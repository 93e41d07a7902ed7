"""Interactive step-tuning UI with a headless fallback: the torch port's copy
of ``magnify_tpu.plot.vis``.

The reference docks magicgui widgets in a napari window and blocks on a Qt
event loop (its plot/vis.py:7-45): every tunable stage exposes its keyword
defaults as live controls, re-runs on change (``auto_call``), and a
Continue button advances to the next stage. This module keeps the same
``InteractiveUI.run_widget`` contract but renders with matplotlib: numeric
keyword parameters become ``Slider`` widgets, a Run button fires non-auto
stages, Continue unblocks. Headless sessions (no matplotlib, or a backend
that is not a GUI) degrade to a single call with the defaults, and every
stage's :class:`TuningSession` stays accessible so parameter changes can be
driven programmatically (tests, scripts). :func:`interactive_find_circles`
re-runs the port's edge stack and detector on the caller's device.
"""

from __future__ import annotations

import inspect

import numpy as np

from magnify_tpu_torch.plot.style import pyplot

__all__ = ["InteractiveUI", "TuningSession", "interactive_find_circles"]


class TuningSession:
    """One tunable stage: keyword defaults -> live parameters.

    Mirrors the reference's magicgui widget semantics: ``set_param``
    updates a parameter and, under ``auto_call``, immediately re-invokes
    the callback (reference plot/vis.py:18-24); ``run`` invokes it
    explicitly. ``calls`` counts invocations, ``result`` holds the last
    returned layer list.
    """

    def __init__(self, func, auto_call: bool = False):
        self.func = func
        self.auto_call = auto_call
        self.params = {
            name: p.default
            for name, p in inspect.signature(func).parameters.items()
            if p.default is not inspect.Parameter.empty
        }
        self.calls = 0
        self.result = None

    def run(self):
        self.result = self.func(**self.params)
        self.calls += 1
        return self.result

    def set_param(self, name: str, value):
        if name not in self.params:
            raise KeyError(f"{name!r} is not a tunable parameter "
                           f"({sorted(self.params)})")
        self.params[name] = value
        if self.auto_call:
            return self.run()
        return self.result


class InteractiveUI:
    """Run parameter-tuning callbacks, interactively when possible."""

    def __init__(self):
        self.interactive = self._gui_available()
        self.last_result = None
        self.sessions: list[TuningSession] = []

    @staticmethod
    def _gui_available() -> bool:
        try:
            import matplotlib
        except ImportError:
            return False
        return matplotlib.get_backend().lower() not in (
            "agg", "pdf", "svg", "ps", "template"
        )

    def run_widget(self, func, auto_call: bool = False, last: bool = False):
        """Tune ``func``'s keyword parameters, then return its last result.

        With a GUI backend this blocks like the reference's Qt loop: the
        layers render, numeric parameters get sliders (re-running on
        change when ``auto_call``), a Run button fires non-auto stages,
        and Continue ends the stage (closing the window when ``last``).
        Headless, the callback runs once with its defaults and the session
        is kept on ``self.sessions`` for programmatic driving.
        """
        session = TuningSession(func, auto_call=auto_call)
        session.run()
        self.sessions.append(session)
        if self.interactive:
            self._run_gui(session, last)
        self.last_result = session.result
        return session.result

    # -- GUI machinery -----------------------------------------------------

    def _run_gui(self, session: TuningSession, last: bool) -> None:
        plt = pyplot()
        from matplotlib.widgets import (
            Button, CheckButtons, RadioButtons, Slider, TextBox,
        )

        # Resolve widget kinds up front: a radio box is taller than one
        # slider strip (0.03 per choice), so per-widget heights drive the
        # layout — a fixed 0.05 pitch would overlap the control above a
        # multi-choice radio.
        specs = [(name, value) + _widget_spec(session.func, name, value)
                 for name, value in session.params.items()]
        boxes, stack_h = _widget_layout(specs)
        fig = plt.figure(figsize=(7, 6 + 6 * stack_h))
        bottom = 0.08 + stack_h
        ax = fig.add_axes([0.08, bottom + 0.05, 0.86, 0.9 - bottom])

        def redraw():
            ax.clear()
            self._render(ax, session.result)
            fig.canvas.draw_idle()

        def on_set(name, value):
            session.set_param(name, value)
            if session.auto_call:
                redraw()

        # magicgui-style widget dispatch (reference plot/vis.py:18-24 relies
        # on magicgui auto-generating checkboxes for bools and combo boxes
        # for choice parameters, not just sliders for numbers).
        controls = []
        for (name, value, kind, spec), (y, height) in zip(specs, boxes):
            sax = fig.add_axes([0.25, y, 0.55, height])
            if kind == "checkbox":
                w = CheckButtons(sax, [name], [bool(value)])

                def _on_check(_lbl, name=name, box=w):
                    on_set(name, box.get_status()[0])

                w.on_clicked(_on_check)
            elif kind == "choice":
                labels, values = spec
                w = RadioButtons(sax, labels,
                                 active=values.index(value)
                                 if value in values else 0)
                sax.set_title(name, fontsize=8, loc="left")
                # Pass the TYPED choice value (Enum member / int literal),
                # not the display label — magicgui's combo boxes re-invoke
                # with the annotated type, and `mode is Mode.fast`-style
                # checks in the callback depend on it.
                w.on_clicked(
                    lambda lbl, name=name, labels=labels, values=values:
                    on_set(name, values[labels.index(lbl)]))
            elif kind == "text":
                w = TextBox(sax, name, initial=str(value))
                w.on_submit(lambda txt, name=name: on_set(name, txt))
            else:
                lo, hi, step = spec
                w = Slider(sax, name, lo, hi, valinit=float(value),
                           valstep=step)
                w.on_changed(lambda val, name=name, step=step: on_set(
                    name, int(val) if step == 1 else float(val)))
            controls.append(w)

        state = {"done": False}
        bax = fig.add_axes([0.82, 0.02, 0.13, 0.05])
        cont = Button(bax, "Continue")
        cont.on_clicked(lambda _ev: state.__setitem__("done", True))
        widgets = [cont]
        if not session.auto_call:
            rax = fig.add_axes([0.66, 0.02, 0.13, 0.05])
            run_btn = Button(rax, "Run")

            def on_run(_ev):
                session.run()
                redraw()

            run_btn.on_clicked(on_run)
            widgets.append(run_btn)

        self._render(ax, session.result)
        fig.show()
        # Block like the reference's Qt loop until Continue is pressed.
        while not state["done"] and plt.fignum_exists(fig.number):
            plt.pause(0.05)
        if last or not plt.fignum_exists(fig.number):
            plt.close(fig)

    @staticmethod
    def _render(ax, layers) -> None:
        if layers is None:
            return
        base_drawn = False
        for layer in layers:
            data = layer[0] if isinstance(layer, tuple) else layer
            meta = (layer[1] if isinstance(layer, tuple) and len(layer) > 1
                    else {})
            data = np.asarray(data)
            is_points = isinstance(layer, tuple) and len(layer) > 2
            if is_points and data.ndim == 2 and data.shape[1] in (2, 3):
                sizes = np.asarray(meta.get("size", 10))
                ax.scatter(data[:, 1], data[:, 0], s=sizes,
                           facecolors="none", edgecolors="r")
            elif data.ndim == 2 and not base_drawn:
                ax.imshow(data, cmap="gray")
                base_drawn = True
            elif data.ndim == 2:
                # Secondary image layers overlay the base (the reference's
                # additive-blended napari layers, e.g. the live Canny edge
                # map, utils.py:137-140): nonzero pixels render yellow.
                ax.imshow(np.ma.masked_where(data == 0, data),
                          cmap="autumn", alpha=0.8, interpolation="nearest")


def _widget_layout(specs, base_y: float = 0.1, pad: float = 0.02):
    """Figure-fraction (y, height) boxes for a widget stack.

    Radio groups are 0.03 per choice, everything else 0.03; each widget
    starts above the previous one's top plus ``pad``, so no two control
    axes overlap regardless of choice counts. Returns (boxes, stack_h)
    where stack_h is the total stacked extent above ``base_y``.
    """
    boxes = []
    y = base_y
    for _name, _value, kind, spec in specs:
        height = 0.03 * max(1, len(spec[0])) if kind == "choice" else 0.03
        boxes.append((y, height))
        y += height + pad
    return boxes, y - base_y


def _widget_spec(func, name: str, value):
    """(kind, spec) for a parameter, magicgui-style: bool defaults become
    checkboxes, ``typing.Literal``/Enum/explicit-choice annotations become
    radio groups, other strings become text boxes, numbers become sliders
    (the reference's magicgui dock auto-generates the same widget set from
    type hints, plot/vis.py:18-24).
    """
    import enum
    import typing

    if isinstance(value, bool):
        return "checkbox", None
    try:
        ann = inspect.signature(func).parameters[name].annotation
    except (ValueError, KeyError):
        ann = inspect.Parameter.empty
    if ann is not inspect.Parameter.empty:
        # Choice specs are (display labels, typed values): the radio
        # callback must hand the TYPED value back to the stage.
        if typing.get_origin(ann) is typing.Literal:
            args = list(typing.get_args(ann))
            return "choice", ([str(a) for a in args], args)
        if isinstance(ann, type) and issubclass(ann, enum.Enum):
            return "choice", ([e.name for e in ann], list(ann))
    if isinstance(value, (list, tuple)) and value and all(
            isinstance(v, str) for v in value):
        # A sequence-of-strings default reads as a choice set with the
        # first entry active (TuningSession then holds a plain string).
        return "choice", (list(value), list(value))
    if isinstance(value, str):
        return "text", None
    return "slider", _slider_range(value)


def _slider_range(value):
    """Pick a (lo, hi, step) for a parameter's slider from its default,
    like magicgui's automatic widget ranges."""
    if isinstance(value, bool):
        return 0, 1, 1
    if isinstance(value, (int, np.integer)):
        hi = max(2 * int(value), int(value) + 10)
        return 0, hi, 1
    v = float(value)
    if 0.0 <= v <= 1.0:
        return 0.0, 1.0, None
    return 0.0, max(2 * v, v + 1.0), None


def interactive_find_circles(image, gui, *, low_edge_quantile,
                             high_edge_quantile, grid_length, num_iter,
                             min_radius, max_radius, min_roundness, min_dist,
                             seed=0, detector="auto", device="cuda"):
    """Interactive wrapper over the detector: exposes the same two tuning
    stages as the reference (edge thresholds, circle filters; its
    utils.py:122-220) and returns the final (circles, scores).

    The edge stage renders the LIVE Canny edge map for the current
    quantiles as an additive overlay, like the reference's "Edges" napari
    layer: every slider change re-runs ``ops.edge.edge_pipeline`` on
    ``device``. The filter stage re-runs ``ops.detect.find_circles`` with
    ``detector`` on ``device``, so headless (each stage once, with these
    values) the result is ``find_circles`` without the UI.
    """
    import torch

    from magnify_tpu_torch.ops.detect import find_circles as _find
    from magnify_tpu_torch.ops.edge import edge_pipeline

    state = {}
    host = (image.cpu().numpy() if isinstance(image, torch.Tensor)
            else np.asarray(image))
    img_dev = torch.from_numpy(
        np.ascontiguousarray(host, dtype=np.float32)).to(device)

    def tune_edges(low_edge_quantile: float = low_edge_quantile,
                   high_edge_quantile: float = high_edge_quantile):
        state["low"] = low_edge_quantile
        state["high"] = high_edge_quantile
        edges = edge_pipeline(img_dev, float(low_edge_quantile),
                              float(high_edge_quantile), normalized=False)[0]
        return [(host, {"name": "Image"}),
                (edges.cpu().numpy().astype(np.uint8),
                 {"name": "Edges", "blending": "additive"})]

    gui.run_widget(tune_edges, auto_call=True)

    def tune_filters(min_radius: int = min_radius,
                     max_radius: int = max_radius,
                     min_roundness: float = min_roundness,
                     min_dist: int = min_dist):
        circles, scores = _find(
            image, state["low"], state["high"], grid_length, num_iter,
            int(min_radius), int(max_radius), min_roundness, int(min_dist),
            gui=None, seed=seed, detector=detector, device=device,
        )
        state["result"] = (circles, scores)
        return [
            (host, {"name": "Image"}),
            (circles[:, :2], {"name": "Circles", "size": 2 * circles[:, 2]},
             "points"),
        ]

    gui.run_widget(tune_filters, auto_call=True, last=True)
    return state["result"]
