"""Plot styling defaults: the torch port's copy of ``magnify_tpu.plot.style``
(counterpart of the reference's plot/style.py), and the one place the plot
modules import pyplot."""

from __future__ import annotations

__all__ = ["pyplot", "set_style"]


_styled = False


def pyplot():
    """``matplotlib.pyplot``, with the default style applied on the first
    call; an ImportError that names matplotlib where it is not installed
    (the plots need it; detection never does)."""
    global _styled
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("magnify_tpu_torch.plot needs matplotlib, which is "
                          "not installed") from e
    if not _styled:
        set_style()
        _styled = True
    return plt


def set_style(name: str = "whitegrid") -> None:
    """Apply the framework's default matplotlib style. Safe headless: without
    matplotlib it does nothing."""
    try:
        import matplotlib as mpl
    except ImportError:
        return
    mpl.rcParams.setdefault("figure.figsize", (8, 8))
    mpl.rcParams["axes.grid"] = name == "whitegrid"
    mpl.rcParams["image.cmap"] = "gray"
