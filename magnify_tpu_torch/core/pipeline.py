"""The component pipeline engine.

An ordered list of named ``Dataset -> Dataset`` components folded over each
assay produced by a reader: insertion by name/index/first/last,
duplicate-name rejection, removal by name. The same contract as
``magnify_tpu.core.pipeline``, with the same stage timers: the reader runs
as the stage ``"read"`` and each component as a stage of its own name
(:func:`magnify_tpu_torch.diagnostics.stage_timer`), and each call gives
the spans inside it one id
(:func:`magnify_tpu_torch.diagnostics.pipeline_call`).
"""

from __future__ import annotations

from collections.abc import Callable

from magnify_tpu_torch import diagnostics
from magnify_tpu_torch.core import registry as _registry

__all__ = ["Pipeline"]


class Pipeline:
    def __init__(self, reader: str):
        self.reader = _registry.readers.get(reader)()
        self.components: list[tuple[str, Callable]] = []

    @property
    def component_names(self) -> list[str]:
        return [name for name, _ in self.components]

    @diagnostics.pipeline_call()
    def __call__(self, data):
        from magnify_tpu_torch.diagnostics import stage_timer

        with stage_timer("read"):
            assays = list(self.reader(data=data))

        outputs = []
        for assay in assays:
            for name, comp in self.components:
                with stage_timer(name):
                    assay = comp(assay)
            outputs.append(assay)
        return outputs[0] if len(outputs) == 1 else outputs

    def _resolve_component(self, component, name, kwargs):
        if isinstance(component, str):
            factory = _registry.components.get(component)
            return name or component, factory(**kwargs)

        def bound(xp, _fn=component, _kw=kwargs):
            return _fn(xp, **_kw)

        return name or component.__name__, bound

    def _insertion_index(self, after, before, first, last) -> int:
        placements = (after is not None) + (before is not None) + first + last
        if placements == 0:
            last = True
        elif placements > 1:
            raise ValueError(
                "Only one of after, before, first, and last can be set."
            )
        if first:
            return 0
        if last:
            return len(self.components)
        anchor, offset = (before, 0) if before is not None else (after, 1)
        if isinstance(anchor, int):
            return anchor + offset
        if isinstance(anchor, str):
            return self.component_names.index(anchor) + offset
        raise ValueError("before/after must be a string or int.")

    def add_pipe(
        self,
        component,
        name: str | None = None,
        after: str | int | None = None,
        before: str | int | None = None,
        first: bool = False,
        last: bool = False,
        **kwargs,
    ) -> None:
        """Insert a component (registered name or callable) into the chain."""
        name, func = self._resolve_component(component, name, kwargs)
        if name in self.component_names:
            raise ValueError(
                f"A component with the name '{name}' already exists in the "
                "pipeline."
            )
        idx = self._insertion_index(after, before, first, last)
        self.components.insert(idx, (name, func))

    def remove_pipe(self, name: str) -> None:
        """Remove the component registered under ``name``."""
        if not self.components:
            raise ValueError(
                f"Cannot remove pipe '{name}': pipeline has no components"
            )
        names = self.component_names
        if name not in names:
            raise ValueError(f"Component '{name}' not found in pipeline")
        del self.components[names.index(name)]
