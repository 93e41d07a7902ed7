"""Component and reader registries.

The reference uses the ``catalogue`` package for two string-keyed registries
(magnify/registry.py:12-13) plus a ``@component``
decorator that wraps a component function into a kwargs-binding factory
(magnify/registry.py:16-29). This module provides the
same extension mechanism without the dependency.
"""

from __future__ import annotations

import functools
import inspect

__all__ = ["Registry", "readers", "components", "component"]


class Registry:
    """A minimal string-keyed function registry."""

    def __init__(self, namespace: str):
        self.namespace = namespace
        self._entries: dict[str, object] = {}

    def register(self, name: str):
        def deco(func):
            self._entries[name] = func
            return func
        return deco

    def get(self, name: str):
        if name not in self._entries:
            known = ", ".join(sorted(self._entries))
            raise ValueError(
                f"Can't find {name!r} in registry {self.namespace}. "
                f"Available names: {known}"
            )
        return self._entries[name]

    def has(self, name: str) -> bool:
        return name in self._entries

    def get_all(self):
        return dict(self._entries)


readers = Registry("magnify_tpu_torch.readers")
components = Registry("magnify_tpu_torch.components")


def component(name: str):
    """Register a ``Dataset -> Dataset`` function as a named component.

    The registered object is a factory that binds keyword arguments via
    ``functools.partial``; its signature is the component's signature minus
    the leading dataset argument, so pipeline ``add_pipe`` kwargs validate
    naturally. Mirrors magnify/registry.py:16-29.
    """

    def deco(func):
        @functools.wraps(func)
        def factory(*args, **kwargs):
            return functools.partial(func, *args, **kwargs)

        sig = inspect.signature(func)
        sig = sig.replace(parameters=list(sig.parameters.values())[1:])
        factory.__signature__ = sig
        components.register(name)(factory)
        return func

    return deco
