"""String -> factory registries for models, backbones, heads, actors, losses
(a copy of uvltrack_tpu/registry.py: framework-free, so the port keeps its
own).

Mirrors the role of the reference registry (lib/registry.py:6-49): experiment
YAMLs name components by string; factories are looked up here. Implementation is
a plain dict with a decorator — no metaclass magic.
"""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._registry: Dict[str, Callable] = {}

    def register(self, key: str) -> Callable:
        def deco(fn: Callable) -> Callable:
            if key in self._registry:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._registry[key] = fn
            return fn

        return deco

    def __getitem__(self, key: str) -> Callable:
        if key not in self._registry:
            raise KeyError(
                f"{key!r} not found in registry {self.name}; "
                f"available: {sorted(self._registry)}"
            )
        return self._registry[key]

    def __contains__(self, key: str) -> bool:
        return key in self._registry

    def keys(self):
        return self._registry.keys()


MODELS = Registry("models")
BACKBONES = Registry("backbones")
HEADS = Registry("heads")
ACTORS = Registry("actors")
LOSSES = Registry("losses")
DATASETS = Registry("datasets")
TRACKERS = Registry("trackers")
