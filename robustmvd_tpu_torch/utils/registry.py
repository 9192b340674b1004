"""Generic registry of named entrypoints (timm style, as in the reference:
rmvd/models/registry.py:7-53)."""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entrypoints: Dict[str, Callable] = {}
        self._meta: Dict[str, dict] = {}

    def register(self, fn, **meta):
        """Register ``fn`` under its own name, with metadata ``meta``."""
        self._entrypoints[fn.__name__] = fn
        self._meta[fn.__name__] = meta
        return fn

    def get(self, name: str) -> Callable:
        if name not in self._entrypoints:
            raise ValueError(
                f"unknown {self.kind} '{name}'. Available: {sorted(self._entrypoints)}"
            )
        return self._entrypoints[name]

    def meta(self, name: str) -> dict:
        return self._meta.get(name, {})

    def list(self):
        return sorted(self._entrypoints)
