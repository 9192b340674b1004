"""Generic registry of named entrypoints (timm style, as in the reference:
rmvd/models/registry.py:7-53)."""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entrypoints: Dict[str, Callable] = {}
        self._meta: Dict[str, dict] = {}

    def register(self, fn, name=None, **meta):
        """Register ``fn`` under ``name`` (default: its own name), with
        metadata ``meta``."""
        name = fn.__name__ if name is None else name
        self._entrypoints[name] = fn
        self._meta[name] = meta
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
