"""Explicit name->factory registries.

The port's copy of ``gencomm_tpu/registry.py``: the same ``Registry``,
and of its registries the two the port fills (losses and yaml parsers).
The port registers only what it has ported, so a name the JAX package
knows and the port does not raises ``KeyError`` listing what is known.
"""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str, obj: Callable | None = None):
        """Register ``obj`` under ``name``; usable as a decorator."""
        key = name.lower()

        def _do(o):
            if key in self._entries and self._entries[key] is not o:
                raise KeyError(f"duplicate {self.kind} registration: {name}")
            self._entries[key] = o
            return o

        return _do(obj) if obj is not None else _do

    def get(self, name: str) -> Callable:
        key = name.lower()
        if key not in self._entries:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.kind} '{name}'. known: {known}")
        return self._entries[key]

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._entries

    def names(self):
        return sorted(self._entries)


LOSSES = Registry("loss")           # core_method in loss: block
YAML_PARSERS = Registry("yaml_parser")
