"""Deferred imports for dependencies that dominate package-import time.

``import cirkit_tpu`` is on the critical path of time-to-first-batch for
every process; with the warm-compile cache (backend/jax/warmcache.py) a
second process replays serialized executables and never builds an
optimizer or runs an independence test — yet eager imports of
``scipy.stats`` and ``optax`` would make it pay for both anyway (see
``python -X importtime``). The reference has no equivalent cost: torch
imports once and its module construction is the whole startup story
(BASELINE.md row 1).

:class:`LazyModule` defers the import to the first attribute access and
then REBINDS the owning module's global name to the real module, so every
later lookup is a plain module attribute access with zero proxy overhead.
Only safe for modules used exclusively at call time (no module-level
evaluation of their attributes) — verified by an AST scan over the three
call sites in r5.
"""

from __future__ import annotations

import importlib
from typing import Any


class LazyModule:
    """Import ``name`` on first attribute access; rebind ``alias`` in
    ``owner_globals`` to the real module so the proxy retires itself."""

    def __init__(self, name: str, alias: str, owner_globals: dict):
        self._name = name
        self._alias = alias
        self._owner = owner_globals

    def __getattr__(self, attr: str) -> Any:
        mod = importlib.import_module(self._name)
        self._owner[self._alias] = mod
        return getattr(mod, attr)

    def __repr__(self) -> str:  # pragma: no cover - diagnostics only
        return f"<LazyModule {self._name!r} (not yet imported)>"
