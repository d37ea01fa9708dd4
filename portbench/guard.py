"""The modules a run may not load: JAX, and the reference package and
its benchmark scripts.  Compared by whole top-level name (the part of a
module's name before its first dot), so the program under test,
``qoipp_tpu_torch``, is not ``qoipp_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qoipp_tpu", "bench",
                       "benchmarks"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules=None) -> list:
    """Sorted top-level names in ``modules`` (sys.modules by default) that
    are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)
