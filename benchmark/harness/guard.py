"""The import guard: the process that prints a result may hold no module of
JAX or of the JAX package the program was ported from.  Names are compared
by their top-level part (before the first dot), whole, so the port,
``quickrank_tpu_torch``, passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "quickrank_tpu"})


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
