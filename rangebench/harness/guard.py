"""No process of the benchmark may hold JAX or the JAX package. Module
names are compared by their whole top-level name: ``repro_torch`` begins
with ``repro`` and is allowed."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def check(where: str) -> None:
    """Raise ``RuntimeError`` naming what was found."""
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"{where}: the process holds {found}; the benchmark "
                           f"may load none of {FORBIDDEN}")
