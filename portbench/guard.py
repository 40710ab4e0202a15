"""The check that a run loaded neither JAX nor the JAX package: module
names compared by their top-level name, whole (the port's own name
begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pilosa_tpu")


def forbidden(modules=None) -> list[str]:
    """Top-level names of ``modules`` (``sys.modules`` by default) that
    the run may not import, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
