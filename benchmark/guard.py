"""The check that nothing the benchmark loaded is JAX or the JAX package.

A module's top-level name (the part before the first dot) is compared
whole, so ``tpu_faas_torch`` is not ``tpu_faas``."""

from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "tpu_faas")


def banned_modules(modules=None) -> list[str]:
    """The banned top-level names among ``modules`` (default: every module
    this process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(BANNED))
