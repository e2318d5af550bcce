"""The check that a run loaded nothing of JAX or of the JAX package: the
top-level name of every loaded module (the part before the first dot)
compared whole, so ``mg_gcn_tpu_torch`` is not taken for ``mg_gcn_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "mg_gcn_tpu")


def forbidden_loaded(names=None) -> list[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
