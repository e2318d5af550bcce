"""Checkpoint / resume of ``(params, opt_state)`` as one ``.npz``.

Port of ``mg_gcn_tpu/checkpoint.py``, with the same file layout: the leaves
as ``leaf_0 .. leaf_{k-1}`` in the JAX package's flattening order (lists and
tuples in order, dict keys sorted, ``AdamState`` as step, m, v), so either
package can read the other's checkpoints.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _rebuild(template: Any, it) -> Any:
    if isinstance(template, dict):
        filled = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(x, it) for x in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(x, it) for x in template)
    return next(it)


def save_checkpoint(path: str | os.PathLike, tree: Any) -> None:
    arrays = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(_leaves(tree))}
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str | os.PathLike, template: Any) -> Any:
    """Restore into the structure, dtypes and devices of ``template``."""
    refs = _leaves(template)
    with np.load(os.fspath(path)) as data:
        if len(data.files) != len(refs):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, template expects {len(refs)}"
            )
        new = []
        for i, ref in enumerate(refs):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != template shape {tuple(ref.shape)}"
                )
            new.append(torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype))
    return _rebuild(template, iter(new))
