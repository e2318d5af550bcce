"""Carry parameters and Adam moments between the JAX package and the port.

The JAX package's parameters are a list of dicts of arrays; as numpy (for
example ``jax.tree.map(np.asarray, params)``) they cross into the port with
:func:`params_from_numpy` and back with :func:`params_to_numpy`, so both
packages can compute from the same starting point.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .nn.adam import AdamState


def params_from_numpy(params, device: str | torch.device = "cuda") -> list[dict]:
    """A list of dicts of numpy arrays -> the port's list of dicts of tensors."""
    dev = resolve_device(device)
    return [{k: torch.from_numpy(np.array(v)).to(dev) for k, v in layer.items()} for layer in params]


def params_to_numpy(params) -> list[dict]:
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()} for layer in params]


def adam_state_from_numpy(step, m, v, device: str | torch.device = "cuda") -> AdamState:
    """The JAX ``AdamState(step, m, v)`` as numpy -> the port's AdamState."""
    dev = resolve_device(device)
    return AdamState(
        step=torch.tensor(int(step), dtype=torch.int32, device=dev),
        m=params_from_numpy(m, dev),
        v=params_from_numpy(v, dev),
    )
