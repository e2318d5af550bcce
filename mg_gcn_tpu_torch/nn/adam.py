"""Optimizers, matching the reference's update rules exactly.

Port of ``mg_gcn_tpu/nn/adam.py``. Parameters are a list of dicts of
tensors (``W``, ``b``, ``Wres``, ``bres``), the JAX package's pytree:

* :func:`sgd_update` — ``W = (1 - wd) * W - lr * G`` for weights,
  ``b -= lr * G_b`` for biases (gcn.hpp:141-144).
* Adam — **coupled** weight decay ``G_W += wd * W`` before the moment
  updates (gcn.hpp:158, not AdamW), on keys starting with ``W`` only;
  ``m = (1-b1) G + b1 m``, ``v = (1-b2) G^2 + b2 v``;
  ``p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)`` with ``bc1 = 1 - b1^t``,
  ``bc2 = 1 - b2^t`` (cuda_utils.cu:208-218).

The bias corrections are computed in the parameters' float dtype: float32
in the default mode, which is what the JAX package computes without
``jax_enable_x64`` (its ``canonicalize_dtype(float64)`` is float32 then).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DEFAULT_HPARAMS = dict(lr=1e-2, beta1=0.9, beta2=0.999, weight_decay=5e-4, eps=1e-8)

Params = list  # list[dict[str, torch.Tensor]]


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Params  # first moments, same structure as params
    v: Params  # second moments


def _is_decayed(key: str) -> bool:
    """Weight decay applies to 'W*' leaves only (gcn.hpp:158 decays W, not b)."""
    return key.startswith("W")


def _zeros_like(params: Params) -> Params:
    return [{k: torch.zeros_like(p) for k, p in layer.items()} for layer in params]


def adam_init(params: Params) -> AdamState:
    device = next(iter(params[0].values())).device
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=_zeros_like(params),
        v=_zeros_like(params),
    )


def adam_update(
    params: Params,
    grads: Params,
    state: AdamState,
    lr: float = 1e-2,
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 5e-4,
    eps: float = 1e-8,
) -> tuple[Params, AdamState]:
    step = state.step + 1
    t = step.to(next(iter(params[0].values())).dtype)
    bc1 = 1.0 - torch.pow(beta1, t)
    bc2 = 1.0 - torch.pow(beta2, t)
    new_p, new_m, new_v = [], [], []
    for layer, glayer, mlayer, vlayer in zip(params, grads, state.m, state.v):
        lp, lm, lv = {}, {}, {}
        for k, p in layer.items():
            g = glayer[k]
            if weight_decay and _is_decayed(k):
                g = g + weight_decay * p  # coupled decay, gcn.hpp:158
            m = (1.0 - beta1) * g + beta1 * mlayer[k]
            v = (1.0 - beta2) * g * g + beta2 * vlayer[k]
            lp[k] = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            lm[k], lv[k] = m, v
        new_p.append(lp)
        new_m.append(lm)
        new_v.append(lv)
    return new_p, AdamState(step=step, m=new_m, v=new_v)


def sgd_update(
    params: Params, grads: Params, lr: float, weight_decay: float = 0.0
) -> Params:
    """Reference linear::update (gcn.hpp:141-144)."""
    out = []
    for layer, glayer in zip(params, grads):
        out.append(
            {
                k: (1.0 - weight_decay) * p - lr * glayer[k]
                if weight_decay and _is_decayed(k)
                else p - lr * glayer[k]
                for k, p in layer.items()
            }
        )
    return out
