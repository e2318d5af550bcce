"""Elementwise / rowwise ops (port of ``mg_gcn_tpu/ops/elementwise.py``).

The reference implements these as hand-written CUDA kernels
(``cuda_utils.cu``); here they are single torch expressions, kept as named
functions so the model code reads like the reference's op vocabulary.
"""

from __future__ import annotations

import torch

LEAKY_SLOPE = 0.01  # reference default alpha (cuda_utils.cu:26-38)


def leaky_relu(x: torch.Tensor, alpha: float = LEAKY_SLOPE) -> torch.Tensor:
    """max(x, alpha*x) (cuda_utils.cu:26-30)."""
    return torch.where(x > 0, x, alpha * x)


def leaky_relu_grad(
    x: torch.Tensor, g: torch.Tensor, alpha: float = LEAKY_SLOPE
) -> torch.Tensor:
    """g where x > 0 else alpha*g (cuda_utils.cu:32-38). ``x`` may be the
    pre- or the post-activation value: the sign is the same."""
    return torch.where(x > 0, g, alpha * g)


def max_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-wise max (cuda_utils.cu:95-104)."""
    return torch.amax(x, dim=-1)


def subtract_rows_exp(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """exp(x - s[:, None]) (cuda_utils.cu:194-200)."""
    return torch.exp(x - s.reshape(-1, 1))
