"""Full-batch BatchNorm followed by a ReLU, as one autograd op.

Over all n rows of h (n × d), in training mode (Ioffe and Szegedy 2015,
PyTorch's ``BatchNorm1d`` in ``train()``): the column means μ and biased
variances σ², then z = ReLU((h − μ) · γ/√(σ² + ε) + β). The backward, with
g' = g ⊙ 1[z > 0] and x̂ = (h − μ)/√(σ² + ε)::

    ∂β = Σ_rows g'     ∂γ = Σ_rows g' ⊙ x̂
    ∂h = γ/√(σ² + ε) ⊙ (g' − ∂β/n − x̂ ⊙ ∂γ/n)

It keeps h (the residual stream, held anyway), its output z (the next
op's input, held anyway), μ and 1/√(σ² + ε); x̂ is recomputed. Given a
layer ``tag``, the backward opens ``<tag>_1_activation`` on the thread
that runs it.
"""

from __future__ import annotations

import contextlib

import torch

from .. import timers


class _BatchNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, gamma, beta, eps, tag):
        var, mean = torch.var_mean(h, dim=0, correction=0)
        invstd = torch.rsqrt(var.add_(eps))
        z = torch.addcmul(beta, torch.sub(h, mean), gamma * invstd).relu_()
        ctx.tag = tag
        ctx.save_for_backward(h, z, mean, invstd, gamma)
        return z

    @staticmethod
    def backward(ctx, g):
        h, z, mean, invstd, gamma = ctx.saved_tensors
        scope = timers.scope(f"{ctx.tag}_1_activation") if ctx.tag is not None else contextlib.nullcontext()
        with scope:
            n = h.shape[0]
            gm = g.masked_fill(z <= 0, 0.0)
            xhat = torch.sub(h, mean).mul_(invstd)
            dbeta = torch.sum(gm, dim=0)
            dgamma = torch.sum(gm * xhat, dim=0)
            k = gamma * invstd
            dh = None
            if ctx.needs_input_grad[0]:
                # k·g' − k·(∂β + x̂·∂γ)/n
                dh = torch.addcmul(-(k * dbeta) / n, xhat, -(k * dgamma) / n).addcmul_(gm, k)
        return dh, dgamma, dbeta, None, None


def batch_norm_relu(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5,
                    tag=None) -> torch.Tensor:
    """ReLU(BatchNorm(h)) over all rows of ``h`` (n × d, float32) with the
    scale ``gamma`` and shift ``beta`` (d,); differentiable in all three.
    ``tag``: the layer whose backward scope the backward opens."""
    if h.dim() != 2 or gamma.shape != (h.shape[1],) or beta.shape != (h.shape[1],):
        raise ValueError(f"h must be (n, d) with gamma and beta (d,), got {tuple(h.shape)}, "
                         f"{tuple(gamma.shape)}, {tuple(beta.shape)}")
    return _BatchNormReLU.apply(h, gamma, beta, float(eps), tag)
