"""The plain reference of DeeperGCN's ResGEN (Li et al., arXiv:2006.07739,
the ogbn-arxiv model: ``res+`` blocks of GENConv with ``softmax_sg``
aggregation and BatchNorm), in plain PyTorch, in the inputs' dtype
(float32 with TF32 off on the card, float64 as the tests' twin).

A GENConv layer of input x: the messages m_j = ReLU(x_j) + ε of the
entries j → i (row i of Aᵀ), the aggregation a_i = Σ_j s_ij ⊙ m_j with
s_ij the softmax of t·m over row i's entries, channel by channel, whose
weights are constants of the gradient (``softmax_sg``); then
Linear(x + a). The model: h = Enc(X); h = GENConv_0(h); h = h +
GENConv_l(ReLU(BN(h))) for l = 1 .. L-1; the logits Head(ReLU(BN(h))).
BatchNorm is written from its equations: over all rows, the column mean
and biased variance, (h − μ)/√(σ² + ε)·γ + β; its gradient is autograd's.
The loss is the softmax cross-entropy averaged over all rows; Adam
(common.adam_step).

The precision is the configuration's (``aggregation_rounding``): the
softmax is shifted by each column's largest message over all nodes,
w = exp(t·(m − c)) in float32; the products take w ⊙ m and w rounded to
``aggregation_dtype`` (``gat.rounding``) and sum in the inputs' dtype
(``torch.sparse.mm`` on CSR); a = num / den, nought where den is nought;
the backward is w ⊙ (A·r(g / den)) masked by x > 0. The dense products run
with TF32 off. Imports nothing of the port.

The flat parameters are the benchmark's: ``{k}.W``, ``{k}.b`` and, for a
dict that holds a BatchNorm, ``{k}.gamma_delta`` (its scale less 1, so
that a draw of nought is PyTorch's γ = 1) and ``{k}.beta``; k as the
port's list (``families/deepergcn.py``).
"""

from __future__ import annotations

import torch

from benchmark.reference.common import _csr, coo_of, softmax_xent, train, transposed
from benchmark.reference.gat import rounding


class Pair:
    """The binary Aᵀ (row i: the entries j → i) and A as CSR tensors in the
    inputs' dtype, with the configuration's rounding ``r``."""

    def __init__(self, graph, device: torch.device, dtype: torch.dtype, r):
        rows, cols = coo_of(graph.indptr, graph.indices, device)
        ones = torch.ones(rows.numel(), dtype=dtype, device=device)
        self.bwd = _csr(rows, cols, ones, graph.n)
        t_rows, t_cols = transposed(rows, cols, graph.n)
        self.fwd = _csr(t_rows, t_cols, ones, graph.n)
        self.r = r


class SoftmaxAgg(torch.autograd.Function):
    """a = Σ_j s_ij ⊙ m_j, s detached; its gradient w ⊙ (A·r(g / den)) on
    x > 0."""

    @staticmethod
    def forward(ctx, x, pair: Pair, t: float, eps: float):
        m = torch.relu(x) + eps
        c = torch.amax(m, dim=0)
        w = torch.exp(t * (m - c))
        num = torch.sparse.mm(pair.fwd, pair.r(w * m))
        den = torch.sparse.mm(pair.fwd, pair.r(w))
        den = torch.where(den > 0, den, torch.inf)
        ctx.pair = pair
        ctx.save_for_backward(x, w, den)
        return num / den

    @staticmethod
    def backward(ctx, g):
        x, w, den = ctx.saved_tensors
        dm = w * torch.sparse.mm(ctx.pair.bwd, ctx.pair.r(g / den))
        return torch.where(x > 0, dm, torch.zeros_like(dm)), None, None, None


def batch_norm_relu(h, gamma, beta, eps: float):
    mean = torch.mean(h, dim=0)
    var = torch.mean((h - mean) ** 2, dim=0)
    return torch.relu((h - mean) / torch.sqrt(var + eps) * gamma + beta)


def logits(params: dict, pair: Pair, x, config: dict, residual: bool = True) -> torch.Tensor:
    layers, t, eps, norm_eps = config["layers"], config["t"], config["msg_eps"], config["norm_eps"]

    def linear(k, h):
        return h @ params[f"{k}.W"] + params[f"{k}.b"]

    def norm(k, h):
        return batch_norm_relu(h, 1.0 + params[f"{k}.gamma_delta"], params[f"{k}.beta"], norm_eps)

    def genconv(k, z):
        return linear(k, z + SoftmaxAgg.apply(z, pair, t, eps))

    h = genconv(1, linear(0, x))
    for k in range(2, layers + 1):
        out = genconv(k, norm(k, h))
        h = h + out if residual else out
    return linear(layers + 1, norm(layers + 1, h))


def loss_and_grads(params: dict, pair: Pair, x, y, config: dict, rows: int | None = None, residual: bool = True):
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        out = logits(leaves, pair, x, config, residual)
        loss, g = softmax_xent(out.detach(), y, rows)
        got = torch.autograd.grad(out, list(leaves.values()), grad_outputs=g)
    return loss, dict(zip(leaves, got))


def run(graph, x, y, params0: dict, config: dict, steps: int, faults=frozenset(), blocks: int = 1) -> dict:
    """``steps`` steps from ``params0`` (common.train's record), the dense
    products in float32 with TF32 off. ``faults`` plants "half_batch" (the
    loss over the first half of the rows), "frozen" (the state left
    unchanged), "no_residual" (the ``res+`` add left out: each block's
    GENConv replaces the stream), or the control "tf32" (the dense products
    in TF32). ``blocks`` is unused: the configuration runs on one card."""
    pair = Pair(graph, x.device, x.dtype, rounding(config))
    rows = x.shape[0] // 2 if "half_batch" in faults else None
    residual = "no_residual" not in faults
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = "tf32" in faults
    try:
        return train(lambda p: loss_and_grads(p, pair, x, y, config, rows, residual), params0, config["optimizer"],
                     steps, frozen="frozen" in faults)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
