"""DeeperGCN's softmax aggregation (``softmax_sg``) as one autograd op over
the binary CSR walk.

For a layer input x (n × d) and the messages m_j = ReLU(x_j) + ε of the
entries j → i (Li et al., arXiv:2006.07739, GENConv without edge
features), per channel c::

    s_ijc = exp(t·m_jc) / Σ_{k ∈ N(i)} exp(t·m_kc)
    a_ic  = Σ_{j ∈ N(i)} s_ijc · m_jc

with the weights s detached (``softmax_sg``: ∂a_i/∂m_j = s_ij). N(i) is row
i of the forward matrix of the pair (Aᵀ for a graph A whose entry (j, i)
is the edge j → i; its backward matrix is A).

**Forward.** c = the column max of m over all nodes, w = exp(t·(m − c)),
then one product of the binary forward matrix with the (n, 2·d_pad)
operand [w ⊙ m ‖ w] rounded to ``operand`` (bfloat16 on the main path),
float32 sums: num and den; a = num ⊘ den. The global column shift is the
same softmax as the published per-row shift (it cancels between num and
den) as long as a row's weights do not all underflow: t·(c − the row's
largest message) under about 87 (float32's smallest normal is e^-87.3),
a spread of about 870 between a channel's largest message and a row's at
t = 0.1; past it the row's weights fall through the subnormals (bfloat16
keeps none below about e^-92). Where a row's weights all round to nought,
and on a row with no entries, den is nought: the op then gives a = 0 for
that row and channel and passes no gradient through it; it never divides
nought by nought.

**Backward.** ∂L/∂m = w ⊙ (A·r(g ⊘ den)): one product at width d over the
backward matrix, its operand rounded to ``operand``; then the mask
1[x > 0] of the message's ReLU. No tensor of one value per entry and
channel is ever formed: at Reddit's 115M entries and 128 channels that
would be 59 GB.

Rounding points (the configuration's ``aggregation_rounding``): c, w, the
products' sums and the division in float32; w ⊙ m and w rounded to the
operand dtype once each; g ⊘ den rounded to it in the backward. The walk
is ``spmm_gather.gather``'s binary CSR walk (``csrc/csr_walk.cuh``); on
CPU tensors it runs its plain version, so that the op on CPU tensors is
its own CPU twin, every step plain torch at the same rounding points.

Tracing: the op given a layer ``tag`` opens ``<tag>_1_matmul-spmm`` around
its backward, on the thread that runs it (autograd's, on a card). Under a
profiler each product adds one to the counter :data:`SOFTAGG_LAUNCHES`,
keyed by (direction, d_pad): ("fwd", 2·d_pad) and ("bwd", d_pad).
"""

from __future__ import annotations

import contextlib

import torch

from .. import timers
from .spmm_gather import GatherMat, gather
from .spmm_pattern import round_up

SOFTAGG_LAUNCHES = "softagg_launches"
OPERANDS = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _counted(direction: str, mat: GatherMat, d_pad: int) -> None:
    if mat.nnz:
        timers.count(SOFTAGG_LAUNCHES, 1, (direction, d_pad))


class _SoftmaxAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd, t, eps, operand, tag):
        n, d = x.shape
        d_pad = round_up(d, 8)
        m = torch.relu(x).add_(eps)
        c = torch.amax(m, dim=0)
        w = torch.sub(m, c).mul_(t).exp_()
        make = torch.zeros if d_pad != d else torch.empty
        op = make((n, 2 * d_pad), dtype=operand, device=x.device)
        torch.mul(w, m, out=op[:, :d])
        op[:, d_pad : d_pad + d].copy_(w)
        del m
        _counted("fwd", fwd, 2 * d_pad)
        out = gather(fwd.indptr, fwd.indices, None, op)
        del op
        den = out[:, d_pad : d_pad + d]
        den = torch.where(den > 0, den, torch.inf)  # a nought row reads a = 0 and passes a nought gradient
        a = torch.div(out[:, :d], den)
        ctx.graph, ctx.operand, ctx.tag = bwd, operand, tag
        ctx.save_for_backward(x, w, den)
        return a

    @staticmethod
    def backward(ctx, g):
        x, w, den = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        bwd, (n, d) = ctx.graph, x.shape
        d_pad = round_up(d, 8)
        scope = timers.scope(f"{ctx.tag}_1_matmul-spmm") if ctx.tag is not None else contextlib.nullcontext()
        with scope:
            make = torch.zeros if d_pad != d else torch.empty
            q = make((n, d_pad), dtype=ctx.operand, device=g.device)
            torch.div(g, den, out=q[:, :d])
            _counted("bwd", bwd, d_pad)
            dm = gather(bwd.indptr, bwd.indices, None, q)[:, :d]
            del q
            dx = dm.mul_(w).masked_fill_(x <= 0, 0.0)
        return dx, None, None, None, None, None, None


def softmax_aggregate(fwd: GatherMat, bwd: GatherMat, x: torch.Tensor, t: float, eps: float,
                      operand: str = "bfloat16", tag=None) -> torch.Tensor:
    """a (n × d, float32) of the softmax aggregation of the messages
    ReLU(x) + ``eps`` at temperature ``t``, over the binary matrices ``fwd``
    (row i: the entries j → i) and ``bwd`` (its transpose); differentiable
    in x with the weights detached (``softmax_sg``). ``operand`` is the
    products' operand dtype ("bfloat16" or "float32"). ``tag``: the layer
    whose backward scope the backward opens (none by default)."""
    if fwd.has_w or bwd.has_w or fwd.scale_side != "none" or bwd.scale_side != "none":
        raise ValueError("the softmax aggregation walks a binary pair with no degree scales")
    if operand not in OPERANDS:
        raise ValueError(f"the softmax aggregation's operand is {'/'.join(OPERANDS)}, not {operand!r}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != fwd.n_in or fwd.n_out != fwd.n_in:
        raise ValueError(f"x must be float32 (n, d) over the pair's {fwd.n_in} nodes, got {x.dtype} {tuple(x.shape)}")
    return _SoftmaxAgg.apply(x, fwd, bwd, float(t), float(eps), OPERANDS[operand], tag)
