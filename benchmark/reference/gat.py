"""The plain reference of GAT (Veličković et al., ICLR 2018,
arXiv:1710.10903), in plain PyTorch, in the inputs' dtype (float32 with
TF32 off on the card, float64 as the tests' twin).

A layer i of H heads of width d: z = h·W; per head, the score of entry
e = (r, c) is LeakyReLU_0.2(a_dst·z[r] + a_src·z[c]), the weights alpha are
the softmax of the scores over each row's entries, and the head's output
row r is Σ_e alpha_e·z[c_e]. A hidden layer concatenates its heads, adds b,
adds its input where the configuration lists it under ``skip``, then
applies the activation (ELU, or LeakyReLU at ``leaky_slope``); the last
layer averages its heads and adds b. The loss is the softmax cross-entropy
averaged over all rows; exact gradients; Adam (common.adam_step).

The precision is the configuration's (``attention_rounding``): each sparse
product, the per-entry dots (SDDMM) and the weighted sums and their
transposes, takes its operands rounded to ``aggregation_dtype`` and sums in
the inputs' dtype, in the forward and in the backward alike; the softmax
is the two-pass form whose row shift and log row sum are such operands: a
pass under the global max of the scores (clipped at -80) estimates each
row's log-sum-exp, then alpha = exp(s - shift - log Σ exp(s - shift)).
The per-entry dots are taken in blocks of entries and the sums by
``torch.sparse.mm`` on CSR, so that no (entries × width) tensor is made
whole. The dense products run with TF32 off. Imports nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.common import coo_of, leaky_relu, softmax_xent, train

BLOCK_ELEMS = 1 << 27  # gathered elements an SDDMM block holds (each of its two operands)
FP8_MAX = 448.0  # float8_e4m3fn's largest value


def rounding(config: dict):
    """The function that rounds an operand to ``aggregation_dtype`` and back
    to its own dtype: bfloat16 by a cast; float8_e4m3fn, a control below
    bfloat16, by a cast after a scale that puts the tensor's largest
    magnitude at float8's largest value; float32 and float64 not at all."""
    name = config["aggregation_dtype"]
    if name in ("float32", "float64"):
        return lambda x: x
    if name == "float8_e4m3fn":
        def fp8(x):
            scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-30) / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return fp8
    if name != "bfloat16":
        raise ValueError(f"no rounding to {name!r}")
    return lambda x: x.to(torch.bfloat16).to(x.dtype)


class Pattern:
    """The graph's entries in CSR order (rows, then columns ascending) and
    its transpose, with the three sparse kernels of attention at the
    configuration's rounding ``r``."""

    def __init__(self, graph, device: torch.device, r):
        self.n, self.r = graph.n, r
        self.rows, self.cols = coo_of(graph.indptr, graph.indices, device)
        self.crow = self._crow(self.rows)
        self.perm = torch.argsort(self.cols * self.n + self.rows)
        self.t_cols = self.rows[self.perm]
        self.t_crow = self._crow(self.cols[self.perm])

    def _crow(self, rows: torch.Tensor) -> torch.Tensor:
        crow = torch.zeros(self.n + 1, dtype=torch.int64, device=rows.device)
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=self.n), 0)
        return crow

    def sddmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per entry <r(a[row]), r(b[col])>."""
        a, b = self.r(a), self.r(b)
        out = torch.empty(self.rows.numel(), dtype=a.dtype, device=a.device)
        step = max(1, BLOCK_ELEMS // max(a.shape[1], 1))
        for e0 in range(0, out.numel(), step):
            e1 = e0 + step
            out[e0:e1] = torch.sum(a[self.rows[e0:e1]] * b[self.cols[e0:e1]], dim=1)
        return out

    def spmm(self, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Row r: Σ_e r(w_e)·r(b[col_e])."""
        m = torch.sparse_csr_tensor(self.crow, self.cols, self.r(w), (self.n, self.n), check_invariants=False)
        return torch.sparse.mm(m, self.r(b))

    def spmm_t(self, w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """Row c: Σ_{e: col_e = c} r(w_e)·r(a[row_e])."""
        m = torch.sparse_csr_tensor(self.t_crow, self.t_cols, self.r(w)[self.perm], (self.n, self.n),
                                    check_invariants=False)
        return torch.sparse.mm(m, self.r(a))


class Sddmm(torch.autograd.Function):
    """s_e = <a[row_e], b[col_e]>; da = M(g)·b, db = Mᵀ(g)·a."""

    @staticmethod
    def forward(ctx, a, b, pat: Pattern):
        ctx.pat = pat
        ctx.save_for_backward(a, b)
        return pat.sddmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = ctx.pat.spmm(g, b) if ctx.needs_input_grad[0] else None
        db = ctx.pat.spmm_t(g, a) if ctx.needs_input_grad[1] else None
        return da, db, None


class Aggregate(torch.autograd.Function):
    """C = M(w)·b; dw_e = <g[row_e], b[col_e]>, db = Mᵀ(w)·g."""

    @staticmethod
    def forward(ctx, w, b, pat: Pattern):
        ctx.pat = pat
        ctx.save_for_backward(w, b)
        return pat.spmm(w, b)

    @staticmethod
    def backward(ctx, g):
        w, b = ctx.saved_tensors
        dw = ctx.pat.sddmm(g, b) if ctx.needs_input_grad[0] else None
        db = ctx.pat.spmm_t(w, g) if ctx.needs_input_grad[1] else None
        return dw, db, None


def row_softmax(pat: Pattern, s: torch.Tensor) -> torch.Tensor:
    """The softmax of the scores over each row's entries in the two-pass
    form: the shifts are constants of the gradient."""
    ones = torch.ones((pat.n, 1), dtype=s.dtype, device=s.device)
    sg = s.detach()
    smax = torch.amax(sg)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    e1 = torch.exp(torch.clamp(sg - smax, -80.0, 0.0))
    lse1 = smax + torch.log(torch.clamp(pat.spmm(e1, ones), min=1e-30))
    shift = pat.sddmm(lse1, ones)
    rowsum = Aggregate.apply(torch.exp(s - shift), ones, pat)
    log_rs = torch.log(torch.clamp(rowsum, min=1e-30))
    return torch.exp(s - shift - Sddmm.apply(log_rs, ones, pat))


def attend(pat: Pattern, z, e_dst, e_src, slope: float) -> torch.Tensor:
    ones = torch.ones_like(e_dst)
    s = leaky_relu(Sddmm.apply(torch.cat([e_dst, ones], dim=1), torch.cat([ones, e_src], dim=1), pat), slope)
    return Aggregate.apply(row_softmax(pat, s), z, pat)


def logits(params: dict, pat: Pattern, x, config: dict) -> torch.Tensor:
    sizes, heads, skip = config["sizes"], config["heads"], set(config["skip"])
    layers = len(sizes) - 1
    h = x
    for i in range(layers):
        d, H = sizes[i + 1], heads[i]
        z = h @ params[f"{i}.W"]
        outs = []
        for k in range(H):
            zk = z[:, k * d : (k + 1) * d]
            e_dst = zk @ params[f"{i}.a_dst"][k][:, None]
            e_src = zk @ params[f"{i}.a_src"][k][:, None]
            outs.append(attend(pat, zk, e_dst, e_src, config["att_slope"]))
        hidden = i + 1 < layers
        y = (torch.cat(outs, dim=1) if hidden else sum(outs) / H) + params[f"{i}.b"]
        if i in skip:
            y = y + h
        if hidden:
            y = F.elu(y) if config["activation"] == "elu" else leaky_relu(y, config["leaky_slope"])
        h = y
    return h


def loss_and_grads(params: dict, pat: Pattern, x, y, config: dict, rows: int | None = None):
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        out = logits(leaves, pat, x, config)
        loss, g = softmax_xent(out.detach(), y, rows)
        got = torch.autograd.grad(out, list(leaves.values()), grad_outputs=g)
    return loss, dict(zip(leaves, got))


def run(graph, x, y, params0: dict, config: dict, steps: int, faults=frozenset(), blocks: int = 1) -> dict:
    """``steps`` steps from ``params0`` (common.train's record), the dense
    products in float32 with TF32 off. ``faults`` plants "half_batch" (the
    loss over the first half of the rows), "frozen" (the state left
    unchanged), "no_skip" (the skip left out), or the control "tf32" (the
    dense products in TF32). ``blocks`` is unused: the configuration runs on
    one card."""
    pat = Pattern(graph, x.device, rounding(config))
    rows = x.shape[0] // 2 if "half_batch" in faults else None
    cfg = dict(config, skip=[]) if "no_skip" in faults else config
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = "tf32" in faults
    try:
        return train(lambda p: loss_and_grads(p, pat, x, y, cfg, rows), params0, config["optimizer"], steps,
                     frozen="frozen" in faults)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
