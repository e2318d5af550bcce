"""Plain PyTorch pieces the references share: the degree-normalized sparse
operator and its transpose, the softmax cross-entropy and Adam. Written from
MG-GCN's equations (gcn.hpp, cuda_utils.cu); imports nothing of the port.
Every function takes its dtype from its inputs, so the same code runs in
float32 on the card and in float64 as the tests' twin; the aggregation's
operand is rounded to the configuration's ``aggregation_dtype``."""

from __future__ import annotations

import warnings

import numpy as np
import torch

# torch.sparse.mm on CSR tensors is the plain product here; its beta notice says nothing of use
warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")


class SparseOperator:
    """The aggregation over a binary pattern M0 (n × n) whose rows are scaled
    by s = 1 / (the row's entry count), at the configuration's precision:

        forward(B)  = s ⊙ (M0 · r(B))        (D⁻¹·M0 applied to B)
        backward(G) = M0ᵀ · r(s ⊙ G)         (its transpose applied to G)

    r rounds the dense operand to ``operand`` (the configuration's
    ``aggregation_dtype``; None keeps it), the pattern is exact and the sums
    and the scaling are in the inputs' dtype: a bfloat16 operand with float32
    sums, as the configurations state. ``blocks`` > 1 keeps only the entries
    whose row and column fall in the same of that many equal row ranges, at
    the full graph's scale: the exchange between partitions left out (a
    planted fault)."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor, n: int, dtype: torch.dtype, blocks: int = 1,
                 operand: torch.dtype | None = None):
        deg = torch.bincount(rows, minlength=n).to(dtype)
        self.scale = torch.where(deg > 0, 1.0 / deg, torch.zeros_like(deg))[:, None]
        if blocks > 1:
            size = -(-n // blocks)
            keep = torch.div(rows, size, rounding_mode="floor") == torch.div(cols, size, rounding_mode="floor")
            rows, cols = rows[keep], cols[keep]
        self.n, self.operand = n, operand
        ones = torch.ones(rows.numel(), dtype=dtype, device=rows.device)
        self.fwd = _csr(rows, cols, ones, n)
        order = torch.argsort(cols * n + rows)
        self.bwd = _csr(cols[order], rows[order], ones, n)

    def rounded(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.operand is None else x.to(self.operand).to(x.dtype)

    def forward(self, b: torch.Tensor) -> torch.Tensor:
        return self.scale * spmm(self.fwd, self.rounded(b))

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        return spmm(self.bwd, self.rounded(self.scale * g))


OPERAND = {"float32": None, "float64": None, "bfloat16": torch.bfloat16, "float16": torch.float16}


def operand_dtype(config: dict) -> torch.dtype | None:
    """The dtype the configuration rounds the aggregation's operand to."""
    return OPERAND[config["aggregation_dtype"]]


def _csr(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """The CSR tensor of entries already sorted by row."""
    crow = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, cols.to(torch.int64), vals, (n, n), check_invariants=False)


def coo_of(indptr: np.ndarray, indices: np.ndarray, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) int64 on ``device`` of a host CSR pattern, row-sorted."""
    ptr = torch.from_numpy(np.asarray(indptr, np.int64)).to(device)
    cols = torch.from_numpy(np.asarray(indices)).to(device).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(ptr.numel() - 1, device=device), ptr[1:] - ptr[:-1])
    return rows, cols


def transposed(rows: torch.Tensor, cols: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The entries of the transpose, row-sorted."""
    order = torch.argsort(cols * n + rows)
    return cols[order], rows[order]


def spmm(csr: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sparse.mm(csr, b)


class Aggregate(torch.autograd.Function):
    """C = op.forward(B), whose gradient is op.backward(G)."""

    @staticmethod
    def forward(ctx, b: torch.Tensor, op: SparseOperator) -> torch.Tensor:
        ctx.op = op
        return op.forward(b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.op.backward(g), None


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x > 0, x, slope * x)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, rows: int | None = None):
    """(loss, gradient on the logits) of the softmax cross-entropy averaged
    over the first ``rows`` rows (all by default; fewer is a planted fault:
    part of the batch left out, the mean taken over the rest), the
    probability clamped at the dtype's smallest normal before the log
    (gcn.hpp:651-675, 785-818)."""
    n = logits.shape[0] if rows is None else rows
    z = logits - torch.amax(logits, dim=1, keepdim=True)
    e = torch.exp(z)
    o = e / torch.sum(e, dim=1, keepdim=True)
    y = labels.long()
    p = torch.gather(o, 1, y[:, None])[:, 0]
    logp = torch.log(torch.clamp(p, min=torch.finfo(o.dtype).tiny))
    g = o.clone()
    g[torch.arange(o.shape[0], device=o.device), y] -= 1.0
    if n < o.shape[0]:
        logp = logp[:n]
        g[n:] = 0.0
    return -torch.sum(logp) / n, g / n


def adam_step(params: dict, grads: dict, m: dict, v: dict, t: int, opt: dict) -> None:
    """One Adam update in place, MG-GCN's rule (gcn.hpp:158,
    cuda_utils.cu:208-218): weight decay added to the gradient of every
    weight matrix (a leaf named ``W*``) before the moments, bias
    corrections 1 - beta^t in the parameters' dtype."""
    b1, b2 = opt["beta1"], opt["beta2"]
    for k, p in params.items():
        g = grads[k]
        if opt["weight_decay"] and k.rsplit(".", 1)[-1].startswith("W"):
            g = g + opt["weight_decay"] * p
        m[k] = (1.0 - b1) * g + b1 * m[k]
        v[k] = (1.0 - b2) * g * g + b2 * v[k]
        tt = torch.tensor(float(t), dtype=p.dtype)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=p.dtype), tt)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=p.dtype), tt)
        params[k] = p - opt["lr"] * (m[k] / bc1.to(p.device)) / (torch.sqrt(v[k] / bc2.to(p.device)) + opt["eps"])


def train(loss_and_grads, params0: dict, opt: dict, steps: int, frozen: bool = False) -> dict:
    """``steps`` training steps from ``params0``: {"losses": [...], "grad1":
    the first step's gradients, "change": the parameters' change after the
    last step}. ``frozen`` plants the fault of a step that returns its
    state unchanged."""
    params = {k: p.clone() for k, p in params0.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        loss, grads = loss_and_grads(params)
        losses.append(float(loss))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        if not frozen:
            adam_step(params, grads, m, v, t, opt)
    return dict(losses=losses, grad1=grad1, change={k: params[k] - params0[k] for k in params})
