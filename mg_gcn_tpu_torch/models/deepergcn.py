"""DeeperGCN: the ResGEN stack of pre-activation residual GENConv layers
with softmax aggregation and BatchNorm (Li, Xiong, Thabet and Ghanem,
*DeeperGCN: All You Need to Train Deeper GCNs*, arXiv:2006.07739), as its
authors trained it on ogbn-arxiv (``res+`` blocks, ``softmax_sg`` at a
fixed t, one-layer MLPs, no edge features).

For a layer input x (n × hidden)::

    GENConv(x) = Linear(x + a),   a = softmax_sg aggregation of ReLU(x) + ε
                                  (``ops/softmax_agg.py``)

and the model, L GENConv layers::

    h   = Enc(X);   h = GENConv_0(h)
    h   = h + GENConv_l(ReLU(BN_{l-1}(h)))        for l = 1 .. L-1
    out = Head(ReLU(BN_{L-1}(h)))

each BN a full-batch BatchNorm over all n rows in training mode
(``ops/batch_norm.py``). Parameters are a list of dicts, one a phase of
the stack, each dict the parameters its phase scopes use: 0 the encoder
(``W``, ``b``); 1 GENConv_0 (``W``, ``b``); l + 1 for l = 1 .. L-1 the
``res+`` block l, its pre-norm and its GENConv (``gamma``, ``beta``,
``W``, ``b``); L + 1 the head with the last norm (``gamma``, ``beta``,
``W``, ``b``). A ``W`` is (in, out) and applies as x·W + b. At ogbn-arxiv's
widths (128 in, hidden 128, 40 classes, 28 layers) that is the 491,176
parameters of the authors' leaderboard entry.

The layer stack is written once, over a list of row blocks with the
aggregation and the norm as callables (:func:`forward_blocks`); one card
passes one block. Training is exact autograd.

Phase scopes (``timers.scope``), tagged with the index k of the parameter
dict: ``k_0_matmul-gemm`` around the encoder, each GENConv's linear and
the head; ``k_0_matmul-spmm`` around the whole softmax aggregation;
``k_0_activation`` around BatchNorm and ReLU; ``k_0_residual`` around
x + a and the ``res+`` add; ``{L+2}_loss-layer`` around the loss. The
aggregation and the BatchNorm open ``k_1_matmul-spmm`` and
``k_1_activation`` around their backward, on the thread that runs it; the
linear, residual and encoder backward run in autograd outside any scope.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..formats import CSRData
from ..ops.batch_norm import batch_norm_relu
from ..ops.softmax_agg import OPERANDS, softmax_aggregate
from ..ops.softmax_xent import softmax_xent
from ..ops.spmm import AggPair
from ..timers import scope

AGGRS = ("softmax_sg",)


@dataclass(frozen=True)
class DeeperGCNConfig:
    sizes: tuple[int, int, int]  # (features, hidden, classes)
    layers: int = 28  # GENConv layers
    aggr: str = "softmax_sg"  # softmax aggregation with the weights detached
    t: float = 0.1  # the softmax's fixed temperature
    msg_eps: float = 1e-7  # ε of the messages ReLU(x) + ε
    norm: str = "batch"
    norm_eps: float = 1e-5
    operand: str = "bfloat16"  # the aggregation products' operand dtype
    loss_mask: str = "all"

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))
        if len(self.sizes) != 3 or min(self.sizes) < 1:
            raise ValueError(f"DeeperGCN takes sizes (features, hidden, classes), got {self.sizes}")
        if self.layers < 1:
            raise ValueError(f"DeeperGCN needs at least one GENConv layer, got {self.layers}")
        if self.aggr not in AGGRS:
            raise ValueError(f"aggregation {self.aggr!r}: the port's GENConv runs {'/'.join(AGGRS)} only (the "
                             "softmax with its weights detached, at a fixed temperature)")
        if not self.t > 0:
            raise ValueError(f"the softmax temperature must be positive, got {self.t}")
        if self.norm != "batch":
            raise ValueError(f"the port's DeeperGCN normalizes by BatchNorm, not {self.norm!r}")
        if self.operand not in OPERANDS:
            raise ValueError(f"the aggregation's operand is {'/'.join(OPERANDS)}, not {self.operand!r}")


def build_deepergcn_graph(graph: CSRData, device: str | torch.device = "cuda") -> AggPair:
    """The binary pair (Aᵀ, A) of the graph's structure on ``device``, for
    the binary CSR walk with no degree scales: row i of the forward matrix
    holds the entries j → i. The stored edge values are not read (GENConv
    here has no edge features); self loops should already be present."""
    from .. import resolve_device, sparse
    from ..ops.spmm_gather import gather_mat_from_csr

    dev = resolve_device(device)
    binary = CSRData(indptr=graph.indptr, indices=graph.indices, data=np.ones(graph.nnz, np.float32),
                     shape=graph.shape)
    return AggPair(fwd=gather_mat_from_csr(sparse.transpose(binary), device=dev),
                   bwd=gather_mat_from_csr(binary, device=dev))


def _linear(gen: torch.Generator, fan_in: int, fan_out: int) -> dict:
    """PyTorch's ``Linear`` init: W and b uniform in ±1/√fan_in."""
    bound = 1.0 / math.sqrt(fan_in)
    return dict(W=torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=gen),
                b=torch.empty(fan_out).uniform_(-bound, bound, generator=gen))


def init_params(config: DeeperGCNConfig, seed: int | None = None, device: str | torch.device = "cuda") -> list[dict]:
    """The parameter list (the module docstring's layout), PyTorch's default
    init: ``Linear`` weights and biases uniform in ±1/√fan_in, BatchNorm's
    ``gamma`` 1 and ``beta`` 0. Drawn on the CPU from a ``torch.Generator``
    seeded with ``seed`` (0 for None)."""
    gen = torch.Generator().manual_seed(0 if seed is None else seed)
    f, hidden, classes = config.sizes
    norm = dict(gamma=torch.ones(hidden), beta=torch.zeros(hidden))
    params = [_linear(gen, f, hidden), _linear(gen, hidden, hidden)]
    params += [{**{k: v.clone() for k, v in norm.items()}, **_linear(gen, hidden, hidden)}
               for _ in range(config.layers - 1)]
    params.append({**norm, **_linear(gen, hidden, classes)})
    return [{k: v.to(device) for k, v in layer.items()} for layer in params]


def _dense(hs, layers) -> list:
    return [torch.addmm(lp["b"], h, lp["W"]) for h, lp in zip(hs, layers)]


def forward_blocks(params: Sequence, aggregate, norm, xs, config: DeeperGCNConfig) -> list:
    """The stack over blocks of rows: ``params[j]`` is the parameter list
    block j computes with and ``xs[j]`` its input rows (one block on one
    card). ``aggregate(zs, k)`` maps the blocks' GENConv inputs to their
    aggregations and ``norm(hs, layers, k)`` the blocks' residual stream to
    ReLU(BatchNorm(·)) with the statistics of all rows, ``layers[j]`` block
    j's parameter dict k; ``k`` names the backward scopes. The blocks'
    logits."""
    with scope("0_0_matmul-gemm"):
        hs = _dense(xs, [p[0] for p in params])
    for k in range(1, config.layers + 1):
        layers = [p[k] for p in params]
        zs = hs
        if k > 1:
            with scope(f"{k}_0_activation"):
                zs = norm(hs, layers, k)
        with scope(f"{k}_0_matmul-spmm"):
            aggs = aggregate(zs, k)
        with scope(f"{k}_0_residual"):
            us = [z + a for z, a in zip(zs, aggs)]
        del zs, aggs
        with scope(f"{k}_0_matmul-gemm"):
            outs = _dense(us, layers)
        del us
        if k == 1:
            hs = outs
        else:
            with scope(f"{k}_0_residual"):
                hs = [h + o for h, o in zip(hs, outs)]
    k = config.layers + 1
    head = [p[k] for p in params]
    with scope(f"{k}_0_activation"):
        zs = norm(hs, head, k)
    with scope(f"{k}_0_matmul-gemm"):
        return _dense(zs, head)


def _one_card(pair: AggPair, config: DeeperGCNConfig):
    """(aggregate, norm) of :func:`forward_blocks` on one card: one block,
    the whole graph."""

    def aggregate(zs, k):
        (z,) = zs
        return [softmax_aggregate(pair.fwd, pair.bwd, z, config.t, config.msg_eps, config.operand, tag=k)]

    def norm(hs, layers, k):
        (h,), (lp,) = hs, layers
        return [batch_norm_relu(h, lp["gamma"], lp["beta"], config.norm_eps, tag=k)]

    return aggregate, norm


def forward(params: Sequence[dict], pair: AggPair, x: torch.Tensor, config: DeeperGCNConfig) -> torch.Tensor:
    return forward_blocks([params], *_one_card(pair, config), [x], config)[0]


def loss_and_grad(params, pair: AggPair, x, y, config: DeeperGCNConfig, mask=None):
    """(loss, acc, grads) by autograd from the logits' gradient, grads in
    the structure of params."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in params]
    with torch.enable_grad():
        logits = forward(leaves, pair, x, config)
    with scope(f"{config.layers + 2}_loss-layer"):  # one past the head's index
        out = softmax_xent(logits.detach(), y, mask)
        # a scalar whose gradient in the logits is out.grad, bit for bit: a
        # tensor ``grad_outputs`` would make autograd import torch.fx's
        # symbolic shapes (and sympy) on its first call, seconds of set-up
        surrogate = torch.sum(logits * out.grad)
    flat = [v for layer in leaves for v in layer.values()]
    flat_grads = iter(torch.autograd.grad(surrogate, flat))
    grads = [{k: next(flat_grads) for k in layer} for layer in leaves]
    return out.loss, out.acc, grads
