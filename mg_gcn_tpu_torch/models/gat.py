"""Graph Attention Network (GAT) on the SDDMM / weighted-SpMM pair.

Port of ``mg_gcn_tpu/models/gat.py``. Each layer, per head::

    z      = h · W                                      (dense GEMM)
    s_e    = leaky_relu(a_dst·z[r_e] + a_src·z[c_e])     (edge_softmax:
    alpha  = softmax over each row's entries              fused row walks)
    h'_r   = Σ_e alpha_e · z[c_e]                        (weighted SpMM)

Heads concatenate on hidden layers and average on the output layer
(Velickovic et al., arXiv:1710.10903). Each layer may have its own head
count (the paper's PPI model: 4, 4, 6), the hidden layers' activation is
LeakyReLU (the JAX package's) or ELU (the paper's), and a layer listed in
``skip`` adds its input to its output before the activation (the PPI
model's skip across its middle layer). Parameters are a list of dicts of
tensors (``W``, ``a_dst``, ``a_src``, ``b``), the JAX package's tree, so
``convert`` carries them across; the skip adds none. Training is exact
autograd through the attention ops of ``ops/edge_attention.py``.

The layer stack is written once, over a list of row blocks with a head's
attention as a callable (:func:`forward_blocks`): one block on one card,
one a partition with the ring attention of ``parallel/dist_gat.py``.

Phase scopes (``timers.scope``), layer l: ``l_0_matmul-gemm`` around the
projection and the score vectors, ``l_0_matmul-spmm`` around each head's
scores, softmax and weighted aggregation and the heads' combination,
``l_0_residual`` around the skip, ``l_0_activation`` around the
activation; ``L_loss-layer`` around the loss. The attention ops open
``l_1_matmul-spmm`` around their backward products, on the thread that
runs the backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..formats import CSRData
from ..nn import init as init_lib
from ..ops import elementwise as ew
from ..ops.edge_attention import build_attention_graph, edge_softmax, spmm_attn
from ..ops.softmax_xent import softmax_xent
from ..timers import scope

ACTIVATIONS = ("leaky", "elu")


@dataclass(frozen=True)
class GATConfig:
    sizes: tuple[int, ...]  # per-head widths: (in, h1, ..., out)
    heads: int | tuple[int, ...] = 1  # one count for every layer, or one a layer
    att_slope: float = 0.2  # LeakyReLU slope on attention scores
    leaky_slope: float = 0.01  # inter-layer LeakyReLU
    loss_mask: str = "all"
    # weight the attention by the graph's (positive) edge values:
    # alpha_e ∝ w_e · exp(s_e), i.e. a log-weight bias on the scores
    edge_weighted: bool = False
    activation: str = "leaky"  # between layers: "leaky" (leaky_slope) or "elu" (ELU, alpha 1)
    skip: tuple[int, ...] = ()  # layers whose input is added to their output, before the activation

    def __post_init__(self):
        if not isinstance(self.heads, int):
            object.__setattr__(self, "heads", tuple(int(h) for h in self.heads))
            if len(self.heads) != self.num_layers:
                raise ValueError(f"heads lists {len(self.heads)} counts for {self.num_layers} layers")
        if min(self.heads_of(i) for i in range(self.num_layers)) < 1:
            raise ValueError(f"every layer needs at least one head, got {self.heads}")
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r} (expected {'/'.join(ACTIVATIONS)})")
        object.__setattr__(self, "skip", tuple(sorted({int(i) for i in self.skip})))
        for i in self.skip:
            if not 0 <= i < self.num_layers:
                raise ValueError(f"skip layer {i} is not one of the {self.num_layers} layers")
            if self.layer_in(i) != self.layer_out(i):
                raise ValueError(f"a skip needs equal widths: layer {i} takes {self.layer_in(i)} features "
                                 f"and gives {self.layer_out(i)}")

    @property
    def num_layers(self) -> int:
        return len(self.sizes) - 1

    def heads_of(self, i: int) -> int:
        """Layer ``i``'s head count."""
        return self.heads if isinstance(self.heads, int) else self.heads[i]

    def layer_in(self, i: int) -> int:
        # hidden layers concatenate the previous layer's heads
        return self.sizes[i] * (self.heads_of(i - 1) if i > 0 else 1)

    def layer_out(self, i: int) -> int:
        """Layer ``i``'s output width: its heads concatenated on a hidden
        layer, their mean on the last."""
        return self.sizes[i + 1] * (self.heads_of(i) if i + 1 < self.num_layers else 1)


def build_gat_graph(graph: CSRData, dtype: str = "bfloat16", device: str | torch.device = "cuda"):
    """(EdgeTileMat, TSched) over the adjacency, on ``device``. The
    structure drives the attention; the stored edge values are read only
    when ``config.edge_weighted`` (they must then be positive). Self-loops
    should be present so every node attends at least to itself."""
    from .. import resolve_device

    return build_attention_graph(graph, dtype=dtype, device=resolve_device(device))


def _log_weight_bias(mat) -> torch.Tensor:
    """Per-entry ``log w_e`` of the compute-dtype weights, clamped to ±30
    (``gat.py:66-79``): an unbounded bias (w = 1e-30 → −69) would widen the
    score range past slot_softmax's per-row window and zero whole rows."""
    w = mat.w.to(torch.float32)
    return torch.clamp(torch.log(torch.clamp(w, min=1e-30)), -30.0, 30.0)


def init_params(config: GATConfig, seed: int | None = None, device: str | torch.device = "cuda") -> list[dict]:
    """Per layer: W (in, heads·out), attention vectors a_dst/a_src
    (heads, out), bias b (heads·out, or out on the averaged last layer).
    ``seed=None`` is the reference's seed-99 init, bit-equal to the JAX
    package's; a seed draws from a ``torch.Generator`` instead."""
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    params = []
    for i in range(config.num_layers):
        in_, out, H = config.layer_in(i), config.sizes[i + 1], config.heads_of(i)
        b_width = config.layer_out(i)
        if gen is None:
            w = np.concatenate([init_lib.kaiming_uniform_ref(in_, out) for _ in range(H)], axis=1)
            a = init_lib.kaiming_uniform_ref(out, 2 * H)  # columns: per-head pairs
            layer = dict(
                W=torch.from_numpy(w),
                a_dst=torch.from_numpy(a[:, :H].T.copy()),
                a_src=torch.from_numpy(a[:, H:].T.copy()),
                b=torch.zeros(b_width, dtype=torch.float32),
            )
        else:
            layer = dict(
                W=init_lib.kaiming_uniform(gen, in_, H * out),
                # attention vectors scale with the head width (fan_in=out)
                a_dst=init_lib.kaiming_uniform(gen, out, H).T.contiguous(),
                a_src=init_lib.kaiming_uniform(gen, out, H).T.contiguous(),
                b=torch.zeros(b_width, dtype=torch.float32),
            )
        params.append({k: v.to(device) for k, v in layer.items()})
    return params


def _attend_head(mat, sched, z, e_dst, e_src, slope, bias=None, tag=None):
    """alpha-weighted aggregation for one head's projected features z; the
    attention ops' backward scopes take the layer ``tag``."""
    alpha = edge_softmax(mat, sched, e_dst, e_src, slope, bias, tag=tag)
    return spmm_attn(mat, sched, alpha, z, tag=tag)


def _activate(h: torch.Tensor, config: GATConfig) -> torch.Tensor:
    """The activation between layers."""
    if config.activation == "elu":
        return F.elu(h)
    return ew.leaky_relu(h, config.leaky_slope)


def forward_blocks(params: Sequence, attend, xs, config: GATConfig) -> list:
    """The layer stack over blocks of rows: ``params[j]`` is the parameter
    list block j computes with and ``xs[j]`` its input rows (one block on
    one card, one a partition in ``parallel/dist_gat.py``).
    ``attend(zh, e_dst, e_src, tag)`` is one head's attention: the blocks'
    projected features and score vectors to their aggregated blocks, the
    layer index ``tag`` naming the attention ops' backward scopes. The
    blocks' logits."""
    hs = xs
    for i in range(config.num_layers):
        layers = [p[i] for p in params]
        out, H = config.sizes[i + 1], config.heads_of(i)
        hidden = i + 1 < config.num_layers
        with scope(f"{i}_0_matmul-gemm"):
            zs = [h @ lp["W"] for h, lp in zip(hs, layers)]  # (rows, H*out)
            zh = [[z[:, hd * out : (hd + 1) * out] for z in zs] for hd in range(H)]
            e_dst = [[z @ lp["a_dst"][hd][:, None] for z, lp in zip(zh[hd], layers)] for hd in range(H)]  # (rows, 1)
            e_src = [[z @ lp["a_src"][hd][:, None] for z, lp in zip(zh[hd], layers)] for hd in range(H)]
        with scope(f"{i}_0_matmul-spmm"):
            heads = [attend(zh[hd], e_dst[hd], e_src[hd], i) for hd in range(H)]
            # concatenate the heads on a hidden layer, average them on the output
            ys = [(torch.cat([hd[j] for hd in heads], dim=1) if hidden else sum(hd[j] for hd in heads) / H) + lp["b"]
                  for j, lp in enumerate(layers)]
        if i in config.skip:
            with scope(f"{i}_0_residual"):
                ys = [y + h for y, h in zip(ys, hs)]
        if hidden:
            with scope(f"{i}_0_activation"):
                ys = [_activate(y, config) for y in ys]
        hs = ys
    return hs


def forward(params: Sequence[dict], graph, x: torch.Tensor, config: GATConfig) -> torch.Tensor:
    mat, sched = graph
    bias = _log_weight_bias(mat) if config.edge_weighted else None

    def attend(zh, e_dst, e_src, tag):
        return [_attend_head(mat, sched, zh[0], e_dst[0], e_src[0], config.att_slope, bias, tag=tag)]

    return forward_blocks([params], attend, [x], config)[0]


def loss_fn(params, graph, x, y, config: GATConfig, mask=None):
    logits = forward(params, graph, x, config)
    with scope(f"{config.num_layers}_loss-layer"):
        out = softmax_xent(logits, y, mask)
    return out.loss, out.acc


def loss_and_grad(params, graph, x, y, config: GATConfig, mask=None):
    """(loss, acc, grads) by autograd, grads in the structure of params."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in params]
    with torch.enable_grad():
        loss, acc = loss_fn(leaves, graph, x, y, config, mask)
        flat = [v for layer in leaves for v in layer.values()]
        flat_grads = iter(torch.autograd.grad(loss, flat))
    grads = [{k: next(flat_grads) for k in layer} for layer in leaves]
    return loss.detach(), acc.detach(), grads
