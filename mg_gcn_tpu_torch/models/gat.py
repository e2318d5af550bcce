"""Graph Attention Network (GAT) on the SDDMM / weighted-SpMM pair.

Port of ``mg_gcn_tpu/models/gat.py``. Each layer, per head::

    z      = h · W                                      (dense GEMM)
    s_e    = leaky_relu(a_dst·z[r_e] + a_src·z[c_e])     (d=2 SDDMM)
    alpha  = softmax over each row's entries             (slot_softmax)
    h'_r   = Σ_e alpha_e · z[c_e]                        (weighted SpMM)

Heads concatenate on hidden layers and average on the output layer
(Velickovic et al., arXiv:1710.10903). Parameters are a list of dicts of
tensors (``W``, ``a_dst``, ``a_src``, ``b``), the JAX package's tree, so
``convert`` carries them across. Training is exact autograd through the
attention ops of ``ops/edge_attention.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..formats import CSRData
from ..nn import init as init_lib
from ..ops import elementwise as ew
from ..ops.edge_attention import build_attention_graph, sddmm, slot_softmax, spmm_attn
from ..ops.softmax_xent import softmax_xent


@dataclass(frozen=True)
class GATConfig:
    sizes: tuple[int, ...]  # per-head widths: (in, h1, ..., out)
    heads: int = 1
    att_slope: float = 0.2  # LeakyReLU slope on attention scores
    leaky_slope: float = 0.01  # inter-layer activation
    loss_mask: str = "all"
    # weight the attention by the graph's (positive) edge values:
    # alpha_e ∝ w_e · exp(s_e), i.e. a log-weight bias on the scores
    edge_weighted: bool = False

    @property
    def num_layers(self) -> int:
        return len(self.sizes) - 1

    def layer_in(self, i: int) -> int:
        # hidden layers concatenate the previous layer's heads
        return self.sizes[i] * (self.heads if i > 0 else 1)


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
    H = config.heads
    for i in range(config.num_layers):
        in_, out = config.layer_in(i), config.sizes[i + 1]
        b_width = out * (H if i + 1 < config.num_layers else 1)
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


def _attend_head(mat, sched, z, e_dst, e_src, slope, bias=None):
    """alpha-weighted aggregation for one head's projected features z."""
    ones = torch.ones((z.shape[0], 1), dtype=torch.float32, device=z.device)
    s = sddmm(mat, sched,
              torch.cat([e_dst, ones], dim=1),  # <[e_dst_r, 1], [1, e_src_c]>
              torch.cat([ones, e_src], dim=1))
    s = ew.leaky_relu(s, slope)
    if bias is not None:
        s = s + bias
    alpha = slot_softmax(mat, sched, s)
    return spmm_attn(mat, sched, alpha, z)


def forward(params: Sequence[dict], graph, x: torch.Tensor, config: GATConfig) -> torch.Tensor:
    mat, sched = graph
    h = x
    H = config.heads
    bias = _log_weight_bias(mat) if config.edge_weighted else None
    for i, layer in enumerate(params):
        out = config.sizes[i + 1]
        z = h @ layer["W"]  # (n, H*out)
        heads = []
        for hd in range(H):
            zh = z[:, hd * out : (hd + 1) * out]
            e_dst = zh @ layer["a_dst"][hd][:, None]  # (n, 1)
            e_src = zh @ layer["a_src"][hd][:, None]
            heads.append(_attend_head(mat, sched, zh, e_dst, e_src, config.att_slope, bias))
        if i + 1 < config.num_layers:
            h = ew.leaky_relu(torch.cat(heads, dim=1) + layer["b"], config.leaky_slope)
        else:
            h = sum(heads) / H + layer["b"]  # average heads on the output
    return h


def loss_fn(params, graph, x, y, config: GATConfig, mask=None):
    out = softmax_xent(forward(params, graph, x, config), y, mask)
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
