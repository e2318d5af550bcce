"""GraphSAGE (mean aggregator) — BASELINE.md config 4.

Port of ``mg_gcn_tpu/models/sage.py``. Each layer computes
``h' = act(h·W_self + mean_neighbors(h)·W_neigh + b)``, the mean
aggregation an SpMM with the *row*-normalized adjacency M (normalize(false)
in reference terms, matrix.hpp:341-349).

For a binary adjacency the aggregation runs on the bit-packed pattern pair
of GCN: M = diag(r)·P, so M·B = r ⊙ (P·B) (orientation "P", post-scale:
the backward pattern walk, ``pattern_bwd``) and Mᵀ·G = Pᵀ·(r ⊙ G)
(orientation "PT", pre-scale: the forward walk, ``pattern_fwd``), on one
shared pack. Training uses exact autograd gradients (there is no reference
backward to mirror for this model); layer 0's aggregation of the features
needs none, so an epoch launches L M-products and L - 1 Mᵀ-products.

The layer stack is written once, over a list of row blocks
(:func:`forward_blocks`): one block on one card, one a partition in
``parallel/dist.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from .. import resolve_device, sparse
from ..formats import CSRData
from ..nn import init as init_lib
from ..ops import elementwise as ew
from ..ops import spmm_pattern as sp
from ..ops.softmax_xent import softmax_xent
from ..ops.spmm import AggPair, COOMat, aggregate
from ..ops.spmm_edges import edge_pair_from_csr_pair
from ..ops.spmm_gather import gather_pair_from_csr_pair

IMPLS = ("auto", "pattern", "edge", "gather", "xla")


@dataclass(frozen=True)
class SAGEConfig:
    sizes: tuple[int, ...]
    leaky_slope: float = 0.01
    loss_mask: str = "all"
    # per-node l2 normalization of every hidden layer's output, after the
    # activation (the GraphSAGE paper's Algorithm 1 line 7, h = h/||h||_2):
    # without it the raw self-path saturates the softmax at hidden 512
    l2_normalize: bool = True

    @property
    def num_layers(self) -> int:
        return len(self.sizes) - 1


def l2_norm_rows(h: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-node l2 normalization, eps inside the rsqrt (``sage.py:52-54``)."""
    return h * torch.rsqrt(torch.sum(h * h, dim=-1, keepdim=True) + eps)


def build_sage_pair(
    graph: CSRData,
    impl: str = "auto",
    pack: torch.Tensor | None = None,
    dtype: str = "bfloat16",
    device: str | torch.device = "cuda",
) -> AggPair:
    """(M, Mᵀ) pair for mean aggregation, M the row-normalized adjacency.

    ``pack`` reuses a bit-packed pattern of the same graph already on
    ``device`` (a GCN PatternMat's): only the scale differs. ``dtype`` is the
    operand dtype of the pattern kernels (bfloat16 / float32 / int8); the
    edge engine takes bfloat16 where int8 is asked. impl="auto" is
    ``train.mean_engine``. A build that cannot run raises: where the JAX
    package falls back to its COO engine (``sage.py:113-121``), the port
    does not."""
    from ..train import mean_engine

    if impl not in IMPLS:
        raise ValueError(
            f"SAGE aggregation impl {impl!r} not available; use auto, "
            "pattern, edge, gather or xla"
        )
    dev = resolve_device(device)
    if impl == "auto":
        impl = mean_engine(graph, dev, have_pack=pack is not None)
    if impl == "pattern":
        if not sp.is_binary(graph):
            raise ValueError("pattern SpMM needs a binary adjacency (data == 1)")
        if dtype not in sp.DTYPES:
            raise ValueError(f"unknown pattern dtype {dtype!r} (expected {'/'.join(sp.DTYPES)})")
        n = graph.nrows
        n_pad = sp.round_up(n, sp.N_ALIGN)
        if pack is None:
            pack = sp.pack_bits_on_device(graph, n_pad, dev)
        scale = torch.from_numpy(sp.row_scale(graph, n_pad)).to(dev)
        fwd = sp.PatternMat(pack, scale, n, n_pad, graph.nnz, "P", "post", dtype)
        bwd = sp.PatternMat(pack, scale, n, n_pad, graph.nnz, "PT", "pre", dtype)
        return AggPair(fwd=fwd, bwd=bwd)
    m = sparse.normalize(graph, axis=False)
    m_t = sparse.transpose(m)
    if impl == "gather":
        fwd, bwd = gather_pair_from_csr_pair(m, m_t, device=dev)
    elif impl == "edge":
        fwd, bwd = edge_pair_from_csr_pair(m, m_t, dtype="bfloat16" if dtype == "int8" else dtype, device=dev)
    else:
        fwd, bwd = COOMat.from_csr(m, device=dev), COOMat.from_csr(m_t, device=dev)
    return AggPair(fwd=fwd, bwd=bwd)


def init_params(
    config: SAGEConfig, seed: int | None = None, device: str | torch.device = "cuda"
) -> list[dict]:
    """The parameter list ``[{Wself, Wneigh, b}, ...]``. ``seed=None`` uses
    the reference's seed-99 init, bit-equal to the JAX package: every
    matrix from a fresh seed-99 engine, so ``Wself == Wneigh``. A seed
    draws from a ``torch.Generator`` instead."""
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    params = []
    for i in range(config.num_layers):
        in_, out = config.sizes[i], config.sizes[i + 1]
        if gen is None:
            layer = dict(
                Wself=torch.from_numpy(init_lib.kaiming_uniform_ref(in_, out)),
                Wneigh=torch.from_numpy(init_lib.kaiming_uniform_ref(in_, out)),
                b=torch.from_numpy(init_lib.bias_ref(out)),
            )
        else:
            layer = dict(
                Wself=init_lib.kaiming_uniform(gen, in_, out),
                Wneigh=init_lib.kaiming_uniform(gen, in_, out),
                b=init_lib.bias_uniform(gen, out),
            )
        params.append({k: v.to(device=device, dtype=torch.float32) for k, v in layer.items()})
    return params


def forward_blocks(params: Sequence, agg, xs, config: SAGEConfig) -> list:
    """The layer stack over blocks of rows: ``params[j]`` is the parameter
    list block j computes with, ``xs[j]`` its input rows, and ``agg`` maps
    the blocks to their M·H blocks, differentiably (one block on one card,
    one a partition in ``parallel/dist.py``). The blocks' logits."""
    hs = xs
    for i in range(config.num_layers):
        lps = [p[i] for p in params]
        hs = [h @ lp["Wself"] + nb @ lp["Wneigh"] + lp["b"] for h, nb, lp in zip(hs, agg(hs), lps)]
        if i + 1 < config.num_layers:
            hs = [ew.leaky_relu(h, config.leaky_slope) for h in hs]
            if config.l2_normalize:
                hs = [l2_norm_rows(h) for h in hs]
    return hs


def forward(params: Sequence[dict], pair: AggPair, x: torch.Tensor, config: SAGEConfig) -> torch.Tensor:
    return forward_blocks([params], lambda hs: [aggregate(pair, h) for h in hs], [x], config)[0]


def loss_fn(params, pair, x, y, config: SAGEConfig, mask=None):
    out = softmax_xent(forward(params, pair, x, config), y, mask)
    return out.loss, out.acc


def loss_and_grad(params, pair, x, y, config: SAGEConfig, mask=None):
    """(loss, acc, grads) by autograd, grads in the structure of params."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in params]
    with torch.enable_grad():
        loss, acc = loss_fn(leaves, pair, x, y, config, mask)
        flat = [v for layer in leaves for v in layer.values()]
        flat_grads = iter(torch.autograd.grad(loss, flat))
    grads = [{k: next(flat_grads) for k in layer} for layer in leaves]
    return loss.detach(), acc.detach(), grads
