"""Differentiable edge-attention ops over the edge engine's CSR layout.

Port of ``mg_gcn_tpu/ops/edge_attention.py``: the composition layer over
the three structure-sharing kernels — ``spmm_edge_tiles`` (M(w) @ B),
``sddmm_edge_tiles`` (per-entry <A[r], B[c]>) and ``spmm_edge_tiles_t``
(Mᵀ(w) @ X) — as ``torch.autograd.Function`` s, so attention layers (GAT)
train end to end. Per-entry values (scores, attention weights, their
cotangents) live in CSR entry order, one per stored entry.

Gradient algebra (``edge_attention.py:11-16``)::

    scores = sddmm(M, A, B):   dA = M(g) @ B          (weighted SpMM)
                               dB = Mᵀ(g) @ A          (transposed SpMM)
    out = spmm(M(w), B):       dw = sddmm(M, g, B)     (per-entry dots)
                               dB = Mᵀ(w) @ g          (transposed SpMM)

Each backward computes only the cotangents autograd asks for
(``ctx.needs_input_grad``). CSR has no padding slots, so the JAX package's
``valid_mask`` (the valid-slot mask) has no counterpart: every entry is an
edge.
"""

from __future__ import annotations

import dataclasses

import torch

from .sddmm import sddmm_edge_tiles
from .spmm_edges import (
    DTYPES, EdgeTileMat, TSched, edge_tile_mat_from_csr, spmm_edge_tiles, spmm_edge_tiles_t, transposed_schedule,
)


def build_attention_graph(csr, dtype: str = "bfloat16", device: str | torch.device = "cuda"):
    """(EdgeTileMat, TSched) for a graph adjacency — the structural pair
    every op below shares, the transpose built once on ``device``. Every
    stored entry is kept, duplicates included: the JAX edge-tile layout gives
    each CSR entry its own slot (``spmm_edges.py:318-338``), so a duplicated
    edge gets two scores and two attention weights. Edge values are stored
    and read only by edge-weighted attention (they must then be positive —
    the bias is ``log w``, see models/gat.py). Self-loops should already be
    present."""
    m = edge_tile_mat_from_csr(csr, dtype=dtype, device=device, merge=False)
    return m, transposed_schedule(m)


def _with_w(mat: EdgeTileMat, w: torch.Tensor) -> EdgeTileMat:
    if mat.dtype_name == "int8":
        raise ValueError(
            "attention ops need dynamic entry weights — build the edge matrix "
            "in bfloat16 (int8 mode packs static quantized weights)"
        )
    return dataclasses.replace(mat, w=w.to(DTYPES[mat.dtype_name]).contiguous())


class _SDDMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, mat, sched):
        ctx.graph = (mat, sched)
        ctx.save_for_backward(a, b)
        return sddmm_edge_tiles(mat, a, b)

    @staticmethod
    def backward(ctx, g):
        (a, b), (mat, sched) = ctx.saved_tensors, ctx.graph
        da = db = None
        if ctx.needs_input_grad[0]:
            da = spmm_edge_tiles(_with_w(mat, g), b).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = spmm_edge_tiles_t(mat, sched, a, w_slots=g).to(b.dtype)
        return da, db, None, None


class _SpmmAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, b, mat, sched):
        ctx.graph = (mat, sched)
        ctx.save_for_backward(w, b)
        return spmm_edge_tiles(_with_w(mat, w), b)

    @staticmethod
    def backward(ctx, g):
        (w, b), (mat, sched) = ctx.saved_tensors, ctx.graph
        dw = db = None
        if ctx.needs_input_grad[0]:
            dw = sddmm_edge_tiles(mat, g, b).to(w.dtype)
        if ctx.needs_input_grad[1]:
            db = spmm_edge_tiles_t(mat, sched, g, w_slots=w).to(b.dtype)
        return dw, db, None, None


def sddmm(mat: EdgeTileMat, sched: TSched, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-entry scores ``<A[r_e], B[c_e]>`` (float32, CSR entry order);
    differentiable in A and B."""
    return _SDDMM.apply(a, b, mat, sched)


def spmm_attn(mat: EdgeTileMat, sched: TSched, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C = M(w) @ B`` (n_out, d) float32; differentiable in the entry
    weights and in B — the weighted-aggregation half of an attention
    layer."""
    return _SpmmAttn.apply(w, b, mat, sched)


def slot_softmax(mat: EdgeTileMat, sched: TSched, scores: torch.Tensor) -> torch.Tensor:
    """Row-wise softmax over each output row's entries, in the JAX
    package's two-pass form (``edge_attention.py:128-166``), kept exactly:
    pass 1 exponentiates ``clip(s − smax, −80, 0)`` under the global max and
    its row sums give ``lse₁[r] ≥ rowmax[r]``; pass 2 uses ``lse₁[r_e]`` (a
    d=1 SDDMM, stop-gradient) as the per-row shift and normalizes in log
    form, ``exp(s − shift − log Σ)``, with the 1e-30 guards. All shifts are
    stop-gradient per-row constants, so gradients flow only through pass 2.
    A row whose whole range sits ≳165 below the global max still
    underflows to alpha ≈ 0, as in the JAX package."""
    dev = scores.device
    ones = torch.ones((mat.n_in, 1), dtype=torch.float32, device=dev)
    sg = scores.detach()
    smax = torch.amax(sg) if sg.numel() else torch.zeros((), device=dev)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    # pass 1: clipped global shift -> per-row LSE estimate (>= row max)
    e1 = torch.exp(torch.clamp(sg - smax, -80.0, 0.0))
    rs1 = spmm_attn(mat, sched, e1, ones)  # (n_out, 1)
    lse1 = smax + torch.log(torch.clamp(rs1, min=1e-30))
    shift = sddmm(mat, sched, lse1, ones).detach()
    # pass 2: exact per-row normalization under the per-row shift
    e = torch.exp(scores - shift)
    rowsum = spmm_attn(mat, sched, e, ones)  # (n_out, 1)
    log_rs = torch.log(torch.clamp(rowsum, min=1e-30))
    slot_log_rs = sddmm(mat, sched, log_rs, ones)  # log rowsum[r_e] per entry
    return torch.exp(scores - shift - slot_log_rs)
