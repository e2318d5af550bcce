"""Sparse × dense matmul (SpMM) dispatch, the COO engine and ``aggregate``.

Port of ``mg_gcn_tpu/ops/spmm.py``. The COO engine (``impl="xla"``) is the
plain PyTorch counterpart of the JAX package's XLA gather + segment-sum:
``index_select`` of B's rows, a multiply by the edge values and an
``index_add_`` into C, streamed in edge chunks so the gathered
(edges, d) block stays under ``GATHER_BYTES_CAP``.

``aggregate`` is a ``torch.autograd.Function`` whose backward multiplies by
the pre-transposed matrix ``pair.bwd`` (the reference keeps A and Aᵀ side
by side for this, gcn.hpp:13-48) instead of differentiating a scatter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..formats import CSRData
from .spmm_edges import EdgeTileMat, spmm_edge_tiles
from .spmm_gather import GatherMat, spmm_gather
from .spmm_pallas import TiledMat, spmm_tiled
from .spmm_pattern import PatternMat, round_up, spmm_pattern
from .spmm_pattern_sparse import BlockPatternMat, spmm_block_pattern

# cap on the gathered (edges, d) block of one COO chunk
GATHER_BYTES_CAP = 2 << 30
COO_PAD = 512  # edge lists are padded to a multiple of this


@dataclass(frozen=True)
class COOMat:
    """A sparse matrix as a row-sorted, padded COO edge list on a device.

    Padding edges carry ``val == 0`` and point at ``(n_rows - 1, 0)``, so
    accumulating consumers are unaffected by them.
    """

    rows: torch.Tensor  # int32[nnz_pad]
    cols: torch.Tensor  # int32[nnz_pad]
    vals: torch.Tensor  # float[nnz_pad]
    n_rows: int
    n_cols: int
    nnz: int  # true edge count (before padding)

    @property
    def nnz_pad(self) -> int:
        return self.rows.shape[0]

    @staticmethod
    def from_csr(csr: CSRData, device: str | torch.device = "cuda", val_dtype=np.float32) -> "COOMat":
        """``val_dtype=np.float64`` is the f64 mode's (``train(f64=True)``):
        the values are widened, not recomputed."""
        counts = np.diff(csr.indptr).astype(np.int64)
        rows = np.repeat(np.arange(csr.nrows, dtype=np.int32), counts)
        nnz = int(rows.shape[0])
        pad = max(round_up(nnz, COO_PAD), COO_PAD) - nnz
        rows_p = np.concatenate([rows, np.full(pad, csr.nrows - 1, np.int32)])
        cols_p = np.concatenate([csr.indices.astype(np.int32), np.zeros(pad, np.int32)])
        vals_p = np.concatenate([csr.data.astype(val_dtype), np.zeros(pad, val_dtype)])
        put = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
        return COOMat(
            rows=put(rows_p),
            cols=put(cols_p),
            vals=put(vals_p),
            n_rows=csr.nrows,
            n_cols=csr.ncols,
            nnz=nnz,
        )


def _spmm_coo(mat: COOMat, B: torch.Tensor) -> torch.Tensor:
    """C[i, :] = sum over edges (i, j, v) of v * B[j, :]."""
    d = B.shape[1]
    out = torch.zeros((mat.n_rows, d), dtype=B.dtype, device=B.device)
    chunk = max(1, GATHER_BYTES_CAP // max(d * B.element_size(), 1))
    for e0 in range(0, mat.nnz_pad, chunk):
        e1 = min(e0 + chunk, mat.nnz_pad)
        g = B.index_select(0, mat.cols[e0:e1]) * mat.vals[e0:e1, None].to(B.dtype)
        out.index_add_(0, mat.rows[e0:e1], g)
    return out


def spmm(mat, B: torch.Tensor) -> torch.Tensor:
    """``C = mat @ B`` for a device-resident :class:`COOMat`,
    :class:`~.spmm_pattern.PatternMat`,
    :class:`~.spmm_pattern_sparse.BlockPatternMat`,
    :class:`~.spmm_edges.EdgeTileMat`, :class:`~.spmm_gather.GatherMat` or
    :class:`~.spmm_pallas.TiledMat`."""
    if isinstance(mat, PatternMat):
        return spmm_pattern(mat, B)
    if isinstance(mat, BlockPatternMat):
        return spmm_block_pattern(mat, B)
    if isinstance(mat, EdgeTileMat):
        return spmm_edge_tiles(mat, B)
    if isinstance(mat, GatherMat):
        return spmm_gather(mat, B)
    if isinstance(mat, TiledMat):
        return spmm_tiled(mat, B)
    if isinstance(mat, COOMat):
        return _spmm_coo(mat, B)
    raise TypeError(f"no SpMM engine for {type(mat).__name__}")


@dataclass
class AggPair:
    """A forward/backward sparse-matrix pair: for GCN (Âᵀ, Â). Forward
    aggregation uses ``fwd``, the gradient ``bwd`` (gcn.hpp:13-48)."""

    fwd: Any
    bwd: Any


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, B: torch.Tensor, pair: AggPair) -> torch.Tensor:
        ctx.pair = pair
        return spmm(pair.fwd, B)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return spmm(ctx.pair.bwd, g), None


def aggregate(pair: AggPair, B: torch.Tensor) -> torch.Tensor:
    """``C = pair.fwd @ B``, whose gradient is ``G_B = pair.bwd @ G``."""
    return _Aggregate.apply(B, pair)
