"""Ultra-sparse SpMM — the serial-gather engine.

Port of ``mg_gcn_tpu/ops/spmm_gather.py`` (``GatherMat``,
``gather_mat_from_csr``, ``spmm_gather``, ``gather_pair_from_csr_pair``,
``gather_pair_from_binary_csr``): ``C = M · B`` with O(nnz) work whatever the
density, the engine of products-scale graphs, whose n²/8 pattern store
would not fit a card and whose edge-tile slot fill collapses.

**Layout.** Row-sorted CSR on the device: ``indptr`` int64, ``indices``
int32, ``w`` float32 or None for a binary matrix (all values 1), whose
GCN normalization rides as a diagonal ``scale`` applied before ("pre", to
B's rows) or after ("post", to C's rows) the product. The TPU kernel's pair
and single entries, windows, super-tiles, accumulator banks and
``R_ROWS``/``W_ROWS``/``E_BLK`` work around its serial scalar walk
(``spmm_gather.py:15-55``) and are not part of the contract.

``stream_bf16`` rounds the (pre-scaled) operand to bfloat16 and the kernel
widens it back to float32 at load; the walk itself stays float32. It is a
property of the matrix, overridable per call — no environment variable
selects it.

The product runs as a hand-written CUDA kernel (``csrc/spmm_gather.cu``,
on the row walk of ``csrc/csr_walk.cuh`` that the edge kernels share):
:func:`gather` (``_gather_kernel``). The wrapper launches it for a CUDA
tensor and uses its plain PyTorch version for a CPU tensor — only because
the tensor lies on the CPU. It counts its launches in ``gather.launches``
by (B's dtype, d_pad); :func:`gather_geometry` reports a launch's geometry.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import sparse
from ..formats import CSRData
from .spmm_edges import (
    CSR_WALK_GEOMETRY_KEYS, check_csr, check_csr_operands, csr_plain, load_csr_lib, pad_features, run_csr_kernel,
)
from .spmm_pattern import query_geometry

_B_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class GatherMat:
    """A sparse matrix as row-sorted CSR on a device (C = M @ B), with an
    optional diagonal scale folded around a binary walk."""

    indptr: torch.Tensor  # int64 [n_out + 1]
    indices: torch.Tensor  # int32 [nnz]
    w: torch.Tensor | None  # float32 [nnz]; None when binary
    scale: torch.Tensor | None  # float32 [n_in] (pre) or [n_out] (post)
    n_out: int
    n_in: int
    nnz: int
    scale_side: str = "none"  # "none" | "pre" | "post"
    stream_bf16: bool = False  # B rides in bfloat16, the walk in float32

    @property
    def has_w(self) -> bool:
        return self.w is not None


def gather_mat_from_csr(
    csr: CSRData,
    device: str | torch.device = "cuda",
    scale: np.ndarray | None = None,
    scale_side: str = "none",
    stream_bf16: bool = False,
) -> GatherMat:
    """Upload a sparse matrix to ``device``. Any edge values; all-ones values
    (or no entries) give a binary, w-less matrix — pass ``scale`` and
    ``scale_side`` to fold a diagonal normalization around it
    (``spmm_gather.py:159-177``)."""
    if scale_side not in ("none", "pre", "post"):
        raise ValueError(f"unknown scale_side {scale_side!r} (expected none/pre/post)")
    if (scale is None) != (scale_side == "none"):
        raise ValueError("pass scale exactly when scale_side is 'pre' or 'post'")
    check_csr(csr, "gather")
    dev = torch.device(device)
    data = csr.data.astype(np.float32, copy=False)
    binary = csr.nnz == 0 or bool((data == 1.0).all())
    return GatherMat(
        indptr=torch.from_numpy(csr.indptr.astype(np.int64)).to(dev),
        indices=torch.from_numpy(np.ascontiguousarray(csr.indices, np.int32)).to(dev),
        w=None if binary else torch.from_numpy(data).to(dev),
        scale=None if scale is None else torch.from_numpy(np.asarray(scale, np.float32)).to(dev),
        n_out=csr.nrows,
        n_in=csr.ncols,
        nnz=csr.nnz,
        scale_side=scale_side,
        stream_bf16=stream_bf16,
    )


def gather_pair_from_csr_pair(
    csr_fwd: CSRData, csr_bwd: CSRData, **kw
) -> tuple[GatherMat, GatherMat]:
    """(forward Âᵀ @, backward Â @) pair for already-normalized weighted
    matrices (gcn.hpp:13-48). For binary adjacencies prefer
    :func:`gather_pair_from_binary_csr`."""
    return gather_mat_from_csr(csr_fwd, **kw), gather_mat_from_csr(csr_bwd, **kw)


def gather_pair_from_binary_csr(
    graph: CSRData, device: str | torch.device = "cuda", stream_bf16: bool = False
) -> tuple[GatherMat, GatherMat]:
    """(Âᵀ, Â) gather pair for a *binary* adjacency, with the GCN in-degree
    normalization factored into diagonal scales around binary walks, exactly
    as ``spmm_gather.py:756-777``:

        Â   = A / colsum  ⇒  Â @ B  = A @ (B / colsum_rows)   (pre-scale)
        Âᵀ  = diag(1/colsum) @ Aᵀ ⇒ Âᵀ @ B = (Aᵀ @ B) / colsum (post-scale)
    """
    if graph.nnz and not bool((graph.data == 1).all()):
        raise ValueError("gather_pair_from_binary_csr needs an all-ones adjacency")
    cs = np.bincount(graph.indices.astype(np.int64), minlength=graph.ncols).astype(np.float32)
    inv_cs = 1.0 / np.maximum(cs, 1.0)
    kw = dict(device=device, scale=inv_cs, stream_bf16=stream_bf16)
    fwd = gather_mat_from_csr(sparse.transpose(graph), scale_side="post", **kw)
    bwd = gather_mat_from_csr(graph, scale_side="pre", **kw)
    return fwd, bwd


# ---------------------------------------------------------------------------
# the kernel, its plain version and the wrapper


def gather_plain(indptr, indices, w, b) -> torch.Tensor:
    """Plain version of :func:`gather`: B widened to float32, float32 sums;
    ``w=None`` is the binary walk."""
    return csr_plain(indptr, indices, w, b, torch.float32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_csr_lib("spmm_gather", mggcn_gather=(4, 1))
    i = ctypes.c_int
    lib.mggcn_gather_geometry.argtypes = [ctypes.c_longlong, i, i, i, ctypes.c_void_p]
    lib.mggcn_gather_geometry.restype = i
    return lib


def gather_geometry(n_out: int, d_pad: int, dtype: torch.dtype, weighted: bool) -> dict:
    """The launch geometry of :func:`gather` over ``n_out`` output rows of
    width ``d_pad`` with B in ``dtype``, from the card (the keys of
    ``spmm_edges.edge_geometry``)."""
    return query_geometry(_lib(), "mggcn_gather_geometry", n_out, d_pad, int(weighted), _B_CODE[dtype],
                          keys=CSR_WALK_GEOMETRY_KEYS)


def gather(indptr: torch.Tensor, indices: torch.Tensor, w: torch.Tensor | None, b: torch.Tensor) -> torch.Tensor:
    """C = M B for the CSR matrix (indptr, indices, float32 w or None for
    binary) and row-major B (n_in, d_pad) in float32 or bfloat16; C is
    float32 (n_out, d_pad).
    Replaces ``mg_gcn_tpu/ops/spmm_gather.py:_gather_kernel``."""
    if b.device.type == "cpu":
        return gather_plain(indptr, indices, w, b)
    check_csr_operands("gather", indptr, indices, w, b, (torch.float32,), tuple(_B_CODE))
    out = torch.empty((indptr.numel() - 1, b.shape[1]), dtype=torch.float32, device=b.device)
    if out.shape[0]:
        ptrs = [indptr.data_ptr(), indices.data_ptr(), None if w is None else w.data_ptr(), b.data_ptr()]
        run_csr_kernel(_lib(), "mggcn_gather", ptrs, out, _B_CODE[b.dtype])
        gather.launches[(str(b.dtype).removeprefix("torch."), b.shape[1])] += 1
    return out


gather.launches = collections.Counter()


def spmm_gather(mat: GatherMat, b: torch.Tensor, stream_bf16: bool | None = None) -> torch.Tensor:
    """``C = M @ B`` for row-major B (n_in, d); returns (n_out, d) float32.

    In the JAX wrapper's order (``spmm_gather.py:730-743``): B to float32,
    the pre-scale, in stream mode the round to bfloat16, the kernel, the
    post-scale. ``stream_bf16=None`` takes the matrix's own flag."""
    if stream_bf16 is None:
        stream_bf16 = mat.stream_bf16
    n, d = b.shape
    if n != mat.n_in:
        raise ValueError(f"B has {n} rows, gather matrix expects {mat.n_in}")
    b = b.to(torch.float32)
    if mat.scale_side == "pre":
        b = b * mat.scale[:n, None]
    bm = pad_features(b, torch.bfloat16 if stream_bf16 else torch.float32)
    out = gather(mat.indptr, mat.indices, mat.w, bm)[:, :d]
    if mat.scale_side == "post":
        out = out * mat.scale[: mat.n_out, None]
    return out

