"""Tiled-ELL SpMM — the ``impl="pallas"`` engine.

Port of ``mg_gcn_tpu/ops/spmm_pallas.py``. The sparse matrix is cut into
(br × bc) tiles; inside a tile each local row's entries sit in ELL slots,
``lcol``/``val`` of shape (n_rb, n_cb, K, br), slot-major, padded slots
carrying val 0 and lcol 0, and ``nsteps[rb, cb]`` the slots a tile uses.
K is the most entries any (tile, row) pair holds, over the whole matrix, so
one hub row inflates every tile: ``TiledMat.from_csr`` refuses a store over
4e9 bytes, as the JAX package's does, which keeps this a debug and
cross-check engine on small and regular graphs.

The product runs as a hand-written CUDA kernel (``csrc/spmm_tiled.cu``),
:func:`tiled`, in float32: threads over a row block's rows, each reading
its own slots and keeping 16 features of sums in registers, with each
column block's B rows staged in shared memory and padding slots skipped.
The wrapper launches it for a CUDA tensor and uses its plain PyTorch
version for a CPU tensor — only because the tensor lies on the CPU; nothing
falls back from one to the other. It counts its launches in
``tiled.launches`` by (dtype, d); :func:`tiled_geometry` reports the launch
geometry.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..formats import CSRData
from .spmm_pattern import query_geometry

STORE_BYTES_CAP = 4e9  # the JAX package's refusal (spmm_pallas.py:131-142)
_PLAIN_ELEMENTS_CAP = 1 << 26  # gathered B elements the plain version holds at once


@dataclass(frozen=True)
class TiledMat:
    """A sparse matrix in tiled ELL on a device."""

    lcol: torch.Tensor  # int32 [n_rb, n_cb, K, br] column within the column block
    val: torch.Tensor  # float32 [n_rb, n_cb, K, br], 0 in padded slots
    nsteps: torch.Tensor  # int32 [n_rb, n_cb] slots used by each tile
    n_rows: int
    n_cols: int
    nnz: int
    br: int
    bc: int

    @property
    def n_rb(self) -> int:
        return self.lcol.shape[0]

    @property
    def n_cb(self) -> int:
        return self.lcol.shape[1]

    @property
    def ell_k(self) -> int:
        return self.lcol.shape[2]

    @property
    def store_bytes(self) -> int:
        return self.lcol.numel() * 4 + self.val.numel() * 4

    @staticmethod
    def from_csr(csr: CSRData, br: int = 512, bc: int = 512, device: str | torch.device = "cuda") -> "TiledMat":
        """The tiled ELL of ``csr``: the JAX package's ``lcol``/``val``/
        ``nsteps`` arrays, element for element (an entry's slot is its rank
        among its row's entries in the same column block, in CSR order).

        Two passes over the row blocks: the first counts the slots each
        (tile, row) needs, so a store over 4e9 bytes is refused before any
        of it is allocated; the second places the entries."""
        n, m = csr.shape
        if br != bc:
            raise ValueError(
                "TiledMat requires square tiles (br == bc): Mosaic's vector "
                "gather constrains the gather table and output to one shape"
            )
        n_rb, n_cb = -(-n // br), -(-m // bc)
        indptr = csr.indptr.astype(np.int64, copy=False)

        def block(rb):
            """(entry range, slot keys cb*br + local row, local columns) of row block rb."""
            r0, r1 = rb * br, min((rb + 1) * br, n)
            e0, e1 = int(indptr[r0]), int(indptr[r1])
            cols = csr.indices[e0:e1].astype(np.int64)
            lrow = np.repeat(np.arange(r1 - r0, dtype=np.int64), np.diff(indptr[r0 : r1 + 1]))
            return (e0, e1), (cols // bc) * br + lrow, cols % bc

        nsteps = np.zeros((n_rb, n_cb), np.int32)
        for rb in range(n_rb):
            _, key, _ = block(rb)
            if key.size:
                keys, counts = np.unique(key, return_counts=True)
                np.maximum.at(nsteps[rb], keys // br, counts.astype(np.int32))
        K = max(int(nsteps.max(initial=0)), 1)
        bytes_needed = 2 * n_rb * n_cb * K * br * 4
        if bytes_needed > STORE_BYTES_CAP:
            raise ValueError(
                f"TiledMat ELL storage would need {bytes_needed/1e9:.1f} GB "
                f"(K={K} slots x {n_rb * n_cb} tiles); this debug kernel "
                "only supports small/regular graphs — use impl='pattern', "
                "'block' or 'xla'"
            )
        lcol = np.zeros((n_rb, n_cb, K, br), np.int32)
        val = np.zeros((n_rb, n_cb, K, br), np.float32)
        for rb in range(n_rb):
            (e0, e1), key, lc = block(rb)
            if not key.size:
                continue
            order = np.argsort(key, kind="stable")
            key_s = key[order]
            first = np.flatnonzero(np.concatenate([[True], key_s[1:] != key_s[:-1]]))
            slot = np.arange(key_s.size) - np.repeat(first, np.diff(np.append(first, key_s.size)))
            cb, lrow = key_s // br, key_s % br
            lcol[rb, cb, slot, lrow] = lc[order]
            val[rb, cb, slot, lrow] = csr.data[e0:e1][order]
        put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return TiledMat(lcol=put(lcol), val=put(val), nsteps=put(nsteps), n_rows=n, n_cols=m,
                        nnz=csr.nnz, br=br, bc=bc)


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernel (CPU path, and the reference the kernel
# is held against on the card)


def tiled_plain(mat: TiledMat, b: torch.Tensor, acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of :func:`tiled`: for every tile's used slots,
    ``index_add_`` val·B[cb·bc + lcol] into the row's sum, in (tile, slot)
    order. Sums in B's dtype, or in ``acc_dtype``."""
    src = b.to(acc_dtype or b.dtype)
    n_rb, n_cb, K, br = mat.lcol.shape
    out = torch.zeros((n_rb * br, b.shape[1]), dtype=src.dtype, device=b.device)
    lane = torch.arange(br, device=b.device)
    # the used (row block, column block, slot) steps, in order
    steps = torch.nonzero(torch.arange(K, device=b.device) < mat.nsteps[..., None].long())
    per = max(1, _PLAIN_ELEMENTS_CAP // (br * max(b.shape[1], 1)))
    for s0 in range(0, steps.shape[0], per):
        ri, ci, ki = steps[s0 : s0 + per].unbind(1)
        rows = (ri * br)[:, None] + lane
        cols = (ci * mat.bc)[:, None] + mat.lcol[ri, ci, ki].long()
        vals = mat.val[ri, ci, ki].to(src.dtype)
        out.index_add_(0, rows.reshape(-1), src.index_select(0, cols.reshape(-1)) * vals.reshape(-1, 1))
    return out


# ---------------------------------------------------------------------------
# the kernel wrapper


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_tiled")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mggcn_tiled.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.mggcn_tiled.restype = ctypes.c_int
    lib.mggcn_tiled_geometry.argtypes = [i, i, i, i, i, i, p]
    lib.mggcn_tiled_geometry.restype = ctypes.c_int
    lib.mggcn_error_string.argtypes = [ctypes.c_int]
    lib.mggcn_error_string.restype = ctypes.c_char_p
    return lib


TILED_GEOMETRY_KEYS = ("grid_x", "grid_y", "threads", "smem", "stages", "blocks_per_sm", "resident_blocks")


def tiled_geometry(mat: TiledMat, d: int) -> dict:
    """The launch geometry of :func:`tiled` for ``mat`` and B of width d:
    grid, threads, dynamic shared memory, B stages and resident blocks."""
    return query_geometry(_lib(), "mggcn_tiled_geometry", mat.n_rb, mat.n_cb, mat.ell_k, mat.br, mat.bc, d,
                          keys=TILED_GEOMETRY_KEYS)


def tiled(mat: TiledMat, b: torch.Tensor) -> torch.Tensor:
    """C = M B for the tiled ELL ``mat`` and row-major float32 B
    (n_cb·bc, d); C is float32 (n_rb·br, d).
    Replaces ``mg_gcn_tpu/ops/spmm_pallas.py:_spmm_kernel``."""
    if b.device.type == "cpu":
        return tiled_plain(mat, b)
    if any(t.device != b.device for t in (mat.lcol, mat.val, mat.nsteps)):
        raise ValueError("tiled: the ELL store and B must lie on one CUDA device")
    if b.dtype != torch.float32 or b.dim() != 2 or not b.is_contiguous():
        raise ValueError("tiled: B must be a contiguous 2-D float32 tensor")
    if b.shape[0] != mat.n_cb * mat.bc or b.shape[1] == 0:
        raise ValueError(f"tiled: B shape {tuple(b.shape)} is not (n_cb * bc = {mat.n_cb * mat.bc}, d > 0)")
    if not all(t.is_contiguous() for t in (mat.lcol, mat.val, mat.nsteps)):
        raise ValueError("tiled: the ELL store must be contiguous")
    d = b.shape[1]
    out = torch.empty((mat.n_rb * mat.br, d), dtype=torch.float32, device=b.device)
    lib = _lib()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.mggcn_tiled(mat.lcol.data_ptr(), mat.val.data_ptr(), mat.nsteps.data_ptr(), b.data_ptr(),
                              out.data_ptr(), mat.n_rb, mat.n_cb, mat.ell_k, mat.br, mat.bc, d, stream)
    if err != 0:
        raise RuntimeError(f"tiled: CUDA error {err} ({lib.mggcn_error_string(err).decode()})")
    tiled.launches[("float32", d)] += 1
    return out


tiled.launches = collections.Counter()


def spmm_tiled(mat: TiledMat, b: torch.Tensor) -> torch.Tensor:
    """``C = mat @ B`` for B (n_cols, d): B's rows are padded to the column
    blocks' n_cb·bc and C is trimmed to (n_rows, d)."""
    n = mat.n_cb * mat.bc
    if b.shape[0] > n:
        raise ValueError(f"B has {b.shape[0]} rows, tiled matrix expects <= {n}")
    if b.shape[0] < n:
        b = torch.cat([b, b.new_zeros((n - b.shape[0], b.shape[1]))])
    return tiled(mat, b.contiguous())[: mat.n_rows]
