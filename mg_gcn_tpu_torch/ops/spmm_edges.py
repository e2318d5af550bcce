"""Weighted-CSR SpMM — the edge engine, for any edge values.

Port of ``mg_gcn_tpu/ops/spmm_edges.py`` (``EdgeTileMat``,
``edge_tile_mat_from_csr``, ``spmm_edge_tiles``, ``edge_pair_from_csr_pair``
and the dispatch numbers ``_pick_br`` / ``expected_fill``). It computes
``C = M · B`` in O(nnz) work and memory, so it also serves binary graphs too
large for the pattern pair's n²/8 store.

**Layout.** The device layout is row-sorted CSR: ``indptr`` int64,
``indices`` int32 and one weight per entry. The JAX package's (br × 128)
slot chunks, its ``meta``/``chi`` step schedule, ``K``, ``CPS``, ``BCW``,
``D_MAX_E`` and chunk pairing route a gather through one-hot MXU matmuls
and fit the TPU's SMEM and VMEM (``spmm_edges.py:1-47``); on the card a
gather is an ordinary load, so none of them is part of the contract. The
attention stack, which consumes this layout, works in CSR edge order
(ROADMAP queue 1 item 7).

**What stays of the TPU kernel's numerics.**

* Weights are cast to the compute dtype (bfloat16 or float32) once, at
  upload, round to nearest even; B is cast to it by the wrapper; the kernel
  sums ``f32(w) · f32(B[c])`` in float32. A bf16 × bf16 product is exact in
  float32, so only the order of the sums differs from the TPU's.
* int8 mode quantizes the weights per output row on the host
  (``spmm_edges.py:288-302``) and B per feature on the device; the kernel
  sums ``wq · bq`` in int32 and the wrapper dequantizes
  (``spmm_edges.py:731-741``).
* Duplicate (row, col) entries are merged at build, as the TPU's
  materialized sub-tile cell merges them (``spmm_edges.py:575-584, 596,
  604-608, 634``): a float32 sum of the compute-dtype weights cast back to
  the compute dtype, or in int8 an integer sum of the quantized weights
  clipped to ±127.

The products run as hand-written CUDA kernels (``csrc/spmm_edges.cu``, on
the row walk of ``csrc/csr_walk.cuh`` that the gather kernel shares):
:func:`edge` (``_edge_kernel``), :func:`edge_i8` (``_edge_kernel_i8``) and
:func:`edge_t` (``_edge_t_kernel``).
Each wrapper launches its kernel for a CUDA tensor and uses its plain
PyTorch version for a CPU tensor — only because the tensor lies on the CPU.
Each counts its launches in ``.launches`` by (dtype, d_pad); a matrix
with no entry (an empty ring block) gives zeros and launches nothing. The walk
splits each row's entries over groups of lanes whose size follows d_pad:
:func:`csr_walk_geometry` states the rule, :func:`edge_geometry` reports a
launch's geometry from the card.

**The transposed product** (``TSched``, ``transposed_schedule``,
``spmm_edge_tiles_t``; ``spmm_edges.py:748-1131``), the backward half of
the attention ops. The JAX package reorders the slot chunks' grid steps by
column window (``TSched``, ``_transposed_core``) so that ``_edge_t_kernel``
accumulates each output window across consecutive steps. Here
:class:`TSched` is the CSR transpose of the matrix's structure, built once
on the matrix's device with a stable sort by column: ``t_indptr`` over the
columns, ``t_rows`` and ``perm``, the CSR entry of each transposed entry.
:func:`edge_t` (``csrc/spmm_edges.cu`` ``mggcn_edge_t``) walks it with the
row walk, reading each weight through ``perm``, so per-edge values stay in
CSR entry order and are never copied into transposed order. What the TPU
needed and the card does not has no counterpart: ``slot_valid_mask`` (CSR
has no padding slots), and ``auto_split``, ``MAX_STEPS``,
``pad_edge_schedule`` and ``transposed_step_words`` (the SMEM prefetch
budget of the schedule).
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
from .spmm_pattern import query_geometry, round_up

# dispatch numbers of the JAX edge-tile schedule (spmm_edges.py:63-64, 75),
# kept only for expected_fill: the edge-vs-gather choice of impl="auto"
BC = 128
K = 128
BR_CANDIDATES = (512, 640, 768, 896, 1024, 1280, 1536, 2048)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_W_CODE = {torch.float32: 0, torch.bfloat16: 1}
# gathered elements the plain versions hold at once (bounds their temporaries)
_PLAIN_ELEMS_CAP = 1 << 27


def _pick_br(n_out: int, n_in: int, nnz: int) -> tuple[int, bool]:
    """The JAX package's (row-tile height, chunk pairing) model pick
    (``spmm_edges.py:156-180``), number for number; the port uses it only
    through :func:`expected_fill`."""
    density = nnz / max(n_out * n_in, 1)
    best, best_score = (BR_CANDIDATES[0], False), -1.0
    for br in BR_CANDIDATES:
        lam = br * BC * density
        chunks = np.ceil(max(lam, 1e-9) / K)
        for paired in (False, True):
            eff_chunks = chunks + (chunks % 2) if paired else chunks
            fill = lam / (eff_chunks * K)
            cost = (0.75 + br / 512.0) + (0.125 if paired else 0.25) * br / 512.0
            score = fill / cost
            if score > best_score + 1e-9:
                best, best_score = (br, paired), score
    return best


def expected_fill(n_out: int, n_in: int, nnz: int) -> float:
    """Mean slot fill the JAX edge-tile schedule would reach
    (``spmm_edges.py:208-218``): the signal ``train._edge_or_gather``
    dispatches on, so both packages pick the same engine."""
    br, paired = _pick_br(n_out, n_in, nnz)
    density = nnz / max(n_out * n_in, 1)
    lam = br * BC * density
    chunks = np.ceil(max(lam, 1e-9) / K)
    if paired:
        chunks += chunks % 2
    return float(lam / (chunks * K))


@dataclass(frozen=True)
class EdgeTileMat:
    """A weighted sparse matrix as row-sorted CSR on a device (C = M @ B).

    ``w`` holds the weights in the compute dtype (bfloat16 or float32); in
    int8 mode ``w`` is None, ``wq`` holds the per-row quantized weights and
    ``row_scale`` the (n_out,) float32 dequant scales. ``nnz`` counts the
    stored entries, after duplicate (row, col) entries were merged (an
    attention graph keeps them: ``edge_tile_mat_from_csr(merge=False)``).
    """

    indptr: torch.Tensor  # int64 [n_out + 1]
    indices: torch.Tensor  # int32 [nnz]
    w: torch.Tensor | None  # bfloat16/float32 [nnz]; None in int8 mode
    wq: torch.Tensor | None  # int8 [nnz], int8 mode only
    row_scale: torch.Tensor | None  # float32 [n_out], int8 mode only
    n_out: int
    n_in: int
    nnz: int
    dtype_name: str = "bfloat16"

    @functools.cached_property
    def live_rows(self) -> torch.Tensor:
        """int32 ids of the rows with at least one entry, computed on the
        matrix's device at first use and kept: the rows the q-range SDDMM
        (``ops/sddmm.py``) launches over."""
        return torch.nonzero(self.indptr.diff() > 0).flatten().to(torch.int32)


def check_csr(csr: CSRData, engine: str) -> None:
    """Reject a CSR matrix the kernels could not read safely: 2^31 entries
    or more (int32 indices), an ``indptr`` that does not end at nnz, or a
    column index outside [0, ncols) (it would address past B's rows)."""
    if csr.nnz >= 2**31:
        raise ValueError(f"the {engine} engine takes fewer than 2^31 entries (int32 indices)")
    if len(csr.indptr) != csr.nrows + 1 or int(csr.indptr[0]) != 0 or int(csr.indptr[-1]) != csr.nnz:
        raise ValueError(f"malformed CSR: indptr must have nrows + 1 entries from 0 to nnz ({csr.nnz})")
    if csr.nnz and (int(csr.indices.min()) < 0 or int(csr.indices.max()) >= csr.ncols):
        raise ValueError(f"malformed CSR: column indices must lie in [0, {csr.ncols})")


def _rows_of(indptr: np.ndarray) -> np.ndarray:
    counts = np.diff(indptr).astype(np.int64)
    return np.repeat(np.arange(counts.size, dtype=np.int32), counts)


def _duplicate_runs(csr: CSRData) -> tuple[np.ndarray, np.ndarray] | None:
    """None when every row's column indices strictly increase (no duplicate
    entries: the common case, checked without sorting). Otherwise the order
    that sorts the entries by (row, col) and the start of each distinct
    (row, col) run in that order."""
    cols = csr.indices
    ok = np.empty(cols.size, bool)
    ok[0:1] = True
    np.greater(cols[1:], cols[:-1], out=ok[1:])
    starts = csr.indptr[1:-1]
    ok[starts[(starts > 0) & (starts < cols.size)]] = True  # a row's first entry
    if ok.all():
        return None
    key = _rows_of(csr.indptr).astype(np.int64) * csr.ncols + cols
    order = np.argsort(key, kind="stable")
    key = key[order]
    first = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
    return order, first


def edge_tile_mat_from_csr(
    csr: CSRData, dtype: str = "bfloat16", device: str | torch.device = "cuda", merge: bool = True
) -> EdgeTileMat:
    """Host-side preparation of a weighted CSR matrix (quantization in int8
    mode, duplicate merging), uploaded to ``device``. Any edge values.
    ``merge=False`` keeps duplicate (row, col) entries as separate entries,
    as the JAX package's attention graph keeps one slot for each."""
    if dtype not in DTYPES:
        raise ValueError(f"unsupported edge dtype {dtype!r} (expected {'/'.join(DTYPES)})")
    check_csr(csr, "edge")
    n_out, n_in = csr.shape
    indptr = csr.indptr.astype(np.int64)
    cols = csr.indices.astype(np.int32, copy=False)
    data = csr.data.astype(np.float32, copy=False)
    runs = _duplicate_runs(csr) if csr.nnz and merge else None
    if runs is not None:
        order, first = runs
        rows_m = _rows_of(indptr)[order][first]
        cols = cols[order][first]
        indptr = np.zeros(n_out + 1, np.int64)
        np.cumsum(np.bincount(rows_m, minlength=n_out), out=indptr[1:])
    row_scale = wq = w = None
    if dtype == "int8":
        # per-output-row symmetric scale, max|w| over the row's entries,
        # then np.rint(w / scale * 127) clipped to ±127: spmm_edges.py:288-302
        counts = np.diff(csr.indptr).astype(np.int64)
        absd = np.abs(data)
        row_scale = np.ones(n_out, np.float32)
        nz = counts > 0
        if absd.size and nz.any():
            row_scale[nz] = np.maximum.reduceat(absd, csr.indptr[:-1][nz])
        row_scale = np.maximum(row_scale, 1e-30)
        q = np.clip(np.rint(data / row_scale[_rows_of(csr.indptr)] * 127.0), -127, 127).astype(np.int32)
        if runs is not None:
            # the TPU's int8 cell: an int32 sum of the quantized duplicates,
            # clipped to ±127 (spmm_edges.py:604-608, 634)
            q = np.clip(np.add.reduceat(q[order], first), -127, 127) if q.size else q
        wq = torch.from_numpy(q.astype(np.int8))
    else:
        w = torch.from_numpy(data).to(DTYPES[dtype])  # round to nearest even, once
        if runs is not None:
            # the TPU's cell: a float32 sum of the compute-dtype weights,
            # cast back to the compute dtype (spmm_edges.py:575-584, 596)
            w32 = w.to(torch.float32).numpy()[order]
            w = torch.from_numpy(np.add.reduceat(w32, first)).to(DTYPES[dtype])
    dev = torch.device(device)
    put = lambda x: None if x is None else x.to(dev)  # noqa: E731
    return EdgeTileMat(
        indptr=put(torch.from_numpy(indptr)),
        indices=put(torch.from_numpy(np.ascontiguousarray(cols, np.int32))),
        w=put(w),
        wq=put(wq),
        row_scale=None if row_scale is None else put(torch.from_numpy(row_scale)),
        n_out=n_out,
        n_in=n_in,
        nnz=int(cols.size),
        dtype_name=dtype,
    )


def edge_pair_from_csr_pair(
    csr_fwd: CSRData, csr_bwd: CSRData, dtype: str = "bfloat16", **kw
) -> tuple[EdgeTileMat, EdgeTileMat]:
    """(forward Âᵀ @, backward Â @) pair for already-normalized weighted
    matrices (``spmm_edges.py:1134-1143``; gcn.hpp:13-48)."""
    return (
        edge_tile_mat_from_csr(csr_fwd, dtype=dtype, **kw),
        edge_tile_mat_from_csr(csr_bwd, dtype=dtype, **kw),
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions of the two kernels (CPU path, and the reference the
# kernels are held against on the card)


def csr_plain(indptr: torch.Tensor, indices: torch.Tensor, w: torch.Tensor | None,
              b: torch.Tensor, acc_dtype: torch.dtype) -> torch.Tensor:
    """C[r] = Σ_e w_e · B[c_e] over the CSR rows: the rows are expanded and
    each chunk of entries is ``index_select``-ed and ``index_add_``-ed in
    ``acc_dtype``. ``w=None`` sums the rows unweighted. Shared by the plain
    versions of the edge and gather kernels."""
    n_out, d = indptr.numel() - 1, b.shape[1]
    out = torch.zeros((n_out, d), dtype=acc_dtype, device=b.device)
    rows = torch.repeat_interleave(torch.arange(n_out, device=b.device), indptr.diff())
    src = b.to(acc_dtype)
    step = max(1, _PLAIN_ELEMS_CAP // max(d, 1))
    for e0 in range(0, indices.numel(), step):
        g = src.index_select(0, indices[e0 : e0 + step].long())
        if w is not None:
            g *= w[e0 : e0 + step, None].to(acc_dtype)
        out.index_add_(0, rows[e0 : e0 + step], g)
    return out


def edge_plain(indptr, indices, w, b) -> torch.Tensor:
    """Plain version of :func:`edge`: float32 products and sums."""
    return csr_plain(indptr, indices, w, b, torch.float32)


def edge_i8_plain(indptr, indices, wq, bq) -> torch.Tensor:
    """Plain version of :func:`edge_i8`: int64 sums (exact), cast to int32."""
    return csr_plain(indptr, indices, wq, bq, torch.int64).to(torch.int32)


# ---------------------------------------------------------------------------
# the kernel wrappers


def load_csr_lib(name: str, **entries: tuple[int, int]) -> ctypes.CDLL:
    """Load the CSR kernel library ``name``. Each entry named in ``entries``
    with (p, m) takes p operand pointers, the output pointer, a row count
    (long long), d_pad (int), then m int mode arguments, then the stream,
    and returns a cudaError_t."""
    lib = _build.load(name)
    for entry, (n_ptrs, n_modes) in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * (n_ptrs + 1) + [ctypes.c_longlong] + [ctypes.c_int] * (1 + n_modes) + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mggcn_error_string.argtypes = [ctypes.c_int]
    lib.mggcn_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_csr_lib("spmm_edges", mggcn_edge=(4, 1), mggcn_edge_i8=(4, 0), mggcn_edge_t=(5, 1))
    i = ctypes.c_int
    lib.mggcn_edge_geometry.argtypes = [ctypes.c_longlong, i, i, i, ctypes.c_void_p]
    lib.mggcn_edge_geometry.restype = i
    return lib


# the CSR walk's launch geometry (csrc/csr_walk.cuh csr::geometry): the
# stages slot of async_copy::write_geometry holds the B rows a lane has in
# flight
CSR_WALK_GEOMETRY_KEYS = ("grid_x", "grid_y", "threads", "smem", "in_flight", "blocks_per_sm", "resident_blocks",
                          "lanes", "groups")
_EDGE_KERNEL_CODE = {"edge": 0, "edge_i8": 1, "edge_t": 2}


def csr_walk_geometry(d_pad: int) -> dict:
    """The row walk's split of a warp at width ``d_pad`` (``csr_walk.cuh``
    ``lanes_for``): ``lanes`` L, the smallest power of two >= d_pad / 4
    (a lane loads 4 features) capped at 32, and ``groups`` G = 32 / L, the
    groups that take a row's entries in strides (group k: entries k, k + G,
    ...). d_pad 8 gives (2, 16), 48 and 64 give (16, 2), >= 128 (32, 1)."""
    if d_pad <= 0 or d_pad % 8:
        raise ValueError(f"d_pad must be a positive multiple of 8, got {d_pad}")
    lanes = 2
    while lanes < 32 and 4 * lanes < d_pad:
        lanes *= 2
    return {"lanes": lanes, "groups": 32 // lanes}


def edge_geometry(name: str, n_out: int, d_pad: int, dtype: torch.dtype) -> dict:
    """The launch geometry of kernel ``name`` (``edge``, ``edge_i8`` or
    ``edge_t``) over ``n_out`` output rows of width ``d_pad`` in ``dtype``,
    from the card: grid, threads, B rows in flight a lane, resident blocks,
    and the walk's ``lanes`` and ``groups`` (:func:`csr_walk_geometry`)."""
    return query_geometry(_lib(), "mggcn_edge_geometry", n_out, d_pad, _EDGE_KERNEL_CODE[name],
                          _W_CODE.get(dtype, 0), keys=CSR_WALK_GEOMETRY_KEYS)


def check_csr_operands(name: str, indptr, indices, w, b, w_dtypes, b_dtypes) -> None:
    """The checks every CSR kernel wrapper makes before a launch: one CUDA
    device, dtypes, shapes, contiguity, 16-byte alignment."""
    dev = b.device
    tensors = [indptr, indices, b] + ([w] if w is not None else [])
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: indptr, indices, weights and B must lie on one CUDA device")
    if indptr.dtype != torch.int64 or indices.dtype != torch.int32 or indptr.dim() != 1 or indices.dim() != 1:
        raise ValueError(f"{name}: indptr must be 1-D int64 and indices 1-D int32")
    if w is not None and (w.dtype not in w_dtypes or w.shape != indices.shape):
        raise ValueError(f"{name}: weights must be {'/'.join(map(str, w_dtypes))} of the indices' shape")
    if b.dtype not in b_dtypes or b.dim() != 2 or b.shape[1] % 8 or b.shape[1] == 0:
        raise ValueError(f"{name}: B must be 2-D {'/'.join(map(str, b_dtypes))} with d_pad % 8 == 0")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if b.data_ptr() % 16:
        raise ValueError(f"{name}: B must be 16-byte aligned")
    if indices.numel() >= 2**31:
        raise ValueError(f"{name}: fewer than 2^31 entries expected")


def run_csr_kernel(lib, name: str, ptrs: list, out: torch.Tensor, *extra) -> torch.Tensor:
    """Launch ``name(*ptrs, out, n_out, d_pad, *extra, stream)`` on the
    current stream of ``out``'s device; raises when the launch is refused."""
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, name)(*ptrs, out.data_ptr(), out.shape[0], out.shape[1], *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.mggcn_error_string(err).decode()})")
    return out


def edge(indptr: torch.Tensor, indices: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = M B for the CSR matrix (indptr, indices, w) and row-major B
    (n_in, d_pad); w and B both float32 or both bfloat16; C is float32
    (n_out, d_pad). Replaces ``mg_gcn_tpu/ops/spmm_edges.py:_edge_kernel``."""
    if b.device.type == "cpu":
        return edge_plain(indptr, indices, w, b)
    check_csr_operands("edge", indptr, indices, w, b, tuple(_W_CODE), tuple(_W_CODE))
    if w.dtype != b.dtype:
        raise ValueError(f"edge: weights ({w.dtype}) and B ({b.dtype}) must share the compute dtype")
    out = torch.empty((indptr.numel() - 1, b.shape[1]), dtype=torch.float32, device=b.device)
    if not indices.numel():  # no entry: zeros, no launch on an empty (null) pointer
        return out.zero_()
    if out.shape[0]:
        ptrs = [indptr.data_ptr(), indices.data_ptr(), w.data_ptr(), b.data_ptr()]
        run_csr_kernel(_lib(), "mggcn_edge", ptrs, out, _W_CODE[b.dtype])
        edge.launches[(str(b.dtype).removeprefix("torch."), b.shape[1])] += 1
    return out


def edge_i8(indptr: torch.Tensor, indices: torch.Tensor, wq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """acc = Mq Bq for int8 weights and an int8 row-major B (n_in, d_pad);
    acc is int32 (n_out, d_pad), exact.
    Replaces ``mg_gcn_tpu/ops/spmm_edges.py:_edge_kernel_i8``."""
    if bq.device.type == "cpu":
        return edge_i8_plain(indptr, indices, wq, bq)
    check_csr_operands("edge_i8", indptr, indices, wq, bq, (torch.int8,), (torch.int8,))
    out = torch.empty((indptr.numel() - 1, bq.shape[1]), dtype=torch.int32, device=bq.device)
    if not indices.numel():
        return out.zero_()
    if out.shape[0]:
        ptrs = [indptr.data_ptr(), indices.data_ptr(), wq.data_ptr(), bq.data_ptr()]
        run_csr_kernel(_lib(), "mggcn_edge_i8", ptrs, out)
        edge_i8.launches[("int8", bq.shape[1])] += 1
    return out


def edge_t_plain(t_indptr, t_rows, perm, w, a) -> torch.Tensor:
    """Plain version of :func:`edge_t`: :func:`csr_plain` over the
    transposed structure with the permuted weights, float32 sums."""
    return csr_plain(t_indptr, t_rows, w[perm.long()], a, torch.float32)


def edge_t(t_indptr: torch.Tensor, t_rows: torch.Tensor, perm: torch.Tensor, w: torch.Tensor,
           a: torch.Tensor) -> torch.Tensor:
    """C = Mᵀ(w) A for the CSR transpose (t_indptr, t_rows, perm) of a
    matrix M with entry weights w (in M's CSR entry order) and row-major A
    (n_out, d_pad); w and A both float32 or both bfloat16; C is float32
    (n_in, d_pad), zero for a column of M with no entries.
    Replaces ``mg_gcn_tpu/ops/spmm_edges.py:_edge_t_kernel``."""
    if a.device.type == "cpu":
        return edge_t_plain(t_indptr, t_rows, perm, w, a)
    check_csr_operands("edge_t", t_indptr, t_rows, w, a, tuple(_W_CODE), tuple(_W_CODE))
    if w.dtype != a.dtype:
        raise ValueError(f"edge_t: weights ({w.dtype}) and A ({a.dtype}) must share the compute dtype")
    if perm.dtype != torch.int32 or perm.shape != t_rows.shape or perm.device != a.device or not perm.is_contiguous():
        raise ValueError("edge_t: perm must be contiguous int32 of t_rows' shape, on A's device")
    out = torch.empty((t_indptr.numel() - 1, a.shape[1]), dtype=torch.float32, device=a.device)
    if not t_rows.numel():
        return out.zero_()
    if out.shape[0]:
        ptrs = [t_indptr.data_ptr(), t_rows.data_ptr(), perm.data_ptr(), w.data_ptr(), a.data_ptr()]
        run_csr_kernel(_lib(), "mggcn_edge_t", ptrs, out, _W_CODE[a.dtype])
        edge_t.launches[(str(a.dtype).removeprefix("torch."), a.shape[1])] += 1
    return out


edge.launches = collections.Counter()
edge_i8.launches = collections.Counter()
edge_t.launches = collections.Counter()


# ---------------------------------------------------------------------------
# the product around the kernels


def pad_features(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """B cast to ``dtype``, contiguous, 16-byte aligned and zero-padded to
    d_pad = a multiple of 8 (at least 8) feature columns; no copy when B
    already is all that."""
    n, d = b.shape
    d_pad = round_up(max(d, 8), 8)
    if d_pad == d:
        b = b.to(dtype).contiguous()
        if b.data_ptr() % 16 == 0:
            return b
    out = torch.zeros((n, d_pad), dtype=dtype, device=b.device)
    out[:, :d] = b
    return out


def spmm_edge_tiles(mat: EdgeTileMat, b: torch.Tensor) -> torch.Tensor:
    """``C = M @ B`` for row-major B (n_in, d); returns (n_out, d) float32.

    int8 mode quantizes B per feature (qscale = max(max|column|, 1e-30) / 127,
    bq = round(b / qscale) half to even, clipped to ±127) and dequantizes the
    int32 sums as ``acc · (row_scale / 127) · qscale`` in that order
    (``spmm_edges.py:731-741``). Both divisors are tensors on B's device: CUDA
    turns division by a Python scalar into a multiply by its reciprocal,
    which can move a quantization boundary by an ulp."""
    n, d = b.shape
    if n != mat.n_in:
        raise ValueError(f"B has {n} rows, edge matrix expects {mat.n_in}")
    if mat.dtype_name == "int8":
        b32 = b.to(torch.float32)
        amax = torch.clamp(torch.amax(torch.abs(b32), dim=0), min=1e-30)
        qscale = amax / torch.full_like(amax, 127.0)
        bq = pad_features(torch.clamp(torch.round(b32 / qscale[None, :]), -127, 127).to(torch.int8), torch.int8)
        acc = edge_i8(mat.indptr, mat.indices, mat.wq, bq)[:, :d].to(torch.float32)
        rs = mat.row_scale / torch.full_like(mat.row_scale, 127.0)
        return acc * rs[:, None] * qscale[None, :]
    bm = pad_features(b, DTYPES[mat.dtype_name])
    return edge(mat.indptr, mat.indices, mat.w, bm)[:, :d]


# ---------------------------------------------------------------------------
# the transposed product


@dataclass(frozen=True)
class TSched:
    """The CSR transpose of an :class:`EdgeTileMat`'s structure: transposed
    entry j (in column-major order, rows ascending within a column, the
    stable order) is the matrix's CSR entry ``perm[j]``, at row
    ``t_rows[j]``. It replaces the JAX package's column-window step
    schedule of the same name (``spmm_edges.py:748-781``)."""

    t_indptr: torch.Tensor  # int64 [n_in + 1]
    t_rows: torch.Tensor  # int32 [nnz]
    perm: torch.Tensor  # int32 [nnz]


def transposed_schedule(mat: EdgeTileMat) -> TSched:
    """Build ``mat``'s :class:`TSched` on its device: one stable sort of
    the column indices (the counterpart of ``spmm_edges.py:842-977``).
    Build it once per matrix and pass it with the matrix, as
    ``ops/edge_attention.build_attention_graph`` does."""
    dev = mat.indices.device
    cols, order = torch.sort(mat.indices, stable=True)
    t_indptr = torch.zeros(mat.n_in + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(cols.long(), minlength=mat.n_in), 0, out=t_indptr[1:])
    del cols
    rows = torch.repeat_interleave(torch.arange(mat.n_out, dtype=torch.int32, device=dev), mat.indptr.diff(),
                                   output_size=mat.nnz)
    t_rows = rows[order]
    del rows
    return TSched(t_indptr=t_indptr, t_rows=t_rows, perm=order.to(torch.int32))


def spmm_edge_tiles_t(mat: EdgeTileMat, sched: TSched, a: torch.Tensor,
                      w_slots: torch.Tensor | None = None) -> torch.Tensor:
    """``C = Mᵀ @ A`` for row-major A (n_out, d); returns (n_in, d) float32.

    ``w_slots`` (one value per entry, CSR entry order) overrides the
    matrix's weights: the backward-B path of the SDDMM and of the weighted
    aggregation. A and the weights are cast to the compute dtype (bfloat16
    or float32); the kernel sums in float32. A column with no entries gives
    zeros. The int8 mode has no transposed product
    (``spmm_edges.py:1113-1117``)."""
    n, d = a.shape
    if n != mat.n_out:
        raise ValueError(f"A has {n} rows, transposed edge matrix expects {mat.n_out}")
    if mat.dtype_name == "int8":
        raise ValueError(
            "the transposed edge kernel has no int8 mode — build the matrix in bfloat16 for attention/gradient paths"
        )
    cdtype = DTYPES[mat.dtype_name]
    w = mat.w if w_slots is None else w_slots.to(cdtype).contiguous()
    am = pad_features(a, cdtype)
    return edge_t(sched.t_indptr, sched.t_rows, sched.perm, w, am)[:, :d]
