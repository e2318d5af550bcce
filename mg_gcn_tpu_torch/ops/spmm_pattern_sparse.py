"""Block-sparse bit-packed pattern SpMM — the aggregation of clustered graphs.

Port of ``mg_gcn_tpu/ops/spmm_pattern_sparse.py``. The pattern P of a binary
adjacency is cut into (tile_r × 4096) regions and only the occupied ones are
stored, as a compact int32 tile store ``tiles[T, tile_r, 128]``: bit b of
word ``tiles[t, r, w]`` holds ``P[rb*tile_r + r, g*4096 + b*128 + w]`` for
tile t = (row block rb, group g), the strided layout of
:mod:`.spmm_pattern` restricted to one group. Tiles run in (rb, g) order,
the JAX package's ``tiles[:T]`` tile for tile. Memory and work then follow
the occupied tiles instead of n², which is what an RCM- or BFS-ordered graph
(``data.prep cluster``) buys.

One store serves both directions, ``Âᵀ B = diag(s) (Pᵀ B)`` and
``Â G = P (diag(s) G)``, through :func:`.spmm_pattern.apply_pattern_calls`
(the same scale and int8 rounding points as the dense pattern pair). The two
products run as hand-written CUDA kernels (``csrc/spmm_pattern_sparse.cu``):
:func:`block_fwd` (Pᵀ B) on the tensor cores, each live (tile, plane)
decoded to a 0/1 matrix and multiplied by the tile's B rows (float32
operands as three exact bfloat16 parts, :func:`split_bf16x3_plain`), and
:func:`block_bwd` (P B) by the backward pattern walk of
``csrc/pattern_bwd.cuh`` with the store as its word source (row r of a row
block's tiles streamed in turn; :func:`block_bwd_groups_plain` sums in its
order, for the tests). Beside the store they read each tile's (rb, g), a
by-group tile list (forward), the by-row-block tile ranges (backward) and
each tile's live-plane mask. The TPU schedules
(K_PLANES plane-compacted steps, padding slots, the dummy zero tile,
first-visit flags) are not built. Each wrapper launches its kernel for a
CUDA tensor and uses its plain PyTorch version for a CPU tensor — only
because the tensor lies on the CPU; nothing falls back from one to the
other. Each wrapper counts its launches in ``.launches`` by (dtype, d_pad).
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
from .spmm_pattern import (
    _DTYPE_CODE,
    _PACK_ROW_CHUNKS,
    _PLAIN_WORDS_CAP,
    BWD_GEOMETRY_KEYS,
    DTYPES,
    GROUP,
    apply_pattern_calls,
    groups_plain,
    is_binary,
    pattern_bwd_split,
    query_geometry,
    round_up,
    sum_decoded,
)

TILE_R = 512  # tile rows
MAX_STORE_WORDS = 2**31  # the store's int32 words are addressed by int32 (the JAX package's limit)


@dataclass(frozen=True)
class BlockPatternMat:
    """One aggregation direction over a shared compact tile store.

    orientation "PT": C = scale ⊙ (Pᵀ B)   (GCN forward, scale_side="post")
    orientation "P":  C = P (scale ⊙ B)     (GCN backward, scale_side="pre")
    """

    tiles: torch.Tensor  # int32 [T, tile_r, 128]
    tile_rb: torch.Tensor  # int32 [T] row block of each tile (ascending)
    tile_g: torch.Tensor  # int32 [T] group of each tile
    rb_ptr: torch.Tensor  # int32 [n_rb + 1]: tiles of row block rb are rb_ptr[rb] .. rb_ptr[rb+1]
    g_ptr: torch.Tensor  # int32 [n_g + 1]: group g's tiles are g_tiles[g_ptr[g] .. g_ptr[g+1]]
    g_tiles: torch.Tensor  # int32 [T] tile ids by (group, row block)
    pmask: torch.Tensor  # int32 [T] live-plane mask: bit b set iff plane b holds an edge
    scale: torch.Tensor  # float32 [n_pad]
    n: int
    n_pad: int
    nnz: int
    orientation: str  # "PT" | "P"
    scale_side: str  # "pre" | "post"
    dtype_name: str = "bfloat16"  # operand dtype: bfloat16 | float32 | int8
    tile_r: int = TILE_R
    plane_occ: float = 1.0  # share of the (tile_r × 128) planes of the stored tiles that hold an edge

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def occupancy(self) -> float:
        total = (self.n_pad // self.tile_r) * (self.n_pad // GROUP)
        return self.num_tiles / total

    @property
    def store_bytes(self) -> int:
        return self.tiles.numel() * 4


def _row_blocks(csr: CSRData, tile_r: int):
    """(row block, its column indices) for each row block of ``tile_r`` rows."""
    n = csr.nrows
    for rb in range(-(-n // tile_r)):
        e0, e1 = int(csr.indptr[rb * tile_r]), int(csr.indptr[min((rb + 1) * tile_r, n)])
        yield rb, csr.indices[e0:e1]


def _occupied(csr: CSRData, n_pad: int, tile_r: int) -> np.ndarray:
    """bool (n_pad // tile_r, n_pad // GROUP): the (row block, group)
    regions that hold an edge."""
    occ = np.zeros((n_pad // tile_r, n_pad // GROUP), bool)
    for rb, cols in _row_blocks(csr, tile_r):
        occ[rb, cols >> 12] = True  # GROUP = 1 << 12
    return occ


def estimate_occupancy(csr: CSRData) -> tuple[float, float]:
    """(tile_occ, plane_occ): the shares of the (TILE_R × 4096) tile regions
    and of the (TILE_R × 128) plane regions that hold an edge, one pass over
    the edges. tile_occ sets the store's memory, plane_occ the share of
    planes the kernels walk. Counted a row block at a time, so a graph too
    large for any pattern store costs no (row block × plane) array."""
    n_pad = round_up(csr.nrows, GROUP)
    n_rb = n_pad // TILE_R
    tiles = planes = 0
    mark = np.zeros(n_pad // 128, bool)
    for _, cols in _row_blocks(csr, TILE_R):
        p = cols >> 7
        mark[p] = True
        planes += int(np.count_nonzero(mark))
        tiles += int(np.count_nonzero(mark.reshape(-1, GROUP // 128).any(axis=1)))
        mark[p] = False
    return tiles / (n_rb * (n_pad // GROUP)), planes / (n_rb * (n_pad // 128))


def _tiles_on_host(
    csr: CSRData, tile_index: np.ndarray, n_g: int, T: int, tile_r: int
) -> tuple[np.ndarray, np.ndarray]:
    """(tiles int32 [T, tile_r, 128], live planes bool [T, 32]) built on
    the host: the JAX package's two chunked passes (per row block)."""
    n, indptr = csr.nrows, csr.indptr
    pos = np.empty(csr.nnz, np.int64)
    bitpos = np.empty(csr.nnz, np.int8)
    live = np.zeros(T * 32, bool)
    for rb in range(-(-n // tile_r)):
        r0, r1 = rb * tile_r, min((rb + 1) * tile_r, n)
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e1 == e0:
            continue
        c = csr.indices[e0:e1].astype(np.int64)
        lrow = np.repeat(np.arange(r1 - r0, dtype=np.int64), np.diff(indptr[r0 : r1 + 1]))
        t = tile_index[rb * n_g + (c >> 12)].astype(np.int64)
        lcol = c & (GROUP - 1)
        pos[e0:e1] = (t * tile_r + lrow) * 128 + (lcol & 127)
        bitpos[e0:e1] = lcol >> 7
        live[t * 32 + (lcol >> 7)] = True
    flat = np.zeros(T * tile_r * 128, dtype=np.uint32)
    order = np.argsort(bitpos, kind="stable")
    pos_s = pos[order]
    bounds = np.searchsorted(bitpos[order], np.arange(33))
    for b in range(32):  # every (word, bit) is one edge: a plane is one OR
        seg = pos_s[bounds[b] : bounds[b + 1]]
        if seg.size:
            flat[seg] |= np.uint32(1 << b)
    return flat.view(np.int32).reshape(T, tile_r, 128), live.reshape(T, 32)


def _tiles_on_device(
    csr: CSRData, tile_index: np.ndarray, n_g: int, T: int, tile_r: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same store built on ``device`` from 4 bytes a column index: per
    chunk of rows one int32 ``index_add_`` of powers of two (equal to the OR,
    since every (word, bit) pair is unique, and never wrapping: bit 31 adds
    -2^31; see :func:`.spmm_pattern.pack_bits_on_device`)."""
    tiles = torch.zeros(T * tile_r * 128, dtype=torch.int32, device=device)
    live = torch.zeros(T * 32, dtype=torch.bool, device=device)
    index = torch.from_numpy(tile_index).to(device)
    indptr = csr.indptr.astype(np.int64, copy=False)
    rows_per = -(-csr.nrows // _PACK_ROW_CHUNKS)
    for r0 in range(0, csr.nrows, rows_per):
        r1 = min(r0 + rows_per, csr.nrows)
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e1 == e0:
            continue
        cols = torch.from_numpy(csr.indices[e0:e1].astype(np.int64)).to(device)
        counts = torch.from_numpy(np.diff(indptr[r0 : r1 + 1])).to(device)
        rows = torch.repeat_interleave(torch.arange(r0, r1, device=device), counts)
        t = index[(rows // tile_r) * n_g + (cols >> 12)].long()
        bit = (cols >> 7) & 31
        pos = (t * tile_r + rows % tile_r) * 128 + (cols & 127)
        tiles.index_add_(0, pos, torch.where(bit == 31, -(1 << 31), 1 << bit).to(torch.int32))
        live[t * 32 + bit] = True
    return tiles.view(T, tile_r, 128), live.view(T, 32)


def block_pattern_pair_from_binary_csr(
    csr: CSRData,
    dtype: str = "bfloat16",
    build_on_device: bool = True,
    tile_r: int = TILE_R,
    device: str | torch.device = "cuda",
) -> tuple[BlockPatternMat, BlockPatternMat]:
    """Build the (forward Âᵀ·, backward Â·) pair from a *binary* adjacency,
    one shared tile store on ``device`` (gcn ctor semantics,
    gcn.hpp:946-954). ``build_on_device=False`` packs the bits on the host
    (the JAX package's build), for tests."""
    if not is_binary(csr):
        raise ValueError("pattern SpMM needs a binary adjacency (data == 1)")
    if dtype not in DTYPES:
        raise ValueError(f"unknown pattern dtype {dtype!r} (expected {'/'.join(DTYPES)})")
    n = csr.nrows
    n_pad = round_up(n, GROUP)
    if GROUP % tile_r:
        raise ValueError(f"tile_r {tile_r} must divide GROUP={GROUP}")
    device = torch.device(device)
    n_rb, n_g = n_pad // tile_r, n_pad // GROUP
    occ = _occupied(csr, n_pad, tile_r)
    occupied = np.flatnonzero(occ.reshape(-1))  # sorted: (rb, g) order
    T = occupied.shape[0]
    if T * tile_r * 128 >= MAX_STORE_WORDS:
        raise ValueError(f"{T} occupied tiles exceed int32 addressing; use the dense pattern or COO path")
    tile_index = np.full(n_rb * n_g, -1, np.int32)
    tile_index[occupied] = np.arange(T, dtype=np.int32)
    if build_on_device:
        tiles, live = _tiles_on_device(csr, tile_index, n_g, T, tile_r, device)
    else:
        tiles_np, live_np = _tiles_on_host(csr, tile_index, n_g, T, tile_r)
        tiles, live = torch.from_numpy(tiles_np).to(device), torch.from_numpy(live_np).to(device)
    # bit b of a tile's mask: plane b is live (bit 31 wraps to the sign)
    pmask = ((live.long() << torch.arange(32, device=device)).sum(1) << 32 >> 32).to(torch.int32)
    plane_occ = float(live.sum()) / max(T * 32, 1)

    occ_rb, occ_g = occupied // n_g, occupied % n_g
    by_group = np.lexsort((occ_rb, occ_g)).astype(np.int32)
    ptr = lambda ids, m: np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=m))]).astype(np.int32)  # noqa: E731
    indeg = np.bincount(csr.indices, minlength=n_pad).astype(np.float64)
    with np.errstate(divide="ignore"):
        s = np.where(indeg > 0, 1.0 / indeg, 0.0).astype(np.float32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    common = dict(
        tiles=tiles, tile_rb=put(occ_rb.astype(np.int32)), tile_g=put(occ_g.astype(np.int32)),
        rb_ptr=put(ptr(occ_rb, n_rb)), g_ptr=put(ptr(occ_g, n_g)), g_tiles=put(by_group), pmask=pmask,
        scale=put(s), n=n, n_pad=n_pad, nnz=csr.nnz, dtype_name=dtype, tile_r=tile_r, plane_occ=plane_occ,
    )
    fwd = BlockPatternMat(orientation="PT", scale_side="post", **common)
    bwd = BlockPatternMat(orientation="P", scale_side="pre", **common)
    return fwd, bwd


# ---------------------------------------------------------------------------
# plain PyTorch versions of the two kernels (CPU path, and the reference the
# kernels are held against on the card)


def decode_tiles(mat: BlockPatternMat):
    """(rows, cols) int64 of P's set bits, in chunks of tiles."""
    tiles = mat.tiles
    # a sixteenth of the dense decoder's words: a clustered tile's words are
    # mostly nonzero, each takes a 32-wide int64 row below, and a chunk's
    # gathered rows of B stay near a gigabyte at d = 128 in float64
    per = max(1, _PLAIN_WORDS_CAP // 16 // (mat.tile_r * 128))
    shifts = torch.arange(32, device=tiles.device)
    for t0 in range(0, mat.num_tiles, per):
        block = tiles[t0 : t0 + per]
        ti, r, w = torch.nonzero(block, as_tuple=True)
        # int64 keeps bit 31 of a negative int32 word under the arithmetic shift
        e, bit = torch.nonzero((block[ti, r, w].to(torch.int64)[:, None] >> shifts) & 1, as_tuple=True)
        t = ti[e] + t0
        yield (mat.tile_rb[t].long() * mat.tile_r + r[e],
               mat.tile_g[t].long() * GROUP + bit * 128 + w[e])


def block_fwd_plain(mat: BlockPatternMat, b: torch.Tensor, acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of :func:`block_fwd`: decode the set bits and
    ``index_add_`` the rows of B into C = Pᵀ B. Float operands sum in
    float32, or in ``acc_dtype`` (float64 gives a reference whose sum order
    does not matter)."""
    return sum_decoded(decode_tiles(mat), b, True, acc_dtype)


def block_bwd_plain(mat: BlockPatternMat, b: torch.Tensor, acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of :func:`block_bwd`: C = P B."""
    return sum_decoded(decode_tiles(mat), b, False, acc_dtype)


def block_bwd_groups_plain(mat: BlockPatternMat, b: torch.Tensor) -> torch.Tensor:
    """:func:`block_bwd` in its kernel's order (:func:`.spmm_pattern.groups_plain`):
    each output row's set bits listed in (tile in ``rb_ptr`` order, word,
    bit) order, entry e to group e mod G (:data:`block_bwd_split`), each
    group's B rows added in order, then the xor tree. For the tests, which
    hold the kernel to its bits in bfloat16 and int8."""
    t, r, w = torch.nonzero(mat.tiles, as_tuple=True)  # (tile, row, word) order
    wv = mat.tiles[t, r, w].to(torch.int64)  # int64 keeps bit 31 under the shift
    e, bit = torch.nonzero((wv[:, None] >> torch.arange(32, device=b.device)) & 1, as_tuple=True)
    t, r, w = t[e], r[e], w[e]
    rows = mat.tile_rb[t].long() * mat.tile_r + r
    # a row block's tiles are consecutive in rb_ptr order: a stable sort by
    # row keeps (tile, word, bit) within each row
    order = torch.argsort(rows, stable=True)
    cols = mat.tile_g[t].long() * GROUP + bit * 128 + w
    return groups_plain(rows[order], cols[order], b, mat.n_pad)


def split_bf16x3_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the float32 mode's operand split in :func:`block_fwd`
    (``split3`` in ``csrc/spmm_pattern_sparse.cu``): x = hi + mid + lo, each
    a bfloat16 value held in a float32. hi is x truncated to bfloat16, mid is
    x - hi truncated, lo = x - hi - mid; both differences are exact. The sum
    is exact for finite |x| >= 2^-100; below it lo may lose bits under
    2^-126. For the tests; the kernel splits in registers."""
    x = x.to(torch.float32)
    mask = torch.tensor(-65536, dtype=torch.int32, device=x.device)  # 0xFFFF0000: a bfloat16's bits
    hi = (x.view(torch.int32) & mask).view(torch.float32)
    r = x - hi
    mid = (r.view(torch.int32) & mask).view(torch.float32)
    return hi, mid, r - mid


def block_fwd_planes_plain(mat: BlockPatternMat, b: torch.Tensor, acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plane formulation of :func:`block_fwd`, in the kernel's order: for
    each group, its tiles in row-block order, and each live plane p of a tile
    (``pmask`` bit p), the 0/1 plane (128 x tile_r, bit p of the tile's
    words) times the tile's B rows, added into output rows g*4096 + p*128 +
    w. Float operands sum in float32 or ``acc_dtype``, int8 exactly; C is
    float32 (int32 for int8). For the tests: it loops over tiles."""
    exact = b.dtype == torch.int8
    src = b.to(torch.float64 if exact else acc_dtype or torch.float32)
    out = torch.zeros((mat.n_pad, b.shape[1]), dtype=src.dtype, device=b.device)
    shifts = torch.arange(32, device=b.device)
    g_ptr, g_tiles = mat.g_ptr.tolist(), mat.g_tiles.tolist()
    for g in range(len(g_ptr) - 1):
        for t in g_tiles[g_ptr[g] : g_ptr[g + 1]]:
            live = torch.nonzero((mat.pmask[t].long() >> shifts) & 1).flatten()
            r0 = int(mat.tile_rb[t]) * mat.tile_r
            # planes[p, r, w] = bit p of tiles[t, r, w]; int64 keeps bit 31
            planes = ((mat.tiles[t].long()[None] >> live[:, None, None]) & 1).to(src.dtype)
            prod = torch.einsum("prw,rd->pwd", planes, src[r0 : r0 + mat.tile_r])
            for k, p in enumerate(live.tolist()):
                out[g * GROUP + p * 128 : g * GROUP + (p + 1) * 128] += prod[k]
    return out.to(torch.int32) if exact else out


# ---------------------------------------------------------------------------
# the kernel wrappers


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_pattern_sparse")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mggcn_block_fwd.argtypes = [p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, p]
    lib.mggcn_block_bwd.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, i, p]
    lib.mggcn_block_fwd.restype = lib.mggcn_block_bwd.restype = ctypes.c_int
    for fn in (lib.mggcn_block_fwd_geometry, lib.mggcn_block_bwd_geometry):
        fn.argtypes = [ctypes.c_longlong, i, i, i, p]
        fn.restype = ctypes.c_int
    lib.mggcn_error_string.argtypes = [ctypes.c_int]
    lib.mggcn_error_string.restype = ctypes.c_char_p
    return lib


BLOCK_FWD_GEOMETRY_KEYS = ("grid_x", "grid_y", "threads", "smem", "stages", "blocks_per_sm", "resident_blocks")


def block_fwd_geometry(n_pad: int, tile_r: int, d_pad: int, dtype: torch.dtype) -> dict:
    """The launch geometry of :func:`block_fwd` for a store of ``n_pad``
    nodes in tiles of ``tile_r`` rows and an (n_pad, d_pad) operand of
    ``dtype``: grid (feature chunks x 16-word runs, groups), threads,
    dynamic shared memory, stages and resident blocks."""
    return query_geometry(_lib(), "mggcn_block_fwd_geometry", n_pad, tile_r, d_pad, _DTYPE_CODE[dtype],
                          keys=BLOCK_FWD_GEOMETRY_KEYS)


# The backward's split of a warp by width and dtype: the backward pattern
# walk's own rule, which block_bwd shares.
block_bwd_split = pattern_bwd_split


def block_bwd_geometry(n_pad: int, tile_r: int, d_pad: int, dtype: torch.dtype) -> dict:
    """The launch geometry of :func:`block_bwd` for a store of ``n_pad``
    nodes in tiles of ``tile_r`` rows and an (n_pad, d_pad) operand of
    ``dtype``, from the card, as :func:`.spmm_pattern.pattern_bwd_geometry`
    gives it: grid (n_pad / 8 blocks of a warp a row at every split, feature
    chunks), threads, dynamic shared memory, stages, resident blocks, then
    the split (:data:`block_bwd_split`), B rows a lane loads at once, words a
    span and ``windows`` = 1 (no column windows over a store)."""
    return query_geometry(_lib(), "mggcn_block_bwd_geometry", n_pad, tile_r, d_pad, _DTYPE_CODE[dtype],
                          keys=BWD_GEOMETRY_KEYS)


def _launch(name: str, mat: BlockPatternMat, b: torch.Tensor, index: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Check the operands, allocate C and launch kernel ``name`` on the
    current stream with the store, ``index`` and B; raises when the launch
    is refused."""
    tiles = mat.tiles
    if b.device.type != "cuda" or any(t.device != b.device for t in (tiles, *index)):
        raise ValueError(f"{name}: the tile store and B must lie on one CUDA device")
    if tiles.dtype != torch.int32 or tuple(tiles.shape[1:]) != (mat.tile_r, 128) or not tiles.is_contiguous():
        raise ValueError(f"{name}: tiles must be a contiguous int32 (T, {mat.tile_r}, 128) tensor")
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in index):
        raise ValueError(f"{name}: the tile index arrays must be contiguous int32")
    if b.dtype not in _DTYPE_CODE or b.dim() != 2 or not b.is_contiguous():
        raise ValueError(f"{name}: B must be a contiguous 2-D float32/bfloat16/int8 tensor")
    if b.shape[0] != mat.n_pad or b.shape[1] % 8 or b.shape[1] == 0:
        raise ValueError(f"{name}: B shape {tuple(b.shape)} is not (n_pad, d_pad), d_pad % 8 == 0")
    if tiles.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name}: tiles and B must be 16-byte aligned")
    d_pad = b.shape[1]
    out = torch.empty((mat.n_pad, d_pad), dtype=torch.int32 if b.dtype == torch.int8 else torch.float32,
                      device=b.device)
    lib = _lib()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = getattr(lib, name)(
            tiles.data_ptr(), *(t.data_ptr() for t in index), b.data_ptr(), out.data_ptr(),
            mat.n_pad, mat.tile_r, d_pad, _DTYPE_CODE[b.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.mggcn_error_string(err).decode()})")
    return out


def block_fwd(mat: BlockPatternMat, b: torch.Tensor) -> torch.Tensor:
    """C = Pᵀ B over ``mat``'s tile store, for row-major B (n_pad, d_pad) in
    float32/bfloat16/int8; C is float32 (int32 for int8).
    Replaces ``mg_gcn_tpu/ops/spmm_pattern_sparse.py:_fwd_kernel_sparse``."""
    if b.device.type == "cpu":
        return block_fwd_plain(mat, b)
    out = _launch("mggcn_block_fwd", mat, b, (mat.tile_rb, mat.g_ptr, mat.g_tiles, mat.pmask))
    block_fwd.launches[(str(b.dtype).removeprefix("torch."), b.shape[1])] += 1
    return out


def block_bwd(mat: BlockPatternMat, b: torch.Tensor) -> torch.Tensor:
    """C = P B, same operands as :func:`block_fwd`, by the backward pattern
    walk over the store (one launch).
    Replaces ``mg_gcn_tpu/ops/spmm_pattern_sparse.py:_bwd_kernel_sparse``."""
    if b.device.type == "cpu":
        return block_bwd_plain(mat, b)
    out = _launch("mggcn_block_bwd", mat, b, (mat.tile_g, mat.rb_ptr))
    block_bwd.launches[(str(b.dtype).removeprefix("torch."), b.shape[1])] += 1
    return out


block_fwd.launches = collections.Counter()
block_bwd.launches = collections.Counter()


def spmm_block_pattern(mat: BlockPatternMat, b: torch.Tensor) -> torch.Tensor:
    """``C = M @ B`` for row-major B (n, d); returns (n, d) float32. Scale,
    padding and int8 handling are the dense pattern pair's
    (:func:`.spmm_pattern.apply_pattern_calls`)."""
    return apply_pattern_calls(mat, b, block_fwd, block_bwd)
