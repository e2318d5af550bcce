"""Bit-packed dense-pattern SpMM — the aggregation of the main path.

Port of ``mg_gcn_tpu/ops/spmm_pattern.py``. For a binary adjacency the
column-normalized GCN operator factors as ``Â = P · diag(s)`` with
``s_j = 1 / in_degree(j)``, so both aggregations need only the pattern P,
bit-packed into n²/8 bytes, plus a scale vector:

    forward   Âᵀ B = diag(s) (Pᵀ B)      (orientation "PT", scale "post")
    backward  Â G  = P (diag(s) G)        (orientation "P",  scale "pre")

**Strided bit layout** (the JAX package's, bit for bit): word
``pack[i, g*128 + w]`` bit ``b`` holds ``P[i, g*4096 + b*128 + w]``; n_pad is
a multiple of 4096 and the pack is int32 (n_pad, n_pad/32).

The two products run as hand-written CUDA kernels
(``csrc/spmm_pattern.cu``): :func:`pattern_fwd` (Pᵀ B) and
:func:`pattern_bwd` (P B). Each wrapper launches its kernel for a CUDA
tensor and uses its plain PyTorch version for a CPU tensor — only because
the tensor lies on the CPU; there is no fallback from one to the other.
Each wrapper counts its launches in ``.launches`` by (dtype, d_pad).
:func:`pattern_bwd_groups_plain` sums in the backward kernel's own order
(:func:`groups_plain`, shared with the ring's and the block store's twins),
for the tests.
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

GROUP = 4096  # pattern columns per 128-word group (32 bit-planes x 128)
N_ALIGN = GROUP
# share of the card's memory the n²/8 pack may take when impl="auto" picks
# the pattern pair (the rest holds activations and the dense operands)
PATTERN_MEM_FRACTION = 0.5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# pack words the plain versions decode at once (bounds their temporaries)
_PLAIN_WORDS_CAP = 1 << 24
# row chunks of the device-side pack build (bounds its int64 temporaries)
_PACK_ROW_CHUNKS = 8


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def is_binary(csr: CSRData) -> bool:
    return bool(np.all(csr.data == 1.0))


def pack_budget_gb(n: int, card_bytes: int) -> tuple[float, float]:
    """(GB of the n_pad²/8 pack of an n-node graph, GB of the
    PATTERN_MEM_FRACTION share of a card of ``card_bytes``)."""
    n_pad = round_up(n, N_ALIGN)
    return n_pad * n_pad / 8 / 1e9, PATTERN_MEM_FRACTION * card_bytes / 1e9


def pattern_feasible(csr: CSRData, card_bytes: int | None) -> bool:
    """True when impl="auto" may take the pattern pair: a card of
    ``card_bytes`` (None on the CPU), a binary adjacency, and its n_pad²/8
    pack within PATTERN_MEM_FRACTION of the card. The one predicate the GCN
    rule (``train.auto_engine``), SAGE and PageRank share; the JAX package's
    fixed 9 GB budget is a TPU v5e's and is not kept."""
    if card_bytes is None or not is_binary(csr):
        return False
    pack_gb, budget_gb = pack_budget_gb(csr.nrows, card_bytes)
    return pack_gb <= budget_gb


def row_scale(csr: CSRData, n_pad: int) -> np.ndarray:
    """Padded 1/out-degree vector, 0 for an empty row: the row-normalized M
    factors as diag(r)·P (mean aggregation; matrix.hpp:341-349
    normalize(false) semantics). ``mg_gcn_tpu/ops/spmm_pattern.py:139-146``."""
    outdeg = np.diff(csr.indptr).astype(np.float64)
    r = np.zeros(n_pad, np.float32)
    with np.errstate(divide="ignore"):
        r[: csr.nrows] = np.where(outdeg > 0, 1.0 / outdeg, 0.0)
    return r


def pack_csr_bits(csr: CSRData, n_pad: int) -> np.ndarray:
    """Pack the CSR pattern into the strided uint32 layout on the host:
    P[i, j] -> bit (j%4096)//128 of word pack[i, (j//4096)*128 + j%128]."""
    words = n_pad // 32
    counts = np.diff(csr.indptr).astype(np.int64)
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), counts)
    cols = csr.indices.astype(np.int64)
    pos = rows * words + (cols // GROUP) * 128 + (cols % 128)
    bitpos = (cols % GROUP) // 128
    flat = np.zeros(n_pad * words, dtype=np.uint32)
    # for a fixed bit every edge has its own word (a shared word and bit
    # would be a duplicate edge), so each bit-plane is one fancy-index OR
    order = np.argsort(bitpos, kind="stable")
    pos_s = pos[order]
    bounds = np.searchsorted(bitpos[order], np.arange(33))
    for b in range(32):
        seg = pos_s[bounds[b] : bounds[b + 1]]
        if seg.size:
            flat[seg] |= np.uint32(1 << b)
    return flat.reshape(n_pad, words)


def pack_bits_on_device(csr: CSRData, n_pad: int, device: torch.device) -> torch.Tensor:
    """Build the int32 pack on ``device`` from 4 bytes a column index.

    Rows, words and bits are derived on the device and each chunk of rows is
    filled by one int32 ``index_add_`` of powers of two. That equals the OR
    because every (word, bit) pair is unique, and it never wraps: the bits
    below 31 sum to at most 2^31 - 1 and bit 31 adds -2^31. Chunking keeps
    the int64 positions at a fraction of the 13.6 GB a full temporary of a
    Reddit-scale graph would take.
    """
    if csr.ncols > 1 << 24:
        raise ValueError("pattern packing supports column indices < 2^24")
    words = n_pad // 32
    pack = torch.zeros((n_pad, words), dtype=torch.int32, device=device)
    indptr = csr.indptr.astype(np.int64, copy=False)
    rows_per = -(-csr.nrows // _PACK_ROW_CHUNKS)
    for r0 in range(0, csr.nrows, rows_per):
        r1 = min(r0 + rows_per, csr.nrows)
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e1 == e0:
            continue
        cols = torch.from_numpy(csr.indices[e0:e1].astype(np.int64)).to(device)
        counts = torch.from_numpy(np.diff(indptr[r0 : r1 + 1])).to(device)
        rows = torch.repeat_interleave(torch.arange(r1 - r0, device=device), counts)
        add_bits(pack[r0:r1].view(-1), rows * words, cols)
    return pack


def add_bits(flat: torch.Tensor, row_word: torch.Tensor, cols: torch.Tensor) -> None:
    """Set the bits of columns ``cols`` (int64) in a flat int32 pack whose
    rows start at word ``row_word`` (int64, one an entry), by one
    ``index_add_`` of powers of two (see :func:`pack_bits_on_device`)."""
    bit = (cols >> 7) & 31
    val = torch.where(bit == 31, -(1 << 31), 1 << bit).to(torch.int32)
    flat.index_add_(0, row_word + (cols >> 12) * 128 + (cols & 127), val)


@dataclass(frozen=True)
class PatternMat:
    """One aggregation direction over a shared bit-packed pattern.

    orientation "PT": C = scale ⊙ (Pᵀ B)   (GCN forward, scale_side="post")
    orientation "P":  C = P (scale ⊙ B)     (GCN backward, scale_side="pre")
    """

    pack: torch.Tensor  # int32 [n_pad, n_pad // 32], strided layout
    scale: torch.Tensor  # float32 [n_pad]
    n: int
    n_pad: int
    nnz: int
    orientation: str  # "PT" | "P"
    scale_side: str  # "pre" | "post" | "none"
    dtype_name: str = "bfloat16"  # operand dtype: bfloat16 | float32 | int8


def pattern_pair_from_binary_csr(
    csr: CSRData, dtype: str = "bfloat16", device: str | torch.device = "cuda"
) -> tuple[PatternMat, PatternMat]:
    """Build the (forward Âᵀ·, backward Â·) pair from a *binary* adjacency,
    one shared pack built on ``device`` (gcn ctor semantics,
    gcn.hpp:946-954)."""
    if not is_binary(csr):
        raise ValueError("pattern SpMM needs a binary adjacency (data == 1)")
    if dtype not in DTYPES:
        raise ValueError(f"unknown pattern dtype {dtype!r} (expected {'/'.join(DTYPES)})")
    device = torch.device(device)
    n = csr.nrows
    n_pad = round_up(n, N_ALIGN)
    pack = pack_bits_on_device(csr, n_pad, device)
    indeg = np.bincount(csr.indices, minlength=n_pad).astype(np.float64)
    with np.errstate(divide="ignore"):
        s = np.where(indeg > 0, 1.0 / indeg, 0.0).astype(np.float32)
    scale = torch.from_numpy(s).to(device)
    fwd = PatternMat(pack, scale, n, n_pad, csr.nnz, "PT", "post", dtype)
    bwd = PatternMat(pack, scale, n, n_pad, csr.nnz, "P", "pre", dtype)
    return fwd, bwd


# ---------------------------------------------------------------------------
# plain PyTorch versions of the two kernels (CPU path, and the reference the
# kernels are held against on the card)


def decode_pattern(pack: torch.Tensor, r0: int, r1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) of the set bits in pack rows [r0, r1), int64."""
    block = pack[r0:r1]
    ri, wi = torch.nonzero(block, as_tuple=True)
    # int64 keeps bit 31 of a negative int32 word under the arithmetic shift
    wv = block[ri, wi].to(torch.int64)
    e, bit = torch.nonzero((wv[:, None] >> torch.arange(32, device=pack.device)) & 1, as_tuple=True)
    wi = wi[e]
    return ri[e] + r0, (wi // 128) * GROUP + bit * 128 + wi % 128


def sum_decoded(pairs, b: torch.Tensor, transpose: bool, acc_dtype: torch.dtype | None) -> torch.Tensor:
    """C = Pᵀ B (``transpose``) or P B for the (rows, cols) chunks of P's set
    bits in ``pairs``: ``index_add_`` of B's rows, float operands summed in
    float32 or ``acc_dtype``; C is float32 (int32 for int8)."""
    n_pad, d_pad = b.shape
    exact = b.dtype == torch.int8
    # int8 sums go through float64, where they stay exact; the result is int32
    src = b.to(torch.float64 if exact else acc_dtype or torch.float32)
    out = torch.zeros((n_pad, d_pad), dtype=src.dtype, device=b.device)
    for rows, cols in pairs:
        if transpose:
            out.index_add_(0, cols, src.index_select(0, rows))
        else:
            out.index_add_(0, rows, src.index_select(0, cols))
    return out.to(torch.int32) if exact else out


def _plain(pack: torch.Tensor, b: torch.Tensor, transpose: bool, acc_dtype: torch.dtype | None) -> torch.Tensor:
    n_pad = pack.shape[0]
    rows_per = max(1, _PLAIN_WORDS_CAP // pack.shape[1])
    pairs = (decode_pattern(pack, r0, min(r0 + rows_per, n_pad)) for r0 in range(0, n_pad, rows_per))
    return sum_decoded(pairs, b, transpose, acc_dtype)


def pattern_fwd_plain(pack: torch.Tensor, b: torch.Tensor, acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of :func:`pattern_fwd`: decode the set bits and
    ``index_add_`` the rows of B into C = Pᵀ B. Float operands sum in
    float32, or in ``acc_dtype`` (float64 gives a reference whose sum order
    does not matter)."""
    return _plain(pack, b, True, acc_dtype)


def pattern_bwd_plain(pack: torch.Tensor, b: torch.Tensor, acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of :func:`pattern_bwd`: C = P B."""
    return _plain(pack, b, False, acc_dtype)


def pattern_bwd_split(d_pad: int, dtype: torch.dtype) -> dict:
    """The backward walk's split of a warp at width ``d_pad`` in ``dtype``
    (``csrc/pattern_bwd.cuh`` ``features_for``, ``lanes_for``): ``features``
    F a lane loads at once (16 bytes, or 8 for an int8 row of d_pad % 16 ==
    8), ``lanes`` L, the smallest power of two >= d_pad / F capped at 32,
    ``groups`` G = 32 / L, the groups that take a row's entries in strides,
    and ``chunks`` of 32 F features a row is walked in (grid y). bfloat16
    d_pad 8 gives L = 1, G = 32; 48 and 64 give L = 8, G = 4; 128 gives L =
    16, G = 2."""
    if d_pad <= 0 or d_pad % 8:
        raise ValueError(f"d_pad must be a positive multiple of 8, got {d_pad}")
    size = torch.empty((), dtype=dtype).element_size()
    features = (16 if d_pad * size % 16 == 0 else 8) // size
    lanes = 1
    while lanes < 32 and lanes * features < d_pad:
        lanes *= 2
    return {"features": features, "lanes": lanes, "groups": 32 // lanes, "chunks": -(-d_pad // (32 * features))}


def groups_plain(rows: torch.Tensor, cols: torch.Tensor, b: torch.Tensor, n_rows: int) -> torch.Tensor:
    """C = P B in the backward walk's order (``csrc/pattern_bwd.cuh``) for
    the set bits of P listed as int64 (row, B row) entries ``rows`` /
    ``cols``, sorted by row and, within a row, in the order the walk streams
    them: entry e of a row goes to group e mod G (:func:`pattern_bwd_split`),
    each group adds its entries' B rows in order into float32 sums (int64
    for int8, stored as int32), and the G partial sums meet by the kernel's
    xor tree (groups 2i and 2i + 1 first, then pairs of pairs). C has
    ``n_rows`` rows, zeros where no entry lies."""
    d_pad, dev = b.shape[1], b.device
    groups = pattern_bwd_split(d_pad, b.dtype)["groups"]
    exact = b.dtype == torch.int8
    acc_dtype = torch.int64 if exact else torch.float32
    counts = torch.bincount(rows, minlength=n_rows)
    k = torch.arange(rows.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[rows]  # entry e of its row
    slot, step = rows * groups + k % groups, k // groups
    terms = b.to(acc_dtype).index_select(0, cols)
    part = torch.zeros((n_rows * groups, d_pad), dtype=acc_dtype, device=dev)
    order = torch.argsort(step, stable=True)
    n_steps = int(step.max()) + 1 if step.numel() else 0
    bounds = torch.searchsorted(step[order], torch.arange(n_steps + 1, device=dev)).tolist()
    for t in range(n_steps):  # each group's t-th entry: one add a (row, group), in entry order
        sel = order[bounds[t] : bounds[t + 1]]
        part.index_add_(0, slot[sel], terms[sel])
    part = part.view(n_rows, groups, d_pad)
    off = 1
    while off < groups:  # the lane adds the sums ``off`` groups away: p_k + p_(k xor off)
        part = part + part[:, torch.arange(groups, device=dev) ^ off]
        off *= 2
    out = part[:, 0].contiguous()
    return out.to(torch.int32) if exact else out


def bwd_groups_plain(pack: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = sum_s P_s B_s in the backward kernel's order (:func:`groups_plain`),
    for a stack of rounds ``pack`` (rounds, m, m/32) and ``b`` (rounds·m,
    d_pad), round s's rows from row s·m: each output row's set bits listed
    in (round, word, bit) order. For the tests, which hold the kernel to its
    bits in bfloat16 and int8."""
    m = pack.shape[1]
    rows, rnd, wi = torch.nonzero(pack.permute(1, 0, 2), as_tuple=True)  # (row, round, word) order
    wv = pack[rnd, rows, wi].to(torch.int64)
    e, bit = torch.nonzero((wv[:, None] >> torch.arange(32, device=b.device)) & 1, as_tuple=True)
    rows, rnd, wi = rows[e], rnd[e], wi[e]
    return groups_plain(rows, rnd * m + (wi // 128) * GROUP + bit * 128 + wi % 128, b, m)


def pattern_bwd_groups_plain(pack: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`pattern_bwd` in its kernel's order (:func:`bwd_groups_plain`
    over one round). For the tests."""
    return bwd_groups_plain(pack[None], b)


# ---------------------------------------------------------------------------
# the kernel wrappers


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_pattern")
    for fn in (lib.mggcn_pattern_fwd, lib.mggcn_pattern_bwd):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    for fn in (lib.mggcn_pattern_fwd_geometry, lib.mggcn_pattern_bwd_geometry):
        fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mggcn_error_string.argtypes = [ctypes.c_int]
    lib.mggcn_error_string.restype = ctypes.c_char_p
    return lib


GEOMETRY_KEYS = ("grid_x", "grid_y", "threads", "smem", "slices", "blocks_per_sm", "resident_blocks")
BWD_GEOMETRY_KEYS = ("grid_x", "grid_y", "threads", "smem", "stages", "blocks_per_sm", "resident_blocks", "lanes",
                     "groups", "features", "loads", "span_words", "windows")


def query_geometry(lib: ctypes.CDLL, name: str, *args, keys: tuple[str, ...] = GEOMETRY_KEYS) -> dict:
    """The launch geometry the launcher ``name`` would use for ``args`` on
    the current card, one int a key of ``keys`` (blocks_per_sm from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); raises on an error."""
    out = (ctypes.c_int * len(keys))()
    err = getattr(lib, name)(*args, out)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.mggcn_error_string(err).decode()})")
    return dict(zip(keys, out))


def pattern_fwd_geometry(n_pad: int, d_pad: int, dtype: torch.dtype) -> dict:
    """The launch geometry of :func:`pattern_fwd` for an (n_pad, d_pad)
    operand of ``dtype``: grid, threads, dynamic shared memory, row slices
    and resident blocks."""
    return query_geometry(_lib(), "mggcn_pattern_fwd_geometry", n_pad, d_pad, _DTYPE_CODE[dtype])


def pattern_bwd_geometry(n_pad: int, d_pad: int, dtype: torch.dtype) -> dict:
    """The launch geometry of :func:`pattern_bwd` for an (n_pad, d_pad)
    operand of ``dtype``, from the card: grid, threads, dynamic shared
    memory, stages of a warp's pack ring, resident blocks, then the split
    (:func:`pattern_bwd_split`'s lanes, groups and features), B rows a lane
    loads at once, pack words a staged span and the column windows its one
    launch walks in turn, a grid-wide barrier between two (with one group, where B outgrows half the L2; the
    sum order is the same). Of these, the card's occupancy query gives
    ``blocks_per_sm`` and ``resident_blocks`` (and the one-group grid); the
    rest follow the rule and the kernel's constants."""
    return query_geometry(_lib(), "mggcn_pattern_bwd_geometry", n_pad, d_pad, _DTYPE_CODE[dtype],
                          keys=BWD_GEOMETRY_KEYS)


def _launch(name: str, pack: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Check the operands, allocate C and launch kernel ``name`` on the
    current stream; raises when the launch is refused."""
    if b.device.type != "cuda" or pack.device != b.device:
        raise ValueError(f"{name}: pack and B must lie on one CUDA device")
    if pack.dtype != torch.int32 or pack.dim() != 2 or not pack.is_contiguous():
        raise ValueError(f"{name}: pack must be a contiguous 2-D int32 tensor")
    n_pad, words = pack.shape
    if n_pad % GROUP or words * 32 != n_pad:
        raise ValueError(f"{name}: pack shape {tuple(pack.shape)} is not (n_pad, n_pad/32), n_pad % {GROUP} == 0")
    if b.dtype not in _DTYPE_CODE or b.dim() != 2 or not b.is_contiguous():
        raise ValueError(f"{name}: B must be a contiguous 2-D float32/bfloat16/int8 tensor")
    if b.shape[0] != n_pad or b.shape[1] % 8 or b.shape[1] == 0:
        raise ValueError(f"{name}: B shape {tuple(b.shape)} is not (n_pad, d_pad), d_pad % 8 == 0")
    if pack.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name}: pack and B must be 16-byte aligned")
    d_pad = b.shape[1]
    out = torch.empty((n_pad, d_pad), dtype=torch.int32 if b.dtype == torch.int8 else torch.float32, device=b.device)
    lib = _lib()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = getattr(lib, name)(
            pack.data_ptr(), b.data_ptr(), out.data_ptr(), n_pad, d_pad, _DTYPE_CODE[b.dtype], stream
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.mggcn_error_string(err).decode()})")
    return out


def pattern_fwd(pack: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = Pᵀ B for the int32 pack and row-major B (n_pad, d_pad) in
    float32/bfloat16/int8; C is float32 (int32 for int8).
    Replaces ``mg_gcn_tpu/ops/spmm_pattern.py:_fwd_kernel``."""
    if b.device.type == "cpu":
        return pattern_fwd_plain(pack, b)
    out = _launch("mggcn_pattern_fwd", pack, b)
    pattern_fwd.launches[(str(b.dtype).removeprefix("torch."), b.shape[1])] += 1
    return out


def pattern_bwd(pack: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = P B, same operands as :func:`pattern_fwd`.
    Replaces ``mg_gcn_tpu/ops/spmm_pattern.py:_bwd_kernel``."""
    if b.device.type == "cpu":
        return pattern_bwd_plain(pack, b)
    out = _launch("mggcn_pattern_bwd", pack, b)
    pattern_bwd.launches[(str(b.dtype).removeprefix("torch."), b.shape[1])] += 1
    return out


pattern_fwd.launches = collections.Counter()
pattern_bwd.launches = collections.Counter()


# ---------------------------------------------------------------------------
# the aggregation around the kernel pair


def apply_pattern_calls(mat: PatternMat, b: torch.Tensor, call_fwd, call_bwd) -> torch.Tensor:
    """Pre/post scale, padding and int8 per-feature quantize/dequantize around
    a (call_fwd, call_bwd) pair of products, ``call(mat, operand)``.

    Rounding points are the JAX wrapper's (spmm_pattern.py:298-346): B is
    scaled in float32 first, then cast to bfloat16, or quantized per feature
    as round(b / qscale) (half to even) clipped to ±127 with
    qscale = max(|column|, 1e-30) / 127. The pattern side is exact 0/1 and
    int8 sums are int32, so int8's only error is the input rounding.
    """
    n, d = b.shape
    if n != mat.n:
        raise ValueError(f"B has {n} rows, pattern expects {mat.n}")
    call = call_fwd if mat.orientation == "PT" else call_bwd
    b = b.to(torch.float32)
    if mat.scale_side == "pre":
        b = b * mat.scale[:n, None]
    d_pad = round_up(max(d, 8), 8)
    op_dt = DTYPES[mat.dtype_name]
    bm = torch.zeros((mat.n_pad, d_pad), dtype=op_dt, device=b.device)
    if op_dt == torch.int8:
        amax = torch.clamp(torch.amax(torch.abs(b), dim=0), min=1e-30)
        # a tensor divisor: CUDA turns division by a Python scalar into a
        # multiply by its reciprocal, which can move qscale by an ulp
        qscale = amax / torch.full_like(amax, 127.0)
        bm[:n, :d] = torch.clamp(torch.round(b / qscale[None, :]), -127, 127).to(torch.int8)
        c = call(mat, bm)[:n, :d].to(torch.float32) * qscale[None, :]
    else:
        bm[:n, :d] = b.to(op_dt)
        c = call(mat, bm)[:n, :d]
    if mat.scale_side == "post":
        c = c * mat.scale[:n, None]
    return c


def spmm_pattern(mat: PatternMat, b: torch.Tensor) -> torch.Tensor:
    """``C = M @ B`` for row-major B (n, d); returns (n, d) float32."""
    return apply_pattern_calls(
        mat, b, lambda m, x: pattern_fwd(m.pack, x), lambda m, x: pattern_bwd(m.pack, x)
    )
