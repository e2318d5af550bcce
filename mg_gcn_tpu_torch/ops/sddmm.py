"""SDDMM — per-entry scores of a sparse structure, for attention.

Port of ``mg_gcn_tpu/ops/sddmm.py`` (``sddmm_edge_tiles``): for every stored
entry e = (r, c) of an :class:`~.spmm_edges.EdgeTileMat`, the score
``s_e = <A[r, :], B[c, :]>``, one float32 per entry in CSR entry order — the
order in which the edge engine takes its weights, so scores, attention
weights and their cotangents pass between the SDDMM and the weighted SpMM
without any gather or scatter (the layout decision recorded in ROADMAP
queue 2). The matrix's weights are not read.

Modes, as the JAX op's:

* float32 and bfloat16 (the matrix's compute dtype): A and B are cast to
  it; products and sums are float32.
* int8 (an int8-mode matrix): A and B are quantized per feature on their
  device, ``qa = max(max|a|, 1e-30) / 127`` (a division by a tensor on the
  same device: ROADMAP queue 3), ``aq = round(a / qa)`` half to even and
  clipped to ±127; then ``s_e = Σ_d f32(aq·bq) · (qa_d · qb_d)``, the
  per-feature scale applied before the float32 reduce
  (``sddmm.py:221-227, 280-289``).

``qskip=True`` runs the q-range kernel's counterpart, which launches only
over the matrix's rows with entries (``EdgeTileMat.live_rows``, computed on
the device once per matrix) with the same per-entry arithmetic: its scores
are bitwise equal to the default's. The default stays off, as in the JAX
package (``sddmm.py:304-310``). ``select`` is only checked: the TPU's two
select schedules ("one", "two") do not exist here. The TPU's ``d > 512``
split was a VMEM limit: every width runs in one launch.

The kernels are hand-written CUDA (``csrc/sddmm.cu``): :func:`sddmm`
(``_sddmm_kernel``) and :func:`sddmm_qskip` (``_sddmm_kernel_qskip``).
Each wrapper launches its kernel for a CUDA tensor and uses its plain
PyTorch version for a CPU tensor — only because the tensor lies on the
CPU — and counts its launches in ``.launches`` by (dtype, d_pad).

A warp scores a row's entries in G groups of L lanes, each lane summing F
features of an entry, the L partial sums met by a fixed xor tree:
:func:`sddmm_geometry` states the rule, :func:`sddmm_launch_geometry`
reports a launch's geometry from the card, and :func:`sddmm_groups_plain`
computes the scores in the kernel's order (for the tests).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .spmm_edges import DTYPES, EdgeTileMat, load_csr_lib, pad_features
from .spmm_pattern import query_geometry

_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
SELECTS = ("one", "two")
# scored entries the plain version holds at once (bounds its temporaries)
_PLAIN_ELEMS_CAP = 1 << 26


def sddmm_plain(indptr, indices, a, b, g=None) -> torch.Tensor:
    """Plain version of :func:`sddmm`: index_select, multiply and sum over
    the features, in float32, or in float64 for ``a`` and ``b`` of float64
    (a reference). int8: ``Σ_d f32(aq·bq) · g_d``."""
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    n_out, d = indptr.numel() - 1, a.shape[1]
    rows = torch.repeat_interleave(torch.arange(n_out, device=a.device), indptr.diff())
    out = torch.empty(indices.numel(), dtype=acc, device=a.device)
    step = max(1, _PLAIN_ELEMS_CAP // max(d, 1))
    for e0 in range(0, indices.numel(), step):
        ar = a.index_select(0, rows[e0 : e0 + step]).to(acc)
        br = b.index_select(0, indices[e0 : e0 + step].long()).to(acc)
        prod = ar * br
        if g is not None:
            prod *= g.to(acc)
        out[e0 : e0 + step] = prod.sum(dim=1)
    return out


def sddmm_geometry(d_pad: int, dtype: torch.dtype) -> dict:
    """The kernels' split of a warp at width ``d_pad`` in ``dtype``
    (``csrc/sddmm.cu`` ``features_for``, ``lanes_for``): ``features`` F a
    lane loads at once (16 bytes, or 8 for an int8 row of d_pad % 16 == 8,
    only 8-byte aligned), ``lanes`` L, the smallest power of two >= d_pad /
    F capped at 32 (wider rows loop in chunks of 32 F), ``groups`` G = 32 /
    L, ``entries`` U = 8 a group scores a batch, and ``shuffles``, the warp
    shuffles of the tree a batch of G U entries: a reduce-scatter over R =
    min(L, 8) lanes, (U / R)(R - 1), then log2(L / R) more a score.
    bfloat16 d_pad 8 gives L = 1 (no shuffle), 64 gives L = 8 (7 shuffles
    for 32 entries)."""
    if d_pad <= 0 or d_pad % 8:
        raise ValueError(f"d_pad must be a positive multiple of 8, got {d_pad}")
    size = torch.empty((), dtype=dtype).element_size()
    features = (16 if d_pad * size % 16 == 0 else 8) // size
    lanes = 1
    while lanes < 32 and lanes * features < d_pad:
        lanes *= 2
    entries = 8
    scatter = min(lanes, entries)
    shuffles = entries // scatter * (scatter - 1 + (lanes // scatter).bit_length() - 1)
    return {"lanes": lanes, "groups": 32 // lanes, "entries": entries, "features": features, "shuffles": shuffles}


def sddmm_groups_plain(indptr, indices, a, b, g=None) -> torch.Tensor:
    """:func:`sddmm` in the kernel's order (:func:`sddmm_geometry`): in
    each chunk c of L·F features, lane l of an entry's group sums its
    features c·L·F + l·F .. + F - 1 in order, one float32 term at a time,
    and the L partial sums meet by the xor tree (lanes l and l ^ 1 first,
    then pairs of pairs); the chunks' scores are then added in chunk order
    (a row wider than one chunk is walked once a chunk). A term is
    float32's fused multiply-add (computed in float64 and rounded once;
    bfloat16 products are exact in float32), or int8's ``f32(aq·bq)·g``
    rounded, then added. For the tests."""
    n_out, d_pad = indptr.numel() - 1, a.shape[1]
    geo = sddmm_geometry(d_pad, a.dtype)
    lanes, feats = geo["lanes"], geo["features"]
    chunks = -(-d_pad // (lanes * feats))
    width = chunks * lanes * feats
    rows = torch.repeat_interleave(torch.arange(n_out, device=a.device), indptr.diff())

    def lane_major(x: torch.Tensor) -> torch.Tensor:
        x = torch.nn.functional.pad(x.to(torch.float32), (0, width - d_pad))
        return x.view(-1, chunks, lanes, feats)

    ar = lane_major(a.index_select(0, rows))
    br = lane_major(b.index_select(0, indices.long()))
    gs = lane_major(g[None, :])[0] if g is not None else None
    score = None
    for c in range(chunks):
        part = torch.zeros((indices.numel(), lanes), dtype=torch.float32, device=a.device)
        for f in range(feats):
            x, y = ar[:, c, :, f], br[:, c, :, f]
            if gs is not None:
                part = part + (x * y) * gs[c, :, f]
            elif a.dtype == torch.float32:
                part = (part.double() + x.double() * y.double()).to(torch.float32)
            else:
                part = part + x * y
        off = 1
        while off < lanes:  # the lane adds the sums ``off`` lanes away: p_l + p_(l xor off)
            part = part + part[:, torch.arange(lanes, device=a.device) ^ off]
            off *= 2
        score = part[:, 0] if score is None else score + part[:, 0]
    return score.contiguous()


@functools.cache
def _lib() -> ctypes.CDLL:
    # (operand pointers, mode ints): the scores' row count is that of the
    # rows launched over (all rows, or the live ones), d_pad, the dtype code
    lib = load_csr_lib("sddmm", mggcn_sddmm=(5, 1), mggcn_sddmm_qskip=(6, 1))
    lib.mggcn_sddmm_geometry.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mggcn_sddmm_geometry.restype = ctypes.c_int
    return lib


# the kernels' launch geometry (csrc/sddmm.cu geometry): the stages slot of
# async_copy::write_geometry holds the B loads a lane keeps in flight
GEOMETRY_KEYS = ("grid_x", "grid_y", "threads", "smem", "in_flight", "blocks_per_sm", "resident_blocks",
                 "lanes", "groups", "entries", "features", "shuffles")


def sddmm_launch_geometry(n_out: int, d_pad: int, dtype: torch.dtype) -> dict:
    """The launch geometry of :func:`sddmm` over ``n_out`` rows of width
    ``d_pad`` in ``dtype``, from the card: grid, threads, B loads in flight
    a lane, resident blocks, and :func:`sddmm_geometry`'s keys.
    :func:`sddmm_qskip` launches the same kernel over its live rows."""
    return query_geometry(_lib(), "mggcn_sddmm_geometry", n_out, d_pad, _CODE[dtype], keys=GEOMETRY_KEYS)


def _check(name, indptr, indices, a, b, g) -> None:
    """Device, dtypes, shapes, contiguity and alignment before a launch."""
    dev = a.device
    tensors = [indptr, indices, a, b] + ([g] if g is not None else [])
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: indptr, indices, A, B and g must lie on one CUDA device")
    if indptr.dtype != torch.int64 or indices.dtype != torch.int32 or indptr.dim() != 1 or indices.dim() != 1:
        raise ValueError(f"{name}: indptr must be 1-D int64 and indices 1-D int32")
    if a.dtype not in _CODE or b.dtype != a.dtype or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{name}: A and B must be 2-D float32, bfloat16 or int8, of one dtype")
    d_pad = a.shape[1]
    if b.shape[1] != d_pad or d_pad % 8 or d_pad == 0 or a.shape[0] != indptr.numel() - 1:
        raise ValueError(f"{name}: A (n_out, d_pad) and B (n_in, d_pad) with d_pad % 8 == 0")
    if (a.dtype == torch.int8) != (g is not None) or (g is not None and (g.dtype != torch.float32
                                                                         or g.shape != (d_pad,))):
        raise ValueError(f"{name}: int8 takes g, float32 (d_pad,); the float modes take none")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (a, b) + ((g,) if g is not None else ())):
        raise ValueError(f"{name}: A, B and g must be 16-byte aligned")
    if indices.numel() >= 2**31:
        raise ValueError(f"{name}: fewer than 2^31 entries expected")


def _run(entry: str, ptrs: list, out: torch.Tensor, n_work: int, a: torch.Tensor) -> None:
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, entry)(*ptrs, out.data_ptr(), n_work, a.shape[1], _CODE[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} ({lib.mggcn_error_string(err).decode()})")


def sddmm(indptr: torch.Tensor, indices: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          g: torch.Tensor | None = None) -> torch.Tensor:
    """Scores (nnz,) float32 of the CSR structure (indptr, indices) for
    row-major A (n_out, d_pad) and B (n_in, d_pad), both float32, bfloat16
    or int8; int8 takes the per-feature scale product g (d_pad,) float32.
    Replaces ``mg_gcn_tpu/ops/sddmm.py:_sddmm_kernel``."""
    if a.device.type == "cpu":
        return sddmm_plain(indptr, indices, a, b, g)
    _check("sddmm", indptr, indices, a, b, g)
    out = torch.empty(indices.numel(), dtype=torch.float32, device=a.device)
    if out.numel():
        ptrs = [indptr.data_ptr(), indices.data_ptr(), a.data_ptr(), b.data_ptr(), None if g is None else g.data_ptr()]
        _run("mggcn_sddmm", ptrs, out, indptr.numel() - 1, a)
        sddmm.launches[(str(a.dtype).removeprefix("torch."), a.shape[1])] += 1
    return out


def sddmm_qskip(indptr: torch.Tensor, indices: torch.Tensor, live_rows: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`sddmm`, launched over ``live_rows`` (int32, the rows with
    entries) only; bitwise equal to it.
    Replaces ``mg_gcn_tpu/ops/sddmm.py:_sddmm_kernel_qskip``."""
    if a.device.type == "cpu":
        return sddmm_plain(indptr, indices, a, b, g)
    _check("sddmm_qskip", indptr, indices, a, b, g)
    if live_rows.dtype != torch.int32 or live_rows.device != a.device or not live_rows.is_contiguous():
        raise ValueError("sddmm_qskip: live_rows must be contiguous int32 on A's device")
    out = torch.empty(indices.numel(), dtype=torch.float32, device=a.device)
    if out.numel():
        ptrs = [indptr.data_ptr(), indices.data_ptr(), live_rows.data_ptr(), a.data_ptr(), b.data_ptr(),
                None if g is None else g.data_ptr()]
        _run("mggcn_sddmm_qskip", ptrs, out, live_rows.numel(), a)
        sddmm_qskip.launches[(str(a.dtype).removeprefix("torch."), a.shape[1])] += 1
    return out


sddmm.launches = collections.Counter()
sddmm_qskip.launches = collections.Counter()


def quantize_per_feature(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-feature symmetric int8: (xq, scale) with scale = max(max|x|,
    1e-30) / 127, divided by a tensor on x's device (ROADMAP queue 3)."""
    x32 = x.to(torch.float32)
    amax = torch.clamp(torch.amax(torch.abs(x32), dim=0), min=1e-30)
    scale = amax / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(x32 / scale[None, :]), -127, 127).to(torch.int8), scale


def sddmm_edge_tiles(mat: EdgeTileMat, a: torch.Tensor, b: torch.Tensor, qskip: bool | None = None,
                     select: str = "two") -> torch.Tensor:
    """Per-entry scores ``<A[row_e], B[col_e]>`` for the entries of ``mat``
    (its structure only), float32 (nnz,) in CSR entry order. A must be
    (n_out, d), B (n_in, d)."""
    if a.shape[0] != mat.n_out or b.shape[0] != mat.n_in:
        raise ValueError(f"A/B have {a.shape[0]}/{b.shape[0]} rows; mat expects {mat.n_out}/{mat.n_in}")
    if a.shape[1] != b.shape[1]:
        raise ValueError("A and B must share the feature dimension")
    if select not in SELECTS:
        raise ValueError(f"unknown select {select!r} (expected one/two)")
    d = a.shape[1]
    g = None
    if mat.dtype_name == "int8":
        aq, qa = quantize_per_feature(a)
        bq, qb = quantize_per_feature(b)
        am, bm = pad_features(aq, torch.int8), pad_features(bq, torch.int8)
        g = torch.zeros(am.shape[1], dtype=torch.float32, device=a.device)
        g[:d] = qa * qb
    else:
        cdtype = DTYPES[mat.dtype_name]
        am, bm = pad_features(a, cdtype), pad_features(b, cdtype)
    if qskip:
        return sddmm_qskip(mat.indptr, mat.indices, mat.live_rows, am, bm, g)
    return sddmm(mat.indptr, mat.indices, am, bm, g)
