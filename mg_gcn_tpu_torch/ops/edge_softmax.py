"""GAT's edge softmax as fused row walks: one head's attention weights from
its score vectors, and their gradient.

For entry e = (r, c) of an attention graph (``ops/edge_attention.py``) and
the head's score vectors ``e_dst`` (n_out) and ``e_src`` (n_in), rounded to
the graph's compute dtype: the LeakyReLU's input ``p_e = e_dst[r] +
e_src[c]``, the score ``s_e = leaky(p_e, slope) (+ bias_e)``, and the
two-pass row softmax of :func:`~.edge_attention.slot_softmax` over each
row's scores, with the rounding points the composite's products give it
(``csrc/edge_softmax.cu`` states both passes and the gradient).

The kernels are hand-written CUDA (``csrc/edge_softmax.cu``):
:func:`softmax_fwd` launches two row walks (the global max, then both
passes and the weights), :func:`softmax_bwd` one (the per-entry gradient of
the LeakyReLU's input, rounded to the compute dtype, and its row sums).
Each wrapper launches its kernels for a CUDA tensor and runs its plain
PyTorch version for a CPU tensor, only because the tensor lies on the CPU,
and counts its kernel launches in ``.launches`` by (dtype, 8). A matrix
with no entry launches nothing.

The plain versions (:func:`softmax_fwd_plain`, :func:`softmax_bwd_plain`)
compute each entry's value with the kernels' operations. By default they sum
each row in entry order (:func:`entry_row_sums`), as the composite's plain
products do, so on the CPU the op gives the composite's bits. With
``row_sums=walk_row_sums`` they sum each row in the kernels' order (lane l
of a warp takes a row's entries l, l + 32, ... in order, the 32 lanes' sums
meet by the xor tree), so on the card they meet the kernels bit for bit
wherever ``exp`` and ``log`` do (for the tests).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .. import _build

_CODE = {torch.float32: 0, torch.bfloat16: 1}
WARP = 32
# the floors of the row sums (torch.clamp's min in slot_softmax) and the
# clip of the first pass
_FLOOR, _CLIP = 1e-30, -80.0


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` (to nearest even), as float32."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def _entry_rows(indptr: torch.Tensor) -> torch.Tensor:
    n_out = indptr.numel() - 1
    return torch.repeat_interleave(torch.arange(n_out, device=indptr.device), indptr.diff(),
                                   output_size=int(indptr[-1]))


def entry_row_sums(indptr: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Each row's sum of the float32 per-entry values ``v``, (n_out,)
    float32: ``index_add_`` over the entries, in entry order on the CPU."""
    out = torch.zeros(indptr.numel() - 1, dtype=torch.float32, device=v.device)
    return out.index_add_(0, _entry_rows(indptr), v) if v.numel() else out


def walk_row_sums(indptr: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Each row's sum of the float32 per-entry values ``v`` in the row
    walk's order: lane l's sum of the row's entries l, l + 32, l + 64, ...
    in order, then the 32 lanes' sums met by the xor tree (lanes l and l ^
    1 first, then pairs of pairs). (n_out,) float32; 0 for an empty row."""
    n_out, dev = indptr.numel() - 1, v.device
    part = torch.zeros(n_out * WARP, dtype=torch.float32, device=dev)
    if v.numel():
        rows = _entry_rows(indptr)
        pos = torch.arange(v.numel(), device=dev) - indptr[rows]
        slot, step = rows * WARP + pos % WARP, pos // WARP
        order = torch.argsort(step, stable=True)
        start = 0
        for end in torch.bincount(step).cumsum(0).tolist():  # the lanes' k-th entries: one slot each
            at = order[start:end]
            part[slot[at]] += v[at]
            start = end
    part = part.view(n_out, WARP)
    lanes = torch.arange(WARP, device=dev)
    for off in (1, 2, 4, 8, 16):
        part = part + part[:, lanes ^ off]
    return part[:, 0].contiguous()


def _scores(indptr, indices, e_dst, e_src, bias, slope):
    """(entry rows, the LeakyReLU's input p, the scores s), float32."""
    rows = _entry_rows(indptr)
    pre = e_dst.to(torch.float32)[rows] + e_src.to(torch.float32)[indices.long()]
    s = torch.where(pre > 0, pre, slope * pre)
    return rows, pre, (s if bias is None else s + bias)


def softmax_fwd_plain(indptr, indices, e_dst, e_src, bias, slope, row_sums=entry_row_sums):
    """Plain version of :func:`softmax_fwd`, its rows summed by
    ``row_sums``."""
    dtype = e_dst.dtype
    rows, _, s = _scores(indptr, indices, e_dst, e_src, bias, slope)
    smax = torch.amax(s) if s.numel() else torch.zeros((), device=s.device)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    rs1 = row_sums(indptr, _round(torch.exp(torch.clamp(s - smax, _CLIP, 0.0)), dtype))
    shift = _round(smax + torch.log(torch.clamp(rs1, min=_FLOOR)), dtype)
    u = s - shift[rows]
    rowsum = row_sums(indptr, _round(torch.exp(u), dtype))
    slot = _round(torch.log(torch.clamp(rowsum, min=_FLOOR)), dtype)
    return torch.exp(u - slot[rows]), torch.stack([shift, slot, rowsum])


def softmax_bwd_plain(indptr, indices, e_dst, e_src, bias, slope, stats, dalpha, row_sums=entry_row_sums):
    """Plain version of :func:`softmax_bwd`, its rows summed by
    ``row_sums``."""
    dtype = e_dst.dtype
    rows, pre, s = _scores(indptr, indices, e_dst, e_src, bias, slope)
    shift, slot, rowsum = stats
    u = s - shift[rows]
    g_t = dalpha * torch.exp(u - slot[rows])
    g_log_rs = row_sums(indptr, _round(-g_t, dtype))
    g_rowsum = _round(torch.where(rowsum >= _FLOOR, g_log_rs / rowsum, torch.zeros_like(rowsum)), dtype)
    g_s = g_t + g_rowsum[rows] * torch.exp(u)
    g_pre = torch.where(pre > 0, g_s, slope * g_s).to(dtype)
    return row_sums(indptr, g_pre.to(torch.float32)), g_pre


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("edge_softmax")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mggcn_softmax_fwd.argtypes = [p] * 8 + [ctypes.c_longlong, ctypes.c_float, i, p]
    lib.mggcn_softmax_bwd.argtypes = [p] * 9 + [ctypes.c_longlong, ctypes.c_float, i, p]
    lib.mggcn_softmax_fwd.restype = lib.mggcn_softmax_bwd.restype = i
    lib.mggcn_error_string.argtypes = [i]
    lib.mggcn_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, indptr, indices, e_dst, e_src, per_entry, stats=None) -> None:
    """Device, dtypes, shapes and contiguity before a launch: ``per_entry``
    lists the float32 operands of one value an entry (the bias, the
    cotangent), ``stats`` the (3, n_out) row statistics."""
    dev = e_dst.device
    per_entry = [t for t in per_entry if t is not None]
    tensors = [indptr, indices, e_dst, e_src, *per_entry] + ([stats] if stats is not None else [])
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every operand must lie on one CUDA device")
    if indptr.dtype != torch.int64 or indices.dtype != torch.int32 or indptr.dim() != 1 or indices.dim() != 1:
        raise ValueError(f"{name}: indptr must be 1-D int64 and indices 1-D int32")
    if e_dst.dtype not in _CODE or e_src.dtype != e_dst.dtype or e_dst.shape != (indptr.numel() - 1,) \
            or e_src.dim() != 1:
        raise ValueError(f"{name}: e_dst (n_out,) and e_src (n_in,) must be float32 or bfloat16, of one dtype")
    if any(t.dtype != torch.float32 or t.shape != indices.shape for t in per_entry):
        raise ValueError(f"{name}: the bias and the cotangent must be float32, one value an entry")
    if stats is not None and (stats.dtype != torch.float32 or stats.shape != (3, e_dst.numel())):
        raise ValueError(f"{name}: the row statistics must be float32 (3, n_out)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if indices.numel() >= 2**31:
        raise ValueError(f"{name}: fewer than 2^31 entries expected")


def _call(entry: str, *args, stream_of: torch.Tensor) -> None:
    lib = _lib()
    with torch.cuda.device(stream_of.device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(stream_of.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} ({lib.mggcn_error_string(err).decode()})")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def softmax_fwd(indptr: torch.Tensor, indices: torch.Tensor, e_dst: torch.Tensor, e_src: torch.Tensor,
                bias: torch.Tensor | None, slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha, stats): the attention weights (nnz,) float32 in CSR entry
    order and each row's (shift, slot, rowsum) as (3, n_out) float32, for
    the CSR structure (indptr, indices), the score vectors ``e_dst``
    (n_out,) and ``e_src`` (n_in,) (both float32 or both bfloat16: the
    rounding dtype) and the per-entry float32 ``bias`` or None."""
    if e_dst.device.type == "cpu":
        return softmax_fwd_plain(indptr, indices, e_dst, e_src, bias, slope)
    _check("softmax_fwd", indptr, indices, e_dst, e_src, (bias,))
    n_out, dev = e_dst.numel(), e_dst.device
    alpha = torch.empty(indices.numel(), dtype=torch.float32, device=dev)
    stats = torch.empty((3, n_out), dtype=torch.float32, device=dev)
    if not indices.numel():  # no entry: no launch on an empty (null) pointer
        return alpha, stats.zero_()
    key = torch.empty(1, dtype=torch.int32, device=dev)  # the max walk's scratch
    _call("mggcn_softmax_fwd", indptr.data_ptr(), indices.data_ptr(), e_dst.data_ptr(), e_src.data_ptr(), _ptr(bias),
          key.data_ptr(), alpha.data_ptr(), stats.data_ptr(), n_out, slope, _CODE[e_dst.dtype], stream_of=alpha)
    softmax_fwd.launches[(str(e_dst.dtype).removeprefix("torch."), 8)] += 2
    return alpha, stats


def softmax_bwd(indptr: torch.Tensor, indices: torch.Tensor, e_dst: torch.Tensor, e_src: torch.Tensor,
                bias: torch.Tensor | None, slope: float, stats: torch.Tensor,
                dalpha: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(de_dst, g_pre) for the cotangent ``dalpha`` (nnz,) float32 of
    :func:`softmax_fwd`'s weights and its ``stats``: the gradient of each
    entry's LeakyReLU input in ``e_dst``'s dtype (nnz,), and its row sums,
    the gradient of ``e_dst`` (n_out,) float32. The gradient of ``e_src``
    is the column sums of ``g_pre`` (the transposed product)."""
    if e_dst.device.type == "cpu":
        return softmax_bwd_plain(indptr, indices, e_dst, e_src, bias, slope, stats, dalpha)
    _check("softmax_bwd", indptr, indices, e_dst, e_src, (bias, dalpha), stats)
    n_out, dev = e_dst.numel(), e_dst.device
    de_dst = torch.empty(n_out, dtype=torch.float32, device=dev)
    g_pre = torch.empty(indices.numel(), dtype=e_dst.dtype, device=dev)
    if not indices.numel():
        return de_dst.zero_(), g_pre
    _call("mggcn_softmax_bwd", indptr.data_ptr(), indices.data_ptr(), e_dst.data_ptr(), e_src.data_ptr(), _ptr(bias),
          stats.data_ptr(), dalpha.data_ptr(), de_dst.data_ptr(), g_pre.data_ptr(), n_out, slope, _CODE[e_dst.dtype],
          stream_of=g_pre)
    softmax_bwd.launches[(str(e_dst.dtype).removeprefix("torch."), 8)] += 1
    return de_dst, g_pre


softmax_fwd.launches = collections.Counter()
softmax_bwd.launches = collections.Counter()
