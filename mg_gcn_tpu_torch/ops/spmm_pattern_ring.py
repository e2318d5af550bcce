"""Fused ring pattern SpMM: one launch a partition sums every round of the
row-partitioned schedule.

Port of ``mg_gcn_tpu/ops/spmm_pattern_ring.py:279-370``. For partition j of
P, with k_s = (j+s) mod P and the ring-ordered pack of
``parallel.dist.DistPatternPair``:

    forward   C_j = Σ_s pack_fwd[j, s]ᵀ · B_{k_s}     (:func:`ring_pattern_fwd`)
    backward  C_j = Σ_s pack_bwd[j, s]  · G_{k_s}     (:func:`ring_pattern_bwd`)

Scales, casts and int8 quantization stay in the caller
(``parallel.dist.dist_aggregate_pattern``), as in the JAX package. The TPU
kernels circulate the blocks with in-kernel RDMA; here the caller's exchange
fills a (P, m, d_pad) slot buffer on the partition's device first (slot 0
its own block, slot s partition k_s's), and the kernels
(``csrc/spmm_pattern_ring.cu``) read only that device's memory. Operands
are row-major (the JAX forward's are feature-major). Each wrapper launches
its kernel for CUDA tensors and uses its plain PyTorch version for CPU
tensors, only because they lie on the CPU. Launches are counted in
``.launches`` by (dtype, d_pad).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .. import _build
from .spmm_pattern import (
    _DTYPE_CODE, BWD_GEOMETRY_KEYS, GROUP, bwd_groups_plain, pattern_bwd_plain, pattern_fwd_plain, query_geometry,
)


def _plain(plain, pack: torch.Tensor, slots: torch.Tensor, acc_dtype: torch.dtype | None) -> torch.Tensor:
    out = plain(pack[0], slots[0], acc_dtype)
    for s in range(1, pack.shape[0]):
        out += plain(pack[s], slots[s], acc_dtype)
    return out


def ring_pattern_fwd_plain(pack: torch.Tensor, slots: torch.Tensor, acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of :func:`ring_pattern_fwd`: the sum over rounds of
    ``pattern_fwd_plain(pack[s], slots[s])``, float sums in float32 or
    ``acc_dtype`` (float64 gives an order-free reference), int8 in int32."""
    return _plain(pattern_fwd_plain, pack, slots, acc_dtype)


def ring_pattern_bwd_plain(pack: torch.Tensor, slots: torch.Tensor, acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of :func:`ring_pattern_bwd`: Σ_s pattern_bwd_plain(pack[s], slots[s])."""
    return _plain(pattern_bwd_plain, pack, slots, acc_dtype)


def ring_pattern_bwd_groups_plain(pack: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """:func:`ring_pattern_bwd` in its kernel's order: the rounds of a row
    walked as one stream (``spmm_pattern.bwd_groups_plain``). For the tests."""
    return bwd_groups_plain(pack, slots.reshape(-1, slots.shape[2]))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_pattern_ring")
    for fn in (lib.mggcn_ring_fwd, lib.mggcn_ring_bwd):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    for fn in (lib.mggcn_ring_fwd_geometry, lib.mggcn_ring_bwd_geometry):
        fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mggcn_error_string.argtypes = [ctypes.c_int]
    lib.mggcn_error_string.restype = ctypes.c_char_p
    return lib


def ring_pattern_fwd_geometry(parts: int, m: int, d_pad: int, dtype: torch.dtype) -> dict:
    """The launch geometry of :func:`ring_pattern_fwd` for a (P, m, m/32)
    pack and (P, m, d_pad) slots of ``dtype`` (see
    ``spmm_pattern.query_geometry``)."""
    return query_geometry(_lib(), "mggcn_ring_fwd_geometry", parts, m, d_pad, _DTYPE_CODE[dtype])


def ring_pattern_bwd_geometry(parts: int, m: int, d_pad: int, dtype: torch.dtype) -> dict:
    """The launch geometry of :func:`ring_pattern_bwd` for a (P, m, m/32)
    pack and (P, m, d_pad) slots of ``dtype`` (see
    ``spmm_pattern.pattern_bwd_geometry``)."""
    return query_geometry(_lib(), "mggcn_ring_bwd_geometry", parts, m, d_pad, _DTYPE_CODE[dtype],
                          keys=BWD_GEOMETRY_KEYS)


def _launch(name: str, pack: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Check the operands, allocate C (m, d_pad) and launch kernel ``name`` on
    the current stream; raises when the launch is refused."""
    if slots.device.type != "cuda" or pack.device != slots.device:
        raise ValueError(f"{name}: pack and slots must lie on one CUDA device")
    if pack.dtype != torch.int32 or pack.dim() != 3 or not pack.is_contiguous():
        raise ValueError(f"{name}: pack must be a contiguous 3-D int32 tensor (P, m, m/32)")
    parts, m, words = pack.shape
    if m % GROUP or words * 32 != m:
        raise ValueError(f"{name}: pack shape {tuple(pack.shape)} is not (P, m, m/32), m % {GROUP} == 0")
    if slots.dtype not in _DTYPE_CODE or slots.dim() != 3 or not slots.is_contiguous():
        raise ValueError(f"{name}: slots must be a contiguous 3-D float32/bfloat16/int8 tensor")
    d_pad = slots.shape[2]
    if slots.shape[:2] != (parts, m) or d_pad % 8 or d_pad == 0:
        raise ValueError(f"{name}: slots shape {tuple(slots.shape)} is not (P, m, d_pad), d_pad % 8 == 0")
    if pack.data_ptr() % 16 or slots.data_ptr() % 16:
        raise ValueError(f"{name}: pack and slots must be 16-byte aligned")
    out = torch.empty((m, d_pad), dtype=torch.int32 if slots.dtype == torch.int8 else torch.float32,
                      device=slots.device)
    lib = _lib()
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream(slots.device).cuda_stream
        err = getattr(lib, name)(
            pack.data_ptr(), slots.data_ptr(), out.data_ptr(), parts, m, d_pad, _DTYPE_CODE[slots.dtype], stream
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.mggcn_error_string(err).decode()})")
    return out


def ring_pattern_fwd(pack: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """C = Σ_s pack[s]ᵀ · slots[s] for the partition's ring-ordered int32
    pack (P, m, m/32) and its slot buffer (P, m, d_pad) in
    float32/bfloat16/int8; C is (m, d_pad) float32 (int32 for int8).
    Replaces ``mg_gcn_tpu/ops/spmm_pattern_ring.py:_fwd_ring_kernel``."""
    if slots.device.type == "cpu":
        return ring_pattern_fwd_plain(pack, slots)
    out = _launch("mggcn_ring_fwd", pack, slots)
    ring_pattern_fwd.launches[(str(slots.dtype).removeprefix("torch."), slots.shape[2])] += 1
    return out


def ring_pattern_bwd(pack: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """C = Σ_s pack[s] · slots[s], same operands as :func:`ring_pattern_fwd`.
    Replaces ``mg_gcn_tpu/ops/spmm_pattern_ring.py:_bwd_ring_kernel``."""
    if slots.device.type == "cpu":
        return ring_pattern_bwd_plain(pack, slots)
    out = _launch("mggcn_ring_bwd", pack, slots)
    ring_pattern_bwd.launches[(str(slots.dtype).removeprefix("torch."), slots.shape[2])] += 1
    return out


ring_pattern_fwd.launches = collections.Counter()
ring_pattern_bwd.launches = collections.Counter()
