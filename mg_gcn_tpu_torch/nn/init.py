"""Weight initialization.

Port of ``mg_gcn_tpu/nn/init.py``. Two modes:

* :func:`kaiming_uniform_ref` — bit parity with the reference's
  ``dn_matrix::init`` (matrix.hpp:539-545): Kaiming-uniform with LeakyReLU
  gain, drawn from ``std::default_random_engine(99)`` (libstdc++
  minstd_rand0) through ``std::uniform_real_distribution``. The reference
  reseeds at 99 per matrix, so equal-shaped layers get identical weights.
  Pure numpy, so it is bit-equal to the JAX package's arrays.
* :func:`kaiming_uniform` — the same distribution from a ``torch.Generator``
  (not the same numbers as ``jax.random``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MINSTD0_A = 16807
MINSTD0_M = 2147483647  # 2^31 - 1
LEAKY_GAIN = math.sqrt(2.0 / (1.0 + 0.01 * 0.01))
BIAS_GAIN = math.sqrt(1.0 / 3.0)  # reference b.init(sqrt(1/3)), gcn.hpp:110


def minstd0_sequence(seed: int, count: int) -> np.ndarray:
    """First ``count`` outputs of std::minstd_rand0 (x <- 16807 x mod 2^31-1).

    Vectorized by log-doubling: X[n:2n] = (a^n mod M) * X[:n] mod M, exact in
    uint64 (products < 2^62).
    """
    if count <= 0:
        return np.empty(0, dtype=np.uint64)
    out = np.empty(count, dtype=np.uint64)
    out[0] = (MINSTD0_A * (seed % MINSTD0_M)) % MINSTD0_M
    filled = 1
    mult = MINSTD0_A
    while filled < count:
        take = min(filled, count - filled)
        out[filled : filled + take] = (out[:take] * mult) % MINSTD0_M
        filled += take
        mult = (mult * mult) % MINSTD0_M
    return out


def _canonical_from_minstd0(seed: int, count: int) -> np.ndarray:
    """libstdc++ std::generate_canonical<double, 53> over minstd_rand0:
    R = 2^31 - 2 and two draws per variate,
    ret = ((x1 - 1) + (x2 - 1) * R) / R^2."""
    r = np.float64(MINSTD0_M - 1)
    seq = minstd0_sequence(seed, 2 * count).astype(np.float64) - 1.0
    return (seq[0::2] + seq[1::2] * r) / (r * r)


def uniform_ref(
    shape: tuple[int, ...], low: float, high: float, seed: int = 99
) -> np.ndarray:
    """std::uniform_real_distribution(low, high) over default_random_engine
    (seed), row-major fill, float64 math truncated to float32."""
    u = _canonical_from_minstd0(seed, int(np.prod(shape)))
    return (u * (high - low) + low).astype(np.float32).reshape(shape)


def kaiming_uniform_ref(
    fan_in: int, fan_out: int, gain: float = LEAKY_GAIN, seed: int = 99
) -> np.ndarray:
    """Reference dn_matrix::init for a (fan_in, fan_out) weight matrix."""
    bound = gain * math.sqrt(3.0 / fan_in)
    return uniform_ref((fan_in, fan_out), -bound, bound, seed)


def bias_ref(fan_out: int, seed: int = 99) -> np.ndarray:
    """Reference bias init: b is (1, out), so the bound is
    sqrt(1/3) * sqrt(3/1) = 1 -> U(-1, 1)."""
    bound = BIAS_GAIN * math.sqrt(3.0 / 1.0)
    return uniform_ref((1, fan_out), -bound, bound, seed)


def kaiming_uniform(
    gen: torch.Generator, fan_in: int, fan_out: int, gain: float = LEAKY_GAIN
) -> torch.Tensor:
    """Kaiming uniform (same bound as the reference) drawn on the CPU from
    ``gen``, so a seed gives the same weights whatever the target device."""
    bound = gain * math.sqrt(3.0 / fan_in)
    return torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=gen)


def bias_uniform(gen: torch.Generator, fan_out: int) -> torch.Tensor:
    return torch.empty(1, fan_out).uniform_(-1.0, 1.0, generator=gen)
