"""Initial parameters made on the device from the seed, and their forms:
the benchmark's flat {"<layer>.<key>": tensor} and the port's list of one
dict a layer."""

from __future__ import annotations

import math

import torch

LEAKY_GAIN = math.sqrt(2.0 / (1.0 + 0.01 * 0.01))


def weight_bound(fan_in: int) -> float:
    """Kaiming-uniform with the LeakyReLU gain, as MG-GCN's dn_matrix::init
    (matrix.hpp:539-545)."""
    return LEAKY_GAIN * math.sqrt(3.0 / fan_in)


def init_params(leaves, seed: int, device: torch.device) -> dict:
    """``leaves`` is [(name, shape, bound)]: each leaf uniform in
    [-bound, bound], all drawn in one call from a generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    out = {}
    for (name, shape, bound), part in zip(leaves, torch.split(flat, sizes)):
        out[name] = (part * bound).reshape(shape).contiguous()
    return out


def to_layers(flat: dict) -> list:
    layers: dict = {}
    for name, t in flat.items():
        i, key = name.split(".", 1)
        layers.setdefault(int(i), {})[key] = t
    return [layers[i] for i in sorted(layers)]


def flatten(layers) -> dict:
    return {f"{i}.{k}": t for i, layer in enumerate(layers) for k, t in layer.items()}
