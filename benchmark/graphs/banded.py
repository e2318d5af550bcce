"""Banded graph: ``draws_per_row`` edges from every row to columns drawn
uniformly in row ± half_width and clipped to [0, n), repeats merged, binary,
no self loops added: a locality-ordered graph, as a reordering (RCM,
METIS) leaves one."""

from __future__ import annotations

import torch

from benchmark.harness.graph import Graph, merge


def make(n: int, params: dict, seed: int, device: torch.device) -> Graph:
    gen = torch.Generator(device=device).manual_seed(seed)
    draws, half = int(params["draws_per_row"]), int(params["half_width"])
    src = torch.arange(n, device=device).repeat_interleave(draws)
    offset = torch.randint(-half, half + 1, (src.numel(),), generator=gen, device=device)
    dst = torch.clamp(src + offset, 0, n - 1)
    del offset
    return merge(n, src, dst)
