"""Uniform random graph: n·draws_per_row edges whose two ends are drawn
uniformly, a self loop on every node when ``self_loops``, repeats merged.
No locality: every row's columns spread over the whole graph, as on the
randomly permuted Reddit that MG-GCN trains on."""

from __future__ import annotations

import torch

from benchmark.harness.graph import Graph, merge


def make(n: int, params: dict, seed: int, device: torch.device) -> Graph:
    gen = torch.Generator(device=device).manual_seed(seed)
    edges = int(n * params["draws_per_row"])
    src = torch.randint(0, n, (edges,), generator=gen, device=device)
    dst = torch.randint(0, n, (edges,), generator=gen, device=device)
    if params["self_loops"]:
        loops = torch.arange(n, device=device)
        src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
    return merge(n, src, dst)
