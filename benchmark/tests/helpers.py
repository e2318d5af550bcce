"""Tiny cells on the CPU for the benchmark's tests: a cell of BENCHMARK.json
with its graph cut to a few hundred nodes, run through the harness on the
port's plain (CPU) paths."""

from __future__ import annotations

import os
import time

import torch

from benchmark.harness import runner, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 12345


TINY_ROOM = 10.0


def tiny_cell(name: str, nodes: int = 512, draws: int = 8, root: str = ROOT) -> spec.Cell:
    """The cell at ``nodes`` nodes; a partitioned one at 4,096 rows a
    partition, the port's least slab, so that every partition holds rows.
    Its limits are the cell's times :data:`TINY_ROOM`: three Adam steps on a
    few hundred rows swing more than on the cell's (a sound tiny run reads
    ``change_gap`` up to 7e-5 in float32, limits 1.2e-5-3e-5), while every
    planted fault reads 1e-2 or more."""
    cell = spec.load_cell(root, name)
    cell.limits = {k: v * TINY_ROOM for k, v in cell.limits.items()}
    parts = int(cell.config.get("parts", 1))
    cell.config["dataset"]["nodes"] = nodes if parts == 1 else 4096 * parts
    cell.traffic["draws_per_row"] = draws
    if "half_width" in cell.traffic:
        cell.traffic["half_width"] = 32
    cell.traffic["impl"] = "pattern"  # the card's bfloat16 pattern pair (and fused exchange), on the plain kernels
    return cell


def run_tiny(cell: spec.Cell, seed: int = SEED, plant=None, trace: bool = False, root: str = ROOT) -> dict:
    devices = [torch.device("cpu")] * cell.chips
    return runner.run(root, cell, seed, 0.05, trace, devices, time.perf_counter(), plant=plant)
