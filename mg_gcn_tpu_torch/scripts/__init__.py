"""Validation scripts of the port, one module each under the JAX package's
script names, run as ``python -m mg_gcn_tpu_torch.scripts.<name>``:

* ``validate_accuracy`` — GCN at Reddit scale in bf16 and int8 on the
  pattern pair, through ``train.make_scan_train_steps``; prints the
  final-accuracy gap;
* ``validate_gat`` — a 2-head GAT must separate 16 planted communities
  (accuracy > 0.95, then ``PASS``);
* ``validate_products`` — GCN at ogbn-products scale on ``impl="auto"``;
  prints the trajectory;
* ``validate_gat_headline`` — the 2-head GAT at Reddit scale; prints the
  trajectory;
* ``trajectory_parity`` — the float32 COO engine against the float64
  oracle ``tests/torch_oracle.py``, 20 epochs; writes its JSON under
  ``.bench_cache/``.

Each builds its graph with :func:`~mg_gcn_tpu_torch.sparse.planted_graph`
from a seed, takes its sizes and epochs as arguments (defaults: the JAX
script's full sizes) and ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions). Each imports torch, numpy and scipy only.
"""

from __future__ import annotations

import torch


def device_line(dev: torch.device) -> str:
    """What a validation script's numbers ran on: the card's name and count, or the CPU."""
    if dev.type == "cuda":
        return f"device: {torch.cuda.get_device_name(dev)} ({torch.cuda.device_count()} card(s))"
    return "device: cpu"
