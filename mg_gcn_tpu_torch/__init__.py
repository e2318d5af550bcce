"""mg_gcn_tpu_torch — the PyTorch/CUDA port of mg_gcn_tpu, for NVIDIA Hopper.

Full-batch GCN, GraphSAGE (``models/sage.py``) and GAT training on one
card, row-partitioned GCN, GraphSAGE and GAT training over P partitions
driven by one process (``parallel/dist.py``, the halo exchange of
``parallel/dist_halo.py``, ``parallel/dist_gat.py``, the CLI's ``-P N -R
1``; partitions may share a card), column-parallel GCN
(``parallel/dist_col.py``, the CLI's ``-P N -R 0``), PageRank on one card or row-partitioned (``models/pagerank.py``, the
CLI's ``pagerank``) and inference from a checkpoint (the CLI's ``infer``).
SAGE's mean aggregation and PageRank's iteration run on the same engines
as GCN's, with the row-normalized operator. The aggregation
engines — the bit-packed dense-pattern pair (``ops/spmm_pattern.py``), its
ring form for the partitions (``ops/spmm_pattern_ring.py``), its
block-sparse form for clustered graphs (``ops/spmm_pattern_sparse.py``),
the weighted-CSR edge engine (``ops/spmm_edges.py``), the serial-gather
engine (``ops/spmm_gather.py``) and the tiled-ELL debug engine
(``ops/spmm_pallas.py``) — and the attention stack (``ops/sddmm.py``, the
transposed edge product, ``ops/edge_attention.py``, ``models/gat.py``) run
on hand-written CUDA kernels (``csrc/``, built with nvcc at first use).
``python -m mg_gcn_tpu_torch.data.prep`` writes datasets (toy, synthetic,
DGL/OGB where installed) and reorders one for locality (``cluster``).
Module names mirror the JAX package so each counterpart is easy to find;
the JAX package is the reference the tests hold this port against.

The port imports torch, numpy and scipy only — never jax, never mg_gcn_tpu.
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; with no CUDA device they raise rather than fall back.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. A CUDA request with no CUDA device
    raises: the port never falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
