"""PageRank power iteration (parity with the reference ``pagerank.hpp``) —
BASELINE.md config 5.

Port of ``mg_gcn_tpu/models/pagerank.py``. The reference builds a 1-wide
GCN layer with W=[damping], b=[1-damping] on the transposed row-normalized
adjacency and iterates until the L∞ change drops below eps, then rescales
to mean 1 (pagerank.hpp:13-42). The teleport term rides *through* the
aggregation (the layer adds the bias before the SpMM):
p' = Mᵀ(d·p + (1-d)·1), M the row-stochastic matrix.

The stopping rule is the reference's: the result is the first iterate
whose L∞ change is below eps, or the ``max_iters``-th. The JAX package
runs 8 iterations a dispatch and picks the crossing on the host, a
workaround for its TPU's host link (``pagerank.py:10-19``); here each
iteration reads its change from the card, one scalar against an SpMV.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device, sparse
from ..formats import CSRData
from ..ops import spmm_pattern as sp
from ..ops.spmm import COOMat, spmm
from ..ops.spmm_edges import edge_tile_mat_from_csr
from ..ops.spmm_gather import gather_mat_from_csr

IMPLS = ("auto", "pattern", "edge", "gather", "xla")


def _pagerank_mat(graph: CSRData, impl: str = "auto", device: str | torch.device = "cuda"):
    """The iteration matrix M = (row-normalized A)ᵀ as a device sparse
    operator (``mg_gcn_tpu/models/pagerank.py:33-90``):

      "pattern" — the float32 bit-packed pattern with a pre-scale,
                  M p = Pᵀ (diag(1/outdeg) p): one PatternMat "PT", "pre"
                  (binary adjacency only), its pack built on the device;
      "gather"  — for a binary adjacency the w-less walk over Aᵀ with a
                  pre-scale of 1/max(outdeg, 1); else the weighted walk;
      "edge"    — the edge engine in float32;
      "xla"     — the COO engine;
      "auto"    — ``train.mean_engine``, SAGE's rule.

    A build that cannot run raises: where the JAX package falls back to
    its COO engine, the port does not."""
    from ..train import mean_engine

    if impl not in IMPLS:
        raise ValueError(f"unknown PageRank impl {impl!r} (expected {'/'.join(IMPLS)})")
    dev = resolve_device(device)
    if impl == "auto":
        impl = mean_engine(graph, dev)
    binary = sp.is_binary(graph)
    if impl == "pattern":
        if not binary:
            raise ValueError("pattern SpMM needs a binary adjacency (data == 1)")
        n = graph.nrows
        n_pad = sp.round_up(n, sp.N_ALIGN)
        pack = sp.pack_bits_on_device(graph, n_pad, dev)
        scale = torch.from_numpy(sp.row_scale(graph, n_pad)).to(dev)
        return sp.PatternMat(pack, scale, n, n_pad, graph.nnz, "PT", "pre", "float32")
    if impl == "gather" and binary:
        outdeg = np.diff(graph.indptr).astype(np.float32)
        return gather_mat_from_csr(sparse.transpose(graph), device=dev, scale=1.0 / np.maximum(outdeg, 1.0),
                                   scale_side="pre")
    a_t = sparse.transpose(sparse.normalize(graph, axis=False))  # row-stochastic, transposed
    if impl == "gather":
        return gather_mat_from_csr(a_t, device=dev)
    if impl == "edge":
        return edge_tile_mat_from_csr(a_t, dtype="float32", device=dev)
    return COOMat.from_csr(a_t, device=dev)


def power_iterate(
    mat, n: int, damping: float = 0.85, eps: float = 1e-4, max_iters: int = 1000
) -> tuple[torch.Tensor, int]:
    """``(p, iters)`` for any device sparse operator ``mat`` of n rows and
    columns: ``p`` (n,) float32 on the operator's device is the first
    iterate whose L∞ change from the one before is below eps (float32
    compare; do-while, pagerank.hpp:28-34), or the ``max_iters``-th."""
    dev = next(v.device for v in vars(mat).values() if isinstance(v, torch.Tensor))
    p = torch.ones((n, 1), dtype=torch.float32, device=dev)
    it = 0
    for it in range(1, max_iters + 1):
        p_new = spmm(mat, damping * p + (1.0 - damping))
        err = torch.max(torch.abs(p_new - p))
        p = p_new
        if bool(err < eps):
            break
    return p.reshape(-1), it


def pagerank(
    graph: CSRData,
    damping: float = 0.85,
    eps: float = 1e-4,
    max_iters: int = 1000,
    impl: str = "auto",
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The mean-1-normalized PageRank vector (n,), float32 on ``device``."""
    mat = _pagerank_mat(graph, impl, device)
    n = graph.nrows
    p, _ = power_iterate(mat, n, damping, eps, max_iters)
    return p * (n / p.sum())


def dist_pagerank_mat(graph: CSRData, mesh):
    """The row-partitioned iteration matrix M = (row-normalized A)ᵀ as the
    COO ring blocks of ``parallel.dist.DistRowMat`` on the partitions of
    ``mesh`` (a ``parallel.dist.Ring``), built on the host; ``n % P`` is
    enforced by ``DistRowMat.from_csr``."""
    from ..parallel import dist

    return dist.DistRowMat.from_csr(sparse.transpose(sparse.normalize(graph, axis=False)), mesh)


def power_iterate_dist(
    dmat, damping: float = 0.85, eps: float = 1e-4, max_iters: int = 1000, strategy: str = "ring"
) -> tuple[list[torch.Tensor], int]:
    """``(p, iters)`` on the partitions of ``dmat``
    (``mg_gcn_tpu/models/pagerank.py:180-196``): the products run on
    ``dist_aggregate`` (``strategy`` ring or all_gather); the loop starts
    from the first iterate with it = 1 and goes on while the largest L∞
    change over the partitions is at least eps and it < max_iters. ``p`` is
    each partition's (n/P, 1) float32 block on its device."""
    from ..parallel import dist

    def step(ps):
        return dist.dist_aggregate(dmat, [damping * p + (1.0 - damping) for p in ps], strategy)

    prev = [torch.ones((dmat.rows_per_shard, 1), dtype=torch.float32, device=r.device) for r in dmat.rows]
    p, it = step(prev), 1
    while it < max_iters:
        err = dist.reduce_parts([torch.max(torch.abs(a - b)) for a, b in zip(p, prev)], torch.maximum)
        if not bool(err >= eps):
            break
        prev, p, it = p, step(p), it + 1
    return p, it


def pagerank_dist(
    graph: CSRData,
    mesh,
    damping: float = 0.85,
    eps: float = 1e-4,
    max_iters: int = 1000,
    strategy: str = "ring",
) -> torch.Tensor:
    """Row-partitioned PageRank over the partitions of ``mesh`` (BASELINE
    config 5; ``mg_gcn_tpu/models/pagerank.py:157-209``): each partition
    owns a row slab of M and of p (:func:`dist_pagerank_mat`,
    :func:`power_iterate_dist`). Returns (n,) float32 on the first
    partition's device, rescaled by the total to mean 1."""
    from ..parallel import dist

    p, _ = power_iterate_dist(dist_pagerank_mat(graph, mesh), damping, eps, max_iters, strategy)
    total = dist.reduce_parts([torch.sum(x) for x in p], torch.add)
    out = p[0].device
    return torch.cat([(x * (graph.nrows / total.to(x.device))).reshape(-1).to(out) for x in p])
