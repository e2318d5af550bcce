"""Row-partitioned multi-head graph attention (GAT) over P partitions.

Port of ``mg_gcn_tpu/parallel/dist_gat.py`` (the CLI's ``--model gat -P N
-R 1``) for P partitions driven by one process (``parallel/dist.py``'s
:class:`~.dist.Ring`; several partitions may share a card). Partition j
owns row slab j of the adjacency as its P ring blocks, its activation rows
and its labels. A GAT layer runs, per head, the JAX package's two ring
passes (``dist_gat.py:196-258``), pass for pass:

1. **scores** — the source terms ``e_src`` go round the ring; in round s
   partition j scores its block A[j, (j+s) % P] by a d = 2 SDDMM of
   ``[e_dst, 1]·[1, e_src]`` and keeps the (LeakyReLU'd) scores, one per
   stored entry in CSR entry order;
2. **normalization** — the global max of the scores (a max over the
   partitions of detached values; −inf for a partition whose blocks hold no
   entry, non-finite → 0), the clipped ``rs1`` pass at d = 1 and its
   detached ``lse1``, the ``rowsum`` pass under the per-row shift (a d = 1
   SDDMM broadcast of ``lse1``), ``log_rs``; all row sums are row-local;
3. **aggregation** — the projected features ``z`` go round the ring; in
   round s partition j adds ``spmm_attn(alpha, z)`` over the same block,
   ``alpha = exp(s − shift − log_rs[r])`` with ``log_rs`` broadcast by a
   d = 1 SDDMM.

The ring hop is :func:`~.dist._ppermute` (partition j receives partition
j+1's block): a copy into a new buffer, which autograd differentiates as
the reverse hop, so the gradients of ``e_src`` and ``z`` travel the ring
back. Gradients are exact autograd through the attention ops
(``ops/edge_attention.py``), the partitions' local loss shares summed by
``dist._exact_loss_and_grad``.

Each block is the port's attention pair ``(EdgeTileMat, TSched)``, built on
its partition's device: row-sorted CSR of the block's real entries, every
entry kept (duplicates too, as ``build_attention_graph(merge=False)``), the
transpose a stable sort by column. The TPU's shared geometry has no
counterpart: no common ``br``/``paired``, no ``pad_edge_schedule``, no
padded ``S2``, no ``slot_valid_mask`` — every entry is an edge. A block
with no entry is an empty CSR matrix: its SDDMMs score nothing and its
products are zero, launching no kernel. The JAX package's ``graph_arrays``
(the stacked slot arrays a ``shard_map`` step takes) has no counterpart:
the step takes the :class:`DistGatGraph` itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..formats import CSRData
from ..models.gat import GATConfig
from ..nn import adam
from ..ops import elementwise as ew
from ..ops.edge_attention import sddmm, spmm_attn
from ..ops.spmm_edges import DTYPES, EdgeTileMat, TSched, transposed_schedule
from .dist import Ring, _exact_loss_and_grad, _ppermute, _update_replicas, column_blocks, reduce_parts, row_slab


@dataclass(frozen=True)
class DistGatGraph:
    """Row-partitioned adjacency as P×P ring-ordered attention blocks.

    ``blocks[j][s]`` is the (EdgeTileMat, TSched) pair of block A[j, (j+s)
    % P] (m_loc × m_loc, rows local to slab j, columns local to column slab
    (j+s) % P) on partition j's device. Edge values are not read: attention
    recomputes its entry weights every layer."""

    blocks: list[list[tuple[EdgeTileMat, TSched]]]
    n: int
    parts: int
    m_loc: int
    dtype_name: str
    nnz: int

    @property
    def block_nnz(self) -> list[list[int]]:
        """Entries of each block, [j][s]."""
        return [[mat.nnz for mat, _ in row] for row in self.blocks]


def attention_block(rows: torch.Tensor, cols: torch.Tensor, n_out: int, n_in: int,
                    dtype: str) -> tuple[EdgeTileMat, TSched]:
    """The attention pair of one block from its row-sorted entries (rows and
    columns local to the block, on one device): CSR structure, no stored
    weights, and its transpose."""
    dev = rows.device
    indptr = torch.zeros(n_out + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(rows, minlength=n_out), 0, out=indptr[1:])
    mat = EdgeTileMat(indptr=indptr, indices=cols.to(torch.int32).contiguous(), w=None, wq=None, row_scale=None,
                      n_out=n_out, n_in=n_in, nnz=rows.numel(), dtype_name=dtype)
    return mat, transposed_schedule(mat)


def build_dist_gat_graph(csr: CSRData, mesh: Ring, dtype: str = "bfloat16") -> DistGatGraph:
    """Partition j's P ring blocks, built on its device from its row slab
    (``mg_gcn_tpu/parallel/dist_gat.py:97-165``). Self-loops should be
    present (prep adds them), so that every node attends to itself."""
    n, parts = csr.nrows, mesh.parts
    if n % parts:
        raise ValueError(
            f"n ({n}) must be divisible by the mesh size ({parts}); pad the "
            "dataset (dist_matrix.hpp:428 semantics)"
        )
    if dtype not in DTYPES:
        raise ValueError(f"unsupported edge dtype {dtype!r} (expected {'/'.join(DTYPES)})")
    m = n // parts
    blocks = []
    for j, dev in enumerate(mesh.devices):
        split = column_blocks(row_slab(csr, j, m), parts, dev)
        blocks.append([attention_block(*split[(j + s) % parts][:2], m, m, dtype) for s in range(parts)])
        del split
    return DistGatGraph(blocks=blocks, n=n, parts=parts, m_loc=m, dtype_name=dtype, nnz=csr.nnz)


def _global_max(scores: Sequence[Sequence[torch.Tensor]]) -> list[torch.Tensor]:
    """The max of every partition's detached scores (pmax), non-finite → 0,
    on each partition's device. A partition whose blocks hold no entry
    contributes −inf."""
    local = []
    for row in scores:
        dev = row[0].device
        maxes = [torch.amax(sc.detach()) for sc in row if sc.numel()]
        local.append(torch.amax(torch.stack(maxes)) if maxes else torch.tensor(float("-inf"), device=dev))
    smax = reduce_parts(local, torch.maximum)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    return [smax.to(row[0].device) for row in scores]


def _attend_head_dist(g: DistGatGraph, zs, e_dsts, e_srcs, slope: float) -> list[torch.Tensor]:
    """Two-pass ring attention of one head over every partition
    (``mg_gcn_tpu/parallel/dist_gat.py:196-258``): ``zs``, ``e_dsts`` and
    ``e_srcs`` are the partitions' (m_loc, out) and (m_loc, 1) blocks;
    returns the partitions' aggregated (m_loc, out) blocks."""
    P = g.parts
    ones = [torch.ones((z.shape[0], 1), dtype=torch.float32, device=z.device) for z in zs]

    # pass 1: raw scores a round (kept), the source terms on the ring
    vis = list(e_srcs)
    scores = [[None] * P for _ in range(P)]
    for s in range(P):
        for j in range(P):
            mat, sched = g.blocks[j][s]
            sc = sddmm(mat, sched, torch.cat([e_dsts[j], ones[j]], dim=1), torch.cat([ones[j], vis[j]], dim=1))
            scores[j][s] = ew.leaky_relu(sc, slope)
        if s + 1 < P:
            vis = _ppermute(vis)

    # the per-row stabilization of ops.edge_attention.slot_softmax: a clipped
    # global-shift pass estimates each row's LSE, then the normalization
    # shifts by that per-row constant
    smax = _global_max(scores)
    lse1 = []
    for j in range(P):
        with torch.no_grad():
            rs1 = None
            for s in range(P):
                mat, sched = g.blocks[j][s]
                e1 = torch.exp(torch.clamp(scores[j][s].detach() - smax[j], -80.0, 0.0))
                prod = spmm_attn(mat, sched, e1, ones[j])
                rs1 = prod if rs1 is None else rs1 + prod
            lse1.append(smax[j] + torch.log(torch.clamp(rs1, min=1e-30)))

    log_rs = []
    for j in range(P):
        rowsum = None
        for s in range(P):
            mat, sched = g.blocks[j][s]
            shift = sddmm(mat, sched, lse1[j], ones[j]).detach()
            prod = spmm_attn(mat, sched, torch.exp(scores[j][s] - shift), ones[j])
            rowsum = prod if rowsum is None else rowsum + prod
        log_rs.append(torch.log(torch.clamp(rowsum, min=1e-30)))

    # pass 2: alpha-weighted aggregation, the projected features on the ring
    vis_z = list(zs)
    out: list = [None] * P
    for s in range(P):
        for j in range(P):
            mat, sched = g.blocks[j][s]
            shift = sddmm(mat, sched, lse1[j], ones[j]).detach()
            slot_lrs = sddmm(mat, sched, log_rs[j], ones[j])
            prod = spmm_attn(mat, sched, torch.exp(scores[j][s] - shift - slot_lrs), vis_z[j])
            out[j] = prod if out[j] is None else out[j] + prod
        if s + 1 < P:
            vis_z = _ppermute(vis_z)
    return out


def dist_gat_forward(params, g: DistGatGraph, xs, config: GATConfig) -> list[torch.Tensor]:
    """The partitions' logits (``mg_gcn_tpu/parallel/dist_gat.py:261-282``):
    ``params[j]`` is the parameter tree partition j computes with; heads
    concatenate on hidden layers and average on the output layer."""
    hs = list(xs)
    H = config.heads
    for i in range(config.num_layers):
        layers = [p[i] for p in params]
        out = config.sizes[i + 1]
        zs = [h @ lp["W"] for h, lp in zip(hs, layers)]
        heads = []
        for hd in range(H):
            zh = [z[:, hd * out : (hd + 1) * out] for z in zs]
            e_dst = [z @ lp["a_dst"][hd][:, None] for z, lp in zip(zh, layers)]
            e_src = [z @ lp["a_src"][hd][:, None] for z, lp in zip(zh, layers)]
            heads.append(_attend_head_dist(g, zh, e_dst, e_src, config.att_slope))
        if i + 1 < config.num_layers:
            hs = [ew.leaky_relu(torch.cat([hd[j] for hd in heads], dim=1) + lp["b"], config.leaky_slope)
                  for j, lp in enumerate(layers)]
        else:
            hs = [sum(hd[j] for hd in heads) / H + lp["b"] for j, lp in enumerate(layers)]
    return hs


def dist_gat_loss_and_grad(params, g: DistGatGraph, xs, ys, config: GATConfig, masks=None):
    """(loss, acc, grads) of the partitions' summed local loss shares by one
    backward pass; the gradients summed over the partitions in partition
    order, on the first partition's device."""
    return _exact_loss_and_grad(params, lambda leaves: dist_gat_forward(leaves, g, xs, config), ys, g.n, masks)


def make_dist_gat_train_step(
    config: GATConfig,
    mesh: Ring,
    graph: DistGatGraph,
    hparams: dict | None = None,
    optimizer: str = "adam",
):
    """The distributed GAT train step (``mg_gcn_tpu/parallel/dist_gat.py:
    285-361``):

        step(params, opt_state, graph, xs, ys, masks=None)
            -> (params, opt_state, loss, acc)

    ``params`` and ``opt_state`` are :func:`~.dist.replicate`'s lists, one
    copy per distinct device, returned updated alike (Adam, or SGD);
    ``xs`` / ``ys`` / ``masks`` are :func:`~.dist.shard`'s lists, ``masks``
    None when every row counts. ``graph`` is the :class:`DistGatGraph` the
    step was made for (its size and partitions)."""
    if config.edge_weighted:
        raise ValueError(
            "edge-weighted GAT is single-chip only (DistGatGraph stores no "
            "edge values); drop edge_weighted or use -P 1"
        )
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if graph.parts != mesh.parts:
        raise ValueError(f"the graph has {graph.parts} partitions, the ring {mesh.parts}")
    hp = dict(adam.DEFAULT_HPARAMS)
    if hparams:
        hp.update(hparams)

    def step(params, opt_state, graph, xs, ys, masks=None):
        per_part = [params[mesh.replica_of(j)] for j in range(mesh.parts)]
        loss, acc, grads = dist_gat_loss_and_grad(per_part, graph, xs, ys, config, masks)
        return (*_update_replicas(params, opt_state, grads, mesh, hp, optimizer), loss, acc)

    return step
