"""Row-partitioned multi-head graph attention (GAT) over P partitions.

Port of ``mg_gcn_tpu/parallel/dist_gat.py`` (the CLI's ``--model gat -P N
-R 1``) for P partitions driven by one process or split over several
(``parallel/dist.py``'s :class:`~.dist.Ring`; several partitions may share
a card). Partition j owns row slab j of the adjacency as its P ring blocks,
its activation rows and its labels; a process builds and runs its own
partitions only. A GAT layer runs, per head, the JAX package's two ring
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
j+1's block): in one process a copy into a new buffer, which autograd
differentiates as the reverse hop; across processes ``dist._Hop``, whose
backward sends the gradients back round the ring as messages. Either way
the gradients of ``e_src`` and ``z`` travel the ring back. Gradients are
exact autograd through the attention ops (``ops/edge_attention.py``), the
partitions' local loss shares summed by ``dist._exact_loss_and_grad``.

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
from ..timers import scope
from .dist import (Ring, _exact_loss_and_grad, _ppermute, _update_replicas, column_blocks, reduce_parts, row_slab,
                   to_parts)


@dataclass(frozen=True)
class DistGatGraph:
    """Row-partitioned adjacency as P×P ring-ordered attention blocks.

    ``blocks[i][s]`` is the (EdgeTileMat, TSched) pair of block A[j, (j+s)
    % P] of this process's i-th partition j (m_loc × m_loc, rows local to
    slab j, columns local to column slab (j+s) % P) on its device. Edge values are not read: attention
    recomputes its entry weights every layer. ``ring`` is the ring it was
    built for."""

    blocks: list[list[tuple[EdgeTileMat, TSched]]]
    n: int
    parts: int
    m_loc: int
    dtype_name: str
    nnz: int
    ring: Ring

    @property
    def block_nnz(self) -> list[list[int]]:
        """Entries of each of this process's blocks, [i][s]."""
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
    """This process's partitions' P ring blocks, each built on its device
    from its row slab of the whole ``csr`` (``mg_gcn_tpu/parallel/
    dist_gat.py:97-165``; every process holds the whole graph, as the JAX
    CLI loads it, ``mg_gcn_tpu/cli.py:811-817``). Self-loops should be
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
    for j, dev in zip(mesh.local, mesh.devices):
        split = column_blocks(row_slab(csr, j, m), parts, dev)
        blocks.append([attention_block(*split[(j + s) % parts][:2], m, m, dtype) for s in range(parts)])
        del split
    return DistGatGraph(blocks=blocks, n=n, parts=parts, m_loc=m, dtype_name=dtype, nnz=csr.nnz, ring=mesh)


def _global_max(scores: Sequence[Sequence[torch.Tensor]], ring: Ring) -> list[torch.Tensor]:
    """The max of every partition's detached scores (pmax), non-finite → 0,
    on each partition's device. A partition whose blocks hold no entry
    contributes −inf."""
    local = []
    for row in scores:
        dev = row[0].device
        maxes = [torch.amax(sc.detach()) for sc in row if sc.numel()]
        local.append(torch.amax(torch.stack(maxes)) if maxes else torch.tensor(float("-inf"), device=dev))
    smax = reduce_parts(local, torch.maximum, ring)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    return to_parts(smax, ring)


def _attend_head_dist(g: DistGatGraph, zs, e_dsts, e_srcs, slope: float) -> list[torch.Tensor]:
    """Two-pass ring attention of one head over this process's partitions
    (``mg_gcn_tpu/parallel/dist_gat.py:196-258``): ``zs``, ``e_dsts`` and
    ``e_srcs`` are their (m_loc, out) and (m_loc, 1) blocks; returns their
    aggregated (m_loc, out) blocks."""
    P, L = g.parts, len(g.ring.devices)
    ones = [torch.ones((z.shape[0], 1), dtype=torch.float32, device=z.device) for z in zs]

    # pass 1: raw scores a round (kept), the source terms on the ring
    vis = list(e_srcs)
    scores = [[None] * P for _ in range(L)]
    for s in range(P):
        for i in range(L):
            mat, sched = g.blocks[i][s]
            sc = sddmm(mat, sched, torch.cat([e_dsts[i], ones[i]], dim=1), torch.cat([ones[i], vis[i]], dim=1))
            scores[i][s] = ew.leaky_relu(sc, slope)
        if s + 1 < P:
            vis = _ppermute(vis, g.ring)

    # the per-row stabilization of ops.edge_attention.slot_softmax: a clipped
    # global-shift pass estimates each row's LSE, then the normalization
    # shifts by that per-row constant
    smax = _global_max(scores, g.ring)
    lse1 = []
    for i in range(L):
        with torch.no_grad():
            rs1 = None
            for s in range(P):
                mat, sched = g.blocks[i][s]
                e1 = torch.exp(torch.clamp(scores[i][s].detach() - smax[i], -80.0, 0.0))
                prod = spmm_attn(mat, sched, e1, ones[i])
                rs1 = prod if rs1 is None else rs1 + prod
            lse1.append(smax[i] + torch.log(torch.clamp(rs1, min=1e-30)))

    log_rs = []
    for i in range(L):
        rowsum = None
        for s in range(P):
            mat, sched = g.blocks[i][s]
            shift = sddmm(mat, sched, lse1[i], ones[i]).detach()
            prod = spmm_attn(mat, sched, torch.exp(scores[i][s] - shift), ones[i])
            rowsum = prod if rowsum is None else rowsum + prod
        log_rs.append(torch.log(torch.clamp(rowsum, min=1e-30)))

    # pass 2: alpha-weighted aggregation, the projected features on the ring
    vis_z = list(zs)
    out: list = [None] * L
    for s in range(P):
        for i in range(L):
            mat, sched = g.blocks[i][s]
            shift = sddmm(mat, sched, lse1[i], ones[i]).detach()
            slot_lrs = sddmm(mat, sched, log_rs[i], ones[i])
            prod = spmm_attn(mat, sched, torch.exp(scores[i][s] - shift - slot_lrs), vis_z[i])
            out[i] = prod if out[i] is None else out[i] + prod
        if s + 1 < P:
            vis_z = _ppermute(vis_z, g.ring)
    return out


def dist_gat_forward(params, g: DistGatGraph, xs, config: GATConfig) -> list[torch.Tensor]:
    """This process's partitions' logits (``mg_gcn_tpu/parallel/
    dist_gat.py:261-282``): ``params[i]`` is the parameter tree its i-th
    partition computes with; heads (``config.heads_of``, one count a layer)
    concatenate on hidden layers and average on the output layer."""
    hs = list(xs)
    for i in range(config.num_layers):
        layers = [p[i] for p in params]
        out, H = config.sizes[i + 1], config.heads_of(i)
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
    backward pass; the gradients summed over every partition in partition
    order, on this process's first partition's device."""
    return _exact_loss_and_grad(params, lambda leaves: dist_gat_forward(leaves, g, xs, config), ys, g.n, masks,
                                g.ring)


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
    step was made for (its size and partitions). Per-layer head counts run;
    ELU and skips (``GATConfig.activation``, ``skip``) run on one card only
    and are refused."""
    if config.edge_weighted:
        raise ValueError(
            "edge-weighted GAT is single-chip only (DistGatGraph stores no "
            "edge values); drop edge_weighted or use -P 1"
        )
    if config.activation != "leaky" or config.skip:
        raise ValueError(
            "the distributed GAT step runs LeakyReLU between layers and no skip; "
            "use activation='leaky' and skip=() or -P 1"
        )
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if graph.parts != mesh.parts:
        raise ValueError(f"the graph has {graph.parts} partitions, the ring {mesh.parts}")
    hp = dict(adam.DEFAULT_HPARAMS)
    if hparams:
        hp.update(hparams)

    def step(params, opt_state, graph, xs, ys, masks=None):
        with scope("train-step"):
            per_part = [params[mesh.replica_of(i)] for i in range(len(mesh.devices))]
            loss, acc, grads = dist_gat_loss_and_grad(per_part, graph, xs, ys, config, masks)
            return (*_update_replicas(params, opt_state, grads, mesh, hp, optimizer), loss, acc)

    return step
