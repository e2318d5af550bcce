"""Column (feature-dimension, tensor) parallel GCN training over P partitions.

Port of ``mg_gcn_tpu/parallel/dist_col.py`` (the CLI's ``-P N -R 0``, the
reference's dormant column path: ``dist_dn_matrix``, dist_matrix.hpp:262-392;
``dist_linear``, gcn.hpp:298-409; ``dist_softmax``, gcn.hpp:680-721) for P
partitions driven by one process or split over several
(``parallel/dist.py``'s :class:`~.dist.Ring`; several partitions may share
a card; a process holds and runs its own partitions only):

* activations are P column shards, partition k's (n, d/P) on its device;
* the adjacency is replicated: one COO matrix (Âᵀ) for each distinct device
  of a process, which every partition on that device reads; each partition
  aggregates its own feature columns (the column path's SpMM is
  embarrassingly parallel, cuda_utils.hpp:35-45) on the COO engine, as the
  JAX package does (``dist_col.py:33``: XLA, no Pallas kernel); the
  gradient multiplies by Â, the same entries with rows and columns swapped;
* a linear layer is tensor parallel (:func:`_tp_linear`): W by input rows,
  each partition's partial product h_k W_k, output column block k the sum
  of the partitions' partial blocks in partition order (``psum_scatter``:
  an all-to-all of the blocks, ``dist.all_to_all``, then the sum on
  partition k), plus bias block k;
* the loss is the sharded softmax cross-entropy
  (:func:`_dist_col_softmax_xent`): the row max and the denominator over
  the partitions, the label's exponential from its owning shard, the first
  shard holding the row's max for the prediction.

**Gradients are the true ones.** The loss is one number: in one process
one autograd graph over all partitions ends in it; across processes every
process computes it alike from every partition's row sums and label picks
(``dist.gather_replicated``, whose backward hands each process only its own
pieces' gradients), and the all-to-all's backward sends each output
block's gradient back to its senders. So each shard's leaves (W by input
rows, b by output columns) get ∂loss/∂leaf, bit for bit the one-process
run's. The JAX step differentiates the replicated loss inside
``shard_map``, where ``psum_scatter`` and ``psum`` transpose to sums over
all devices, and its gradients come out P times the true ones (Adam's
coupled decay then acts at wd/P, SGD steps at P·lr); the port keeps the
module's contract, the single-chip exact gradient
(tests/test_torch_port_dist_col.py pins both).

Parameters and Adam's moments are sharded like their leaves
(:func:`shard_col_params`, :func:`shard_col_state`; back with
:func:`gather_col_params`, :func:`gather_col_state`, which checkpoints and
tests use); Adam's step count is replicated. Every function takes
the ring: the shards it is given are this process's partitions' only.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..models.gcn import GCNConfig
from ..nn import adam
from ..ops import elementwise as ew
from ..ops.spmm import AggPair, COOMat, aggregate
from ..timers import scope
from . import multihost
from .dist import Ring, _landed, all_to_all, fold, gather_replicated, make_mesh, reduce_parts, to_parts


def make_col_mesh(num_devices: int | None = None, devices=None) -> Ring:
    """The ring of column partitions (``mg_gcn_tpu/parallel/dist_col.py:38``):
    :func:`~.dist.make_mesh`'s rules, across processes too."""
    return make_mesh(num_devices, devices)


def dist_transpose(xs: Sequence[torch.Tensor], mesh: Ring) -> list[torch.Tensor]:
    """Distributed dense transpose (``mg_gcn_tpu/parallel/dist_col.py:45-68``,
    the reference's ``dist_dn_matrix::transpose``): the column shards ``xs``
    of an (n, d) matrix, partition k's (n, d/P), become the column shards of
    its (d, n) transpose, partition k's xᵀ[:, k·n/P : (k+1)·n/P]. One
    all-to-all of row blocks into each partition's row slab."""
    parts, n = mesh.parts, xs[0].shape[0]
    if n % parts:
        raise ValueError(f"rows ({n}) must be divisible by the mesh size ({parts})")
    m = n // parts
    got = all_to_all([[x[k * m : (k + 1) * m] for k in range(parts)] for x in xs], mesh)
    return [torch.cat(row, dim=1).T.contiguous() for row in got]  # x[my rows, :], transposed


def make_dist_transpose(mesh: Ring, parts: int):
    """``xs -> dist_transpose(xs)`` for this process's column shards on
    ``mesh`` (``mg_gcn_tpu/parallel/dist_col.py:71-81``)."""
    if parts != mesh.parts:
        raise ValueError(f"{parts} parts on a ring of {mesh.parts}")

    def transpose(xs):
        if len(xs) != len(mesh.devices):
            raise ValueError(f"{len(xs)} shards for {len(mesh.devices)} partitions")
        return dist_transpose(xs, mesh)

    return transpose


def _tp_linear(hs, ws, bs, mesh: Ring) -> list[torch.Tensor]:
    """Tensor-parallel ``XW + b`` (``mg_gcn_tpu/parallel/dist_col.py:84-91``):
    partition k's h (n, in/P) @ w (in/P, out) is a partial (n, out); output
    column block k is every partition's partial block k, summed in
    partition order on partition k's device, plus bias block k. In one
    process the blocks are read where they lie; across processes they
    travel by one all-to-all (a reduce-scatter), whose backward sends each
    output block's gradient back to every partition."""
    partials = [h @ w for h, w in zip(hs, ws)]
    c = partials[0].shape[1] // mesh.parts
    blocks = [[p[:, k * c : (k + 1) * c] for k in range(mesh.parts)] for p in partials]
    if mesh.world == 1:
        with scope("exchange"):
            for k in range(mesh.parts):
                _landed(k, [row[k] for j, row in enumerate(blocks) if j != k])
            got = [[row[k].to(b.device) for row in blocks] for k, b in enumerate(bs)]
    else:
        got = all_to_all(blocks, mesh)
    return [fold(g, torch.add) + b for g, b in zip(got, bs)]


def _dist_col_softmax_xent(logits: Sequence[torch.Tensor], ys: Sequence[torch.Tensor], n_total: int,
                           mesh: Ring):
    """Column-sharded softmax cross-entropy (``mg_gcn_tpu/parallel/
    dist_col.py:94-139``; gcn.hpp:690-721): ``logits[i]`` this process's
    i-th partition k's (n, c/P) shard, ``ys[i]`` the labels on its device.
    The row max (no gradient) over the partitions; each partition's row
    sums of exp(logit − max) and its pick of the label's term (zero where
    another shard owns the label); the denominator and the label's term
    the sums of every partition's, in partition order, their quotient the
    label's probability; the prediction the first shard's column holding
    the row's max (cuda_utils.cu:120-133). Returns (loss, acc) on the first
    partition's device, the same on every process."""
    c_loc = logits[0].shape[1]
    row_max = reduce_parts([torch.amax(lg.detach(), dim=1) for lg in logits], torch.maximum, mesh)
    es = [torch.exp(lg - rm[:, None]) for lg, rm in zip(logits, to_parts(row_max, mesh))]
    sums, picks = [], []
    for k, e, y in zip(mesh.local, es, ys):
        local = y.long() - k * c_loc
        in_shard = (local >= 0) & (local < c_loc)
        p = torch.gather(e, 1, torch.clamp(local, 0, c_loc - 1)[:, None])[:, 0]
        sums.append(torch.sum(e, dim=1))
        picks.append(torch.where(in_shard, p, torch.zeros_like(p)))
    with scope("psum"):
        if mesh.world == 1:  # across processes the gathers count what arrives
            _landed(mesh.first, sums[:1] + picks[:1], mesh.parts - 1)
        denom = fold(gather_replicated(sums, mesh), torch.add)
        p_label = fold(gather_replicated(picks, mesh), torch.add) / denom
    logp = torch.log(torch.clamp(p_label, min=torch.finfo(p_label.dtype).tiny))

    # accuracy only: the first shard holding the row's max wins
    os_ = [e.detach() / dn[:, None] for e, dn in zip(es, to_parts(denom.detach(), mesh))]
    local_max = [torch.amax(o, dim=1) for o in os_]
    gmax = reduce_parts(local_max, torch.maximum, mesh)
    cands = [torch.where(lm == gm, torch.argmax(o, dim=1) + k * c_loc, 2**30)
             for k, o, lm, gm in zip(mesh.local, os_, local_max, to_parts(gmax, mesh))]
    pred = reduce_parts(cands, torch.minimum, mesh)
    correct = (pred == ys[0].long().to(pred.device)).to(logp.dtype)
    return -torch.sum(logp) / n_total, torch.sum(correct) / n_total


def col_loss_fn(params, mats: Sequence[AggPair], xs, ys, config: GCNConfig, n_total: int, mesh: Ring):
    """Forward and loss over this process's partitions (``mg_gcn_tpu/
    parallel/dist_col.py:142-160``), differentiable: ``params[i]`` its i-th
    partition's shards, ``mats[i]`` the (Âᵀ, Â) COO pair on its device.
    Each layer in ``layer_meta``'s order, LeakyReLU between layers."""
    hs = list(xs)
    for i in range(config.num_layers):
        meta = config.layer_meta(i)
        ws, bs = [p[i]["W"] for p in params], [p[i]["b"] for p in params]
        if meta["lin_first"]:
            hs = [aggregate(mat, hw) for mat, hw in zip(mats, _tp_linear(hs, ws, bs, mesh))]
        else:
            hs = _tp_linear([aggregate(mat, h) for mat, h in zip(mats, hs)], ws, bs, mesh)
        if meta["activation"]:
            hs = [ew.leaky_relu(h, config.leaky_slope) for h in hs]
    return _dist_col_softmax_xent(hs, ys, n_total, mesh)


def col_loss_and_grad(params, mats, xs, ys, config: GCNConfig, n_total: int, mesh: Ring):
    """(loss, acc, grads): one backward pass from the one loss through every
    partition (across processes, each process's from its copy of the loss,
    the all-to-alls' backwards meeting between them); ``grads[i]`` is the
    gradient of this process's i-th partition's shards."""
    leaves = [[{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in p] for p in params]
    with torch.enable_grad():
        loss, acc = col_loss_fn(leaves, mats, xs, ys, config, n_total, mesh)
        flat = [v for p in leaves for layer in p for v in layer.values()]
        flat_grads = iter(torch.autograd.grad(loss, flat))
    grads = [[{k: next(flat_grads) for k in layer} for layer in p] for p in leaves]
    return loss.detach(), acc, grads


def make_col_train_step(
    config: GCNConfig,
    mesh: Ring,
    n_total: int,
    hparams: dict | None = None,
    optimizer: str = "adam",
):
    """The tensor-parallel train step (``mg_gcn_tpu/parallel/dist_col.py:
    163-241``):

        step(params, opt_state, mats, xs, ys) -> (params, opt_state, loss, acc)

    ``params`` / ``opt_state`` are :func:`shard_col_params` /
    :func:`shard_col_state`'s lists, one per partition of this process,
    returned updated; ``mats`` is :func:`replicate_coo`'s list; ``xs`` the
    feature column shards (:func:`shard_columns`); ``ys`` the labels, one
    copy per partition of this process. Every width must divide by P (the reference rounds the last
    width up for the same reason, main.cpp:135). Exact gradients, the true
    ones (see the module docstring); loss and acc lie on the first
    partition's device."""
    if config.residual:
        raise NotImplementedError(
            "the column/tensor-parallel path does not implement residual "
            "connections; use the row-partitioned path (-R 1)"
        )
    if config.loss_mask != "all":
        raise NotImplementedError(
            "the column/tensor-parallel path computes loss over all rows "
            "(reference semantics); --mask-train needs the row path (-R 1)"
        )
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    hp = dict(adam.DEFAULT_HPARAMS)
    if hparams:
        hp.update(hparams)
    parts = mesh.parts
    for s in config.sizes:
        if s % parts:
            raise ValueError(f"column-parallel needs widths divisible by P; got {s} % {parts}")

    def step(params, opt_state, mats, xs, ys):
        with scope("train-step"):
            loss, acc, grads = col_loss_and_grad(params, mats, xs, ys, config, n_total, mesh)
            new_params, new_state = [], []
            with torch.no_grad():
                for p, st, g in zip(params, opt_state, grads):
                    if optimizer == "sgd":  # the state rides unchanged
                        p = adam.sgd_update(p, g, hp["lr"], hp["weight_decay"])
                    else:
                        p, st = adam.adam_update(p, g, st, **hp)
                    new_params.append(p)
                    new_state.append(st)
        return new_params, new_state, loss, acc

    return step


# ---------------------------------------------------------------------------
# placing the operands


def replicate_coo(mat: COOMat, mesh: Ring) -> list[AggPair]:
    """The COO matrix Âᵀ as the (Âᵀ, Â) aggregation pair, held once for
    each distinct device of this process's partitions (Â is Âᵀ's entries
    with rows and columns swapped: the COO engine needs no sorted rows);
    returns one pair a partition, partitions on one device sharing it."""
    pairs = []
    for dev in mesh.replica_devices:
        fwd = COOMat(rows=mat.rows.to(dev), cols=mat.cols.to(dev), vals=mat.vals.to(dev), n_rows=mat.n_rows,
                     n_cols=mat.n_cols, nnz=mat.nnz)
        pairs.append(AggPair(fwd=fwd, bwd=COOMat(rows=fwd.cols, cols=fwd.rows, vals=fwd.vals, n_rows=mat.n_cols,
                                                 n_cols=mat.n_rows, nnz=mat.nnz)))
    return [pairs[mesh.replica_of(i)] for i in range(len(mesh.devices))]


def shard_columns(x, mesh: Ring) -> list[torch.Tensor]:
    """Split the last axis of ``x`` (numpy array or tensor) into P equal
    column blocks: this process's partitions' blocks, each on its device."""
    t = torch.as_tensor(x)
    if t.shape[-1] % mesh.parts:
        raise ValueError(f"{t.shape[-1]} columns do not split into {mesh.parts} equal partitions")
    c = t.shape[-1] // mesh.parts
    return [t[..., k * c : (k + 1) * c].contiguous().to(dev) for k, dev in zip(mesh.local, mesh.devices)]


def _shard_axis(key: str) -> int:
    """W leaves split by input rows, biases by output columns."""
    return 0 if key.startswith("W") else -1


def shard_col_params(params, mesh: Ring) -> list[list[dict]]:
    """Full parameter tree -> one tree of shards for each of this process's
    partitions, on its device."""
    shards = [[{} for _ in params] for _ in mesh.devices]
    for i, layer in enumerate(params):
        for key, t in layer.items():
            if t.shape[_shard_axis(key)] % mesh.parts:
                raise ValueError(f"layer {i} {key} {tuple(t.shape)} does not split into {mesh.parts} shards")
            parts = torch.chunk(t, mesh.parts, dim=_shard_axis(key))
            for s, k, dev in zip(shards, mesh.local, mesh.devices):
                s[i][key] = parts[k].contiguous().to(dev)
    return shards


def gather_col_params(shards, mesh: Ring) -> list[dict]:
    """:func:`shard_col_params`'s shards -> the full tree, on the first
    partition's device. Across processes every process gathers every
    partition's shards (one gather a leaf, the same calls on every
    process) and gets the full tree."""
    dev = next(iter(shards[0][0].values())).device

    def every(leaves):
        return multihost.all_gather_parts(leaves) if mesh.world > 1 else [t.to(dev) for t in leaves]

    return [{key: torch.cat(every([s[i][key] for s in shards]), dim=_shard_axis(key)) for key in layer}
            for i, layer in enumerate(shards[0])]


def shard_col_state(state: adam.AdamState, mesh: Ring) -> list[adam.AdamState]:
    """An AdamState of full trees -> one for each of this process's
    partitions: moments sharded like their leaves, the step count
    replicated."""
    ms, vs = shard_col_params(state.m, mesh), shard_col_params(state.v, mesh)
    return [adam.AdamState(step=state.step.to(dev), m=m, v=v) for dev, m, v in zip(mesh.devices, ms, vs)]


def gather_col_state(states: Sequence[adam.AdamState], mesh: Ring) -> adam.AdamState:
    """:func:`shard_col_state`'s states -> one AdamState of full trees (across
    processes on every process, as :func:`gather_col_params`)."""
    return adam.AdamState(step=states[0].step, m=gather_col_params([s.m for s in states], mesh),
                          v=gather_col_params([s.v for s in states], mesh))
