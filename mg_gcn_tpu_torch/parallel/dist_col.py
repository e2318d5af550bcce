"""Column (feature-dimension, tensor) parallel GCN training over P partitions.

Port of ``mg_gcn_tpu/parallel/dist_col.py`` (the CLI's ``-P N -R 0``, the
reference's dormant column path: ``dist_dn_matrix``, dist_matrix.hpp:262-392;
``dist_linear``, gcn.hpp:298-409; ``dist_softmax``, gcn.hpp:680-721) for P
partitions driven by one process (``parallel/dist.py``'s
:class:`~.dist.Ring`; several partitions may share a card):

* activations are P column shards, partition k's (n, d/P) on its device;
* the adjacency is replicated: one COO matrix (Âᵀ) for each distinct device
  of the ring, which every partition on that device reads; each partition
  aggregates its own feature columns (the column path's SpMM is
  embarrassingly parallel, cuda_utils.hpp:35-45) on the COO engine, as the
  JAX package does (``dist_col.py:33``: XLA, no Pallas kernel); the
  gradient multiplies by Â, the same entries with rows and columns swapped;
* a linear layer is tensor parallel (:func:`_tp_linear`): W by input rows,
  each partition's partial product h_k W_k, output column block k the sum
  of the partitions' partial blocks in partition order (``psum_scatter``),
  plus bias block k;
* the loss is the sharded softmax cross-entropy
  (:func:`_dist_col_softmax_xent`): the row max and the denominator over
  the partitions, the label's probability from its owning shard, the first
  shard holding the row's max for the prediction.

**Gradients are the true ones.** The step builds one autograd graph over
all partitions, ending in the one loss, so each shard's leaves (W by input
rows, b by output columns) get ∂loss/∂leaf. The JAX step differentiates
the replicated loss inside ``shard_map``, where ``psum_scatter`` and
``psum`` transpose to sums over all devices, and its gradients come out P
times the true ones (Adam's coupled decay then acts at wd/P, SGD steps at
P·lr); the port keeps the module's contract, the single-chip exact
gradient (tests/test_torch_port_dist_col.py pins both).

Parameters and Adam's moments are sharded like their leaves
(:func:`shard_col_params`, :func:`shard_col_state`; back with
:func:`gather_col_params`, :func:`gather_col_state`, which checkpoints and
tests use); Adam's step count is replicated.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..models.gcn import GCNConfig
from ..nn import adam
from ..ops import elementwise as ew
from ..ops.spmm import AggPair, COOMat, aggregate
from .dist import Ring, _copy_to, make_mesh, reduce_parts


def make_col_mesh(num_devices: int | None = None, devices=None) -> Ring:
    """The ring of column partitions (``mg_gcn_tpu/parallel/dist_col.py:38``):
    :func:`~.dist.make_mesh`'s rules."""
    return make_mesh(num_devices, devices)


def dist_transpose(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Distributed dense transpose (``mg_gcn_tpu/parallel/dist_col.py:45-68``,
    the reference's ``dist_dn_matrix::transpose``): the column shards ``xs``
    of an (n, d) matrix, partition k's (n, d/P), become the column shards of
    its (d, n) transpose, partition k's xᵀ[:, k·n/P : (k+1)·n/P]. The
    all-to-all is P copies into each partition's row slab."""
    parts, n = len(xs), xs[0].shape[0]
    if n % parts:
        raise ValueError(f"rows ({n}) must be divisible by the mesh size ({parts})")
    m = n // parts
    out = []
    for k, xk in enumerate(xs):
        slab = torch.cat([_copy_to(x[k * m : (k + 1) * m], xk.device) for x in xs], dim=1)  # x[my rows, :]
        out.append(slab.T.contiguous())
    return out


def make_dist_transpose(mesh: Ring, parts: int):
    """``xs -> dist_transpose(xs)`` for the column shards on ``mesh``
    (``mg_gcn_tpu/parallel/dist_col.py:71-81``)."""
    if parts != mesh.parts:
        raise ValueError(f"{parts} parts on a ring of {mesh.parts}")

    def transpose(xs):
        if len(xs) != parts:
            raise ValueError(f"{len(xs)} shards for {parts} partitions")
        return dist_transpose(xs)

    return transpose


def _tp_linear(hs, ws, bs) -> list[torch.Tensor]:
    """Tensor-parallel ``XW + b`` (``mg_gcn_tpu/parallel/dist_col.py:84-91``):
    partition k's h (n, in/P) @ w (in/P, out) is a partial (n, out); output
    column block k is the partials' block k summed in partition order, on
    partition k's device, plus bias block k."""
    partials = [h @ w for h, w in zip(hs, ws)]
    c = partials[0].shape[1] // len(hs)
    return [reduce_parts([p[:, k * c : (k + 1) * c].to(b.device) for p in partials], torch.add) + b
            for k, b in enumerate(bs)]


def _dist_col_softmax_xent(logits: Sequence[torch.Tensor], ys: Sequence[torch.Tensor], n_total: int):
    """Column-sharded softmax cross-entropy (``mg_gcn_tpu/parallel/
    dist_col.py:94-139``; gcn.hpp:690-721): ``logits[k]`` partition k's (n,
    c/P) shard, ``ys[k]`` the labels on its device. The row max (no
    gradient) and the denominator over the partitions; the label's
    probability from its owning shard; the prediction the first shard's
    column holding the row's max (cuda_utils.cu:120-133). Returns (loss,
    acc) on the first partition's device."""
    c_loc = logits[0].shape[1]
    devs = [lg.device for lg in logits]
    row_max = reduce_parts([torch.amax(lg.detach(), dim=1) for lg in logits], torch.maximum)
    es = [torch.exp(lg - row_max.to(d)[:, None]) for lg, d in zip(logits, devs)]
    denom = reduce_parts([torch.sum(e, dim=1) for e in es], torch.add)
    os_ = [e / denom.to(d)[:, None] for e, d in zip(es, devs)]
    picks = []
    for k, (o, y) in enumerate(zip(os_, ys)):
        local = y.long() - k * c_loc
        in_shard = (local >= 0) & (local < c_loc)
        p = torch.gather(o, 1, torch.clamp(local, 0, c_loc - 1)[:, None])[:, 0]
        picks.append(torch.where(in_shard, p, torch.zeros_like(p)))
    p_label = reduce_parts(picks, torch.add)
    logp = torch.log(torch.clamp(p_label, min=torch.finfo(p_label.dtype).tiny))

    # accuracy only: the first shard holding the row's max wins
    local_max = [torch.amax(o.detach(), dim=1) for o in os_]
    gmax = reduce_parts(local_max, torch.maximum)
    cands = [torch.where(lm == gmax.to(d), torch.argmax(o.detach(), dim=1) + k * c_loc, 2**30)
             for k, (o, lm, d) in enumerate(zip(os_, local_max, devs))]
    pred = reduce_parts(cands, torch.minimum)
    correct = (pred == ys[0].long().to(pred.device)).to(logp.dtype)
    return -torch.sum(logp) / n_total, torch.sum(correct) / n_total


def col_loss_fn(params, mats: Sequence[AggPair], xs, ys, config: GCNConfig, n_total: int):
    """Forward and loss over the partitions (``mg_gcn_tpu/parallel/
    dist_col.py:142-160``), differentiable: ``params[k]`` partition k's
    shards, ``mats[k]`` the (Âᵀ, Â) COO pair on its device. Each layer in
    ``layer_meta``'s order, LeakyReLU between layers."""
    hs = list(xs)
    for i in range(config.num_layers):
        meta = config.layer_meta(i)
        ws, bs = [p[i]["W"] for p in params], [p[i]["b"] for p in params]
        if meta["lin_first"]:
            hs = [aggregate(mat, hw) for mat, hw in zip(mats, _tp_linear(hs, ws, bs))]
        else:
            hs = _tp_linear([aggregate(mat, h) for mat, h in zip(mats, hs)], ws, bs)
        if meta["activation"]:
            hs = [ew.leaky_relu(h, config.leaky_slope) for h in hs]
    return _dist_col_softmax_xent(hs, ys, n_total)


def col_loss_and_grad(params, mats, xs, ys, config: GCNConfig, n_total: int):
    """(loss, acc, grads): one backward pass from the one loss through every
    partition; ``grads[k]`` is the gradient of partition k's shards."""
    leaves = [[{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in p] for p in params]
    with torch.enable_grad():
        loss, acc = col_loss_fn(leaves, mats, xs, ys, config, n_total)
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
    :func:`shard_col_state`'s lists, one per partition, returned updated;
    ``mats`` is :func:`replicate_coo`'s list; ``xs`` the feature column
    shards (:func:`shard_columns`); ``ys`` the labels, one copy per
    partition. Every width must divide by P (the reference rounds the last
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
        loss, acc, grads = col_loss_and_grad(params, mats, xs, ys, config, n_total)
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
    each distinct device of ``mesh`` (Â is Âᵀ's entries with rows and
    columns swapped: the COO engine needs no sorted rows); returns one pair
    a partition, partitions on one device sharing it."""
    pairs = []
    for dev in mesh.replica_devices:
        fwd = COOMat(rows=mat.rows.to(dev), cols=mat.cols.to(dev), vals=mat.vals.to(dev), n_rows=mat.n_rows,
                     n_cols=mat.n_cols, nnz=mat.nnz)
        pairs.append(AggPair(fwd=fwd, bwd=COOMat(rows=fwd.cols, cols=fwd.rows, vals=fwd.vals, n_rows=mat.n_cols,
                                                 n_cols=mat.n_rows, nnz=mat.nnz)))
    return [pairs[mesh.replica_of(j)] for j in range(mesh.parts)]


def shard_columns(x, mesh: Ring) -> list[torch.Tensor]:
    """Split the last axis of ``x`` (numpy array or tensor) into P equal
    column blocks, partition k's on its device."""
    t = torch.as_tensor(x)
    if t.shape[-1] % mesh.parts:
        raise ValueError(f"{t.shape[-1]} columns do not split into {mesh.parts} equal partitions")
    c = t.shape[-1] // mesh.parts
    return [t[..., k * c : (k + 1) * c].contiguous().to(dev) for k, dev in enumerate(mesh.devices)]


def _shard_axis(key: str) -> int:
    """W leaves split by input rows, biases by output columns."""
    return 0 if key.startswith("W") else -1


def shard_col_params(params, mesh: Ring) -> list[list[dict]]:
    """Full parameter tree -> one tree of shards a partition, on its device."""
    shards = [[{} for _ in params] for _ in range(mesh.parts)]
    for i, layer in enumerate(params):
        for key, t in layer.items():
            if t.shape[_shard_axis(key)] % mesh.parts:
                raise ValueError(f"layer {i} {key} {tuple(t.shape)} does not split into {mesh.parts} shards")
            for k, part in enumerate(torch.chunk(t, mesh.parts, dim=_shard_axis(key))):
                shards[k][i][key] = part.contiguous().to(mesh.devices[k])
    return shards


def gather_col_params(shards) -> list[dict]:
    """:func:`shard_col_params`'s shards -> the full tree, on the first
    partition's device."""
    dev = next(iter(shards[0][0].values())).device
    return [{key: torch.cat([s[i][key].to(dev) for s in shards], dim=_shard_axis(key)) for key in layer}
            for i, layer in enumerate(shards[0])]


def shard_col_state(state: adam.AdamState, mesh: Ring) -> list[adam.AdamState]:
    """An AdamState of full trees -> one a partition: moments sharded like
    their leaves, the step count replicated."""
    ms, vs = shard_col_params(state.m, mesh), shard_col_params(state.v, mesh)
    return [adam.AdamState(step=state.step.to(dev), m=m, v=v) for dev, m, v in zip(mesh.devices, ms, vs)]


def gather_col_state(states: Sequence[adam.AdamState]) -> adam.AdamState:
    """:func:`shard_col_state`'s states -> one AdamState of full trees."""
    return adam.AdamState(step=states[0].step, m=gather_col_params([s.m for s in states]),
                          v=gather_col_params([s.v for s in states]))
