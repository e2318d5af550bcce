"""1-D row-partitioned GCN training over P partitions, driven by one
process or by several.

Port of ``mg_gcn_tpu/parallel/dist.py`` (the CLI's ``-P N -R 1`` path). The
JAX package runs it as one program over a device mesh (``shard_map``); the
reference as one host process driving P GPUs (dist_matrix.hpp:30). The port
does as the reference does: a process drives its partitions, each placed on
a ``torch.device``, and several partitions may share a card (``[cuda:0] * 4``,
like the JAX package's virtual CPU devices). After
``multihost.initialize`` the P partitions split over the processes,
contiguously in rank order, as the JAX mesh orders the devices by process;
with one process it drives all P. The mapping:

* the mesh -> :class:`Ring`, this process's partitions' devices in ring
  order, and which process owns each partition (:func:`make_mesh`);
* an array sharded over the mesh -> a list of this process's partitions'
  tensors, each on its device (:func:`shard`);
* ``lax.ppermute`` -> a copy of the neighbour's block into a buffer on this
  partition's device (a peer copy when the two lie on different cards), or a
  message when another process owns the neighbour (:func:`_permute`); where
  autograd differentiates through it across processes, :class:`_Hop`,
  whose backward is the reverse hop's messages;
* ``lax.all_to_all`` / ``psum_scatter`` -> :func:`all_to_all` (the column
  path), its backward the transposed all-to-all;
* ``lax.psum`` / ``lax.pmax`` -> every partition's tensor gathered to every
  process and folded in partition order (:func:`reduce_parts`), so that a
  run repeats bit for bit whatever the number of processes;
* replicated parameters and optimizer state -> one copy per distinct device
  (:func:`replicate`), each updated from the same summed gradients;
* a value every process computes alike from every partition's pieces (the
  column path's loss) -> :func:`gather_replicated`, whose backward keeps
  each process's own pieces' gradients and sums nothing over processes.

Every loop over partitions visits this process's partitions only; the
process boundary lives in :class:`Ring` and these helpers.

The pairs: COO ring blocks (:class:`DistAggPair`), the bit-packed pattern
pair (:class:`DistPatternPair`), ring blocks on the serial-gather kernel
(:class:`DistGatherPair`) and the halo exchange (``parallel/dist_halo.py``).
GCN trains on each (:func:`make_dist_train_step`), GraphSAGE on all but the
pattern pair (:func:`make_dist_sage_train_step`). The models' layer stacks
are ``models/``'s, run with one block a partition; this module supplies
what is particular to partitions: the aggregation over them, the loss
across them and the sum of their gradients.

The exchange runs on the partitions' current streams, before the products
that read it; overlapping the two is later work (ROADMAP queue 1 item 9h).

Traced (``timers``), the GCN step opens the one-card step's phase scopes
(``models.gcn``'s own), each around the loop over the partitions; every move between partitions
opens an ``exchange`` span, every fold a ``psum`` span, and the bytes that
land in another partition count to ``timers.EXCHANGE_BYTES`` under the
partition they land in (:func:`_landed`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, sparse, timers
from . import multihost
from ..formats import CSRData
from ..models import gcn, sage
from ..models.gcn import GCNConfig
from ..nn import adam
from ..ops import spmm_pattern as sp
from ..ops.softmax_xent import softmax
from ..ops.spmm import COOMat, spmm
from ..ops.spmm_gather import GatherMat, spmm_gather
from ..ops.spmm_pattern_ring import ring_pattern_bwd, ring_pattern_fwd
from ..timers import scope

STRATEGIES = {"coo": ("ring", "all_gather"), "pattern": ("ring", "all_gather", "fused"), "gather": ("ring",),
              "halo": ("ring",), "halo_gather": ("ring",)}


@dataclass(frozen=True)
class Ring:
    """The partitions in ring order (the JAX package's 1-D mesh):
    ``devices`` are this process's partitions' devices, and the ``world``
    processes own ``len(devices)`` contiguous partitions each, process
    ``rank`` partitions [first, first + len(devices))."""

    devices: tuple[torch.device, ...]
    world: int = 1
    rank: int = 0

    @property
    def parts(self) -> int:
        return len(self.devices) * self.world

    @property
    def first(self) -> int:
        return self.rank * len(self.devices)

    @property
    def local(self) -> range:
        """The global ids of this process's partitions."""
        return range(self.first, self.first + len(self.devices))

    def owner(self, j: int) -> int:
        """The process that owns partition j."""
        return j // len(self.devices)

    @property
    def replica_devices(self) -> tuple[torch.device, ...]:
        """The distinct devices, in order of first appearance: one replica of
        the parameters each."""
        return tuple(dict.fromkeys(self.devices))

    def replica_of(self, i: int) -> int:
        """Index into :attr:`replica_devices` of this process's i-th
        partition's device."""
        return self.replica_devices.index(self.devices[i])


def make_mesh(num_devices: int | None = None, devices=None) -> Ring:
    """The ring of partitions (``mg_gcn_tpu/parallel/dist.py:54-72``).

    One process: with ``devices=None``, ``cuda:0 .. cuda:{P-1}``, P =
    ``num_devices`` or every visible card; fewer visible cards than P raises,
    never a smaller ring. An explicit ``devices`` list may repeat a device:
    ``["cuda:0"] * 4`` puts four partitions on one card, ``["cpu"] * P`` all
    on the CPU.

    After ``multihost.initialize`` with W processes: P = ``num_devices``
    must split into W equal shares of L = P / W partitions, and
    ``devices`` lists this process's L devices; with ``devices=None`` they
    are the cards ``MG_GCN_LOCAL_DEVICE_IDS`` names, in turn (else
    ``cuda:0 .. cuda:{L-1}``)."""
    world, rank = multihost.process_count(), multihost.process_index()
    if world > 1:
        if num_devices is None or num_devices % world:
            raise ValueError(f"-P {num_devices} partitions do not split evenly over {world} processes")
        num_devices //= world
        if devices is None:
            ids = multihost.local_device_ids() or range(num_devices)
            devices = [f"cuda:{ids[i % len(ids)]}" for i in range(num_devices)]
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        num_devices = visible if num_devices is None else num_devices
        if num_devices < 1 or visible < num_devices:
            # a smaller ring would walk only part of every partition's blocks
            raise ValueError(
                f"make_mesh({num_devices}) but only {visible} CUDA device(s) visible; pass "
                "devices=[...] to place several partitions on one card, or ['cpu'] * P"
            )
        devices = [f"cuda:{i}" for i in range(num_devices)]
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev} is not visible ({torch.cuda.device_count()} CUDA device(s))")
        devs.append(dev)
    if not devs or (num_devices is not None and len(devs) != num_devices):
        raise ValueError(f"make_mesh({num_devices}) with {len(devs)} device(s)")
    return Ring(tuple(devs), world, rank)


def _to(tree, device: torch.device):
    """``tree`` (tensors in lists, dicts and named tuples) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    return [_to(v, device) for v in tree]


def replicate(tree, mesh: Ring) -> list:
    """One copy of ``tree`` (the parameters, or an AdamState) per distinct
    device of ``mesh``: the form the train step takes and returns."""
    return [_to(tree, dev) for dev in mesh.replica_devices]


def shard(x, mesh: Ring) -> list[torch.Tensor]:
    """Split the leading axis of ``x`` (numpy array or tensor) into P equal
    row blocks: this process's partitions' blocks, each on its device. A
    numpy ``x`` is sliced a block at a time (a ``np.memmap`` is read only
    there)."""
    if not isinstance(x, (torch.Tensor, np.ndarray)):
        x = np.asarray(x)
    if x.shape[0] % mesh.parts:
        raise ValueError(f"{x.shape[0]} rows do not split into {mesh.parts} equal partitions")
    m = x.shape[0] // mesh.parts
    out = []
    for j, dev in zip(mesh.local, mesh.devices):
        blk = x[j * m : (j + 1) * m]
        if isinstance(blk, np.ndarray):
            blk = np.ascontiguousarray(blk)
            blk = torch.from_numpy(blk if blk.flags.writeable else blk.copy())
        out.append(blk.to(dev))
    return out


def shard_dataset(ds, mesh: Ring, n_rows: int | None = None, mask_train: bool = False):
    """(xs, ys, masks): the dataset's float32 features, int64 labels and
    loss mask on this process's partitions, built a partition at a time (a
    mapped ``features.bin`` is read only there). Rows are padded with zeros
    to ``n_rows`` (the pattern pair's n_pad) and the mask then keeps the
    real rows (``mg_gcn_tpu/cli.py:556-567``); ``mask_train`` keeps the
    train set (sets == 0) only. ``masks`` is None when every row counts."""
    n = ds.num_nodes
    n_rows = n if n_rows is None else n_rows
    if n_rows % mesh.parts:
        raise ValueError(f"{n_rows} rows do not split into {mesh.parts} equal partitions")
    m = n_rows // mesh.parts
    labels, sets = ds.labels.reshape(-1), ds.sets.reshape(-1)
    xs, ys, masks = [], [], []
    for j, dev in zip(mesh.local, mesh.devices):
        r0, r1 = min(j * m, n), min((j + 1) * m, n)
        x = np.zeros((m, ds.num_features), np.float32)
        x[: r1 - r0] = ds.features[r0:r1]
        y = np.zeros(m, np.int64)
        y[: r1 - r0] = labels[r0:r1]
        mask = np.zeros(m, bool)
        mask[: r1 - r0] = sets[r0:r1] == 0 if mask_train else True
        xs.append(torch.from_numpy(x).to(dev))
        ys.append(torch.from_numpy(y).to(dev))
        masks.append(torch.from_numpy(mask).to(dev))
    return xs, ys, masks if mask_train or n_rows > n else None


def fold(xs: Sequence[torch.Tensor], op: Callable) -> torch.Tensor:
    """``op`` folded over ``xs`` in order, on ``xs[0]``'s device: tensors
    all of one process. :func:`reduce_parts` folds a ring's partitions; the
    column path folds the blocks it gathered here."""
    out = xs[0]
    for x in xs[1:]:
        out = op(out, x.to(out.device))
    return out


def _landed(j: int, blocks: Sequence[torch.Tensor], times: int = 1) -> None:
    """Count ``times`` the bytes of ``blocks`` as landing in partition
    ``j`` (``timers.EXCHANGE_BYTES``), while a profiler runs: the flag is
    read before any size is."""
    if timers.counting():
        timers.count(timers.EXCHANGE_BYTES, times * sum(b.numel() * b.element_size() for b in blocks), j)


def _gather(xs: Sequence[torch.Tensor], mesh: Ring) -> list[torch.Tensor]:
    """``multihost.all_gather_parts`` in an ``exchange`` span: every other
    partition's tensor lands in this process's first partition."""
    with scope("exchange"):
        _landed(mesh.first, xs[:1], mesh.parts - 1)
        return multihost.all_gather_parts(list(xs))


def reduce_parts(xs: Sequence[torch.Tensor], op: Callable, mesh: Ring) -> torch.Tensor:
    """``op`` folded over every partition of ``mesh`` in partition order, on
    the first local partition's device (psum with torch.add, pmax with
    torch.maximum). ``xs`` are this process's partitions' tensors; across
    processes (``mesh.world > 1``) every partition's is gathered first, so
    each process folds the same tensors in the same order as one process
    would, never in a library's all-reduce order."""
    with scope("psum"):
        if mesh.world > 1:
            return fold(_gather(xs, mesh), op)
        _landed(mesh.first, xs[:1], mesh.parts - 1)
        return fold(xs, op)


def to_parts(x: torch.Tensor, mesh: Ring) -> list[torch.Tensor]:
    """``x``, held by this process's first partition (a fold's result), on
    each of its partitions' devices, in an ``exchange`` span."""
    with scope("exchange"):
        for j in mesh.local[1:]:
            _landed(j, [x])
        return [x.to(dev) for dev in mesh.devices]


def _psum_trees(trees: Sequence, mesh: Ring) -> list[dict]:
    """The per-partition gradient trees summed leaf by leaf (psum), in
    partition order. Across processes every leaf travels in one gather."""
    keys = [(i, k) for i, layer in enumerate(trees[0]) for k in layer]
    with scope("psum"):
        if mesh.world == 1:
            _landed(mesh.first, [trees[0][i][k] for i, k in keys], mesh.parts - 1)
            leaves = {key: fold([t[key[0]][key[1]] for t in trees], torch.add) for key in keys}
        else:
            flat = _gather([torch.cat([t[i][k].reshape(-1) for i, k in keys]) for t in trees], mesh)
            pieces = [torch.split(f, [trees[0][i][k].numel() for i, k in keys]) for f in flat]
            leaves = {key: fold([p[e] for p in pieces], torch.add).reshape(trees[0][key[0]][key[1]].shape)
                      for e, key in enumerate(keys)}
    return [{k: leaves[(i, k)] for k in layer} for i, layer in enumerate(trees[0])]


def _copy_to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``x`` in a new buffer on ``device`` (a peer copy across cards)."""
    return torch.empty_like(x, device=device).copy_(x)


# messages between processes are tagged by their exchange's position: the
# count of exchanges this process has made (every process makes the same
# ones in the same order), wrapped, with a bit for the backward's messages
_POSITION = [0]
_POSITION_WRAP = 1 << 12


def _next_position() -> int:
    _POSITION[0] = (_POSITION[0] + 1) % _POSITION_WRAP
    return _POSITION[0]


def _tag(position: int, back: bool, src: int, dst: int, parts: int) -> int:
    """The tag of the message from partition ``src`` to partition ``dst``
    in the exchange at ``position`` (its backward's when ``back``): under
    2^31 for up to 256 partitions."""
    return ((position * 2 + back) * parts + src) * parts + dst


def _permute(blocks: Sequence[torch.Tensor], shift: int, mesh: Ring, copy: bool = True,
             position: int | None = None, back: bool = False) -> list[torch.Tensor]:
    """Local partition j receives the block partition (j + shift) % P holds
    (``lax.ppermute`` with perm (i, (i - shift) % P)); every block has the
    same shape. A block of this process is copied onto j's device (with
    ``copy=False`` one already there is used as it is); a block of another
    process arrives in one batch of sends and receives with the rest of the
    hop's messages (``multihost.exchange``), tagged by the hop's
    ``position`` (the next one when None) and ``back``."""
    def local_block(b, device):
        return b if not copy and b.device == device else _copy_to(b, device)

    P, first = mesh.parts, mesh.first
    with scope("exchange"):
        if shift % P:
            for jl, j in enumerate(mesh.local):
                _landed(j, blocks[jl : jl + 1])  # every block has the shape
        if mesh.world == 1:
            return [local_block(blocks[(j + shift) % P], blocks[j].device) for j in range(P)]
        position = _next_position() if position is None else position
        out: list = [None] * len(blocks)
        sends, recvs, into = [], [], []
        for jl, j in enumerate(mesh.local):
            src = (j + shift) % P
            if mesh.owner(src) == mesh.rank:
                out[jl] = local_block(blocks[src - first], blocks[jl].device)
            else:
                recvs.append((torch.empty_like(blocks[jl]), mesh.owner(src), _tag(position, back, src, j, P)))
                into.append(jl)
        for kl, k in enumerate(mesh.local):
            dst = (k - shift) % P
            if mesh.owner(dst) != mesh.rank:
                sends.append((blocks[kl], mesh.owner(dst), _tag(position, back, k, dst, P)))
        for jl, got in zip(into, multihost.exchange(sends, recvs)):
            out[jl] = got
        return out


class _Hop(torch.autograd.Function):
    """A hop across processes that carries gradients: the forward is
    :func:`_permute` by ``shift``, the backward :func:`_permute` of the
    outputs' gradients by ``-shift`` (JAX's transpose of ``ppermute``),
    tagged by the forward's position. Each batch of messages blocks until
    its peer posts the matching batch, so every process's autograd engine
    must reach the backward hops in the same order, as it does when the
    processes build the same graph: engines that took different orders
    would hang, not pair up, and the gradients' sums would fold in another
    order. Every output must feed the loss on every process (a hop whose
    outputs no process uses is never reached and its peer waits)."""

    @staticmethod
    def forward(ctx, shift, mesh, *blocks):
        ctx.shift, ctx.mesh, ctx.position = shift, mesh, _next_position()
        return tuple(_permute(blocks, shift, mesh, position=ctx.position))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_permute(grads, -ctx.shift, ctx.mesh, position=ctx.position, back=True))


def _ppermute(blocks: Sequence[torch.Tensor], mesh: Ring) -> list[torch.Tensor]:
    """One ring hop (JAX's ``_ring_perm``, dist.py:318-321): partition j
    receives the block partition j+1 held. In one process a differentiable
    copy; across processes :class:`_Hop`, whose backward sends the
    gradients back round the ring."""
    if mesh.world == 1:
        return _permute(blocks, 1, mesh)
    return list(_Hop.apply(1, mesh, *blocks))


def _all_to_all(pieces: Sequence[Sequence[torch.Tensor]], mesh: Ring, position: int | None = None,
                back: bool = False) -> list[list[torch.Tensor]]:
    """Every partition sends one block to every partition (``lax.all_to_all``):
    ``pieces[i][k]`` is this process's i-th partition's block for partition
    k; returns ``out[i][j]``, partition j's block for this process's i-th
    partition, on its device. Blocks between this process's partitions are
    copies; the others travel in one batch (``multihost.exchange``), tagged
    as :func:`_permute`'s."""
    P, local = mesh.parts, list(mesh.local)
    devs = [pieces[i][k].device for i, k in enumerate(local)]
    with scope("exchange"):
        for i, k in enumerate(local):
            # every block partition j sends to k has the shape k sends to j
            _landed(k, [pieces[i][j] for j in range(P) if j != k])
        if mesh.world == 1:
            return [[_copy_to(pieces[j][k], devs[k]) for j in range(P)] for k in range(P)]
        position = _next_position() if position is None else position
        out = [[None] * P for _ in local]
        sends, recvs, into = [], [], []
        for i, j in enumerate(local):
            for k in range(P):
                if mesh.owner(k) == mesh.rank:
                    out[k - mesh.first][j] = _copy_to(pieces[i][k], devs[k - mesh.first])
                else:
                    sends.append((pieces[i][k], mesh.owner(k), _tag(position, back, j, k, P)))
        for i, k in enumerate(local):
            for j in range(P):
                if mesh.owner(j) != mesh.rank:
                    like = pieces[i][j]
                    recvs.append((torch.empty_like(like, device=devs[i]), mesh.owner(j),
                                  _tag(position, back, j, k, P)))
                    into.append((i, j))
        for (i, j), got in zip(into, multihost.exchange(sends, recvs)):
            out[i][j] = got
        return out


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all` that carries gradients: the backward is the
    all-to-all of the outputs' gradients back to their senders (its own
    transpose), tagged by the forward's position."""

    @staticmethod
    def forward(ctx, mesh, *flat):
        ctx.mesh, ctx.position = mesh, _next_position()
        out = _all_to_all(_rows(flat, mesh), mesh, ctx.position)
        return tuple(t for row in out for t in row)

    @staticmethod
    def backward(ctx, *grads):
        back = _all_to_all(_rows(grads, ctx.mesh), ctx.mesh, ctx.position, back=True)
        return (None, *(g for row in back for g in row))


def _rows(flat: Sequence, mesh: Ring) -> list:
    """``flat`` (P blocks for each of this process's partitions, in turn)
    as one list of P blocks a partition."""
    P = mesh.parts
    return [list(flat[i * P : (i + 1) * P]) for i in range(len(mesh.devices))]


def all_to_all(pieces: Sequence[Sequence[torch.Tensor]], mesh: Ring) -> list[list[torch.Tensor]]:
    """:func:`_all_to_all`, differentiable: in one process copies that
    autograd differentiates; across processes :class:`_AllToAll`."""
    if mesh.world == 1:
        return _all_to_all(pieces, mesh)
    return _rows(_AllToAll.apply(mesh, *(t for row in pieces for t in row)), mesh)


class _GatherReplicated(torch.autograd.Function):
    """Every partition's tensor on every process, for a consumer that every
    process computes alike (a replicated loss): the backward hands each
    input this process's own gradient of its copy and never sums the
    copies' gradients over processes, which would scale them by the number
    of processes (the JAX column step's fault)."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(_gather(xs, mesh))

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        return (None, *(grads[j].to(dev) for j, dev in zip(mesh.local, mesh.devices)))


def gather_replicated(xs: Sequence[torch.Tensor], mesh: Ring) -> list[torch.Tensor]:
    """Every partition's tensor in partition order, on ``xs[0]``'s device,
    differentiable, for a consumer every process computes alike: in one
    process the tensors themselves, across processes
    :class:`_GatherReplicated`."""
    return list(xs) if mesh.world == 1 else list(_GatherReplicated.apply(mesh, *xs))


def _all_parts(blocks: Sequence[torch.Tensor], mesh: Ring) -> list:
    """Every partition's block, in partition order: this process's blocks as
    they are, the others' gathered (the all_gather exchange)."""
    if mesh.world == 1:
        return list(blocks)
    out = _gather(blocks, mesh)
    for jl, j in enumerate(mesh.local):
        out[j] = blocks[jl]
    return out


def _slots(blocks: Sequence[torch.Tensor], j: int, order) -> torch.Tensor:
    """Partition j's (len(order), *block) buffer: slot s the copy of block
    ``order[s]`` (its own block copied too, and not counted); ``blocks``
    holds every partition's block (:func:`_all_parts`)."""
    own = blocks[j]
    with scope("exchange"):
        _landed(j, [blocks[k] for k in order if k != j])
        out = torch.empty((len(order), *own.shape), dtype=own.dtype, device=own.device)
        for s, k in enumerate(order):
            out[s].copy_(blocks[k])
    return out


def row_slab(csr: CSRData, j: int, m: int) -> CSRData:
    """Rows [j·m, (j+1)·m) of ``csr`` with global column ids, as views of
    its arrays (the JAX package's ``slab_of``)."""
    e0, e1 = int(csr.indptr[j * m]), int(csr.indptr[(j + 1) * m])
    return CSRData(indptr=csr.indptr[j * m : (j + 1) * m + 1] - e0, indices=csr.indices[e0:e1],
                   data=csr.data[e0:e1], shape=(m, csr.ncols))


def column_blocks(slab: CSRData, parts: int, device: torch.device) -> list[tuple]:
    """A row slab of m rows split on ``device`` into its P column blocks of
    m columns: entry k holds block k's (rows, cols, vals), rows local to the
    slab, columns local to the block, in the slab's CSR order (int64 rows
    and columns, float32 values)."""
    m = slab.nrows
    counts = torch.from_numpy(np.diff(slab.indptr).astype(np.int64)).to(device)
    rows = torch.repeat_interleave(torch.arange(m, device=device), counts)
    cols = torch.from_numpy(slab.indices).to(device).long()
    vals = torch.from_numpy(slab.data.astype(np.float32, copy=False)).to(device)
    dest = cols // m
    out = []
    for k in range(parts):
        sel = dest == k
        out.append((rows[sel], cols[sel] - k * m, vals[sel]))
    return out


def gather_block(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, n_out: int, n_in: int) -> GatherMat:
    """A block's row-sorted (rows, cols, vals) as a weighted
    :class:`~..ops.spmm_gather.GatherMat` (n_out × n_in) on their device."""
    indptr = torch.zeros(n_out + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(torch.bincount(rows, minlength=n_out), 0, out=indptr[1:])
    return GatherMat(indptr=indptr, indices=cols.to(torch.int32), w=vals, scale=None, n_out=n_out, n_in=n_in,
                     nnz=rows.numel())


# ---------------------------------------------------------------------------
# the COO pair

# every COO ring block is padded to a multiple of this many entries (the JAX
# package's ``DistRowMat.from_csr`` default ``pad_to``)
COO_RING_PAD = 512


@dataclass(frozen=True)
class DistRowMat:
    """Row-partitioned sparse matrix as ring-ordered padded COO blocks.

    ``rows[i]`` / ``cols[i]`` / ``vals[i]`` are this process's i-th
    partition j's (P, E) arrays on its device: entry [s] is the COO block
    A[j, (j+s) % P] with row ids local to row slab j and column ids local to
    column block (j+s) % P. Padding entries have val == 0, row = last local
    row, col = 0. ``ring`` is the ring it was built for.
    """

    rows: list[torch.Tensor]  # int32 (P, E) each
    cols: list[torch.Tensor]
    vals: list[torch.Tensor]  # float32 (P, E) each
    n: int  # global rows (== cols; square)
    parts: int
    nnz: int
    ring: Ring

    @property
    def rows_per_shard(self) -> int:
        return self.n // self.parts

    @staticmethod
    def from_csr(csr: CSRData, mesh: Ring) -> "DistRowMat":
        n, parts = csr.nrows, mesh.parts
        if n % parts:
            raise ValueError(
                f"n ({n}) must be divisible by the mesh size ({parts}); pad the "
                "dataset (the reference has the same requirement, "
                "dist_matrix.hpp:428, and pads in prep.py)"
            )
        part = sparse.uniform_partition(n, parts)
        blocks = sparse.partition_blocks(csr, part, part)
        # the padded width is every partition's widest block: each process
        # holds the whole graph here, so all of them compute the same one
        emax = max(blocks[j][k].nnz for j in range(parts) for k in range(parts))
        emax = max(sp.round_up(emax, COO_RING_PAD), COO_RING_PAD)
        m_loc = n // parts
        out = {"rows": [], "cols": [], "vals": []}
        for j, dev in zip(mesh.local, mesh.devices):
            rows = np.full((parts, emax), m_loc - 1, np.int32)
            cols = np.zeros((parts, emax), np.int32)
            vals = np.zeros((parts, emax), np.float32)
            for s in range(parts):
                blk = blocks[j][(j + s) % parts]  # ring order
                e = blk.nnz
                rows[s, :e] = np.repeat(np.arange(m_loc, dtype=np.int32), np.diff(blk.indptr))
                cols[s, :e] = blk.indices
                vals[s, :e] = blk.data
            for key, a in (("rows", rows), ("cols", cols), ("vals", vals)):
                out[key].append(torch.from_numpy(a).to(dev))
        return DistRowMat(**out, n=n, parts=parts, nnz=csr.nnz, ring=mesh)


@dataclass
class DistAggPair:
    """The (Âᵀ, Â) ring blocks: forward aggregation and its gradient."""

    fwd: DistRowMat
    bwd: DistRowMat

    @staticmethod
    def from_csr_pair(csr_fwd: CSRData, csr_bwd: CSRData, mesh: Ring) -> "DistAggPair":
        return DistAggPair(DistRowMat.from_csr(csr_fwd, mesh), DistRowMat.from_csr(csr_bwd, mesh))


def _block_spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, b: torch.Tensor, m: int) -> torch.Tensor:
    """One partition's local COO product (JAX's ``_local_block_spmm``,
    dist.py:280-315): the port's COO engine, ``index_select`` + ``index_add_``
    in edge chunks."""
    return spmm(COOMat(rows=rows, cols=cols, vals=vals, n_rows=m, n_cols=b.shape[0], nnz=rows.numel()), b)


def dist_aggregate(mat: DistRowMat, hs: Sequence[torch.Tensor], strategy: str = "ring") -> list[torch.Tensor]:
    """C_j = Σ_s A[j, (j+s) % P] @ B_{(j+s) % P} for this process's
    partitions j (``mg_gcn_tpu/parallel/dist.py:439-477``); ``hs`` are their
    (n/P, d) row blocks. ``ring``: P rounds of local products, the blocks
    moving one hop between rounds. ``all_gather``: every partition gathers
    all blocks, then one product over its concatenated edges (the
    reference's ``-S``)."""
    parts, m, ring = mat.parts, mat.rows_per_shard, mat.ring
    if strategy == "all_gather":
        every = _all_parts(hs, ring)
        out = []
        for i, (j, h) in enumerate(zip(ring.local, hs)):
            with scope("exchange"):
                _landed(j, [x for k, x in enumerate(every) if k != j])
                b_full = torch.cat([x.to(h.device) for x in every])  # (n, d), partition order
            block_ids = torch.remainder(j + torch.arange(parts, device=h.device), parts)
            cols = mat.cols[i].long() + block_ids[:, None] * m
            out.append(_block_spmm(mat.rows[i].reshape(-1), cols.reshape(-1), mat.vals[i].reshape(-1), b_full, m))
        return out
    if strategy != "ring":
        raise ValueError(f"unknown dist spmm strategy {strategy!r}")
    cs = [torch.zeros((m, h.shape[1]), dtype=h.dtype, device=h.device) for h in hs]
    blocks = list(hs)
    for s in range(parts):
        for i in range(len(hs)):
            cs[i] += _block_spmm(mat.rows[i][s], mat.cols[i][s], mat.vals[i][s], blocks[i], m)
        if s + 1 < parts:
            blocks = _ppermute(blocks, ring)
    return cs


# ---------------------------------------------------------------------------
# the serial-gather ring pair


@dataclass(frozen=True)
class DistGatherMat:
    """Row-partitioned sparse matrix as ring-ordered blocks on the
    serial-gather kernel (``mg_gcn_tpu/parallel/dist.py:330-380``):
    ``blocks[i][s]`` is the weighted CSR block A[j, (j+s) % P] (m_loc ×
    m_loc) of this process's i-th partition j, on its device, the TPU's
    padded schedules' counterpart."""

    blocks: list[list[GatherMat]]
    n: int
    parts: int
    nnz: int
    ring: Ring

    @property
    def rows_per_shard(self) -> int:
        return self.n // self.parts

    @staticmethod
    def from_csr(csr: CSRData, mesh: Ring) -> "DistGatherMat":
        """Build this process's partitions' blocks on their devices, each
        from its row slab."""
        n, parts = csr.nrows, mesh.parts
        if n % parts:
            raise ValueError(f"n ({n}) must be divisible by the mesh size ({parts})")
        m = n // parts
        blocks = []
        for j, dev in zip(mesh.local, mesh.devices):
            split = column_blocks(row_slab(csr, j, m), parts, dev)
            blocks.append([gather_block(*split[(j + s) % parts], m, m) for s in range(parts)])
            del split
        return DistGatherMat(blocks=blocks, n=n, parts=parts, nnz=csr.nnz, ring=mesh)


@dataclass
class DistGatherPair:
    """(Âᵀ, Â) ring blocks on the serial-gather kernel: the ultra-sparse
    row partition (``mg_gcn_tpu/parallel/dist.py:383-405``)."""

    fwd: DistGatherMat
    bwd: DistGatherMat

    @staticmethod
    def from_csr_pair(csr_fwd: CSRData, csr_bwd: CSRData, mesh: Ring) -> "DistGatherPair":
        return DistGatherPair(DistGatherMat.from_csr(csr_fwd, mesh), DistGatherMat.from_csr(csr_bwd, mesh))


def dist_aggregate_gather(mat: DistGatherMat, hs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """C_j = Σ_s A[j, (j+s) % P] @ B_{(j+s) % P} on the serial-gather kernel
    (``mg_gcn_tpu/parallel/dist.py:411-436``): P rounds of local products in
    float32, the blocks moving one hop between rounds, as
    :func:`dist_aggregate`'s ring."""
    parts = mat.parts
    cs: list = [None] * len(hs)
    blocks = list(hs)
    for s in range(parts):
        for i in range(len(hs)):
            prod = spmm_gather(mat.blocks[i][s], blocks[i])
            cs[i] = prod if s == 0 else cs[i] + prod
        if s + 1 < parts:
            blocks = _ppermute(blocks, mat.ring)
    return [c.to(h.dtype) for c, h in zip(cs, hs)]


# ---------------------------------------------------------------------------
# the bit-packed pattern pair


def _ring_packs(csr: CSRData, m: int, j: int, parts: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Partition j's ring-ordered (pack_fwd, pack_bwd), int32 (P, m, m/32),
    built on ``device`` from the edges: the column indices go up in row
    chunks (4 bytes an edge) and each pack is filled by
    :func:`~..ops.spmm_pattern.add_bits`. No host pass over the blocks."""
    words = m // 32
    pack_fwd = torch.zeros((parts, m, words), dtype=torch.int32, device=device)
    pack_bwd = torch.zeros_like(pack_fwd)
    indptr = csr.indptr.astype(np.int64, copy=False)
    rows_per = max(1, -(-csr.nrows // sp._PACK_ROW_CHUNKS))
    for r0 in range(0, csr.nrows, rows_per):
        r1 = min(r0 + rows_per, csr.nrows)
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e1 == e0:
            continue
        cols = torch.from_numpy(csr.indices[e0:e1]).to(device).long()
        counts = torch.from_numpy(np.diff(indptr[r0 : r1 + 1])).to(device)
        rows = r0 + torch.repeat_interleave(torch.arange(r1 - r0, device=device), counts)
        row_blk, col_blk = rows // m, cols // m
        # pack_fwd[j, s] = P[k_s row slab, j column slab]: k_s is the row's slab
        sel = col_blk == j
        k = row_blk[sel]
        sp.add_bits(pack_fwd.view(-1), (((k - j) % parts) * m + rows[sel] - k * m) * words, cols[sel] - j * m)
        # pack_bwd[j, s] = P[j row slab, k_s column slab]: k_s is the column's slab
        sel = row_blk == j
        k = col_blk[sel]
        sp.add_bits(pack_bwd.view(-1), (((k - j) % parts) * m + rows[sel] - j * m) * words, cols[sel] - k * m)
    return pack_fwd, pack_bwd


@dataclass(frozen=True)
class DistPatternPair:
    """Row-partitioned bit-packed pattern pair (``mg_gcn_tpu/parallel/
    dist.py:169-263``). For partition j, with k_s = (j+s) mod P:

      pack_fwd[j][s] = bits of P[k_s row slab, j column slab]  (forward rounds)
      pack_bwd[j][s] = bits of P[j row slab, k_s column slab]  (backward rounds)
      scale[j]       = the 1/in-degree slab of partition j's rows

    Slabs are m_loc = round_up(ceil(n/P), 4096) rows, so a partition holds
    2·P·m_loc²/8 bytes of packs, on its device; a process holds its own
    partitions' (the lists' entries, in order).
    """

    pack_fwd: list[torch.Tensor]  # int32 (P, m_loc, m_loc/32) each
    pack_bwd: list[torch.Tensor]
    scale: list[torch.Tensor]  # float32 (m_loc,) each
    n: int
    n_pad: int
    parts: int
    m_loc: int
    dtype_name: str
    nnz: int
    ring: Ring

    @staticmethod
    def from_binary_csr(csr: CSRData, mesh: Ring, dtype: str = "bfloat16") -> "DistPatternPair":
        """Build each partition's packs on its device from the edges."""
        if not sp.is_binary(csr):
            raise ValueError("pattern dist pair needs a binary adjacency")
        if dtype not in sp.DTYPES:
            raise ValueError(f"unknown pattern dtype {dtype!r} (expected {'/'.join(sp.DTYPES)})")
        n, parts = csr.nrows, mesh.parts
        m = sp.round_up(-(-n // parts), sp.GROUP)
        if csr.ncols > 1 << 24:
            raise ValueError("pattern packing supports column indices < 2^24")
        indeg = np.bincount(csr.indices, minlength=m * parts).astype(np.float64)
        with np.errstate(divide="ignore"):
            s_vec = np.where(indeg > 0, 1.0 / indeg, 0.0).astype(np.float32)
        packs = [_ring_packs(csr, m, j, parts, dev) for j, dev in zip(mesh.local, mesh.devices)]
        return DistPatternPair(
            pack_fwd=[f for f, _ in packs],
            pack_bwd=[b for _, b in packs],
            scale=[torch.from_numpy(s_vec[j * m : (j + 1) * m]).to(dev) for j, dev in zip(mesh.local, mesh.devices)],
            n=n, n_pad=m * parts, parts=parts, m_loc=m, dtype_name=dtype, nnz=csr.nnz, ring=mesh,
        )


def dist_aggregate_pattern(
    pair: DistPatternPair,
    hs: Sequence[torch.Tensor],
    orientation: str,
    dtype_name: str | None = None,
    strategy: str = "ring",
) -> list[torch.Tensor]:
    """The distributed product over the bit packs (``mg_gcn_tpu/parallel/
    dist.py:480-629``) for every partition; ``hs`` are the (m_loc, d) blocks.

    Forward ("PT"): C_j = s_j ⊙ Σ_s P[k_s rows, j cols]ᵀ B_{k_s}, post-scaled.
    Backward ("P"): own block pre-scaled, then C_j = Σ_s P[j rows, k_s cols]
    G_{k_s}. The blocks go on the wire in the operand dtype. ``ring`` and
    ``all_gather`` run the single-pack kernels ``pattern_fwd`` /
    ``pattern_bwd`` per round on the m_loc-square blocks, adding each
    round's product in the accumulator type; ``fused`` fills each
    partition's (P, m_loc, d_pad) slot buffer and launches one ring kernel a
    partition. ``fused`` and ``all_gather`` fill every partition's slots
    before the first product: a peer copy runs on its source card's current
    stream, so a copy issued after that card's product would wait for it,
    and the cards' products would run one after another. Each slot buffer
    is dropped once its partition's products are issued. int8: one global
    per-feature scale, the max over all partitions (pmax), so every
    partition quantizes as the single-card path does; int32 sums.
    """
    if strategy not in STRATEGIES["pattern"]:
        raise ValueError(f"unknown dist spmm strategy {strategy!r}")
    dtype_name = dtype_name or pair.dtype_name
    parts, m, ring = pair.parts, pair.m_loc, pair.ring
    local = ring.local
    d = hs[0].shape[1]
    d_pad = sp.round_up(max(d, 8), 8)
    op_dt = sp.DTYPES[dtype_name]
    acc_dt = torch.int32 if op_dt == torch.int8 else torch.float32
    forward = orientation == "PT"
    packs = pair.pack_fwd if forward else pair.pack_bwd
    hs = [h.to(torch.float32) for h in hs]
    if not forward:  # pre-scale the own block (before int8 quantizing, too)
        hs = [h * sc[:, None] for h, sc in zip(hs, pair.scale)]
    qscale = [None] * len(hs)
    if op_dt == torch.int8:
        amax = torch.clamp(reduce_parts([torch.amax(torch.abs(h), dim=0) for h in hs], torch.maximum, ring),
                           min=1e-30)
        # a tensor divisor: CUDA turns division by a Python scalar into a
        # multiply by its reciprocal (ROADMAP queue 3)
        qscale = [q / torch.full_like(q, 127.0) for q in to_parts(amax, ring)]
    blocks = []
    for h, q in zip(hs, qscale):
        blk = torch.zeros((m, d_pad), dtype=op_dt, device=h.device)
        blk[:, :d] = (h if q is None else torch.clamp(torch.round(h / q[None, :]), -127, 127)).to(op_dt)
        blocks.append(blk)

    if strategy == "fused":
        # one launch a partition over its P slots; at P = 1 the kernel runs
        # one round (the JAX package swaps to "ring" there, dist.py:509-512,
        # because its RDMA kernel needs a peer; this one reads no peer)
        kernel = ring_pattern_fwd if forward else ring_pattern_bwd
        every = _all_parts(blocks, ring)
        slots = [_slots(every, j, [(j + s) % parts for s in range(parts)]) for j in local]
        accs = [kernel(pack, slots.pop(0)) for pack in packs]
    else:
        call = sp.pattern_fwd if forward else sp.pattern_bwd
        accs = [torch.zeros((m, d_pad), dtype=acc_dt, device=b.device) for b in blocks]
        if strategy == "all_gather":
            every = _all_parts(blocks, ring)
            slots = [_slots(every, j, range(parts)) for j in local]  # partition order
            for i, j in enumerate(local):
                gathered = slots.pop(0)
                for s in range(parts):
                    accs[i] += call(packs[i][s], gathered[(j + s) % parts])
        else:
            for s in range(parts):
                for i in range(len(blocks)):
                    accs[i] += call(packs[i][s], blocks[i])
                if s + 1 < parts:
                    blocks = _ppermute(blocks, ring)
    out = []
    for acc, q, sc in zip(accs, qscale, pair.scale):
        c = acc[:, :d].to(torch.float32)
        if q is not None:
            c = c * q[None, :]
        out.append(c * sc[:, None] if forward else c)
    return out


# ---------------------------------------------------------------------------
# the step


def _dist_softmax_xent(logits, ys, n_total: int, masks, mesh: Ring):
    """Row-local softmax + NLL with partition-summed scalars (gcn.hpp:890-929):
    (loss, acc, per-partition logits gradients)."""
    probs = [softmax(lg) for lg in logits]
    terms, grads = [], []
    if masks is None:
        denom = torch.tensor(float(n_total), device=logits[0].device)
    else:
        ms = [mk.to(torch.float32) for mk in masks]
        denom = torch.clamp(reduce_parts([torch.sum(mk) for mk in ms], torch.add, mesh), min=1)
    for j, (o, y, dn) in enumerate(zip(probs, ys, to_parts(denom, mesh))):
        y = y.long()
        logp = torch.log(torch.clamp(torch.gather(o, 1, y[:, None])[:, 0], min=torch.finfo(o.dtype).tiny))
        correct = (torch.argmax(o, dim=-1) == y).to(o.dtype)
        g = o - F.one_hot(y, o.shape[1]).to(o.dtype)
        if masks is None:
            terms.append((torch.sum(logp), torch.sum(correct)))
            grads.append(g / dn)
        else:
            terms.append((torch.sum(logp * ms[j]), torch.sum(correct * ms[j])))
            grads.append(g * ms[j][:, None] / dn)
    loss = -reduce_parts([t[0] for t in terms], torch.add, mesh) / denom
    acc = reduce_parts([t[1] for t in terms], torch.add, mesh) / denom
    return loss, acc, grads


def _local_xent_terms(logits, y, m, denom):
    """One partition's (loss share, accuracy share), differentiable; the
    caller sums the shares."""
    o = softmax(logits)
    y = y.long()
    logp = torch.log(torch.clamp(torch.gather(o, 1, y[:, None])[:, 0], min=torch.finfo(o.dtype).tiny))
    correct = (torch.argmax(o.detach(), dim=-1) == y).to(torch.float32)
    if m is None:
        return -torch.sum(logp) / denom, torch.sum(correct) / denom
    return -torch.sum(logp * m) / denom, torch.sum(correct * m) / denom


def dist_loss_and_grad(params, agg_fwd, agg_bwd, xs, ys, config: GCNConfig, n_total: int, masks=None, *,
                       mesh: Ring):
    """Forward and reference-parity backward over this process's partitions
    (``mg_gcn_tpu/parallel/dist.py:718-752``): ``models.gcn``'s layer stack
    with the partition-summed loss layer. ``params[i]`` is the parameter
    tree on its i-th partition's device; ``agg_fwd`` / ``agg_bwd`` map the
    partitions' blocks to theirs. Returns (loss, acc, grads), the gradients
    summed over every partition (of every process of ``mesh``) in partition
    order, on the first local partition's device."""
    with torch.no_grad():
        loss, acc, local = gcn.loss_and_grad_parity_blocks(
            params, agg_fwd, agg_bwd, xs, config, lambda hs: _dist_softmax_xent(hs, ys, n_total, masks, mesh))
    return loss, acc, _psum_trees(local, mesh)


class _ExactAgg(torch.autograd.Function):
    """The aggregation over all partitions, differentiable: the forward runs
    ``agg_fwd`` (the Âᵀ schedule), the backward ``agg_bwd`` (the Â schedule)
    on the partitions' output gradients (JAX's ``_exact_agg``)."""

    @staticmethod
    def forward(ctx, agg_fwd, agg_bwd, *hs):
        ctx.agg_bwd = agg_bwd
        return tuple(agg_fwd(list(hs)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *ctx.agg_bwd(list(gs)))


def _exact_loss_and_grad(params, logits_of: Callable, ys, n_total: int, masks, mesh: Ring,
                         loss_scope: str | None = None):
    """(loss, acc, grads) of the partitions' summed local loss shares by one
    backward pass: each partition has its own parameter leaves,
    ``logits_of(leaves)`` gives the partitions' logits, and the leaves'
    gradients are summed over the partitions afterwards. ``loss_scope``
    names the phase scope around the loss shares, where the model's
    one-card step opens one."""
    leaves = [[{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in p] for p in params]
    if masks is None:
        ms = [None] * len(ys)
        denom = torch.tensor(float(n_total), device=ys[0].device)
    else:
        ms = [mk.to(torch.float32) for mk in masks]
        denom = torch.clamp(reduce_parts([torch.sum(mk) for mk in ms], torch.add, mesh), min=1.0)
    with torch.enable_grad():
        logits = logits_of(leaves)
        with scope(loss_scope) if loss_scope else contextlib.nullcontext():
            terms = [_local_xent_terms(h, y, m, dn) for h, y, m, dn in zip(logits, ys, ms, to_parts(denom, mesh))]
        flat = [v for p in leaves for layer in p for v in layer.values()]
        flat_grads = iter(torch.autograd.grad([t[0] for t in terms], flat))
    local = [[{k: next(flat_grads) for k in layer} for layer in p] for p in leaves]
    loss = reduce_parts([t[0].detach() for t in terms], torch.add, mesh)
    acc = reduce_parts([t[1] for t in terms], torch.add, mesh)
    return loss, acc, _psum_trees(local, mesh)


def dist_loss_and_grad_exact(params, agg_fwd, agg_bwd, xs, ys, config: GCNConfig, n_total: int, masks=None, *,
                             mesh: Ring):
    """Exact-autograd twin of :func:`dist_loss_and_grad` (config.parity
    False, CLI ``--exact``; ``mg_gcn_tpu/parallel/dist.py:774-805``): one
    backward pass through :class:`_ExactAgg` gives each partition's leaves
    the gradient of the partitions' local loss shares."""
    agg = lambda hs: list(_ExactAgg.apply(agg_fwd, agg_bwd, *hs))  # noqa: E731
    return _exact_loss_and_grad(params, lambda leaves: gcn.forward_blocks(leaves, agg, xs, config), ys, n_total,
                                masks, mesh)


def dist_sage_loss_and_grad(params, agg, xs, ys, config, n_total: int, masks=None, *, mesh: Ring):
    """GraphSAGE's loss and exact gradients over the partitions
    (``mg_gcn_tpu/parallel/dist.py:1151-1174``): ``agg`` maps the
    partitions' blocks to their M·H blocks, differentiably; each layer is
    ``h·W_self + M h·W_neigh + b``, LeakyReLU and the per-node l2
    normalization between layers (``models.sage.forward_blocks``). Returns
    (loss, acc, grads), summed over the partitions in partition order."""
    return _exact_loss_and_grad(params, lambda leaves: sage.forward_blocks(leaves, agg, xs, config), ys, n_total,
                                masks, mesh)


def _check_pair_kind(pair_kind: str, strategy: str, kinds) -> None:
    if pair_kind not in kinds:
        raise ValueError(f"unknown pair_kind {pair_kind!r}")
    if strategy not in STRATEGIES[pair_kind]:
        if STRATEGIES[pair_kind] == ("ring",):  # the JAX package's message names halo_gather's pair "halo"
            raise ValueError(f"the {pair_kind.split('_')[0]} pair has a single (ring) exchange schedule; "
                             f"strategy {strategy!r} is not available with pair_kind={pair_kind!r}")
        raise ValueError(f"strategy {strategy!r} is not available with pair_kind={pair_kind!r}")


def _aggregations(pair_kind: str, pair, strategy: str, pattern_dtype: str):
    """(agg_fwd, agg_bwd) of ``pair``: its forward and backward matrices'
    products on the partitions' blocks (``mg_gcn_tpu/parallel/dist.py:
    884-921``)."""
    if pair_kind == "pattern":
        return (lambda hs: dist_aggregate_pattern(pair, hs, "PT", pattern_dtype, strategy),
                lambda gs: dist_aggregate_pattern(pair, gs, "P", pattern_dtype, strategy))
    if pair_kind == "coo":
        return (lambda hs: dist_aggregate(pair.fwd, hs, strategy), lambda gs: dist_aggregate(pair.bwd, gs, strategy))
    if pair_kind == "gather":
        return (lambda hs: dist_aggregate_gather(pair.fwd, hs), lambda gs: dist_aggregate_gather(pair.bwd, gs))
    from .dist_halo import DistHaloGatherMat, dist_aggregate_halo

    if isinstance(pair.fwd, DistHaloGatherMat) != (pair_kind == "halo_gather"):
        raise ValueError(f"pair_kind {pair_kind!r} does not match a {type(pair.fwd).__name__} pair")
    return (lambda hs: dist_aggregate_halo(pair.fwd, hs), lambda gs: dist_aggregate_halo(pair.bwd, gs))


def build_pair(pair_kind: str, csr_fwd: CSRData, csr_bwd: CSRData, mesh: Ring):
    """The (forward, backward) pair of ``pair_kind`` from the host CSR
    matrices, on the partitions' devices: "coo" a :class:`DistAggPair`,
    "gather" a :class:`DistGatherPair`, "halo" / "halo_gather" a
    :class:`~.dist_halo.DistHaloPair` whose local products run on the COO
    engine / the serial-gather kernel."""
    if pair_kind == "coo":
        return DistAggPair.from_csr_pair(csr_fwd, csr_bwd, mesh)
    if pair_kind == "gather":
        return DistGatherPair.from_csr_pair(csr_fwd, csr_bwd, mesh)
    if pair_kind in ("halo", "halo_gather"):
        from .dist_halo import DistHaloPair

        engine = "gather" if pair_kind == "halo_gather" else "xla"
        return DistHaloPair.from_csr_pair(csr_fwd, csr_bwd, mesh, engine=engine)
    raise ValueError(f"unknown pair_kind {pair_kind!r} (expected coo, gather, halo or halo_gather)")


def _update_replicas(params, opt_state, grads, mesh: Ring, hp: dict, optimizer: str):
    """Every replica of the parameters updated from the same summed
    gradients: (params, opt_state) lists. The gradients go to every
    replica's device first (``psum``), then each replica is updated
    (``adam-update``)."""
    leaves = [v for layer in grads for v in layer.values()]
    with torch.no_grad():
        with scope("psum"):
            for dev in mesh.replica_devices:
                if dev != leaves[0].device:
                    _landed(mesh.first + mesh.devices.index(dev), leaves)
            replica_grads = [_to(grads, dev) for dev in mesh.replica_devices]
        new_params, new_state = [], []
        with scope("adam-update"):
            for p, st, g in zip(params, opt_state, replica_grads):
                if optimizer == "sgd":  # linear::update (gcn.hpp:141-144); the state rides unchanged
                    p = adam.sgd_update(p, g, hp["lr"], hp["weight_decay"])
                else:
                    p, st = adam.adam_update(p, g, st, **hp)
                new_params.append(p)
                new_state.append(st)
    return new_params, new_state


def make_dist_train_step(
    config: GCNConfig,
    mesh: Ring,
    n_total: int,
    hparams: dict | None = None,
    strategy: str = "ring",
    pair_kind: str = "coo",
    pattern_dtype: str = "bfloat16",
    optimizer: str = "adam",
):
    """The distributed train step (``mg_gcn_tpu/parallel/dist.py:808-985``):

        step(params, opt_state, pair, xs, ys, masks=None)
            -> (params, opt_state, loss, acc)

    ``params`` and ``opt_state`` are :func:`replicate`'s lists, one copy per
    distinct device, returned updated alike; ``pair`` a :class:`DistAggPair`
    (``pair_kind="coo"``), a :class:`DistPatternPair` (``"pattern"``), a
    :class:`DistGatherPair` (``"gather"``) or a
    :class:`~.dist_halo.DistHaloPair` (``"halo"``, or ``"halo_gather"`` on
    the serial-gather engine); the gather and halo kinds take the ring
    exchange only. ``xs`` / ``ys`` / ``masks`` are :func:`shard`'s lists
    (for the pattern pair of ``pair.n_pad`` rows, with a mask of the real
    rows). ``config.parity`` picks the reference-parity backward or exact
    autograd; loss and acc lie on the first partition's device."""
    _check_pair_kind(pair_kind, strategy, STRATEGIES)
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    hp = dict(adam.DEFAULT_HPARAMS)
    if hparams:
        hp.update(hparams)
    lag = dist_loss_and_grad if config.parity else dist_loss_and_grad_exact

    def step(params, opt_state, pair, xs, ys, masks=None):
        with scope("train-step"):
            agg_fwd, agg_bwd = _aggregations(pair_kind, pair, strategy, pattern_dtype)
            per_part = [params[mesh.replica_of(i)] for i in range(len(mesh.devices))]
            loss, acc, grads = lag(per_part, agg_fwd, agg_bwd, xs, ys, config, n_total, masks, mesh=mesh)
            return (*_update_replicas(params, opt_state, grads, mesh, hp, optimizer), loss, acc)

    return step


SAGE_PAIRS = ("coo", "halo", "gather", "halo_gather")


def sage_aggregation(pair_kind: str, pair, strategy: str = "ring") -> Callable:
    """SAGE's differentiable aggregation over the partitions, hs -> M·H's
    blocks: the gradient multiplies by ``pair.bwd`` (Mᵀ) through
    :class:`_ExactAgg`, as the one-card SAGE's ``aggregate`` does (the
    JAX package's autodiff through ``ppermute`` on the halo pair computes
    the same product)."""
    _check_pair_kind(pair_kind, strategy, SAGE_PAIRS)
    agg_fwd, agg_bwd = _aggregations(pair_kind, pair, strategy, "float32")
    return lambda hs: list(_ExactAgg.apply(agg_fwd, agg_bwd, *hs))


def make_dist_sage_train_step(
    config,
    mesh: Ring,
    n_total: int,
    hparams: dict | None = None,
    strategy: str = "ring",
    pair_kind: str = "coo",
):
    """The distributed GraphSAGE train step (``mg_gcn_tpu/parallel/dist.py:
    1042-1213``), exact gradients, Adam (decaying ``Wself`` and ``Wneigh``):

        step(params, opt_state, pair, xs, ys, masks=None)
            -> (params, opt_state, loss, acc)

    ``pair`` is built from the mean pair (M, Mᵀ), M the row-normalized
    adjacency: a :class:`DistAggPair` (``"coo"``, ring or all_gather), a
    :class:`DistGatherPair` (``"gather"``) or a
    :class:`~.dist_halo.DistHaloPair` (``"halo"``, ``"halo_gather"``),
    aggregated by :func:`sage_aggregation`."""
    _check_pair_kind(pair_kind, strategy, SAGE_PAIRS)
    hp = dict(adam.DEFAULT_HPARAMS)
    if hparams:
        hp.update(hparams)

    def step(params, opt_state, pair, xs, ys, masks=None):
        with scope("train-step"):
            per_part = [params[mesh.replica_of(i)] for i in range(len(mesh.devices))]
            loss, acc, grads = dist_sage_loss_and_grad(per_part, sage_aggregation(pair_kind, pair, strategy), xs,
                                                       ys, config, n_total, masks, mesh=mesh)
            return (*_update_replicas(params, opt_state, grads, mesh, hp, "adam"), loss, acc)

    return step


def make_dist_infer(config: GCNConfig, mesh: Ring, strategy: str = "ring"):
    """Row-partitioned forward pass (``mg_gcn_tpu/parallel/dist.py:988-1033``):
    ``infer(params, pair, xs)`` -> the partitions' logits, for a COO
    :class:`DistAggPair` and :func:`replicate`'s parameters."""
    if strategy not in STRATEGIES["coo"]:
        raise ValueError(f"unknown dist spmm strategy {strategy!r}")

    def infer(params, pair: DistAggPair, xs):
        per_part = [params[mesh.replica_of(i)] for i in range(len(mesh.devices))]
        with torch.no_grad():
            return gcn.forward_blocks(per_part, lambda hs: dist_aggregate(pair.fwd, hs, strategy), xs, config)

    return infer
