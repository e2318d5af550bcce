"""1-D row-partitioned GCN training over P partitions driven by one process.

Port of ``mg_gcn_tpu/parallel/dist.py`` (the CLI's ``-P N -R 1`` path). The
JAX package runs it as one program over a device mesh (``shard_map``); the
reference as one host process driving P GPUs (dist_matrix.hpp:30). The port
does as the reference does: one process drives P partitions, each placed on
a ``torch.device``, and several partitions may share a card (``[cuda:0] * 4``,
like the JAX package's virtual CPU devices). The mapping:

* the mesh -> :class:`Ring`, the ordered partition devices (:func:`make_mesh`);
* an array sharded over the mesh -> a list of P tensors, partition j's on its
  device (:func:`shard`);
* ``lax.ppermute`` -> a copy of the neighbour's block into a buffer on this
  partition's device (a peer copy when the two lie on different cards);
* ``lax.psum`` / ``lax.pmax`` -> a sum / max over the partitions in partition
  order on one device, so that a run repeats bit for bit;
* replicated parameters and optimizer state -> one copy per distinct device
  (:func:`replicate`), each updated from the same summed gradients.

The pairs: COO ring blocks (:class:`DistAggPair`), the bit-packed pattern
pair (:class:`DistPatternPair`), ring blocks on the serial-gather kernel
(:class:`DistGatherPair`) and the halo exchange (``parallel/dist_halo.py``).
GCN trains on each (:func:`make_dist_train_step`), GraphSAGE on all but the
pattern pair (:func:`make_dist_sage_train_step`).

The exchange runs on the partitions' current streams, before the products
that read it; overlapping the two is later work (ROADMAP queue 1 item 9h).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, sparse
from ..formats import CSRData
from ..models.gcn import GCNConfig
from ..nn import adam
from ..ops import elementwise as ew
from ..ops import spmm_pattern as sp
from ..ops.softmax_xent import softmax
from ..ops.spmm import COOMat, spmm
from ..ops.spmm_gather import GatherMat, spmm_gather
from ..ops.spmm_pattern_ring import ring_pattern_bwd, ring_pattern_fwd

STRATEGIES = {"coo": ("ring", "all_gather"), "pattern": ("ring", "all_gather", "fused"), "gather": ("ring",),
              "halo": ("ring",), "halo_gather": ("ring",)}


@dataclass(frozen=True)
class Ring:
    """The partitions' devices in ring order (the JAX package's 1-D mesh)."""

    devices: tuple[torch.device, ...]

    @property
    def parts(self) -> int:
        return len(self.devices)

    @property
    def replica_devices(self) -> tuple[torch.device, ...]:
        """The distinct devices, in order of first appearance: one replica of
        the parameters each."""
        return tuple(dict.fromkeys(self.devices))

    def replica_of(self, j: int) -> int:
        """Index into :attr:`replica_devices` of partition j's device."""
        return self.replica_devices.index(self.devices[j])


def make_mesh(num_devices: int | None = None, devices=None) -> Ring:
    """The ring of partitions (``mg_gcn_tpu/parallel/dist.py:54-72``).

    With ``devices=None``: ``cuda:0 .. cuda:{P-1}``, P = ``num_devices`` or
    every visible card; fewer visible cards than P raises, never a smaller
    ring. An explicit ``devices`` list may repeat a device: ``["cuda:0"] * 4``
    puts four partitions on one card, ``["cpu"] * P`` all on the CPU."""
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
        devs.append(dev)
    if not devs or (num_devices is not None and len(devs) != num_devices):
        raise ValueError(f"make_mesh({num_devices}) with {len(devs)} device(s)")
    return Ring(tuple(devs))


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
    row blocks, partition j's on its device."""
    t = torch.as_tensor(x)
    if t.shape[0] % mesh.parts:
        raise ValueError(f"{t.shape[0]} rows do not split into {mesh.parts} equal partitions")
    m = t.shape[0] // mesh.parts
    return [t[j * m : (j + 1) * m].to(dev) for j, dev in enumerate(mesh.devices)]


def shard_dataset(ds, mesh: Ring, n_rows: int | None = None, mask_train: bool = False):
    """(xs, ys, masks): the dataset's float32 features, int64 labels and
    loss mask on the partitions. Rows are padded with zeros to ``n_rows``
    (the pattern pair's n_pad) and the mask then keeps the real rows
    (``mg_gcn_tpu/cli.py:556-567``); ``mask_train`` keeps the train set
    (sets == 0) only. ``masks`` is None when every row counts."""
    n = ds.num_nodes
    n_rows = n if n_rows is None else n_rows
    x = np.zeros((n_rows, ds.num_features), np.float32)
    x[:n] = ds.features
    y = np.zeros(n_rows, np.int64)
    y[:n] = ds.labels.reshape(-1)
    mask = np.zeros(n_rows, bool)
    mask[:n] = ds.sets.reshape(-1) == 0 if mask_train else True
    masks = shard(mask, mesh) if mask_train or n_rows > n else None
    return shard(x, mesh), shard(y, mesh), masks


def reduce_parts(xs: Sequence[torch.Tensor], op: Callable) -> torch.Tensor:
    """``op`` folded over the partitions' tensors in partition order, on the
    first partition's device (psum with torch.add, pmax with torch.maximum)."""
    out = xs[0]
    for x in xs[1:]:
        out = op(out, x.to(out.device))
    return out


def _psum_trees(trees: Sequence) -> list[dict]:
    """The per-partition gradient trees summed leaf by leaf (psum)."""
    return [{k: reduce_parts([t[i][k] for t in trees], torch.add) for k in layer} for i, layer in enumerate(trees[0])]


def _copy_to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``x`` in a new buffer on ``device`` (a peer copy across cards)."""
    return torch.empty_like(x, device=device).copy_(x)


def _ppermute(blocks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One ring hop (JAX's ``_ring_perm``, dist.py:318-321): partition j
    receives the block partition j+1 held."""
    p = len(blocks)
    return [_copy_to(blocks[(j + 1) % p], blocks[j].device) for j in range(p)]


def _slots(blocks: Sequence[torch.Tensor], j: int, order) -> torch.Tensor:
    """Partition j's (len(order), *block) buffer: slot s the copy of block
    ``order[s]`` (its own block copied too)."""
    own = blocks[j]
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

    ``rows[j]`` / ``cols[j]`` / ``vals[j]`` are partition j's (P, E) arrays on
    its device: entry [s] is the COO block A[j, (j+s) % P] with row ids local
    to row slab j and column ids local to column block (j+s) % P. Padding
    entries have val == 0, row = last local row, col = 0.
    """

    rows: list[torch.Tensor]  # int32 (P, E) each
    cols: list[torch.Tensor]
    vals: list[torch.Tensor]  # float32 (P, E) each
    n: int  # global rows (== cols; square)
    parts: int
    nnz: int

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
        emax = max(blocks[j][k].nnz for j in range(parts) for k in range(parts))
        emax = max(sp.round_up(emax, COO_RING_PAD), COO_RING_PAD)
        m_loc = n // parts
        rows = np.full((parts, parts, emax), m_loc - 1, np.int32)
        cols = np.zeros((parts, parts, emax), np.int32)
        vals = np.zeros((parts, parts, emax), np.float32)
        for j in range(parts):
            for s in range(parts):
                blk = blocks[j][(j + s) % parts]  # ring order
                e = blk.nnz
                rows[j, s, :e] = np.repeat(np.arange(m_loc, dtype=np.int32), np.diff(blk.indptr))
                cols[j, s, :e] = blk.indices
                vals[j, s, :e] = blk.data
        put = lambda a: [torch.from_numpy(a[j]).to(dev) for j, dev in enumerate(mesh.devices)]  # noqa: E731
        return DistRowMat(rows=put(rows), cols=put(cols), vals=put(vals), n=n, parts=parts, nnz=csr.nnz)


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
    """C_j = Σ_s A[j, (j+s) % P] @ B_{(j+s) % P} for every partition j
    (``mg_gcn_tpu/parallel/dist.py:439-477``); ``hs`` are the (n/P, d) row
    blocks. ``ring``: P rounds of local products, the blocks moving one hop
    between rounds. ``all_gather``: every partition gathers all blocks, then
    one product over its concatenated edges (the reference's ``-S``)."""
    parts, m = mat.parts, mat.rows_per_shard
    if strategy == "all_gather":
        out = []
        for j, h in enumerate(hs):
            b_full = torch.cat([x.to(h.device) for x in hs])  # (n, d), partition order
            block_ids = torch.remainder(j + torch.arange(parts, device=h.device), parts)
            cols = mat.cols[j].long() + block_ids[:, None] * m
            out.append(_block_spmm(mat.rows[j].reshape(-1), cols.reshape(-1), mat.vals[j].reshape(-1), b_full, m))
        return out
    if strategy != "ring":
        raise ValueError(f"unknown dist spmm strategy {strategy!r}")
    cs = [torch.zeros((m, h.shape[1]), dtype=h.dtype, device=h.device) for h in hs]
    blocks = list(hs)
    for s in range(parts):
        for j in range(parts):
            cs[j] += _block_spmm(mat.rows[j][s], mat.cols[j][s], mat.vals[j][s], blocks[j], m)
        if s + 1 < parts:
            blocks = _ppermute(blocks)
    return cs


# ---------------------------------------------------------------------------
# the serial-gather ring pair


@dataclass(frozen=True)
class DistGatherMat:
    """Row-partitioned sparse matrix as ring-ordered blocks on the
    serial-gather kernel (``mg_gcn_tpu/parallel/dist.py:330-380``):
    ``blocks[j][s]`` is the weighted CSR block A[j, (j+s) % P] (m_loc ×
    m_loc) on partition j's device, the TPU's padded schedules' counterpart."""

    blocks: list[list[GatherMat]]
    n: int
    parts: int
    nnz: int

    @property
    def rows_per_shard(self) -> int:
        return self.n // self.parts

    @staticmethod
    def from_csr(csr: CSRData, mesh: Ring) -> "DistGatherMat":
        """Build each partition's blocks on its device from its row slab."""
        n, parts = csr.nrows, mesh.parts
        if n % parts:
            raise ValueError(f"n ({n}) must be divisible by the mesh size ({parts})")
        m = n // parts
        blocks = []
        for j, dev in enumerate(mesh.devices):
            split = column_blocks(row_slab(csr, j, m), parts, dev)
            blocks.append([gather_block(*split[(j + s) % parts], m, m) for s in range(parts)])
            del split
        return DistGatherMat(blocks=blocks, n=n, parts=parts, nnz=csr.nnz)


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
    cs: list = [None] * parts
    blocks = list(hs)
    for s in range(parts):
        for j in range(parts):
            prod = spmm_gather(mat.blocks[j][s], blocks[j])
            cs[j] = prod if s == 0 else cs[j] + prod
        if s + 1 < parts:
            blocks = _ppermute(blocks)
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
    2·P·m_loc²/8 bytes of packs, on its device.
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
        packs = [_ring_packs(csr, m, j, parts, dev) for j, dev in enumerate(mesh.devices)]
        return DistPatternPair(
            pack_fwd=[f for f, _ in packs],
            pack_bwd=[b for _, b in packs],
            scale=[torch.from_numpy(s_vec[j * m : (j + 1) * m]).to(dev) for j, dev in enumerate(mesh.devices)],
            n=n, n_pad=m * parts, parts=parts, m_loc=m, dtype_name=dtype, nnz=csr.nnz,
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
    partition. int8: one global per-feature scale, the max over all
    partitions (pmax), so every partition quantizes as the single-card path
    does; int32 sums.
    """
    if strategy not in STRATEGIES["pattern"]:
        raise ValueError(f"unknown dist spmm strategy {strategy!r}")
    dtype_name = dtype_name or pair.dtype_name
    parts, m = pair.parts, pair.m_loc
    d = hs[0].shape[1]
    d_pad = sp.round_up(max(d, 8), 8)
    op_dt = sp.DTYPES[dtype_name]
    acc_dt = torch.int32 if op_dt == torch.int8 else torch.float32
    forward = orientation == "PT"
    packs = pair.pack_fwd if forward else pair.pack_bwd
    hs = [h.to(torch.float32) for h in hs]
    if not forward:  # pre-scale the own block (before int8 quantizing, too)
        hs = [h * sc[:, None] for h, sc in zip(hs, pair.scale)]
    qscale = [None] * parts
    if op_dt == torch.int8:
        amax = torch.clamp(reduce_parts([torch.amax(torch.abs(h), dim=0) for h in hs], torch.maximum), min=1e-30)
        # a tensor divisor: CUDA turns division by a Python scalar into a
        # multiply by its reciprocal (ROADMAP queue 3)
        qscale = [q / torch.full_like(q, 127.0) for q in (amax.to(h.device) for h in hs)]
    blocks = []
    for h, q in zip(hs, qscale):
        blk = torch.zeros((m, d_pad), dtype=op_dt, device=h.device)
        blk[:, :d] = (h if q is None else torch.clamp(torch.round(h / q[None, :]), -127, 127)).to(op_dt)
        blocks.append(blk)

    if strategy == "fused":
        # one launch a partition over its P slots; at P = 1 the kernel runs
        # one round (the JAX package swaps to "ring" there, dist.py:509-512,
        # because its RDMA kernel needs a peer; this one reads no peer)
        ring = ring_pattern_fwd if forward else ring_pattern_bwd
        accs = [ring(packs[j], _slots(blocks, j, [(j + s) % parts for s in range(parts)])) for j in range(parts)]
    else:
        call = sp.pattern_fwd if forward else sp.pattern_bwd
        accs = [torch.zeros((m, d_pad), dtype=acc_dt, device=b.device) for b in blocks]
        if strategy == "all_gather":
            for j in range(parts):
                gathered = _slots(blocks, j, range(parts))  # partition order
                for s in range(parts):
                    accs[j] += call(packs[j][s], gathered[(j + s) % parts])
        else:
            for s in range(parts):
                for j in range(parts):
                    accs[j] += call(packs[j][s], blocks[j])
                if s + 1 < parts:
                    blocks = _ppermute(blocks)
    out = []
    for acc, q, sc in zip(accs, qscale, pair.scale):
        c = acc[:, :d].to(torch.float32)
        if q is not None:
            c = c * q[None, :]
        out.append(c * sc[:, None] if forward else c)
    return out


# ---------------------------------------------------------------------------
# the step


def _dist_layer_forward(layers, meta: dict, agg_fwd, hs, slope: float):
    """One GCN layer on every partition; ``layers[j]`` is the layer's
    parameters on partition j's device. Returns (outputs, cache)."""
    if meta["lin_first"]:
        ahw = agg_fwd([h @ lp["W"] + lp["b"] for h, lp in zip(hs, layers)])
    else:
        ahw = [a @ lp["W"] + lp["b"] for a, lp in zip(agg_fwd(hs), layers)]
    if meta["activation"]:
        ahw = [ew.leaky_relu(a, slope) for a in ahw]
    if meta["res_proj"]:
        ahw = [a + h @ lp["Wres"] + lp["bres"] for a, h, lp in zip(ahw, hs, layers)]
    elif meta["res_identity"]:
        ahw = [a + h for a, h in zip(ahw, hs)]
    return ahw, dict(h=hs, post=ahw)


def _dist_layer_backward(layers, meta: dict, agg_bwd, cache: dict, gs, slope: float, need_input_grad: bool):
    """Reference-parity backward of one layer on every partition
    (gcn.hpp:460-489): the partitions' local gradients (summed later) and
    the input gradients."""
    ts = [ew.leaky_relu_grad(p, g, slope) for p, g in zip(cache["post"], gs)] if meta["activation"] else gs
    g_out = None
    if meta["lin_first"]:
        src = agg_bwd(ts) if meta["backward_spmm"] else ts
        if need_input_grad:
            g_out = [x @ lp["W"].T for x, lp in zip(src, layers)]
    else:
        src = ts  # the layer input, not ÂH (lin.setX(H), gcn.hpp:477)
        if need_input_grad:
            g_hw = [t @ lp["W"].T for t, lp in zip(ts, layers)]
            g_out = agg_bwd(g_hw) if meta["backward_spmm"] else g_hw
    grads = [dict(b=torch.sum(x, dim=0, keepdim=True), W=h.T @ x) for x, h in zip(src, cache["h"])]
    if meta["res_proj"]:
        for gr, g, h in zip(grads, gs, cache["h"]):
            gr["bres"], gr["Wres"] = torch.sum(g, dim=0, keepdim=True), h.T @ g
        if g_out is not None:
            g_out = [o + g @ lp["Wres"].T for o, g, lp in zip(g_out, gs, layers)]
    elif meta["res_identity"] and g_out is not None:
        g_out = [o + g for o, g in zip(g_out, gs)]
    return grads, g_out


def _dist_softmax_xent(logits, ys, n_total: int, masks):
    """Row-local softmax + NLL with partition-summed scalars (gcn.hpp:890-929):
    (loss, acc, per-partition logits gradients)."""
    probs = [softmax(lg) for lg in logits]
    terms, grads = [], []
    if masks is None:
        denom = torch.tensor(float(n_total), device=logits[0].device)
    else:
        ms = [mk.to(torch.float32) for mk in masks]
        denom = torch.clamp(reduce_parts([torch.sum(mk) for mk in ms], torch.add), min=1)
    for j, (o, y) in enumerate(zip(probs, ys)):
        y = y.long()
        logp = torch.log(torch.clamp(torch.gather(o, 1, y[:, None])[:, 0], min=torch.finfo(o.dtype).tiny))
        correct = (torch.argmax(o, dim=-1) == y).to(o.dtype)
        g = o - F.one_hot(y, o.shape[1]).to(o.dtype)
        dn = denom.to(o.device)
        if masks is None:
            terms.append((torch.sum(logp), torch.sum(correct)))
            grads.append(g / dn)
        else:
            terms.append((torch.sum(logp * ms[j]), torch.sum(correct * ms[j])))
            grads.append(g * ms[j][:, None] / dn)
    loss = -reduce_parts([t[0] for t in terms], torch.add) / denom
    acc = reduce_parts([t[1] for t in terms], torch.add) / denom
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


def dist_loss_and_grad(params, agg_fwd, agg_bwd, xs, ys, config: GCNConfig, n_total: int, masks=None):
    """Forward and reference-parity backward over the partitions
    (``mg_gcn_tpu/parallel/dist.py:718-752``). ``params[j]`` is the
    parameter tree on partition j's device; ``agg_fwd`` / ``agg_bwd`` map the
    partitions' blocks to theirs. Returns (loss, acc, grads), the gradients
    summed over the partitions in partition order, on the first partition's
    device. Layer 0 skips its backward product, as the reference does."""
    with torch.no_grad():
        hs, caches = xs, []
        for i in range(config.num_layers):
            hs, cache = _dist_layer_forward([p[i] for p in params], config.layer_meta(i), agg_fwd, hs,
                                            config.leaky_slope)
            caches.append(cache)
        loss, acc, gs = _dist_softmax_xent(hs, ys, n_total, masks)
        local: list = [[None] * config.num_layers for _ in params]
        for i in reversed(range(config.num_layers)):
            grads, gs = _dist_layer_backward([p[i] for p in params], config.layer_meta(i), agg_bwd, caches[i], gs,
                                             config.leaky_slope, need_input_grad=i > 0)
            for j, g in enumerate(grads):
                local[j][i] = g
    return loss, acc, _psum_trees(local)


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


def _exact_loss_and_grad(params, logits_of: Callable, ys, n_total: int, masks):
    """(loss, acc, grads) of the partitions' summed local loss shares by one
    backward pass: each partition has its own parameter leaves,
    ``logits_of(leaves)`` gives the partitions' logits, and the leaves'
    gradients are summed over the partitions afterwards."""
    leaves = [[{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in p] for p in params]
    if masks is None:
        ms = [None] * len(ys)
        denom = torch.tensor(float(n_total), device=ys[0].device)
    else:
        ms = [mk.to(torch.float32) for mk in masks]
        denom = torch.clamp(reduce_parts([torch.sum(mk) for mk in ms], torch.add), min=1.0)
    with torch.enable_grad():
        terms = [_local_xent_terms(h, y, m, denom.to(h.device)) for h, y, m in zip(logits_of(leaves), ys, ms)]
        flat = [v for p in leaves for layer in p for v in layer.values()]
        flat_grads = iter(torch.autograd.grad([t[0] for t in terms], flat))
    local = [[{k: next(flat_grads) for k in layer} for layer in p] for p in leaves]
    loss = reduce_parts([t[0].detach() for t in terms], torch.add)
    acc = reduce_parts([t[1] for t in terms], torch.add)
    return loss, acc, _psum_trees(local)


def dist_loss_and_grad_exact(params, agg_fwd, agg_bwd, xs, ys, config: GCNConfig, n_total: int, masks=None):
    """Exact-autograd twin of :func:`dist_loss_and_grad` (config.parity
    False, CLI ``--exact``; ``mg_gcn_tpu/parallel/dist.py:774-805``): one
    backward pass through :class:`_ExactAgg` gives each partition's leaves
    the gradient of the partitions' local loss shares."""
    agg = lambda hs: list(_ExactAgg.apply(agg_fwd, agg_bwd, *hs))  # noqa: E731

    def logits_of(leaves):
        hs = xs
        for i in range(config.num_layers):
            hs, _ = _dist_layer_forward([p[i] for p in leaves], config.layer_meta(i), agg, hs, config.leaky_slope)
        return hs

    return _exact_loss_and_grad(params, logits_of, ys, n_total, masks)


def dist_sage_loss_and_grad(params, agg, xs, ys, config, n_total: int, masks=None):
    """GraphSAGE's loss and exact gradients over the partitions
    (``mg_gcn_tpu/parallel/dist.py:1151-1174``): ``agg`` maps the
    partitions' blocks to their M·H blocks, differentiably; each layer is
    ``h·W_self + M h·W_neigh + b``, LeakyReLU and the per-node l2
    normalization between layers (``models/sage.py``). Returns (loss, acc,
    grads), summed over the partitions in partition order."""
    from ..models.sage import l2_norm_rows

    def logits_of(leaves):
        hs = xs
        for i in range(config.num_layers):
            lps = [p[i] for p in leaves]
            hs = [h @ lp["Wself"] + nb @ lp["Wneigh"] + lp["b"] for h, nb, lp in zip(hs, agg(hs), lps)]
            if i + 1 < config.num_layers:
                hs = [ew.leaky_relu(h, config.leaky_slope) for h in hs]
                if config.l2_normalize:
                    hs = [l2_norm_rows(h) for h in hs]
        return hs

    return _exact_loss_and_grad(params, logits_of, ys, n_total, masks)


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
    gradients: (params, opt_state) lists."""
    new_params, new_state = [], []
    with torch.no_grad():
        for p, st, dev in zip(params, opt_state, mesh.replica_devices):
            g = _to(grads, dev)
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
        agg_fwd, agg_bwd = _aggregations(pair_kind, pair, strategy, pattern_dtype)
        per_part = [params[mesh.replica_of(j)] for j in range(mesh.parts)]
        loss, acc, grads = lag(per_part, agg_fwd, agg_bwd, xs, ys, config, n_total, masks)
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
        per_part = [params[mesh.replica_of(j)] for j in range(mesh.parts)]
        loss, acc, grads = dist_sage_loss_and_grad(per_part, sage_aggregation(pair_kind, pair, strategy), xs, ys,
                                                   config, n_total, masks)
        return (*_update_replicas(params, opt_state, grads, mesh, hp, "adam"), loss, acc)

    return step


def make_dist_infer(config: GCNConfig, mesh: Ring, strategy: str = "ring"):
    """Row-partitioned forward pass (``mg_gcn_tpu/parallel/dist.py:988-1033``):
    ``infer(params, pair, xs)`` -> the partitions' logits, for a COO
    :class:`DistAggPair` and :func:`replicate`'s parameters."""
    if strategy not in STRATEGIES["coo"]:
        raise ValueError(f"unknown dist spmm strategy {strategy!r}")

    def infer(params, pair: DistAggPair, xs):
        per_part = [params[mesh.replica_of(j)] for j in range(mesh.parts)]
        with torch.no_grad():
            hs = xs
            for i in range(config.num_layers):
                hs, _ = _dist_layer_forward([p[i] for p in per_part], config.layer_meta(i),
                                            lambda b: dist_aggregate(pair.fwd, b, strategy), hs, config.leaky_slope)
        return hs

    return infer
