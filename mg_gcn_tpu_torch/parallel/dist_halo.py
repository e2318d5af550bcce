"""Halo-exchange row partition: only the feature rows a partition references
cross to it.

Port of ``mg_gcn_tpu/parallel/dist_halo.py`` for P partitions driven by one
process or split over several (``parallel/dist.py``'s :class:`~.dist.Ring`).
The reference's row
partition broadcasts every owner's whole feature block each round
(dist_matrix.hpp:458-467); here partition j receives, in round s, only the
distinct rows its block A[j, k] references, k = (j+s+1) mod P:

* build (:func:`halo_slab_blocks`, :meth:`DistHaloMat.from_slabs`): row
  slab j splits by column block on partition j's device. The diagonal block
  A[j, j] keeps local columns; each other block A[j, k] computes in round
  s = (k - j - 1) mod P, its columns rebased into the sorted distinct
  columns it references (``torch.unique(sorted=True, return_inverse=True)``),
  which are what k sends to j in round s (``send_idx[k][s]``). One slab at a
  time, so a large graph never holds P slabs of temporaries at once. A
  process reads only its own partitions' slabs (``from_slabs``'s
  ``slab_of``, ``from_pigo``'s reads of ``graph.bin`` and ``graph_t.bin``);
  the round widths, entry count and useful volume are agreed across
  processes, and a receive list whose sender is another process is shipped
  to it once, at build.
* product (:func:`dist_aggregate_halo`): C_j = A[j, j] h_j, then for
  s = 0..P-2 C_j += A[j, k] h_k[send_idx[k][s]]: each owner k gathers its
  round's rows (``index_select``), the route moves them to j (a copy onto j's
  device, or a message when another process owns j; the JAX package's
  ``ppermute`` with perm (i, (i - s - 1) mod P)), and j multiplies its block
  by them. One process runs partition by partition, one halo buffer alive
  at a time; across processes every round's messages go in one batch, so
  the round's buffers of this process's partitions are alive together.

Every block is row-sorted CSR holding only its real entries, multiplied by
the COO engine (:class:`DistHaloMat`) or by the serial-gather kernel,
weighted, float32 (:class:`DistHaloGatherMat`; the TPU's schedules, their
padding and the thin-group scatter remainder ``_split_scatter`` have no
counterpart: a block walks every entry). The send lists are padded as the
JAX package pads them at its default ``pad_to=512`` (index 0, each round to
a multiple of SEND_PAD = min(512, 128) rows, at least that many), so
``round_widths``, ``halo_total`` and the exchanged volume agree with it
number for number; a padded row of a halo buffer is received and never
read.

``DistHaloPair.from_pigo`` builds the normalized pair from the files, each
process reading its row slabs only: process 0 streams the normalization
diagonal (``formats.read_pigo_row_sums``, written nowhere) and broadcasts
it, so no process but the first reads a whole file's values.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ..formats import CSRData
from ..ops.spmm import COOMat, spmm
from ..ops.spmm_gather import GatherMat
from ..timers import scope
from . import multihost
from .dist import Ring, _copy_to, _landed, _permute, column_blocks, gather_block, row_slab


SEND_PAD = 128


def _round_up(x: int, to: int) -> int:
    return max((x + to - 1) // to * to, to)


def halo_slab_blocks(slab: CSRData, j: int, parts: int, device: torch.device):
    """Partition j's halo blocks from its row slab alone (rows [j·m, (j+1)·m)
    with global column ids), built on ``device``
    (``mg_gcn_tpu/parallel/dist_halo.py:53-92``). Returns (loc, compact,
    recv):

      loc        = (rows, cols, vals) of the diagonal block A[j, j]
      compact[s] = (rows, halo_cols, vals) of block A[j, (j+s+1) % P], its
                   columns rebased into halo positions [0, len(recv[s]))
      recv[s]    = the sorted local row ids partition (j+s+1) % P sends to j
                   in round s

    rows and columns int64, values float32, each block in CSR order."""
    split = column_blocks(slab, parts, device)
    loc, compact, recv = split[j], [None] * (parts - 1), [None] * (parts - 1)
    for k in range(parts):
        if k == j:
            continue
        s = (k - j - 1) % parts  # the round in which A[j, k] computes
        rows, cols, vals = split[k]
        split[k] = None
        recv[s], halo_cols = torch.unique(cols, sorted=True, return_inverse=True)
        compact[s] = (rows, halo_cols, vals)
    return loc, compact, recv


@dataclass(frozen=True)
class DistHaloMat:
    """Row-partitioned sparse matrix with compact halo exchange lists
    (``mg_gcn_tpu/parallel/dist_halo.py:155-392``), on the COO engine.
    For this process's i-th partition j, on its device, S = P - 1 rounds:

      loc[i]         the diagonal block A[j, j] (m_loc × m_loc)
      rem[i][s]      block A[j, (j+s+1) % P] (m_loc × round_widths[s]),
                     columns in round s's halo positions
      send_idx[i][s] int64 (round_widths[s],): the local rows partition j
                     sends in round s, to (j-s-1) % P; padding 0

    ``ring`` is the ring it was built for; the widths, ``nnz`` and
    ``halo_total`` are the whole matrix's, on every process.
    """

    loc: list
    rem: list[list]
    send_idx: list[list[torch.Tensor]]
    n: int
    parts: int
    nnz: int
    halo_width: int  # the widest round's padded width
    halo_total: int  # the sum of the unpadded halos: the useful volume, in rows
    round_widths: tuple  # (w_0, ..., w_{S-1}), padded
    ring: Ring

    @property
    def rows_per_shard(self) -> int:
        return self.n // self.parts

    @staticmethod
    def block(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, n_out: int, n_in: int):
        """A block's local product operator: a COO block of real entries."""
        return COOMat(rows=rows.to(torch.int32), cols=cols.to(torch.int32), vals=vals, n_rows=n_out, n_cols=n_in,
                      nnz=rows.numel())

    @classmethod
    def from_csr(cls, csr: CSRData, mesh: Ring):
        """Build this process's partitions' blocks and send lists on their
        devices from the whole matrix, one row slab at a time."""
        m = csr.nrows // mesh.parts
        return cls.from_slabs(lambda j: row_slab(csr, j, m), csr.nrows, mesh, nnz=csr.nnz)

    @classmethod
    def from_pigo(cls, path: str, mesh: Ring):
        """Build from a PIGO-CSR file as it stands (no normalization), each
        process reading only its partitions' row slabs of it."""
        from ..formats import read_pigo_csr_slab, read_pigo_nrows

        n = read_pigo_nrows(path)
        m = n // mesh.parts
        return cls.from_slabs(lambda j: read_pigo_csr_slab(path, j * m, (j + 1) * m), n, mesh)

    @classmethod
    def from_slabs(cls, slab_of: Callable[[int], CSRData], n: int, mesh: Ring, nnz: int | None = None):
        """The per-process build (``mg_gcn_tpu/parallel/dist_halo.py:
        219-392``): ``slab_of(j)`` gives row slab j (rows [j·m, (j+1)·m),
        global column ids) and is called for this process's partitions only,
        one at a time. Across processes the round widths (the widest receive
        list of each round, padded) and the sums of the slabs' entries and of
        the unpadded halos are agreed by one gather, and a receive list whose
        sender is another process is shipped to it once (sender k's list for
        round s is receiver (k-s-1) % P's). ``nnz`` overrides the summed
        entry count. In one process the same build as ever."""
        parts = mesh.parts
        if n % parts:
            raise ValueError(
                f"n ({n}) must be divisible by the mesh size ({parts}); pad the "
                "dataset (dist_matrix.hpp:428 semantics)"
            )
        m, S = n // parts, parts - 1
        loc, compact, recv, my_nnz = [], [], [], 0
        for j, dev in zip(mesh.local, mesh.devices):
            slab = slab_of(j)
            my_nnz += slab.nnz
            lb, comp, rc = halo_slab_blocks(slab, j, parts, dev)
            del slab
            loc.append(cls.block(*lb, m, m))
            compact.append([(r.to(torch.int32), c.to(torch.int32), v) for r, c, v in comp])
            recv.append(rc)
            del lb, comp
        sizes = torch.tensor([max(rc[s].numel() for rc in recv) for s in range(S)]
                             + [my_nnz, sum(r.numel() for rc in recv for r in rc)], dtype=torch.int64)
        if mesh.world > 1:  # the widest list of each round; the sums
            every = torch.stack(multihost.all_gather(sizes))
            sizes = torch.cat([every[:, :S].amax(0), every[:, S:].sum(0)])
        widths = tuple(_round_up(int(w), SEND_PAD) for w in sizes[:S])
        rem = [[cls.block(*comp[s], m, widths[s]) for s in range(S)] for comp in compact]
        send_idx = [[] for _ in mesh.devices]
        for s in range(S):
            # receiver j's list, padded; sender k's list is receiver
            # (k - s - 1) % P's: one hop of shift -(s+1) from receiver to sender
            padded = []
            for rc, dev in zip(recv, mesh.devices):
                idx = torch.zeros(widths[s], dtype=torch.int64, device=dev)
                idx[: rc[s].numel()] = rc[s]
                padded.append(idx)
            for i, idx in enumerate(_permute(padded, -(s + 1) % parts, mesh, copy=False)):
                send_idx[i].append(idx)
        return cls(loc=loc, rem=rem, send_idx=send_idx, n=n, parts=parts,
                   nnz=int(sizes[S]) if nnz is None else nnz, halo_width=max(widths, default=0),
                   halo_total=int(sizes[S + 1]), round_widths=widths, ring=mesh)

    def comm_bytes_per_spmm(self, d: int, itemsize: int = 4, padded: bool = True) -> int:
        """The exchange volume of one product of d feature columns: what
        moves (every partition ships each round's padded width) or, with
        ``padded=False``, the useful volume."""
        rows = self.parts * sum(self.round_widths) if padded else self.halo_total
        return rows * d * itemsize


class DistHaloGatherMat(DistHaloMat):
    """:class:`DistHaloMat` with every local product on the serial-gather
    kernel (``mg_gcn_tpu/parallel/dist_halo.py:472-765``): the diagonal
    block (m_loc × m_loc) and each round's (m_loc × w_s) block are weighted
    :class:`~..ops.spmm_gather.GatherMat` s, walked in float32."""

    block = staticmethod(gather_block)


@dataclass
class DistHaloPair:
    """The (forward, backward) halo matrices: (Âᵀ, Â) for GCN, (M, Mᵀ) for
    SAGE's mean aggregation (``mg_gcn_tpu/parallel/dist_halo.py:865-877``)."""

    fwd: DistHaloMat
    bwd: DistHaloMat

    @staticmethod
    def from_csr_pair(csr_fwd: CSRData, csr_bwd: CSRData, mesh: Ring, engine: str = "xla") -> "DistHaloPair":
        """``engine`` is the local products' engine: "xla" (COO) or
        "gather" (the serial-gather kernel, :class:`DistHaloGatherMat`)."""
        make = _halo_class(engine).from_csr
        return DistHaloPair(make(csr_fwd, mesh), make(csr_bwd, mesh))

    @staticmethod
    def from_pigo(graph_path: str, graph_t_path: str, mesh: Ring, engine: str = "xla",
                  norm: str = "gcn") -> "DistHaloPair":
        """The normalized pair straight from ``graph.bin`` and its transpose
        ``graph_t.bin`` (``mg_gcn_tpu/parallel/dist_halo.py:879-995``),
        each process reading only its partitions' row slabs of both.

        ``norm="gcn"``: (fwd, bwd) = (Âᵀ, Â), Â = A with entry (r, c)
        divided by A's column sum c (main.cpp:143): Â's slab from
        ``graph.bin`` entry by entry, Âᵀ's from ``graph_t.bin`` row by row.
        ``norm="sage"``: (fwd, bwd) = (M, Mᵀ), M = A with row r divided by
        its sum: M's slab from ``graph.bin`` row by row, Mᵀ's from
        ``graph_t.bin`` entry by entry. The diagonal (the row sums of
        ``graph_t.bin`` for GCN, of ``graph.bin`` for SAGE, float64) is
        streamed on process 0 (``formats.read_pigo_row_sums``) and
        broadcast; each value is divided in float64 and rounded to float32
        once."""
        from ..formats import read_pigo_csr_slab, read_pigo_header, read_pigo_row_sums

        if norm not in ("gcn", "sage"):
            raise ValueError(f"unknown norm {norm!r} (gcn | sage)")
        make = _halo_class(engine).from_slabs
        h, h_t = read_pigo_header(graph_path), read_pigo_header(graph_t_path)
        n = h.nrows
        if n != h_t.nrows or h.nnz != h_t.nnz:
            raise ValueError(
                f"{graph_path} ({h.nrows} rows, {h.nnz} edges) and {graph_t_path} ({h_t.nrows} rows, {h_t.nnz}"
                " edges) are not a transposed pair — regenerate graph_t.bin (formats.ensure_pigo_transpose)"
            )
        if n % mesh.parts:
            raise ValueError(
                f"n ({n}) must be divisible by the mesh size ({mesh.parts}); pad "
                "the dataset (dist_matrix.hpp:428 semantics)"
            )
        m = n // mesh.parts
        diag_src = graph_t_path if norm == "gcn" else graph_path
        diag = multihost.broadcast_object(read_pigo_row_sums(diag_src) if multihost.process_index() == 0 else None)

        def row_scaled(path: str, j: int) -> CSRData:
            s = read_pigo_csr_slab(path, j * m, (j + 1) * m)
            scale = np.repeat(diag[j * m : (j + 1) * m], np.diff(s.indptr))
            return CSRData(s.indptr, s.indices, (s.data.astype(np.float64) / scale).astype(np.float32), s.shape)

        def entry_scaled(path: str, j: int) -> CSRData:
            s = read_pigo_csr_slab(path, j * m, (j + 1) * m)
            data = (s.data.astype(np.float64) / diag[s.indices.astype(np.int64)]).astype(np.float32)
            return CSRData(s.indptr, s.indices, data, s.shape)

        if norm == "gcn":
            fwd, bwd = functools.partial(row_scaled, graph_t_path), functools.partial(entry_scaled, graph_path)
        else:
            fwd, bwd = functools.partial(row_scaled, graph_path), functools.partial(entry_scaled, graph_t_path)
        return DistHaloPair(make(fwd, n, mesh), make(bwd, n, mesh))


def _halo_class(engine: str) -> type:
    if engine not in ("xla", "gather"):
        raise ValueError(f"unknown halo engine {engine!r} (expected xla or gather)")
    return DistHaloGatherMat if engine == "gather" else DistHaloMat


def _block_product(blk, b: torch.Tensor) -> torch.Tensor:
    if isinstance(blk, GatherMat) and torch.is_grad_enabled() and b.requires_grad:
        # the kernel has no backward: a gradient takes the backward matrix
        # (dist._ExactAgg), as every step does
        raise ValueError("the serial-gather halo blocks are not differentiable; aggregate them through "
                         "parallel.dist.sage_aggregation or _ExactAgg")
    return spmm(blk, b)


def dist_aggregate_halo(mat: DistHaloMat, hs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The halo-exchange product for this process's partitions: C_j =
    A[j, j] h_j, then round by round C_j += A[j, k] h_k[send_idx[k][s]] with
    k = (j+s+1) % P (``dist_aggregate_halo`` and, on a
    :class:`DistHaloGatherMat`, ``dist_aggregate_halo_gather`` of
    ``mg_gcn_tpu/parallel/dist_halo.py:821-862, 1019-1044``, in their sum
    order): each owner gathers its round's rows, they move to the receiver
    (a copy, or across processes ``dist._permute``'s message), the receiver
    multiplies. ``hs`` are the (m_loc, d) blocks; the result has their
    dtype. The steps take its gradient as the backward matrix's product
    (``dist._ExactAgg``), never by autograd through it."""
    parts = mat.parts
    if mat.ring.world == 1:  # partition by partition: one halo buffer alive at a time
        out = []
        for j, h in enumerate(hs):
            c = _block_product(mat.loc[j], h)
            for s in range(parts - 1):
                k = (j + s + 1) % parts
                with scope("exchange"):
                    halo = hs[k].index_select(0, mat.send_idx[k][s])
                    _landed(j, [halo])
                    if halo.device != h.device:
                        halo = _copy_to(halo, h.device)
                c = c + _block_product(mat.rem[j][s], halo)
                del halo
            out.append(c.to(h.dtype))
        return out
    cs = [_block_product(loc, h) for loc, h in zip(mat.loc, hs)]
    for s in range(parts - 1):  # a round's messages go in one batch
        sent = [h.index_select(0, idx[s]) for h, idx in zip(hs, mat.send_idx)]
        halos = _permute(sent, s + 1, mat.ring, copy=False)
        del sent
        cs = [c + _block_product(rem[s], halo) for c, rem, halo in zip(cs, mat.rem, halos)]
        del halos
    return [c.to(h.dtype) for c, h in zip(cs, hs)]
