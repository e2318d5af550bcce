"""Halo-exchange row partition: only the feature rows a partition references
cross to it.

Port of ``mg_gcn_tpu/parallel/dist_halo.py`` for P partitions driven by one
process (``parallel/dist.py``'s :class:`~.dist.Ring`). The reference's row
partition broadcasts every owner's whole feature block each round
(dist_matrix.hpp:458-467); here partition j receives, in round s, only the
distinct rows its block A[j, k] references, k = (j+s+1) mod P:

* build (:func:`halo_slab_blocks`, :meth:`DistHaloMat.from_csr`): row slab j
  splits by column block on partition j's device. The diagonal block A[j, j]
  keeps local columns; each other block A[j, k] computes in round
  s = (k - j - 1) mod P, its columns rebased into the sorted distinct
  columns it references (``torch.unique(sorted=True, return_inverse=True)``),
  which are what k sends to j in round s (``send_idx[k][s]``). One slab at a
  time, so a large graph never holds P slabs of temporaries at once.
* product (:func:`dist_aggregate_halo`): C_j = A[j, j] h_j, then for
  s = 0..P-2 C_j += A[j, k] h_k[send_idx[k][s]], the gathered rows copied onto
  j's device (the JAX package's ``ppermute`` with perm (i, (i - s - 1) mod P)),
  each round's buffer freed after its product.

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

The per-process slab builds (``from_pigo``, ``from_slabs``, ``GraphHeader``)
wait for ROADMAP queue 1 item 9g.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..formats import CSRData
from ..ops.spmm import COOMat, spmm
from ..ops.spmm_gather import GatherMat
from .dist import Ring, _copy_to, column_blocks, gather_block, row_slab


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
    For partition j, on its device, S = P - 1 rounds:

      loc[j]         the diagonal block A[j, j] (m_loc × m_loc)
      rem[j][s]      block A[j, (j+s+1) % P] (m_loc × round_widths[s]),
                     columns in round s's halo positions
      send_idx[j][s] int64 (round_widths[s],): the local rows partition j
                     sends in round s, to (j-s-1) % P; padding 0
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
        """Build each partition's blocks and send lists on its device, one
        row slab at a time."""
        n, parts = csr.nrows, mesh.parts
        if n % parts:
            raise ValueError(
                f"n ({n}) must be divisible by the mesh size ({parts}); pad the "
                "dataset (dist_matrix.hpp:428 semantics)"
            )
        m, S = n // parts, parts - 1
        loc, compact, recv = [], [], []
        for j, dev in enumerate(mesh.devices):
            lb, comp, rc = halo_slab_blocks(row_slab(csr, j, m), j, parts, dev)
            loc.append(cls.block(*lb, m, m))
            compact.append([(r.to(torch.int32), c.to(torch.int32), v) for r, c, v in comp])
            recv.append(rc)
            del lb, comp
        widths = tuple(_round_up(max(recv[j][s].numel() for j in range(parts)), SEND_PAD) for s in range(S))
        rem = [[cls.block(*compact[j][s], m, widths[s]) for s in range(S)] for j in range(parts)]
        send_idx = []
        for k, dev in enumerate(mesh.devices):
            sends = []
            for s in range(S):
                # partition k sends to (k - s - 1) % P the rows that partition receives
                rc = recv[(k - s - 1) % parts][s]
                idx = torch.zeros(widths[s], dtype=torch.int64, device=dev)
                idx[: rc.numel()] = rc.to(dev)
                sends.append(idx)
            send_idx.append(sends)
        return cls(loc=loc, rem=rem, send_idx=send_idx, n=n, parts=parts, nnz=csr.nnz,
                   halo_width=max(widths, default=0),
                   halo_total=sum(r.numel() for rc in recv for r in rc), round_widths=widths)

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
        if engine not in ("xla", "gather"):
            raise ValueError(f"unknown halo engine {engine!r} (expected xla or gather)")
        make = DistHaloGatherMat.from_csr if engine == "gather" else DistHaloMat.from_csr
        return DistHaloPair(make(csr_fwd, mesh), make(csr_bwd, mesh))


def _block_product(blk, b: torch.Tensor) -> torch.Tensor:
    if isinstance(blk, GatherMat) and torch.is_grad_enabled() and b.requires_grad:
        # the kernel has no backward: a gradient takes the backward matrix
        # (dist._ExactAgg), as every step does
        raise ValueError("the serial-gather halo blocks are not differentiable; aggregate them through "
                         "parallel.dist.sage_aggregation or _ExactAgg")
    return spmm(blk, b)


def dist_aggregate_halo(mat: DistHaloMat, hs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The halo-exchange product for every partition: C_j = A[j, j] h_j,
    then round by round C_j += A[j, k] h_k[send_idx[k][s]] with
    k = (j+s+1) % P (``dist_aggregate_halo`` and, on a
    :class:`DistHaloGatherMat`, ``dist_aggregate_halo_gather`` of
    ``mg_gcn_tpu/parallel/dist_halo.py:821-862, 1019-1044``, in their sum
    order). ``hs`` are the (m_loc, d) blocks; the result has their dtype.
    The steps take its gradient as the backward matrix's product
    (``dist._ExactAgg``), never by autograd through it."""
    parts, out = mat.parts, []
    for j, h in enumerate(hs):
        c = _block_product(mat.loc[j], h)
        for s in range(parts - 1):
            k = (j + s + 1) % parts
            halo = hs[k].index_select(0, mat.send_idx[k][s])
            if halo.device != h.device:
                halo = _copy_to(halo, h.device)
            c = c + _block_product(mat.rem[j][s], halo)
            del halo  # at most one round's buffer alive
        out.append(c.to(h.dtype))
    return out
