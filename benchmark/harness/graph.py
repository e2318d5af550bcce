"""A graph as the benchmark makes it: the binary pattern's CSR arrays, made
on a device from the seed by a layout of ``benchmark/graphs/``, then kept on
the host, where the port and the reference each take it from."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Graph:
    """An n × n binary adjacency: ``indptr`` int64 (n + 1), ``indices``
    int32, columns sorted within a row, no repeats."""

    n: int
    indptr: np.ndarray
    indices: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])


def merge(n: int, src: torch.Tensor, dst: torch.Tensor) -> Graph:
    """The graph of the edges (src[e], dst[e]), repeats merged, sorted by
    row then column; the arrays go to the host."""
    key = torch.unique(src * n + dst)  # sorted
    del src, dst
    rows = torch.div(key, n, rounding_mode="floor")
    cols = (key - rows * n).to(torch.int32)
    del key
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=cols.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return Graph(n=n, indptr=indptr.cpu().numpy(), indices=cols.cpu().numpy())
