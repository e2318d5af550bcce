"""Host-side graph/CSR preprocessing (numpy).

Port of the parts of ``mg_gcn_tpu/sparse.py`` the single-card slice needs:
degree normalization and the counting-sort transpose (reference
matrix.hpp:340-424), and the synthetic ``random_graph``. The C++/OpenMP fast
path (``native``) waits for a later slice (ROADMAP queue 1 item 1).
"""

from __future__ import annotations

import numpy as np

from .formats import CSRData


def _expand_rows(csr: CSRData) -> np.ndarray:
    """Per-edge row ids from indptr."""
    counts = np.diff(csr.indptr).astype(np.int64)
    return np.repeat(np.arange(csr.nrows, dtype=np.int64), counts)


def normalize(csr: CSRData, axis: bool = False) -> CSRData:
    """Degree-normalize edge weights (matrix.hpp:340-390).

    axis=False: each row is scaled to sum to 1 (row-stochastic).
    axis=True: each entry is divided by the sum of its column — the GCN
    in-degree normalization of the training path (main.cpp:143).
    Sums are taken in float64 in edge order, as the JAX package does.
    """
    data = csr.data.astype(np.float32, copy=True)
    if not axis:
        ptr = csr.indptr.astype(np.int64)
        row_sum = np.zeros(csr.nrows, np.float32)
        chunk_rows = 1 << 20
        for r0 in range(0, csr.nrows, chunk_rows):
            r1 = min(r0 + chunk_rows, csr.nrows)
            e0, e1 = ptr[r0], ptr[r1]
            if e1 == e0:
                continue
            # the trailing 0 keeps reduceat's start index legal for trailing
            # empty rows without clamping into the previous row's segment
            chunk = np.concatenate([data[e0:e1].astype(np.float64), [0.0]])
            sums = np.add.reduceat(chunk, ptr[r0:r1] - e0)
            counts = ptr[r0 + 1 : r1 + 1] - ptr[r0:r1]
            row_sum[r0:r1] = np.where(counts > 0, sums, 0.0).astype(np.float32)
        data = data / row_sum[_expand_rows(csr)]
    else:
        cols = csr.indices.astype(np.int64)
        # bincount sums in element order in float64, like np.add.at
        col_sum = np.bincount(cols, weights=data.astype(np.float64), minlength=csr.ncols)
        data = (data / col_sum[cols]).astype(np.float32)
    return CSRData(csr.indptr, csr.indices, data.astype(np.float32), csr.shape)


def transpose(csr: CSRData) -> CSRData:
    """CSR transpose via a stable counting sort (matrix.hpp:392-424): the
    result's rows hold the original column's edges in original row order."""
    n, m = csr.shape
    cols = csr.indices.astype(np.int64)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(cols, minlength=m), out=indptr[1:])
    order = np.argsort(cols, kind="stable")
    return CSRData(
        indptr=indptr,
        indices=_expand_rows(csr)[order].astype(np.int32),
        data=csr.data[order],
        shape=(m, n),
    )


def random_graph(
    n: int,
    avg_degree: float,
    seed: int = 0,
    self_loops: bool = True,
    weights: str = "ones",
) -> CSRData:
    """Synthetic benchmark graph: uniform random edges, duplicates merged.
    Same generator and draw order as ``mg_gcn_tpu.sparse.random_graph``, so
    a seed gives the same graph in both packages."""
    rng = np.random.default_rng(seed)
    nnz_target = int(n * avg_degree)
    src = rng.integers(0, n, size=nnz_target, dtype=np.int64)
    dst = rng.integers(0, n, size=nnz_target, dtype=np.int64)
    if self_loops:
        src = np.concatenate([src, np.arange(n, dtype=np.int64)])
        dst = np.concatenate([dst, np.arange(n, dtype=np.int64)])
    # sort + drop repeats: the same sorted keys as np.unique, which NumPy
    # >= 2.3 computes with a hash table that is minutes slower at 1e8 keys
    key = src * n + dst
    key.sort()
    first = np.ones(key.size, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    key = key[first]
    src, dst = key // n, key % n
    if weights == "ones":
        data = np.ones(src.shape[0], dtype=np.float32)
    else:
        data = rng.random(src.shape[0], dtype=np.float32) + 0.5
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return CSRData(indptr=indptr, indices=dst.astype(np.int32), data=data, shape=(n, n))
