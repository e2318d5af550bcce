"""Host-side graph/CSR preprocessing (numpy, scipy).

Port of ``mg_gcn_tpu/sparse.py``: degree normalization and the
counting-sort transpose (reference matrix.hpp:340-424), self loops, the
uniform partition, its 2-D block split and its communication volume,
symmetric permutations and the locality orderings
of ``data.prep cluster``, and the synthetic generators ``random_graph``,
``planted_graph`` and ``planted_features``. ``normalize``, ``transpose``
and ``comm_volume`` run on the C++/OpenMP library of :mod:`.native` where it
is available, as the JAX package's do; its results are element-equal to the
numpy path here.
"""

from __future__ import annotations

import numpy as np

from . import native
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
    if native.available():
        return CSRData(csr.indptr, csr.indices, native.normalize(csr, axis), csr.shape)
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
    if native.available():
        return native.transpose(csr)
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


def add_self_loops(csr: CSRData, weight: float = 1.0) -> CSRData:
    """Add a self edge to every node that has none, rows sorted by column."""
    import scipy.sparse as ss

    rows = _expand_rows(csr)
    has = np.zeros(csr.nrows, bool)
    has[rows[csr.indices == rows]] = True
    missing = np.flatnonzero(~has).astype(np.int64)
    if missing.size == 0:
        return csr
    coo = csr.to_scipy().tocoo()
    r = np.concatenate([coo.row.astype(np.int64), missing])
    c = np.concatenate([coo.col.astype(np.int64), missing])
    d = np.concatenate([coo.data.astype(np.float32), np.full(missing.size, weight, np.float32)])
    out = ss.csr_matrix((d, (r, c)), shape=csr.shape)
    out.sort_indices()
    return CSRData.from_scipy(out)


def uniform_partition(n: int, parts: int) -> np.ndarray:
    """The reference's uniform 1-D partition, p[i] = i*n/P (main.cpp:139-141):
    P+1 boundaries."""
    return np.array([i * n // parts for i in range(parts + 1)], dtype=np.int64)


def partition_blocks(csr: CSRData, row_part: np.ndarray, col_part: np.ndarray) -> list[list[CSRData]]:
    """Split A into a P×Q grid of CSR blocks (the reference's
    dist_row_csr_matrix construction, dist_matrix.hpp:215-259): block[i][j]
    holds rows [row_part[i], row_part[i+1]) and the columns in
    [col_part[j], col_part[j+1]), column indices shifted down by
    col_part[j]."""
    rows = _expand_rows(csr)
    cols = csr.indices.astype(np.int64)
    col_block = np.searchsorted(col_part[1:], cols, side="right")
    out = []
    for i in range(len(row_part) - 1):
        r0, r1 = int(row_part[i]), int(row_part[i + 1])
        e0, e1 = int(csr.indptr[r0]), int(csr.indptr[r1])
        row_i, col_i, cb_i, dat_i = rows[e0:e1] - r0, cols[e0:e1], col_block[e0:e1], csr.data[e0:e1]
        blocks = []
        for j in range(len(col_part) - 1):
            sel = cb_i == j
            indptr = np.zeros(r1 - r0 + 1, dtype=np.int64)
            np.cumsum(np.bincount(row_i[sel], minlength=r1 - r0), out=indptr[1:])
            blocks.append(CSRData(
                indptr=indptr,
                indices=(col_i[sel] - int(col_part[j])).astype(np.int32),
                data=dat_i[sel].astype(np.float32),
                shape=(r1 - r0, int(col_part[j + 1] - col_part[j])),
            ))
        out.append(blocks)
    return out


def comm_volume(csr: CSRData, part: np.ndarray) -> np.ndarray:
    """P×P communication volume of a row partition (prep.py:232-272):
    volume[i][j] = the distinct columns owned by partition j that partition
    i's rows reference, the feature rows that travel j→i."""
    if native.available():
        return native.comm_volume(csr, np.asarray(part, np.int64))
    P = len(part) - 1
    rows = _expand_rows(csr)
    cols = csr.indices.astype(np.int64)
    row_block = np.searchsorted(part[1:], rows, side="right")
    col_block = np.searchsorted(part[1:], cols, side="right")
    vol = np.zeros((P, P), dtype=np.int64)
    for i in range(P):
        sel = row_block == i
        for j in range(P):
            vol[i, j] = np.unique(cols[sel & (col_block == j)]).size
    return vol


def permute_symmetric(csr: CSRData, perm: np.ndarray) -> CSRData:
    """A[perm][:, perm]: ``perm`` maps new index -> old index, as
    ``features[perm]`` does (the reference's prep.py:24-43, 89-93)."""
    sp = csr.to_scipy()[perm][:, perm]
    sp.sort_indices()
    return CSRData.from_scipy(sp)


def cluster_order(csr: CSRData, method: str = "rcm") -> np.ndarray:
    """A locality-improving node order (new index -> old index) that
    concentrates edges near the diagonal, where the block-sparse pattern
    pair skips empty tiles (``ops/spmm_pattern_sparse.py``):

    * "rcm"    — reverse Cuthill-McKee bandwidth reduction (scipy);
    * "bfs"    — breadth-first order from the node of largest degree, then
      the unreached nodes;
    * "degree" — by falling degree.
    """
    sym = csr.to_scipy()
    sym = (sym + sym.T).tocsr()
    if method == "rcm":
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        return np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True))
    if method == "bfs":
        from scipy.sparse.csgraph import breadth_first_order

        start = int(np.argmax(np.diff(sym.indptr)))
        order, _ = breadth_first_order(sym, start, return_predecessors=True)
        seen = np.zeros(csr.nrows, bool)
        seen[order] = True
        return np.concatenate([order, np.flatnonzero(~seen)]).astype(np.int64)
    if method == "degree":
        return np.argsort(-np.diff(csr.indptr)).astype(np.int64)
    raise ValueError(f"unknown cluster method {method!r}")


def _csr_from_edges(n: int, src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(indptr, indices) of the n×n pattern of the edges, duplicates merged.

    Sort + drop repeats gives the same sorted keys as np.unique, which
    NumPy >= 2.3 computes with a hash table that is minutes slower at 1e8
    keys."""
    key = src * n + dst
    key.sort()
    first = np.ones(key.size, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    key = key[first]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=indptr[1:])
    return indptr, (key % n).astype(np.int32)


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
    indptr, indices = _csr_from_edges(n, src, dst)
    if weights == "ones":
        data = np.ones(indices.shape[0], dtype=np.float32)
    else:
        data = rng.random(indices.shape[0], dtype=np.float32) + 0.5
    return CSRData(indptr=indptr, indices=indices, data=data, shape=(n, n))


def banded_graph(n: int, draws: int, half_width: int, seed: int) -> CSRData:
    """bench.py's block-banded graph (bench.py:276-292): ``draws`` edges a
    row to columns ``row + U[-half_width, half_width]`` clipped to [0, n),
    duplicates merged, binary, no self loops added."""
    src = np.arange(n, dtype=np.int64).repeat(draws)
    rng = np.random.default_rng(seed)
    dst = np.clip(src + rng.integers(-half_width, half_width + 1, src.size), 0, n - 1)
    indptr, indices = _csr_from_edges(n, src, dst)
    return CSRData(indptr=indptr, indices=indices, data=np.ones(indices.shape[0], np.float32), shape=(n, n))


def planted_graph(
    n: int,
    avg_degree: float,
    classes: int,
    intra: float = 0.55,
    seed: int = 3,
    self_loops: bool = True,
) -> tuple[CSRData, np.ndarray]:
    """Synthetic graph with planted communities, ``(graph, comm)``: a share
    ``intra`` of the edges stays inside the source's community (contiguous
    index ranges), duplicates merged; ``comm[i]`` serves as node i's label.
    Same draws as ``mg_gcn_tpu.sparse.planted_graph``."""
    rng = np.random.default_rng(seed)
    sizes = np.full(classes, n // classes, np.int64)
    sizes[: n % classes] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    comm = np.repeat(np.arange(classes, dtype=np.int32), sizes)
    nnz_target = int(n * avg_degree)
    src = rng.integers(0, n, size=nnz_target, dtype=np.int64)
    is_intra = rng.random(nnz_target) < intra
    c_of = comm[src]
    lo, hi = bounds[c_of], bounds[c_of + 1]
    pick = lo + (rng.random(nnz_target) * (hi - lo)).astype(np.int64)
    dst = np.where(is_intra, pick, rng.integers(0, n, size=nnz_target, dtype=np.int64))
    if self_loops:
        src = np.concatenate([src, np.arange(n, dtype=np.int64)])
        dst = np.concatenate([dst, np.arange(n, dtype=np.int64)])
    indptr, indices = _csr_from_edges(n, src, dst)
    g = CSRData(indptr=indptr, indices=indices, data=np.ones(indices.shape[0], np.float32), shape=(n, n))
    return g, comm


def planted_features(comm: np.ndarray, dim: int, noise: float = 10.0, seed: int = 0) -> np.ndarray:
    """Features that carry the planted community signal: a random projection
    of the community one-hot plus Gaussian noise of scale ``noise``."""
    rng = np.random.default_rng(seed)
    classes = int(comm.max()) + 1
    proj = rng.standard_normal((classes, dim)).astype(np.float32)
    return proj[comm] + noise * rng.standard_normal((comm.size, dim)).astype(np.float32)
