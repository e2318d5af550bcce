"""The CSR row walk's schedule (``csrc/csr_walk.cuh``) on the CPU: a plain
twin of what the kernel computes, held against the JAX package's
``_edge_kernel`` and ``_edge_t_kernel`` in Pallas interpret mode (their
default off the TPU) and against the port's plain versions ``edge_plain``,
``edge_i8_plain`` and ``edge_t_plain``. Same numpy inputs into both.

The twin (:func:`walk_twin`) splits each row's entries over the walk's G
groups (``spmm_edges.csr_walk_geometry``): group k sums entries k, k + G,
k + 2G, ... of the row in order (``index_add_`` on the CPU adds in index
order), and the G partial sums meet by the kernel's xor tree (groups 2i and
2i + 1 first, then pairs of pairs). It is for these tests only.

Tolerance, float32 and bfloat16: the same rounded weights and operand on
both sides, float32 sums in another order, so rtol 1e-5 / atol 1e-6 of the
output's scale (its largest magnitude); int8 sums are exact and equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.ops import spmm_edges as jse
from mg_gcn_tpu_torch import sparse
from mg_gcn_tpu_torch.formats import CSRData
from mg_gcn_tpu_torch.ops import spmm_edges as se

# the GAT path's widths (d_pad 8, 48, 64) and the walk's other group sizes
WIDTHS = [8, 16, 41, 64, 128]  # d_pad 8, 16, 48, 64, 128
RTOL, ATOL_OF_SCALE = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def walk_twin(indptr: torch.Tensor, indices: torch.Tensor, w: torch.Tensor | None, b: torch.Tensor,
              acc_dtype: torch.dtype) -> torch.Tensor:
    """C[r] = sum_e w_e B[c_e] as the walk takes it at B's width d_pad:
    per-group sums in ``acc_dtype`` (float64, float32, or int64 for int8),
    then the xor tree over the groups."""
    n_out, d_pad = indptr.numel() - 1, b.shape[1]
    groups = se.csr_walk_geometry(d_pad)["groups"]
    counts = indptr.diff()
    rows = torch.repeat_interleave(torch.arange(n_out), counts)
    pos = torch.arange(indices.numel()) - torch.repeat_interleave(indptr[:-1], counts)
    terms = b.to(acc_dtype).index_select(0, indices.long())
    if w is not None:
        terms = terms * w.to(acc_dtype)[:, None]
    part = torch.zeros((n_out * groups, d_pad), dtype=acc_dtype).index_add_(0, rows * groups + pos % groups, terms)
    part = part.view(n_out, groups, d_pad)
    off = 1
    while off < groups:  # the lane adds the sums ``off`` groups away: p_k + p_(k xor off)
        part = part + part[:, torch.arange(groups) ^ off]
        off *= 2
    return part[:, 0]


def walk_twin_t(t_indptr, t_rows, perm, w, a, acc_dtype):
    """The transposed walk (edge_t): the twin over the CSR transpose, each
    weight read through ``perm``."""
    return walk_twin(t_indptr, t_rows, w[perm.long()], a, acc_dtype)


def twin_kernel(acc_dtype):
    """The twin in a kernel wrapper's place: float32 sums, int32 for int8."""
    def run(indptr, indices, w, b):
        out = walk_twin(indptr, indices, w, b, torch.int64 if b.dtype == torch.int8 else acc_dtype)
        return out.to(torch.int32) if b.dtype == torch.int8 else out
    return run


def assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_OF_SCALE * np.abs(want).max(initial=0.0))


def walk_graph(n=700, seed=3, duplicates=True):
    """n nodes, up to 8 random entries a row of uniform weights in [0.5,
    1.5), a hub row 7 with an entry in every column, empty rows 100..149, a
    hub column 5 (an entry in every row past 149, for the transpose) and,
    with ``duplicates``, every tenth row's first entry repeated (duplicate
    (row, col) entries)."""
    rng = np.random.default_rng(seed)
    cols = [np.unique(rng.integers(0, n, 8)) for _ in range(n)]
    cols[7] = np.arange(n)
    for r in range(100, 150):
        cols[r] = cols[r][:0]
    for r in range(150, n):
        cols[r] = np.union1d(cols[r], [5])
    if duplicates:
        for r in range(0, n, 10):
            if cols[r].size:
                cols[r] = np.r_[cols[r][:1], cols[r]]
    indptr = np.r_[0, np.cumsum([c.size for c in cols])].astype(np.int64)
    data = (rng.random(indptr[-1]) + 0.5).astype(np.float32)
    return CSRData(indptr, np.concatenate(cols).astype(np.int32), data, (n, n))


GRAPH = walk_graph()


def operand(rows, d, seed):
    return np.random.default_rng(seed).standard_normal((rows, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# the rule


@pytest.mark.parametrize("d_pad,lanes", [(8, 2), (16, 4), (24, 8), (32, 8), (40, 16), (48, 16), (64, 16),
                                         (72, 32), (128, 32), (136, 32), (256, 32), (264, 32)])
def test_geometry_rule(d_pad, lanes):
    """L is the smallest power of two >= d_pad / 4, capped at 32; G = 32 / L."""
    assert se.csr_walk_geometry(d_pad) == {"lanes": lanes, "groups": 32 // lanes}
    assert lanes == 32 or 4 * lanes >= d_pad > 2 * lanes


@pytest.mark.parametrize("d_pad", [0, 12, -8])
def test_geometry_refuses_bad_widths(d_pad):
    with pytest.raises(ValueError, match="multiple of 8"):
        se.csr_walk_geometry(d_pad)


# ---------------------------------------------------------------------------
# the twin against the plain versions, on the raw CSR (duplicates unmerged)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("acc", ["float64", "float32", "int8"])
def test_twin_matches_plain(acc, d):
    """The twin against edge_plain (float64 and float32 sums) and
    edge_i8_plain (int8, equal) on hub rows, empty rows and duplicate
    entries; empty rows are exactly zero."""
    indptr, indices = torch.from_numpy(GRAPH.indptr), torch.from_numpy(GRAPH.indices)
    b = se.pad_features(torch.from_numpy(operand(GRAPH.ncols, d, seed=d)), torch.float32)
    if acc == "int8":
        rng = np.random.default_rng(d)
        w = torch.from_numpy(rng.integers(-127, 128, GRAPH.nnz).astype(np.int8))
        bq = torch.from_numpy(rng.integers(-127, 128, b.shape).astype(np.int8))
        got = twin_kernel(torch.float32)(indptr, indices, w, bq)
        assert got.dtype == torch.int32
        assert torch.equal(got, se.edge_i8_plain(indptr, indices, w, bq))
        return
    w = torch.from_numpy(GRAPH.data)
    dt = getattr(torch, acc)
    got = walk_twin(indptr, indices, w, b, dt)
    assert got.dtype == dt and got.shape == (GRAPH.nrows, b.shape[1])
    assert not bool(got[100:150].any())
    want = se.csr_plain(indptr, indices, w, b, dt)
    if acc == "float64":
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))
    else:
        assert_close(got, want)
        assert_close(got, se.edge_plain(indptr, indices, w, b))


@pytest.mark.parametrize("d", WIDTHS)
def test_twin_t_matches_edge_t_plain(d):
    """The transposed twin against edge_t_plain for M = the graph's
    transpose: its transpose walk has the hub row 7 (a column of M with 700
    entries), the duplicates, and the empty rows 100..149 as columns of M
    with no entries, whose output rows are zero."""
    m = sparse.transpose(GRAPH)
    mat = se.edge_tile_mat_from_csr(m, dtype="float32", device="cpu", merge=False)
    t = se.transposed_schedule(mat)
    a = se.pad_features(torch.from_numpy(operand(m.nrows, d, seed=d + 1)), torch.float32)
    w = torch.from_numpy(np.random.default_rng(d).standard_normal(mat.nnz).astype(np.float32))
    got = walk_twin_t(t.t_indptr, t.t_rows, t.perm, w, a, torch.float32)
    assert int(t.t_indptr.diff()[7]) == m.nrows and not bool(t.t_indptr.diff()[100:150].any())
    assert_close(got, se.edge_t_plain(t.t_indptr, t.t_rows, t.perm, w, a))
    assert not bool(got[100:150].any())


# ---------------------------------------------------------------------------
# the twin against the JAX package's kernels


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_twin_matches_jax_edge_kernel(monkeypatch, dtype, d):
    """spmm_edge_tiles with the twin in the kernel's place against the JAX
    package's (``_edge_kernel`` / ``_edge_kernel_i8``); duplicates merged
    at build by both."""
    b = operand(GRAPH.ncols, d, seed=d)
    jmat = jse.edge_tile_mat_from_csr(JCSRData(GRAPH.indptr, GRAPH.indices, GRAPH.data, GRAPH.shape), dtype=dtype)
    want = np.asarray(jse.spmm_edge_tiles(jmat, jnp.asarray(b)))
    monkeypatch.setattr(se, "edge", twin_kernel(torch.float32))
    monkeypatch.setattr(se, "edge_i8", twin_kernel(torch.float32))
    mat = se.edge_tile_mat_from_csr(GRAPH, dtype=dtype, device="cpu")
    got = se.spmm_edge_tiles(mat, torch.from_numpy(b)).numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert_close(got, want)


_jspmm_t = jax.jit(jse.spmm_edge_tiles_t)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_t_matches_jax_edge_t_kernel(monkeypatch, dtype, d):
    """spmm_edge_tiles_t with the transposed twin in the kernel's place
    against the JAX package's (``_edge_t_kernel``) for M = the transpose of
    the graph without its duplicate entries: hub and empty columns."""
    csr = sparse.transpose(walk_graph(duplicates=False))
    a = operand(csr.nrows, d, seed=d + 1)
    jmat = jse.edge_tile_mat_from_csr(JCSRData(csr.indptr, csr.indices, csr.data, csr.shape), dtype=dtype)
    want = np.asarray(_jspmm_t(jmat, jse.transposed_schedule(jmat), jnp.asarray(a)))
    monkeypatch.setattr(se, "edge_t", lambda *args: walk_twin_t(*args, torch.float32))
    mat = se.edge_tile_mat_from_csr(csr, dtype=dtype, device="cpu", merge=False)
    got = se.spmm_edge_tiles_t(mat, se.transposed_schedule(mat), torch.from_numpy(a)).numpy()
    assert_close(got, want)
