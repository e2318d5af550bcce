"""Port vs JAX package: the edge engine (``ops/spmm_edges.py``). The JAX
edge-tile kernels run in Pallas interpret mode (their default off the TPU),
the port's kernels on their plain versions (the tensors lie on the CPU).
Same numpy inputs into both."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from mg_gcn_tpu.ops import spmm_edges as jse
from mg_gcn_tpu_torch import sparse
from mg_gcn_tpu_torch.formats import CSRData
from mg_gcn_tpu_torch.ops import spmm_edges as se

DTYPES = ["float32", "bfloat16", "int8"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def signed(n_out, n_in, density, seed):
    """A random weighted CSR with signed values (the JAX edge tests' own)."""
    m = sps.random(n_out, n_in, density=density, format="csr", random_state=seed, dtype=np.float32)
    m.data = (m.data * 2 - 0.5).astype(np.float32)
    return CSRData(m.indptr.astype(np.int64), m.indices.astype(np.int32), m.data, m.shape)


def assert_matches(got, want, dtype):
    """int8: equal (the same int32 sums, the same dequant order). Float: the
    same rounded weights and operand, float32 sums in another order —
    rtol 1e-5 (float32) / 1e-4 (bfloat16) of the output's scale."""
    assert got.shape == want.shape
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-5 if dtype == "float32" else 1e-4
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max(initial=0.0)))


def run_both(csr, d, dtype, seed=0, **jax_kw):
    b = np.random.default_rng(seed).standard_normal((csr.ncols, d)).astype(np.float32)
    want = np.asarray(jse.spmm_edge_tiles(jse.edge_tile_mat_from_csr(csr, dtype=dtype, **jax_kw), jnp.asarray(b)))
    mat = se.edge_tile_mat_from_csr(csr, dtype=dtype, device="cpu")
    return se.spmm_edge_tiles(mat, torch.from_numpy(b)).numpy(), want


@pytest.mark.parametrize("d", [8, 41, 130])
@pytest.mark.parametrize("dtype", DTYPES)
def test_square_uniform_weights_match_jax(dtype, d):
    g = sparse.random_graph(2000, 5, seed=d, weights="uniform")
    assert_matches(*run_both(g, d, dtype, seed=d), dtype)


@pytest.mark.parametrize("shape", [(300, 700), (700, 300)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rectangular_signed_match_jax(dtype, shape):
    assert_matches(*run_both(signed(*shape, density=0.03, seed=2), 24, dtype), dtype)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_both_jax_pairings_match(dtype, paired):
    """The JAX slot layout with and without chunk pairing computes the same
    product; the port has no slots, so it matches both."""
    g = sparse.random_graph(1000, 40, seed=7, weights="uniform")
    assert_matches(*run_both(g, 41, dtype, br=512, paired=paired), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_empty_rows_write_zeros(dtype):
    """Rows 100..1099 have no entries (a whole JAX row tile is empty)."""
    n = 1200
    dense = np.zeros((n, n), np.float32)
    dense[:100, :50] = np.arange(100 * 50, dtype=np.float32).reshape(100, 50) / 999
    dense[1100:, 600:700] = 1.5
    m = sps.csr_matrix(dense)
    csr = CSRData(m.indptr.astype(np.int64), m.indices.astype(np.int32), m.data.astype(np.float32), m.shape)
    got, want = run_both(csr, 16, dtype)
    assert_matches(got, want, dtype)
    assert not np.any(got[100:1100])


@pytest.mark.parametrize("dtype", DTYPES)
def test_empty_matrix(dtype):
    csr = CSRData(np.zeros(301, np.int64), np.zeros(0, np.int32), np.zeros(0, np.float32), (300, 200))
    got, want = run_both(csr, 8, dtype)
    assert_matches(got, want, dtype)
    assert got.shape == (300, 8) and not np.any(got)


def duplicate_csr():
    """Rows with duplicate (row, col) entries inside one JAX sub-tile, out of
    column order: row 0 sums 127 + 127 + 127 -> clipped to 127 in int8;
    row 1 (scale 1.0 from col 9) sums 0.3 + 0.2 -> 38 + 25 = 63; row 2 sums
    127 + 76 - 25 = 178 -> 127."""
    rows = [
        ([5, 2, 5, 5], [1.0, 0.5, 1.0, 1.0]),
        ([3, 9, 3], [0.3, 1.0, 0.2]),
        ([7, 1, 7, 7], [1.0, -0.4, 0.6, -0.2]),
    ]
    indptr = np.cumsum([0] + [len(c) for c, _ in rows]).astype(np.int64)
    indices = np.concatenate([c for c, _ in rows]).astype(np.int32)
    data = np.concatenate([v for _, v in rows]).astype(np.float32)
    return CSRData(indptr, indices, data, (3, 16))


@pytest.mark.parametrize("dtype", DTYPES)
def test_duplicate_entries_merge_like_the_tpu_cell(dtype):
    csr = duplicate_csr()
    got, want = run_both(csr, 8, dtype)
    assert_matches(got, want, dtype)
    mat = se.edge_tile_mat_from_csr(csr, dtype=dtype, device="cpu")
    assert mat.nnz == 6  # 11 entries, 6 distinct cells
    assert mat.indptr.tolist() == [0, 2, 4, 6]
    if dtype == "int8":
        assert mat.wq.tolist() == [64, 127, 63, 127, -51, 127]  # clipped at ±127


def test_int8_quantization_is_the_jax_hosts():
    """Per-row scales and quantized weights equal the JAX schedule builder's
    (spmm_edges.py:288-302), entry for entry."""
    g = sparse.random_graph(2000, 6, seed=3, weights="uniform")
    mat = se.edge_tile_mat_from_csr(g, dtype="int8", device="cpu")
    sched = jse.edge_tile_schedule_host(g, dtype="int8")
    np.testing.assert_array_equal(mat.row_scale.numpy(), sched["row_scale"])
    valid = (sched["idx"] >> 30) & 1 == 1
    q_jax = ((sched["idx"][valid] >> jse.WQ_SHIFT) & jse.WQ_MASK) - jse.WQ_BIAS
    assert sorted(q_jax.tolist()) == sorted(mat.wq.tolist())


def test_bf16_weights_round_once_to_nearest_even():
    g = sparse.random_graph(500, 4, seed=5, weights="uniform")
    mat = se.edge_tile_mat_from_csr(g, dtype="bfloat16", device="cpu")
    assert mat.w.dtype == torch.bfloat16
    assert torch.equal(mat.w, torch.from_numpy(g.data).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_plain_versions_against_dense(dtype):
    """The kernels' plain versions against a dense matmul in float64."""
    csr = signed(200, 150, density=0.05, seed=4)
    rng = np.random.default_rng(1)
    if dtype == torch.int8:
        w = torch.from_numpy(rng.integers(-127, 128, csr.nnz).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (150, 16)).astype(np.int8))
        got = se.edge_i8(torch.from_numpy(csr.indptr), torch.from_numpy(csr.indices), w, b)
        assert got.dtype == torch.int32
    else:
        w = torch.from_numpy(csr.data).to(dtype)
        b = torch.from_numpy(rng.standard_normal((150, 16)).astype(np.float32)).to(dtype)
        got = se.edge(torch.from_numpy(csr.indptr), torch.from_numpy(csr.indices), w, b)
        assert got.dtype == torch.float32
    dense = sps.csr_matrix((w.double().numpy(), csr.indices, csr.indptr), shape=csr.shape).toarray()
    want = dense @ b.double().numpy()
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize(
    "indptr,indices,why",
    [
        ([0, 2, 3], [0, 9], "indptr"),  # ends past nnz
        ([0, 1, 2], [0, 8], "column indices"),  # column 8 of 8
        ([0, 1, 2], [-1, 3], "column indices"),
    ],
)
@pytest.mark.parametrize("engine", ["edge", "gather"])
def test_builders_reject_malformed_csr(engine, indptr, indices, why):
    """A CSR read from a file that would address past B's rows is refused
    on the host, before any kernel sees it."""
    from mg_gcn_tpu_torch.ops import spmm_gather as sg

    csr = CSRData(np.array(indptr, np.int64), np.array(indices, np.int32), np.ones(len(indices), np.float32), (2, 8))
    build = se.edge_tile_mat_from_csr if engine == "edge" else sg.gather_mat_from_csr
    with pytest.raises(ValueError, match=why):
        build(csr, device="cpu")


GRID = [
    (232_968, 114_964_049),  # Reddit, random_graph(n, 493, seed=1)
    (2_449_029, 124_900_000),  # ogbn-products scale, random_graph(n, 50, seed=3)
    (1_000, 5_000),
    (20_000, 1_300_000),
    (300, 30_000),
    (100_000, 100_000),
    (4_096, 0),
]


@pytest.mark.parametrize("n,nnz", GRID)
def test_expected_fill_and_pick_equal_jax(n, nnz):
    assert se._pick_br(n, n, nnz) == jse._pick_br(n, n, nnz)
    assert se.expected_fill(n, n, nnz) == jse.expected_fill(n, n, nnz)
