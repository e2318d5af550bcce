"""Port vs JAX package: the SDDMM (``ops/sddmm.py``) and the transposed
edge product (``ops/spmm_edges.py``'s transposed half). The JAX kernels run
in Pallas interpret mode (their default off the TPU) under ``jax.jit``; the
port's kernels on their plain versions (the tensors lie on the CPU). Same
numpy inputs into both. The JAX results come in its slot layout and are
mapped to CSR entry order by ``tests/torch_port_slots.py``'s
:func:`slots_to_csr_order`."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.ops import sddmm as jsd
from mg_gcn_tpu.ops import spmm_edges as jse
from mg_gcn_tpu_torch.formats import CSRData
from mg_gcn_tpu_torch.ops import sddmm as sd
from mg_gcn_tpu_torch.ops import spmm_edges as se
from tests.torch_port_slots import csr_to_slots, slots_to_csr_order

DTYPES = ["float32", "bfloat16", "int8"]
# tolerance of the output's scale: float32 and int8 (float32 sums of the
# same rounded terms, in another order) 1e-5; bfloat16 1e-4
TOL = {"float32": 1e-5, "bfloat16": 1e-4, "int8": 1e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_csr(csr):
    return JCSRData(csr.indptr, csr.indices, csr.data, csr.shape)


def random_csr(n_out, n_in, density, seed, empty_rows=()):
    m = sps.random(n_out, n_in, density=density, format="lil", random_state=seed, dtype=np.float32)
    for r in empty_rows:
        m.rows[r], m.data[r] = [], []
    m = m.tocsr()
    m.data = (m.data + 0.5).astype(np.float32)
    return CSRData(m.indptr.astype(np.int64), m.indices.astype(np.int32), m.data, m.shape)


def assert_scale_close(got, want, tol):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max(initial=0.0)))


_jsddmm = jax.jit(jsd.sddmm_edge_tiles, static_argnames=("qskip", "select"))


def run_sddmm(csr, d, dtype, seed=0, **kw):
    """(port scores, JAX scores in CSR order) for the same numpy A, B."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((csr.nrows, d)).astype(np.float32)
    b = rng.standard_normal((csr.ncols, d)).astype(np.float32)
    jmat = jse.edge_tile_mat_from_csr(jax_csr(csr), dtype=dtype)
    want = slots_to_csr_order(jmat, csr, _jsddmm(jmat, jnp.asarray(a), jnp.asarray(b), **kw))
    mat = se.edge_tile_mat_from_csr(csr, dtype=dtype, device="cpu", merge=False)
    return sd.sddmm_edge_tiles(mat, torch.from_numpy(a), torch.from_numpy(b), **kw).numpy(), want


SQUARE = random_csr(300, 300, 0.03, seed=1)
RECT = random_csr(200, 450, 0.04, seed=2)


@pytest.mark.parametrize("d", [1, 2, 8, 41])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sddmm_square_matches_jax(dtype, d):
    assert_scale_close(*run_sddmm(SQUARE, d, dtype, seed=d), TOL[dtype])


@pytest.mark.parametrize("d", [2, 41])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sddmm_rectangular_matches_jax(dtype, d):
    assert_scale_close(*run_sddmm(RECT, d, dtype, seed=d), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_sddmm_empty_rows_match_jax(dtype):
    """Rows 40..239 have no entries (whole JAX row tiles are empty)."""
    csr = random_csr(400, 300, 0.05, seed=3, empty_rows=range(40, 240))
    assert_scale_close(*run_sddmm(csr, 16, dtype), TOL[dtype])


def test_sddmm_qskip_and_select_match_jax():
    """The JAX q-range kernel (qskip=True) and its one-level select give the
    default kernel's scores; the port's q-range path is bitwise equal to
    its default, over the live rows of a matrix with empty rows."""
    csr = random_csr(400, 300, 0.05, seed=4, empty_rows=range(100, 300))
    default, want = run_sddmm(csr, 24, "float32")
    for kw in (dict(qskip=True), dict(select="one")):
        got, want_kw = run_sddmm(csr, 24, "float32", **kw)
        assert_scale_close(want_kw, want, 1e-5)
        assert np.array_equal(got, default)
    mat = se.edge_tile_mat_from_csr(csr, dtype="float32", device="cpu")
    live = mat.live_rows
    assert live.dtype == torch.int32 and mat.live_rows is live  # computed once
    assert live.tolist() == [r for r in range(400) if csr.indptr[r + 1] > csr.indptr[r]]


def test_sddmm_int8_quantizes_like_jax():
    """Per-feature scales with the 1e-30 floor (an all-zero feature), and
    the score is Σ f32(aq·bq)·(qa·qb), the JAX kernel's rounding points."""
    csr = SQUARE
    rng = np.random.default_rng(6)
    a = rng.standard_normal((300, 9)).astype(np.float32)
    b = rng.standard_normal((300, 9)).astype(np.float32)
    a[:, 3] = 0.0
    jmat = jse.edge_tile_mat_from_csr(jax_csr(csr), dtype="int8")
    want = slots_to_csr_order(jmat, csr, _jsddmm(jmat, jnp.asarray(a), jnp.asarray(b)))
    mat = se.edge_tile_mat_from_csr(csr, dtype="int8", device="cpu", merge=False)
    got = sd.sddmm_edge_tiles(mat, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert_scale_close(got, want, 1e-5)
    aq, qa = sd.quantize_per_feature(torch.from_numpy(a))
    assert float(qa[3]) == np.float32(1e-30) / np.float32(127.0) and not aq[:, 3].any()


def test_sddmm_rejects_bad_shapes():
    mat = se.edge_tile_mat_from_csr(SQUARE, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="rows"):
        sd.sddmm_edge_tiles(mat, torch.zeros(299, 4), torch.zeros(300, 4))
    with pytest.raises(ValueError, match="feature dimension"):
        sd.sddmm_edge_tiles(mat, torch.zeros(300, 4), torch.zeros(300, 5))
    with pytest.raises(ValueError, match="select"):
        sd.sddmm_edge_tiles(mat, torch.zeros(300, 4), torch.zeros(300, 4), select="three")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_sddmm_plain_against_dense(dtype):
    csr = RECT
    rng = np.random.default_rng(7)
    if dtype == torch.int8:
        a = torch.from_numpy(rng.integers(-127, 128, (200, 16)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (450, 16)).astype(np.int8))
        g = torch.from_numpy(rng.random(16, np.float32) * 1e-3)
    else:
        a = torch.from_numpy(rng.standard_normal((200, 16)).astype(np.float32)).to(dtype)
        b = torch.from_numpy(rng.standard_normal((450, 16)).astype(np.float32)).to(dtype)
        g = None
    got = sd.sddmm(torch.from_numpy(csr.indptr), torch.from_numpy(csr.indices), a, b, g)
    dense = (a.double() * (1.0 if g is None else g.double())) @ b.double().T
    rows = np.repeat(np.arange(200), np.diff(csr.indptr))
    want = dense.numpy()[rows, csr.indices]
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the transposed product


_jspmm_t = jax.jit(jse.spmm_edge_tiles_t)


def run_spmm_t(csr, d, dtype, with_w, seed=0):
    """(port Mᵀ(w) A, JAX Mᵀ(w) A) for the same numpy A and entry weights."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((csr.nrows, d)).astype(np.float32)
    jmat = jse.edge_tile_mat_from_csr(jax_csr(csr), dtype=dtype)
    sched = jse.transposed_schedule(jmat)
    w = rng.standard_normal(csr.nnz).astype(np.float32) if with_w else None
    w_slots = None if w is None else jnp.asarray(csr_to_slots(jmat, csr, w))
    want = np.asarray(_jspmm_t(jmat, sched, jnp.asarray(a), w_slots))
    mat = se.edge_tile_mat_from_csr(csr, dtype=dtype, device="cpu", merge=False)
    got = se.spmm_edge_tiles_t(mat, se.transposed_schedule(mat), torch.from_numpy(a),
                               None if w is None else torch.from_numpy(w))
    return got.numpy(), want


@pytest.mark.parametrize("with_w", [False, True], ids=["matrix_weights", "w_slots"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_t_matches_jax(dtype, with_w):
    assert_scale_close(*run_spmm_t(RECT, 24, dtype, with_w), TOL[dtype])


def test_spmm_t_empty_columns_are_zeros():
    """Columns 50..249 have no entries: the JAX dummy zero-init steps'
    contract (spmm_edges.py:937-945)."""
    csr = random_csr(300, 250, 0.05, seed=5)
    keep = csr.indices < 50
    rows = np.repeat(np.arange(300), np.diff(csr.indptr))[keep]
    m = sps.csr_matrix((csr.data[keep], (rows, csr.indices[keep])), shape=(300, 250))
    csr = CSRData(m.indptr.astype(np.int64), m.indices.astype(np.int32), m.data.astype(np.float32), m.shape)
    got, want = run_spmm_t(csr, 8, "float32", with_w=True)
    assert_scale_close(got, want, 1e-5)
    assert not np.any(got[50:])


def test_spmm_t_rejects_int8():
    mat = se.edge_tile_mat_from_csr(RECT, dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="no int8 mode"):
        se.spmm_edge_tiles_t(mat, se.transposed_schedule(mat), torch.zeros(200, 8))


def test_transposed_schedule_is_the_csr_transpose():
    """t_indptr / t_rows equal scipy's CSC of the matrix, and perm maps each
    transposed entry to its CSR entry (stable: rows ascend in a column)."""
    mat = se.edge_tile_mat_from_csr(RECT, dtype="float32", device="cpu")
    t = se.transposed_schedule(mat)
    csc = RECT.to_scipy().tocsc()
    assert t.t_indptr.dtype == torch.int64 and t.t_rows.dtype == t.perm.dtype == torch.int32
    np.testing.assert_array_equal(t.t_indptr.numpy(), csc.indptr)
    np.testing.assert_array_equal(t.t_rows.numpy(), csc.indices)
    np.testing.assert_array_equal(RECT.data[t.perm.numpy()], csc.data)


def test_edge_t_plain_against_dense():
    csr = RECT
    rng = np.random.default_rng(8)
    mat = se.edge_tile_mat_from_csr(csr, dtype="float32", device="cpu")
    t = se.transposed_schedule(mat)
    w = torch.from_numpy(rng.standard_normal(csr.nnz).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((200, 16)).astype(np.float32))
    got = se.edge_t(t.t_indptr, t.t_rows, t.perm, w, a)
    dense = sps.csr_matrix((w.double().numpy(), csr.indices, csr.indptr), shape=csr.shape).toarray()
    want = dense.T @ a.double().numpy()
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
