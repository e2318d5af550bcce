"""Port vs JAX package: the serial-gather engine (``ops/spmm_gather.py``).
The JAX kernel runs in Pallas interpret mode (its default off the TPU), the
port's kernel on its plain version (the tensors lie on the CPU). Same numpy
inputs into both; both sum in float32 in different orders, so outputs agree
within rtol 1e-5 of the output's scale."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from mg_gcn_tpu.ops import spmm_gather as jsg
from mg_gcn_tpu_torch import sparse
from mg_gcn_tpu_torch.formats import CSRData
from mg_gcn_tpu_torch.ops import spmm_gather as sg


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def signed(n_out, n_in, density, seed):
    m = sps.random(n_out, n_in, density=density, format="csr", random_state=seed, dtype=np.float32)
    m.data = (m.data * 2 - 0.5).astype(np.float32)
    return CSRData(m.indptr.astype(np.int64), m.indices.astype(np.int32), m.data, m.shape)


def assert_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max(initial=0.0)))


def operand(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def both(jmat, mat, b, stream=None):
    want = np.asarray(jsg.spmm_gather(jmat, jnp.asarray(b), stream_bf16=stream))
    got = sg.spmm_gather(mat, torch.from_numpy(b), stream_bf16=stream).numpy()
    return got, want


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("d", [8, 48, 130])
@pytest.mark.parametrize("kind", ["weighted", "binary"])
def test_matches_jax(kind, d, stream):
    """Weighted and binary walks; in stream mode both sides round the same
    operand to bfloat16 and sum in float32."""
    g = sparse.random_graph(2000, 5, seed=d, weights="uniform" if kind == "weighted" else "ones")
    jmat, mat = jsg.gather_mat_from_csr(g), sg.gather_mat_from_csr(g, device="cpu")
    assert mat.has_w == (kind == "weighted") == jmat.has_w
    assert_close(*both(jmat, mat, operand(2000, d, seed=d), stream))


@pytest.mark.parametrize("side", ["pre", "post"])
def test_scale_sides_match_jax(side):
    g = signed(400, 400, density=0.02, seed=3)
    g = CSRData(g.indptr, g.indices, np.ones_like(g.data), g.shape)
    scale = np.random.default_rng(1).random(400).astype(np.float32) + 0.25
    jmat = jsg.gather_mat_from_csr(g, scale=scale, scale_side=side)
    mat = sg.gather_mat_from_csr(g, device="cpu", scale=scale, scale_side=side)
    assert_close(*both(jmat, mat, operand(400, 24)))


@pytest.mark.parametrize("shape", [(300, 700), (700, 300)])
def test_rectangular_signed_match_jax(shape):
    g = signed(*shape, density=0.02, seed=2)
    assert_close(*both(jsg.gather_mat_from_csr(g), sg.gather_mat_from_csr(g, device="cpu"), operand(shape[1], 16)))


def test_empty_rows_and_empty_matrix():
    n = 1200
    dense = np.zeros((n, n), np.float32)
    dense[:100, :50] = 0.5
    dense[1100:, 600:700] = 1.5
    m = sps.csr_matrix(dense)
    g = CSRData(m.indptr.astype(np.int64), m.indices.astype(np.int32), m.data.astype(np.float32), m.shape)
    got, want = both(jsg.gather_mat_from_csr(g), sg.gather_mat_from_csr(g, device="cpu"), operand(n, 16))
    assert_close(got, want)
    assert not np.any(got[100:1100])
    empty = CSRData(np.zeros(301, np.int64), np.zeros(0, np.int32), np.zeros(0, np.float32), (300, 200))
    got, want = both(jsg.gather_mat_from_csr(empty), sg.gather_mat_from_csr(empty, device="cpu"), operand(200, 8))
    assert got.shape == want.shape == (300, 8) and not np.any(got) and not np.any(want)


@pytest.mark.parametrize("stream", [False, True])
def test_binary_pair_matches_jax(stream):
    """gather_pair_from_binary_csr: the same 1/max(in-degree, 1) diagonal,
    post-scaled forward (Aᵀ) and pre-scaled backward (A)."""
    g = sparse.random_graph(1500, 6, seed=4)
    jfwd, jbwd = jsg.gather_pair_from_binary_csr(g)
    fwd, bwd = sg.gather_pair_from_binary_csr(g, device="cpu", stream_bf16=stream)
    assert (fwd.scale_side, bwd.scale_side) == ("post", "pre")
    np.testing.assert_array_equal(fwd.scale.numpy(), np.asarray(jfwd.scale))
    b = operand(1500, 41)
    for jm, m in ((jfwd, fwd), (jbwd, bwd)):
        assert not m.has_w
        assert_close(*both(jm, m, b, stream))
    # the pair is the normalized operator: Âᵀ B and Â B (float32 operand)
    a = sparse.normalize(g, axis=True).to_dense().astype(np.float64)
    for m, want in ((fwd, a.T @ b), (bwd, a @ b)):
        got = sg.spmm_gather(m, torch.from_numpy(b), stream_bf16=False).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_weighted_pair_matches_jax():
    g = sparse.normalize(sparse.random_graph(800, 7, seed=6, weights="uniform"), axis=True)
    g_t = sparse.transpose(g)
    jpair = jsg.gather_pair_from_csr_pair(g_t, g)
    pair = sg.gather_pair_from_csr_pair(g_t, g, device="cpu")
    b = operand(800, 33)
    for jm, m in zip(jpair, pair):
        assert m.has_w
        assert_close(*both(jm, m, b))


def test_binary_pair_rejects_weights():
    with pytest.raises(ValueError, match="all-ones"):
        sg.gather_pair_from_binary_csr(sparse.random_graph(50, 3, weights="uniform"), device="cpu")


@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [True, False])
def test_plain_version_against_dense(weighted, b_dtype):
    g = signed(200, 150, density=0.05, seed=4)
    w = torch.from_numpy(g.data) if weighted else None
    b = torch.from_numpy(operand(150, 16)).to(b_dtype)
    got = sg.gather(torch.from_numpy(g.indptr), torch.from_numpy(g.indices), w, b)
    assert got.dtype == torch.float32
    vals = g.data if weighted else np.ones_like(g.data)
    want = sps.csr_matrix((vals.astype(np.float64), g.indices, g.indptr), shape=g.shape) @ b.double().numpy()
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
