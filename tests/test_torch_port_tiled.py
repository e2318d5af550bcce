"""Port vs JAX package: the tiled-ELL engine — the store's arrays, the
product (JAX side in Pallas interpret mode, port side on the kernel's plain
version), the refusals of ``TiledMat.from_csr`` and GCN on ``impl="pallas"``. Same numpy
inputs into both."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu import train as jtrain
from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.models import gcn as jgcn
from mg_gcn_tpu.ops import spmm_pallas as jpl
from mg_gcn_tpu_torch import convert, sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.models import gcn as tgcn
from mg_gcn_tpu_torch.ops import spmm as tspmm
from mg_gcn_tpu_torch.ops import spmm_pallas as tpl

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jcsr(g):
    return JCSRData(g.indptr, g.indices, g.data, g.shape)


def _graph(which):
    if which == "golden":
        return sparse.normalize(Dataset.load(GOLDEN).graph, axis=True)
    if which == "hub":  # one row with 300 entries: K is set by it
        g = sparse.random_graph(700, 6, seed=2, weights="random")
        rows = np.repeat(np.arange(700), np.diff(g.indptr))
        rows[: 300] = 5
        m = CSRData(g.indptr, g.indices, g.data, g.shape).to_scipy().tocoo()
        import scipy.sparse as ss

        m = ss.csr_matrix((m.data, (rows, m.col)), shape=m.shape)
        m.sum_duplicates()
        return CSRData.from_scipy(m)
    return sparse.random_graph(700, 6, seed=2, weights="random")


@pytest.mark.parametrize("br", [64, 128])
@pytest.mark.parametrize("which", ["golden", "random", "hub"])
def test_ell_arrays_match_jax(which, br):
    g = _graph(which)
    want = jpl.TiledMat.from_csr(_jcsr(g), br=br, bc=br, interpret=True)
    got = tpl.TiledMat.from_csr(g, br=br, bc=br, device="cpu")
    for k in ("lcol", "val", "nsteps"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)
    assert (got.n_rows, got.n_cols, got.nnz, got.br, got.bc) == (want.n_rows, want.n_cols, want.nnz, want.br, want.bc)
    assert got.ell_k == want.ell_k and got.store_bytes == 2 * got.lcol.numel() * 4


@pytest.mark.parametrize("d", [1, 41, 130])
def test_spmm_tiled_matches_jax(d):
    g = _graph("hub")
    jm = jpl.TiledMat.from_csr(_jcsr(g), br=128, bc=128, interpret=True)
    m = tpl.TiledMat.from_csr(g, br=128, bc=128, device="cpu")
    b = np.random.default_rng(d).standard_normal((g.ncols, d)).astype(np.float32)
    want = np.asarray(jpl.spmm_tiled(jm, jnp.asarray(b)))
    got = tspmm.spmm(m, _t(b)).numpy()
    assert got.shape == want.shape == (g.nrows, d)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_plain_version_against_dense():
    g = _graph("hub")
    m = tpl.TiledMat.from_csr(g, br=64, bc=64, device="cpu")
    b = np.random.default_rng(3).standard_normal((m.n_cb * 64, 24))
    got = tpl.tiled(m, _t(b.astype(np.float32)))
    assert got.shape == (m.n_rb * 64, 24) and got.dtype == torch.float32
    want = g.to_dense().astype(np.float64) @ b[: g.ncols]
    np.testing.assert_allclose(got[: g.nrows].numpy(), want, rtol=1e-5, atol=1e-5)
    assert not got[g.nrows :].any()
    np.testing.assert_allclose(tpl.tiled_plain(m, _t(b), torch.float64)[: g.nrows].numpy(), want, rtol=1e-12)


def test_refuses_non_square_tiles_like_jax():
    g = _graph("random")
    with pytest.raises(ValueError) as want:
        jpl.TiledMat.from_csr(_jcsr(g), br=128, bc=256)
    with pytest.raises(ValueError) as got:
        tpl.TiledMat.from_csr(g, br=128, bc=256, device="cpu")
    assert str(got.value) == str(want.value)


def test_refuses_a_store_over_4e9_bytes_before_allocating(monkeypatch):
    """A 2,000,000-node graph with one hub row of 40 entries in one tile:
    K = 40, 2 x 3907² tiles x 40 x 512 x 4 bytes = 2.5e12. Both packages
    refuse with one message; the port's allocates no store array first."""
    n = 2_000_000
    indptr = np.zeros(n + 1, np.int64)
    indptr[6:] = 40
    g = CSRData(indptr, np.arange(40, dtype=np.int32), np.ones(40, np.float32), (n, n))
    with pytest.raises(ValueError) as want:
        jpl.TiledMat.from_csr(_jcsr(g))
    big = []
    zeros = np.zeros

    def watch(shape, *a, **kw):
        if np.prod(shape) > 10**8:
            big.append(shape)
        return zeros(shape, *a, **kw)

    monkeypatch.setattr(tpl.np, "zeros", watch)
    with pytest.raises(ValueError) as got:
        tpl.TiledMat.from_csr(g, device="cpu")
    assert str(got.value) == str(want.value) and "2501.0 GB" in str(got.value)
    assert big == []


def test_kernel_wrapper_counts_no_cpu_launches():
    m = tpl.TiledMat.from_csr(_graph("random"), br=128, bc=128, device="cpu")
    before = sum(tpl.tiled.launches.values())
    tspmm.spmm(m, torch.ones(700, 8))
    assert sum(tpl.tiled.launches.values()) == before  # the plain version ran: the tensor lies on the CPU


@pytest.mark.parametrize("parity", [True, False], ids=["parity", "exact"])
def test_loss_and_grad_on_pallas_pair_matches_jax(parity):
    """GCN on the tiled-ELL pair in both packages (JAX kernel in interpret
    mode), the golden dataset, from the same parameters."""
    ds = Dataset.load(GOLDEN)
    sizes = (ds.num_features, 16, ds.num_labels)
    jparams = jgcn.init_params(jgcn.GCNConfig(sizes=sizes), jax.random.key(2))
    jpair = jtrain.build_agg_pair(_jcsr(ds.graph), impl="pallas", tile_br=128, tile_bc=128, interpret=True)
    x, y = ds.features, ds.labels.reshape(-1)
    config = dict(sizes=sizes, parity=parity)
    jl, ja, jg = jgcn.loss_and_grad(jparams, jpair, jnp.asarray(x), jnp.asarray(y), jgcn.GCNConfig(**config))
    pair = ttrain.build_agg_pair(ds.graph, impl="pallas", tile_br=128, tile_bc=128, device="cpu")
    assert isinstance(pair.fwd, tpl.TiledMat) and pair.fwd.br == 128
    params = convert.params_from_numpy([{k: np.asarray(v) for k, v in p.items()} for p in jparams], "cpu")
    loss, acc, grads = tgcn.loss_and_grad(params, pair, _t(x), _t(y.astype(np.int64)), tgcn.GCNConfig(**config))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(acc) == float(ja)
    for gl, jgl in zip(grads, jg):
        for k in jgl:
            want = np.asarray(jgl[k])
            np.testing.assert_allclose(gl[k].numpy().reshape(want.shape), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_one_train_step_on_pallas_matches_coo():
    """One ``train(impl="pallas")`` step against ``train(impl="xla")``."""
    ds = Dataset.load(GOLDEN)
    got = ttrain.train(ds, [16], epochs=1, impl="pallas", device="cpu", log=False)
    want = ttrain.train(ds, [16], epochs=1, impl="xla", device="cpu", log=False)
    assert got.engine == "pallas"
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.accs == want.accs
    for layer, wlayer in zip(got.params, want.params):
        for k in wlayer:
            np.testing.assert_allclose(layer[k].numpy(), wlayer[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
