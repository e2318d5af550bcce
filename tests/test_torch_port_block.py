"""Port vs JAX package: the block-sparse pattern pair — the tile store, the
two products (JAX side in Pallas interpret mode, port side on the kernels'
plain versions), the refusals, GCN on the pair and the 3-epoch trajectory.
Same numpy inputs into both."""

import numpy as np
import pytest
import scipy.sparse as ss
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu import train as jtrain
from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.formats import Dataset as JDataset
from mg_gcn_tpu.models import gcn as jgcn
from mg_gcn_tpu.ops import spmm as jspmm
from mg_gcn_tpu.ops import spmm_pattern_sparse as jsps
from mg_gcn_tpu_torch import convert, sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.models import gcn as tgcn
from mg_gcn_tpu_torch.ops import spmm as tspmm
from mg_gcn_tpu_torch.ops import spmm_pattern_sparse as sps

CPU = torch.device("cpu")
# f32 and bf16 see the same (rounded) inputs on both sides and differ only
# in the order of their f32 sums; int8 sums are int32 and exact
TOL = {"float32": 1e-5, "bfloat16": 1e-4}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    # the JAX block kernels run as tests/test_pattern_sparse.py runs them
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(jsps.pl, "pallas_call", patched)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jcsr(g):
    return JCSRData(g.indptr, g.indices, g.data, g.shape)


def _from_edges(n, src, dst):
    m = ss.csr_matrix((np.ones(len(src), np.float32), (src, dst)), shape=(n, n))
    m.sum_duplicates()
    m.data[:] = 1.0
    return CSRData.from_scipy(m)


@pytest.fixture(scope="module")
def banded():
    """A band of half-width 300 around the diagonal (bench.py's banded graph
    at a small size): 3 row blocks' worth of tiles per group, planes mostly
    dead."""
    return sparse.banded_graph(9000, 6, 300, seed=5)


def gappy_graph():
    """Empty rows, an empty row block (rows 4096-4607), an empty group
    (columns 4096-8191) and edges in the last plane of a group (bit 31)."""
    rng = np.random.default_rng(2)
    n = 12_288
    src = rng.integers(0, 4096, 3000)
    dst = rng.integers(0, 4096, 3000)
    src = np.concatenate([src, rng.integers(4608, n, 3000), np.arange(3968, 4096), [9000, 9001]])
    dst = np.concatenate([dst, rng.integers(8192, n, 3000), np.arange(3968, 4096), [12_287, 8191 + 4096]])
    keep = (src % 7) != 3  # empty rows everywhere
    return _from_edges(n, src[keep], dst[keep])


@pytest.mark.parametrize("build_on_device", [True, False], ids=["device-build", "host-build"])
@pytest.mark.parametrize("tile_r", [128, 256, 512])
def test_tile_store_matches_jax(banded, tile_r, build_on_device):
    """The store is JAX's ``tiles[:T]`` bit for bit, in the same tile order;
    JAX's store has one more tile, the all-zero dummy tile its schedules
    point empty output blocks at, which the port does not build."""
    jf, _ = jsps.block_pattern_pair_from_binary_csr(_jcsr(banded), dtype="float32", tile_r=tile_r)
    f, b = sps.block_pattern_pair_from_binary_csr(banded, dtype="float32", tile_r=tile_r, device=CPU,
                                                  build_on_device=build_on_device)
    T = f.num_tiles
    assert T == jf.num_tiles - 1
    np.testing.assert_array_equal(f.tiles.numpy(), np.asarray(jf.tiles)[:T])
    assert not np.asarray(jf.tiles)[T].any()
    n_blocks = (f.n_pad // tile_r) * (f.n_pad // sps.GROUP)
    assert f.occupancy == (jf.num_tiles - 1) / n_blocks and jf.occupancy == jf.num_tiles / n_blocks
    assert f.plane_occ == jf.plane_occ
    assert (f.n, f.n_pad, f.nnz, f.tile_r) == (jf.n, jf.n_pad, jf.nnz, jf.tile_r)
    np.testing.assert_array_equal(f.scale.numpy(), np.asarray(jf.scale))
    assert b.tiles is f.tiles and (f.orientation, b.orientation) == ("PT", "P")
    # the schedules' tiles, by group (forward) and by row block (backward)
    assert sorted(f.g_tiles.tolist()) == list(range(T))
    assert np.all(np.diff(f.tile_rb.numpy()) >= 0)
    live = {int(t) for t in np.asarray(jf.fwd_tile) if t < T}
    assert live == set(range(T))


def test_device_build_equals_host_build(banded):
    dev = sps.block_pattern_pair_from_binary_csr(banded, device=CPU, build_on_device=True)[0]
    host = sps.block_pattern_pair_from_binary_csr(banded, device=CPU, build_on_device=False)[0]
    for k in ("tiles", "tile_rb", "tile_g", "rb_ptr", "g_ptr", "g_tiles", "pmask", "scale"):
        assert torch.equal(getattr(dev, k), getattr(host, k)), k
    assert dev.plane_occ == host.plane_occ


@pytest.mark.parametrize("which", ["banded", "gappy", "uniform"])
def test_estimate_occupancy_matches_jax(banded, which):
    g = {"banded": banded, "gappy": gappy_graph(), "uniform": sparse.random_graph(5000, 8, seed=1)}[which]
    got, want = sps.estimate_occupancy(g), jsps.estimate_occupancy(_jcsr(g))
    assert got == tuple(float(w) for w in want)


def test_plane_masks_name_the_live_planes():
    g = gappy_graph()
    f, _ = sps.block_pattern_pair_from_binary_csr(g, device=CPU)
    words = f.tiles.numpy().view(np.uint32).reshape(f.num_tiles, -1)
    want = np.bitwise_or.reduce(words, axis=1)
    np.testing.assert_array_equal(f.pmask.numpy().view(np.uint32), want)
    assert (want >> 31).any()  # bit 31 is live somewhere


@pytest.mark.parametrize("orientation", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [8, 41, 130])
def test_spmm_block_pattern_matches_jax(banded, orientation, dtype, d):
    jfwd, jbwd = jsps.block_pattern_pair_from_binary_csr(_jcsr(banded), dtype=dtype)
    fwd, bwd = sps.block_pattern_pair_from_binary_csr(banded, dtype=dtype, device=CPU)
    b = np.random.default_rng(d).standard_normal((banded.nrows, d)).astype(np.float32)
    jm, m = (jfwd, fwd) if orientation == "fwd" else (jbwd, bwd)
    want = np.asarray(jsps.spmm_block_pattern(jm, jnp.asarray(b)))
    got = tspmm.spmm(m, _t(b)).numpy()
    assert got.shape == want.shape == (banded.nrows, d)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("tile_r", [128, 256, 512])
def test_tile_r_variants_against_dense(tile_r):
    g = gappy_graph()
    fwd, bwd = sps.block_pattern_pair_from_binary_csr(g, dtype="float32", tile_r=tile_r, device=CPU)
    assert fwd.tiles.shape[1] == tile_r
    b = np.random.default_rng(7).standard_normal((g.nrows, 9))
    a_hat = sparse.normalize(g, axis=True).to_dense().astype(np.float64)
    got_f = sps.spmm_block_pattern(fwd, _t(b.astype(np.float32))).numpy()
    np.testing.assert_allclose(got_f, a_hat.T @ b, rtol=1e-5, atol=1e-5)
    got_b = sps.spmm_block_pattern(bwd, _t(b.astype(np.float32))).numpy()
    np.testing.assert_allclose(got_b, a_hat @ b, rtol=1e-5, atol=1e-5)


def test_empty_output_blocks_zeroed():
    """Rows of the empty row block and columns of the empty group come out
    0 (JAX visits them with its dummy tile; the port's kernels write zeros
    where no tile reaches)."""
    g = gappy_graph()
    fwd, bwd = sps.block_pattern_pair_from_binary_csr(g, dtype="float32", device=CPU)
    assert fwd.rb_ptr[8] == fwd.rb_ptr[9]  # row block 8 (rows 4096-4607) holds no tile
    assert 1 not in fwd.tile_g.tolist()  # group 1 (columns 4096-8191) holds no tile
    b = torch.ones((g.nrows, 8))
    assert not sps.spmm_block_pattern(bwd, b)[4096:4608].any()
    assert not sps.spmm_block_pattern(fwd, b)[4096:8192].any()
    jfwd, jbwd = jsps.block_pattern_pair_from_binary_csr(_jcsr(g), dtype="float32")
    for m, jm in ((fwd, jfwd), (bwd, jbwd)):
        want = np.asarray(jsps.spmm_block_pattern(jm, jnp.ones((g.nrows, 8))))
        np.testing.assert_allclose(sps.spmm_block_pattern(m, b).numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("transpose", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_plain_versions_against_dense(transpose, dtype):
    """The kernels' plain versions against a dense 0/1 matmul in float64,
    with set bits in plane 31 (the int32 sign bit)."""
    g = gappy_graph()
    fwd, _ = sps.block_pattern_pair_from_binary_csr(g, device=CPU)
    rng = np.random.default_rng(1)
    if dtype == torch.int8:
        b = _t(rng.integers(-127, 128, (fwd.n_pad, 16)).astype(np.int8))
    else:
        b = _t(rng.standard_normal((fwd.n_pad, 16)).astype(np.float32)).to(dtype)
    p = np.zeros((fwd.n_pad, fwd.n_pad))
    p[: g.nrows, : g.ncols] = g.to_dense()
    dense = (p.T if transpose else p) @ b.to(torch.float64).numpy()
    got = (sps.block_fwd if transpose else sps.block_bwd)(fwd, b)
    assert got.dtype == (torch.int32 if dtype == torch.int8 else torch.float32)
    if dtype == torch.int8:
        np.testing.assert_array_equal(got.numpy(), dense.astype(np.int64))
    else:
        np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-5)


def _addressing_graph():
    """One edge in every (512 x 4096) tile region of a 262,144-node graph:
    T = 32,768 tiles, T * 512 * 128 = 2^31."""
    n = 262_144
    rb, g = np.meshgrid(np.arange(n // 512), np.arange(n // 4096), indexing="ij")
    return _from_edges(n, (rb * 512).reshape(-1), (g * 4096).reshape(-1))


@pytest.mark.parametrize("case", ["weighted", "tile_r", "int32-addressing"])
def test_refusals_match_jax(case):
    kw = {}
    if case == "weighted":
        g = sparse.random_graph(64, 4, seed=5, weights="random")
    elif case == "tile_r":
        g, kw = sparse.random_graph(64, 4, seed=5), {"tile_r": 384}
    else:
        g = _addressing_graph()
    with pytest.raises(ValueError) as want:
        jsps.block_pattern_pair_from_binary_csr(_jcsr(g), **kw)
    with pytest.raises(ValueError) as got:
        sps.block_pattern_pair_from_binary_csr(g, device=CPU, **kw)
    assert str(got.value) == str(want.value)


def test_kernel_wrappers_count_no_cpu_launches(banded):
    fwd, bwd = sps.block_pattern_pair_from_binary_csr(banded, dtype="float32", device=CPU)
    before = (sum(sps.block_fwd.launches.values()), sum(sps.block_bwd.launches.values()))
    tspmm.spmm(fwd, torch.ones(banded.nrows, 8))
    tspmm.spmm(bwd, torch.ones(banded.nrows, 8))
    after = (sum(sps.block_fwd.launches.values()), sum(sps.block_bwd.launches.values()))
    assert after == before  # the plain versions ran: the tensors lie on the CPU


def _clustered_dataset(n=3000, feats=12, classes=5):
    g = sparse.banded_graph(n, 8, 200, seed=5)
    rng = np.random.default_rng(0)
    return Dataset(graph=g, features=rng.standard_normal((n, feats)).astype(np.float32),
                   labels=rng.integers(0, classes, (n, 1)).astype(np.int32), sets=np.zeros((n, 1), np.int32))


@pytest.mark.parametrize("parity", [True, False], ids=["parity", "exact"])
def test_loss_and_grad_on_block_pair_matches_jax(parity):
    ds = _clustered_dataset()
    sizes = (ds.num_features, 16, ds.num_labels)
    jparams = jgcn.init_params(jgcn.GCNConfig(sizes=sizes), jax.random.key(3))
    jpair = jtrain.build_agg_pair(_jcsr(ds.graph), impl="block", pattern_dtype="float32")
    x, y = ds.features, ds.labels.reshape(-1)
    jl, ja, jg = jgcn.loss_and_grad(jparams, jpair, jnp.asarray(x), jnp.asarray(y),
                                    jgcn.GCNConfig(sizes=sizes, parity=parity))
    pair = ttrain.build_agg_pair(ds.graph, impl="block", pattern_dtype="float32", device="cpu")
    assert isinstance(pair.fwd, sps.BlockPatternMat)
    params = convert.params_from_numpy([{k: np.asarray(v) for k, v in p.items()} for p in jparams], "cpu")
    loss, acc, grads = tgcn.loss_and_grad(params, pair, _t(x), _t(y.astype(np.int64)),
                                          tgcn.GCNConfig(sizes=sizes, parity=parity))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(acc) == float(ja)
    for gl, jgl in zip(grads, jg):
        for k in jgl:
            want = np.asarray(jgl[k])
            np.testing.assert_allclose(gl[k].numpy().reshape(want.shape), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_train_trajectory_on_block_pair_matches_jax():
    """3 epochs of ``train(impl="block")`` in both packages from the same
    seed-99 parameters, carried over through ``convert.params_from_numpy``."""
    ds = _clustered_dataset()
    jds = JDataset(graph=_jcsr(ds.graph), features=ds.features, labels=ds.labels, sets=ds.sets)
    sizes = (ds.num_features, 16, ds.num_labels)
    jparams = jgcn.init_params(jgcn.GCNConfig(sizes=sizes))
    want = jtrain.train(jds, [16], epochs=3, impl="block", pattern_dtype="float32", log=False)
    got = ttrain.train(ds, [16], epochs=3, impl="block", pattern_dtype="float32", device="cpu", log=False,
                       params=convert.params_from_numpy([{k: np.asarray(v) for k, v in p.items()} for p in jparams],
                                                        "cpu"))
    assert got.engine == "block"
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.accs == want.accs
    for layer, jlayer in zip(convert.params_to_numpy(got.params), want.params):
        for k in jlayer:
            np.testing.assert_allclose(layer[k], np.asarray(jlayer[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert got.losses[-1] < got.losses[0]


def test_coo_pair_equals_block_pair_in_float32():
    """The block pair against the port's COO engine, one float32 step."""
    ds = _clustered_dataset()
    config = tgcn.GCNConfig(sizes=(ds.num_features, 16, ds.num_labels))
    params = tgcn.init_params(config, device="cpu")
    x, y = _t(ds.features), _t(ds.labels.reshape(-1).astype(np.int64))
    steps = [tgcn.loss_and_grad(params, ttrain.build_agg_pair(ds.graph, impl=impl, pattern_dtype="float32",
                                                              device="cpu"), x, y, config)
             for impl in ("block", "xla")]
    np.testing.assert_allclose(float(steps[0][0]), float(steps[1][0]), rtol=1e-5)
    for gb, gc in zip(steps[0][2], steps[1][2]):
        for k in gc:
            np.testing.assert_allclose(gb[k].numpy(), gc[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_block_matrix_through_jax_coo_reference(banded):
    """The port's block forward against the JAX package's COO engine on Âᵀ."""
    a_t = jspmm.COOMat.from_csr(sparse.transpose(sparse.normalize(banded, axis=True)))
    b = np.random.default_rng(4).standard_normal((banded.nrows, 24)).astype(np.float32)
    want = np.asarray(jspmm.spmm(a_t, jnp.asarray(b)))
    fwd, _ = sps.block_pattern_pair_from_binary_csr(banded, dtype="float32", device=CPU)
    np.testing.assert_allclose(tspmm.spmm(fwd, _t(b)).numpy(), want, rtol=1e-5, atol=1e-6)
