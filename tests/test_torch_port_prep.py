"""Port vs JAX package: dataset preparation and the host graph tools —
``data/prep.py`` (toy, synthetic, DGL/OGB through mocked packages, the
``cluster`` and ``commvolume`` commands), the ``sparse`` additions and
``formats.ensure_pigo_transpose``. The files each package writes are
compared byte for byte."""

import os
import sys
import types

import numpy as np
import pytest
import scipy.sparse as ss

from mg_gcn_tpu import sparse as jsparse
from mg_gcn_tpu.data import prep as jprep
from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu_torch import formats, sparse
from mg_gcn_tpu_torch.data import prep
from mg_gcn_tpu_torch.formats import Dataset

FILES = ("graph.bin", "features.bin", "labels.bin", "sets.bin")


def _jcsr(g):
    return JCSRData(g.indptr, g.indices, g.data, g.shape)


def _assert_csr_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got.indptr), np.asarray(want.indptr))
    np.testing.assert_array_equal(np.asarray(got.indices), np.asarray(want.indices))
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    assert tuple(got.shape) == tuple(want.shape)


def _assert_dirs_equal(got, want, files=FILES):
    for f in files:
        assert open(os.path.join(got, f), "rb").read() == open(os.path.join(want, f), "rb").read(), f


def _small_dataset(n=40, seed=0):
    g = sparse.random_graph(n, 3, seed=seed, self_loops=False)
    rng = np.random.default_rng(seed)
    return (g, rng.random((n, 5), np.float32), rng.integers(0, 3, n).astype(np.int32),
            rng.choice([0, 0, 1, 2], n).astype(np.int32))


def test_make_toy_byte_equal_to_jax(tmp_path):
    got = prep.make_toy(str(tmp_path / "port"))
    want = jprep.make_toy(str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == ["toyA", "toyB"]
    for g, w in zip(got, want):
        assert sorted(os.listdir(g)) == sorted(os.listdir(w)) == sorted(FILES)
        _assert_dirs_equal(g, w)


@pytest.mark.parametrize("perm_seed", [0, 3])
def test_make_synthetic_byte_equal_to_jax(tmp_path, perm_seed):
    got = prep.make_synthetic(300, 5, 6, 4, str(tmp_path / "port"), P=8, seed=2, perm_seed=perm_seed)
    want = jprep.make_synthetic(300, 5, 6, 4, str(tmp_path / "jax"), P=8, seed=2, perm_seed=perm_seed)
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(want, tmp_path / "jax")
    _assert_dirs_equal(got, want, FILES + ("graph_t.bin",))
    # the port's transpose carries the digest of the graph it was built from
    assert sorted(os.listdir(got)) == sorted(os.listdir(want) + ["graph_t.bin.sha256"])


@pytest.mark.parametrize("P", [8, 3])
def test_pad_graph_matches_jax(P):
    g, x, y, s = _small_dataset(43)
    got = prep.pad_graph(g, x, y, s, P=P)
    want = jprep.pad_graph(_jcsr(g), x, y, s, P=P)
    _assert_csr_equal(got.graph, want.graph)
    for k in ("features", "labels", "sets"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert getattr(got, k).dtype == getattr(want, k).dtype


def test_permuted_variant_matches_jax():
    g, x, y, s = _small_dataset(40)
    ds = prep.pad_graph(g, x, y, s)
    jds = jprep.pad_graph(_jcsr(g), x, y, s)
    got, want = prep.permuted_variant(ds, 7), jprep.permuted_variant(jds, 7)
    _assert_csr_equal(got.graph, want.graph)
    for k in ("features", "labels", "sets"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


@pytest.mark.parametrize("method", ["rcm", "bfs", "degree"])
def test_cluster_order_matches_jax(method):
    g = sparse.random_graph(500, 3, seed=4)
    got = sparse.cluster_order(g, method)
    np.testing.assert_array_equal(got, jsparse.cluster_order(_jcsr(g), method))
    assert sorted(got.tolist()) == list(range(500))


def test_cluster_order_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown cluster method"):
        sparse.cluster_order(sparse.random_graph(20, 2), "metis")


@pytest.mark.parametrize("method", ["rcm", "bfs"])
def test_cluster_command_matches_jax(tmp_path, method, capsys):
    src = prep.make_synthetic(200, 4, 5, 3, str(tmp_path), seed=1)
    args = ["cluster", src, "--cluster", method]
    assert prep.main([*args[:2], str(tmp_path / "port"), *args[2:]]) == 0
    assert jprep.main([*args[:2], str(tmp_path / "jax"), *args[2:]]) == 0
    _assert_dirs_equal(tmp_path / "port", tmp_path / "jax")
    # the default destination, <dir>_clustered, and the default order, RCM
    assert prep.main(["cluster", src]) == 0
    assert os.path.isdir(src + "_clustered")
    assert capsys.readouterr().out.splitlines()[-1] == f"wrote {src}_clustered"


def test_clustering_makes_tiles_skippable(tmp_path):
    """RCM on a shuffled banded graph brings back a low tile occupancy:
    what the block pair is for."""
    from mg_gcn_tpu_torch.ops.spmm_pattern_sparse import estimate_occupancy

    band = sparse.banded_graph(12_000, 4, 100, seed=1)
    shuffled = sparse.permute_symmetric(band, np.random.default_rng(0).permutation(12_000))
    before = estimate_occupancy(shuffled)[0]
    after = estimate_occupancy(sparse.permute_symmetric(shuffled, sparse.cluster_order(shuffled, "rcm")))[0]
    assert after < 0.5 <= before


@pytest.mark.parametrize("P", [2, 4])
def test_comm_volume_matches_jax(tmp_path, P, capsys):
    g = sparse.random_graph(300, 4, seed=6)
    part = sparse.uniform_partition(g.nrows, P)
    np.testing.assert_array_equal(part, jsparse.uniform_partition(g.nrows, P))
    np.testing.assert_array_equal(sparse.comm_volume(g, part), jsparse.comm_volume(_jcsr(g), part))
    path = prep.make_synthetic(100, 4, 5, 3, str(tmp_path), seed=3)
    got = prep.comm_volume_report(path, P)
    out = capsys.readouterr().out
    np.testing.assert_array_equal(got, jprep.comm_volume_report(path, P))
    assert out == capsys.readouterr().out


def test_sparse_helpers_match_jax():
    g = sparse.random_graph(120, 3, seed=8, self_loops=False)
    _assert_csr_equal(sparse.add_self_loops(g), jsparse.add_self_loops(_jcsr(g)))
    looped = sparse.add_self_loops(g)
    assert sparse.add_self_loops(looped) is looped
    perm = np.random.default_rng(1).permutation(120)
    _assert_csr_equal(sparse.permute_symmetric(g, perm), jsparse.permute_symmetric(_jcsr(g), perm))


def test_planted_graph_and_features_match_jax():
    got, comm = sparse.planted_graph(500, 6, 7, seed=3)
    want, jcomm = jsparse.planted_graph(500, 6, 7, seed=3)
    _assert_csr_equal(got, want)
    np.testing.assert_array_equal(comm, jcomm)
    np.testing.assert_array_equal(sparse.planted_features(comm, 16, seed=2),
                                  jsparse.planted_features(jcomm, 16, seed=2))


def test_banded_graph_is_bench_py_graph():
    """bench.py's construction (bench.py:283-291): scipy COO -> CSR with
    duplicates summed, data 1."""
    n, deg = 3000, 9
    rb = np.random.default_rng(7)
    src = np.arange(n, dtype=np.int64).repeat(deg)
    dst = np.clip(src + rb.integers(-200, 201, src.size), 0, n - 1)
    m = ss.csr_matrix((np.ones(src.size, np.float32), (src, dst)), shape=(n, n))
    m.sum_duplicates()
    m.data[:] = 1.0
    _assert_csr_equal(sparse.banded_graph(n, deg, 200, seed=7), JCSRData.from_scipy(m))


def test_prep_command_synthetic_and_commvolume(tmp_path, capsys):
    out = str(tmp_path)
    assert prep.main(["synthetic", "-n", "64", "--deg", "4", "--feat", "6", "--labels", "3", "-o", out]) == 0
    path = os.path.join(out, "synthetic")
    assert capsys.readouterr().out.strip() == f"wrote {path}"
    ds = Dataset.load(path)
    assert ds.num_nodes == 64 and ds.num_features == 8
    assert prep.main(["commvolume", path, "-P", "2"]) == 0
    assert "off-diagonal (cross-device) volume" in capsys.readouterr().out
    assert prep.main(["commvolume"]) == 2 and prep.main(["cluster"]) == 2


# ---------------------------------------------------------------------------
# DGL / OGB conversion, with the packages mocked (no download path)


class _T:
    def __init__(self, a):
        self._a = np.asarray(a)

    def numpy(self):
        return self._a


class _FakeGraph:
    def __init__(self, dense, ndata):
        self._dense, self.ndata = dense, ndata

    def number_of_nodes(self):
        return self._dense.shape[0]

    def adjacency_matrix(self, scipy_fmt):
        assert scipy_fmt == "csr"
        return ss.csr_matrix(self._dense)


@pytest.fixture
def fake_packages(monkeypatch):
    """dgl.data.RedditDataset / CoraGraphDataset and
    ogb.nodeproppred.DglNodePropPredDataset over one 10-node graph."""
    rng = np.random.default_rng(0)
    n = 10
    dense = (rng.random((n, n)) < 0.3).astype(np.float32)
    np.fill_diagonal(dense, 0)
    feats = rng.random((n, 5)).astype(np.float32)
    val, test = np.zeros(n, bool), np.zeros(n, bool)
    val[[2, 5]], test[[7, 8]] = True, True
    g = _FakeGraph(dense, dict(feat=_T(feats), label=_T(rng.integers(0, 3, n)), val_mask=_T(val),
                               test_mask=_T(test)))
    labels = rng.integers(0, 4, n).astype(np.float32)
    labels[[3, 6]] = np.nan

    class _Dataset:
        def __init__(self, name=None):
            pass

        def __getitem__(self, i):
            return g if self.__class__.__name__ != "_Ogb" else (g, _T(labels.reshape(-1, 1)))

    class _Ogb(_Dataset):
        def get_idx_split(self):
            return dict(train=_T([0, 1, 2, 4]), valid=_T([5, 7]), test=_T([8, 9]))

    dgl, dgl_data = types.ModuleType("dgl"), types.ModuleType("dgl.data")
    dgl_data.RedditDataset = dgl_data.CoraGraphDataset = _Dataset
    dgl.data = dgl_data
    ogb, ogb_np = types.ModuleType("ogb"), types.ModuleType("ogb.nodeproppred")
    ogb_np.DglNodePropPredDataset = _Ogb
    ogb.nodeproppred = ogb_np
    for name, mod in (("dgl", dgl), ("dgl.data", dgl_data), ("ogb", ogb), ("ogb.nodeproppred", ogb_np)):
        monkeypatch.setitem(sys.modules, name, mod)


@pytest.mark.parametrize("name,perm_seed", [("reddit", 0), ("cora", 5), ("ogbn-tiny", 0)])
def test_make_dgl_matches_jax(tmp_path, fake_packages, name, perm_seed):
    got = prep.make_dgl(name, str(tmp_path / "port"), perm_seed=perm_seed)
    want = jprep.make_dgl(name, str(tmp_path / "jax"), perm_seed=perm_seed)
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(want, tmp_path / "jax")
    _assert_dirs_equal(got, want, FILES + ("graph_t.bin",))
    ds = Dataset.load(got)
    assert ds.num_nodes == 16 and ds.num_features == 8 and ds.labels.min() >= 0


def test_make_dgl_without_the_packages_exits_with_jax_message(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "dgl", None)
    with pytest.raises(SystemExit) as got:
        prep.make_dgl("reddit", str(tmp_path))
    with pytest.raises(SystemExit) as want:
        jprep.make_dgl("reddit", str(tmp_path))
    assert str(got.value) == str(want.value) and "needs dgl/ogb installed" in str(got.value)
    with pytest.raises(SystemExit, match="unknown dataset"):
        prep.make_dgl("imagenet", str(tmp_path))


# ---------------------------------------------------------------------------
# ensure_pigo_transpose


def _write_graph(directory, seed):
    g = sparse.random_graph(200, 4, seed=seed, weights="random")
    os.makedirs(directory, exist_ok=True)
    formats.write_pigo_csr(os.path.join(directory, "graph.bin"), g)
    return g


def test_transpose_rebuilt_when_graph_rewritten_with_older_mtime(tmp_path):
    """graph.bin rewritten after the transpose was built, with an mtime set
    back before it: the JAX package's mtime guard keeps the stale transpose
    (the fault of its formats.py:375), the port rebuilds it."""
    d = str(tmp_path)
    _write_graph(d, 1)
    tpath = formats.ensure_pigo_transpose(d)
    built = os.path.getmtime(tpath)
    g2 = _write_graph(d, 2)
    os.utime(os.path.join(d, "graph.bin"), (built - 100, built - 100))
    # the JAX guard would keep it: the transpose is "newer" than the graph
    assert os.path.getmtime(tpath) >= os.path.getmtime(os.path.join(d, "graph.bin"))
    assert formats.ensure_pigo_transpose(d) == tpath
    _assert_csr_equal(formats.read_pigo_csr(tpath), sparse.transpose(g2))


def test_transpose_kept_while_graph_unchanged(tmp_path):
    d = str(tmp_path)
    g = _write_graph(d, 3)
    tpath = formats.ensure_pigo_transpose(d)
    _assert_csr_equal(formats.read_pigo_csr(tpath), sparse.transpose(g))
    stamp = os.stat(tpath).st_mtime_ns
    os.utime(os.path.join(d, "graph.bin"))  # touched, same bytes
    assert formats.ensure_pigo_transpose(d) == tpath
    assert os.stat(tpath).st_mtime_ns == stamp


def test_transpose_without_a_digest_is_rebuilt(tmp_path):
    """A graph_t.bin written by the JAX package (no digest) whose graph.bin
    was rewritten since: the port cannot vouch for it and rebuilds."""
    d = str(tmp_path)
    _write_graph(d, 4)
    from mg_gcn_tpu.formats import ensure_pigo_transpose as jax_ensure

    jax_ensure(d)
    g2 = _write_graph(d, 5)
    future = os.path.getmtime(os.path.join(d, "graph.bin")) + 1000
    os.utime(os.path.join(d, "graph_t.bin"), (future, future))
    tpath = formats.ensure_pigo_transpose(d)
    _assert_csr_equal(formats.read_pigo_csr(tpath), sparse.transpose(g2))
    assert os.path.exists(tpath + ".sha256")
