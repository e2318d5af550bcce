"""Port vs JAX package: the host library (``mg_gcn_tpu_torch/native.py`` and
its own ``csrc/host/mggcn_host.cpp``) element for element against the
port's numpy path and against ``mg_gcn_tpu.native`` / ``mg_gcn_tpu.sparse``
on the same CSR; ``MG_GCN_NO_NATIVE=1``; where the library is built."""

import os

import numpy as np
import pytest
import torch

from mg_gcn_tpu import native as jnative
from mg_gcn_tpu import sparse as jsparse
from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu_torch import native, sparse
from mg_gcn_tpu_torch.formats import CSRData

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def need_native():
    if not native.available():
        pytest.skip("no C++ compiler: the port computes in numpy")


def graph(weights: str, seed: int, n: int = 700, deg: float = 9.0) -> CSRData:
    return sparse.random_graph(n, deg, seed=seed, weights=weights)


def edge_graph() -> CSRData:
    """Empty rows and columns (the last quarter), a hub row and column, a
    rectangular shape."""
    rng = np.random.default_rng(3)
    n, m = 300, 410
    rows = np.concatenate([rng.integers(0, 220, 2000), np.full(300, 7), rng.integers(0, 220, 300)])
    cols = np.concatenate([rng.integers(0, 300, 2000), rng.integers(0, 300, 300), np.full(300, 11)])
    import scipy.sparse as ss

    sp = ss.csr_matrix((rng.random(rows.size).astype(np.float32) + 0.5, (rows, cols)), shape=(n, m))
    sp.sum_duplicates()
    sp.sort_indices()
    return CSRData.from_scipy(sp)


def numpy_path(monkeypatch, fn, *args):
    monkeypatch.setenv("MG_GCN_NO_NATIVE", "1")
    try:
        return fn(*args)
    finally:
        monkeypatch.delenv("MG_GCN_NO_NATIVE")


def as_jax(g: CSRData) -> JCSRData:
    return JCSRData(g.indptr, g.indices, g.data, g.shape)


def same_csr(a, b) -> None:
    assert a.shape == b.shape
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices), (a.data, b.data)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


CASES = [("ones", 0), ("ones", 1), ("random", 2), ("random", 3), ("edge", 0)]


def case_graph(weights, seed):
    return edge_graph() if weights == "edge" else graph(weights, seed)


@pytest.mark.parametrize("weights,seed", CASES)
@pytest.mark.parametrize("axis", [False, True])
def test_normalize_equals_numpy_and_jax(need_native, monkeypatch, weights, seed, axis):
    """Element-equal to the port's numpy path and to the JAX package's
    numpy path; to ``mg_gcn_tpu.native`` too, but on weighted rows at
    axis=False within one ulp: the JAX library multiplies by the float64
    reciprocal of the row sum, its own numpy path (and this library)
    divide by the float32 sum."""
    g = case_graph(weights, seed)
    got = native.normalize(g, axis)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, sparse.normalize(g, axis).data)
    np.testing.assert_array_equal(got, numpy_path(monkeypatch, sparse.normalize, g, axis).data)
    np.testing.assert_array_equal(got, numpy_path(monkeypatch, jsparse.normalize, as_jax(g), axis).data)
    if jnative.available():
        theirs = jnative.normalize(as_jax(g), axis)
        if axis or weights == "ones":
            np.testing.assert_array_equal(got, theirs)
        else:
            assert np.abs(got.view(np.int32) - theirs.view(np.int32)).max() <= 1


@pytest.mark.parametrize("weights,seed", CASES)
def test_transpose_equals_numpy_and_jax(need_native, monkeypatch, weights, seed):
    """The stable counting sort's entry order (tests/test_native.py:85):
    equal to the port's and the JAX package's numpy transposes and to the
    JAX library's."""
    g = case_graph(weights, seed)
    got = native.transpose(g)
    same_csr(got, numpy_path(monkeypatch, sparse.transpose, g))
    same_csr(got, numpy_path(monkeypatch, jsparse.transpose, as_jax(g)))
    same_csr(got, sparse.transpose(g))
    if jnative.available():
        same_csr(got, jnative.transpose(as_jax(g)))


def test_transpose_keeps_duplicate_entries_in_source_order(need_native, monkeypatch):
    """Repeated (row, column) entries with different values: the stable
    order of np.argsort(kind="stable"), on one chunk or several."""
    indptr = np.array([0, 3, 3, 6, 8], np.int64)
    indices = np.array([2, 2, 0, 1, 2, 2, 0, 2], np.int32)
    data = np.arange(1, 9, dtype=np.float32)
    g = CSRData(indptr, indices, data, (4, 3))
    same_csr(native.transpose(g), numpy_path(monkeypatch, sparse.transpose, g))


@pytest.mark.parametrize("parts", [1, 3, 4])
def test_comm_volume_and_expand_rows_equal(need_native, monkeypatch, parts):
    g = graph("random", 5, n=64 * parts)
    part = sparse.uniform_partition(g.nrows, parts)
    got = native.comm_volume(g, part)
    np.testing.assert_array_equal(got, numpy_path(monkeypatch, sparse.comm_volume, g, part))
    np.testing.assert_array_equal(got, numpy_path(monkeypatch, jsparse.comm_volume, as_jax(g), part))
    np.testing.assert_array_equal(got, sparse.comm_volume(g, part))
    rows = native.expand_rows(g)
    np.testing.assert_array_equal(rows, sparse._expand_rows(g))
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.comm_volume(as_jax(g), part))
        np.testing.assert_array_equal(rows, jnative.expand_rows(as_jax(g)))


def test_no_native_env_gives_the_numpy_path(need_native, monkeypatch):
    """``MG_GCN_NO_NATIVE=1`` turns the library off at the next call:
    ``available()`` is False and ``sparse`` never calls into it."""
    g = graph("random", 6)
    monkeypatch.setenv("MG_GCN_NO_NATIVE", "1")
    assert not native.available()

    def refuse(*_args):
        raise AssertionError("the library was called under MG_GCN_NO_NATIVE")

    for name in ("normalize", "transpose", "comm_volume"):
        monkeypatch.setattr(native, name, refuse)
    sparse.normalize(g, axis=True)
    sparse.normalize(g, axis=False)
    sparse.transpose(g)
    sparse.comm_volume(g, sparse.uniform_partition(g.nrows, 2))
    monkeypatch.delenv("MG_GCN_NO_NATIVE")
    assert native.available()


def test_library_lands_in_the_port_build_dir(need_native):
    """Built from the port's own source into mg_gcn_tpu_torch/_build/, its
    name keyed by the source and flags; the JAX package's csrc/build/ holds
    nothing of it."""
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "mg_gcn_tpu_torch", "_build")
    assert os.path.isfile(path)
    assert native.SOURCE == os.path.join(REPO, "mg_gcn_tpu_torch", "csrc", "host", "mggcn_host.cpp")
    jax_build = os.path.join(REPO, "csrc", "build")
    if os.path.isdir(jax_build):
        assert not [f for f in os.listdir(jax_build) if f.startswith("libmggcn_host-")]
    assert native.num_threads() >= 1


def test_build_writes_a_temporary_then_renames(need_native, monkeypatch, tmp_path):
    """A fresh build goes to a temporary name and is renamed into place, and
    the loader uses the library at the keyed path."""
    out = str(tmp_path / os.path.basename(native.library_path()))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    assert native._build(out)
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(out)]
