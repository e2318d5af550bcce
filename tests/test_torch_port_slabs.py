"""Port vs JAX package: the slab reads of ``formats.py`` and the per-process
halo builds of ``parallel/dist_halo.py`` (``from_slabs``, ``from_pigo``), in
one process on the CPU.

Every reader (``read_pigo_csr_slab`` and its bounds, the header, the row
count, ``read_pigo_indptr_at``, the chunked float64 row sums, the mapped
dense read and its size check, ``Dataset.load(graph_mode="header",
mmap_features=True)``) equals the JAX package's on the same files, array for
array. The port's ``from_slabs`` / ``from_pigo`` builds equal JAX's (one
process, its host arrays) and the port's own ``from_csr``: blocks, send
lists, round widths, halo total and nnz, for the gcn and sage norms on the
COO and serial-gather engines at P = 2 and 4 (weights within rtol 1e-6,
indices exact). Then the two faults of the JAX build that the port does not
repeat: a read-only dataset directory still builds (the row sums stay in
memory), and a row-sums cache is found by the source's content, never by
mtime. ``formats.check_pigo_transpose`` names ``ensure_pigo_transpose``."""

import os

import numpy as np
import pytest
import torch

from mg_gcn_tpu import formats as jformats
from mg_gcn_tpu.parallel import dist_halo as jhalo
from mg_gcn_tpu_torch import formats, sparse
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.ops.spmm import COOMat
from mg_gcn_tpu_torch.parallel import dist, dist_halo
from tests.torch_port_dist_cases import cpu_ring, expand_rows, jcsr, weighted_graph


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _dataset(directory, n=192, seed=11, transpose=True) -> Dataset:
    """A weighted non-symmetric graph with features, labels and sets, saved
    to ``directory`` (with ``graph_t.bin`` unless ``transpose`` is False)."""
    rng = np.random.default_rng(seed)
    ds = Dataset(graph=weighted_graph(n, 6, seed=seed), features=rng.standard_normal((n, 10)).astype(np.float32),
                 labels=rng.integers(0, 4, (n, 1)).astype(np.int32), sets=rng.integers(0, 3, (n, 1)).astype(np.int32))
    ds.save(directory)
    if transpose:
        formats.ensure_pigo_transpose(directory)
    return ds


@pytest.fixture
def files(tmp_path):
    d = str(tmp_path / "ds")
    _dataset(d)
    return d


def _same(a, b):
    assert type(a) is type(b) or not isinstance(a, np.ndarray)
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("r0,r1", [(0, 48), (48, 144), (144, 192), (0, 192), (100, 100)])
def test_read_pigo_csr_slab_equals_jax(files, r0, r1):
    path = os.path.join(files, "graph.bin")
    got, want = formats.read_pigo_csr_slab(path, r0, r1), jformats.read_pigo_csr_slab(path, r0, r1)
    assert got.shape == want.shape == (r1 - r0, 192)
    for f in ("indptr", "indices", "data"):
        _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("r0,r1", [(0, 193), (-1, 4), (10, 9)])
def test_read_pigo_csr_slab_bounds_equal_jax(files, r0, r1):
    path = os.path.join(files, "graph.bin")
    with pytest.raises(ValueError) as got:
        formats.read_pigo_csr_slab(path, r0, r1)
    with pytest.raises(ValueError) as want:
        jformats.read_pigo_csr_slab(path, r0, r1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["graph.bin", "graph_t.bin"])
def test_header_readers_equal_jax(files, name):
    path = os.path.join(files, name)
    got, want = formats.read_pigo_header(path), jformats.read_pigo_header(path)
    assert (got.nrows, got.ncols, got.nnz, got.path) == (want.nrows, want.ncols, want.nnz, want.path)
    assert formats.read_pigo_nrows(path) == jformats.read_pigo_nrows(path) == 192
    rows = [0, 1, 47, 96, 191, 192]
    _same(formats.read_pigo_indptr_at(path, rows), jformats.read_pigo_indptr_at(path, rows))


@pytest.mark.parametrize("chunk_rows", [1, 7, 64, 1 << 22])
def test_read_pigo_row_sums_equal_jax(tmp_path, chunk_rows):
    """Chunked float64 row sums, with empty rows (and an empty last row)."""
    g = weighted_graph(64, 3, seed=5).to_scipy().tolil()
    for r in (0, 17, 18, 63):
        g[r, :] = 0
    path = str(tmp_path / "g.bin")
    formats.write_pigo_csr(path, CSRData.from_scipy(g.tocsr()))
    got = formats.read_pigo_row_sums(path, chunk_rows=chunk_rows)
    _same(got, jformats.read_pigo_row_sums(path, chunk_rows=chunk_rows))
    assert got[[0, 17, 18, 63]].tolist() == [0.0] * 4 and got.dtype == np.float64


def test_read_dense_mmap_equals_jax(files, tmp_path):
    path = os.path.join(files, "features.bin")
    got, want = formats.read_dense(path, mmap=True), jformats.read_dense(path, mmap=True)
    assert isinstance(got, np.memmap) and isinstance(want, np.memmap)
    _same(np.asarray(got), np.asarray(want))
    short = str(tmp_path / "short.bin")
    with open(path, "rb") as f, open(short, "wb") as g:
        g.write(f.read()[:-4])  # one element short
    with pytest.raises(ValueError) as e_got:
        formats.read_dense(short, mmap=True)
    with pytest.raises(ValueError) as e_want:
        jformats.read_dense(short, mmap=True)
    assert str(e_got.value) == str(e_want.value)


@pytest.mark.parametrize("graph_mode", ["header", "full"])
def test_dataset_load_equals_jax(files, graph_mode):
    got = Dataset.load(files, mmap_features=True, graph_mode=graph_mode)
    want = jformats.Dataset.load(files, mmap_features=True, graph_mode=graph_mode)
    assert isinstance(got.features, np.memmap)
    for f in ("features", "labels", "sets"):
        _same(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)))
    if graph_mode == "header":
        assert isinstance(got.graph, formats.GraphHeader)
        assert (got.graph.nrows, got.graph.ncols, got.graph.nnz, got.graph.path) == (
            want.graph.nrows, want.graph.ncols, want.graph.nnz, want.graph.path)
    else:
        for f in ("indptr", "indices", "data"):
            _same(getattr(got.graph, f), getattr(want.graph, f))
    assert (got.num_nodes, got.num_features, got.num_labels) == (want.num_nodes, want.num_features, want.num_labels)
    with pytest.raises(ValueError, match="unknown graph_mode"):
        Dataset.load(files, graph_mode="slab")


def _entries(block):
    """A port block's (rows, cols, vals) as numpy, in CSR order."""
    if isinstance(block, COOMat):
        return block.rows.numpy(), block.cols.numpy(), block.vals.numpy()
    return expand_rows(block.indptr), block.indices.numpy(), block.w.numpy()


def _assert_block_jax(block, rows, cols, vals):
    """A port block equal to a JAX padded block's first entries (indices
    exact, weights within rtol 1e-6); the JAX rest is padding."""
    r, c, v = _entries(block)
    e = r.size
    assert np.array_equal(r, rows[:e]) and np.array_equal(c, cols[:e])
    np.testing.assert_allclose(v, vals[:e], rtol=1e-6, atol=0)
    assert (vals[e:] == 0).all()


def _assert_same_build(got, want, rtol):
    """Two port builds: every block's entries (indices exact, weights
    within ``rtol``), the send lists and the counts."""
    assert (got.n, got.parts, got.nnz, got.halo_width, got.halo_total, got.round_widths) == (
        want.n, want.parts, want.nnz, want.halo_width, want.halo_total, want.round_widths)
    for j in range(got.parts):
        for a, b in [(got.loc[j], want.loc[j])] + list(zip(got.rem[j], want.rem[j])):
            (ra, ca, va), (rb, cb, vb) = _entries(a), _entries(b)
            assert np.array_equal(ra, rb) and np.array_equal(ca, cb)
            np.testing.assert_allclose(va, vb, rtol=rtol, atol=0)
        for s in range(got.parts - 1):
            assert torch.equal(got.send_idx[j][s], want.send_idx[j][s])


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("engine", ["xla", "gather"])
@pytest.mark.parametrize("norm", ["gcn", "sage"])
def test_from_pigo_equals_jax_and_from_csr(tmp_path, norm, engine, parts):
    """``DistHaloPair.from_pigo`` against JAX's ``from_pigo`` (one process;
    its COO build for the entries, its own engine's for the exchange) and
    against the port's ``from_csr_pair`` on the normalized pair."""
    d = str(tmp_path / "ds")
    ds = _dataset(d)
    gpath, tpath = os.path.join(d, "graph.bin"), os.path.join(d, "graph_t.bin")
    ring = cpu_ring(parts)
    got = dist_halo.DistHaloPair.from_pigo(gpath, tpath, ring, engine=engine, norm=norm)
    want_entries = jhalo.DistHaloPair.from_pigo(gpath, tpath, parts, engine="xla", norm=norm)
    want_exchange = jhalo.DistHaloPair.from_pigo(gpath, tpath, parts, engine=engine, norm=norm)
    m = ds.num_nodes // parts
    for side in ("fwd", "bwd"):
        g, we, wx = getattr(got, side), getattr(want_entries, side), getattr(want_exchange, side)
        assert isinstance(g, dist_halo.DistHaloGatherMat) == (engine == "gather")
        assert (g.n, g.parts, g.nnz, g.halo_width, g.halo_total, g.round_widths) == (
            wx.n, wx.parts, wx.nnz, wx.halo_width, wx.halo_total, wx.round_widths)
        for j in range(parts):
            _assert_block_jax(g.loc[j], *(np.asarray(getattr(we, f"loc_{k}"))[j] for k in ("rows", "cols", "vals")))
            for s in range(parts - 1):
                _assert_block_jax(g.rem[j][s],
                                  *(np.asarray(getattr(we, f"rem_{k}")[s])[j] for k in ("rows", "cols", "vals")))
                assert np.array_equal(g.send_idx[j][s].numpy(), np.asarray(wx.send_idx[s])[j])
        assert all(blk.n_rows == m if isinstance(blk, COOMat) else blk.n_out == m for blk in g.loc)
    if norm == "gcn":
        a = sparse.normalize(ds.graph, axis=True)
        fwd, bwd = sparse.transpose(a), a
    else:
        fwd = sparse.normalize(ds.graph, axis=False)
        bwd = sparse.transpose(fwd)
    ref = dist_halo.DistHaloPair.from_csr_pair(fwd, bwd, ring, engine=engine)
    _assert_same_build(got.fwd, ref.fwd, 1e-6)
    _assert_same_build(got.bwd, ref.bwd, 1e-6)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("cls", ["DistHaloMat", "DistHaloGatherMat"])
def test_from_slabs_equals_jax_and_from_csr(files, cls, parts):
    """``from_slabs`` on slabs of ``graph.bin`` read through the file: each
    slab read once, in order; the build equals JAX's ``from_slabs`` and the
    port's ``from_csr`` bit for bit, and ``from_pigo`` of the file."""
    path = os.path.join(files, "graph.bin")
    g = formats.read_pigo_csr(path)
    m, read = g.nrows // parts, []

    def slab_of(j):
        read.append(j)
        return formats.read_pigo_csr_slab(path, j * m, (j + 1) * m)

    ring = cpu_ring(parts)
    make = getattr(dist_halo, cls)
    got = make.from_slabs(slab_of, g.nrows, ring)
    assert read == list(range(parts))
    _assert_same_build(got, make.from_csr(g, ring), 0)
    _assert_same_build(got, make.from_pigo(path, ring), 0)
    want = jhalo.DistHaloMat.from_slabs(lambda j: jformats.read_pigo_csr_slab(path, j * m, (j + 1) * m), g.nrows,
                                        parts)
    assert (got.nnz, got.halo_total, got.round_widths) == (want.nnz, want.halo_total, want.round_widths)
    for j in range(parts):
        _assert_block_jax(got.loc[j], *(np.asarray(getattr(want, f"loc_{k}"))[j] for k in ("rows", "cols", "vals")))
        for s in range(parts - 1):
            assert np.array_equal(got.send_idx[j][s].numpy(), np.asarray(want.send_idx[s])[j])


def _pair_values(pair) -> list[np.ndarray]:
    return [_entries(b)[2] for mat in (pair.fwd, pair.bwd) for j in range(mat.parts) for b in [mat.loc[j], *mat.rem[j]]]


def test_read_only_directory_still_builds(tmp_path, monkeypatch):
    """The JAX build writes ``<src>.rowsums.npy`` into the dataset directory
    and dies when it cannot (ADVICE.md, dist_halo.py:955); the port computes
    the sums in memory, writes nothing, and builds the same pair as in a
    writable directory. The directory is made read-only; a root process,
    which chmod does not stop, has its writes refused as they would be for
    anyone else."""
    d = str(tmp_path / "ds")
    _dataset(d)
    ring = cpu_ring(2)
    paths = (os.path.join(d, "graph.bin"), os.path.join(d, "graph_t.bin"))
    before = sorted(os.listdir(d))
    os.chmod(d, 0o555)
    try:
        if os.geteuid() == 0:
            def refuse(path, *a, **k):
                raise PermissionError(13, "Permission denied", str(path))

            monkeypatch.setattr(formats.np, "save", refuse)
        got = dist_halo.DistHaloPair.from_pigo(*paths, ring)
        assert sorted(os.listdir(d)) == before  # no cache, no temporary left
    finally:
        os.chmod(d, 0o755)
    monkeypatch.undo()
    want = dist_halo.DistHaloPair.from_pigo(*paths, ring)
    assert sorted(os.listdir(d)) == before  # writable: nothing written either
    for a, b in zip(_pair_values(got), _pair_values(want)):
        assert np.array_equal(a, b)


def test_stale_rowsums_not_used(tmp_path):
    """The sums come from the file as it is: neither the JAX package's
    ``graph_t.bin.rowsums.npy`` with a matching mtime is read, nor do the
    sums of an earlier ``graph_t.bin`` survive its replacement by one of
    the same mtime, size and pattern (other weights). No cache is written."""
    d = str(tmp_path / "ds")
    ds = _dataset(d)
    ring = cpu_ring(2)
    gpath, tpath = os.path.join(d, "graph.bin"), os.path.join(d, "graph_t.bin")

    def expected(graph):
        a = sparse.normalize(graph, axis=True)
        return dist_halo.DistHaloPair.from_csr_pair(sparse.transpose(a), a, ring)

    stamp = os.stat(tpath)
    np.save(tpath + ".rowsums.npy", np.full(ds.num_nodes, 1e9))  # the JAX cache's name, wrong sums
    os.utime(tpath + ".rowsums.npy", ns=(stamp.st_atime_ns, stamp.st_mtime_ns))
    first = dist_halo.DistHaloPair.from_pigo(gpath, tpath, ring)
    for a, b in zip(_pair_values(first), _pair_values(expected(ds.graph))):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    g2 = CSRData(ds.graph.indptr, ds.graph.indices, ds.graph.data[::-1].copy(), ds.graph.shape)
    for path, graph in ((gpath, g2), (tpath, sparse.transpose(g2))):
        st = os.stat(path)
        formats.write_pigo_csr(path, graph)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert os.stat(tpath).st_mtime_ns == stamp.st_mtime_ns
    second = dist_halo.DistHaloPair.from_pigo(gpath, tpath, ring)
    for a, b in zip(_pair_values(second), _pair_values(expected(g2))):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert [n for n in os.listdir(d) if "rowsums" in n] == ["graph_t.bin.rowsums.npy"]  # the JAX one only


def test_check_pigo_transpose(tmp_path):
    """Missing, undigested and stale transposes each raise, naming
    ``ensure_pigo_transpose``; a fresh one passes. Nothing is written."""
    d = str(tmp_path / "ds")
    ds = _dataset(d, transpose=False)
    with pytest.raises(ValueError, match="graph_t.bin is missing: run mg_gcn_tpu_torch.formats.ensure_pigo_transpose"):
        formats.check_pigo_transpose(d)
    tpath = formats.ensure_pigo_transpose(d)
    assert formats.check_pigo_transpose(d) == tpath
    os.remove(tpath + ".sha256")
    with pytest.raises(ValueError, match="ensure_pigo_transpose"):
        formats.check_pigo_transpose(d)
    formats.ensure_pigo_transpose(d)
    formats.write_pigo_csr(os.path.join(d, "graph.bin"), weighted_graph(ds.num_nodes, 6, seed=99))
    listed = sorted(os.listdir(d))
    with pytest.raises(ValueError, match="was built from another graph.bin: run .*ensure_pigo_transpose"):
        formats.check_pigo_transpose(d)
    assert sorted(os.listdir(d)) == listed


def test_dist_engine_on_a_header(files):
    """``halo_engine`` and ``dist_engine`` read a ``GraphHeader``'s counts;
    the pattern pair is off for a graph on disk and across processes."""
    from mg_gcn_tpu_torch.train import dist_engine, halo_engine

    header = formats.read_pigo_header(os.path.join(files, "graph.bin"))
    full = formats.read_pigo_csr(os.path.join(files, "graph.bin"))
    assert halo_engine(header, True) == halo_engine(full, True)
    assert halo_engine(header, False) == "xla"
    assert dist_engine(header, "auto", 2, 2, 80 * 2**30)[0] == dist_engine(full, "halo", 2, 2, 80 * 2**30)[0]
    assert "graph on disk" in dist_engine(header, "auto", 2, 2, None)[1]
    binary = CSRData(full.indptr, full.indices, np.ones_like(full.data), full.shape)
    assert dist_engine(binary, "auto", 2, 2, 80 * 2**30)[0] == "pattern"
    assert dist_engine(binary, "auto", 2, 1, 80 * 2**30, processes=2)[0] != "pattern"
    with pytest.raises(ValueError, match="pattern impl not applicable here"):
        dist_engine(binary, "pattern", 2, 1, 80 * 2**30, processes=2)
    assert isinstance(dist.make_mesh(2, ["cpu", "cpu"]), dist.Ring)
