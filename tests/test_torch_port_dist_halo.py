"""Port vs JAX package: the halo exchange (``parallel/dist_halo.py``) on P
partitions on the CPU — the build (send lists, round widths, the useful
volume, every block's entries) on a non-symmetric weighted graph and on a
banded graph with empty rounds, ``dist_aggregate_halo`` on the COO engine
and on the serial-gather engine (JAX's ``dist_aggregate_halo_gather``, its
gather kernel in interpret mode), three GCN steps on each halo pair in
parity and exact modes, and the CLI's ``-P N -R 1`` halo path. The JAX side
runs on conftest's CPU devices; the port's gather kernel on its plain
version (the tensors lie on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu.models import gcn as jgcn
from mg_gcn_tpu.parallel import dist as jdist
from mg_gcn_tpu.parallel import dist_halo as jhalo
from mg_gcn_tpu_torch import cli, sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.models.gcn import GCNConfig
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.ops.spmm import COOMat
from mg_gcn_tpu_torch.ops.spmm_gather import GatherMat
from mg_gcn_tpu_torch.parallel import dist, dist_halo
from tests.torch_port_dist_cases import (
    assert_steps_close, banded_weighted, cpu_ring, expand_rows, features, jax_steps, jcsr, port_steps, weighted_graph,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
SPEC = jax.sharding.PartitionSpec(jdist.GRAPH_AXIS)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _entries(block):
    """A port block's (rows, cols, vals) as numpy, in CSR order."""
    if isinstance(block, COOMat):
        return block.rows.numpy(), block.cols.numpy(), block.vals.numpy()
    assert isinstance(block, GatherMat) and block.w is not None  # weighted, HAS_W
    return expand_rows(block.indptr), block.indices.numpy(), block.w.numpy()


def _assert_block(block, rows, cols, vals, m, n_in):
    """A port block equal to the JAX block's first entries; the JAX rest is
    padding (row m - 1, column 0, value 0)."""
    r, c, v = _entries(block)
    e = r.size
    assert np.array_equal(r, rows[:e]) and np.array_equal(c, cols[:e]) and np.array_equal(v, vals[:e])
    assert (rows[e:] == m - 1).all() and (cols[e:] == 0).all() and (vals[e:] == 0).all()
    shape = (block.n_rows, block.n_cols) if isinstance(block, COOMat) else (block.n_out, block.n_in)
    assert shape == (m, n_in)


GRAPHS = {
    "weighted": lambda n, parts: weighted_graph(n, 6, seed=11),
    "banded": lambda n, parts: banded_weighted(n, parts, seed=12),
}


@pytest.mark.parametrize("engine", ["xla", "gather"])
@pytest.mark.parametrize("kind,parts", [("weighted", 3), ("weighted", 4), ("banded", 4)])
def test_halo_build_equals_jax(kind, parts, engine):
    """Send lists, round widths, halo width, the useful volume, the bytes an
    SpMM moves and every block's entries equal the JAX host build's."""
    n = 120 * parts
    g = GRAPHS[kind](n, parts)
    a = sparse.normalize(g, axis=True)
    got = dist_halo.DistHaloPair.from_csr_pair(sparse.transpose(a), a, cpu_ring(parts), engine=engine).fwd
    want = jhalo.DistHaloMat.from_csr(jcsr(sparse.transpose(a)), parts)
    assert isinstance(got, dist_halo.DistHaloGatherMat) == (engine == "gather")
    assert (got.n, got.parts, got.nnz, got.halo_width, got.halo_total, got.round_widths) == (
        want.n, want.parts, want.nnz, want.halo_width, want.halo_total, want.round_widths)
    for d in (1, 16):
        for padded in (True, False):
            assert got.comm_bytes_per_spmm(d, padded=padded) == want.comm_bytes_per_spmm(d, padded=padded)
    m = n // parts
    for j in range(parts):
        _assert_block(got.loc[j], *(np.asarray(getattr(want, f"loc_{k}"))[j] for k in ("rows", "cols", "vals")), m, m)
        for s in range(parts - 1):
            sent = got.send_idx[j][s]
            assert sent.dtype == torch.int64 and np.array_equal(sent.numpy(), np.asarray(want.send_idx[s])[j])
            jrem = (np.asarray(getattr(want, f"rem_{k}")[s])[j] for k in ("rows", "cols", "vals"))
            _assert_block(got.rem[j][s], *jrem, m, want.round_widths[s])
    if kind == "banded":  # round 1 (block A[j, j+2]) is empty on every partition, still 128 rows wide
        assert all(got.rem[j][1].nnz == 0 for j in range(parts)) and got.round_widths[1] == 128
    if engine == "gather":  # the serial-gather build's exchange is the COO build's
        jg = jhalo.DistHaloGatherMat.from_csr(jcsr(sparse.transpose(a)), parts)
        assert (jg.round_widths, jg.halo_total) == (got.round_widths, got.halo_total)
        for s in range(parts - 1):
            assert np.array_equal(torch.stack([got.send_idx[j][s] for j in range(parts)]).numpy(),
                                  np.asarray(jg.send_idx[s]))


def test_halo_slab_blocks_equal_jax():
    """One slab's (loc, compact, recv), the per-slab unit of the build."""
    parts, n = 4, 480
    g = weighted_graph(n, 6, seed=13)
    for j in range(parts):
        slab = dist.row_slab(g, j, n // parts)
        loc, compact, recv = dist_halo.halo_slab_blocks(slab, j, parts, torch.device("cpu"))
        jloc, jcompact, jrecv = jhalo.halo_slab_blocks(jcsr(slab), j, parts)
        for t, w in zip(loc, jloc):
            assert np.array_equal(t.numpy(), w)
        for s in range(parts - 1):
            assert np.array_equal(recv[s].numpy(), jrecv[s])
            for t, w in zip(compact[s], jcompact[s]):
                assert np.array_equal(t.numpy(), w)


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_pad_then_normalize_is_normalize_then_pad(parts):
    """Padding n to a multiple of P with empty rows and columns (as prep
    pads) commutes with the GCN normalization and the transpose: the padded
    nodes get no entries, so a padded Â / Âᵀ is the unpadded one with empty
    rows and columns appended."""
    g = weighted_graph(301, 5, seed=14)
    n_pad = -(-g.nrows // parts) * parts + 3

    def pad(c: CSRData) -> CSRData:
        indptr = np.concatenate([c.indptr, np.full(n_pad - c.nrows, c.indptr[-1])])
        return CSRData(indptr, c.indices, c.data, (n_pad, n_pad))

    for first, second in ((pad(sparse.normalize(g, axis=True)), sparse.normalize(pad(g), axis=True)),
                          (pad(sparse.transpose(sparse.normalize(g, axis=True))),
                           sparse.transpose(sparse.normalize(pad(g), axis=True)))):
        for k in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(first, k), getattr(second, k)), k
        assert first.shape == second.shape


# ---------------------------------------------------------------------------
# the products


def _jax_aggregate(body, fields: dict, h: np.ndarray, parts: int) -> np.ndarray:
    """``body(mat_local, h)`` in shard_map over the JAX CPU mesh, the mat's
    per-partition fields stripped of their shard axis as the JAX step does."""
    names = list(fields)

    def run(*args):
        *vals, hl = args
        return body({k: jhalo.strip_shard_axis(v) for k, v in zip(names, vals)}, hl)

    f = jax.jit(jax.shard_map(run, mesh=jdist.make_mesh(parts), in_specs=(SPEC,) * (len(names) + 1),
                              out_specs=SPEC, check_vma=False))
    return np.asarray(f(*fields.values(), jnp.asarray(h)))


@pytest.mark.parametrize("parts", [3, 4])
def test_dist_aggregate_halo_matches_jax(parts):
    """The COO engine's halo product against JAX's ``dist_aggregate_halo``
    at rtol 1e-5 / atol 1e-6, and against the dense product."""
    n = 120 * parts
    a = sparse.normalize(weighted_graph(n, 6, seed=15), axis=True)
    h = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    ring = cpu_ring(parts)
    got = torch.cat(dist_halo.dist_aggregate_halo(dist_halo.DistHaloMat.from_csr(a, ring), dist.shard(h, ring)))
    jmat = jhalo.DistHaloMat.from_csr(jcsr(a), parts)
    want = _jax_aggregate(lambda mat, hl: jhalo.dist_aggregate_halo(mat, hl, parts),
                          {k: getattr(jmat, k) for k in jhalo.MAT_FIELDS}, h, parts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), a.to_scipy().toarray() @ h, rtol=1e-5, atol=1e-6)


def test_dist_aggregate_halo_gather_matches_jax(monkeypatch):
    """The serial-gather engine's halo product against JAX's
    ``dist_aggregate_halo_gather`` (interpret mode) at rtol 1e-5 / atol
    1e-6, with JAX's thin-group split forced on: where JAX routes a
    partition's diagonal block to its COO scatter remainder and where it
    keeps it on the gather kernel, the port's CSR block (every entry, one
    walk) gives the sum of the two parts."""
    parts, n = 3, 360
    a = sparse.normalize(weighted_graph(n, 6, seed=16), axis=True)
    h = np.random.default_rng(2).standard_normal((n, 12)).astype(np.float32)
    diag = [dist.column_blocks(dist.row_slab(a, j, n // parts), parts, torch.device("cpu"))[j][0].numel()
            for j in range(parts)]
    monkeypatch.setattr(jhalo, "GROUP_BUDGET", 0)
    monkeypatch.setattr(jhalo, "SCATTER_MIN_GROUP", sorted(diag)[1] + 1)  # thin: all but the fullest diagonal
    jmat = jhalo.DistHaloGatherMat.from_csr(jcsr(a), parts)
    scattered = (np.asarray(jmat.sc_vals) != 0).sum(axis=1)
    assert sorted(scattered.tolist()) == [0] + sorted(diag)[:2]
    ring = cpu_ring(parts)
    got = torch.cat(dist_halo.dist_aggregate_halo(dist_halo.DistHaloGatherMat.from_csr(a, ring), dist.shard(h, ring)))
    want = _jax_aggregate(lambda mat, hl: jhalo.dist_aggregate_halo_gather(mat, hl, parts),
                          {k: getattr(jmat, k) for k in jhalo.GATHER_HALO_FIELDS}, h, parts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_one_process_halo_product_keeps_one_buffer_alive(monkeypatch):
    """In one process the product runs partition by partition: at each
    remote block's product one gathered halo buffer is alive, never the
    whole round's P, and no message route is taken; the result is the
    dense product."""
    import weakref

    parts, n = 4, 480
    a = sparse.normalize(weighted_graph(n, 6, seed=18), axis=True)
    h = np.random.default_rng(4).standard_normal((n, 8)).astype(np.float32)
    ring = cpu_ring(parts)
    mat = dist_halo.DistHaloMat.from_csr(a, ring)
    halos, alive = [], []
    product = dist_halo._block_product

    def watch(blk, b):
        if any(blk is r for rem in mat.rem for r in rem):
            halos.append(weakref.ref(b))
            alive.append(sum(r() is not None for r in halos))
        return product(blk, b)

    def refuse(*args, **kwargs):
        raise AssertionError("one process took the message route")

    monkeypatch.setattr(dist_halo, "_block_product", watch)
    monkeypatch.setattr(dist_halo, "_permute", refuse)
    with torch.no_grad():
        got = torch.cat(dist_halo.dist_aggregate_halo(mat, dist.shard(h, ring)))
    assert alive == [1] * parts * (parts - 1)
    np.testing.assert_allclose(got.numpy(), a.to_scipy().toarray() @ h, rtol=1e-5, atol=1e-6)


def test_halo_product_is_differentiable_through_the_exchange():
    """On the COO engine autograd runs back through the index gather and
    the copies: the gradient of <C, G> in H is Aᵀ G."""
    parts, n = 3, 360
    a = sparse.normalize(weighted_graph(n, 6, seed=17), axis=True)
    rng = np.random.default_rng(3)
    h, g = rng.standard_normal((n, 8)).astype(np.float32), rng.standard_normal((n, 8)).astype(np.float32)
    ring = cpu_ring(parts)
    hs = [x.requires_grad_(True) for x in dist.shard(h, ring)]
    cs = dist_halo.dist_aggregate_halo(dist_halo.DistHaloMat.from_csr(a, ring), hs)
    grads = torch.autograd.grad(sum((c * gj).sum() for c, gj in zip(cs, dist.shard(g, ring))), hs)
    np.testing.assert_allclose(torch.cat(grads).numpy(), a.to_scipy().toarray().T @ g, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the train step

SIZES = (6, 8, 8, 3)  # 6 -> 8 aggregates first, 8 -> 8 and 8 -> 3 multiply first


@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize("pair_kind,parts,mask", [("halo", 4, True), ("halo", 3, False), ("halo_gather", 3, False)])
def test_three_steps_match_jax(pair_kind, parts, mask, parity):
    """Three GCN steps on the halo pair against the JAX package's
    ``make_dist_train_step`` on its halo pair (``halo_gather``: its gather
    kernel in interpret mode): losses at rtol 1e-5, accuracy within a node,
    the last parameters at rtol 1e-5 / atol 1e-6. Exact mode takes Adam
    eps = 1, as the JAX package's own exact test does."""
    n = 80 * parts
    g = weighted_graph(n, 5, seed=18)
    x, y, train = features(n, SIZES[0], SIZES[-1], seed=4, mask=mask)
    a = sparse.normalize(g, axis=True)
    engine = "gather" if pair_kind == "halo_gather" else "xla"
    hp = dict(adam.DEFAULT_HPARAMS, **({} if parity else dict(eps=1.0)))
    jconfig = jgcn.GCNConfig(sizes=SIZES, parity=parity)
    jpair = jhalo.DistHaloPair.from_csr_pair(jcsr(sparse.transpose(a)), jcsr(a), parts, engine=engine)
    mesh = jdist.make_mesh(parts)
    params = jgcn.init_params(jconfig)
    jstep = jdist.make_dist_train_step(jconfig, mesh, n, hp, use_mask=mask, pair_kind=pair_kind)
    want = jax_steps(jstep, mesh, params, jpair, x, y, train, 3)
    ring = cpu_ring(parts)
    pair = dist_halo.DistHaloPair.from_csr_pair(sparse.transpose(a), a, ring, engine=engine)
    step = dist.make_dist_train_step(GCNConfig(sizes=SIZES, parity=parity), ring, n, hp, pair_kind=pair_kind)
    got = port_steps(step, ring, [{k: np.asarray(v) for k, v in la.items()} for la in params], pair, x, y, train, 3)
    assert_steps_close(got, want, int(train.sum()) if mask else n, 1e-5, 1e-6)
    assert want[-1][1] < want[0][1]


def test_step_refusals_name_the_ring():
    ring = cpu_ring(2)
    config = GCNConfig(sizes=(4, 2))
    for kind, name in (("halo", "halo"), ("halo_gather", "halo"), ("gather", "gather")):
        for strategy in ("all_gather", "fused"):
            with pytest.raises(ValueError) as got:
                dist.make_dist_train_step(config, ring, 10, strategy=strategy, pair_kind=kind)
            with pytest.raises(ValueError) as want:
                jdist.make_dist_train_step(jgcn.GCNConfig(sizes=(4, 2)), jdist.make_mesh(2), 10, strategy=strategy,
                                           pair_kind=kind)
            assert str(got.value) == str(want.value)
            assert f"the {name} pair has a single (ring) exchange schedule" in str(got.value)
    with pytest.raises(ValueError, match="does not match"):
        a = sparse.normalize(weighted_graph(240, 4, seed=1), axis=True)
        pair = dist_halo.DistHaloPair.from_csr_pair(a, a, ring)
        dist.make_dist_train_step(config, ring, 240, pair_kind="halo_gather")(None, None, pair, None, None)
    with pytest.raises(ValueError, match="unknown halo engine"):
        dist_halo.DistHaloPair.from_csr_pair(a, a, ring, engine="pattern")
    with pytest.raises(ValueError, match=r"n \(241\) must be divisible by the mesh size \(2\)"):
        dist_halo.DistHaloMat.from_csr(weighted_graph(241, 4, seed=1), ring)


@pytest.mark.parametrize(
    "kind,pair_cls,mat_cls",
    [("coo", dist.DistAggPair, dist.DistRowMat), ("gather", dist.DistGatherPair, dist.DistGatherMat),
     ("halo", dist_halo.DistHaloPair, dist_halo.DistHaloMat),
     ("halo_gather", dist_halo.DistHaloPair, dist_halo.DistHaloGatherMat)],
)
def test_build_pair_takes_each_kinds_engine(kind, pair_cls, mat_cls):
    """``dist.build_pair`` gives each kind its pair and engine; the step's
    forward and backward products over it equal Âᵀ H and Â G (dense, float64)
    at rtol 1e-5 / atol 1e-6. An unknown kind raises."""
    parts, n = 3, 240
    a = sparse.normalize(weighted_graph(n, 5, seed=21), axis=True)
    ring = cpu_ring(parts)
    pair = dist.build_pair(kind, sparse.transpose(a), a, ring)
    assert type(pair) is pair_cls and type(pair.fwd) is mat_cls and type(pair.bwd) is mat_cls
    h = np.random.default_rng(5).standard_normal((n, 7)).astype(np.float32)
    agg_fwd, agg_bwd = dist._aggregations(kind, pair, "ring", "float32")
    dense = a.to_scipy().toarray().astype(np.float64)
    np.testing.assert_allclose(torch.cat(agg_fwd(dist.shard(h, ring))).numpy(), dense.T @ h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat(agg_bwd(dist.shard(h, ring))).numpy(), dense @ h, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown pair_kind 'pattern'"):
        dist.build_pair("pattern", sparse.transpose(a), a, ring)


# ---------------------------------------------------------------------------
# the CLI


def _epochs(err: str) -> list:
    return [line.split() for line in err.splitlines() if line[:1].isdigit() and len(line.split()) == 4]


def _weighted_dir(tmp_path, n=256):
    g = weighted_graph(n, 4, seed=19)
    rng = np.random.default_rng(0)
    d = str(tmp_path / "weighted")
    Dataset(graph=g, features=rng.standard_normal((n, 8)).astype(np.float32),
            labels=rng.integers(0, 3, (n, 1)).astype(np.int32), sets=np.zeros((n, 1), np.int32)).save(d)
    return d


@pytest.mark.parametrize("parts,impl,data", [(2, "auto", "weighted"), (4, "halo", "golden"), (2, "halo", "golden")])
def test_cli_halo_matches_jax_cli(tmp_path, capsys, parts, impl, data):
    """``-P N -R 1 train`` on the CPU takes the halo pair where the JAX CLI
    does (``auto`` off the TPU, a weighted graph included: ROADMAP queue 3's
    closed item) and prints its lines: the header, ``halo exchange: ...``
    number for number, and losses at rtol 1e-5."""
    d = _weighted_dir(tmp_path) if data == "weighted" else GOLDEN
    args = ["-P", str(parts), "-R", "1", "-E", "3", "--impl", impl, "train", d, "1", "8"]
    assert cli.main(["--device", "cpu", "--csv-dir", str(tmp_path / "p"), *args]) == 0
    got = capsys.readouterr().err
    assert jcli.main(["--csv-dir", str(tmp_path / "j"), *args]) == 0
    want = capsys.readouterr().err
    lines = [line for line in want.splitlines() if not line[:1].isdigit() or len(line.split()) != 4]
    assert any(line.startswith("halo exchange: ") for line in lines)
    assert [line for line in got.splitlines() if line in lines or line.startswith("halo")] == lines
    ge, we = _epochs(got), _epochs(want)
    assert [e[0] for e in ge] == ["0", "1", "2"] == [e[0] for e in we]
    np.testing.assert_allclose([float(e[1]) for e in ge], [float(e[1]) for e in we], rtol=1e-5)


def test_cli_halo_gather_lines(tmp_path, capsys, monkeypatch):
    """Where ``train.halo_engine`` takes the gather kernel (on a card: expected
    fill < 0.3), the CLI builds the serial-gather halo pair and prints the
    JAX CLI's two lines, the moved rows from the JAX build; losses as the
    COO engine's halo run."""
    d = _weighted_dir(tmp_path)
    base = ["-P", "4", "-R", "1", "--device", "cpu", "-E", "2", "--csv-dir", str(tmp_path), "train", d, "1", "8"]
    assert cli.main(base) == 0
    coo = _epochs(capsys.readouterr().err)
    monkeypatch.setattr(ttrain, "halo_engine", lambda graph, on_card: "gather")
    assert cli.main(base) == 0
    err = capsys.readouterr().err.splitlines()
    a = sparse.normalize(Dataset.load(d).graph, axis=True)
    jmat = jhalo.DistHaloGatherMat.from_csr(jcsr(sparse.transpose(a)), 4)
    assert err[3:5] == ["halo local engine: serial-gather",
                        f"halo exchange: {4 * sum(jmat.round_widths)} rows/SpMM fwd moved ({jmat.halo_total} useful;"
                        f" dense bcast would move {3 * 256})"]
    np.testing.assert_allclose([float(e[1]) for e in _epochs("\n".join(err))], [float(e[1]) for e in coo], rtol=1e-5)


@pytest.mark.parametrize(
    "args",
    [
        ["--impl", "halo"],
        ["-P", "2", "-R", "1", "-S"],
        ["-P", "2", "-R", "1", "--impl", "halo", "--exchange", "fused"],
        ["-P", "3", "-R", "1", "--impl", "halo"],
    ],
    ids=lambda a: " ".join(a),
)
def test_cli_halo_refusals_match_jax(tmp_path, capsys, args):
    """Each exits 2 with the JAX CLI's message; where the JAX CLI raises
    from its step (a halo pair asked for another exchange than the ring),
    the port exits 2 with the same message."""
    d = _weighted_dir(tmp_path)
    P = args[args.index("-P") + 1] if "-P" in args else "1"
    assert cli.main(["--device", ",".join(["cpu"] * int(P)), "-E", "1", "--csv-dir", str(tmp_path), *args, "train",
                     d, "1", "8"]) == 2
    got = capsys.readouterr().err.splitlines()[-1]
    try:
        assert jcli.main(["-E", "1", "--csv-dir", str(tmp_path), *args, "train", d, "1", "8"]) == 2
        want = capsys.readouterr().err.splitlines()[-1]
    except ValueError as exc:
        want = str(exc)
    assert got == want


def test_halo_gather_blocks_refuse_autograd():
    """The gather kernel has no backward: a product that would need one
    raises rather than give a zero gradient; under no_grad it runs."""
    ring = cpu_ring(2)
    a = sparse.normalize(weighted_graph(240, 4, seed=20), axis=True)
    mat = dist_halo.DistHaloGatherMat.from_csr(a, ring)
    hs = [x.requires_grad_(True) for x in dist.shard(np.ones((240, 3), np.float32), ring)]
    with pytest.raises(ValueError, match="not differentiable"):
        dist_halo.dist_aggregate_halo(mat, hs)
    with torch.no_grad():
        got = torch.cat(dist_halo.dist_aggregate_halo(mat, hs))
    np.testing.assert_allclose(got.numpy(), a.to_scipy().toarray() @ np.ones((240, 3)), rtol=1e-5, atol=1e-6)
