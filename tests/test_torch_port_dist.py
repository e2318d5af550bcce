"""Port vs JAX package: row-partitioned training (``parallel/dist.py``) on P
partitions on the CPU — the block split, the COO and pattern pair builds,
the COO ring products, the train step in parity and exact modes, and the
CLI's ``-P N -R 1`` path. The JAX side runs on conftest's 8 CPU devices."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu import sparse as jsparse
from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.models import gcn as jgcn
from mg_gcn_tpu.nn import adam as jadam
from mg_gcn_tpu.ops.spmm import AggPair as JAggPair
from mg_gcn_tpu.ops.spmm import COOMat as JCOOMat
from mg_gcn_tpu.parallel import dist as jdist
from mg_gcn_tpu_torch import cli, convert, sparse
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.models import gcn as tgcn
from mg_gcn_tpu_torch.models.gcn import GCNConfig
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.parallel import dist
from mg_gcn_tpu_torch.train import build_agg_pair

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jcsr(g: CSRData) -> JCSRData:
    return JCSRData(g.indptr, g.indices, g.data, g.shape)


def _cpu_ring(parts):
    return dist.make_mesh(parts, ["cpu"] * parts)


def _np_tree(tree):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in tree]


# ---------------------------------------------------------------------------
# the builds


@pytest.mark.parametrize("parts", [2, 4])
def test_partition_blocks_equal_jax(parts):
    g = sparse.random_graph(5000, 4, seed=21, weights="random")
    part = sparse.uniform_partition(g.nrows, parts)
    cols = np.array([0, 1234, 4096, 5000])
    got, want = sparse.partition_blocks(g, part, cols), jsparse.partition_blocks(_jcsr(g), part, cols)
    for row_got, row_want in zip(got, want):
        for b, jb in zip(row_got, row_want):
            assert b.shape == jb.shape
            for k in ("indptr", "indices", "data"):
                a, w = getattr(b, k), getattr(jb, k)
                assert a.dtype == w.dtype and np.array_equal(a, w), k


@pytest.mark.parametrize("parts", [2, 4])
def test_dist_row_mat_equals_jax(parts):
    g = sparse.random_graph(6000, 4, seed=21, weights="random")
    a = sparse.normalize(g, axis=True)
    got = dist.DistRowMat.from_csr(a, _cpu_ring(parts))
    want = jdist.DistRowMat.from_csr(_jcsr(a), parts)
    for k in ("rows", "cols", "vals"):
        assert np.array_equal(torch.stack(getattr(got, k)).numpy(), np.asarray(getattr(want, k))), k
    assert (got.n, got.parts, got.nnz) == (want.n, want.parts, want.nnz)


@pytest.mark.parametrize("n,parts", [(5000, 2), (6000, 4), (9000, 2)])
def test_dist_pattern_pair_equals_jax(n, parts):
    """Packs and scales bit for bit, n not a multiple of P·4096 (padded rows)."""
    g = sparse.random_graph(n, 4, seed=21, weights="ones")
    got = dist.DistPatternPair.from_binary_csr(g, _cpu_ring(parts), dtype="float32")
    want = jdist.DistPatternPair.from_binary_csr(_jcsr(g), parts, dtype="float32")
    for k in ("pack_fwd", "pack_bwd", "scale"):
        assert np.array_equal(torch.stack(getattr(got, k)).numpy(), np.asarray(getattr(want, k))), k
    assert (got.n, got.n_pad, got.parts, got.m_loc, got.nnz) == (want.n, want.n_pad, want.parts, want.m_loc, want.nnz)


def test_refusals():
    w = sparse.random_graph(5000, 4, seed=21, weights="random")
    with pytest.raises(ValueError, match=r"n \(5001\) must be divisible by the mesh size \(2\)"):
        dist.DistRowMat.from_csr(sparse.random_graph(5001, 4, seed=1), _cpu_ring(2))
    with pytest.raises(ValueError, match="pattern dist pair needs a binary adjacency"):
        dist.DistPatternPair.from_binary_csr(w, _cpu_ring(2))
    with pytest.raises(ValueError, match="unknown pair_kind"):
        dist.make_dist_train_step(GCNConfig(sizes=(4, 2)), _cpu_ring(2), 10, pair_kind="bogus")
    with pytest.raises(ValueError, match="not available"):
        dist.make_dist_train_step(GCNConfig(sizes=(4, 2)), _cpu_ring(2), 10, strategy="fused")
    with pytest.raises(ValueError, match="the halo pair has a single \\(ring\\) exchange schedule"):
        dist.make_dist_train_step(GCNConfig(sizes=(4, 2)), _cpu_ring(2), 10, strategy="all_gather", pair_kind="halo")


def test_make_mesh(monkeypatch):
    ring = dist.make_mesh(4, ["cpu", "cpu", "cpu", "cpu"])
    assert ring.parts == 4 and ring.replica_devices == (torch.device("cpu"),)
    assert [ring.replica_of(j) for j in range(4)] == [0, 0, 0, 0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match=r"make_mesh\(4\) but only 0 CUDA device"):
        dist.make_mesh(4)  # no smaller ring, no CPU ring unasked
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.make_mesh(2, ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="with 3 device"):
        dist.make_mesh(2, ["cpu"] * 3)


# ---------------------------------------------------------------------------
# the COO ring


@pytest.mark.parametrize("strategy", ["ring", "all_gather"])
def test_dist_aggregate_matches_jax(strategy):
    parts, n = 4, 5000
    g = sparse.random_graph(n, 6, seed=3, weights="random")
    a = sparse.normalize(g, axis=True)
    h = np.random.default_rng(0).random((n, 16), np.float32)
    ring = _cpu_ring(parts)
    got = torch.cat(dist.dist_aggregate(dist.DistRowMat.from_csr(a, ring), dist.shard(h, ring), strategy)).numpy()
    jmat = jdist.DistRowMat.from_csr(_jcsr(a), parts)
    spec = jax.sharding.PartitionSpec(jdist.GRAPH_AXIS)

    def body(r, c, v, hl):
        return jdist.dist_aggregate(dict(rows=r[0], cols=c[0], vals=v[0]), hl, parts, strategy)

    f = jax.jit(jax.shard_map(body, mesh=jdist.make_mesh(parts), in_specs=(spec,) * 4, out_specs=spec,
                              check_vma=False))
    want = np.asarray(f(jmat.rows, jmat.cols, jmat.vals, jnp.asarray(h)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, a.to_scipy().toarray() @ h, rtol=1e-5, atol=1e-6)


def test_dist_infer_matches_jax():
    parts, n = 2, 5000
    g = sparse.random_graph(n, 6, seed=3)
    a = sparse.normalize(g, axis=True)
    config = jgcn.GCNConfig(sizes=(6, 8, 3))
    jparams = jgcn.init_params(config)
    x = np.random.default_rng(1).standard_normal((n, 6)).astype(np.float32)
    want = jdist.make_dist_infer(config, jdist.make_mesh(parts))(
        jparams, jdist.DistAggPair.from_csr_pair(_jcsr(sparse.transpose(a)), _jcsr(a), parts), jnp.asarray(x))
    ring = _cpu_ring(parts)
    infer = dist.make_dist_infer(GCNConfig(sizes=(6, 8, 3)), ring)
    got = infer(dist.replicate(convert.params_from_numpy(_np_tree(jparams), "cpu"), ring),
                dist.DistAggPair.from_csr_pair(sparse.transpose(a), a, ring), dist.shard(x, ring))
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the pattern exchange's order


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("orientation", ["PT", "P"])
@pytest.mark.parametrize("strategy", ["fused", "all_gather"])
def test_pattern_exchange_fills_every_slot_before_the_first_product(monkeypatch, strategy, orientation, parts):
    """Every partition's slot buffer is filled before the first product
    launches (a peer copy runs on its source card's stream, so one issued
    after that card's product would wait for it); each product reads a
    filled buffer; the outputs equal the ring exchange's bit for bit."""
    n = 3000
    g = sparse.random_graph(n, 4, seed=23, weights="ones")
    ring = _cpu_ring(parts)
    pair = dist.DistPatternPair.from_binary_csr(g, ring, dtype="bfloat16")
    h = np.zeros((pair.n_pad, 20), np.float32)
    h[:n] = np.random.default_rng(7).standard_normal((n, 20))
    want = dist.dist_aggregate_pattern(pair, dist.shard(h, ring), orientation, strategy="ring")

    events, filled = [], []
    slots = dist._slots

    def spy_slots(blocks, j, order):
        out = slots(blocks, j, order)
        events.append(("slots", j))
        filled.append(out.untyped_storage().data_ptr())
        return out

    def spy(kernel):
        def launch(pack, operand):
            events.append(("product", operand.untyped_storage().data_ptr()))
            return kernel(pack, operand)
        return launch

    monkeypatch.setattr(dist, "_slots", spy_slots)
    for owner, name in ((dist, "ring_pattern_fwd"), (dist, "ring_pattern_bwd"), (dist.sp, "pattern_fwd"),
                        (dist.sp, "pattern_bwd")):
        monkeypatch.setattr(owner, name, spy(getattr(owner, name)))
    got = dist.dist_aggregate_pattern(pair, dist.shard(h, ring), orientation, strategy=strategy)

    assert events[:parts] == [("slots", j) for j in range(parts)]
    products = events[parts:]
    assert len(products) == (parts if strategy == "fused" else parts * parts)
    assert all(kind == "product" and ptr in filled for kind, ptr in products)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the train step


SIZES = (6, 8, 8, 3)  # 6 -> 8 aggregates first, 8 -> 8 and 8 -> 3 multiply first


def _problem(parts, mask, seed=22):
    n, f, c = 5000, SIZES[0], SIZES[-1]
    g = sparse.random_graph(n, 4, seed=seed, weights="ones")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    train = rng.random(n) < 0.6 if mask else None
    return g, x, y, train


def _jax_steps(g, x, y, train, parts, config, hp, optimizer, steps):
    """The JAX package's COO dist step on the CPU mesh, ``steps`` times:
    [(params, loss, acc)]."""
    a = sparse.normalize(g, axis=True)
    jpair = jdist.DistAggPair.from_csr_pair(_jcsr(sparse.transpose(a)), _jcsr(a), parts)
    step = jdist.make_dist_train_step(config, jdist.make_mesh(parts), g.nrows, hp, use_mask=train is not None,
                                      optimizer=optimizer)
    params = jgcn.init_params(config)
    opt = jadam.adam_init(params)
    out = []
    for _ in range(steps):
        args = (jnp.asarray(x), jnp.asarray(y)) + (() if train is None else (jnp.asarray(train),))
        params, opt, loss, acc = step(params, opt, jpair, *args)
        out.append((_np_tree(params), float(loss), float(acc)))
    return out


def _jax_single(g, x, y, train, config, hp, optimizer):
    """The JAX package's single-chip COO loss_and_grad and update."""
    a = sparse.normalize(g, axis=True)
    pair = JAggPair(JCOOMat.from_csr(_jcsr(sparse.transpose(a)), pad_to=8), JCOOMat.from_csr(_jcsr(a), pad_to=8))
    params = jgcn.init_params(config)
    mask = None if train is None else jnp.asarray(train)
    loss, acc, grads = jgcn.loss_and_grad(params, pair, jnp.asarray(x), jnp.asarray(y), config, mask)
    if optimizer == "sgd":
        params = jadam.sgd_update(params, grads, hp["lr"], hp["weight_decay"])
    else:
        params, _ = jadam.adam_update(params, grads, jadam.adam_init(params), **hp)
    return _np_tree(params), float(loss), float(acc)


def _port_steps(g, x, y, train, parts, config, hp, optimizer, steps, pair_kind, strategy, dtype="float32"):
    ring = _cpu_ring(parts)
    jparams = jgcn.init_params(jgcn.GCNConfig(sizes=config.sizes, residual=config.residual))
    params = convert.params_from_numpy(_np_tree(jparams), "cpu")
    params, opt = dist.replicate(params, ring), dist.replicate(adam.adam_init(params), ring)
    n = g.nrows
    if pair_kind == "pattern":
        pair = dist.DistPatternPair.from_binary_csr(g, ring, dtype=dtype)
        rows = pair.n_pad
    else:
        a = sparse.normalize(g, axis=True)
        pair = dist.DistAggPair.from_csr_pair(sparse.transpose(a), a, ring)
        rows = n
    xp = np.zeros((rows, x.shape[1]), np.float32)
    xp[:n] = x
    yp = np.zeros(rows, np.int64)
    yp[:n] = y
    mp = np.zeros(rows, bool)
    mp[:n] = True if train is None else train
    masks = dist.shard(mp, ring) if train is not None or rows > n else None
    step = dist.make_dist_train_step(config, ring, n, hp, strategy=strategy, pair_kind=pair_kind,
                                     pattern_dtype=dtype, optimizer=optimizer)
    out = []
    for _ in range(steps):
        params, opt, loss, acc = step(params, opt, pair, dist.shard(xp, ring), dist.shard(yp, ring), masks)
        out.append((convert.params_to_numpy(params[0]), float(loss), float(acc)))
    return out


def _assert_params_close(got, want, rtol, atol):
    for layer, jlayer in zip(got, want):
        for k in jlayer:
            np.testing.assert_allclose(layer[k], jlayer[k], rtol=rtol, atol=atol, err_msg=k)


CASES = [
    # parts, parity, residual, optimizer, mask
    (2, True, False, "adam", False),
    (4, True, True, "adam", True),
    (4, False, False, "adam", False),
    (2, False, True, "sgd", True),
    (4, True, False, "sgd", False),
]


@pytest.mark.parametrize("parts,parity,residual,optimizer,mask", CASES)
def test_pattern_step_matches_jax(parts, parity, residual, optimizer, mask):
    """The port's fused pattern step (float32) against the JAX package's COO
    dist step and its single-chip step + update: loss rtol 1e-4, parameters
    rtol 5e-4 / atol 5e-6 (test_dist_pattern.py:146-153); the COO ring step
    against the JAX COO step at rtol 1e-5. Exact mode takes Adam eps = 1,
    as the JAX package's own exact test does (test_dist.py:152-154)."""
    config = GCNConfig(sizes=SIZES, parity=parity, residual=residual)
    jconfig = jgcn.GCNConfig(sizes=SIZES, parity=parity, residual=residual)
    hp = dict(adam.DEFAULT_HPARAMS, **({} if parity else dict(eps=1.0)))
    g, x, y, train = _problem(parts, mask)
    (jp, jl, ja), = _jax_steps(g, x, y, train, parts, jconfig, hp, optimizer, 1)
    sp_, sl, sa = _jax_single(g, x, y, train, jconfig, hp, optimizer)
    (pp, pl, pa), = _port_steps(g, x, y, train, parts, config, hp, optimizer, 1, "pattern", "fused")
    for params, loss, acc in ((jp, jl, ja), (sp_, sl, sa)):
        np.testing.assert_allclose(pl, loss, rtol=1e-4)
        np.testing.assert_allclose(pa, acc, rtol=1e-6)
        _assert_params_close(pp, params, 5e-4, 5e-6)
    (cp, cl, ca), = _port_steps(g, x, y, train, parts, config, hp, optimizer, 1, "coo", "ring")
    np.testing.assert_allclose(cl, jl, rtol=1e-5)
    np.testing.assert_allclose(ca, ja, rtol=1e-6)
    _assert_params_close(cp, jp, 1e-5, 1e-6)


def test_three_step_trajectory_matches_jax():
    config = GCNConfig(sizes=SIZES)
    g, x, y, train = _problem(4, False)
    want = _jax_steps(g, x, y, train, 4, jgcn.GCNConfig(sizes=SIZES), dict(adam.DEFAULT_HPARAMS), "adam", 3)
    for strategy in ("fused", "all_gather"):
        got = _port_steps(g, x, y, train, 4, config, dict(adam.DEFAULT_HPARAMS), "adam", 3, "pattern", strategy)
        np.testing.assert_allclose([s[1] for s in got], [s[1] for s in want], rtol=1e-4)
        _assert_params_close(got[-1][0], want[-1][0], 5e-4, 5e-6)
    assert want[-1][1] < want[0][1]


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("aggs", ["one_card", "coo"])
@pytest.mark.parametrize("parity", [True, False])
def test_one_partition_equals_the_single_card_step(parity, aggs, mask):
    """At P = 1 the row-partitioned step is the one-card step, so that a
    second copy of the layer stack that drifts fails here:
    ``dist_loss_and_grad`` (parity) or ``dist_loss_and_grad_exact`` on one
    CPU partition against ``models.gcn.loss_and_grad`` on the COO pair, with
    the one-card pair's own aggregation or the COO ring pair: loss at rtol
    1e-5, each gradient leaf within 1e-5 of its norm. On the CPU the two are
    bit for bit (the loss layers' divisions by n and by a tensor of n agree
    there), and that is asserted too."""
    n = 600
    config = GCNConfig(sizes=SIZES, residual=True, parity=parity)
    g = sparse.random_graph(n, 4, seed=22, weights="ones")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((n, SIZES[0])).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, SIZES[-1], n))
    train = torch.from_numpy(rng.random(n) < 0.6) if mask else None
    params = tgcn.init_params(config, seed=5, device="cpu")
    pair = build_agg_pair(g, impl="xla", device="cpu")
    loss, acc, grads = tgcn.loss_and_grad(params, pair, x, y, config, train)
    ring = _cpu_ring(1)
    if aggs == "one_card":
        agg_fwd, agg_bwd = tgcn._one_block(pair)
    else:
        a = sparse.normalize(g, axis=True)
        agg_fwd, agg_bwd = dist._aggregations("coo", dist.build_pair("coo", sparse.transpose(a), a, ring), "ring",
                                              "float32")
    lag = dist.dist_loss_and_grad if parity else dist.dist_loss_and_grad_exact
    dloss, dacc, dgrads = lag([params], agg_fwd, agg_bwd, [x], [y], config, n, None if train is None else [train],
                              mesh=ring)
    np.testing.assert_allclose(float(dloss), float(loss), rtol=1e-5)
    assert float(dacc) == float(acc)
    for layer, ref in zip(dgrads, grads, strict=True):
        assert layer.keys() == ref.keys()
        for k in ref:
            assert float(torch.linalg.vector_norm(layer[k] - ref[k])) <= 1e-5 * float(torch.linalg.vector_norm(ref[k]))
            assert torch.equal(layer[k], ref[k]), k
    assert torch.equal(dloss, loss) and torch.equal(dacc, acc)


def test_bf16_and_int8_steps_stay_near_float32():
    config = GCNConfig(sizes=SIZES)
    g, x, y, train = _problem(2, False)
    hp = dict(adam.DEFAULT_HPARAMS)
    ref = _port_steps(g, x, y, train, 2, config, hp, "adam", 2, "pattern", "fused")
    for dtype in ("bfloat16", "int8"):
        got = _port_steps(g, x, y, train, 2, config, hp, "adam", 2, "pattern", "fused", dtype=dtype)
        np.testing.assert_allclose([s[1] for s in got], [s[1] for s in ref], rtol=1e-2)


def test_replicate_one_copy_per_distinct_device():
    """Partitions sharing a device share one replica of the parameters and
    of the optimizer state."""
    ring = dist.Ring((torch.device("cpu"), torch.device("cpu")))
    assert ring.replica_devices == (torch.device("cpu"),)
    params = [{"W": torch.ones(2, 2), "b": torch.zeros(1, 2)}]
    reps = dist.replicate(params, ring)
    assert len(reps) == 1 and reps[0][0]["W"] is params[0]["W"]
    state = dist.replicate(adam.adam_init(params), ring)
    assert isinstance(state[0], adam.AdamState)


# ---------------------------------------------------------------------------
# the CLI


def _epoch_lines(err):
    return [line.split() for line in err.splitlines() if line[:1].isdigit() and len(line.split()) == 4]


def test_cli_dist_matches_jax_cli(tmp_path, capsys):
    """``-P 2 -R 1 --device cpu -E 3 train <golden> 1 8`` against the JAX
    CLI's ``-P 2 -R 1 --impl xla`` (its COO ring on the CPU mesh): the same
    header, line format and losses; the last width rounded up to a
    multiple of P (7 -> 8) in the CSV name."""
    rc = cli.main(["-P", "2", "-R", "1", "--device", "cpu", "-E", "3", "--csv-dir", str(tmp_path / "port"),
                   "train", GOLDEN, "1", "8"])
    got = capsys.readouterr().err
    assert rc == 0
    rc = jcli.main(["-P", "2", "-R", "1", "--impl", "xla", "-E", "3", "--csv-dir", str(tmp_path / "jax"),
                    "train", GOLDEN, "1", "8"])
    want = capsys.readouterr().err
    assert rc == 0
    assert got.splitlines()[:3] == want.splitlines()[:3]
    ge, we = _epoch_lines(got), _epoch_lines(want)
    assert [e[0] for e in ge] == ["0", "1", "2"] == [e[0] for e in we]
    np.testing.assert_allclose([float(e[1]) for e in ge], [float(e[1]) for e in we], rtol=1e-5)
    assert [e[2] for e in ge] == [e[2] for e in we]
    ds = Dataset.load(GOLDEN)
    sizes = [ds.num_features, 8, 8]
    assert ds.num_labels == 7
    assert cli._csv_name(GOLDEN, sizes, 2) == jcli._csv_name(GOLDEN, sizes, 2)
    keys = [line.split(":")[0] for line in (tmp_path / "port" / cli._csv_name(GOLDEN, sizes, 2)).read_text().splitlines()]
    assert keys == ["0_preprocess", "0_0_epoch", "1_0_epoch", "2_0_epoch"]


@pytest.mark.parametrize("exchange", ["auto", "ring", "all_gather"])
def test_cli_pattern_pair_on_the_cpu(tmp_path, capsys, exchange):
    """``--impl pattern`` takes the dist pattern pair on the CPU too (plain
    versions); ``auto`` picks the fused exchange. Losses as the COO run's."""
    base = ["-P", "4", "-R", "1", "--device", "cpu,cpu,cpu,cpu", "-E", "2", "--csv-dir", str(tmp_path)]
    assert cli.main([*base, "train", GOLDEN, "1", "8"]) == 0
    coo = _epoch_lines(capsys.readouterr().err)
    assert cli.main([*base, "--impl", "pattern", "--pattern-dtype", "float32", "--exchange", exchange,
                     "train", GOLDEN, "1", "8"]) == 0
    err = capsys.readouterr().err
    assert ("exchange: fused ring (auto)" in err) == (exchange == "auto")
    np.testing.assert_allclose([float(e[1]) for e in _epoch_lines(err)], [float(e[1]) for e in coo], rtol=1e-5)


def _weighted_dir(tmp_path):
    g = sparse.random_graph(256, 4, seed=1, weights="random")
    rng = np.random.default_rng(0)
    d = str(tmp_path / "weighted")
    Dataset(graph=g, features=rng.standard_normal((256, 8)).astype(np.float32),
            labels=rng.integers(0, 3, (256, 1)).astype(np.int32), sets=np.zeros((256, 1), np.int32)).save(d)
    return d


@pytest.mark.parametrize(
    "args,message",
    [
        (["-P", "2", "-R", "0", "--mask-train"], "-R 0 (column parallel) does not support --mask-train/--residual"),
        (["-P", "2", "-R", "1", "--exchange", "fused"], "--exchange fused needs the bit-pattern pair"),
        (["-P", "2", "-R", "1", "--impl", "pattern"], "pattern impl not applicable here"),
        (["-P", "4", "-R", "1", "--device", "cuda"], "requested -P 4 but only 0 devices visible"),
        (["-P", "3", "-R", "1", "--device", "cpu,cpu"], "--device lists 2 devices for -P 3"),
        (["-P", "3", "-R", "1", "--model", "gat", "--device", "cpu,cpu,cpu"], "node count 256 not divisible by P=3"),
        (["-P", "2", "-R", "1", "--impl", "gather", "-S"], "--impl gather uses the ring exchange; drop -S"),
        (["-P", "3", "-R", "1", "--impl", "halo", "--device", "cpu,cpu,cpu"], "node count 256 not divisible by P=3"),
        (["-P", "2", "-R", "1", "--multihost"], "no coordinator: set MG_GCN_COORDINATOR"),
    ],
    ids=lambda a: " ".join(a) if isinstance(a, list) else None,
)
def test_cli_dist_refusals(tmp_path, capsys, monkeypatch, args, message):
    """Each exits 2 with its message; the weighted graph has no pattern pair."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MG_GCN_COORDINATOR", raising=False)
    device = [] if "--device" in args else ["--device", "cpu"]
    assert cli.main([*args, *device, "-E", "1", "--csv-dir", str(tmp_path), "train", _weighted_dir(tmp_path),
                     "1", "8"]) == 2
    assert message in capsys.readouterr().err
