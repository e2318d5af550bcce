"""Port vs JAX package: the slice as a whole — the training loop, the
aggregation-engine choice and the CLI."""

import os

import numpy as np
import pytest
import torch

from types import SimpleNamespace

import jax
import jax.numpy as jnp

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu import train as jtrain
from mg_gcn_tpu.cli import _csv_name as jax_csv_name
from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.formats import Dataset as JDataset
from mg_gcn_tpu.models import gcn as jgcn
from mg_gcn_tpu.ops import spmm_gather as jsg
from mg_gcn_tpu.ops import spmm_pattern as jsp
from mg_gcn_tpu_torch import cli, convert, sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.models import gcn as tgcn
from mg_gcn_tpu_torch.ops.spmm import COOMat
from mg_gcn_tpu_torch.ops.spmm_edges import EdgeTileMat
from mg_gcn_tpu_torch.ops.spmm_gather import GatherMat
from mg_gcn_tpu_torch.ops.spmm_pattern import PatternMat

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jsp.pl, "pallas_call", patched)


def test_train_trajectory_matches_jax():
    """20 epochs of the port (pattern pair, float32, CPU) against the JAX
    package's COO engine: losses within rel 1e-4, accuracies within one
    node of 256, every epoch."""
    ds, jds = Dataset.load(GOLDEN), JDataset.load(GOLDEN)
    got = ttrain.train(ds, [16, 16], epochs=20, impl="pattern", pattern_dtype="float32", device="cpu", log=False)
    want = jtrain.train(jds, [16, 16], epochs=20, impl="xla", log=False)
    assert got.engine == "pattern"
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert np.max(np.abs(np.array(got.accs) - np.array(want.accs))) <= 1 / 256
    assert got.losses[-1] < got.losses[0]


@pytest.mark.parametrize("impl", ["edge", "gather"])
def test_train_trajectory_on_o_nnz_engines_matches_jax(impl):
    """20 epochs of the port on the edge engine (float32) and the gather
    engine (binary pair) against the JAX package's COO engine."""
    ds, jds = Dataset.load(GOLDEN), JDataset.load(GOLDEN)
    got = ttrain.train(ds, [16, 16], epochs=20, impl=impl, pattern_dtype="float32", device="cpu", log=False)
    want = jtrain.train(jds, [16, 16], epochs=20, impl="xla", log=False)
    assert got.engine == impl
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert np.max(np.abs(np.array(got.accs) - np.array(want.accs))) <= 1 / 256


def _assert_params_close(got, want):
    for layer, jlayer in zip(convert.params_to_numpy(got), want):
        for k in jlayer:
            np.testing.assert_allclose(layer[k], np.asarray(jlayer[k]), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("impl", ["edge", "gather"])
def test_one_step_matches_jax_engine(impl):
    """One step against the JAX package's own edge / gather kernels (Pallas
    interpret mode off the TPU), from the same parameters, in float32."""
    ds, jds = Dataset.load(GOLDEN), JDataset.load(GOLDEN)
    want = jtrain.train(jds, [16], epochs=1, impl=impl, pattern_dtype="float32", log=False)
    got = ttrain.train(ds, [16], epochs=1, impl=impl, pattern_dtype="float32", device="cpu", log=False)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.accs == want.accs
    _assert_params_close(got.params, want.params)


@pytest.mark.parametrize("impl", ["edge", "gather"])
def test_weighted_golden_loss_and_grad_matches_jax(impl):
    """The golden graph with numpy edge weights through ``build_agg_pair``
    and ``loss_and_grad`` in both packages (float32 weights)."""
    ds, jds = Dataset.load(GOLDEN), JDataset.load(GOLDEN)
    g = ds.graph
    w = np.random.default_rng(5).random(g.nnz, np.float32) + 0.5
    sizes = (ds.num_features, 16, ds.num_labels)
    jparams = jgcn.init_params(jgcn.GCNConfig(sizes=sizes), jax.random.key(2))
    jpair = jtrain.build_agg_pair(JCSRData(g.indptr, g.indices, w, g.shape), impl=impl, pattern_dtype="float32")
    x, y = jds.features, jds.labels.reshape(-1)
    jl, ja, jg = jgcn.loss_and_grad(jparams, jpair, jnp.asarray(x), jnp.asarray(y), jgcn.GCNConfig(sizes=sizes))

    pair = ttrain.build_agg_pair(CSRData(g.indptr, g.indices, w, g.shape), impl=impl, pattern_dtype="float32",
                                 device="cpu")
    assert type(pair.fwd) is (EdgeTileMat if impl == "edge" else GatherMat)
    params = convert.params_from_numpy([{k: np.asarray(v) for k, v in p.items()} for p in jparams], "cpu")
    loss, acc, grads = tgcn.loss_and_grad(
        params, pair, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), tgcn.GCNConfig(sizes=sizes)
    )
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(acc) == float(ja)
    for gl, jgl in zip(grads, jg):
        for k in jgl:
            want = np.asarray(jgl[k])
            np.testing.assert_allclose(gl[k].numpy().reshape(want.shape), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize(
    "n,nnz",
    [
        (232_968, 114_964_049),  # Reddit: edge
        (2_449_029, 124_900_000),  # ogbn-products scale: gather
        (1_000, 5_000),
        (20_000, 1_300_000),
        (100_000, 100_000),
        (3_000_000, 3_000_000),
    ],
)
def test_edge_or_gather_matches_jax(n, nnz):
    g = SimpleNamespace(nrows=n, ncols=n, nnz=nnz)
    assert ttrain._edge_or_gather(g) == jtrain._edge_or_gather(g)


def test_edge_or_gather_differs_where_the_tpu_gather_schedule_is_infeasible():
    """The JAX package takes "edge" when the gather schedule would exceed the
    TPU's SMEM step budget; the card has none, so the port keeps "gather"."""
    g = SimpleNamespace(nrows=20_000_000, ncols=20_000_000, nnz=100_000_000)
    assert not jtrain._gather_feasible(g.nrows, g.ncols, g.nnz)
    assert (ttrain._edge_or_gather(g), jtrain._edge_or_gather(g)) == ("gather", "edge")


@pytest.mark.parametrize(
    "n,nnz,parts",
    [
        (232_968, 114_964_049, 4),  # Reddit: xla
        (2_449_032, 124_899_250, 4),  # ogbn-products padded to 4 partitions: gather
        (1_000, 5_000, 2),
        (100_000, 100_000, 4),
        (20_000, 1_300_000, 2),
    ],
)
def test_halo_engine_matches_jax(monkeypatch, n, nnz, parts):
    """The halo pair's local engine on a card against the JAX package's on
    the TPU (its backend faked), where its SMEM step budget admits the
    slab's schedule; off the TPU JAX takes "xla", as the port on the CPU."""
    g = SimpleNamespace(nrows=n, ncols=n, nnz=nnz)
    assert jtrain._gather_feasible(n // parts, n // parts, -(-nnz // parts), r_rows=jsg.R_ROWS)
    assert ttrain.halo_engine(g, on_card=False) == jtrain.halo_engine(g, parts) == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert ttrain.halo_engine(g, on_card=True) == jtrain.halo_engine(g, parts)


def test_halo_engine_differs_where_the_tpu_gather_schedule_is_infeasible(monkeypatch):
    """The JAX package takes "xla" for the halo pair when a slab's gather
    schedule would exceed the TPU's SMEM step budget; the card has none, so
    the port keeps "gather"."""
    g = SimpleNamespace(nrows=80_000_000, ncols=80_000_000, nnz=400_000_000)
    assert not jtrain._gather_feasible(g.nrows // 4, g.ncols // 4, g.nnz // 4, r_rows=jsg.R_ROWS)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert (ttrain.halo_engine(g, on_card=True), jtrain.halo_engine(g, 4)) == ("gather", "xla")


GB = 10**9


@pytest.mark.parametrize(
    "n,nnz,binary,card,want",
    [
        (232_968, 114_964_049, True, 80 * GB, "gather"),  # Reddit: index list 0.46 GB, pack 6.8 GB
        (232_968, 114_964_049, False, 80 * GB, "edge"),  # weighted Reddit
        (232_968, 114_964_049, True, 10 * GB, "edge"),  # pack over half of 10 GB
        (2_449_029, 124_900_000, True, 80 * GB, "gather"),  # products: pack 750 GB
        (2_449_029, 124_900_000, False, 80 * GB, "gather"),
        (2_449_029, 124_900_000, True, 2000 * GB, "gather"),  # the pack fits: index list 0.52 GB, pack 750 GB
        (232_968, 114_964_049, True, None, "xla"),  # the CPU
    ],
)
def test_auto_engine_is_a_function_of_card_memory(n, nnz, binary, card, want):
    g = SimpleNamespace(nrows=n, ncols=n, nnz=nnz, data=np.ones(3, np.float32) * (1.0 if binary else 0.5))
    impl, why = ttrain.auto_engine(g, card)
    assert impl == want
    if want in ("edge", "gather"):
        # the walk in a fitting pack's place names its index list; the others the edge-tile fill
        walk = f"CSR index list {(4 * nnz + 8 * (n + 1)) / 1e9:.3g} GB, bfloat16 operand"
        assert ("expected edge-tile fill" in why) != (walk in why)


@pytest.mark.parametrize(
    "n,nnz,dtype,card,want,past",
    [
        (232_968, 114_964_049, "int8", 80 * GB, "pattern", "which the CSR walk does not take"),
        (232_968, 114_964_049, "float32", 80 * GB, "gather", None),
        (20_000, 20_000**2 // 4, "bfloat16", 80 * GB, "pattern", "denser than 1 bit in 8"),  # 1 bit in 4.2
        (20_000, 20_000**2 // 16, "bfloat16", 80 * GB, "gather", None),  # 1 bit in 16.8 (the bytes favour the pack)
        (20_000, 20_000**2 // 40, "bfloat16", 80 * GB, "gather", None),
        # 1 bit in 102, but past the walk's int32 indices; the 31.7 GB pack fits
        (500_000, 2_500_000_000, "bfloat16", 80 * GB, "pattern", "2^31 entries or more"),
        # 1 bit in 46, the pack's 11.5 GB within 15 GB, two 8 GB index lists not
        (300_000, 2_000_000_000, "bfloat16", 30 * GB, "pattern", "two index lists past the budget"),
    ],
)
def test_auto_engine_weighs_the_index_list_against_the_pack(n, nnz, dtype, card, want, past):
    """Where the n_pad²/8 pack fits, auto takes the binary CSR walk where its
    kernel takes the operand dtype, at most WALK_DENSITY_MAX of the pack's
    bits are set, the entries fit int32 indices and its two index lists
    (4·nnz + 8·(n + 1) bytes each) fit the pack's budget; else the pattern
    pair. The reason names both byte counts, the density and the dtype, and
    each limit the walk is past."""
    from mg_gcn_tpu_torch.ops.spmm_pattern import N_ALIGN, round_up

    g = SimpleNamespace(nrows=n, ncols=n, nnz=nnz, data=np.ones(3, np.float32))
    impl, why = ttrain.auto_engine(g, card, pattern_dtype=dtype)
    assert impl == want
    bits = round_up(n, N_ALIGN) ** 2
    pack_gb, walk_gb = bits / 8 / 1e9, (4 * nnz + 8 * (n + 1)) / 1e9
    assert (nnz <= bits / 8) == (past != "denser than 1 bit in 8")
    assert (f"bit pack {pack_gb:.3g} GB within {card / 2e9:.1f} GB, 1 bit in {bits / nnz:.3g} set,"
            f" CSR index list {walk_gb:.3g} GB, {dtype} operand") in why
    assert why.count(", ") == 4 + (past is not None) and (past is None or past in why)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_auto_walk_keeps_the_pattern_pairs_rounding_points(monkeypatch, dtype):
    """auto's binary CSR walk in the pattern pair's place (a card of 80 GB,
    its size passed in through ``card_memory``): a GatherMat pair that
    streams bfloat16 exactly for a bfloat16 operand. At d = 41 and 128 each
    walk's kernel gets the pattern kernel's operand bit for bit (the
    backward's pre-scaled in float32, then rounded) on every row an entry
    reads, and the products agree within float32 summation-order tolerance.
    The graph has empty columns, the only rows where the two scales differ
    (1/max(cs, 1) against 0)."""
    from mg_gcn_tpu_torch.ops import spmm_gather as sg
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp
    from mg_gcn_tpu_torch.ops.spmm import spmm

    g = sparse.random_graph(3000, 4, seed=7, self_loops=False)
    read = torch.from_numpy(np.bincount(g.indices, minlength=g.ncols) > 0)
    assert not bool(read.all())
    monkeypatch.setattr(ttrain, "card_memory", lambda dev: 80 * GB)
    walk = ttrain.build_agg_pair(g, impl="auto", pattern_dtype=dtype, device="cpu")
    pack = ttrain.build_agg_pair(g, impl="pattern", pattern_dtype=dtype, device="cpu")
    assert isinstance(walk.fwd, GatherMat) and isinstance(walk.bwd, GatherMat) and not walk.fwd.has_w
    assert walk.fwd.stream_bf16 == walk.bwd.stream_bf16 == (dtype == "bfloat16")
    # only auto's pick in a pack's place streams bfloat16; --impl gather stays float32
    assert not ttrain.build_agg_pair(g, impl="gather", pattern_dtype=dtype, device="cpu").fwd.stream_bf16

    operands = {}

    def keep_operand(name, kernel):
        def run(*args):
            operands[name] = args[-1]
            return kernel(*args)
        return run

    monkeypatch.setattr(sg, "gather", keep_operand("walk", sg.gather))
    monkeypatch.setattr(sp, "pattern_fwd", keep_operand("pack", sp.pattern_fwd))
    monkeypatch.setattr(sp, "pattern_bwd", keep_operand("pack", sp.pattern_bwd))
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    rng = np.random.default_rng(3)
    for d in (41, 128):
        b = torch.from_numpy(rng.standard_normal((g.nrows, d)).astype(np.float32))
        for side in ("fwd", "bwd"):
            got, want = spmm(getattr(walk, side), b), spmm(getattr(pack, side), b)
            op_walk, op_pack = operands["walk"][:, :d], operands["pack"][: g.nrows, :d]
            assert op_walk.dtype == op_pack.dtype == sp.DTYPES[dtype]
            assert torch.equal(op_walk[read].view(bits), op_pack[read].view(bits)), (d, side)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


def test_auto_engine_pre_normalized_skips_pattern():
    # 300 nodes pad to 4,096: one of the 8 row blocks holds edges, so the
    # JAX rule takes the block pair (tile occupancy 1/8 < 0.5)
    g = sparse.random_graph(300, 4, seed=1)
    assert ttrain.auto_engine(g, 80 * GB)[0] == "block"
    assert ttrain.auto_engine(g, 80 * GB, pre_normalized=True)[0] == "edge"
    with pytest.raises(ValueError, match="raw binary"):
        ttrain.build_agg_pair(g, impl="pattern", device="cpu", pre_normalized=True)


def test_one_step_matches_jax_pattern_interpret(interpret):
    """One step against the JAX package's own pattern kernels (interpret
    mode), from the same parameters, in float32."""
    ds, jds = Dataset.load(GOLDEN), JDataset.load(GOLDEN)
    want = jtrain.train(jds, [16], epochs=1, impl="pattern", pattern_dtype="float32", log=False)
    got = ttrain.train(ds, [16], epochs=1, impl="pattern", pattern_dtype="float32", device="cpu", log=False)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.accs == want.accs
    for layer, jlayer in zip(convert.params_to_numpy(got.params), want.params):
        for k in jlayer:
            np.testing.assert_allclose(layer[k], np.asarray(jlayer[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_train_resumes_from_jax_state():
    """Parameters and Adam moments carried over from JAX continue the same
    run: JAX 3 epochs == JAX 2 epochs, then the port 1 epoch."""
    ds, jds = Dataset.load(GOLDEN), JDataset.load(GOLDEN)
    full = jtrain.train(jds, [8], epochs=3, impl="xla", log=False)
    head = jtrain.train(jds, [8], epochs=2, impl="xla", log=False)
    np_tree = lambda t: [{k: np.asarray(v) for k, v in layer.items()} for layer in t]  # noqa: E731
    st = head.opt_state
    tail = ttrain.train(
        ds, [8], epochs=1, impl="xla", device="cpu", log=False,
        params=convert.params_from_numpy(np_tree(head.params), "cpu"),
        opt_state=convert.adam_state_from_numpy(int(st.step), np_tree(st.m), np_tree(st.v), "cpu"),
    )
    np.testing.assert_allclose(tail.losses[0], full.losses[2], rtol=1e-5)


def test_auto_engine_choice():
    g = sparse.random_graph(300, 4, seed=1)
    # CPU: auto means the COO engine, as in the JAX package
    assert isinstance(ttrain.build_agg_pair(g, impl="auto", device="cpu").fwd, COOMat)
    assert isinstance(ttrain.build_agg_pair(g, impl="pattern", device="cpu").fwd, PatternMat)
    w = sparse.random_graph(300, 4, seed=1, weights="random")
    with pytest.raises(ValueError, match="binary"):
        ttrain.build_agg_pair(w, impl="pattern", device="cpu")
    assert isinstance(ttrain.build_agg_pair(w, impl="edge", device="cpu").fwd, EdgeTileMat)
    gather = ttrain.build_agg_pair(g, impl="gather", device="cpu")
    assert isinstance(gather.fwd, GatherMat) and not gather.fwd.has_w  # the binary pair
    assert ttrain.build_agg_pair(w, impl="gather", device="cpu").fwd.has_w


def test_halo_impl_is_a_distributed_mode(capsys):
    """impl="halo" on one device raises with the JAX package's message, and
    the CLI's ``--impl halo`` at -P 1 exits 2 with the JAX CLI's."""
    g = sparse.random_graph(50, 3, seed=1)
    with pytest.raises(ValueError) as got:
        ttrain.build_agg_pair(g, impl="halo", device="cpu")
    with pytest.raises(ValueError) as want:
        jtrain.build_agg_pair(JCSRData(g.indptr, g.indices, g.data, g.shape), impl="halo")
    assert str(got.value) == str(want.value)
    assert cli.main(["--device", "cpu", "--impl", "halo", "train", GOLDEN, "1", "8"]) == 2
    got = capsys.readouterr().err.splitlines()[-1]
    assert jcli.main(["--impl", "halo", "train", GOLDEN, "1", "8"]) == 2
    assert got == capsys.readouterr().err.splitlines()[-1] == "--impl halo is a distributed mode; use -P <num> -R 1"


def test_unknown_impl_rejected():
    with pytest.raises(ValueError, match="unknown aggregation impl"):
        ttrain.build_agg_pair(sparse.random_graph(50, 3), impl="bogus", device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = Dataset.load(GOLDEN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(ds, [8], epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.build_agg_pair(ds.graph)
    assert cli.main(["-E", "1", "train", GOLDEN, "1", "8"]) == 2


@pytest.mark.parametrize(
    "path,sizes,P",
    [("data/reddit", [602, 128, 41], 1), ("/x/permuted/reddit/", [3, 4], 4), ("toyA", [2], 1)],
)
def test_csv_name_matches_jax(path, sizes, P):
    assert cli._csv_name(path, sizes, P) == jax_csv_name(path, sizes, P)


def test_cli_train_stderr_and_csv(tmp_path, capsys):
    csv_dir = tmp_path / "csvs"
    rc = cli.main(["-E", "3", "--device", "cpu", "--csv-dir", str(csv_dir), "train", GOLDEN, "2", "16", "16"])
    assert rc == 0
    ds = Dataset.load(GOLDEN)
    lines = capsys.readouterr().err.splitlines()
    # the JAX CLI's header lines (cli.py:261-264), then one line an epoch
    assert lines[:3] == [
        f"{ds.num_nodes} {ds.graph.nnz}",
        f"num_labels = {ds.num_labels}",
        f"feature size = {ds.num_features}",
    ]
    epochs = [line.split() for line in lines[3:]]
    assert [int(e[0]) for e in epochs] == [0, 1, 2]
    want = jtrain.train(JDataset.load(GOLDEN), [16, 16], epochs=3, impl="xla", log=False)
    for e, loss, acc in zip(epochs, want.losses, want.accs):
        assert len(e) == 4
        np.testing.assert_allclose(float(e[1]), loss, rtol=1e-4)
        assert abs(float(e[2]) - acc) <= 1 / 256
        assert float(e[3]) > 0
    sizes = [ds.num_features, 16, 16, ds.num_labels]
    csv = csv_dir / cli._csv_name(GOLDEN, sizes, 1)
    keys = [line.split(":")[0] for line in csv.read_text().splitlines()]
    assert keys == ["0_preprocess", "0_0_epoch", "1_0_epoch", "2_0_epoch"]


@pytest.mark.parametrize("impl", ["edge", "gather"])
def test_cli_train_on_o_nnz_engines(tmp_path, capsys, impl):
    rc = cli.main(["-E", "3", "--device", "cpu", "--impl", impl, "--pattern-dtype", "float32",
                   "--csv-dir", str(tmp_path), "train", GOLDEN, "1", "16"])
    assert rc == 0
    ds = Dataset.load(GOLDEN)
    lines = capsys.readouterr().err.splitlines()
    assert lines[:3] == [f"{ds.num_nodes} {ds.graph.nnz}", f"num_labels = {ds.num_labels}",
                         f"feature size = {ds.num_features}"]
    epochs = [line.split() for line in lines[3:]]
    want = jtrain.train(JDataset.load(GOLDEN), [16], epochs=3, impl="xla", log=False)
    assert [int(e[0]) for e in epochs] == [0, 1, 2]
    for e, loss in zip(epochs, want.losses):
        assert len(e) == 4
        np.testing.assert_allclose(float(e[1]), loss, rtol=1e-4)


def test_cli_save_load_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    base = ["--device", "cpu", "--csv-dir", str(tmp_path)]
    assert cli.main(["-E", "2", *base, "--save", ck, "train", GOLDEN, "1", "8"]) == 0
    assert cli.main(["-E", "1", *base, "--load", ck, "train", GOLDEN, "1", "8"]) == 0
    assert cli.main(["-E", "3", *base, "train", GOLDEN, "1", "8"]) == 0
    err = capsys.readouterr().err.splitlines()
    epochs = [line.split() for line in err if line[:1].isdigit() and len(line.split()) == 4]
    resumed, straight = epochs[2], epochs[5]
    np.testing.assert_allclose(float(resumed[1]), float(straight[1]), rtol=1e-6)


@pytest.mark.parametrize(
    "args",
    [
        ["--mmap", "train"],
        ["--multihost", "train"],
        ["-P", "2", "-R", "1", "--impl", "halo", "--mmap", "train"],
        ["--multihost", "infer"],
        ["--multihost", "pagerank"],
    ],
    ids=lambda a: " ".join(a),
)
def test_cli_later_slices_exit_2(args, capsys, tmp_path, monkeypatch):
    """The flags these cases once refused: ``--mmap`` now trains with the
    epoch lines of the run without it, and ``--multihost`` with no
    coordinator (no ``MG_GCN_COORDINATOR``) exits 2 with initialize's
    message, for every command."""
    monkeypatch.delenv("MG_GCN_COORDINATOR", raising=False)
    tail = [GOLDEN, "1", "8"] if args[-1] == "train" else [GOLDEN]
    argv = ["--device", "cpu", "-E", "2", "--csv-dir", str(tmp_path), *args, *tail]
    if "--multihost" in args:
        assert cli.main(argv) == 2
        assert "no coordinator: set MG_GCN_COORDINATOR" in capsys.readouterr().err
        return
    assert cli.main(argv) == 0
    mapped = [line.split()[:3] for line in capsys.readouterr().err.splitlines() if line[:1].isdigit()]
    assert cli.main([a for a in argv if a != "--mmap"]) == 0
    read = [line.split()[:3] for line in capsys.readouterr().err.splitlines() if line[:1].isdigit()]
    assert mapped == read and len(mapped) == 3  # the header line, then two epochs


@pytest.mark.parametrize(
    "which,card,want",
    [
        ("banded", 80 * GB, "block"),  # tile occupancy 0.05: the block store
        ("uniform", 80 * GB, "gather"),  # every tile occupied; 1 bit in 470 set: the binary CSR walk
        ("banded", 10**6, "edge"),  # neither store fits half of 1 MB
        ("banded-weighted", 80 * GB, "edge"),
        ("banded-pre-normalized", 80 * GB, "edge"),
        # planes sparse (0.19) but the store (~11.5 GB) is past the block
        # builder's int32 addressing though within half the card: the dense
        # pack fits, and 1 bit in 300,000 is set: the binary CSR walk
        ("uniform-past-int32", 80 * GB, "gather"),
    ],
)
def test_auto_engine_block_rule(which, card, want):
    """The JAX package's rule (train.py:165-179) on real graphs: block when
    tiles or planes are sparse and the store fits the card and the builder's
    addressing, else, when the dense pack fits, the binary CSR walk on a
    graph no denser than WALK_DENSITY_MAX, else the O(nnz) engines; the
    reason names both occupancies."""
    from mg_gcn_tpu.ops import spmm_pattern_sparse as jsps
    from mg_gcn_tpu_torch.ops import spmm_pattern_sparse as sps

    if which == "uniform-past-int32":
        g = sparse.random_graph(300_000, 1, seed=2)
    elif which.startswith("banded"):
        g = sparse.banded_graph(20_000, 16, 150, seed=2)
    else:
        g = sparse.random_graph(20_000, 16, seed=2)
    if which.endswith("weighted"):
        g = CSRData(g.indptr, g.indices, g.data * 0.5, g.shape)
    occ = sps.estimate_occupancy(g)
    assert occ == tuple(float(v) for v in jsps.estimate_occupancy(JCSRData(g.indptr, g.indices, g.data, g.shape)))
    impl, why = ttrain.auto_engine(g, card, pre_normalized=which.endswith("normalized"))
    assert impl == want
    if which in ("banded", "uniform", "uniform-past-int32") and card == 80 * GB:
        assert f"tile occupancy {occ[0]:.3f}, plane occupancy {occ[1]:.3f}" in why
    if which == "uniform-past-int32":
        # the builder refuses this store before allocating it
        assert occ[1] < ttrain.BLOCK_PLANE_OCC_MAX
        with pytest.raises(ValueError, match="exceed int32 addressing"):
            sps.block_pattern_pair_from_binary_csr(g, device="cpu")


def test_build_agg_pair_block_and_pallas():
    g = sparse.banded_graph(5000, 6, 100, seed=1)
    pair = ttrain.build_agg_pair(g, impl="block", pattern_dtype="int8", device="cpu")
    assert type(pair.fwd).__name__ == "BlockPatternMat" and pair.fwd.dtype_name == "int8"
    with pytest.raises(ValueError, match="raw binary"):
        ttrain.build_agg_pair(g, impl="block", device="cpu", pre_normalized=True)
    w = CSRData(g.indptr, g.indices, g.data * 0.5, g.shape)
    with pytest.raises(ValueError, match="binary"):
        ttrain.build_agg_pair(w, impl="block", device="cpu")
    ell = ttrain.build_agg_pair(w, impl="pallas", tile_br=256, tile_bc=256, device="cpu")
    assert (ttrain.ENGINE_OF[type(ell.fwd)], ell.fwd.br, ell.bwd.bc) == ("pallas", 256, 256)
    with pytest.raises(ValueError, match="square tiles"):
        ttrain.build_agg_pair(w, impl="pallas", tile_br=256, tile_bc=128, device="cpu")


@pytest.mark.parametrize("impl", ["block", "pallas"])
def test_cli_train_on_block_and_pallas(tmp_path, capsys, impl):
    rc = cli.main(["-E", "3", "--device", "cpu", "--impl", impl, "--pattern-dtype", "float32",
                   "--csv-dir", str(tmp_path), "train", GOLDEN, "1", "16"])
    assert rc == 0
    ds = Dataset.load(GOLDEN)
    lines = capsys.readouterr().err.splitlines()
    assert lines[:3] == [f"{ds.num_nodes} {ds.graph.nnz}", f"num_labels = {ds.num_labels}",
                         f"feature size = {ds.num_features}"]
    epochs = [line.split() for line in lines[3:]]
    want = jtrain.train(JDataset.load(GOLDEN), [16], epochs=3, impl="xla", log=False)
    assert [int(e[0]) for e in epochs] == [0, 1, 2]
    for e, loss in zip(epochs, want.losses):
        np.testing.assert_allclose(float(e[1]), loss, rtol=1e-4)
    sizes = [ds.num_features, 16, ds.num_labels]
    assert (tmp_path / cli._csv_name(GOLDEN, sizes, 1)).exists()
