"""Port vs JAX package: GraphSAGE (``models/sage.py``) — the mean-aggregation
pair in every impl, the seed-99 init, logits and exact gradients with and
without l2 normalization, the train step of ``make_train_step(model="sage")``
and the CLI's ``--model sage``. The JAX pattern kernels run in interpret
mode; the port's kernels run their plain versions (the tensors lie on the
CPU)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu import sparse as jsparse
from mg_gcn_tpu import train as jtrain
from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.models import sage as jsage
from mg_gcn_tpu.nn import adam as jadam
from mg_gcn_tpu.ops import spmm as jspmm
from mg_gcn_tpu.ops import spmm_edges as jse
from mg_gcn_tpu.ops import spmm_pattern as jsp
from mg_gcn_tpu_torch import cli, convert, sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.models import sage
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.ops import spmm as tspmm
from mg_gcn_tpu_torch.ops import spmm_pattern as sp
from mg_gcn_tpu_torch.ops.spmm import COOMat, spmm
from mg_gcn_tpu_torch.ops.spmm_edges import EdgeTileMat
from mg_gcn_tpu_torch.ops.spmm_gather import GatherMat

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
N, F, C = 300, 10, 4
IMPLS = ["pattern", "edge", "gather", "xla"]
ENGINE = {"pattern": sp.PatternMat, "edge": EdgeTileMat, "gather": GatherMat, "xla": COOMat}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    """The JAX package's pattern kernels in interpret mode (its own tests'
    way off the TPU); the gather and edge kernels interpret by default."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jsp.pl, "pallas_call", patched)


def _jcsr(g: CSRData) -> JCSRData:
    return JCSRData(g.indptr, g.indices, g.data, g.shape)


def _graph(empty_rows: bool = True) -> CSRData:
    """A binary random graph of N nodes; rows 5..9 emptied (0 out-degree)."""
    g = sparse.random_graph(N, 5, seed=21)
    if not empty_rows:
        return g
    rows = np.repeat(np.arange(N), np.diff(g.indptr))
    keep = (rows < 5) | (rows > 9)
    indptr = np.r_[0, np.cumsum(np.bincount(rows[keep], minlength=N))].astype(np.int64)
    return CSRData(indptr, g.indices[keep], g.data[keep], g.shape)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, F)).astype(np.float32), rng.integers(0, C, N).astype(np.int32)


def _random_params(sizes, seed):
    """Per-matrix random parameters (Wself != Wneigh), as numpy."""
    rng = np.random.default_rng(seed)
    return [dict(Wself=(rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                 Wneigh=(rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                 b=(rng.standard_normal((1, o)) * 0.1).astype(np.float32))
            for i, o in zip(sizes[:-1], sizes[1:])]


def _assert_grads_close(grads, jgrads, rtol=1e-5):
    assert [sorted(g) for g in grads] == [sorted(g) for g in jgrads]
    for i, (gl, jgl) in enumerate(zip(grads, jgrads)):
        for k in jgl:
            want = np.asarray(jgl[k])
            np.testing.assert_allclose(gl[k].detach().numpy().reshape(want.shape), want, rtol=rtol,
                                       atol=rtol * np.abs(want).max(), err_msg=f"layer {i} {k}")


# ---------------------------------------------------------------------------
# the pair


@pytest.mark.parametrize("impl", IMPLS)
def test_build_sage_pair_matches_jax(impl):
    """Both directions of the pair against the JAX package's pair of the
    same impl and against the dense row-normalized matrix."""
    g = _graph()
    pair = sage.build_sage_pair(g, impl=impl, dtype="float32", device="cpu")
    jpair = jsage.build_sage_pair(_jcsr(g), impl=impl, dtype="float32")
    assert isinstance(pair.fwd, ENGINE[impl]) and isinstance(pair.bwd, ENGINE[impl])
    if impl == "pattern":
        assert (pair.fwd.orientation, pair.fwd.scale_side, pair.bwd.orientation, pair.bwd.scale_side) == (
            "P", "post", "PT", "pre")
        assert pair.fwd.pack is pair.bwd.pack  # one pack
        np.testing.assert_array_equal(pair.fwd.scale.numpy(), np.asarray(jpair.fwd.scale))
    m = sparse.normalize(g, axis=False).to_dense().astype(np.float64)
    b = np.random.default_rng(4).standard_normal((N, 24)).astype(np.float32)
    for mat, jmat, dense in ((pair.fwd, jpair.fwd, m), (pair.bwd, jpair.bwd, m.T)):
        got = spmm(mat, torch.from_numpy(b)).numpy()
        want = np.asarray(jspmm.spmm(jmat, jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, dense @ b, rtol=1e-5, atol=1e-6)


def test_row_scale_equals_jax():
    g = _graph()
    np.testing.assert_array_equal(sp.row_scale(g, 4096), jsp.row_scale(_jcsr(g), 4096))
    assert np.all(sp.row_scale(g, 4096)[5:10] == 0) and np.all(sp.row_scale(g, 4096)[N:] == 0)


@pytest.mark.parametrize("impl", IMPLS)
def test_mean_semantics_rows_sum_to_one(impl):
    """M·1 is 1 on every row with a neighbour and 0 on an empty row."""
    g = _graph()
    pair = sage.build_sage_pair(g, impl=impl, dtype="float32", device="cpu")
    got = spmm(pair.fwd, torch.ones((N, 1))).numpy().reshape(-1)
    want = (np.diff(g.indptr) > 0).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_pattern_pair_reuses_a_given_pack():
    g = _graph()
    pack = sp.pack_bits_on_device(g, 4096, torch.device("cpu"))
    pair = sage.build_sage_pair(g, impl="auto", pack=pack, device="cpu")  # a pack given: the pattern pair
    assert isinstance(pair.fwd, sp.PatternMat) and pair.fwd.pack is pack


def test_auto_rule(monkeypatch, capsys):
    """On the CPU auto is COO, as in the JAX package; on a card the pattern
    pair when the pack fits PATTERN_MEM_FRACTION of it (GCN's predicate),
    else the O(nnz) engine of train._edge_or_gather."""
    g = _graph()
    assert isinstance(sage.build_sage_pair(g, device="cpu").fwd, COOMat)
    monkeypatch.setattr(ttrain, "card_memory", lambda dev: 80 * 10**9)
    assert ttrain.mean_engine(g, torch.device("cpu")) == "pattern"
    w = sparse.random_graph(N, 5, seed=21, weights="random")
    assert ttrain.mean_engine(w, torch.device("cpu")) == ttrain._edge_or_gather(w)
    monkeypatch.setattr(ttrain, "card_memory", lambda dev: 10**6)  # the pack does not fit
    assert ttrain.mean_engine(g, torch.device("cpu")) == ttrain._edge_or_gather(g)
    assert ttrain.mean_engine(g, torch.device("cpu"), have_pack=True) == "pattern"
    assert capsys.readouterr().err.count("aggregation engine:") == 4


def test_pattern_feasible_is_the_gcn_rule():
    """SAGE, PageRank and GCN ask one predicate: binary, and the n_pad²/8
    pack within half the card."""
    g = _graph()
    n_pad = 4096
    assert sp.pattern_feasible(g, int(n_pad * n_pad / 8 / sp.PATTERN_MEM_FRACTION))
    assert not sp.pattern_feasible(g, int(n_pad * n_pad / 8 / sp.PATTERN_MEM_FRACTION) - 1)
    assert not sp.pattern_feasible(g, None)
    assert not sp.pattern_feasible(sparse.random_graph(N, 5, seed=21, weights="random"), 80 * 10**9)


def test_unknown_impl_raises_with_jax_message():
    g = _graph()
    with pytest.raises(ValueError) as got:
        sage.build_sage_pair(g, impl="block", device="cpu")
    with pytest.raises(ValueError) as want:
        jsage.build_sage_pair(_jcsr(g), impl="block")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="binary"):
        sage.build_sage_pair(sparse.random_graph(N, 5, seed=21, weights="random"), impl="pattern", device="cpu")


def test_no_coo_fallback(monkeypatch):
    """Where the edge build fails, the JAX package warns and falls back to its
    COO engine (sage.py:113-121); the port raises."""

    def refuse(*args, **kw):
        raise ValueError("schedule too large")

    monkeypatch.setattr(jse, "edge_pair_from_csr_pair", refuse)
    monkeypatch.setattr(sage, "edge_pair_from_csr_pair", refuse)
    g = _graph()
    assert isinstance(jsage.build_sage_pair(_jcsr(g), impl="edge").fwd, jspmm.COOMat)
    with pytest.raises(ValueError, match="schedule too large"):
        sage.build_sage_pair(g, impl="edge", device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sage.build_sage_pair(_graph())


# ---------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("sizes", [(F, 8, C), (F, 16, 8, C)])
def test_seed99_init_is_bit_equal_to_jax(sizes):
    params = sage.init_params(sage.SAGEConfig(sizes=sizes), device="cpu")
    jparams = jsage.init_params(jsage.SAGEConfig(sizes=sizes))
    for layer, jlayer in zip(params, jparams):
        assert list(layer) == list(jlayer) == ["Wself", "Wneigh", "b"]
        assert torch.equal(layer["Wself"], layer["Wneigh"])  # the reference reseeds a matrix
        for k in jlayer:
            np.testing.assert_array_equal(layer[k].numpy(), np.asarray(jlayer[k]))


def test_generator_init_has_the_jax_shapes():
    config = sage.SAGEConfig(sizes=(F, 8, C))
    params = sage.init_params(config, seed=5, device="cpu")
    jparams = jsage.init_params(jsage.SAGEConfig(sizes=(F, 8, C)), jax.random.key(5))
    for layer, jlayer in zip(params, jparams):
        assert {k: tuple(v.shape) for k, v in layer.items()} == {k: v.shape for k, v in jlayer.items()}
        assert not torch.equal(layer["Wself"], layer["Wneigh"])
    assert torch.equal(sage.init_params(config, seed=5, device="cpu")[0]["Wself"], params[0]["Wself"])


def test_l2_norm_rows_keeps_eps_inside_the_rsqrt():
    h = np.array([[3.0, 4.0], [0.0, 0.0], [1e-7, 0.0]], np.float32)
    got = sage.l2_norm_rows(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsage.l2_norm_rows(jnp.asarray(h))), rtol=1e-6)
    assert np.all(got[1] == 0) and abs(got[2, 0] - 1e-7 / np.sqrt(1e-14 + 1e-12)) < 1e-6


@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grad_matches_jax(impl, l2):
    """Loss, accuracy and every gradient leaf against the JAX package's
    autodiff on its pair of the same impl (float32), from random
    parameters with Wself != Wneigh, three layers (two l2-normalized
    hidden layers), the train-set mask on."""
    g = _graph()
    x, y = _inputs()
    mask = np.random.default_rng(9).random(N) < 0.7
    sizes = (F, 16, 8, C)
    config = sage.SAGEConfig(sizes=sizes, l2_normalize=l2)
    jconfig = jsage.SAGEConfig(sizes=sizes, l2_normalize=l2)
    pnp = _random_params(sizes, seed=7)
    jpair = jsage.build_sage_pair(_jcsr(g), impl=impl, dtype="float32")
    jl, ja, jg = jsage.loss_and_grad([{k: jnp.asarray(v) for k, v in la.items()} for la in pnp], jpair,
                                     jnp.asarray(x), jnp.asarray(y), jconfig, jnp.asarray(mask))
    pair = sage.build_sage_pair(g, impl=impl, dtype="float32", device="cpu")
    loss, acc, grads = sage.loss_and_grad(convert.params_from_numpy(pnp, "cpu"), pair, torch.from_numpy(x),
                                          torch.from_numpy(y.astype(np.int64)), config, torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert round(float(acc) * mask.sum()) == round(float(ja) * mask.sum())
    _assert_grads_close(grads, jg)
    logits = sage.forward(convert.params_from_numpy(pnp, "cpu"), pair, torch.from_numpy(x), config)
    jlogits = jsage.forward([{k: jnp.asarray(v) for k, v in la.items()} for la in pnp], jpair, jnp.asarray(x),
                            jconfig)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_pattern_modes_match_jax(dtype):
    """The int8 (per-feature quantized operands) and bfloat16 pattern modes
    against the JAX package's: the same rounding points, float32 sums."""
    g = _graph()
    x, y = _inputs()
    sizes = (F, 16, C)
    pnp = _random_params(sizes, seed=8)
    jpair = jsage.build_sage_pair(_jcsr(g), impl="pattern", dtype=dtype)
    jl, _, jg = jsage.loss_and_grad([{k: jnp.asarray(v) for k, v in la.items()} for la in pnp], jpair,
                                    jnp.asarray(x), jnp.asarray(y), jsage.SAGEConfig(sizes=sizes))
    pair = sage.build_sage_pair(g, impl="pattern", dtype=dtype, device="cpu")
    loss, _, grads = sage.loss_and_grad(convert.params_from_numpy(pnp, "cpu"), pair, torch.from_numpy(x),
                                        torch.from_numpy(y.astype(np.int64)), sage.SAGEConfig(sizes=sizes))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_grads_close(grads, jg, rtol=1e-4)


def test_layer0_aggregation_takes_no_gradient_product(monkeypatch):
    """An epoch launches L M-products and L - 1 Mᵀ-products: layer 0's
    aggregation of the features has no gradient."""
    g = _graph()
    x, y = _inputs()
    pair = sage.build_sage_pair(g, impl="xla", device="cpu")
    calls = []
    monkeypatch.setattr(tspmm, "spmm", lambda m, b, orig=tspmm.spmm: calls.append(m is pair.fwd) or orig(m, b))
    config = sage.SAGEConfig(sizes=(F, 8, 8, C))
    sage.loss_and_grad(sage.init_params(config, device="cpu"), pair, torch.from_numpy(x),
                       torch.from_numpy(y.astype(np.int64)), config)
    assert sorted(calls) == [False, False, True, True, True]


def test_three_epochs_match_jax_train_step():
    """Three Adam steps of make_train_step(model="sage") from the seed-99
    init (the port on the pattern pair, JAX on COO): losses and the final
    parameters; weight decay reaches Wself and Wneigh, not b."""
    g = _graph(empty_rows=False)
    x, y = _inputs()
    sizes = (F, 16, C)
    config, jconfig = sage.SAGEConfig(sizes=sizes), jsage.SAGEConfig(sizes=sizes)
    step = ttrain.make_train_step(config, model="sage")
    jstep = jtrain.make_train_step(jconfig, model="sage")
    params = sage.init_params(config, device="cpu")
    opt = adam.adam_init(params)
    jp = jsage.init_params(jconfig)
    jo = jadam.adam_init(jp)
    pair = sage.build_sage_pair(g, impl="pattern", dtype="float32", device="cpu")
    jpair = jsage.build_sage_pair(_jcsr(g), impl="xla")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    for _ in range(3):
        jp, jo, jl, ja = jstep(jp, jo, jpair, jnp.asarray(x), jnp.asarray(y), None)
        params, opt, loss, acc = step(params, opt, pair, xt, yt, None)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert round(float(acc) * N) == round(float(ja) * N)
    for layer, jlayer in zip(params, jp):
        for k in jlayer:
            np.testing.assert_allclose(layer[k].numpy(), np.asarray(jlayer[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    # decay only: a zero gradient moves W* by lr · wd-driven Adam steps and leaves b
    zero = [{k: torch.zeros_like(v) for k, v in la.items()} for la in params]
    moved, _ = adam.adam_update(params, zero, adam.adam_init(params))
    assert not torch.equal(moved[0]["Wself"], params[0]["Wself"])
    assert not torch.equal(moved[0]["Wneigh"], params[0]["Wneigh"])
    assert torch.equal(moved[0]["b"], params[0]["b"])


# ---------------------------------------------------------------------------
# the CLI


def _epochs(lines):
    return [line.split() for line in lines if len(line.split()) == 4 and line[:1].isdigit()]


def test_cli_sage_train_matches_jax(tmp_path, capsys):
    """``--model sage -E 3 train`` on the golden dataset: the JAX CLI's
    header lines and losses (JAX on COO, the port's CPU auto on COO too),
    and the timer CSV under the JAX CLI's name."""
    ds = Dataset.load(GOLDEN)
    assert cli.main(["-E", "3", "--device", "cpu", "--model", "sage", "--csv-dir", str(tmp_path / "p"), "train",
                     GOLDEN, "1", "16"]) == 0
    got = capsys.readouterr().err.splitlines()
    assert jcli.main(["-E", "3", "--impl", "xla", "--model", "sage", "--csv-dir", str(tmp_path / "j"), "train",
                      GOLDEN, "1", "16"]) == 0
    want = capsys.readouterr().err.splitlines()
    assert got[:3] == want[:3] == [f"{ds.num_nodes} {ds.graph.nnz}", f"num_labels = {ds.num_labels}",
                                   f"feature size = {ds.num_features}"]
    g, w = _epochs(got), _epochs(want)
    assert [e[0] for e in g] == ["0", "1", "2"]
    np.testing.assert_allclose([float(e[1]) for e in g], [float(e[1]) for e in w], rtol=1e-5)
    assert [e[2] for e in g] == [e[2] for e in w]
    name = jcli._csv_name(GOLDEN, [ds.num_features, 16, ds.num_labels], 1)
    keys = [line.split(":")[0] for line in (tmp_path / "p" / name).read_text().splitlines()]
    assert keys == ["0_preprocess", "0_0_epoch", "1_0_epoch", "2_0_epoch"]


@pytest.mark.parametrize(
    "args",
    [
        ["--model", "sage", "--impl", "block", "train"],
        ["--model", "sage", "--impl", "pallas", "train"],
        ["--model", "sage", "--residual", "train"],
        ["-P", "2", "-R", "0", "--model", "sage", "train"],
    ],
    ids=lambda a: " ".join(a),
)
def test_cli_sage_refusals_match_jax(args, capsys):
    """The SAGE option combinations the JAX CLI refuses exit 2 with its
    message."""
    argv = ["--device", "cpu", *args, GOLDEN, "1", "8"]
    assert cli.main(argv) == 2
    got = capsys.readouterr().err.splitlines()
    assert jcli.cmd_train(jcli.build_parser().parse_args(argv[2:])) == 2
    want = capsys.readouterr().err.splitlines()
    assert got == want[-1:]


def test_cli_sage_at_p_above_1_names_its_item(capsys):
    """SAGE at -P 2 trains (``parallel.dist.make_dist_sage_train_step``);
    the JAX CLI's refusal there exits 2 with its message, and what the port
    does not carry yet, streaming SAGE's feature shards from a memmap
    (``--mmap``), exits 2 naming its ROADMAP item."""
    argv = ["--device", "cpu,cpu", "-P", "2", "-R", "1", "--model", "sage", "--optimizer", "sgd", "train", GOLDEN,
            "1", "8"]
    assert cli.main(argv) == 2
    got = capsys.readouterr().err.splitlines()
    assert jcli.cmd_train(jcli.build_parser().parse_args(argv[2:])) == 2
    assert got == capsys.readouterr().err.splitlines()[-1:]
    assert cli.main(["-P", "2", "-R", "1", "--device", "cpu,cpu", "--model", "sage", "--mmap", "train", GOLDEN, "1",
                     "8"]) == 2
    assert "ROADMAP queue 1 item 9g" in capsys.readouterr().err
