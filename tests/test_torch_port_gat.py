"""Port vs JAX package: the GAT slice as a whole — ``models/gat.py`` (init,
logits, gradients), the train step of ``train.make_train_step(model="gat")``
and the CLI's ``--model gat``. The JAX model runs its Pallas kernels in
interpret mode under ``jax.jit`` (each model compiled once); the port's
kernels run their plain versions (the tensors lie on the CPU). Random
per-head parameters are made with numpy and carried into both packages
(``convert``): under the seed-99 init both heads get the same ``W``, which
would hide a head-slicing fault."""

import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu import train as jtrain
from mg_gcn_tpu.models import gat as jgat
from mg_gcn_tpu.nn import adam as jadam
from mg_gcn_tpu_torch import cli, convert
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.models import gat
from mg_gcn_tpu_torch.nn import adam
from tests.test_torch_port_sddmm import jax_csr

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
N, F, C = 120, 12, 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def toy_graph(weighted: bool) -> CSRData:
    """Random graph with self loops; weighted: positive values with one
    1e-30 (log → −69, clamped to −30 by the edge-weighted bias)."""
    rng = np.random.default_rng(1)
    m = sps.random(N, N, density=0.05, format="csr", random_state=1, dtype=np.float32)
    m = (m + sps.identity(N, dtype=np.float32, format="csr")).tocsr()
    m.data = (rng.random(m.nnz) + 0.25).astype(np.float32) if weighted else np.ones(m.nnz, np.float32)
    if weighted:
        m.data[7] = 1e-30
    return CSRData(m.indptr.astype(np.int64), m.indices.astype(np.int32), m.data, m.shape)


def configs(sizes, heads, edge_weighted=False):
    return (gat.GATConfig(sizes=sizes, heads=heads, edge_weighted=edge_weighted),
            jgat.GATConfig(sizes=sizes, heads=heads, edge_weighted=edge_weighted))


def random_params(config, seed) -> list[dict]:
    """Per-head parameters that differ between heads, as numpy."""
    rng = np.random.default_rng(seed)
    params = []
    for i in range(config.num_layers):
        in_, out, H = config.layer_in(i), config.sizes[i + 1], config.heads
        b_width = out * (H if i + 1 < config.num_layers else 1)
        params.append(dict(
            W=rng.uniform(-0.6, 0.6, (in_, H * out)).astype(np.float32),
            a_dst=rng.uniform(-0.5, 0.5, (H, out)).astype(np.float32),
            a_src=rng.uniform(-0.5, 0.5, (H, out)).astype(np.float32),
            b=(0.1 * rng.standard_normal(b_width)).astype(np.float32),
        ))
    return params


def inputs(seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, F)).astype(np.float32), rng.integers(0, C, N).astype(np.int32)


def both_graphs(csr, dtype):
    return jgat.build_gat_graph(jax_csr(csr), dtype=dtype), gat.build_gat_graph(csr, dtype=dtype, device="cpu")


def assert_leaves_close(got, want, bound):
    """Per leaf, ‖port − JAX‖ ≤ bound · ‖JAX‖."""
    for i, (gl, jl) in enumerate(zip(got, want)):
        assert gl.keys() == jl.keys()
        for k in jl:
            w = np.asarray(jl[k])
            diff = np.linalg.norm(gl[k].detach().numpy().reshape(w.shape) - w)
            assert diff <= bound * np.linalg.norm(w), f"layer {i} {k}: {diff} > {bound} x {np.linalg.norm(w)}"


@pytest.mark.parametrize("heads", [1, 2, 3])
def test_seed99_init_is_bit_equal_to_jax(heads):
    config, jconfig = configs((F, 8, C), heads)
    got = convert.params_to_numpy(gat.init_params(config, None, device="cpu"))
    want = jgat.init_params(jconfig, None)
    for layer, jlayer in zip(got, want):
        assert layer.keys() == jlayer.keys()
        for k in jlayer:
            assert layer[k].dtype == np.float32 and np.array_equal(layer[k], np.asarray(jlayer[k])), k


def test_generator_init_has_the_jax_shapes():
    config, jconfig = configs((F, 8, C), 2)
    got = convert.params_to_numpy(gat.init_params(config, 3, device="cpu"))
    again = convert.params_to_numpy(gat.init_params(config, 3, device="cpu"))
    want = jgat.init_params(jconfig, jax.random.key(3))
    for layer, layer2, jlayer in zip(got, again, want):
        for k in jlayer:
            assert layer[k].shape == np.asarray(jlayer[k]).shape and np.array_equal(layer[k], layer2[k])
    assert not np.array_equal(got[0]["a_dst"][0], got[0]["a_dst"][1])


def test_convert_carries_gat_params_and_adam_state_both_ways():
    """``convert`` is generic over the leaves' names: GAT's W, a_dst, a_src
    and b (and Adam moments of that tree) cross from JAX to the port and
    back bit for bit."""
    _, jconfig = configs((F, 8, C), 2)
    jparams = jgat.init_params(jconfig, jax.random.key(4))
    as_np = jax.tree.map(np.asarray, jparams)
    back = convert.params_to_numpy(convert.params_from_numpy(as_np, "cpu"))
    state = convert.adam_state_from_numpy(3, as_np, as_np, "cpu")
    assert int(state.step) == 3
    for tree in (back, convert.params_to_numpy(state.m), convert.params_to_numpy(state.v)):
        for layer, jlayer in zip(tree, as_np):
            assert layer.keys() == jlayer.keys() == {"W", "a_dst", "a_src", "b"}
            for k in jlayer:
                assert layer[k].dtype == jlayer[k].dtype and np.array_equal(layer[k], jlayer[k]), k


@pytest.mark.parametrize(
    "sizes,heads,edge_weighted",
    [((F, 8, C), 1, False), ((F, C), 2, True)],
    ids=["2 layers 1 head", "1 layer 2 heads edge-weighted"],
)
def test_logits_match_jax_with_random_per_head_params(sizes, heads, edge_weighted):
    """float32 logits within rtol 1e-5 of their scale: the same rounded
    inputs, float32 sums in another order. (Two layers of two heads, the
    concatenation, are held through the loss and every gradient below.)"""
    config, jconfig = configs(sizes, heads, edge_weighted)
    jgraph, graph = both_graphs(toy_graph(edge_weighted), "float32")
    params = random_params(config, seed=heads)
    x, _ = inputs()
    want = np.asarray(jax.jit(lambda p, x: jgat.forward(p, jgraph, x, jconfig))(params, jnp.asarray(x)))
    got = gat.forward(convert.params_from_numpy(params, "cpu"), graph, torch.from_numpy(x), config).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if edge_weighted:  # the 1e-30 weight meets the clamp
        assert float(gat._log_weight_bias(graph[0]).min()) == -30.0


def test_loss_and_grad_match_jax_float32():
    """Two layers, two heads, float32: loss within rtol 1e-5 and every
    gradient leaf within ‖Δ‖ ≤ 1e-4 ‖JAX‖."""
    config, jconfig = configs((F, 8, C), 2)
    jgraph, graph = both_graphs(toy_graph(False), "float32")
    params = random_params(config, seed=5)
    x, y = inputs()
    jl, ja, jg = jax.jit(lambda p: jgat.loss_and_grad(p, jgraph, jnp.asarray(x), jnp.asarray(y), jconfig))(params)
    loss, acc, grads = gat.loss_and_grad(convert.params_from_numpy(params, "cpu"), graph, torch.from_numpy(x),
                                         torch.from_numpy(y.astype(np.int64)), config)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert round(float(acc) * N) == round(float(ja) * N)
    assert_leaves_close(grads, jg, 1e-4)


def test_loss_and_grad_match_jax_bfloat16_edge_weighted():
    """One layer, two heads, edge-weighted, on the bfloat16 attention graph:
    loss within rtol 1e-4 and every leaf within ‖Δ‖ ≤ 2⁻⁸ ‖JAX‖. Both
    packages round z, the attention weights and the cotangents to bfloat16,
    but from float32 values summed in another order, so a value near a
    rounding boundary can round to the neighbouring bfloat16 (one bf16 ulp,
    2⁻⁸ relative): the bound is that ulp on every element."""
    config, jconfig = configs((F, C), 2, edge_weighted=True)
    jgraph, graph = both_graphs(toy_graph(True), "bfloat16")
    params = random_params(config, seed=6)
    x, y = inputs(3)
    jl, _, jg = jax.jit(lambda p: jgat.loss_and_grad(p, jgraph, jnp.asarray(x), jnp.asarray(y), jconfig))(params)
    loss, _, grads = gat.loss_and_grad(convert.params_from_numpy(params, "cpu"), graph, torch.from_numpy(x),
                                       torch.from_numpy(y.astype(np.int64)), config)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    assert_leaves_close(grads, jg, 2.0**-8)


def test_three_adam_steps_match_jax_train_step():
    """Three steps of ``make_train_step(model="gat")`` in both packages
    from the same random parameters (one layer, one head; float32): losses
    and accuracies every step, and the parameters after them. Adam decays
    the W leaves only."""
    config, jconfig = configs((F, C), 1)
    jgraph, graph = both_graphs(toy_graph(False), "float32")
    params = random_params(config, seed=7)
    x, y = inputs(4)
    jstep = jtrain.make_train_step(jconfig, model="gat", donate=False)
    step = ttrain.make_train_step(config, model="gat")
    jp, jo = jax.tree.map(jnp.asarray, params), jadam.adam_init(jax.tree.map(jnp.asarray, params))
    tp = convert.params_from_numpy(params, "cpu")
    to = adam.adam_init(tp)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    for _ in range(3):
        jp, jo, jl, ja = jstep(jp, jo, jgraph, jnp.asarray(x), jnp.asarray(y), None)
        tp, to, loss, acc = step(tp, to, graph, xt, yt, None)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert round(float(acc) * N) == round(float(ja) * N)
    assert_leaves_close(tp, jp, 1e-4)


def test_make_train_step_rejects_unknown_models():
    with pytest.raises(ValueError, match="unknown model"):
        ttrain.make_train_step(gat.GATConfig(sizes=(2, 2)), model="gin")
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrain.make_train_step(gat.GATConfig(sizes=(2, 2)), optimizer="lamb", model="sage")


def test_gat_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gat.build_gat_graph(toy_graph(False))
    assert cli.main(["-E", "1", "--model", "gat", "train", GOLDEN, "1", "8"]) == 2


def test_cli_gat_stderr_and_csv(tmp_path, capsys):
    """``--model gat --heads 2`` on the golden dataset: the JAX CLI's header
    lines, one ``epoch loss acc seconds`` line an epoch with the losses of
    the library step from the seed-99 init, and the timer CSV under the JAX
    CLI's name. ``--pattern-dtype int8`` trains GAT in bfloat16, as the JAX
    CLI maps it (cli.py:390)."""
    ds = Dataset.load(GOLDEN)
    sizes = [ds.num_features, 16, ds.num_labels]
    config = gat.GATConfig(sizes=tuple(sizes), heads=2)
    graph = gat.build_gat_graph(ds.graph, device="cpu")
    params = gat.init_params(config, device="cpu")
    opt = adam.adam_init(params)
    step = ttrain.make_train_step(config, model="gat")
    x, y = torch.from_numpy(ds.features), torch.from_numpy(ds.labels.reshape(-1).astype(np.int64))
    want = []
    for _ in range(3):
        params, opt, loss, acc = step(params, opt, graph, x, y, None)
        want.append((float(loss), float(acc)))
    for dtype in ("bfloat16", "int8"):
        csv_dir = tmp_path / dtype
        rc = cli.main(["-E", "3", "--device", "cpu", "--model", "gat", "--heads", "2", "--pattern-dtype", dtype,
                       "--csv-dir", str(csv_dir), "train", GOLDEN, "1", "16"])
        assert rc == 0
        lines = capsys.readouterr().err.splitlines()
        assert lines[:3] == [f"{ds.num_nodes} {ds.graph.nnz}", f"num_labels = {ds.num_labels}",
                             f"feature size = {ds.num_features}"]
        epochs = [line.split() for line in lines[3:]]
        assert [int(e[0]) for e in epochs] == [0, 1, 2] and all(len(e) == 4 and float(e[3]) > 0 for e in epochs)
        np.testing.assert_allclose([float(e[1]) for e in epochs], [w[0] for w in want], rtol=1e-6)
        assert [float(e[2]) for e in epochs] == [w[1] for w in want]
        name = jcli._csv_name(GOLDEN, sizes, 1)
        keys = [line.split(":")[0] for line in (csv_dir / name).read_text().splitlines()]
        assert keys == ["0_preprocess", "0_0_epoch", "1_0_epoch", "2_0_epoch"]


@pytest.mark.parametrize(
    "args",
    [
        ["--edge-weighted", "train"],
        ["-P", "2", "--model", "gat", "train"],
        ["--model", "gat", "--impl", "pattern", "train"],
        ["--model", "gat", "--residual", "train"],
        ["-P", "2", "-R", "1", "--model", "gat", "--edge-weighted", "train"],
    ],
    ids=lambda a: " ".join(a),
)
def test_cli_gat_refusals_match_jax(args, capsys):
    """The option combinations the JAX CLI refuses exit 2 with its
    message."""
    argv = ["--device", "cpu", *args, GOLDEN, "1", "8"]
    assert cli.main(argv) == 2
    got = capsys.readouterr().err.splitlines()
    assert jcli.cmd_train(jcli.build_parser().parse_args(argv[2:])) == 2
    want = capsys.readouterr().err.splitlines()
    assert got == want[-1:]



def test_cli_gat_per_layer_heads_elu_and_skip(tmp_path, capsys):
    """``--heads 4,4,6 --activation elu --skip 1`` (the PPI form of GAT at
    small widths) on the golden dataset: the epoch lines carry the library
    step's losses from the seed-99 init, and ``infer`` takes the same flags
    for the checkpoint ``--save`` wrote."""
    ds = Dataset.load(GOLDEN)
    config = gat.GATConfig(sizes=(ds.num_features, 8, 8, ds.num_labels), heads=(4, 4, 6), activation="elu",
                           skip=(1,))
    graph = gat.build_gat_graph(ds.graph, device="cpu")
    params = gat.init_params(config, device="cpu")
    assert [layer["a_dst"].shape[0] for layer in params] == [4, 4, 6] and params[2]["W"].shape == (32, 6 * ds.num_labels)
    opt = adam.adam_init(params)
    step = ttrain.make_train_step(config, model="gat")
    x, y = torch.from_numpy(ds.features), torch.from_numpy(ds.labels.reshape(-1).astype(np.int64))
    want = []
    for _ in range(2):
        params, opt, loss, _ = step(params, opt, graph, x, y, None)
        want.append(float(loss))
    flags = ["--device", "cpu", "--model", "gat", "--heads", "4,4,6", "--activation", "elu", "--skip", "1"]
    ck = str(tmp_path / "gat.ckpt.npz")
    rc = cli.main(["-E", "2", *flags, "--save", ck, "--csv-dir", str(tmp_path), "train", GOLDEN, "2", "8", "8"])
    assert rc == 0
    epochs = [line.split() for line in capsys.readouterr().err.splitlines()[3:]]
    np.testing.assert_allclose([float(e[1]) for e in epochs], want, rtol=1e-6)
    out = str(tmp_path / "pred.bin")
    assert cli.main([*flags, "--load", ck, "--save", out, "infer", GOLDEN, "2", "8", "8"]) == 0
    preds = np.fromfile(out, np.int32)[-ds.num_nodes:]
    with torch.no_grad():
        logits = gat.forward(params, graph, x, config)
    assert np.array_equal(preds, torch.argmax(logits, dim=-1).numpy())


@pytest.mark.parametrize(
    "args,message",
    [
        (["--activation", "elu", "train", GOLDEN, "1", "8"], "--activation and --skip are GAT options"),
        (["--skip", "1", "--model", "sage", "train", GOLDEN, "1", "8"], "--activation and --skip are GAT options"),
        (["-P", "2", "-R", "1", "--model", "gat", "--activation", "elu", "train", GOLDEN, "1", "8"],
         "run on one card"),
        (["--model", "gat", "--heads", "4,4", "train", GOLDEN, "2", "8", "8"], "heads lists 2 counts for 3 layers"),
        (["--model", "gat", "--skip", "0", "train", GOLDEN, "1", "8"], "a skip needs equal widths"),
    ],
    ids=["elu gcn", "skip sage", "elu -P 2", "heads count", "skip widths"],
)
def test_cli_gat_option_refusals(args, message, capsys):
    """The new GAT flags exit 2 with a message where they do not apply."""
    assert cli.main(["--device", "cpu", "-E", "1", *args]) == 2
    assert message in capsys.readouterr().err
