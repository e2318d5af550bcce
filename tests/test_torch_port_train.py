"""Port vs JAX package: the slice as a whole — the training loop, the
aggregation-engine choice and the CLI."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_gcn_tpu import train as jtrain
from mg_gcn_tpu.cli import _csv_name as jax_csv_name
from mg_gcn_tpu.formats import Dataset as JDataset
from mg_gcn_tpu.ops import spmm_pattern as jsp
from mg_gcn_tpu_torch import cli, convert, sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.formats import Dataset
from mg_gcn_tpu_torch.ops.spmm import COOMat
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


@pytest.mark.parametrize("impl", sorted(ttrain.LATER_IMPLS))
def test_later_impls_name_their_roadmap_item(impl):
    g = sparse.random_graph(50, 3, seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.build_agg_pair(g, impl=impl, device="cpu")


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
        ["-P", "2", "-R", "1", "train"],
        ["--model", "sage", "train"],
        ["--model", "gat", "train"],
        ["--f64", "train"],
        ["--mmap", "train"],
        ["--multihost", "train"],
        ["--exchange", "ring", "train"],
        ["--time-phases", "train"],
        ["--profile", "prof", "train"],
        ["--impl", "edge", "train"],
        ["infer"],
        ["pagerank"],
    ],
    ids=lambda a: " ".join(a),
)
def test_cli_later_slices_exit_2(args, capsys):
    tail = [GOLDEN, "1", "8"] if args[-1] == "train" else [GOLDEN]
    assert cli.main(["--device", "cpu", *args, *tail]) == 2
    assert "ROADMAP" in capsys.readouterr().err
