"""Port vs JAX package: the f64 mode (``train(f64=True)``, the CLI's
``--f64``) on the COO engine, held to 1e-12 relative against the JAX
package's float64 step and against the float64 oracle tests/torch_oracle.py.

``jax_enable_x64`` is process-global, so the JAX side's float64 results
come from one subprocess for the module (as tests/test_f64.py builds its
step) and this process never turns the flag on."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu_torch import cli
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.models import gcn as tgcn
from tests import torch_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden")
# (sizes, residual, parity): layer 0 aggregate-first (out > in) and the
# later ones linear-first, the identity and projection residuals, both modes
CONFIGS = {
    "parity": ((12, 24, 4), False, True),
    "residual": ((12, 24, 24, 4), True, True),
    "exact": ((12, 24, 4), False, False),
}
TRAIN_HIDDEN = [16, 16]
TRAIN_EPOCHS = 3

JAX_SIDE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from mg_gcn_tpu import sparse
from mg_gcn_tpu.formats import Dataset
from mg_gcn_tpu.models.gcn import GCNConfig, init_params, loss_and_grad
from mg_gcn_tpu.train import build_agg_pair, train

configs, out_path, golden, hidden, epochs = eval(sys.argv[1]), sys.argv[2], sys.argv[3], eval(sys.argv[4]), int(sys.argv[5])
n = 96
g = sparse.random_graph(n, 5, seed=7, weights="random")
rng = np.random.default_rng(7)
x64 = rng.standard_normal((n, 12))
y = rng.integers(0, 4, n).astype(np.int32)
pair = build_agg_pair(g, impl="xla", coo_val_dtype=np.float64)
assert pair.fwd.vals.dtype == jnp.float64
out = dict(indptr=g.indptr, indices=g.indices, data=g.data, x=x64, y=y)
for name, (sizes, residual, parity) in configs.items():
    config = GCNConfig(sizes=sizes, residual=residual, parity=parity)
    params = init_params(config, dtype=jnp.float64)
    loss, acc, grads = jax.jit(loss_and_grad, static_argnums=4)(params, pair, jnp.asarray(x64), jnp.asarray(y), config)
    assert jnp.asarray(loss).dtype == jnp.float64
    out[f"{name}/loss"], out[f"{name}/acc"] = float(loss), float(acc)
    for i, (p, gr) in enumerate(zip(params, grads)):
        for k in p:
            out[f"{name}/param/{i}/{k}"] = np.asarray(p[k])
            out[f"{name}/grad/{i}/{k}"] = np.asarray(gr[k])
res = train(Dataset.load(golden), hidden, epochs=epochs, impl="xla", log=False, f64=True)
out["train/losses"], out["train/accs"] = np.asarray(res.losses), np.asarray(res.accs)
np.savez(out_path, **out)
print("JAX_F64_OK")
"""


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_f64(tmp_path_factory):
    """The JAX package's float64 steps and 3-epoch training, from one
    subprocess with jax_enable_x64 on."""
    out = str(tmp_path_factory.mktemp("jax_f64") / "jax_f64.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, repr(CONFIGS), out, GOLDEN, repr(TRAIN_HIDDEN),
                        str(TRAIN_EPOCHS)], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "JAX_F64_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(out))


def port_inputs(j):
    g = CSRData(j["indptr"], j["indices"], j["data"], (len(j["indptr"]) - 1,) * 2)
    return g, torch.from_numpy(j["x"]), torch.from_numpy(j["y"].astype(np.int64))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_f64_step_matches_jax(jax_f64, name):
    """The port's float64 step on the COO engine (float64 values widened
    from the float32 normalization) against the JAX package's: the loss,
    every gradient leaf within 1e-12 relative, the same nodes right; the
    seed-99 init cast to float64 is the JAX package's bit for bit."""
    sizes, residual, parity = CONFIGS[name]
    g, x, y = port_inputs(jax_f64)
    config = tgcn.GCNConfig(sizes=sizes, residual=residual, parity=parity)
    params = tgcn.init_params(config, device="cpu", dtype=torch.float64)
    for i, layer in enumerate(params):
        for k, v in layer.items():
            np.testing.assert_array_equal(v.numpy(), jax_f64[f"{name}/param/{i}/{k}"])
    pair = ttrain.build_agg_pair(g, impl="xla", device="cpu", coo_val_dtype=np.float64)
    assert pair.fwd.vals.dtype == torch.float64
    loss, acc, grads = tgcn.loss_and_grad(params, pair, x, y, config)
    assert loss.dtype == torch.float64
    assert rel(float(loss), jax_f64[f"{name}/loss"]) < 1e-12
    assert round(float(acc) * len(y)) == round(float(jax_f64[f"{name}/acc"]) * len(y))  # nodes right
    for i, layer in enumerate(grads):
        for k, v in layer.items():
            assert v.dtype == torch.float64
            want = jax_f64[f"{name}/grad/{i}/{k}"]
            assert rel(v.reshape(want.shape), want) < 1e-12, (name, i, k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_f64_step_matches_oracle(jax_f64, name):
    """The same step against tests/torch_oracle.py in float64 on the same
    float32-normalized Â (tests/test_f64.py's "shared input"): within
    1e-12 relative."""
    from mg_gcn_tpu_torch import sparse

    sizes, residual, parity = CONFIGS[name]
    g, x, y = port_inputs(jax_f64)
    config = tgcn.GCNConfig(sizes=sizes, residual=residual, parity=parity)
    params = tgcn.init_params(config, device="cpu", dtype=torch.float64)
    pair = ttrain.build_agg_pair(g, impl="xla", device="cpu", coo_val_dtype=np.float64)
    loss, acc, grads = tgcn.loss_and_grad(params, pair, x, y, config)
    a_hat = torch.from_numpy(sparse.normalize(g, axis=True).to_dense().astype(np.float64))
    ref = [{k: (v.reshape(-1) if k.startswith("b") else v) for k, v in layer.items()} for layer in params]
    if parity:
        _, loss_o, acc_o, grads_o = torch_oracle.run_parity(a_hat, a_hat.T, ref, x, y.numpy(), residual=residual)
    else:
        _, loss_o, acc_o, grads_o = torch_oracle.run_exact(a_hat.T, ref, x, y.numpy(), residual=residual)
    assert rel(float(loss), loss_o) < 1e-12
    assert float(acc) == acc_o
    for i, layer in enumerate(grads_o):
        for k, want in layer.items():
            assert rel(grads[i][k].reshape(want.shape), want) < 1e-12, (name, i, k)


def test_train_f64_matches_jax(jax_f64):
    """Three ``train(f64=True)`` epochs on the golden dataset (COO engine,
    seed-99 init in float64, Adam in float64) against the JAX package's
    losses within 1e-12 relative."""
    res = ttrain.train(Dataset.load(GOLDEN), TRAIN_HIDDEN, epochs=TRAIN_EPOCHS, impl="auto", f64=True,
                       device="cpu", log=False)
    assert res.engine == "xla"
    assert all(v.dtype == torch.float64 for layer in res.params for v in layer.values())
    for got, want in zip(res.losses, jax_f64["train/losses"], strict=True):
        assert rel(got, want) < 1e-12
    np.testing.assert_array_equal(res.accs, jax_f64["train/accs"])


def test_train_f64_refuses_kernel_impls():
    """Other impls raise with the JAX package's message."""
    ds = Dataset.load(GOLDEN)
    for impl in ("pattern", "edge", "gather", "block", "pallas"):
        with pytest.raises(ValueError, match=r"f64 mode runs on the COO/XLA engine only \(impl '" + impl):
            ttrain.train(ds, [8], epochs=1, impl=impl, f64=True, device="cpu", log=False)


@pytest.mark.parametrize(
    "args",
    [
        ["-P", "2", "-R", "1"],
        ["--model", "sage"],
        ["--model", "gat"],
        ["--impl", "pattern"],
        ["--impl", "gather"],
        ["--model", "sage", "--residual"],
    ],
    ids=lambda a: " ".join(a),
)
def test_cli_f64_refusals_match_jax(args, capsys):
    """``--f64`` with -P > 1, another model or a kernel impl: exit 2 and the
    JAX CLI's message, word for word (its refusal comes before it turns
    jax_enable_x64 on)."""
    argv = ["--f64", *args, "train", GOLDEN, "1", "8"]
    assert cli.main(["--device", "cpu", *argv]) == 2
    ours = capsys.readouterr().err
    assert jcli.main(argv) == 2
    theirs = capsys.readouterr().err
    assert ours == theirs
    assert ours.startswith("--f64 runs single-chip GCN on the COO/XLA engine")


def test_cli_f64_trains_in_float64(tmp_path, capsys):
    """``--f64 train`` runs (no exit 2) and prints the epochs of
    ``train(f64=True)`` on the same dataset."""
    argv = ["--device", "cpu", "-E", "2", "--f64", "--csv-dir", str(tmp_path), "train", GOLDEN, "1", "8"]
    assert cli.main(argv) == 0
    epochs = [line.split() for line in capsys.readouterr().err.splitlines() if re.fullmatch(r"\d+ \S+ \S+ \S+", line)]
    res = ttrain.train(Dataset.load(GOLDEN), [8], epochs=2, f64=True, device="cpu", log=False)
    assert [float(e[1]) for e in epochs] == res.losses
