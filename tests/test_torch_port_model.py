"""Port vs JAX package: the GCN model (parity and exact modes, with and
without residual), each parity quirk on its own, and checkpoints."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu import sparse as jsparse
from mg_gcn_tpu.checkpoint import load_checkpoint as jload
from mg_gcn_tpu.formats import Dataset as JDataset
from mg_gcn_tpu.models import gcn as jgcn
from mg_gcn_tpu.nn import adam as jadam
from mg_gcn_tpu.ops.spmm import AggPair as JAggPair
from mg_gcn_tpu.ops.spmm import COOMat as JCOOMat
from mg_gcn_tpu_torch import checkpoint, convert, sparse
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.models import gcn
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.ops import elementwise as ew
from mg_gcn_tpu_torch.ops.softmax_xent import softmax_xent
from mg_gcn_tpu_torch.ops.spmm import AggPair, COOMat
from mg_gcn_tpu_torch.train import build_agg_pair

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    ds = Dataset.load(GOLDEN)
    jds = JDataset.load(GOLDEN)
    a = jsparse.normalize(jds.graph, axis=True)
    jpair = JAggPair(JCOOMat.from_csr(jsparse.transpose(a)), JCOOMat.from_csr(a))
    return ds, jds, jpair


def _jax_params_np(jparams):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams]


@pytest.mark.parametrize("impl", ["xla", "pattern"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("parity", [True, False])
def test_loss_and_grad_matches_jax(golden, impl, residual, parity):
    ds, jds, jpair = golden
    sizes = (ds.num_features, 16, 8, ds.num_labels)  # 16->16 identity, 16->8 projection residuals
    jconfig = jgcn.GCNConfig(sizes=sizes, residual=residual, parity=parity)
    config = gcn.GCNConfig(sizes=sizes, residual=residual, parity=parity)
    jparams = jgcn.init_params(jconfig, jax.random.key(3))  # random, not equal-shaped copies
    x, y = jds.features, jds.labels.reshape(-1)
    jl, ja, jg = jgcn.loss_and_grad(jparams, jpair, jnp.asarray(x), jnp.asarray(y), jconfig)

    pair = build_agg_pair(ds.graph, impl=impl, pattern_dtype="float32", device=CPU)
    params = convert.params_from_numpy(_jax_params_np(jparams), CPU)
    loss, acc, grads = gcn.loss_and_grad(
        params, pair, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), config
    )
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(acc) == float(ja)
    assert [sorted(g) for g in grads] == [sorted(g) for g in jg]
    for i, (gl, jgl) in enumerate(zip(grads, jg)):
        for k in jgl:
            want = np.asarray(jgl[k])
            # the scale term keeps near-zero entries from dominating: both
            # sides sum the same float32 terms in different orders
            np.testing.assert_allclose(
                gl[k].numpy().reshape(want.shape), want, rtol=1e-5,
                atol=1e-5 * np.abs(want).max(), err_msg=f"layer {i} {k}",
            )


def test_golden_files_forward_and_parity_grads():
    """The golden per-layer activations and gradients (test_golden_files.py
    scheme) through the port."""
    from mg_gcn_tpu_torch.formats import read_dense

    ds = Dataset.load(GOLDEN)
    config = gcn.GCNConfig(sizes=(ds.num_features, 16, 16, ds.num_labels))
    params = [
        {
            "W": torch.from_numpy(read_dense(os.path.join(GOLDEN, f"{2 * i}.bin"))),
            "b": torch.from_numpy(read_dense(os.path.join(GOLDEN, f"{2 * i + 1}.bin"))),
        }
        for i in range(3)
    ]
    pair = build_agg_pair(ds.graph, impl="xla", device=CPU)
    x = torch.from_numpy(ds.features)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64))
    _, caches = gcn.forward(params, pair, x, config, return_caches=True)
    for i in range(3):
        np.testing.assert_allclose(
            caches[i]["post"].numpy(), read_dense(os.path.join(GOLDEN, f"o{i}.bin")), rtol=1e-4, atol=1e-5
        )
    loss, _, grads = gcn.loss_and_grad(params, pair, x, y, config)
    np.testing.assert_allclose(float(loss), float(open(os.path.join(GOLDEN, "loss.txt")).read()), rtol=1e-5)
    for i in range(3):
        for k, f in (("W", f"g{2 * i}.bin"), ("b", f"g{2 * i + 1}.bin")):
            np.testing.assert_allclose(
                grads[i][k].numpy(), read_dense(os.path.join(GOLDEN, f)), rtol=2e-4, atol=1e-6
            )


def _diag_pair(n, fwd_val, bwd_val):
    """A pair of scaled identity matrices as COO operators."""

    def mat(v):
        csr = CSRData(np.arange(n + 1), np.arange(n, dtype=np.int32), np.full(n, v, np.float32), (n, n))
        return COOMat.from_csr(csr, device=CPU)

    return AggPair(fwd=mat(fwd_val), bwd=mat(bwd_val))


def _inputs(n, f, c, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, c, n))
    return x, y


def test_quirk_layer0_skips_backward_spmm():
    """Layer 0 takes no backward SpMM: its gradients come from the
    unaggregated gradient (gcn.hpp:469-474). With a zero backward matrix an
    exact gradient would vanish; the parity one does not."""
    n, f, c = 12, 6, 3
    config = gcn.GCNConfig(sizes=(f, c))  # one lin-first layer
    params = gcn.init_params(config, device=CPU)
    x, y = _inputs(n, f, c, 0)
    pair = _diag_pair(n, 1.0, 0.0)
    _, _, grads = gcn.loss_and_grad(params, pair, x, y, config)
    t = softmax_xent(gcn.forward(params, pair, x, config), y).grad
    torch.testing.assert_close(grads[0]["W"], x.T @ t)
    torch.testing.assert_close(grads[0]["b"], t.sum(0, keepdim=True))
    _, _, exact = gcn.loss_and_grad(params, pair, x, y, gcn.GCNConfig(sizes=(f, c), parity=False))
    assert float(exact[0]["W"].abs().max()) == 0.0


def test_quirk_spmm_first_weight_grad_uses_layer_input():
    """In the SpMM-first order (out > in) the weight gradient is Hᵀ t, not
    (ÂH)ᵀ t (lin.setX(H), gcn.hpp:477)."""
    n, f, c = 12, 3, 5
    config = gcn.GCNConfig(sizes=(f, c))
    params = gcn.init_params(config, device=CPU)
    x, y = _inputs(n, f, c, 1)
    pair = _diag_pair(n, 2.0, 2.0)  # ÂH = 2H, so the two differ by 2x
    assert not config.layer_meta(0)["lin_first"]
    _, _, grads = gcn.loss_and_grad(params, pair, x, y, config)
    t = softmax_xent(gcn.forward(params, pair, x, config), y).grad
    torch.testing.assert_close(grads[0]["W"], x.T @ t)
    _, _, exact = gcn.loss_and_grad(params, pair, x, y, gcn.GCNConfig(sizes=(f, c), parity=False))
    torch.testing.assert_close(exact[0]["W"], (2 * x).T @ t)


def test_quirk_activation_mask_from_post_residual_buffer():
    """The activation gradient takes its sign from the post-activation,
    post-residual buffer (gcn.hpp:465), not from the pre-activation."""
    n, d = 6, 4
    meta = gcn.GCNConfig(sizes=(d, d, 2), residual=True).layer_meta(0)
    meta = dict(meta, backward_spmm=True)  # as layer i > 0 would have it
    assert meta["lin_first"] and meta["activation"] and meta["res_identity"]
    layer = {"W": torch.eye(d), "b": torch.zeros(1, d)}
    pre = torch.tensor([[-1.0, 2.0, -3.0, 4.0]] * n)
    h = torch.tensor([[5.0, -5.0, 1.0, 1.0]] * n)  # flips the sign of columns 0 and 1
    post = ew.leaky_relu(pre) + h
    g = torch.ones(n, d)
    _, agg_bwd = gcn._one_block(_diag_pair(n, 1.0, 1.0))
    (grads,), _ = gcn._layer_backward([layer], meta, agg_bwd, dict(h=[h], post=[post]), [g], 0.01, need_input_grad=True)
    t_post = torch.where(post > 0, g, 0.01 * g)
    t_pre = torch.where(pre > 0, g, 0.01 * g)
    torch.testing.assert_close(grads["b"], t_post.sum(0, keepdim=True))
    assert not torch.equal(grads["b"], t_pre.sum(0, keepdim=True))


def test_quirk_bias_rides_through_aggregation():
    """Linear first (out <= in): Â(HW + b), the bias inside the aggregation."""
    n, f, c = 8, 5, 2
    config = gcn.GCNConfig(sizes=(f, c))
    params = gcn.init_params(config, device=CPU)
    x, _ = _inputs(n, f, c, 2)
    logits = gcn.forward(params, _diag_pair(n, 3.0, 3.0), x, config)
    torch.testing.assert_close(logits, 3.0 * (x @ params[0]["W"] + params[0]["b"]))


def test_parity_backward_spmm_count():
    """One backward SpMM per layer except layer 0, at the bench's op order."""
    calls = []
    g = sparse.random_graph(64, 4, seed=2)
    config = gcn.GCNConfig(sizes=(24, 12, 12, 5))  # every layer linear-first
    pair = build_agg_pair(g, impl="xla", device=CPU)
    orig = gcn.spmm
    try:
        gcn.spmm = lambda m, b: calls.append(m is pair.bwd) or orig(m, b)
        x, y = _inputs(64, 24, 5, 3)
        gcn.loss_and_grad(gcn.init_params(config, device=CPU), pair, x, y, config)
    finally:
        gcn.spmm = orig
    assert calls == [True, True]


def test_checkpoint_round_trip_and_jax_compat(tmp_path):
    config = gcn.GCNConfig(sizes=(6, 4, 3), residual=True)
    params = gcn.init_params(config, seed=1, device=CPU)
    state = adam.adam_init(params)
    grads = [{k: torch.ones_like(v) for k, v in layer.items()} for layer in params]
    params, state = adam.adam_update(params, grads, state)
    path = tmp_path / "ck.npz"
    checkpoint.save_checkpoint(path, (params, state))
    p2, s2 = checkpoint.load_checkpoint(path, (gcn.init_params(config, device=CPU), adam.adam_init(params)))
    assert int(s2.step) == 1 and list(p2[0]) == list(params[0])
    for a, b in zip(p2 + s2.m + s2.v, params + state.m + state.v):
        for k in a:
            assert torch.equal(a[k], b[k])
    # the JAX package reads the port's checkpoint into its own tree
    jconfig = jgcn.GCNConfig(sizes=(6, 4, 3), residual=True)
    jt = jgcn.init_params(jconfig)
    jp, js = jload(path, (jt, jadam.adam_init(jt)))
    assert int(js.step) == 1
    for layer, jlayer in zip(params, jp):
        for k in layer:
            np.testing.assert_array_equal(layer[k].numpy(), np.asarray(jlayer[k]))
