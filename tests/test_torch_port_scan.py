"""Port vs JAX package: the multi-epoch step ``train.make_scan_train_steps``
(``mg_gcn_tpu/train.py:307-345``, ``lax.scan``) for GCN (parity and exact),
SAGE and GAT, three epochs from the same parameters; and the port's scan
against its own loop of ``make_train_step``. On the CPU the scan takes the
loop route (``train.scan_route``); its replayed CUDA graph is held on the
card (``tests/test_torch_port_cuda.py``). The JAX attention kernels run in
interpret mode, their default off the TPU; the GCN and SAGE pairs of the
JAX side are its COO engine."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu import train as jtrain
from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.models import gat as jgat
from mg_gcn_tpu.models import gcn as jgcn
from mg_gcn_tpu.models import sage as jsage
from mg_gcn_tpu.nn import adam as jadam
from mg_gcn_tpu_torch import convert, sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.models import gat, gcn, sage
from mg_gcn_tpu_torch.nn import adam
from tests.test_torch_port_gat import random_params as gat_random_params
from tests.test_torch_port_gat import toy_graph as gat_toy_graph
from tests.test_torch_port_sddmm import jax_csr

N, F, C = 200, 10, 4
EPOCHS = 3
CASES = ["gcn-parity", "gcn-exact", "sage", "gat"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, F)).astype(np.float32), rng.integers(0, C, n).astype(np.int32)


def _case(case: str):
    """(model, port config, JAX config, port pair, JAX pair, numpy params,
    x, y): GCN on the port's float32 pattern pair (parity) or COO (exact),
    SAGE on the pattern pair, GAT (2 heads, per-head random parameters) on
    the float32 attention graph."""
    if case == "gat":
        config, jconfig = gat.GATConfig(sizes=(F, 8, C), heads=2), jgat.GATConfig(sizes=(F, 8, C), heads=2)
        g = gat_toy_graph(False)
        x, y = _inputs(g.nrows)
        return ("gat", config, jconfig, gat.build_gat_graph(g, dtype="float32", device="cpu"),
                jgat.build_gat_graph(jax_csr(g), dtype="float32"), gat_random_params(config, seed=8), x, y)
    g = sparse.random_graph(N, 5, seed=21)
    jg = JCSRData(g.indptr, g.indices, g.data, g.shape)
    x, y = _inputs(N)
    if case == "sage":
        sizes = (F, 16, C)
        config, jconfig = sage.SAGEConfig(sizes=sizes), jsage.SAGEConfig(sizes=sizes)
        params = jax.tree.map(np.asarray, jsage.init_params(jconfig))
        return ("sage", config, jconfig, sage.build_sage_pair(g, impl="pattern", dtype="float32", device="cpu"),
                jsage.build_sage_pair(jg, impl="xla"), params, x, y)
    parity = case == "gcn-parity"
    sizes = (F, 16, 16, C)
    config, jconfig = gcn.GCNConfig(sizes=sizes, parity=parity), jgcn.GCNConfig(sizes=sizes, parity=parity)
    params = jax.tree.map(np.asarray, jgcn.init_params(jconfig))
    pair = ttrain.build_agg_pair(g, impl="pattern" if parity else "xla", pattern_dtype="float32", device="cpu")
    return "gcn", config, jconfig, pair, jtrain.build_agg_pair(jg, impl="xla"), params, x, y


def _port_inputs(params, x, y):
    tp = convert.params_from_numpy(params, "cpu")
    return tp, adam.adam_init(tp), torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))


def _leaves(run) -> list:
    params, opt, losses, accs = run
    return ttrain._leaves(params, opt) + [losses, accs]


def _loop(step, params, opt, pair, x, y, epochs):
    losses, accs = [], []
    for _ in range(epochs):
        params, opt, loss, acc = step(params, opt, pair, x, y, None)
        losses.append(loss)
        accs.append(acc)
    return params, opt, torch.stack(losses), torch.stack(accs)


@pytest.mark.parametrize("case", CASES)
def test_scan_matches_jax_scan(case):
    """Three epochs of the port's scan against the JAX
    ``make_scan_train_steps`` from the same parameters: the losses within
    rtol 1e-5, the accuracies to the node, the parameters within rtol 1e-4 /
    atol 1e-6, Adam's step count 3 in both."""
    model, config, jconfig, pair, jpair, params, x, y = _case(case)
    tp, to, xt, yt = _port_inputs(params, x, y)
    jp = jax.tree.map(jnp.asarray, params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # donated buffers the CPU backend cannot reuse
        jp, jo, jl, ja = jtrain.make_scan_train_steps(jconfig, EPOCHS, model=model)(
            jp, jadam.adam_init(jp), jpair, jnp.asarray(x), jnp.asarray(y), None)
    tp, to, losses, accs = ttrain.make_scan_train_steps(config, EPOCHS, model=model)(tp, to, pair, xt, yt, None)
    assert losses.shape == accs.shape == (EPOCHS,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_array_equal(np.round(accs.numpy() * len(y)), np.round(np.asarray(ja) * len(y)))
    assert int(to.step) == int(jo.step) == EPOCHS
    for layer, jlayer in zip(tp, jp):
        assert layer.keys() == jlayer.keys()
        for k in jlayer:
            want = np.asarray(jlayer[k])
            np.testing.assert_allclose(layer[k].numpy().reshape(want.shape), want, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_scan_equals_its_own_loop_bit_for_bit(case):
    """The scan equals three calls of ``make_train_step``'s step: every
    parameter, Adam moment and step count, loss and accuracy, bit for bit."""
    model, config, _, pair, _, params, x, y = _case(case)
    tp, to, xt, yt = _port_inputs(params, x, y)
    got = ttrain.make_scan_train_steps(config, EPOCHS, model=model)(tp, to, pair, xt, yt, None)
    want = _loop(ttrain.make_train_step(config, model=model), tp, to, pair, xt, yt, EPOCHS)
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_second_call_continues_the_first_and_aliases_nothing():
    """A call on the scan's own results continues the run (two calls of 3
    epochs equal 6 steps bit for bit); Adam's step count advances by
    num_epochs a call; no returned tensor shares storage with an input or
    with another output, and the inputs are left as they were."""
    model, config, _, pair, _, params, x, y = _case("gcn-parity")
    tp, to, xt, yt = _port_inputs(params, x, y)
    before = [t.clone() for t in ttrain._leaves(tp, to)]
    steps = ttrain.make_scan_train_steps(config, EPOCHS, model=model)
    first = steps(tp, to, pair, xt, yt, None)
    assert int(first[1].step) == EPOCHS
    second = steps(first[0], first[1], pair, xt, yt, None)
    assert int(second[1].step) == 2 * EPOCHS
    want = _loop(ttrain.make_train_step(config, model=model), tp, to, pair, xt, yt, 2 * EPOCHS)
    for a, b in zip(ttrain._leaves(second[0], second[1]), ttrain._leaves(want[0], want[1]), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(torch.cat([first[2], second[2]]), want[2])
    assert torch.equal(torch.cat([first[3], second[3]]), want[3])
    assert all(torch.equal(a, b) for a, b in zip(ttrain._leaves(tp, to), before))
    inputs = {t.untyped_storage().data_ptr() for t in ttrain._leaves(tp, to) + [xt, yt]}
    outputs = [t.untyped_storage().data_ptr() for t in _leaves(first)]
    assert len(set(outputs)) == len(outputs) and not inputs & set(outputs)


def test_unknown_model_and_no_epochs_raise():
    config = gcn.GCNConfig(sizes=(F, C))
    with pytest.raises(ValueError, match="unknown model"):
        ttrain.make_scan_train_steps(config, EPOCHS, model="gin")
    with pytest.raises(ValueError, match="num_epochs"):
        ttrain.make_scan_train_steps(config, 0)


def test_route_on_the_cpu_is_the_loop_printed_once(capsys):
    """The rule sends CPU tensors to the loop; the route is printed once,
    however many calls follow."""
    assert ttrain.scan_route(torch.device("cpu")) == ("loop", "the CPU has no CUDA graphs")
    model, config, _, pair, _, params, x, y = _case("sage")
    tp, to, xt, yt = _port_inputs(params, x, y)
    steps = ttrain.make_scan_train_steps(config, 2, model=model)
    out = steps(tp, to, pair, xt, yt, None)
    steps(out[0], out[1], pair, xt, yt, None)
    assert steps.route == "loop" and steps.captures == []
    assert capsys.readouterr().err.count("scan route: loop (the CPU has no CUDA graphs)") == 1
