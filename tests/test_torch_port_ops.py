"""Port vs JAX package: the ops — pattern SpMM pair (JAX side in Pallas
interpret mode, port side on the kernels' plain versions), COO SpMM,
aggregate, softmax_xent, Adam and SGD. Same numpy inputs into both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu import sparse as jsparse
from mg_gcn_tpu.nn import adam as jadam
from mg_gcn_tpu.ops import softmax_xent as jsx
from mg_gcn_tpu.ops import spmm as jspmm
from mg_gcn_tpu.ops import spmm_pattern as jsp
from mg_gcn_tpu_torch import convert, sparse
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.ops import softmax_xent as sx
from mg_gcn_tpu_torch.ops import spmm as tspmm
from mg_gcn_tpu_torch.ops import spmm_pattern as sp

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    # the JAX pattern kernels run as tests/test_spmm_pattern.py runs them
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jsp.pl, "pallas_call", patched)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def pattern_graph():
    g = sparse.random_graph(600, 5, seed=2)
    jpair = jsp.pattern_pair_from_binary_csr(g, dtype="float32")
    return g, jpair


# tolerance per operand dtype: f32 and bf16 see the same (rounded) inputs
# on both sides and differ only in the order of their f32 sums; int8 sums
# are int32 and exact, so the dequantized outputs are equal
TOL = {"float32": 1e-5, "bfloat16": 1e-4}


@pytest.mark.parametrize("orientation", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [8, 24, 41])
def test_spmm_pattern_matches_jax(pattern_graph, orientation, dtype, d):
    g, _ = pattern_graph
    jfwd, jbwd = jsp.pattern_pair_from_binary_csr(g, dtype=dtype)
    fwd, bwd = sp.pattern_pair_from_binary_csr(g, dtype=dtype, device=CPU)
    b = np.random.default_rng(d).random((g.nrows, d)).astype(np.float32)
    jm, m = (jfwd, fwd) if orientation == "fwd" else (jbwd, bwd)
    want = np.asarray(jsp.spmm_pattern(jm, jnp.asarray(b)))
    got = sp.spmm_pattern(m, _t(b)).numpy()
    assert got.shape == want.shape == (g.nrows, d)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=0)


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_plain_versions_against_dense(transpose, dtype):
    """The kernels' plain versions against a dense 0/1 matmul in float64."""
    g = sparse.random_graph(300, 4, seed=7)
    n_pad = sp.round_up(g.nrows, sp.N_ALIGN)
    pack = _t(sp.pack_csr_bits(g, n_pad).view(np.int32))
    rng = np.random.default_rng(1)
    if dtype == torch.int8:
        b = _t(rng.integers(-127, 128, (n_pad, 16)).astype(np.int8))
    else:
        b = _t(rng.standard_normal((n_pad, 16)).astype(np.float32)).to(dtype)
    p = np.zeros((n_pad, n_pad))
    p[: g.nrows, : g.ncols] = g.to_dense()
    dense = (p.T if transpose else p) @ b.to(torch.float64).numpy()
    fn = sp.pattern_fwd if transpose else sp.pattern_bwd
    got = fn(pack, b)
    assert got.dtype == (torch.int32 if dtype == torch.int8 else torch.float32)
    if dtype == torch.int8:
        np.testing.assert_array_equal(got.numpy(), dense.astype(np.int64))
    else:
        np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-5)


def test_spmm_pattern_rejects_weighted():
    g = sparse.random_graph(64, 4, seed=5, weights="random")
    with pytest.raises(ValueError, match="binary"):
        sp.pattern_pair_from_binary_csr(g, device=CPU)


def test_kernel_wrappers_count_no_cpu_launches():
    g = sparse.random_graph(100, 3, seed=1)
    fwd, _ = sp.pattern_pair_from_binary_csr(g, dtype="float32", device=CPU)
    before = (sum(sp.pattern_fwd.launches.values()), sum(sp.pattern_bwd.launches.values()))
    sp.spmm_pattern(fwd, torch.ones(100, 8))
    after = (sum(sp.pattern_fwd.launches.values()), sum(sp.pattern_bwd.launches.values()))
    assert after == before  # the plain version ran: the tensor lies on the CPU


@pytest.mark.parametrize("d", [5, 41])
def test_coo_spmm_matches_jax(d, monkeypatch):
    g = jsparse.normalize(sparse.random_graph(400, 6, seed=3), axis=True)
    b = np.random.default_rng(0).standard_normal((400, d)).astype(np.float32)
    want = np.asarray(jspmm.spmm(jspmm.COOMat.from_csr(g), jnp.asarray(b)))
    mat = tspmm.COOMat.from_csr(g, device=CPU)
    np.testing.assert_allclose(tspmm.spmm(mat, _t(b)).numpy(), want, rtol=1e-5, atol=1e-6)
    # a tiny gather cap streams the edges in many chunks: same result
    monkeypatch.setattr(tspmm, "GATHER_BYTES_CAP", 4096)
    np.testing.assert_allclose(tspmm.spmm(mat, _t(b)).numpy(), want, rtol=1e-5, atol=1e-6)


def test_aggregate_backward_uses_pair_bwd():
    g = sparse.random_graph(200, 4, seed=6)
    a = sparse.normalize(g, axis=True)
    at = sparse.transpose(a)
    pair = tspmm.AggPair(tspmm.COOMat.from_csr(at, device=CPU), tspmm.COOMat.from_csr(a, device=CPU))
    b = torch.randn(200, 6, generator=torch.Generator().manual_seed(0), requires_grad=True)
    gout = torch.randn(200, 6, generator=torch.Generator().manual_seed(1))
    out = tspmm.aggregate(pair, b)
    (gb,) = torch.autograd.grad(out, b, gout)
    np.testing.assert_allclose(out.detach().numpy(), at.to_dense() @ b.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), a.to_dense() @ gout.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((50, 7))).astype(np.float32)
    logits[4] = 0.0  # an all-tie row: argmax takes the first index
    labels = rng.integers(0, 7, 50).astype(np.int32)
    mask = rng.random(50) < 0.4 if masked else None
    want = jsx.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), None if mask is None else jnp.asarray(mask))
    got = sx.softmax_xent(_t(logits), _t(labels), None if mask is None else _t(mask))
    for name in ("loss", "acc", "grad"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-6, atol=1e-8, err_msg=name
        )


def test_softmax_xent_loss_over_all_rows():
    """Unmasked, every row counts, and the clamp keeps log(0) finite."""
    logits = torch.tensor([[0.0, 200.0], [1.0, 0.0]])
    out = sx.softmax_xent(logits, torch.tensor([0, 0]))
    tiny = torch.finfo(torch.float32).tiny
    p1 = torch.softmax(logits[1], 0)[0]
    want = -(np.log(tiny) + torch.log(p1)) / 2
    assert torch.isfinite(out.loss)
    np.testing.assert_allclose(float(out.loss), float(want), rtol=1e-6)
    assert float(out.acc) == 0.5


def _tree(rng, shapes):
    return [{k: rng.standard_normal(s).astype(np.float32) for k, s in layer.items()} for layer in shapes]


SHAPES = [{"W": (5, 4), "b": (1, 4), "Wres": (5, 4), "bres": (1, 4)}, {"W": (4, 3), "b": (1, 3)}]


@pytest.mark.parametrize("step", [0, 6])
def test_adam_update_matches_jax(step):
    rng = np.random.default_rng(step)
    p, g, m = _tree(rng, SHAPES), _tree(rng, SHAPES), _tree(rng, SHAPES)
    v = [{k: np.abs(a) for k, a in layer.items()} for layer in _tree(rng, SHAPES)]
    hp = dict(lr=0.05, beta1=0.8, beta2=0.99, weight_decay=0.01, eps=1e-7)
    to_j = lambda t: [{k: jnp.asarray(a) for k, a in layer.items()} for layer in t]  # noqa: E731
    jp, js = jadam.adam_update(to_j(p), to_j(g), jadam.AdamState(jnp.int32(step), to_j(m), to_j(v)), **hp)
    tp, ts = adam.adam_update(
        convert.params_from_numpy(p, CPU), convert.params_from_numpy(g, CPU),
        convert.adam_state_from_numpy(step, m, v, CPU), **hp,
    )
    assert int(ts.step) == int(js.step) == step + 1
    for want_t, got_t in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        for wl, gl in zip(want_t, got_t):
            for k in wl:
                np.testing.assert_allclose(gl[k].numpy(), np.asarray(wl[k]), rtol=1e-6, atol=1e-7, err_msg=k)


def test_adam_decays_only_w_keys():
    p = [{"W": torch.ones(2, 2), "b": torch.ones(1, 2), "Wres": torch.ones(2, 2), "bres": torch.ones(1, 2)}]
    zero = [{k: torch.zeros_like(v) for k, v in p[0].items()}]
    new, _ = adam.adam_update(p, zero, adam.adam_init(p), weight_decay=0.5)
    assert torch.all(new[0]["W"] < 1) and torch.all(new[0]["Wres"] < 1)
    assert torch.equal(new[0]["b"], p[0]["b"]) and torch.equal(new[0]["bres"], p[0]["bres"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adam_bias_correction_in_param_dtype(dtype):
    """The bias corrections follow the parameters' dtype: float32 ones (the
    JAX package's default, without jax_enable_x64) and float64 ones."""
    p = [{"W": torch.ones(1, 1, dtype=dtype), "b": torch.zeros(1, 1, dtype=dtype)}]
    g = [{"W": torch.full((1, 1), 0.3, dtype=dtype), "b": torch.full((1, 1), 0.3, dtype=dtype)}]
    state = adam.adam_init(p)
    for _ in range(3):
        p, state = adam.adam_update(p, g, state, weight_decay=0.0)
    m, v = torch.zeros((), dtype=dtype), torch.zeros((), dtype=dtype)
    w = torch.ones((), dtype=dtype)
    for t in range(1, 4):
        m = (1.0 - 0.9) * 0.3 + 0.9 * m
        v = (1.0 - 0.999) * 0.3 * 0.3 + 0.999 * v
        tt = torch.tensor(float(t), dtype=dtype)
        w = w - 1e-2 * (m / (1.0 - torch.pow(0.9, tt))) / (torch.sqrt(v / (1.0 - torch.pow(0.999, tt))) + 1e-8)
    assert p[0]["W"].dtype == dtype
    assert float(p[0]["W"]) == float(w)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_sgd_update_matches_jax(wd):
    rng = np.random.default_rng(11)
    p, g = _tree(rng, SHAPES), _tree(rng, SHAPES)
    to_j = lambda t: [{k: jnp.asarray(a) for k, a in layer.items()} for layer in t]  # noqa: E731
    want = jadam.sgd_update(to_j(p), to_j(g), 0.1, wd)
    got = adam.sgd_update(convert.params_from_numpy(p, CPU), convert.params_from_numpy(g, CPU), 0.1, wd)
    for wl, gl in zip(want, got):
        for k in wl:
            np.testing.assert_allclose(gl[k].numpy(), np.asarray(wl[k]), rtol=1e-6, atol=1e-7, err_msg=k)
