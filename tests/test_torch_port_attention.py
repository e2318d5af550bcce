"""Port vs JAX package: the differentiable attention ops
(``ops/edge_attention.py``) — ``sddmm`` and ``spmm_attn`` with their
backward passes, the two-pass ``slot_softmax``, and a graph with a
duplicated edge; then the fused ``edge_softmax`` against the composite it
replaces. The JAX ops run their Pallas kernels in interpret mode
under ``jax.jit``; the port's kernels their plain versions (the tensors lie
on the CPU). Per-entry values are compared in CSR entry order
(``tests/test_torch_port_sddmm.py``'s slot decoder)."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu.models import gat as jgat
from mg_gcn_tpu.ops import edge_attention as jea
from mg_gcn_tpu_torch import convert
from mg_gcn_tpu_torch.formats import CSRData
from mg_gcn_tpu_torch.models import gat
from mg_gcn_tpu_torch.ops import edge_attention as ea
from mg_gcn_tpu_torch.ops import elementwise as ew
from tests.test_torch_port_sddmm import jax_csr, random_csr
from tests.torch_port_slots import csr_to_slots, slots_to_csr_order

# tolerance of each output's scale: float32 1e-5; bfloat16 1e-4 (the same
# bf16-rounded operands and cotangents, float32 sums in another order)
TOL = {"float32": 1e-5, "bfloat16": 1e-4}
N = 160


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def graph_csr(seed=1):
    """A random binary graph with self loops and no duplicate entries."""
    m = random_csr(N, N, 0.05, seed=seed).to_scipy()
    m = (m + sps.identity(N, dtype=np.float32, format="csr")).tocsr()
    m.data[:] = 1.0
    return CSRData(m.indptr.astype(np.int64), m.indices.astype(np.int32), m.data.astype(np.float32), m.shape)


CSR = graph_csr()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def graphs(request):
    dtype = request.param
    return dtype, jea.build_attention_graph(jax_csr(CSR), dtype=dtype), ea.build_attention_graph(CSR, dtype, "cpu")


def scale_close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=tol,
                               atol=tol * float(np.abs(np.asarray(want)).max(initial=0.0)), err_msg=what)


def _torch_vjp(fn, inputs, cot):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    return out.detach().numpy(), [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(cot))]


def test_sddmm_vjp_matches_jax(graphs):
    """Scores, dA = M(g) B and dB = Mᵀ(g) A against ``jax.vjp`` of the JAX
    op, the same cotangent on each entry."""
    dtype, (jmat, jsched), (mat, sched) = graphs
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((N, 8)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal(CSR.nnz).astype(np.float32)

    @jax.jit
    def jvjp(a, b, g):
        out, vjp = jax.vjp(lambda a, b: jea.sddmm(jmat, jsched, a, b), a, b)
        return (out, *vjp(g))

    s_j, da_j, db_j = jvjp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(csr_to_slots(jmat, CSR, g)))
    s, (da, db) = _torch_vjp(lambda a, b: ea.sddmm(mat, sched, a, b), (a, b), g)
    scale_close(s, slots_to_csr_order(jmat, CSR, s_j), TOL[dtype], "scores")
    scale_close(da, da_j, TOL[dtype], "dA")
    scale_close(db, db_j, TOL[dtype], "dB")


def test_spmm_attn_vjp_matches_jax(graphs):
    """C = M(w) B, dw = sddmm(M, g, B) and dB = Mᵀ(w) g against
    ``jax.vjp``."""
    dtype, (jmat, jsched), (mat, sched) = graphs
    rng = np.random.default_rng(3)
    w = rng.standard_normal(CSR.nnz).astype(np.float32)
    b = rng.standard_normal((N, 12)).astype(np.float32)
    g = rng.standard_normal((N, 12)).astype(np.float32)

    @jax.jit
    def jvjp(w, b, g):
        out, vjp = jax.vjp(lambda w, b: jea.spmm_attn(jmat, jsched, w, b), w, b)
        return (out, *vjp(g))

    c_j, dw_j, db_j = jvjp(jnp.asarray(csr_to_slots(jmat, CSR, w)), jnp.asarray(b), jnp.asarray(g))
    c, (dw, db) = _torch_vjp(lambda w, b: ea.spmm_attn(mat, sched, w, b), (w, b), g)
    scale_close(c, c_j, TOL[dtype], "C")
    scale_close(dw, slots_to_csr_order(jmat, CSR, dw_j), TOL[dtype], "dw")
    scale_close(db, db_j, TOL[dtype], "dB")


def test_backward_skips_cotangents_nobody_needs(monkeypatch):
    """An input that needs no gradient costs no kernel: a scores SDDMM
    against a ones column computes dA only (one edge launch, no edge_t)."""
    from mg_gcn_tpu_torch.ops import spmm_edges as se

    mat, sched = ea.build_attention_graph(CSR, "float32", "cpu")
    calls = []
    for name in ("edge_plain", "edge_t_plain"):
        plain = getattr(se, name)
        monkeypatch.setattr(se, name, lambda *x, plain=plain, name=name: calls.append(name) or plain(*x))
    a = torch.ones((N, 1), requires_grad=True)
    ea.sddmm(mat, sched, a, torch.ones((N, 1))).sum().backward()
    assert calls == ["edge_plain"]


def test_slot_softmax_matches_jax_with_underflow_rows():
    """Row 5 sits ~200 below the global max (past the ~165 window: alpha
    underflows toward 0 through the 1e-30 guards, as in JAX), row 7 ~100
    below (inside the window: it still normalizes to 1); float32."""
    jmat, jsched = jea.build_attention_graph(jax_csr(CSR), dtype="float32")
    mat, sched = ea.build_attention_graph(CSR, "float32", "cpu")
    rng = np.random.default_rng(4)
    s = rng.standard_normal(CSR.nnz).astype(np.float32)
    s[0] = 5.0  # the global max
    lo = {5: -200.0, 7: -100.0}
    for r, off in lo.items():
        s[CSR.indptr[r] : CSR.indptr[r + 1]] += off
    want = slots_to_csr_order(
        jmat, CSR, jax.jit(lambda x: jea.slot_softmax(jmat, jsched, x))(jnp.asarray(csr_to_slots(jmat, CSR, s))))
    got = ea.slot_softmax(mat, sched, torch.from_numpy(s)).numpy()
    scale_close(got, want, 1e-5, "alpha")
    row = slice(CSR.indptr[5], CSR.indptr[6])
    np.testing.assert_allclose(got[row], want[row], rtol=1e-4)  # both ~1e-27, the guard's value
    assert 0 < got[row].max() < 1e-20
    sums = np.add.reduceat(got, CSR.indptr[:-1])
    np.testing.assert_allclose(np.delete(sums, 5), 1.0, rtol=1e-5)


def test_duplicate_edge_is_kept_and_gat_forward_matches_jax():
    """A graph whose row 3 lists column 9 twice: the attention graph keeps
    both entries (two scores, two attention weights, as the JAX slots do),
    and a one-layer GAT forward equals JAX's in float32."""
    rows = [list(np.unique(np.r_[r, (r * 7 + np.arange(4)) % 40])) for r in range(40)]
    rows[3] = rows[3] + [9, 9]
    indptr = np.r_[0, np.cumsum([len(c) for c in rows])].astype(np.int64)
    csr = CSRData(indptr, np.concatenate(rows).astype(np.int32), np.ones(indptr[-1], np.float32), (40, 40))
    mat, sched = gat.build_gat_graph(csr, dtype="float32", device="cpu")
    assert mat.nnz == csr.nnz and sched.perm.numel() == csr.nnz
    config = gat.GATConfig(sizes=(6, 5), heads=1)
    jconfig = jgat.GATConfig(sizes=(6, 5), heads=1)
    params = [{k: np.asarray(v) for k, v in layer.items()} for layer in jgat.init_params(jconfig, jax.random.key(1))]
    x = np.random.default_rng(5).standard_normal((40, 6)).astype(np.float32)
    jgraph = jgat.build_gat_graph(jax_csr(csr), dtype="float32")
    want = jax.jit(lambda p, x: jgat.forward(p, jgraph, x, jconfig))(params, jnp.asarray(x))
    got = gat.forward(convert.params_from_numpy(params, "cpu"), (mat, sched), torch.from_numpy(x), config)
    scale_close(got.detach().numpy(), want, 1e-5, "logits")


def test_attention_ops_refuse_int8():
    mat, sched = ea.build_attention_graph(CSR, "int8", "cpu")
    with pytest.raises(ValueError, match="dynamic entry weights"):
        ea.spmm_attn(mat, sched, torch.ones(CSR.nnz), torch.ones((N, 2)))


# ---------------------------------------------------------------------------
# the fused edge softmax (ops/edge_softmax.py) against the composite it
# replaces: sddmm -> leaky_relu -> + bias -> slot_softmax, under autograd


def softmax_csr():
    """64 nodes, self loops and 4 more columns a row, except: row 0 holds
    one entry, rows 20..24 none, row 3 lists column 9 twice and row 11 every
    column (64 entries: two a lane of the row walk)."""
    n = 64
    rows = [list(np.unique(np.r_[r, (r * 7 + np.arange(1, 5)) % n])) for r in range(n)]
    rows[0] = [0]
    for r in range(20, 25):
        rows[r] = []
    rows[3] = rows[3] + [9, 9]
    rows[11] = list(range(n))
    indptr = np.r_[0, np.cumsum([len(c) for c in rows])].astype(np.int64)
    w = np.random.default_rng(8).random(indptr[-1]).astype(np.float32) + 0.25
    w[5] = 1e-30  # log w = -69, clamped to -30 by the bias
    return CSRData(indptr, np.concatenate(rows).astype(np.int32), w, (n, n))


def _composite(mat, sched, e_dst, e_src, slope, bias=None):
    ones_dst, ones_src = torch.ones((mat.n_out, 1)), torch.ones((mat.n_in, 1))
    s = ea.sddmm(mat, sched, torch.cat([e_dst, ones_dst], dim=1), torch.cat([ones_src, e_src], dim=1))
    s = ew.leaky_relu(s, slope)
    return ea.slot_softmax(mat, sched, s if bias is None else s + bias)


def _softmax_vjp(fn, mat, sched, e_dst, e_src, cot, bias=None):
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (e_dst, e_src)]
    alpha = fn(mat, sched, *leaves, 0.2, bias)
    return alpha.detach().numpy(), [g.numpy() for g in torch.autograd.grad(alpha, leaves, torch.from_numpy(cot))]


@pytest.mark.parametrize("weighted", [False, True], ids=["binary", "edge-weighted"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_softmax_matches_the_composite(dtype, weighted):
    """alpha and the gradients of e_dst and e_src against the composite's
    autograd, on a graph with a one-entry row, empty rows, a duplicated
    edge and a 64-entry row; row 5 sits ~200 below the global max (past the
    ~165 window: it underflows toward 0 through the 1e-30 guards in both),
    row 7 ~100 below (inside it: in float32 it still sums to 1). The same
    rounded inputs, rounding points and, on the CPU, row sums in entry
    order: the same bits."""
    from mg_gcn_tpu_torch.models.gat import _log_weight_bias

    csr = softmax_csr()
    mat, sched = ea.build_attention_graph(csr, dtype, "cpu")
    rng = np.random.default_rng(9)
    e_dst, e_src = (2 * rng.standard_normal((64, 1)).astype(np.float32) for _ in range(2))
    e_dst[5], e_dst[7] = -1000.0, -500.0  # scores ~-200 and ~-100 after the LeakyReLU's 0.2
    cot = rng.standard_normal(csr.nnz).astype(np.float32)
    bias = _log_weight_bias(mat) if weighted else None
    want, (dd_want, ds_want) = _softmax_vjp(_composite, mat, sched, e_dst, e_src, cot, bias)
    got, (dd, ds) = _softmax_vjp(ea.edge_softmax, mat, sched, e_dst, e_src, cot, bias)
    for what, x, y in (("alpha", got, want), ("de_dst", dd, dd_want), ("de_src", ds, ds_want)):
        assert np.array_equal(x.view(np.int32), y.view(np.int32)), what
    row5 = slice(csr.indptr[5], csr.indptr[6])
    np.testing.assert_allclose(got[row5], want[row5], rtol=1e-4)
    assert 0 < got[row5].max() < 1e-20
    if dtype == "float32":  # bf16 shifts move a row's sum by up to half an ulp of its log
        sums = np.add.reduceat(got, csr.indptr[:-1])[np.diff(csr.indptr) > 0]
        np.testing.assert_allclose(np.delete(sums, 5), 1.0, rtol=1e-5)
    assert not dd[20:25].any()


def test_walk_row_sums_follow_the_row_walk_order():
    """Bit for bit a scalar float32 walk of the kernels' order: lane l sums
    a row's entries l, l + 32, ... in order, then lanes l and l ^ 1 meet,
    then pairs of pairs; rows of 0, 1, 31, 32, 33, 100 and 1,000 entries of
    values over 12 orders of magnitude, where the order shows."""
    from mg_gcn_tpu_torch.ops.edge_softmax import walk_row_sums

    lengths = [0, 1, 31, 32, 33, 100, 1000]
    indptr = np.r_[0, np.cumsum(lengths)].astype(np.int64)
    rng = np.random.default_rng(10)
    v = (rng.standard_normal(indptr[-1]) * 10.0 ** rng.integers(-6, 6, indptr[-1])).astype(np.float32)
    want = []
    for r in range(len(lengths)):
        lane = [np.float32(0)] * 32
        for k, x in enumerate(v[indptr[r] : indptr[r + 1]]):
            lane[k % 32] = np.float32(lane[k % 32] + x)
        for off in (1, 2, 4, 8, 16):
            lane = [np.float32(lane[i] + lane[i ^ off]) for i in range(32)]
        want.append(lane[0])
    got = walk_row_sums(torch.from_numpy(indptr), torch.from_numpy(v)).numpy()
    assert np.array_equal(got.view(np.int32), np.asarray(want, np.float32).view(np.int32))


@pytest.mark.parametrize("wants", [(True, False), (False, True), (True, True)], ids=["e_dst", "e_src", "both"])
def test_edge_softmax_backward_computes_only_what_is_needed(monkeypatch, wants):
    """The backward walk runs once whichever gradient is asked for; the
    transposed product (the column sums into e_src) only when e_src's is,
    and a gradient nobody needs comes back None."""
    from mg_gcn_tpu_torch.ops import spmm_edges as se

    mat, sched = ea.build_attention_graph(softmax_csr(), "bfloat16", "cpu")
    calls = []
    monkeypatch.setattr(ea, "softmax_bwd", lambda *x, f=ea.softmax_bwd: calls.append("softmax_bwd") or f(*x))
    monkeypatch.setattr(se, "edge_t_plain", lambda *x, f=se.edge_t_plain: calls.append("edge_t") or f(*x))
    leaves = [torch.randn((64, 1), requires_grad=w) for w in wants]
    alpha = ea.edge_softmax(mat, sched, *leaves, 0.2)
    alpha.backward(torch.ones_like(alpha))
    assert calls == ["softmax_bwd"] + (["edge_t"] if wants[1] else [])
    assert [leaf.grad is not None for leaf in leaves] == list(wants)


def test_edge_softmax_refuses_int8():
    mat, sched = ea.build_attention_graph(CSR, "int8", "cpu")
    with pytest.raises(ValueError, match="dynamic entry weights"):
        ea.edge_softmax(mat, sched, torch.ones((N, 1)), torch.ones((N, 1)), 0.2)
