"""Port vs JAX package: the differentiable attention ops
(``ops/edge_attention.py``) — ``sddmm`` and ``spmm_attn`` with their
backward passes, the two-pass ``slot_softmax``, and a graph with a
duplicated edge. The JAX ops run their Pallas kernels in interpret mode
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
