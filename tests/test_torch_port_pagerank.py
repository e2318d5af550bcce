"""Port vs JAX package: PageRank (``models/pagerank.py``) — the iteration
matrix in every impl, the stopping rule and its iteration count, the cap at
``max_iters``, the mean-1 rescale, the row-partitioned ``pagerank_dist`` on
4 CPU partitions against the JAX package's on its 8-device CPU mesh, and
the CLI's ``pagerank`` command. The JAX pattern kernel runs in interpret
mode (``tests/test_pagerank.py``'s way); the port's kernels run their plain
versions (the tensors lie on the CPU)."""

import os

import numpy as np
import pytest
import torch

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.formats import read_dense as jread_dense
from mg_gcn_tpu.models import pagerank as jpr
from mg_gcn_tpu.ops import spmm_gather as jsg
from mg_gcn_tpu.ops import spmm_pattern as jsp
from mg_gcn_tpu.parallel import dist as jdist
from mg_gcn_tpu_torch import cli, sparse
from mg_gcn_tpu_torch.formats import CSRData, Dataset, read_dense
from mg_gcn_tpu_torch.models import pagerank as pr
from mg_gcn_tpu_torch.ops import spmm_pattern as sp
from mg_gcn_tpu_torch.ops.spmm import COOMat
from mg_gcn_tpu_torch.ops.spmm_edges import EdgeTileMat
from mg_gcn_tpu_torch.ops.spmm_gather import GatherMat
from mg_gcn_tpu_torch.parallel import dist

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
ENGINE = {"pattern": sp.PatternMat, "edge": EdgeTileMat, "gather": GatherMat, "xla": COOMat}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jsp.pl, "pallas_call", patched)


def _jcsr(g: CSRData) -> JCSRData:
    return JCSRData(g.indptr, g.indices, g.data, g.shape)


def _graph(weighted: bool = False, n: int = 300, seed: int = 13) -> CSRData:
    """A random graph with rows 5..9 emptied (dangling nodes)."""
    g = sparse.random_graph(n, 6, seed=seed, weights="random" if weighted else "ones")
    rows = np.repeat(np.arange(n), np.diff(g.indptr))
    keep = (rows < 5) | (rows > 9)
    indptr = np.r_[0, np.cumsum(np.bincount(rows[keep], minlength=n))].astype(np.int64)
    return CSRData(indptr, g.indices[keep], g.data[keep], g.shape)


def oracle(graph, damping=0.85, eps=1e-4, max_iters=1000):
    """``tests/test_pagerank.py``'s numpy oracle of the reference's loop:
    p' = Mᵀ(d·p + (1-d)·1), M row-stochastic; returns (p, iterations)."""
    m = sparse.normalize(graph, axis=False).to_dense().T
    p = np.ones(graph.nrows, np.float32)
    it = 0
    for it in range(1, max_iters + 1):
        p_new = m @ (damping * p + (1 - damping))
        done = np.max(np.abs(p_new - p)) < eps
        p = p_new
        if done:
            break
    return p * (graph.nrows / p.sum()), it


CASES = [("pattern", False), ("edge", False), ("gather", False), ("gather", True), ("xla", False), ("xla", True),
         ("edge", True)]


@pytest.mark.parametrize("impl,weighted", CASES, ids=lambda c: str(c))
def test_power_iteration_matches_jax(impl, weighted):
    """The iterate and its iteration count against the JAX package's
    ``power_iterate`` on its matrix of the same impl, and the rescaled
    vector against JAX's ``pagerank`` and the numpy oracle."""
    g = _graph(weighted)
    mat = pr._pagerank_mat(g, impl, device="cpu")
    assert isinstance(mat, ENGINE[impl])
    if impl == "gather":  # binary: the w-less walk, pre-scaled by 1/max(outdeg, 1)
        assert mat.has_w == weighted and mat.scale_side == ("none" if weighted else "pre")
    p, iters = pr.power_iterate(mat, g.nrows)
    jp, jiters = jpr.power_iterate(jpr._pagerank_mat(_jcsr(g), impl), g.nrows)
    assert iters == jiters
    np.testing.assert_allclose(p.numpy(), jp, rtol=1e-4, atol=1e-5)
    got = pr.pagerank(g, impl=impl, device="cpu").numpy()
    np.testing.assert_allclose(got, jpr.pagerank(_jcsr(g), impl=impl), rtol=1e-4, atol=1e-5)
    want, oracle_iters = oracle(g)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert iters == oracle_iters


def test_binary_gather_prescale_equals_jax():
    g = _graph()
    mat = pr._pagerank_mat(g, "gather", device="cpu")
    jmat = jpr._pagerank_mat(_jcsr(g), "gather")
    assert isinstance(jmat, jsg.GatherMat) and not jmat.has_w
    np.testing.assert_array_equal(mat.scale.numpy(), np.asarray(jmat.scale)[: g.nrows])
    assert np.all(mat.scale.numpy()[5:10] == 1.0)  # 1 / max(0, 1)


@pytest.mark.parametrize("seed", [2, 11, 15])
def test_iteration_counts_equal_jax_and_the_oracle(seed):
    g = sparse.random_graph(96, 5, seed=seed)
    _, iters = pr.power_iterate(pr._pagerank_mat(g, "xla", device="cpu"), g.nrows)
    _, jiters = jpr.power_iterate(jpr._pagerank_mat(_jcsr(g), "xla"), g.nrows)
    assert iters == jiters == oracle(g)[1]


@pytest.mark.parametrize("max_iters", [0, 1, 5, 8, 11])
def test_cap_at_max_iters(max_iters):
    """A cap below the crossing returns the max_iters-th iterate, also mid
    way through one of the JAX package's 8-iteration chunks."""
    g = _graph()
    p, iters = pr.power_iterate(pr._pagerank_mat(g, "xla", device="cpu"), g.nrows, max_iters=max_iters)
    jp, jiters = jpr.power_iterate(jpr._pagerank_mat(_jcsr(g), "xla"), g.nrows, max_iters=max_iters)
    assert iters == jiters == max_iters
    np.testing.assert_allclose(p.numpy(), jp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pr.pagerank(g, max_iters=max_iters, device="cpu").numpy(),
                               oracle(g, max_iters=max_iters)[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("damping,eps", [(0.85, 1e-4), (0.5, 1e-6), (0.99, 1e-3)])
def test_sum_equals_n(damping, eps):
    g = _graph()
    p = pr.pagerank(g, damping=damping, eps=eps, device="cpu")
    assert p.dtype == torch.float32 and p.shape == (g.nrows,)
    np.testing.assert_allclose(float(p.sum()), g.nrows, rtol=1e-5)
    np.testing.assert_allclose(p.numpy(), jpr.pagerank(_jcsr(g), damping=damping, eps=eps), rtol=1e-4, atol=1e-5)


def test_auto_and_refusals():
    g = _graph()
    assert isinstance(pr._pagerank_mat(g, device="cpu"), COOMat)  # the CPU: COO, as in the JAX package
    with pytest.raises(ValueError, match="unknown PageRank impl"):
        pr._pagerank_mat(g, "block", device="cpu")
    with pytest.raises(ValueError, match="binary"):
        pr._pagerank_mat(_graph(weighted=True), "pattern", device="cpu")


def test_no_coo_fallback(monkeypatch):
    """Where the gather schedule is refused, the JAX package falls back to
    its COO engine (pagerank.py:63-71); the port raises."""

    def refuse(*args, **kw):
        raise ValueError("schedule too large")

    monkeypatch.setattr(jsg, "gather_mat_from_csr", refuse)
    monkeypatch.setattr(pr, "gather_mat_from_csr", refuse)
    g = _graph()
    from mg_gcn_tpu.ops.spmm import COOMat as JCOOMat

    assert isinstance(jpr._pagerank_mat(_jcsr(g), "gather"), JCOOMat)
    with pytest.raises(ValueError, match="schedule too large"):
        pr._pagerank_mat(g, "gather", device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pr.pagerank(_graph())


# ---------------------------------------------------------------------------
# row-partitioned


@pytest.mark.parametrize("strategy", ["ring", "all_gather"])
@pytest.mark.parametrize("weighted", [False, True])
def test_pagerank_dist_matches_jax(strategy, weighted):
    """4 CPU partitions against the JAX package's pagerank_dist on its
    4-device mesh and against the single-device result."""
    g = _graph(weighted, n=320, seed=3)
    ring = dist.make_mesh(4, ["cpu"] * 4)
    got = pr.pagerank_dist(g, ring, strategy=strategy)
    assert got.shape == (320,) and got.dtype == torch.float32
    want = jpr.pagerank_dist(_jcsr(g), jdist.make_mesh(4), strategy=strategy)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), pr.pagerank(g, device="cpu").numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.sum()), 320.0, rtol=1e-5)


@pytest.mark.parametrize("strategy", ["ring", "all_gather"])
def test_dist_iterations_equal_the_single_device_count(strategy):
    """The row-partitioned loop (it = 1 at the first iterate) stops at the
    single-device iterate: the same count, or one apart only where the
    single-device change at the first of the two lies within 2% of eps (the
    ring sums the blocks in another order, which can put a change that sits
    at eps on the other side; here ring's change at 50 is 1.0014e-4 against
    9.918e-5 for one device and all_gather)."""
    g = _graph(n=320, seed=3)
    dmat = pr.dist_pagerank_mat(g, dist.make_mesh(4, ["cpu"] * 4))
    p, iters = pr.power_iterate_dist(dmat, strategy=strategy)
    mat = pr._pagerank_mat(g, "xla", device="cpu")
    single, single_iters = pr.power_iterate(mat, g.nrows)
    assert single_iters == oracle(g)[1]
    if iters != single_iters:
        k = min(iters, single_iters)
        change = float((pr.power_iterate(mat, g.nrows, max_iters=k)[0]
                        - pr.power_iterate(mat, g.nrows, max_iters=k - 1)[0]).abs().max())
        assert abs(iters - single_iters) == 1 and abs(change - 1e-4) < 2e-6, (iters, single_iters, change)
    if strategy == "all_gather":
        assert iters == single_iters
    np.testing.assert_allclose(torch.cat(p).reshape(-1).numpy(), single.numpy(), rtol=1e-4, atol=1e-5)


def test_pagerank_dist_cap_and_divisibility():
    g = _graph(n=320, seed=3)
    ring = dist.make_mesh(4, ["cpu"] * 4)
    for max_iters in (1, 3):  # it starts at 1 with the first iterate
        got = pr.pagerank_dist(g, ring, max_iters=max_iters)
        want = jpr.pagerank_dist(_jcsr(g), jdist.make_mesh(4), max_iters=max_iters)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), oracle(g, max_iters=max_iters)[0], rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        pr.pagerank_dist(_graph(n=322, seed=3), ring)


# ---------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("parts", [1, 4])
def test_cli_pagerank_matches_jax_cli(tmp_path, capsys, parts):
    """``pagerank <dir>`` (and ``-P 4`` on four CPU partitions): the JAX
    CLI's stderr line and a pagerank.bin within rtol 1e-4 / atol 1e-5 of the
    JAX CLI's."""
    ds = Dataset.load(GOLDEN)
    p_args = ["-P", str(parts)] if parts > 1 else []
    out, jout = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    assert cli.main([*p_args, "--device", "cpu", "--save", out, "pagerank", GOLDEN]) == 0
    got = capsys.readouterr().err.splitlines()
    assert jcli.main([*p_args, "--save", jout, "pagerank", GOLDEN]) == 0
    want = capsys.readouterr().err.splitlines()
    assert got[0].split(" seconds=")[0] == want[-2].split(" seconds=")[0] == (
        f"pagerank n={ds.num_nodes} sum={float(ds.num_nodes):.3f}")
    assert got[1] == f"wrote {out}"
    p, jp = read_dense(out), jread_dense(jout)
    assert p.shape == jp.shape == (ds.num_nodes, 1) and p.dtype == np.float32
    np.testing.assert_allclose(p, jp, rtol=1e-4, atol=1e-5)


def test_cli_pagerank_refusals(capsys, monkeypatch):
    assert cli.main(["--device", "cpu", "pagerank"]) == 2
    assert "pagerank requires: <data_dir>" in capsys.readouterr().err
    monkeypatch.delenv("MG_GCN_COORDINATOR", raising=False)
    assert cli.main(["--multihost", "--device", "cpu", "pagerank", GOLDEN]) == 2
    assert "no coordinator: set MG_GCN_COORDINATOR" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["pagerank", GOLDEN]) == 2
    assert "no CUDA device" in capsys.readouterr().err
