"""Port vs dense oracles and the JAX package: the ring pattern pair
(``ops/spmm_pattern_ring.py``) through ``parallel.dist.dist_aggregate_pattern``
with each exchange strategy, on P partitions on the CPU (the kernels' plain
versions, chosen because the tensors lie on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mg_gcn_tpu import sparse as jsparse
from mg_gcn_tpu.parallel import dist as jdist
from mg_gcn_tpu_torch import sparse
from mg_gcn_tpu_torch.ops import spmm_pattern as sp
from mg_gcn_tpu_torch.ops import spmm_pattern_ring as ring
from mg_gcn_tpu_torch.parallel import dist

STRATEGIES = ("ring", "all_gather", "fused")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(n, parts, dtype="float32"):
    g = sparse.random_graph(n, 4, seed=21, weights="ones")
    mesh = dist.make_mesh(parts, ["cpu"] * parts)
    pair = dist.DistPatternPair.from_binary_csr(g, mesh, dtype=dtype)
    a_hat = sparse.normalize(g, axis=True).to_scipy().toarray()
    return g, mesh, pair, a_hat


def _operand(pair, d, seed, normal=False):
    rng = np.random.default_rng(seed)
    h = np.zeros((pair.n_pad, d), np.float32)
    h[: pair.n] = rng.standard_normal((pair.n, d)) if normal else rng.random((pair.n, d))
    return h


def _agg(pair, mesh, h, orientation, strategy, dtype=None):
    return torch.cat(dist.dist_aggregate_pattern(pair, dist.shard(h, mesh), orientation, dtype, strategy)).numpy()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("n,parts", [(5000, 2), (6000, 4)])
@pytest.mark.parametrize("orientation", ["PT", "P"])
def test_dist_pattern_matches_dense_oracle(orientation, n, parts, strategy):
    """Âᵀh (forward) and Âh (backward) within rtol 1e-5 / atol 1e-5 in
    float32, the JAX package's tolerances (test_dist_pattern.py:62-84);
    padded rows exactly 0."""
    g, mesh, pair, a_hat = _setup(n, parts)
    h = _operand(pair, 8, seed=0 if orientation == "PT" else 1)
    got = _agg(pair, mesh, h, orientation, strategy)
    want = (a_hat.T if orientation == "PT" else a_hat) @ h[:n]
    np.testing.assert_allclose(got[:n], want, rtol=1e-5, atol=1e-5)
    assert np.abs(got[n:]).max() == 0


@pytest.mark.parametrize("orientation", ["PT", "P"])
def test_dist_pattern_int8_matches_single_card(orientation):
    """int8 with one global per-feature scale quantizes as the port's
    single-card int8 ``spmm_pattern`` does (test_dist_pattern.py:87-104)."""
    n = 5000
    g, mesh, pair, _ = _setup(n, 2, dtype="int8")
    h = _operand(pair, 8, seed=2, normal=True)
    got = _agg(pair, mesh, h, orientation, "ring")
    fwd1, bwd1 = sp.pattern_pair_from_binary_csr(g, dtype="int8", device="cpu")
    single = sp.spmm_pattern(fwd1 if orientation == "PT" else bwd1, torch.from_numpy(h[:n])).numpy()
    np.testing.assert_allclose(got[:n], single, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("orientation", ["PT", "P"])
def test_strategies_equal_in_int8(orientation, parts):
    """int32 sums are exact in any order: the three exchanges agree bit for bit."""
    _, mesh, pair, _ = _setup(6000, parts, dtype="int8")
    h = _operand(pair, 41, seed=3, normal=True)
    outs = [_agg(pair, mesh, h, orientation, s) for s in STRATEGIES]
    assert all(np.array_equal(outs[0], o) for o in outs[1:])


def test_strategies_close_in_bfloat16():
    _, mesh, pair, _ = _setup(5000, 4, dtype="bfloat16")
    h = _operand(pair, 16, seed=4)
    for orientation in ("PT", "P"):
        outs = [_agg(pair, mesh, h, orientation, s) for s in STRATEGIES]
        for o in outs[1:]:
            np.testing.assert_allclose(o, outs[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_ring_plain_is_the_sum_of_the_round_products(which):
    """The ring wrapper on CPU tensors is the sum over rounds of the
    single-pack products, counts no launch, and int8 sums in int32."""
    _, _, pair, _ = _setup(6000, 4)
    packs = pair.pack_fwd if which == "fwd" else pair.pack_bwd
    one = sp.pattern_fwd_plain if which == "fwd" else sp.pattern_bwd_plain
    fn = ring.ring_pattern_fwd if which == "fwd" else ring.ring_pattern_bwd
    rng = np.random.default_rng(5)
    slots = torch.from_numpy(rng.integers(-127, 128, (4, pair.m_loc, 16)).astype(np.int8))
    before = dict(fn.launches)
    got = fn(packs[1], slots)
    want = sum(one(packs[1][s], slots[s]).long() for s in range(4))
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)
    assert dict(fn.launches) == before
    f = torch.from_numpy(rng.standard_normal((4, pair.m_loc, 16)).astype(np.float32))
    exact = (ring.ring_pattern_fwd_plain if which == "fwd" else ring.ring_pattern_bwd_plain)(packs[1], f, torch.float64)
    torch.testing.assert_close(fn(packs[1], f).double(), exact, rtol=1e-5, atol=1e-5)


def test_fused_p1_runs_one_round():
    """At P = 1 the fused exchange runs the ring kernel with one round (the
    JAX package swaps to its ring strategy there): the single-card product."""
    g, mesh, pair, a_hat = _setup(5000, 1)
    h = _operand(pair, 8, seed=6)
    for orientation, a in (("PT", a_hat.T), ("P", a_hat)):
        np.testing.assert_allclose(_agg(pair, mesh, h, orientation, "fused")[:5000], a @ h[:5000], rtol=1e-5,
                                   atol=1e-5)


def test_unknown_strategy_rejected():
    _, mesh, pair, _ = _setup(5000, 2)
    with pytest.raises(ValueError, match="unknown dist spmm strategy"):
        dist.dist_aggregate_pattern(pair, dist.shard(np.zeros((pair.n_pad, 8), np.float32), mesh), "PT",
                                    strategy="bogus")


@pytest.mark.parametrize("orientation", ["PT", "P"])
def test_fused_matches_jax_fused_interpret(orientation):
    """Against the JAX package's fused RDMA-ring kernel under the TPU
    interpreter on the 2-device CPU mesh (run as tests/test_pattern_ring.py
    runs it), P = 2, d = 8, float32."""
    n, parts, d = 5000, 2, 8
    jg = jsparse.random_graph(n, 4, seed=21, weights="ones")
    jpair = jdist.DistPatternPair.from_binary_csr(jg, parts, dtype="float32")
    _, mesh, pair, _ = _setup(n, parts)
    h = _operand(pair, d, seed=7)
    spec = jax.sharding.PartitionSpec(jdist.GRAPH_AXIS)

    def body(pf, pb, sc, hh):
        pack = pf[0] if orientation == "PT" else pb[0]
        return jdist.dist_aggregate_pattern(pack, sc[0], hh, parts, orientation, "float32", "fused", interpret=True)

    f = jax.jit(jax.shard_map(body, mesh=jdist.make_mesh(parts), in_specs=(spec,) * 4, out_specs=spec,
                              check_vma=False))
    want = np.asarray(f(jpair.pack_fwd, jpair.pack_bwd, jpair.scale, jnp.asarray(h)))
    got = _agg(pair, mesh, h, orientation, "fused")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
