"""Port vs JAX package: the row partition on the serial-gather kernel
(``parallel/dist.py``: ``DistGatherMat``, ``DistGatherPair``,
``dist_aggregate_gather``) on P partitions on the CPU — the blocks in the
ring order of ``DistRowMat``, the ring product against JAX's (its gather
kernel in interpret mode) and the dense product (a banded graph with empty
blocks included), three GCN steps in parity and exact modes, and the CLI's
``--impl gather -P N -R 1``. The port's gather kernel runs its plain version
(the tensors lie on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu import sparse as jsparse
from mg_gcn_tpu.models import gcn as jgcn
from mg_gcn_tpu.parallel import dist as jdist
from mg_gcn_tpu_torch import cli, sparse
from mg_gcn_tpu_torch.models.gcn import GCNConfig
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.parallel import dist
from tests.torch_port_dist_cases import (
    assert_steps_close, banded_weighted, cpu_ring, expand_rows, features, jax_steps, jcsr, port_steps, weighted_graph,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
SPEC = jax.sharding.PartitionSpec(jdist.GRAPH_AXIS)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kind,parts", [("weighted", 3), ("weighted", 4), ("banded", 4)])
def test_gather_blocks_take_the_ring_order(kind, parts):
    """blocks[j][s] holds block A[j, (j+s) % P]: the entries of the JAX
    package's ``partition_blocks`` there, and of the port's COO ring
    (``DistRowMat``) round s, as a weighted CSR block of m_loc × m_loc."""
    n = 120 * parts
    g = weighted_graph(n, 6, seed=21) if kind == "weighted" else banded_weighted(n, parts, seed=22)
    a = sparse.normalize(g, axis=True)
    ring = cpu_ring(parts)
    got = dist.DistGatherMat.from_csr(a, ring)
    coo = dist.DistRowMat.from_csr(a, ring)
    part = jsparse.uniform_partition(n, parts)
    want = jsparse.partition_blocks(jcsr(a), part, part)
    m = n // parts
    assert (got.n, got.parts, got.nnz, got.rows_per_shard) == (n, parts, a.nnz, m)
    empty = 0
    for j in range(parts):
        for s in range(parts):
            blk, jb = got.blocks[j][s], want[j][(j + s) % parts]
            assert (blk.n_out, blk.n_in, blk.nnz) == (m, m, jb.nnz) and blk.w is not None
            assert np.array_equal(blk.indptr.numpy(), jb.indptr) and np.array_equal(blk.indices.numpy(), jb.indices)
            assert np.array_equal(blk.w.numpy(), jb.data)
            e = jb.nnz
            assert np.array_equal(expand_rows(blk.indptr), coo.rows[j][s][:e].numpy())
            assert np.array_equal(blk.indices.numpy(), coo.cols[j][s][:e].numpy())
            assert np.array_equal(blk.w.numpy(), coo.vals[j][s][:e].numpy())
            empty += e == 0
    assert empty == (6 if kind == "banded" else 0)  # A[j, k] with |j - k| >= 2


@pytest.mark.parametrize("kind,parts", [("weighted", 2), ("weighted", 4), ("banded", 4)])
def test_dist_aggregate_gather_is_the_dense_product(kind, parts):
    n = 120 * parts
    g = weighted_graph(n, 6, seed=23) if kind == "weighted" else banded_weighted(n, parts, seed=24)
    a = sparse.normalize(g, axis=True)
    h = np.random.default_rng(5).standard_normal((n, 10)).astype(np.float32)
    ring = cpu_ring(parts)
    got = torch.cat(dist.dist_aggregate_gather(dist.DistGatherMat.from_csr(a, ring), dist.shard(h, ring)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), a.to_scipy().toarray() @ h, rtol=1e-5, atol=1e-6)


def test_dist_aggregate_gather_matches_jax():
    """Against JAX's ``dist_aggregate_gather`` (the gather kernel in
    interpret mode) inside shard_map at P = 3, rtol 1e-5 / atol 1e-6."""
    parts, n = 3, 360
    a = sparse.normalize(weighted_graph(n, 6, seed=25), axis=True)
    h = np.random.default_rng(6).standard_normal((n, 12)).astype(np.float32)
    ring = cpu_ring(parts)
    got = torch.cat(dist.dist_aggregate_gather(dist.DistGatherMat.from_csr(a, ring), dist.shard(h, ring)))
    jmat = jdist.DistGatherMat.from_csr(jcsr(a), parts)

    def body(idx, w, meta, meta2, hl):
        return jdist.dist_aggregate_gather(dict(idx=idx[0], w=w[0], meta=meta[0], meta2=meta2[0]), hl, parts)

    f = jax.jit(jax.shard_map(body, mesh=jdist.make_mesh(parts), in_specs=(SPEC,) * 5, out_specs=SPEC,
                              check_vma=False))
    want = np.asarray(f(jmat.idx, jmat.w, jmat.meta, jmat.meta2, jnp.asarray(h)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


SIZES = (6, 8, 8, 3)


@pytest.mark.parametrize("parity", [True, False])
def test_three_steps_match_jax(parity):
    """Three GCN steps on the gather pair against the JAX package's
    ``make_dist_train_step(pair_kind="gather")`` (interpret mode) at P = 3:
    losses at rtol 1e-5, accuracy within a node, the last parameters at
    rtol 1e-5 / atol 1e-6 (exact mode with Adam eps = 1)."""
    parts, n = 3, 240
    g = weighted_graph(n, 5, seed=26)
    x, y, _ = features(n, SIZES[0], SIZES[-1], seed=7)
    a = sparse.normalize(g, axis=True)
    hp = dict(adam.DEFAULT_HPARAMS, **({} if parity else dict(eps=1.0)))
    jconfig = jgcn.GCNConfig(sizes=SIZES, parity=parity)
    mesh = jdist.make_mesh(parts)
    params = jgcn.init_params(jconfig)
    jstep = jdist.make_dist_train_step(jconfig, mesh, n, hp, pair_kind="gather")
    want = jax_steps(jstep, mesh, params, jdist.DistGatherPair.from_csr_pair(jcsr(sparse.transpose(a)), jcsr(a), parts),
                     x, y, None, 3)
    ring = cpu_ring(parts)
    step = dist.make_dist_train_step(GCNConfig(sizes=SIZES, parity=parity), ring, n, hp, pair_kind="gather")
    got = port_steps(step, ring, [{k: np.asarray(v) for k, v in la.items()} for la in params],
                     dist.DistGatherPair.from_csr_pair(sparse.transpose(a), a, ring), x, y, None, 3)
    assert_steps_close(got, want, n, 1e-5, 1e-6)


def test_gather_steps_equal_the_coo_ring_steps():
    """On a banded graph with empty blocks and a train mask, two steps on
    the gather pair at P = 4 follow the port's COO ring steps."""
    parts, n = 4, 480
    g = banded_weighted(n, parts, seed=27)
    x, y, train = features(n, SIZES[0], SIZES[-1], seed=8, mask=True)
    a = sparse.normalize(g, axis=True)
    ring = cpu_ring(parts)
    params = [{k: np.asarray(v) for k, v in la.items()} for la in jgcn.init_params(jgcn.GCNConfig(sizes=SIZES))]
    config = GCNConfig(sizes=SIZES)
    runs = [port_steps(dist.make_dist_train_step(config, ring, n, pair_kind=kind), ring, params, pair, x, y, train, 2)
            for kind, pair in (("gather", dist.DistGatherPair.from_csr_pair(sparse.transpose(a), a, ring)),
                               ("coo", dist.DistAggPair.from_csr_pair(sparse.transpose(a), a, ring)))]
    assert_steps_close(runs[0], runs[1], int(train.sum()), 1e-5, 1e-6)


def _epochs(err: str) -> list:
    return [line.split() for line in err.splitlines() if line[:1].isdigit() and len(line.split()) == 4]


@pytest.mark.parametrize("parts,jax_impl", [(2, "gather"), (4, "xla")])
def test_cli_gather_matches_jax_cli(tmp_path, capsys, parts, jax_impl):
    """``--impl gather -P N -R 1`` trains (no longer a later slice): the JAX
    CLI's lines and losses at rtol 1e-5, against its ``--impl gather`` run
    (interpret mode) at P = 2 and its COO run at P = 4."""
    args = ["-P", str(parts), "-R", "1", "-E", "2", "train", GOLDEN, "1", "8"]
    assert cli.main(["--device", "cpu", "--impl", "gather", "--csv-dir", str(tmp_path / "p"), *args]) == 0
    got = capsys.readouterr().err
    assert jcli.main(["--impl", jax_impl, "--csv-dir", str(tmp_path / "j"), *args]) == 0
    want = capsys.readouterr().err
    assert [line for line in got.splitlines() if not line[:1].isdigit()] == [
        line for line in want.splitlines() if not line[:1].isdigit()]
    ge, we = _epochs(got), _epochs(want)
    assert [e[0] for e in ge] == ["0", "1"] == [e[0] for e in we]
    np.testing.assert_allclose([float(e[1]) for e in ge], [float(e[1]) for e in we], rtol=1e-5)


@pytest.mark.parametrize("extra", [["-S"], ["--exchange", "all_gather"], ["--exchange", "fused"]],
                         ids=lambda a: " ".join(a))
def test_cli_gather_takes_the_ring_only(tmp_path, capsys, extra):
    """``--impl gather`` with ``-S`` or another exchange exits 2 with the
    JAX CLI's message."""
    args = ["-P", "2", "-R", "1", "-E", "1", "--impl", "gather", *extra, "--csv-dir", str(tmp_path), "train", GOLDEN,
            "1", "8"]
    assert cli.main(["--device", "cpu", *args]) == 2
    got = capsys.readouterr().err.splitlines()[-1]
    assert jcli.main(args) == 2
    want = capsys.readouterr().err.splitlines()[-1]
    assert got == want == "--impl gather uses the ring exchange; drop -S / --exchange"
