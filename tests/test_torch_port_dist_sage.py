"""Port vs JAX package: GraphSAGE's row-partitioned step
(``parallel/dist.py``: ``make_dist_sage_train_step``) on P partitions on the
CPU — three Adam steps on each pair kind (COO ring and all_gather, halo,
serial-gather ring, halo on the serial-gather engine) against the JAX
package's ``make_dist_sage_train_step`` (its gather kernel in interpret
mode), the step's gradients against the one-card SAGE step, and the CLI's
``--model sage -P N -R 1``."""

import os

import numpy as np
import pytest
import torch

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu.models import sage as jsage
from mg_gcn_tpu.parallel import dist as jdist
from mg_gcn_tpu.parallel import dist_halo as jhalo
from mg_gcn_tpu_torch import cli, sparse
from mg_gcn_tpu_torch.models import sage
from mg_gcn_tpu_torch.parallel import dist
from tests.torch_port_dist_cases import (
    assert_steps_close, banded_weighted, cpu_ring, features, jax_steps, jcsr, port_steps, weighted_graph,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
SIZES = (6, 8, 3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pairs(m, m_t, parts, kind, ring=None):
    """The (M, Mᵀ) pair of ``kind``: the port's on ``ring``, else the JAX
    package's over ``parts`` devices."""
    if ring is None:
        m, m_t = jcsr(m), jcsr(m_t)
        if kind == "coo":
            return jdist.DistAggPair.from_csr_pair(m, m_t, parts)
        if kind == "gather":
            return jdist.DistGatherPair.from_csr_pair(m, m_t, parts)
        return jhalo.DistHaloPair.from_csr_pair(m, m_t, parts, engine="gather" if kind == "halo_gather" else "xla")
    return dist.build_pair(kind, m, m_t, ring)


@pytest.mark.parametrize(
    "kind,strategy,parts,mask",
    [("coo", "ring", 3, False), ("coo", "all_gather", 4, True), ("halo", "ring", 4, True), ("halo", "ring", 3, False),
     ("gather", "ring", 3, False), ("halo_gather", "ring", 3, True)],
)
def test_three_sage_steps_match_jax(kind, strategy, parts, mask):
    """Three steps from the seed-99 init on a non-symmetric weighted graph:
    losses at rtol 1e-5, accuracy within a node, the last parameters at
    rtol 1e-5 / atol 1e-6; every parameter (Wself, Wneigh, b) moves."""
    n = 80 * parts
    g = weighted_graph(n, 5, seed=31)
    x, y, train = features(n, SIZES[0], SIZES[-1], seed=9, mask=mask)
    m = sparse.normalize(g, axis=False)
    m_t = sparse.transpose(m)
    jconfig = jsage.SAGEConfig(sizes=SIZES, loss_mask="train" if mask else "all")
    mesh = jdist.make_mesh(parts)
    params = jsage.init_params(jconfig)
    jstep = jdist.make_dist_sage_train_step(jconfig, mesh, n, strategy=strategy, use_mask=mask, pair_kind=kind)
    want = jax_steps(jstep, mesh, params, _pairs(m, m_t, parts, kind), x, y, train, 3)
    ring = cpu_ring(parts)
    step = dist.make_dist_sage_train_step(sage.SAGEConfig(sizes=SIZES), ring, n, strategy=strategy, pair_kind=kind)
    start = [{k: np.asarray(v) for k, v in la.items()} for la in params]
    got = port_steps(step, ring, start, _pairs(m, m_t, parts, kind, ring), x, y, train, 3)
    assert_steps_close(got, want, int(train.sum()) if mask else n, 1e-5, 1e-6)
    assert all(not np.array_equal(got[-1][0][i][k], start[i][k]) for i in range(2) for k in start[i])


@pytest.mark.parametrize("kind", ["coo", "halo", "gather", "halo_gather"])
def test_dist_sage_gradients_equal_the_single_card_step(kind):
    """``dist_sage_loss_and_grad`` at P = 4 on a banded graph (empty halo
    rounds and ring blocks) against ``models.sage.loss_and_grad`` on one
    device with the COO pair: loss at rtol 1e-5, each gradient leaf within
    1e-5 of its norm."""
    parts, n = 4, 480
    g = banded_weighted(n, parts, seed=32)
    x, y, _ = features(n, SIZES[0], SIZES[-1], seed=10)
    config = sage.SAGEConfig(sizes=SIZES)
    params = sage.init_params(config, device="cpu")
    loss, acc, grads = sage.loss_and_grad(params, sage.build_sage_pair(g, impl="xla", device="cpu"),
                                          torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), config)
    m = sparse.normalize(g, axis=False)
    ring = cpu_ring(parts)
    pair = _pairs(m, sparse.transpose(m), parts, kind, ring)
    dloss, dacc, dgrads = dist.dist_sage_loss_and_grad([params] * parts, dist.sage_aggregation(kind, pair),
                                                        dist.shard(x, ring), dist.shard(y.astype(np.int64), ring),
                                                        config, n)
    np.testing.assert_allclose(float(dloss), float(loss), rtol=1e-5)
    assert float(dacc) == float(acc)
    for layer, ref in zip(dgrads, grads):
        for k in ref:
            assert float(torch.linalg.vector_norm(layer[k] - ref[k])) <= 1e-5 * float(torch.linalg.vector_norm(ref[k]))


def test_sage_step_refusals_match_jax():
    ring, mesh = cpu_ring(2), jdist.make_mesh(2)
    config, jconfig = sage.SAGEConfig(sizes=SIZES), jsage.SAGEConfig(sizes=SIZES)
    for kind, strategy in (("halo", "all_gather"), ("gather", "all_gather"), ("halo_gather", "all_gather"),
                           ("pattern", "ring")):
        with pytest.raises(ValueError) as got:
            dist.make_dist_sage_train_step(config, ring, 10, strategy=strategy, pair_kind=kind)
        with pytest.raises(ValueError) as want:
            jdist.make_dist_sage_train_step(jconfig, mesh, 10, strategy=strategy, pair_kind=kind)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the CLI


def _epochs(err: str) -> list:
    return [line.split() for line in err.splitlines() if line[:1].isdigit() and len(line.split()) == 4]


@pytest.mark.parametrize(
    "parts,impl,jax_impl,extra",
    [(2, "halo", "halo", []), (4, "auto", "auto", ["--mask-train"]), (2, "xla", "xla", ["-S"]),
     (4, "gather", "xla", []), (2, "halo", "halo", ["--save", "{ck}"])],
)
def test_cli_dist_sage_matches_jax_cli(tmp_path, capsys, parts, impl, jax_impl, extra):
    """``--model sage -P N -R 1`` trains (no longer a later slice): the JAX
    CLI's lines and losses at rtol 1e-5 (``--impl gather`` against its COO
    run); a checkpoint equal to JAX's at rtol 1e-5 / atol 1e-6."""
    extra = [e.replace("{ck}", str(tmp_path / "ck.npz")) for e in extra]
    args = ["-P", str(parts), "-R", "1", "-E", "3", "--model", "sage", *extra, "train", GOLDEN, "1", "8"]
    assert cli.main(["--device", "cpu", "--impl", impl, "--csv-dir", str(tmp_path / "p"), *args]) == 0
    got = capsys.readouterr().err
    if "--save" in extra:
        ported = dict(np.load(tmp_path / "ck.npz"))
    assert jcli.main(["--impl", jax_impl, "--csv-dir", str(tmp_path / "j"), *args]) == 0
    want = capsys.readouterr().err
    assert [line for line in got.splitlines() if not line[:1].isdigit()] == [
        line for line in want.splitlines() if not line[:1].isdigit()]
    ge, we = _epochs(got), _epochs(want)
    assert [e[0] for e in ge] == ["0", "1", "2"] == [e[0] for e in we]
    np.testing.assert_allclose([float(e[1]) for e in ge], [float(e[1]) for e in we], rtol=1e-5)
    if "--save" in extra:
        jax_ck = dict(np.load(tmp_path / "ck.npz"))
        assert sorted(ported) == sorted(jax_ck)
        for k in jax_ck:
            np.testing.assert_allclose(ported[k], jax_ck[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize(
    "args",
    [
        ["-P", "2", "-R", "1", "--optimizer", "sgd"],
        ["-P", "3", "-R", "1"],
        ["-P", "2", "-R", "1", "--impl", "gather", "-S"],
    ],
    ids=lambda a: " ".join(a),
)
def test_cli_dist_sage_refusals_match_jax(tmp_path, capsys, args):
    """Each exits 2 with the JAX CLI's message."""
    P = int(args[args.index("-P") + 1])
    argv = ["-E", "1", "--model", "sage", "--csv-dir", str(tmp_path), *args, "train", GOLDEN, "1", "8"]
    assert cli.main(["--device", ",".join(["cpu"] * P), *argv]) == 2
    got = capsys.readouterr().err.splitlines()[-1]
    assert jcli.main(argv) == 2
    assert got == capsys.readouterr().err.splitlines()[-1]


def test_cli_dist_sage_halo_takes_the_ring_only(tmp_path, capsys):
    """``--impl halo -S``: the JAX CLI raises from its step with the message
    the port exits 2 with."""
    argv = ["-P", "2", "-R", "1", "-E", "1", "-S", "--model", "sage", "--impl", "halo", "--csv-dir", str(tmp_path),
            "train", GOLDEN, "1", "8"]
    assert cli.main(["--device", "cpu,cpu", *argv]) == 2
    got = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(ValueError) as want:
        jcli.main(argv)
    assert got == str(want.value)
