"""Port vs JAX package: the distributed GAT (``parallel/dist_gat.py``, the
CLI's ``--model gat -P N -R 1``) on P partitions on the CPU.

The JAX distributed GAT step runs its Pallas kernels in interpret mode and
takes over a minute a step here, so it runs once (a module-scoped fixture:
P = 2, one head, SGD at lr 1 without decay, so that p − p′ is the
gradient). Everything else is held against the port's one-card GAT step,
which ``tests/test_torch_port_gat.py`` holds against the JAX package:
P = 2 and 4, one and two heads, float32 and bfloat16, the masked loss, SGD,
three Adam steps, a banded graph whose far blocks are empty, and a graph
whose every edge crosses partitions (the ring hops must carry gradient).
Random per-head parameters come in through ``convert``: under the seed-99
init both heads get the same ``W``, which would hide a head-slicing fault.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu.models import gat as jgat
from mg_gcn_tpu.nn import adam as jadam
from mg_gcn_tpu.parallel import dist as jdist
from mg_gcn_tpu.parallel import dist_gat as jdist_gat
from mg_gcn_tpu_torch import cli, convert, sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.checkpoint import load_checkpoint
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.models import gat
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.parallel import dist, dist_gat
from tests.test_torch_port_gat import random_params
from tests.torch_port_dist_cases import cpu_ring, jcsr

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
SIZES = (5, 4, 3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def toy_graph(n: int, density: float, seed: int) -> CSRData:
    """A binary random graph with self-loops (not symmetric)."""
    m = sps.random(n, n, density=density, format="csr", random_state=seed, dtype=np.float32)
    m = (m + sps.identity(n, dtype=np.float32, format="csr")).tocsr()
    m.data[:] = 1.0
    return CSRData(m.indptr.astype(np.int64), m.indices.astype(np.int32), m.data, m.shape)


def cross_graph(n: int, parts: int, seed: int) -> CSRData:
    """Every row of slab j links to 3 random nodes of slab (j + 1) % P only:
    no entry lies in a diagonal block, so every score and every aggregated
    feature comes over the ring."""
    m = n // parts
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 3)
    cols = ((rows // m + 1) % parts) * m + rng.integers(0, m, rows.size)
    a = sps.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    a.data[:] = 1.0
    return CSRData(a.indptr.astype(np.int64), a.indices.astype(np.int32), a.data, a.shape)


def inputs(n: int, seed: int, mask: bool = False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, SIZES[0])).astype(np.float32)
    y = rng.integers(0, SIZES[-1], n).astype(np.int64)
    return x, y, (rng.random(n) < 0.5 if mask else None)


def assert_leaves_close(got, want, bound: float) -> None:
    """Per leaf, ‖got − want‖ ≤ bound · ‖want‖."""
    for i, (gl, wl) in enumerate(zip(got, want, strict=True)):
        assert gl.keys() == wl.keys()
        for k in wl:
            g, w = np.asarray(gl[k], np.float64), np.asarray(wl[k], np.float64)
            diff = np.linalg.norm(g.reshape(w.shape) - w)
            assert diff <= bound * np.linalg.norm(w), f"layer {i} {k}: {diff} > {bound} x {np.linalg.norm(w)}"


def single_and_dist(csr, parts, config, params_np, x, y, mask, dtype="float32"):
    """(one-card loss_and_grad, dist_gat_loss_and_grad) from the same
    parameters, as numpy gradients."""
    params = convert.params_from_numpy(params_np, "cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    mt = None if mask is None else torch.from_numpy(mask)
    one = gat.loss_and_grad(params, gat.build_gat_graph(csr, dtype=dtype, device="cpu"), xt, yt, config, mt)
    ring = cpu_ring(parts)
    graph = dist_gat.build_dist_gat_graph(csr, ring, dtype=dtype)
    masks = None if mask is None else dist.shard(mt, ring)
    got = dist_gat.dist_gat_loss_and_grad([params] * parts, graph, dist.shard(xt, ring), dist.shard(yt, ring),
                                          config, masks)
    return one, got


def assert_same_step(got, one, n: int, bound: float = 1e-5) -> None:
    """Loss within rtol 1e-5, the same number of correct rows, every
    gradient leaf within ``bound`` of its norm."""
    np.testing.assert_allclose(float(got[0]), float(one[0]), rtol=1e-5)
    assert round(float(got[1]) * n) == round(float(one[1]) * n)
    assert_leaves_close(convert.params_to_numpy(got[2]), convert.params_to_numpy(one[2]), bound)


# ---------------------------------------------------------------------------
# (a) against the JAX distributed GAT step, once


@pytest.fixture(scope="module")
def jax_sgd_step():
    """One SGD step (lr 1, no decay) of JAX's ``make_dist_gat_train_step``
    on 2 of the CPU mesh's devices: n = 64, one head, sizes 5-4-3, float32.
    Returns the graph, inputs, start parameters and (params after, loss,
    acc) as numpy."""
    n, parts = 64, 2
    csr = toy_graph(n, 0.08, seed=21)
    x, y, _ = inputs(n, seed=22)
    jconfig = jgat.GATConfig(sizes=SIZES, heads=1)
    params = random_params(jconfig, seed=23)
    mesh = jdist.make_mesh(parts)
    g = jdist_gat.build_dist_gat_graph(jcsr(csr), parts, dtype="float32")
    step = jdist_gat.make_dist_gat_train_step(jconfig, mesh, g, hparams=dict(lr=1.0, weight_decay=0.0),
                                              optimizer="sgd")
    jp = jax.tree.map(jnp.asarray, params)
    after, _, loss, acc = step(jp, jadam.adam_init(jp), jdist_gat.graph_arrays(g), jnp.asarray(x),
                               jnp.asarray(y.astype(np.int32)))
    return dict(csr=csr, x=x, y=y, params=params, after=jax.tree.map(np.asarray, after), loss=float(loss),
                acc=float(acc), n=n, parts=parts)


def test_sgd_step_matches_the_jax_dist_gat_step(jax_sgd_step):
    """The port's step at the same P: loss within rtol 1e-5, the same
    number of correct rows, and every leaf's p − p′ (the gradient, at lr 1
    without decay) within ‖Δ‖ ≤ 1e-5 ‖JAX‖."""
    case = jax_sgd_step
    ring = cpu_ring(case["parts"])
    config = gat.GATConfig(sizes=SIZES, heads=1)
    graph = dist_gat.build_dist_gat_graph(case["csr"], ring, dtype="float32")
    step = dist_gat.make_dist_gat_train_step(config, ring, graph, dict(lr=1.0, weight_decay=0.0), optimizer="sgd")
    start = convert.params_from_numpy(case["params"], "cpu")
    params, opt = dist.replicate(start, ring), dist.replicate(adam.adam_init(start), ring)
    after, _, loss, acc = step(params, opt, graph, dist.shard(case["x"], ring), dist.shard(case["y"], ring))
    np.testing.assert_allclose(float(loss), case["loss"], rtol=1e-5)
    assert round(float(acc) * case["n"]) == round(case["acc"] * case["n"])
    got = [{k: p[k] - a[k] for k in p} for p, a in zip(case["params"], convert.params_to_numpy(after[0]))]
    want = [{k: p[k] - a[k] for k in p} for p, a in zip(case["params"], case["after"])]
    assert_leaves_close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# (b) against the port's one-card GAT step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("parts", [2, 4])
def test_gradients_equal_the_single_card_step(parts, heads, dtype):
    """Two layers on a random graph at P = 2 and 4, one and two heads, in
    both dtypes: the loss within rtol 1e-5, the same correct rows, every
    leaf within ‖Δ‖ ≤ 1e-5 ‖one card‖ (the same rounded inputs; only the
    row sums' order differs, by blocks)."""
    n = 96
    config = gat.GATConfig(sizes=SIZES, heads=heads)
    x, y, _ = inputs(n, seed=parts + heads)
    one, got = single_and_dist(toy_graph(n, 0.06, seed=heads), parts, config, random_params(config, seed=parts),
                               x, y, None, dtype)
    assert_same_step(got, one, n)


def test_masked_loss_equals_the_single_card_step():
    """``--mask-train``: the partitions' mask and the mask's partition-summed
    denominator give the one-card masked loss and gradients."""
    n, parts = 96, 4
    config = gat.GATConfig(sizes=SIZES, heads=2, loss_mask="train")
    x, y, mask = inputs(n, seed=5, mask=True)
    one, got = single_and_dist(toy_graph(n, 0.06, seed=5), parts, config, random_params(config, seed=5), x, y, mask)
    assert_same_step(got, one, int(mask.sum()))


def test_banded_graph_with_empty_blocks():
    """A banded graph at P = 4 whose band reaches only the neighbouring row
    slabs: the blocks two slabs away hold no entry, and the step still
    equals the one-card step."""
    n, parts = 128, 4
    g = sparse.banded_graph(n, 4, n // (2 * parts), 3)
    ring = cpu_ring(parts)
    nnz = dist_gat.build_dist_gat_graph(g, ring).block_nnz
    assert all(nnz[j][2] == 0 for j in range(parts)) and all(nnz[j][0] > 0 for j in range(parts))
    config = gat.GATConfig(sizes=SIZES, heads=2)
    x, y, _ = inputs(n, seed=6)
    one, got = single_and_dist(g, parts, config, random_params(config, seed=6), x, y, None)
    assert_same_step(got, one, n)


def test_ring_hops_carry_gradient(monkeypatch):
    """On a graph whose every edge crosses partitions, e_src and z reach a
    row only through the ring hops, so ``a_src``'s gradient comes only
    through the hops' backward (the reverse ring): equal to the one-card
    gradient, and wrong (more than 10 % off in norm) when the hops are cut
    out of the graph by a detaching copy."""
    n, parts = 96, 4
    g = cross_graph(n, parts, seed=7)
    config = gat.GATConfig(sizes=SIZES, heads=2)
    params = random_params(config, seed=7)
    x, y, _ = inputs(n, seed=7)
    one, got = single_and_dist(g, parts, config, params, x, y, None)
    assert_same_step(got, one, n)
    monkeypatch.setattr(dist_gat, "_ppermute", lambda blocks: [b.detach() for b in dist._ppermute(blocks)])
    _, cut = single_and_dist(g, parts, config, params, x, y, None)
    for i in range(config.num_layers):
        for k in ("a_src", "W"):
            ref = one[2][i][k]
            assert float(torch.linalg.vector_norm(cut[2][i][k] - ref)) > 0.1 * float(torch.linalg.vector_norm(ref))


def test_build_holds_each_block_of_the_slab():
    """Partition j's round s block is A[j, (j+s) % P]: its CSR rows hold
    the slab's entries in that column block, in the slab's CSR order, a
    repeated entry kept twice; its transpose is the stable sort of those
    entries by column."""
    n, parts = 96, 3
    g = toy_graph(n, 0.08, seed=8)
    first = g.indices[g.indptr[0] : g.indptr[1]]
    g = CSRData(np.concatenate([[0], g.indptr[1:] + first.size]), np.concatenate([first, g.indices]),
                np.ones(g.nnz + first.size, np.float32), g.shape)  # row 0's entries twice
    graph = dist_gat.build_dist_gat_graph(g, cpu_ring(parts), dtype="bfloat16")
    m = n // parts
    assert graph.m_loc == m and graph.nnz == g.nnz and sum(map(sum, graph.block_nnz)) == g.nnz
    for j in range(parts):
        for s in range(parts):
            k = (j + s) % parts
            mat, sched = graph.blocks[j][s]
            rows = [[c - k * m for c in g.indices[g.indptr[r] : g.indptr[r + 1]] if k * m <= c < (k + 1) * m]
                    for r in range(j * m, (j + 1) * m)]
            assert mat.indices.tolist() == [c for row in rows for c in row]
            assert mat.indptr.tolist() == np.cumsum([0] + [len(row) for row in rows]).tolist()
            assert mat.dtype_name == "bfloat16" and mat.w is None and mat.nnz == graph.block_nnz[j][s]
            cols = mat.indices.numpy()
            order = np.argsort(cols, kind="stable")
            entry_rows = np.repeat(np.arange(m), np.diff(mat.indptr.numpy()))
            assert sched.perm.tolist() == order.tolist() and sched.t_rows.tolist() == entry_rows[order].tolist()
            assert sched.t_indptr.tolist() == np.cumsum([0] + np.bincount(cols, minlength=m).tolist()).tolist()


def test_sgd_and_three_adam_steps_equal_the_single_card_steps():
    """``make_dist_gat_train_step`` at P = 4 on replica lists against the
    one-card ``make_train_step(model="gat")``: one SGD step, then three Adam
    steps; losses within rtol 1e-5, correct rows equal, parameters within
    rtol 1e-5 / atol 1e-6 after each run."""
    n, parts = 96, 4
    csr = toy_graph(n, 0.06, seed=9)
    config = gat.GATConfig(sizes=SIZES, heads=2)
    start = convert.params_from_numpy(random_params(config, seed=9), "cpu")
    x, y, _ = inputs(n, seed=9)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    ring = cpu_ring(parts)
    graph = dist_gat.build_dist_gat_graph(csr, ring, dtype="float32")
    one_graph = gat.build_gat_graph(csr, dtype="float32", device="cpu")
    for optimizer, steps in (("sgd", 1), ("adam", 3)):
        step1 = ttrain.make_train_step(config, optimizer=optimizer, model="gat")
        stepd = dist_gat.make_dist_gat_train_step(config, ring, graph, optimizer=optimizer)
        p1, o1 = start, adam.adam_init(start)
        pd, od = dist.replicate(start, ring), dist.replicate(adam.adam_init(start), ring)
        for _ in range(steps):
            p1, o1, l1, a1 = step1(p1, o1, one_graph, xt, yt, None)
            pd, od, ld, ad = stepd(pd, od, graph, dist.shard(xt, ring), dist.shard(yt, ring))
            np.testing.assert_allclose(float(ld), float(l1), rtol=1e-5)
            assert round(float(ad) * n) == round(float(a1) * n)
        for got, want in zip(convert.params_to_numpy(pd[0]), convert.params_to_numpy(p1)):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=f"{optimizer} {k}")
        assert int(od[0].step) == (steps if optimizer == "adam" else 0)


def test_step_refusals():
    """The JAX step's refusal of edge-weighted GAT (its message), the JAX
    build's n % P message, and an unknown optimizer."""
    ring = cpu_ring(2)
    graph = dist_gat.build_dist_gat_graph(toy_graph(64, 0.05, seed=1), ring)
    with pytest.raises(ValueError) as got:
        dist_gat.make_dist_gat_train_step(gat.GATConfig(sizes=SIZES, edge_weighted=True), ring, graph)
    with pytest.raises(ValueError) as want:
        jdist_gat.make_dist_gat_train_step(jgat.GATConfig(sizes=SIZES, edge_weighted=True), jdist.make_mesh(2),
                                           None)
    assert str(got.value) == str(want.value)
    g = toy_graph(63, 0.05, seed=1)
    with pytest.raises(ValueError) as got:
        dist_gat.build_dist_gat_graph(g, ring)
    with pytest.raises(ValueError) as want:
        jdist_gat.build_dist_gat_graph(jcsr(g), 2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown optimizer"):
        dist_gat.make_dist_gat_train_step(gat.GATConfig(sizes=SIZES), ring, graph, optimizer="lamb")


# ---------------------------------------------------------------------------
# (c) the CLI


def _epochs(err: str) -> list:
    return [line.split() for line in err.splitlines() if line[:1].isdigit() and len(line.split()) == 4]


@pytest.mark.parametrize("extra", [[], ["--mask-train", "--optimizer", "sgd"]], ids=["adam", "mask-train sgd"])
def test_cli_dist_gat_matches_the_library(tmp_path, capsys, extra):
    """``--model gat -P 2 -R 1 --heads 2 -E 3`` on the golden dataset: the
    three epoch lines' losses and accuracies equal the library's steps on
    the same inputs (seed-99 init, 7 labels rounded up to 8), and
    ``--save`` holds the library's parameters."""
    ck = tmp_path / "ck.npz"
    argv = ["--device", "cpu,cpu", "-P", "2", "-R", "1", "--model", "gat", "--heads", "2", "-E", "3", "--csv-dir",
            str(tmp_path), "--save", str(ck), *extra, "train", GOLDEN, "1", "8"]
    assert cli.main(argv) == 0
    epochs = _epochs(capsys.readouterr().err)
    assert [e[0] for e in epochs] == ["0", "1", "2"]
    assert sorted(os.listdir(tmp_path)) == ["ck.npz", "golden_16_8_8_2.csv"]

    ds = Dataset.load(GOLDEN)
    ring = cpu_ring(2)
    config = gat.GATConfig(sizes=(16, 8, 8), heads=2, loss_mask="train" if extra else "all")
    start = gat.init_params(config, device="cpu")
    graph = dist_gat.build_dist_gat_graph(ds.graph, ring, dtype="bfloat16")
    xs, ys, masks = dist.shard_dataset(ds, ring, mask_train=bool(extra))
    step = dist_gat.make_dist_gat_train_step(config, ring, graph, optimizer="sgd" if extra else "adam")
    p, o = dist.replicate(start, ring), dist.replicate(adam.adam_init(start), ring)
    for e in range(3):
        p, o, loss, acc = step(p, o, graph, xs, ys, masks)
        assert float(epochs[e][1]) == float(loss) and float(epochs[e][2]) == float(acc)
    saved, _ = load_checkpoint(ck, (start, adam.adam_init(start)))
    for got, want in zip(convert.params_to_numpy(saved), convert.params_to_numpy(p[0])):
        for k in want:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize(
    "args",
    [["-P", "3", "-R", "1", "--model", "gat"], ["-P", "2", "-R", "1", "--model", "gat", "--edge-weighted"],
     ["-P", "2", "-R", "0", "--model", "gat"]],
    ids=lambda a: " ".join(a),
)
def test_cli_dist_gat_refusals_match_jax(tmp_path, capsys, args):
    """n % P (256 nodes at -P 3), ``--edge-weighted`` at -P 2 and ``-R 0``
    exit 2 with the JAX CLI's messages."""
    P = int(args[1])
    argv = ["-E", "1", "--csv-dir", str(tmp_path), *args, "train", GOLDEN, "1", "8"]
    assert cli.main(["--device", ",".join(["cpu"] * P), *argv]) == 2
    got = capsys.readouterr().err.splitlines()[-1]
    assert jcli.main(argv) == 2
    assert got == capsys.readouterr().err.splitlines()[-1]


def test_cli_dist_gat_defaults_to_the_card(tmp_path, capsys, monkeypatch):
    """Without a card, ``--model gat -P 2`` without ``--device`` exits 2
    naming the visible cards; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-P", "2", "-R", "1", "--model", "gat", "-E", "1", "--csv-dir", str(tmp_path), "train", GOLDEN, "1", "8"]
    assert cli.main(argv) == 2
    assert capsys.readouterr().err.splitlines()[-1] == "error: requested -P 2 but only 0 devices visible"
