"""Port vs JAX package: column-parallel GCN (``parallel/dist_col.py``, the
CLI's ``-P N -R 0``) on P partitions on the CPU.

The pieces (``dist_transpose``, ``_tp_linear``, the sharded softmax
cross-entropy) are held against the JAX functions under ``shard_map`` on 4
of the CPU mesh's virtual devices; the step's loss against the JAX column
step's loss, and its gradients against the single-chip exact gradients of
both packages. The JAX column step's gradients are P times the true ones
(its loss is replicated and its collectives transpose to sums over all
devices): :func:`test_jax_column_gradients_are_p_times_the_true_ones`
pins that fault, which the port does not copy."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu.models import gcn as jgcn
from mg_gcn_tpu.ops.spmm import AggPair as JAggPair
from mg_gcn_tpu.ops.spmm import COOMat as JCOOMat
from mg_gcn_tpu.parallel import dist_col as jcol
from mg_gcn_tpu_torch import cli, convert, sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params, loss_and_grad
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.ops.spmm import AggPair, COOMat
from mg_gcn_tpu_torch.parallel import dist_col
from tests.torch_port_dist_cases import cpu_ring, jcsr

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
FEAT = jcol.FEAT_AXIS
N, SIZES = 48, (16, 8, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def problem(seed: int = 11):
    """tests/test_dist_col.py's problem: n = 48, a weighted random graph of
    degree 5 (seed 12), normalized; features and labels from ``seed``."""
    rng = np.random.default_rng(seed)
    a = sparse.normalize(sparse.random_graph(N, 5, seed=12, weights="random"), axis=True)
    x = rng.standard_normal((N, SIZES[0])).astype(np.float32)
    y = rng.integers(0, SIZES[-1], N).astype(np.int64)
    return a, sparse.transpose(a), x, y


def jax_shard_map(fn, parts, in_specs, out_specs):
    mesh = jcol.make_col_mesh(parts)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False))


def port_step(parts, a_t, x, y, config, params):
    """The port's (loss, acc, full gradients) of one column step."""
    ring = cpu_ring(parts)
    mats = dist_col.replicate_coo(COOMat.from_csr(a_t, device="cpu"), ring)
    loss, acc, grads = dist_col.col_loss_and_grad(dist_col.shard_col_params(params, ring), mats,
                                                  dist_col.shard_columns(x, ring), [torch.from_numpy(y)] * parts,
                                                  config, N)
    return loss, acc, dist_col.gather_col_params(grads)


def jax_col_grads(parts, a_t, x, y, config, params):
    """JAX's column step as ``make_col_train_step`` differentiates it:
    ``value_and_grad`` of ``col_loss_fn`` inside ``shard_map``; (loss,
    acc, gradients) with the gradients gathered to full arrays."""
    row, col, repl = PartitionSpec(FEAT), PartitionSpec(None, FEAT), PartitionSpec()
    pspec = [{"W": row, "b": col} for _ in params]
    mat = JCOOMat.from_csr(jcsr(a_t), pad_to=8)
    mspec = JCOOMat(rows=repl, cols=repl, vals=repl, n_rows=mat.n_rows, n_cols=mat.n_cols, nnz=mat.nnz)

    def body(p, m, xl, yl):
        (loss, acc), g = jax.value_and_grad(lambda q: jcol.col_loss_fn(q, m, xl, yl, config, N, parts),
                                            has_aux=True)(p)
        return loss, acc, g

    run = jax_shard_map(body, parts, (pspec, mspec, col, repl), (repl, repl, pspec))
    loss, acc, g = run(params, mat, jnp.asarray(x), jnp.asarray(y.astype(np.int32)))
    return float(loss), float(acc), jax.tree.map(np.asarray, g)


def single_chip(a, a_t, x, y, params):
    """The single-chip exact (loss, acc, gradients) of both packages."""
    jconfig = jgcn.GCNConfig(sizes=SIZES, parity=False)
    jpair = JAggPair(JCOOMat.from_csr(jcsr(a_t), pad_to=8), JCOOMat.from_csr(jcsr(a), pad_to=8))
    jl, ja, jg = jgcn.loss_and_grad(params, jpair, jnp.asarray(x), jnp.asarray(y.astype(np.int32)), jconfig)
    pair = AggPair(COOMat.from_csr(a_t, device="cpu"), COOMat.from_csr(a, device="cpu"))
    config = GCNConfig(sizes=SIZES, parity=False)
    loss, acc, grads = loss_and_grad(convert.params_from_numpy(params, "cpu"), pair, torch.from_numpy(x),
                                     torch.from_numpy(y), config)
    return (float(jl), float(ja), jax.tree.map(np.asarray, jg)), (float(loss), float(acc),
                                                                  convert.params_to_numpy(grads))


def assert_leaves_close(got, want, bound: float, scale: float = 1.0) -> None:
    """Per leaf, ‖got − scale · want‖ ≤ bound · ‖scale · want‖."""
    for i, (gl, wl) in enumerate(zip(got, want, strict=True)):
        assert gl.keys() == wl.keys()
        for k in wl:
            g, w = np.asarray(gl[k], np.float64), scale * np.asarray(wl[k], np.float64)
            diff = np.linalg.norm(g - w)
            assert diff <= bound * np.linalg.norm(w), f"layer {i} {k}: {diff} > {bound} x {np.linalg.norm(w)}"


# ---------------------------------------------------------------------------
# the pieces


@pytest.mark.parametrize("parts", [2, 4])
def test_dist_transpose_equals_x_t_and_jax(parts):
    """Column shards of an (n, d) matrix become column shards of its
    transpose: concatenated, xᵀ exactly, and equal to JAX's
    ``make_dist_transpose`` on the CPU mesh."""
    x = np.random.default_rng(7).standard_normal((32, 8)).astype(np.float32)
    ring = cpu_ring(parts)
    got = dist_col.make_dist_transpose(ring, parts)(dist_col.shard_columns(x, ring))
    assert [tuple(t.shape) for t in got] == [(8, 32 // parts)] * parts
    assert np.array_equal(torch.cat(got, dim=1).numpy(), x.T)
    want = np.asarray(jcol.make_dist_transpose(jcol.make_col_mesh(parts), parts)(jnp.asarray(x)))
    assert np.array_equal(torch.cat(got, dim=1).numpy(), want)
    with pytest.raises(ValueError) as err:
        dist_col.dist_transpose(dist_col.shard_columns(x[:31], ring))
    assert str(err.value) == f"rows (31) must be divisible by the mesh size ({parts})"


def test_tp_linear_equals_jax_under_shard_map():
    """h (n, in) column-sharded, W by input rows, b by output columns on 4
    partitions: the output column shards equal JAX's ``psum_scatter``
    within rtol 1e-6 (the partials summed in another order)."""
    parts = 4
    rng = np.random.default_rng(3)
    h = rng.standard_normal((24, 16)).astype(np.float32)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    b = rng.standard_normal((1, 12)).astype(np.float32)
    ring = cpu_ring(parts)
    shards = dist_col.shard_col_params([{"W": torch.from_numpy(w), "b": torch.from_numpy(b)}], ring)
    got = dist_col._tp_linear(dist_col.shard_columns(h, ring), [s[0]["W"] for s in shards],
                              [s[0]["b"] for s in shards])
    col = PartitionSpec(None, FEAT)
    want = jax_shard_map(jcol._tp_linear, parts, (col, PartitionSpec(FEAT), col), col)(h, w, b)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(want), h @ w + b, rtol=1e-5, atol=1e-5)


def test_sharded_softmax_xent_equals_jax_under_shard_map():
    """Loss within rtol 1e-6 and accuracy equal to JAX's
    ``_dist_col_softmax_xent`` on 4 partitions, with rows whose max sits in
    two shards at once (the first shard's column wins) and labels in every
    shard; the loss is the single-chip softmax cross-entropy."""
    parts, n, c = 4, 40, 8
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    logits[:6, 1] = logits[:6, 6] = 9.0  # ties across shards 0 and 3
    y = rng.integers(0, c, n).astype(np.int64)
    y[:3] = 6  # the tie's second column: wrong under the first-shard rule
    ring = cpu_ring(parts)
    loss, acc = dist_col._dist_col_softmax_xent(dist_col.shard_columns(logits, ring), [torch.from_numpy(y)] * parts, n)
    run = jax_shard_map(lambda lg, yy: jcol._dist_col_softmax_xent(lg, yy, n, parts), parts,
                        (PartitionSpec(None, FEAT), PartitionSpec()), (PartitionSpec(), PartitionSpec()))
    jl, ja = run(logits, y.astype(np.int32))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    assert float(acc) * n == float(ja) * n
    p = torch.softmax(torch.from_numpy(logits).double(), dim=1)
    np.testing.assert_allclose(float(loss), float(-torch.log(p[torch.arange(n), y]).mean()), rtol=1e-6)
    first = np.argmax(logits, axis=1)
    assert round(float(acc) * n) == int((first == y).sum())


# ---------------------------------------------------------------------------
# the step


@pytest.mark.parametrize("parts", [2, 4])
def test_column_step_has_the_single_chip_gradients_and_the_jax_loss(parts):
    """tests/test_dist_col.py's problem from the seed-99 init: the port's
    column step gives JAX's column-step loss (rtol 1e-5) and accuracy, the
    single-chip exact loss, and every gradient leaf within ‖Δ‖ ≤ 1e-5 ‖ref‖
    of the single-chip exact gradients of both packages."""
    a, a_t, x, y = problem()
    jconfig = jgcn.GCNConfig(sizes=SIZES, parity=False)
    params = jax.tree.map(np.asarray, jgcn.init_params(jconfig))
    loss, acc, grads = port_step(parts, a_t, x, y, GCNConfig(sizes=SIZES, parity=False),
                                 convert.params_from_numpy(params, "cpu"))
    jl, ja, _ = jax_col_grads(parts, a_t, x, y, jconfig, params)
    (sl, sa, sg), (tl, ta, tg) = single_chip(a, a_t, x, y, params)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    np.testing.assert_allclose(float(loss), sl, rtol=1e-5)
    np.testing.assert_allclose(float(loss), tl, rtol=1e-5)
    assert round(float(acc) * N) == round(ja * N) == round(sa * N) == round(ta * N)
    assert_leaves_close(convert.params_to_numpy(grads), sg, 1e-5)
    assert_leaves_close(convert.params_to_numpy(grads), tg, 1e-5)


@pytest.mark.parametrize("parts", [2, 4])
def test_jax_column_gradients_are_p_times_the_true_ones(parts):
    """Pins the JAX column step's fault. ``make_col_train_step``
    (``mg_gcn_tpu/parallel/dist_col.py:209-212``) differentiates the
    replicated loss inside ``shard_map``; ``psum_scatter`` and ``psum``
    transpose to sums over all devices, so every shard's gradient collects
    P copies: each leaf is P times the single-chip exact gradient, within
    1e-5 of its norm. The port's column step gives the true gradient
    (the test above), as the module's own contract says
    (tests/test_dist_col.py:1-2); with Adam's coupled decay the JAX step
    decays at wd/P, with SGD it steps at P·lr."""
    a, a_t, x, y = problem()
    jconfig = jgcn.GCNConfig(sizes=SIZES, parity=False)
    params = jax.tree.map(np.asarray, jgcn.init_params(jconfig))
    jl, _, jg = jax_col_grads(parts, a_t, x, y, jconfig, params)
    (sl, _, sg), _ = single_chip(a, a_t, x, y, params)
    np.testing.assert_allclose(jl, sl, rtol=1e-5)  # the loss is right
    assert_leaves_close(jg, sg, 1e-5, scale=float(parts))


def test_three_adam_steps_equal_the_single_card_exact_steps():
    """``make_col_train_step`` at P = 4 from the seed-99 init: three Adam
    steps equal the one-card exact ``make_train_step`` steps (losses within
    rtol 1e-5, accuracies equal) and the gathered parameters and moments
    after them (rtol 1e-5 / atol 1e-6); the step count is replicated."""
    parts = 4
    a, a_t, x, y = problem()
    config = GCNConfig(sizes=SIZES, parity=False)
    start = init_params(config, device="cpu")
    ring = cpu_ring(parts)
    step = dist_col.make_col_train_step(config, ring, N)
    mats = dist_col.replicate_coo(COOMat.from_csr(a_t, device="cpu"), ring)
    xs, ys = dist_col.shard_columns(x, ring), [torch.from_numpy(y)] * parts
    p, o = dist_col.shard_col_params(start, ring), dist_col.shard_col_state(adam.adam_init(start), ring)
    step1 = ttrain.make_train_step(config)
    pair = AggPair(COOMat.from_csr(a_t, device="cpu"), COOMat.from_csr(a, device="cpu"))
    p1, o1 = start, adam.adam_init(start)
    for _ in range(3):
        p, o, loss, acc = step(p, o, mats, xs, ys)
        p1, o1, l1, a1 = step1(p1, o1, pair, torch.from_numpy(x), torch.from_numpy(y), None)
        np.testing.assert_allclose(float(loss), float(l1), rtol=1e-5)
        assert float(acc) == float(a1)
    assert [int(s.step) for s in o] == [3] * parts
    for got, want in ((dist_col.gather_col_params(p), p1), (dist_col.gather_col_state(o).m, o1.m)):
        for gl, wl in zip(convert.params_to_numpy(got), convert.params_to_numpy(want)):
            for k in wl:
                np.testing.assert_allclose(gl[k], wl[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_operands_placement():
    """The COO pair is held once a distinct device (partitions on one device
    share it; Â is Âᵀ's entries swapped); parameters and Adam states shard
    and gather back bit for bit, W by input rows and b by output columns."""
    ring = dist_col.make_col_mesh(4, ["cpu"] * 4)
    _, a_t, _, _ = problem()
    mats = dist_col.replicate_coo(COOMat.from_csr(a_t, device="cpu"), ring)
    assert len({id(m) for m in mats}) == 1 and mats[0].bwd.rows is mats[0].fwd.cols
    config = GCNConfig(sizes=SIZES)
    params = init_params(config, seed=5, device="cpu")
    shards = dist_col.shard_col_params(params, ring)
    assert [tuple(s[0]["W"].shape) for s in shards] == [(4, 8)] * 4
    assert [tuple(s[1]["b"].shape) for s in shards] == [(1, 1)] * 4
    state = adam.adam_init(params)._replace(step=torch.tensor(7, dtype=torch.int32))
    back = dist_col.gather_col_state(dist_col.shard_col_state(state, ring))
    assert int(back.step) == 7
    for got, want in zip(dist_col.gather_col_params(shards), params):
        assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="does not split"):
        dist_col.shard_col_params([{"W": torch.zeros(6, 8), "b": torch.zeros(1, 8)}], ring)


@pytest.mark.parametrize(
    "kw,err",
    [(dict(residual=True), NotImplementedError), (dict(loss_mask="train"), NotImplementedError),
     (dict(sizes=(10, 8, 4)), ValueError)],
    ids=["residual", "loss_mask", "indivisible"],
)
def test_step_refusals_match_jax(kw, err):
    """Residual connections, a masked loss and widths that do not divide by
    P raise the JAX step's exceptions with its messages."""
    sizes = kw.pop("sizes", SIZES)
    with pytest.raises(err) as got:
        dist_col.make_col_train_step(GCNConfig(sizes=sizes, parity=False, **kw), cpu_ring(4), N)
    with pytest.raises(err) as want:
        jcol.make_col_train_step(jgcn.GCNConfig(sizes=sizes, parity=False, **kw), jcol.make_col_mesh(4), N)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the CLI


def _lines(err: str) -> tuple[list, list]:
    lines = err.splitlines()
    epochs = [line.split() for line in lines if line[:1].isdigit() and len(line.split()) == 4]
    return [line for line in lines if not (line[:1].isdigit() and len(line.split()) == 4)], epochs


def test_cli_column_epoch_0_and_checkpoint_match_jax_cli(tmp_path, capsys):
    """``-P 4 -R 0 -E 1 --save CK train <golden> 1 8``: the JAX CLI's stderr
    lines (the parity note included) and its epoch-0 loss and accuracy
    (rtol 1e-5; epoch 0 is before any update, where the JAX step's P×
    gradient does not show), and a checkpoint with the JAX CLI's leaves:
    the full rounded arrays (16 → 16, 8, 7 labels → 8), names and shapes."""
    base = ["-P", "4", "-R", "0", "-E", "1"]
    assert cli.main(["--device", "cpu", *base, "--csv-dir", str(tmp_path / "p"), "--save", str(tmp_path / "p.npz"),
                     "train", GOLDEN, "1", "8"]) == 0
    got, got_epochs = _lines(capsys.readouterr().err)
    assert jcli.main([*base, "--csv-dir", str(tmp_path / "j"), "--save", str(tmp_path / "j.npz"), "train", GOLDEN,
                      "1", "8"]) == 0
    want, want_epochs = _lines(capsys.readouterr().err)
    assert got == want and len(got_epochs) == len(want_epochs) == 1
    np.testing.assert_allclose(float(got_epochs[0][1]), float(want_epochs[0][1]), rtol=1e-5)
    assert float(got_epochs[0][2]) == float(want_epochs[0][2])
    assert os.listdir(tmp_path / "p") == os.listdir(tmp_path / "j") == ["golden_16_8_8_4.csv"]
    ported, jax_ck = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(ported.files) == sorted(jax_ck.files)
    assert {k: ported[k].shape for k in ported.files} == {k: jax_ck[k].shape for k in jax_ck.files}
    assert ported["leaf_0"].shape == (16, 8)  # layer 0 W, full


def test_cli_column_trains_and_resumes(tmp_path, capsys):
    """``-P 2 -R 0 -E 3 train <golden> 1 9``: the hidden width 9 rounds up
    to 10; three falling losses; ``--save`` holds the full (16, 10) layer 0
    W, and ``--load`` of it continues below the last epoch's loss."""
    ck = tmp_path / "ck.npz"
    argv = ["--device", "cpu,cpu", "-P", "2", "-R", "0", "--csv-dir", str(tmp_path)]
    assert cli.main([*argv, "-E", "3", "--save", str(ck), "train", GOLDEN, "1", "9"]) == 0
    _, epochs = _lines(capsys.readouterr().err)
    losses = [float(e[1]) for e in epochs]
    assert len(losses) == 3 and losses[2] < losses[0]
    assert np.load(ck)["leaf_0"].shape == (16, 10)
    assert cli.main([*argv, "-E", "1", "--load", str(ck), "train", GOLDEN, "1", "9"]) == 0
    _, resumed = _lines(capsys.readouterr().err)
    assert float(resumed[0][1]) < losses[2]


@pytest.mark.parametrize("flag", ["--mask-train", "--residual"])
def test_cli_column_refusals_match_jax(tmp_path, capsys, flag):
    argv = ["-P", "2", "-R", "0", "-E", "1", flag, "--csv-dir", str(tmp_path), "train", GOLDEN, "1", "8"]
    assert cli.main(["--device", "cpu", *argv]) == 2
    got = capsys.readouterr().err.splitlines()[-1]
    assert jcli.main(argv) == 2
    assert got == capsys.readouterr().err.splitlines()[-1]


def test_entry_points_default_to_the_card(tmp_path, capsys, monkeypatch):
    """Without a card the default ring (``cuda:0 .. cuda:P-1``) is refused,
    never moved to the CPU: the library's mesh raises, and the CLI's
    ``-P 2 -R 0`` without ``--device`` exits 2 naming the visible cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA device"):
        dist_col.make_col_mesh(2)
    assert cli.main(["-P", "2", "-R", "0", "-E", "1", "--csv-dir", str(tmp_path), "train", GOLDEN, "1", "8"]) == 2
    assert capsys.readouterr().err.splitlines()[-1] == "error: requested -P 2 but only 0 devices visible"
