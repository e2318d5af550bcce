"""DeeperGCN (``models/deepergcn.py``, ``ops/softmax_agg.py``,
``ops/batch_norm.py``) on the CPU: the parameter count of the published
ogbn-arxiv model, the softmax aggregation against the published per-row
softmax in float64, BatchNorm against PyTorch's, the port's loss and
gradients over three Adam steps against the plain reference
``benchmark/reference/deepergcn.py``, the train and replayed steps, the CLI
and its refusals. The model has no JAX counterpart; the reference is the
benchmark's plain PyTorch one."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import compare, spec
from benchmark.harness.graph import Graph
from benchmark.tests.helpers import ROOT
from mg_gcn_tpu_torch import cli, sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.formats import Dataset
from mg_gcn_tpu_torch.models import deepergcn as dg
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.ops.batch_norm import batch_norm_relu
from mg_gcn_tpu_torch.ops.softmax_agg import softmax_aggregate
from mg_gcn_tpu_torch.ops.spmm_gather import gather_pair_from_binary_csr

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
N, F_IN, HIDDEN, C, LAYERS = 300, 10, 16, 4, 4
U_BF16 = 2.0**-8  # bfloat16's unit roundoff (8 significant bits)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _graph(n=N, seed=2):
    return sparse.random_graph(n, 6, seed=seed, weights="ones")


def _per_row_softmax(g, x, t, eps):
    """The published form in float64: per row i and channel, the softmax of
    t·m over row i's entries j → i under the row's own max, and a = Σ s ⊙ m;
    the entries' (row, column) and the weights s, detached."""
    gt = sparse.transpose(g)
    rows = torch.repeat_interleave(torch.arange(gt.nrows), torch.from_numpy(np.diff(gt.indptr)))
    cols = torch.from_numpy(gt.indices).long()
    m = torch.relu(x.double()) + eps
    z = t * m[cols]
    rowmax = torch.full((gt.nrows, x.shape[1]), -torch.inf, dtype=torch.float64)
    rowmax = rowmax.scatter_reduce(0, rows[:, None].expand_as(z), z, "amax")
    e = torch.exp(z - rowmax[rows])
    den = torch.zeros_like(rowmax).index_add_(0, rows, e)
    s = (e / den[rows]).detach()
    return rows, cols, s, m


def _pair(g):
    """(fwd, bwd) of the model's binary pair on the CPU."""
    pair = dg.build_deepergcn_graph(g, device="cpu")
    return pair.fwd, pair.bwd


def _inputs(n=N, d=HIDDEN, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, d), generator=gen) * 3.0, torch.randn((n, d), generator=gen)


def test_parameter_count_is_the_leaderboard_entry():
    """At ogbn-arxiv's widths the stack has the 491,176 parameters of the
    authors' leaderboard entry; at the cell's (608 in, 41 out) 552,745."""
    for sizes, want in (((128, 128, 40), 491_176), ((608, 128, 41), 552_745)):
        params = dg.init_params(dg.DeeperGCNConfig(sizes=sizes), device="cpu")
        assert len(params) == 30 and sum(v.numel() for layer in params for v in layer.values()) == want


def test_init_is_pytorch_default_in_the_documented_layout():
    config = dg.DeeperGCNConfig(sizes=(F_IN, HIDDEN, C), layers=LAYERS)
    params = dg.init_params(config, 7, device="cpu")
    assert [sorted(layer) for layer in params] == ([["W", "b"]] * 2 + [["W", "b", "beta", "gamma"]] * LAYERS)
    assert params[0]["W"].shape == (F_IN, HIDDEN) and params[-1]["W"].shape == (HIDDEN, C)
    for k, layer in enumerate(params):
        bound = 1 / np.sqrt(F_IN if k == 0 else HIDDEN)
        assert float(layer["W"].abs().max()) <= bound and float(layer["b"].abs().max()) <= bound
        if "gamma" in layer:
            assert bool((layer["gamma"] == 1).all()) and bool((layer["beta"] == 0).all())
    again = dg.init_params(config, 7, device="cpu")
    assert all(torch.equal(a[k], b[k]) for a, b in zip(params, again) for k in a)


@pytest.mark.parametrize("operand,bound", [("float32", 1e-6), ("bfloat16", 2 * U_BF16 + 1e-6)])
def test_softmax_aggregation_is_the_per_row_softmax(operand, bound):
    """The op's global column shift gives the published per-row softmax: a
    within ``bound`` of the float64 form, element by element. With bfloat16
    operands each positive term of num and of den is rounded once (u =
    2^-8), so a = num/den lies within 2u of the exact value; float32 within
    the float32 sums of a few entries."""
    g = _graph()
    fwd, bwd = _pair(g)
    x, _ = _inputs()
    a = softmax_aggregate(fwd, bwd, x, 0.1, 1e-7, operand)
    rows, cols, s, m = _per_row_softmax(g, x, 0.1, 1e-7)
    want = torch.zeros((N, HIDDEN), dtype=torch.float64).index_add_(0, rows, s * m[cols])
    assert bool(((a.double() - want).abs() <= bound * want).all())


@pytest.mark.parametrize("operand,bound", [("float32", 1e-6), ("bfloat16", 3 * U_BF16 + 1e-6)])
def test_softmax_aggregation_backward_is_the_detached_softmax(operand, bound):
    """The op's gradient against autograd through the float64 per-row form
    with the weights detached (softmax_sg: ∂a_i/∂m_j = s_ij), then the
    message's ReLU: element by element within ``bound`` of the sum of the
    terms' magnitudes (bfloat16: g/den rounded once, and w/den off the exact
    weight by den's rounding)."""
    g = _graph()
    fwd, bwd = _pair(g)
    x, cot = _inputs()
    xl = x.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(softmax_aggregate(fwd, bwd, xl, 0.1, 1e-7, operand), xl, cot)
    x64 = x.double().requires_grad_(True)
    rows, cols, s, m = _per_row_softmax(g, x64, 0.1, 1e-7)
    a = torch.zeros((N, HIDDEN), dtype=torch.float64).index_add(0, rows, s * m[cols])
    (want,) = torch.autograd.grad(a, x64, cot.double())
    mag = torch.zeros((N, HIDDEN), dtype=torch.float64).index_add_(0, cols, s * cot.double().abs()[rows])
    assert bool(((got.double() - want).abs() <= bound * mag + 1e-300).all())
    assert bool((got[x <= 0] == 0).all())


def test_softmax_aggregation_past_its_shift_bound_is_nought_not_nan():
    """A row whose messages lie 1,000 below the column's largest (past the
    global shift's bound of about 870 at t = 0.1): every weight of the row
    underflows, and the op gives a = 0 there and passes no gradient, with
    no NaN anywhere; the other rows keep their softmax."""
    g = _graph()
    gt = sparse.transpose(g)
    fwd, bwd = _pair(g)
    x, cot = _inputs()
    x = x.abs()
    row = 5
    srcs = torch.from_numpy(gt.indices[gt.indptr[row] : gt.indptr[row + 1]]).long()
    others = torch.ones(N, dtype=torch.bool)
    others[srcs] = False
    x[others] += 1000.0  # every node outside the row's sources sits 1,000 higher
    xl = x.clone().requires_grad_(True)
    a = softmax_aggregate(fwd, bwd, xl, 0.1, 1e-7, "bfloat16")
    (dx,) = torch.autograd.grad(a, xl, cot)
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(dx).all())
    assert bool((a[row] == 0).all())
    fine = [r for r in range(N) if not bool(torch.isin(torch.from_numpy(
        gt.indices[gt.indptr[r] : gt.indptr[r + 1]]).long(), srcs).all())]
    assert bool((a[fine] > 0).all())


def test_softmax_aggregation_refuses_a_scaled_pair():
    g = _graph()
    with pytest.raises(ValueError, match="binary pair with no degree scales"):
        softmax_aggregate(*gather_pair_from_binary_csr(g, device="cpu"), _inputs()[0], 0.1, 1e-7)
    fwd, bwd = _pair(g)
    with pytest.raises(ValueError, match="operand"):
        softmax_aggregate(fwd, bwd, _inputs()[0], 0.1, 1e-7, "int8")


def test_batch_norm_relu_is_torchs_batch_norm():
    """Forward and backward against ReLU(F.batch_norm) in training mode,
    within float32 rounding (rtol 1e-5)."""
    gen = torch.Generator().manual_seed(4)
    h = torch.randn((N, HIDDEN), generator=gen) * 2.0 + 0.5
    gamma, beta = torch.rand(HIDDEN, generator=gen) + 0.5, torch.randn(HIDDEN, generator=gen)
    cot = torch.randn((N, HIDDEN), generator=gen)
    out = []
    for fn in (lambda a, b, c: batch_norm_relu(a, b, c, 1e-5),
               lambda a, b, c: torch.relu(F.batch_norm(a, None, None, b, c, training=True, eps=1e-5))):
        leaves = [v.clone().requires_grad_(True) for v in (h, gamma, beta)]
        z = fn(*leaves)
        out.append([z.detach(), *torch.autograd.grad(z, leaves, cot)])
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def _reference_case(operand: str):
    """(config dict, port config, graph, x, y, flat params, port pair) of a
    small DeeperGCN: 4 GENConv layers of 16 on a 300-node graph."""
    fam = spec.load_module(ROOT, "families", "deepergcn")
    cell = spec.load_cell(ROOT, "deepergcn-reddit-uniform")
    config = dict(cell.config, sizes=[F_IN, HIDDEN, C], layers=LAYERS, aggregation_dtype=operand)
    g = _graph()
    graph = Graph(n=N, indptr=g.indptr, indices=g.indices)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((N, F_IN)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, C, N))
    gen = torch.Generator().manual_seed(6)
    flat = {name: (torch.rand(shape, generator=gen) * 2 - 1) * (bound or 0.2) for name, shape, bound in
            fam.leaves(config)}  # the BatchNorm leaves away from their init, so that every leaf is exercised
    return fam, config, graph, x, y, flat, dg.build_deepergcn_graph(g, device="cpu")


@pytest.mark.parametrize("operand", ["float32", "bfloat16"])
def test_port_matches_the_reference_over_three_adam_steps(operand):
    """Three Adam steps of the port's step against the plain reference
    from the same parameters. float32: the same arithmetic with sums in
    another order, four layers: losses within 1e-6, the first gradient and
    the change of every leaf within 1e-5 of compare's scale. bfloat16: the
    same rounding points, a float32 difference now and then moving a
    bfloat16 rounding: losses within 1e-4, gradients within 2e-3, the
    change within 2e-2 (Adam's first step is about lr times the gradient's
    sign, so a leaf element whose gradient is near nought moves by up to
    2 lr when that sign differs)."""
    fam, config, graph, x, y, flat, pair = _reference_case(operand)
    ref = spec.load_module(ROOT, "reference", "deepergcn")
    want = ref.run(graph, x, y, flat, config, 3)
    step = ttrain.make_train_step(fam.port_config(config), dict(lr=0.01, weight_decay=0.0), model="deepergcn")
    params = fam.port_params(flat)
    opt = adam.adam_init(params)
    losses, m1 = [], None
    for s in range(3):
        params, opt, loss, _ = step(params, opt, pair, x, y, None)
        losses.append(float(loss))
        if s == 0:
            m1 = fam.bench_flat(opt.m, shift=False)
    got = compare.program_record(losses, m1, flat, fam.bench_flat(params, shift=True), config["optimizer"])
    numbers = {k: v for k, (v, _) in compare.numbers(got, want).items()}
    limits = ({"loss_gap": 1e-6, "grad_gap": 1e-5, "grad_dir": 1e-5, "change_gap": 1e-5} if operand == "float32"
              else {"loss_gap": 1e-4, "grad_gap": 2e-3, "grad_dir": 2e-3, "change_gap": 2e-2})
    assert all(numbers[k] <= limits[k] for k in limits), numbers


def test_scan_on_the_cpu_equals_its_own_loop_bit_for_bit():
    """``make_scan_train_steps(model="deepergcn")`` takes the loop route on
    the CPU and equals three steps of ``make_train_step`` bit for bit (the
    card's replayed graph is held in ``test_torch_port_cuda.py``)."""
    _, config, _, x, y, flat, pair = _reference_case("bfloat16")
    fam = spec.load_module(ROOT, "families", "deepergcn")
    pc = fam.port_config(config)
    params = fam.port_params(flat)
    got = ttrain.make_scan_train_steps(pc, 3, model="deepergcn")(params, adam.adam_init(params), pair, x, y, None)
    step = ttrain.make_train_step(pc, model="deepergcn")
    p, o = params, adam.adam_init(params)
    losses = []
    for _ in range(3):
        p, o, loss, _ = step(p, o, pair, x, y, None)
        losses.append(loss)
    assert torch.equal(got[2], torch.stack(losses))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(got[0], p) for k in a)


def test_first_step_imports_no_module():
    """The first train step loads no module: each one it imported (torch.fx's
    symbolic shapes and sympy through autograd's tensor ``grad_outputs``, some
    400 modules) was seconds of every run's set-up. In a fresh process, so
    that no other test has imported them already."""
    code = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
from mg_gcn_tpu_torch import sparse
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.models import deepergcn as dg
from mg_gcn_tpu_torch.nn import adam
torch.set_num_threads(2)
config = dg.DeeperGCNConfig(sizes=(10, 16, 4), layers=3)
pair = dg.build_deepergcn_graph(sparse.random_graph(64, 4, seed=2, weights="ones"), device="cpu")
params = dg.init_params(config, 1, device="cpu")
x, y = torch.randn(64, 10), torch.randint(0, 4, (64,))
step = ttrain.make_train_step(config, model="deepergcn")
before = set(sys.modules)
step(params, adam.adam_init(params), pair, x, y, None)
print(sorted(set(sys.modules) - before))
"""
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_config_refuses_what_the_port_does_not_run():
    for kw, message in ((dict(aggr="mean"), "softmax_sg only"), (dict(norm="layer"), "BatchNorm"),
                        (dict(operand="int8"), "operand"),
                        (dict(layers=0), "at least one"), (dict(t=0.0), "positive")):
        with pytest.raises(ValueError, match=message):
            dg.DeeperGCNConfig(sizes=(F_IN, HIDDEN, C), **kw)
    with pytest.raises(ValueError, match="sizes"):
        dg.DeeperGCNConfig(sizes=(F_IN, HIDDEN, HIDDEN, C))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dg.build_deepergcn_graph(_graph())
    assert cli.main(["-E", "1", "--model", "deepergcn", "train", GOLDEN, "1", "8"]) == 2


def test_cli_trains_and_infers_deepergcn(tmp_path, capsys):
    """``--model deepergcn --layers 3`` on the
    golden dataset: the epoch lines carry the library step's losses from
    the seed-0 init, the CSV has the JAX CLI's name, and ``infer`` with the
    checkpoint writes the forward pass's predictions."""
    ds = Dataset.load(GOLDEN)
    config = dg.DeeperGCNConfig(sizes=(ds.num_features, 8, ds.num_labels), layers=3)
    pair = dg.build_deepergcn_graph(ds.graph, device="cpu")
    params = dg.init_params(config, device="cpu")
    opt = adam.adam_init(params)
    step = ttrain.make_train_step(config, dict(lr=0.01, weight_decay=0.0), model="deepergcn")
    x, y = torch.from_numpy(ds.features), torch.from_numpy(ds.labels.reshape(-1).astype(np.int64))
    want = []
    for _ in range(2):
        params, opt, loss, _ = step(params, opt, pair, x, y, None)
        want.append(float(loss))
    flags = ["--device", "cpu", "--model", "deepergcn", "--layers", "3"]
    ck = str(tmp_path / "deepergcn.ckpt.npz")
    rc = cli.main(["-E", "2", *flags, "--wd", "0", "--save", ck, "--csv-dir", str(tmp_path), "train", GOLDEN, "1",
                   "8"])
    assert rc == 0
    epochs = [line.split() for line in capsys.readouterr().err.splitlines()[3:]]
    np.testing.assert_allclose([float(e[1]) for e in epochs], want, rtol=1e-6)
    assert (tmp_path / cli._csv_name(GOLDEN, [ds.num_features, 8, ds.num_labels], 1)).exists()
    out = str(tmp_path / "pred.bin")
    assert cli.main([*flags, "--load", ck, "--save", out, "infer", GOLDEN, "1", "8"]) == 0
    preds = np.fromfile(out, np.int32)[-ds.num_nodes:]
    with torch.no_grad():
        logits = dg.forward(params, pair, x, config)
    assert np.array_equal(preds, torch.argmax(logits, dim=-1).numpy())


@pytest.mark.parametrize(
    "args,message",
    [
        (["-P", "2", "-R", "1", "--model", "deepergcn"], "runs on one card"),
        (["--model", "deepergcn", "--layers", "0"], "at least one"),
        (["--model", "deepergcn", "--impl", "pattern"], "binary CSR walk"),
        (["--model", "deepergcn", "--impl", "edge"], "binary CSR walk"),
        (["--model", "deepergcn", "--pattern-dtype", "int8"], "no int8 path"),
        (["--model", "deepergcn", "--residual"], "GCN option"),
        (["--layers", "4"], "DeeperGCN option"),
        (["--model", "gat", "--layers", "4"], "DeeperGCN option"),
    ],
    ids=["-P 2", "layers 0", "impl pattern", "impl edge", "int8", "residual", "layers gcn", "layers gat"],
)
def test_cli_deepergcn_refusals(args, message, capsys):
    """What the port does not run exits 2 with a message that says so."""
    assert cli.main(["--device", "cpu", "-E", "1", *args, "train", GOLDEN, "1", "8"]) == 2
    assert message in capsys.readouterr().err


def test_cli_deepergcn_takes_one_hidden_width(capsys):
    assert cli.main(["--device", "cpu", "-E", "1", "--model", "deepergcn", "train", GOLDEN, "2", "8", "8"]) == 2
    assert "one hidden width" in capsys.readouterr().err
