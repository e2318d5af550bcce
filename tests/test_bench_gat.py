"""The GAT cell of the benchmark (``gat-reddit-uniform``) on the CPU at a
tiny size: the port's PPI form of GAT (per-layer heads, ELU, the skip across
the middle layer) against the plain reference ``benchmark/reference/gat.py``
(logits, loss, every gradient leaf, three Adam steps through the harness),
the reference against its float64 twin, the planted faults and the
precision control coming out not correct, the reference importing nothing
of the port, and the family's work count and metric readers."""

import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import compare, runner, spec
from benchmark.harness.params import to_layers
from benchmark.harness.trainer import host_csr
from benchmark.tests.helpers import ROOT, SEED, run_tiny, tiny_cell
from benchmark.tests.test_bench_faults import frozen, half_batch

CELL = "gat-reddit-uniform"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(cell, dtype=torch.float32):
    graph, x, y, params0 = runner.make_inputs(ROOT, cell, SEED, torch.device("cpu"))
    return graph, torch.from_numpy(x).to(dtype), torch.from_numpy(y), {k: v.to(dtype) for k, v in params0.items()}


def _port_and_reference(cell):
    """(port logits, loss, grads) and (reference logits, loss, grads) from
    the cell's tiny inputs, the gradients flat by leaf name."""
    from mg_gcn_tpu_torch.models import gat as tgat

    family = spec.load_module(ROOT, "families", "gat")
    ref = spec.load_module(ROOT, "reference", "gat")
    graph, x, y, params0 = _inputs(cell)
    config = family.port_config(cell.config)
    pair = tgat.build_gat_graph(host_csr(graph), dtype=cell.config["aggregation_dtype"], device="cpu")
    layers = to_layers({k: v.clone() for k, v in params0.items()})
    logits = tgat.forward(layers, pair, x, config)
    loss, _, grads = tgat.loss_and_grad(layers, pair, x, y, config)
    port = (logits, float(loss), {f"{i}.{k}": g for i, layer in enumerate(grads) for k, g in layer.items()})
    pat = ref.Pattern(graph, x.device, ref.rounding(cell.config))
    r_logits = ref.logits(params0, pat, x, cell.config)
    r_loss, r_grads = ref.loss_and_grads(params0, pat, x, y, cell.config)
    return port, (r_logits, float(r_loss), r_grads)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_port_matches_the_reference_leaf_by_leaf(precision):
    """Logits, loss and every gradient leaf of the port's step on the
    tiny cell against the reference's: in float32 the same arithmetic in
    another order, every leaf within 1e-4 of its norm; with the bfloat16
    attention the same rounding points, every leaf within 1e-5 of the
    median leaf's norm (compare's scale: a_dst's gradient is a sum of
    terms that cancel, since the softmax over a row does not see e_dst[r]
    but through the LeakyReLU)."""
    cell = tiny_cell(CELL)
    cell.config["aggregation_dtype"] = precision
    (logits, loss, grads), (r_logits, r_loss, r_grads) = _port_and_reference(cell)
    assert torch.allclose(logits, r_logits, rtol=1e-5, atol=1e-5 * float(r_logits.abs().max()))
    assert abs(loss - r_loss) <= 1e-6 * abs(r_loss)
    assert grads.keys() == r_grads.keys()
    if precision == "float32":
        for k, g in grads.items():
            assert torch.linalg.vector_norm(g - r_grads[k]) <= 1e-4 * torch.linalg.vector_norm(r_grads[k]), k
    else:
        assert max(compare.scaled(grads, r_grads, diff=True).values()) < 1e-5


def test_three_adam_steps_through_the_harness_are_correct():
    """The tiny cell through the harness: the port's first three steps
    against the reference's are correct, the first gradient at float32
    summation order."""
    out = run_tiny(tiny_cell(CELL))
    assert out["correct"], out["checks"]
    assert out["checks"]["grad_gap"]["value"] < 1e-5 and out["checks"]["grad_dir"]["value"] < 1e-5


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "no_skip"])
def test_fault_is_not_correct(fault):
    plants = {"frozen": (frozen, None), "half_batch": (half_batch, None), "no_skip": (None, {"skip": []})}
    plant, control = plants[fault]
    cell = tiny_cell(CELL)
    out = runner.run(ROOT, cell, SEED, 0.05, False, [torch.device("cpu")], time.perf_counter(), plant=plant,
                     control=control)
    assert not out["correct"], out["checks"]


def test_reference_below_its_precision_is_not_correct():
    """The reference with the attention's operands in float8 (the control
    below the configuration's bfloat16) against itself at bfloat16."""
    cell = tiny_cell(CELL)
    ref = spec.load_module(ROOT, "reference", "gat")
    graph, x, y, params0 = _inputs(cell)
    sound = ref.run(graph, x, y, params0, cell.config, 3)
    low = ref.run(graph, x, y, params0, {**cell.config, "aggregation_dtype": "float8_e4m3fn"}, 3)
    got = compare.numbers(low, sound)
    assert any(got[k][0] > cell.limits[k] for k in compare.NUMBERS), got


def test_reference_against_float64_twin():
    cell = tiny_cell(CELL)
    cell.config["aggregation_dtype"] = "float32"
    ref = spec.load_module(ROOT, "reference", "gat")
    records = {}
    for dtype in (torch.float32, torch.float64):
        graph, x, y, params0 = _inputs(cell, dtype)
        records[dtype] = ref.run(graph, x, y, params0, cell.config, 3)
    got = compare.numbers(records[torch.float32], records[torch.float64])
    # float32 rounding of a few hundred nodes' sums through three layers of
    # 1,024 features and three Adam steps
    assert got["loss_gap"][0] < 1e-5
    assert got["grad_gap"][0] < 1e-5
    assert got["grad_dir"][0] < 1e-5
    assert got["change_gap"][0] < 1e-2


def test_reference_faults_move_it():
    """The reference's own faults change what it computes."""
    cell = tiny_cell(CELL)
    ref = spec.load_module(ROOT, "reference", "gat")
    graph, x, y, params0 = _inputs(cell)
    sound = ref.run(graph, x, y, params0, cell.config, 2)
    for fault in ("half_batch", "no_skip", "frozen"):
        got = compare.numbers(ref.run(graph, x, y, params0, cell.config, 2, faults={fault}), sound)
        assert max(v for v, _ in got.values()) > 1e-2, (fault, got)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import benchmark.reference.gat;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'mg_gcn_tpu_torch', 'mg_gcn_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_leaves_have_the_port_layout():
    from mg_gcn_tpu_torch.models import gat as tgat

    cell = spec.load_cell(ROOT, CELL)
    family = spec.load_module(ROOT, "families", "gat")
    leaves = {name: shape for name, shape, _ in family.leaves(cell.config)}
    port = tgat.init_params(family.port_config(cell.config), 1, device="cpu")
    assert leaves == {f"{i}.{k}": tuple(v.shape) for i, layer in enumerate(port) for k, v in layer.items()}
    assert leaves["0.W"] == (608, 1024) and leaves["1.W"] == (1024, 1024) and leaves["2.W"] == (1024, 246)
    assert leaves["2.b"] == (41,) and leaves["1.a_dst"] == (4, 256)


def test_work_counts_the_attention():
    cell = spec.load_cell(ROOT, CELL)
    family = spec.load_module(ROOT, "families", "gat")
    n, nnz = 232_968, 114_964_464
    w = family.work(cell.config, n, nnz)
    assert len(w.attention) == 6 * (4 + 4 + 6) and not w.products
    assert w.least_s == pytest.approx(w.gemms_least_s + w.attention_least_s)
    agg = [a for a in w.attention if a.what == "aggregation"]
    assert [a.flops for a in agg] == [2.0 * nnz * 256] * 8 + [2.0 * nnz * 41] * 6
    # the layer-0 projection, n x 608 x 1024, and its weight gradient
    assert w.gemms[0].flops == w.gemms[1].flops == 2.0 * n * 608 * 1024
    # every pass of the attention is bound by its bytes at these widths
    assert all(a.bytes / 3.35e12 >= a.flops / 989e12 for a in w.attention)


def test_cell_files_and_metric_readers():
    import json
    import os

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    assert spec.problems(bench, ROOT) == []
    cell = spec.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.family == "gat" and cell.config["reduced"] == []
    names = [m["name"] for m in cell.per_layer]
    assert {"attn_ms", "attn_roofline", "attn_launches", "step_mfu", "idle_share", "build_s"} <= set(names)
    ctx = SimpleNamespace(trace=None, work=spec.load_module(ROOT, "families", "gat").work(cell.config, 10, 30))
    for name in ("attn_ms", "attn_roofline", "attn_launches"):
        assert spec.load_module(ROOT, "metrics", name).read(ctx) is None
