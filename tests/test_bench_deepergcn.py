"""The DeeperGCN cell of the benchmark (``deepergcn-reddit-uniform``) on the
CPU at a small size: the configuration and its entries, the leaves in the
port's layout, the work counted by hand, the four new metric readers on a
synthetic trace (and nothing where their scope or counter is missing), the
faults coming out not correct through the harness, the reference against
its float64 twin and its own faults, and the reference importing nothing
of the port."""

import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import compare, runner, spec, tracing
from benchmark.tests.helpers import ROOT, SEED, run_tiny, tiny_cell
from benchmark.tests.test_bench_faults import frozen, half_batch

CELL = "deepergcn-reddit-uniform"
METRICS = ("softagg_ms", "softagg_roofline", "norm_ms", "softagg_launches")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def small_cell(operand: str = "bfloat16") -> spec.Cell:
    """The cell at 512 nodes and 8 draws a row, 4 GENConv layers of 16."""
    cell = tiny_cell(CELL)
    cell.config.update(layers=4, sizes=[608, 16, 41], aggregation_dtype=operand)
    return cell


def _inputs(cell, dtype=torch.float32):
    graph, x, y, params0 = runner.make_inputs(ROOT, cell, SEED, torch.device("cpu"))
    return graph, torch.from_numpy(x).to(dtype), torch.from_numpy(y), {k: v.to(dtype) for k, v in params0.items()}


def test_cell_files_pass_the_rules():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    assert spec.problems(bench, ROOT) == []
    cell = spec.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.family == cell.reference == "deepergcn" and cell.traffic_name == "uniform"
    assert cell.config["reduced"] == [] and cell.config["layers"] == 28 and cell.config["sizes"] == [608, 128, 41]
    entry = next(c for c in bench["configs"] if c["name"] == "deepergcn-reddit")
    assert entry["source"] == cell.config["source"] and len(entry["source"]) <= 200
    names = {m["name"]: m for m in cell.per_layer}
    for name in METRICS:
        assert names[name]["workloads"] == [CELL] and names[name]["moves"] == "epoch_ms"
    assert {"step_mfu", "idle_share", "build_s"} <= set(names)
    assert set(cell.limits) == set(compare.NUMBERS)


def test_leaves_have_the_port_layout():
    """The benchmark's leaves are the port's ``init_params`` shapes, each
    BatchNorm scale held as ``gamma_delta``; 552,745 numbers."""
    from mg_gcn_tpu_torch.models import deepergcn as dg

    cell = spec.load_cell(ROOT, CELL)
    family = spec.load_module(ROOT, "families", "deepergcn")
    leaves = {name: shape for name, shape, _ in family.leaves(cell.config)}
    port = dg.init_params(family.port_config(cell.config), 1, device="cpu")
    want = {f"{i}.{k.replace('gamma', 'gamma_delta')}": tuple(v.shape) for i, layer in enumerate(port)
            for k, v in layer.items()}
    assert leaves == want and sum(math.prod(s) for s in leaves.values()) == 552_745
    bounds = {name: bound for name, _, bound in family.leaves(cell.config)}
    assert bounds["0.W"] == 1 / math.sqrt(608) and bounds["29.b"] == 1 / math.sqrt(128)
    assert bounds["5.gamma_delta"] == bounds["5.beta"] == 0.0


def test_the_flat_form_carries_gamma_both_ways():
    """A drawn nought leaf is the port's γ = 1, and the trainer reads γ − 1
    back (moments unshifted)."""
    cell = small_cell()
    family = spec.load_module(ROOT, "families", "deepergcn")
    _, _, _, params0 = _inputs(cell)
    port = family.port_params(params0)
    assert bool((port[2]["gamma"] == 1).all()) and "gamma_delta" not in port[2]
    back = family.bench_flat(port, shift=True)
    assert back.keys() == params0.keys() and all(torch.equal(back[k], params0[k]) for k in back)
    assert torch.equal(family.bench_flat(port, shift=False)["2.gamma_delta"], port[2]["gamma"])


def test_work_counts_by_hand():
    cell = small_cell()
    family = spec.load_module(ROOT, "families", "deepergcn")
    n, nnz, (f, h, c), layers = 1000, 20_000, cell.config["sizes"], cell.config["layers"]
    w = family.work(cell.config, n, nnz)
    # the encoder (forward, weight gradient), then each linear and the head (forward, weight, input gradients)
    assert len(w.gemms) == 2 + 3 * (layers + 1) and not w.products
    assert sum(g.flops for g in w.gemms) == 2 * 2 * n * f * h + 3 * 2 * n * h * (h * layers + c)
    assert [a.what for a in w.softagg] == ["forward", "backward"] * layers
    fwd, bwd = w.softagg[:2]
    csr = 4 * nnz + 8 * (n + 1)
    assert (fwd.flops, fwd.bytes) == (4 * nnz * h, csr + 2 * n * h + 8 * n * h)
    assert (bwd.flops, bwd.bytes) == (2 * nnz * h, csr + 2 * n * h + 4 * n * h)
    assert fwd.least_s() == max(fwd.flops / 989e12, fwd.bytes / 3.35e12)
    assert w.softagg_least_s == pytest.approx(layers * (fwd.least_s() + bwd.least_s()))
    assert w.least_s == pytest.approx(w.gemms_least_s + w.softagg_least_s)
    # the cell's shape: each pass bound by its bytes, 11.7 ms an epoch
    full = family.work(spec.load_cell(ROOT, CELL).config, 232_968, 114_964_464)
    assert all(a.bytes / 3.35e12 > a.flops / 989e12 for a in full.softagg)
    assert 11e-3 < full.softagg_least_s < 12e-3


def _synthetic_trace(phases: dict, epochs: int = 2) -> tracing.Traced:
    """A trace of one host thread: for each phase name, a scope holding one
    launch whose kernel takes ``phases[name]`` µs; and one kernel outside
    any scope."""
    events, ts = [], 0.0
    for corr, (name, dur) in enumerate(list(phases.items()) + [("", 40.0)]):
        if name:
            events.append(dict(cat="user_annotation", name=name, ts=ts, dur=10.0, pid=1, tid=1))
        events.append(dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=ts + 1, dur=1.0, pid=1, tid=1,
                           args=dict(correlation=corr)))
        events.append(dict(cat="kernel", name=f"k{corr}", ts=ts + 2, dur=dur, pid=0, tid=7,
                           args=dict(correlation=corr, device=0)))
        ts += 100.0 + dur
    return tracing.Traced(events=events, epochs=epochs, cards=[0], t0=0.0, t1=ts, host_s=ts / 1e6)


def test_new_metrics_read_a_synthetic_trace(monkeypatch):
    from mg_gcn_tpu_torch import timers

    cell = spec.load_cell(ROOT, CELL)
    work = spec.load_module(ROOT, "families", "deepergcn").work(cell.config, 232_968, 114_964_464)
    trace = _synthetic_trace({"3_0_matmul-spmm": 3000.0, "3_1_matmul-spmm": 1000.0, "4_0_activation": 400.0,
                              "4_1_activation": 200.0, "3_0_matmul-gemm": 500.0})
    monkeypatch.setattr(timers, "counters", lambda: {"softagg_launches": {("fwd", 256): 56, ("bwd", 128): 56}})
    ctx = SimpleNamespace(trace=trace, work=work)
    got = {name: spec.load_module(ROOT, "metrics", name).read(ctx) for name in METRICS}
    assert got["softagg_ms"] == pytest.approx(2.0) and got["norm_ms"] == pytest.approx(0.3)
    assert got["softagg_roofline"] == pytest.approx(100.0 * work.softagg_least_s * 1e3 / 2.0)
    assert got["softagg_launches"] == 56.0


def test_new_metrics_read_nothing_where_nothing_is_there(monkeypatch):
    """No trace, no scope of theirs in the trace, no counter, or a work
    count without the softmax aggregation: nothing, and no raise (the
    parent's port has none of them)."""
    from mg_gcn_tpu_torch import timers

    cell = spec.load_cell(ROOT, CELL)
    work = spec.load_module(ROOT, "families", "deepergcn").work(cell.config, 1000, 20_000)
    gcn_work = spec.load_module(ROOT, "families", "gcn").work(spec.load_cell(ROOT, "gcn-reddit-uniform").config,
                                                              1000, 20_000)
    monkeypatch.setattr(timers, "counters", lambda: {"attn_launches": {("edge", 8): 3}})
    other = _synthetic_trace({"0_0_matmul-gemm": 500.0, "adam-update": 100.0})
    for ctx in (SimpleNamespace(trace=None, work=work), SimpleNamespace(trace=other, work=work),
                SimpleNamespace(trace=_synthetic_trace({"3_0_matmul-spmm": 10.0}), work=gcn_work)):
        for name in ("softagg_ms", "softagg_roofline", "norm_ms", "softagg_launches"):
            value = spec.load_module(ROOT, "metrics", name).read(ctx)
            assert value is None or (name == "softagg_ms" and ctx.work is gcn_work), (name, value)
    monkeypatch.delattr(timers, "counters")
    assert spec.load_module(ROOT, "metrics", "softagg_launches").read(SimpleNamespace(trace=other)) is None


def test_sound_run_is_correct_and_reports_the_metrics():
    """The small cell through the harness, traced: correct, with the
    launches counter at two products a layer over the traced epochs (the
    counter is the process's, so what earlier tests of this process
    counted is added)."""
    from mg_gcn_tpu_torch import timers

    cell = small_cell()
    before = sum(timers.counters().get("softagg_launches", {}).values())
    out = run_tiny(cell, trace=True)
    assert out["correct"], out["checks"]
    epochs = cell.traffic["traced_epochs"]
    assert out["metrics"]["softagg_launches"]["value"] == pytest.approx((before + 2 * 4 * epochs) / epochs)


@pytest.mark.parametrize("fault", [frozen, half_batch], ids=["frozen", "half_batch"])
def test_fault_is_not_correct(fault):
    out = run_tiny(small_cell(), plant=fault)
    assert not out["correct"], out["checks"]


def test_reference_faults_and_precision_control_move_it():
    """The reference's faults and its float8 operand change what it
    computes, each past a limit of the cell."""
    cell = small_cell()
    ref = spec.load_module(ROOT, "reference", "deepergcn")
    graph, x, y, params0 = _inputs(cell)
    sound = ref.run(graph, x, y, params0, cell.config, 3)
    runs = {f: ref.run(graph, x, y, params0, cell.config, 3, faults={f}) for f in ("half_batch", "frozen",
                                                                                   "no_residual")}
    runs["fp8"] = ref.run(graph, x, y, params0, {**cell.config, "aggregation_dtype": "float8_e4m3fn"}, 3)
    for what, rec in runs.items():
        got = compare.numbers(rec, sound)
        assert any(got[k][0] > cell.limits[k] for k in compare.NUMBERS), (what, got)


def test_reference_against_float64_twin():
    cell = small_cell("float32")
    ref = spec.load_module(ROOT, "reference", "deepergcn")
    records = {}
    for dtype in (torch.float32, torch.float64):
        graph, x, y, params0 = _inputs(cell, dtype)
        records[dtype] = ref.run(graph, x, y, params0, cell.config, 3)
    got = compare.numbers(records[torch.float32], records[torch.float64])
    # float32 rounding of 512 nodes' sums through four layers and three Adam steps
    assert got["loss_gap"][0] < 1e-5 and got["grad_gap"][0] < 1e-4 and got["grad_dir"][0] < 1e-4
    assert got["change_gap"][0] < 1e-2


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import benchmark.reference.deepergcn;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'mg_gcn_tpu_torch', 'mg_gcn_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_int8_operand_is_refused_cleanly():
    cell = small_cell("int8")
    with pytest.raises(ValueError, match="no int8 path"):
        runner.run(ROOT, cell, SEED, 0.05, False, [torch.device("cpu")], time.perf_counter())


def test_other_aggregation_is_refused_cleanly():
    """A configuration whose ``aggr`` is not softmax_sg is refused by the
    family before any step, with the port's message."""
    cell = small_cell()
    cell.config["aggr"] = "softmax"
    with pytest.raises(ValueError, match="softmax_sg only"):
        runner.run(ROOT, cell, SEED, 0.05, False, [torch.device("cpu")], time.perf_counter())
