"""One run of one cell.

Set-up (timed as ``setup_s``, from the start of ``run.py``): the cell's
files; the graph, features, labels and initial parameters made on the card
from ``--seed``; the port's operator, step and optimizer state, built once
as the port's CLI builds them; the first :data:`FIRST_STEPS` steps through
that same step (the reference follows them). Then the window: one step an
epoch, the loss and accuracy read back after each, for ``--seconds``; the
same object goes on from where the first steps left it. With ``--trace 1``
a few more epochs run under the profiler after the window. Then the port's
state is freed and the plain reference runs the first steps from the same
inputs and parameters on the first card; the numbers of ``compare`` against
the cell's limits decide ``correct``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from benchmark.harness import compare, guard, spec, tracing
from benchmark.harness.params import init_params

FIRST_STEPS = 3


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py", description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="inputs and weights are made from it")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: the per-layer metrics from a trace")
    return p.parse_args(argv)


def cards(chips: int) -> list:
    """The cell's cards, ``cuda:0 .. cuda:chips-1``; raises without them."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the benchmark measures the port on cards only")
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(chips)]


def make_inputs(root: str, cell: spec.Cell, seed: int, device: torch.device):
    """(graph, features, labels, initial parameters) from the seed: the graph
    by its layout, features normal (the dataset's width, zero columns up to
    the first layer's), labels uniform over the classes, all drawn on
    ``device``; features and labels then go to the host, as the port's
    loaders hand them over."""
    ds, sizes = cell.config["dataset"], cell.config["sizes"]
    n = int(ds["nodes"])
    layout = spec.load_module(root, "graphs", cell.traffic["graph"])
    graph = layout.make(n, cell.traffic, 3 * seed, device)
    gen = torch.Generator(device=device).manual_seed(3 * seed + 1)
    x = torch.zeros((n, sizes[0]), dtype=torch.float32, device=device)
    x[:, : ds["features"]] = torch.randn((n, ds["features"]), generator=gen, device=device)
    y = torch.randint(0, ds["classes"], (n,), generator=gen, device=device)
    family = spec.load_module(root, "families", cell.family)
    params0 = init_params(family.leaves(cell.config), 3 * seed + 2, device)
    return graph, x.cpu().numpy(), y.cpu().numpy(), params0


def memory_peak(devices) -> int:
    cuda = [d for d in devices if d.type == "cuda"]
    return max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def first_steps(trainer, params0: dict, opt: dict, steps: int) -> dict:
    """The program's first ``steps`` steps through the window's own call,
    in the reference's form."""
    losses, m1 = [], None
    for s in range(steps):
        loss, _ = trainer.epoch()
        losses.append(loss)
        if s == 0:
            m1 = trainer.first_moment()
    return compare.program_record(losses, m1, params0, trainer.flat_params(), opt)


def run(root: str, cell: spec.Cell, seed: int, seconds: float, trace: bool, devices: list, t_start: float,
        plant=None, control: dict | None = None) -> dict:
    """The result of one run (the keys of the printed line). ``plant(trainer)``
    may break the timed path and ``control`` change the configuration the
    port runs (not the reference's), for the tests of ``correct``."""
    cfg = cell.config
    port_cfg = {**cfg, **(control or {})}
    torch.backends.cuda.matmul.allow_tf32 = bool(port_cfg.get("tf32", False))
    family = spec.load_module(root, "families", cell.family)
    reference = spec.load_module(root, "reference", cell.reference)
    dev0 = devices[0]
    t_in = time.perf_counter()
    graph, x, y, params0 = make_inputs(root, cell, seed, dev0)
    log(f"{cell.name}: n {graph.n}, nnz {graph.nnz}, seed {seed}; start to inputs {t_in - t_start:.3f} s,"
        f" inputs {time.perf_counter() - t_in:.3f} s")
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(d)

    trainer = family.build(port_cfg, cell.traffic, graph, x, y, params0, devices)
    if plant is not None:
        plant(trainer)
    t_steps = time.perf_counter()
    record = first_steps(trainer, params0, cfg["optimizer"], FIRST_STEPS)
    t0 = time.perf_counter()
    log(f"first {FIRST_STEPS} steps {t0 - t_steps:.3f} s")
    setup_s = t0 - t_start
    losses = []
    while True:
        losses.append(trainer.epoch()[0])
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    epoch_s = elapsed / len(losses)
    peak = memory_peak(devices)
    log(f"window {elapsed:.3f} s, {len(losses)} epochs, {epoch_s * 1e3:.4f} ms an epoch, setup {setup_s:.3f} s,"
        f" peak {peak} B, losses {losses[0]:.6f} .. {losses[-1]:.6f}; {card_line()}")

    traced = None
    if trace:
        traced = tracing.trace_epochs(trainer.epoch, devices, int(cell.traffic["traced_epochs"]))
        log(f"traced: {traced.host_s / traced.epochs * 1e3:.4f} ms an epoch on the host clock, window"
            f" {traced.window_s:.6f} s; idle by card {traced.idle_shares()}")
    ctx = SimpleNamespace(cell=cell, epoch_s=epoch_s, epochs=len(losses), setup_s=setup_s, peak_bytes=peak,
                          build_s=trainer.build_s, work=family.work(cfg, graph.n, graph.nnz), trace=traced)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.load_module(root, "metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    trainer.close()
    del trainer
    gc.collect()
    if dev0.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference's dense products are float32
    ref = reference.run(graph, torch.from_numpy(x).to(dev0), torch.from_numpy(y).to(dev0), params0, cfg,
                        FIRST_STEPS, blocks=int(cfg.get("parts", 1)))
    got = compare.numbers(record, ref)
    log(f"reference {time.perf_counter() - t_ref:.3f} s; losses {record['losses']} vs {ref['losses']}")

    failed = sum(not math.isfinite(v) for v in losses)
    checks = {k: {"value": v, "limit": cell.limits[k], "at": what} for k, (v, what) in got.items()}
    checks["window_nonfinite_losses"] = {"value": failed, "limit": 0, "at": "window"}
    device = {"platform": "gpu" if dev0.type == "cuda" else dev0.type,
              "kind": torch.cuda.get_device_name(dev0) if dev0.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()), "attempted": len(losses),
           "failed": failed, "metrics": metrics, "device": device}
    if traced is not None and traced.cards:
        busy = traced.busy_s()
        device.update(busy_s=sum(busy.values()) / len(busy), window_s=traced.window_s)
    if traced is not None:
        out["breakdown"] = traced.breakdown()
    out["checks"] = checks
    return out


def main(argv, t_start: float, root: str) -> int:
    args = parse(argv)
    cell = spec.load_cell(root, args.workload)
    try:
        devices = cards(cell.chips)
    except RuntimeError as exc:
        log(f"error: {exc}")
        return 1
    result = run(root, cell, args.seed, args.seconds, bool(args.trace), devices, t_start)
    found = guard.forbidden_loaded()
    if found:
        log(f"error: the run loaded {', '.join(found)}")
        return 1
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r} ({c['at']})")
    print(json.dumps(result))
    return 0
