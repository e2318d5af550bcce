"""Port vs JAX package: phase timing — the phase scopes of the GCN step
(``models/gcn.py``, ``adam-update``), ``xplane.py``'s reduction on
torch.profiler events, ``diagnostics.py`` and the CLI's ``--time-phases``
and ``--profile`` on the CPU, where both packages fall back to the un-fused
replay (no device events)."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu import diagnostics as jdiag
from mg_gcn_tpu import train as jtrain
from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.models import gcn as jgcn
from mg_gcn_tpu.nn import adam as jadam
from mg_gcn_tpu.xplane import _looks_like_phase as jax_looks_like_phase
from mg_gcn_tpu_torch import cli, diagnostics, sparse, timers, xplane
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.formats import Dataset
from mg_gcn_tpu_torch.models import gcn as tgcn
from mg_gcn_tpu_torch.nn import adam as tadam

N, F, C = 64, 10, 4
FALLBACK = "no device trace; falling back to un-fused phase replay"
# layer 0 aggregate-first (10 -> 16) with a projection residual, layer 1
# linear-first with the identity residual, layer 2 linear-first
SIZES = (F, 16, 16, C)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def inputs():
    g = sparse.random_graph(N, 4, seed=50)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, F)).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    return g, x, y


def jax_named_scopes(fn, *args) -> set[str]:
    """Every named-scope component of the ops of ``fn``'s jaxpr (sub-jaxprs
    too), with the transforms' wrappers (``jvp(...)``, ``transpose(...)``)
    taken off."""
    names = set()

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            for comp in str(eqn.source_info.name_stack).split("/"):
                while (m := re.fullmatch(r"\w+\((.*)\)", comp)) is not None:
                    comp = m.group(1)
                if comp:
                    names.add(comp)
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if isinstance(sub, jcore.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jcore.Jaxpr):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return names


def jax_step_scopes(config: jgcn.GCNConfig) -> set[str]:
    g, x, y = inputs()
    params = jgcn.init_params(config)
    pair = jtrain.build_agg_pair(JCSRData(g.indptr, g.indices, g.data, g.shape), impl="xla")
    step = jtrain.make_train_step(config, donate=False)
    return jax_named_scopes(step, params, jadam.adam_init(params), pair, jnp.asarray(x), jnp.asarray(y), None)


def port_step_events(config: tgcn.GCNConfig) -> list[dict]:
    """The Chrome-trace events of one traced port step on the CPU."""
    g, x, y = inputs()
    params = tgcn.init_params(config, device="cpu")
    pair = ttrain.build_agg_pair(g, impl="xla", device="cpu")
    step = ttrain.make_train_step(config)
    with torch.profiler.profile(activities=timers.profiler_activities()) as prof:
        step(params, tadam.adam_init(params), pair, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), None)
    return xplane.trace_events(prof)


def phase_spans(events: list[dict]) -> list[dict]:
    return [e for e in events if e.get("cat") == "user_annotation" and xplane._looks_like_phase(e["name"])]


@pytest.mark.parametrize("residual", [True, False])
def test_step_scopes_equal_jax_named_scopes(residual):
    """The record_function names of one traced parity-mode step on the CPU
    are exactly the JAX step's named_scope set for the same config
    (``adam-update`` included), each phase once; layer 0's skipped backward
    SpMM opens no scope, as its JAX named_scope holds no op."""
    jconfig = jgcn.GCNConfig(sizes=SIZES, residual=residual)
    want = {c for c in jax_step_scopes(jconfig) if jax_looks_like_phase(c)}
    assert "adam-update" in want and "0_1_matmul-spmm" not in want and "3_loss-layer" in want
    names = [e["name"] for e in phase_spans(port_step_events(tgcn.GCNConfig(sizes=SIZES, residual=residual)))]
    assert set(names) == want
    assert len(names) == len(set(names))


def test_exact_mode_scopes_and_backward_outside_them():
    """Exact mode: the port's scopes are the forward's and ``adam-update``,
    the JAX step's set once its transforms' wrappers are taken off (JAX
    names them ``jvp(0_0_matmul-spmm)`` and ``transpose(jvp(...))``, which
    its own ``_looks_like_phase`` refuses). Autograd's backward runs outside
    every phase span, so the reduction leaves the backward's device time
    unattributed (a deliberate difference, ROADMAP)."""
    jconfig = jgcn.GCNConfig(sizes=SIZES, parity=False)
    jax_all = jax_step_scopes(jconfig)
    want = {c for c in jax_all if xplane._looks_like_phase(c)}
    assert want == {f"{i}_0_{p}" for i in range(3) for p in ("matmul-gemm", "matmul-spmm")} | {
        "0_0_activation", "1_0_activation", "adam-update"}
    events = port_step_events(tgcn.GCNConfig(sizes=SIZES, parity=False))
    spans = phase_spans(events)
    assert {e["name"] for e in spans} == want
    backward = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("autograd::engine")]
    assert backward
    for b in backward:
        assert not [s for s in spans if s["tid"] == b["tid"] and s["ts"] <= b["ts"] <= s["ts"] + s["dur"]]


@pytest.mark.parametrize("residual", [True, False])
def test_profile_epoch_keys_equal_jax(residual):
    """The un-fused replay's keys, in order, are the JAX ``profile_epoch``'s
    on the same inputs: an aggregate-first and a linear-first layer, the
    backward's ``_gb``, ``_gw`` and ``_gout``, no ``0_1_matmul-spmm``."""
    g, x, y = inputs()
    jconfig = jgcn.GCNConfig(sizes=SIZES, residual=residual)
    jpair = jtrain.build_agg_pair(JCSRData(g.indptr, g.indices, g.data, g.shape), impl="xla")
    want = jdiag.profile_epoch(jgcn.init_params(jconfig), jpair, jnp.asarray(x), jnp.asarray(y), jconfig,
                               prefix="phase_")
    config = tgcn.GCNConfig(sizes=SIZES, residual=residual)
    pair = ttrain.build_agg_pair(g, impl="xla", device="cpu")
    got = diagnostics.profile_epoch(tgcn.init_params(config, device="cpu"), pair, torch.from_numpy(x),
                                    torch.from_numpy(y.astype(np.int64)), config, prefix="phase_")
    keys = list(got._entries)
    assert keys == list(want._entries)
    assert "phase_0_1_matmul-spmm" not in keys and "phase_0_0_matmul-spmm" in keys
    assert {"phase_2_1_gb", "phase_2_1_gw", "phase_2_1_gout", "phase_0_1_gw"} <= set(keys)
    assert all(ms >= 0 for ms in got._entries.values())


@pytest.mark.parametrize(
    "name",
    ["0_0_matmul-spmm", "12_1_activation", "3_loss-layer", "adam-update", "jit(step)", "transpose",
     "0_2_matmul-gemm", "0_1_residual", "2_0_matmul-gemm", "1_1_gb", "phase_0_0_activation", "loss-layer",
     "x_0_activation", "0_0_matmul-spmm/add", "jvp(0_0_matmul-spmm)", "adam", "aten::mm", "0_0",
     "7_1_matmul-spmm", "0_1_matmul"],
)
def test_looks_like_phase_matches_jax(name):
    """tests/test_xplane.py's strings and more: the JAX verdict."""
    assert xplane._looks_like_phase(name) == jax_looks_like_phase(name)


def ev(cat, name, ts, dur, tid=1, corr=None, pid=100):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": args}


def hand_built_events() -> list[dict]:
    """Host spans and launches on thread 1 (and one on thread 2), device
    events on the card (pid 0):

    * ``0_0_matmul-spmm`` (0-100) holds ``inner`` (10-40), a non-phase span,
      and the phase ``0_0_activation`` nested inside it (50-90);
    * kernel 1 launched at 20 (inside ``inner``: credited to the spmm
      scope, the innermost *phase*), kernel 2 at 60 (the activation), kernel
      3 at 95 whose kernel starts at 400, after its scope closed at 100 (the
      spmm scope), a memcpy launched at 150 by no scope, a memset with no
      launch event, a kernel launched on thread 2 while thread 1's scope
      was open, a driver-API launch inside ``adam-update``;
    * CPU ops and a launch that put nothing on the card count nowhere.
    """
    return [
        ev("user_annotation", "0_0_matmul-spmm", 0, 100),
        ev("user_annotation", "inner", 10, 30),
        ev("user_annotation", "0_0_activation", 50, 40),
        ev("user_annotation", "adam-update", 500, 50),
        ev("cpu_op", "aten::mm", 15, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=2),
        ev("cuda_runtime", "cudaLaunchKernelExC", 95, 2, corr=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 150, 2, corr=4),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 2, tid=2, corr=6),
        ev("cuda_driver", "cuLaunchKernel", 510, 2, corr=7),
        ev("cuda_runtime", "cudaFuncSetAttribute", 25, 1, corr=8),
        ev("kernel", "k1", 200, 1.5, tid=7, corr=1, pid=0),
        ev("kernel", "k2", 230, 2.0, tid=7, corr=2, pid=0),
        ev("kernel", "k3", 400, 4.0, tid=7, corr=3, pid=0),
        ev("gpu_memcpy", "Memcpy HtoD", 420, 0.25, tid=7, corr=4, pid=0),
        ev("gpu_memset", "Memset", 430, 0.125, tid=7, corr=5, pid=0),
        ev("kernel", "k6", 440, 0.5, tid=7, corr=6, pid=0),
        ev("kernel", "k7", 600, 3.0, tid=7, corr=7, pid=0),
        ev("gpu_user_annotation", "0_0_matmul-spmm", 200, 204, tid=7, pid=0),
    ]


def test_device_time_by_scope_on_hand_built_events():
    totals = xplane.device_time_by_scope(hand_built_events())
    want = {"0_0_matmul-spmm": (1.5 + 4.0) / 1e3, "0_0_activation": 2.0 / 1e3, "adam-update": 3.0 / 1e3,
            "unattributed": (0.25 + 0.125 + 0.5) / 1e3}
    assert totals.keys() == want.keys()
    for k, v in want.items():
        assert abs(totals[k] - v) < 1e-12, k
    pairs = [(phase, e["name"]) for phase, e in xplane.attribute(hand_built_events())]
    assert pairs == [("0_0_matmul-spmm", "k1"), ("0_0_activation", "k2"), ("0_0_matmul-spmm", "k3"),
                     ("unattributed", "Memcpy HtoD"), ("unattributed", "Memset"), ("unattributed", "k6"),
                     ("adam-update", "k7")]


def test_device_time_by_scope_empty_without_device_events():
    """A trace of the CPU only holds no device event: no entry, the signal
    for the un-fused fallback (the JAX reduction's empty dict)."""
    events = [e for e in hand_built_events() if e["pid"] != 0]
    assert xplane.device_time_by_scope(events) == {}
    assert xplane.device_time_by_scope(port_step_events(tgcn.GCNConfig(sizes=SIZES))) == {}


def test_scope_is_free_without_a_profiler():
    """Outside a profiler a scope is one shared no-op; inside, a
    record_function span of that name."""
    assert timers.scope("0_0_matmul-spmm") is timers.scope("adam-update")
    with torch.profiler.profile(activities=timers.profiler_activities()) as prof:
        with timers.scope("0_0_matmul-spmm"):
            torch.ones(3).sum()
    assert [e["name"] for e in phase_spans(xplane.trace_events(prof))] == ["0_0_matmul-spmm"]


def test_settle_profiler_primes_the_card_only(monkeypatch):
    """``settle_profiler``: with a card, at a trace's start the card
    synchronized, PRIMER_KERNELS spin kernels, synchronized again, then
    PROFILER_SETTLE_S slept; at its end only the sync and the sleep;
    without a card, nothing."""
    calls = []
    monkeypatch.setattr(timers.time, "sleep", lambda s: calls.append(("sleep", s)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(("synchronize",)))
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: calls.append(("spin", cycles)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    timers.settle_profiler()
    timers.settle_profiler(start=False)
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    timers.settle_profiler()
    spins = [("spin", timers.PRIMER_CYCLES)] * timers.PRIMER_KERNELS
    assert calls == [("synchronize",), *spins, ("synchronize",), ("sleep", timers.PROFILER_SETTLE_S)]
    calls.clear()
    timers.settle_profiler(start=False)
    assert calls == [("synchronize",), ("sleep", timers.PROFILER_SETTLE_S)]


def test_trace_readers_leave_the_primer_out():
    """``xplane.device_events`` and ``attribute`` drop the primer's spin
    kernels and keep every other device event."""
    events = [{"cat": "kernel", "name": "void at::cuda::(anonymous namespace)::spin_kernel(long)", "ts": 0, "dur": 5,
               "args": {"correlation": 1}},
              {"cat": "kernel", "name": "pattern_fwd_kernel", "ts": 10, "dur": 5, "args": {"correlation": 2}},
              {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 20, "dur": 1, "args": {}},
              {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 1}]
    assert [e["name"] for e in xplane.device_events(events)] == ["pattern_fwd_kernel", "Memcpy DtoD"]
    assert [e["name"] for _, e in xplane.attribute(events)] == ["pattern_fwd_kernel", "Memcpy DtoD"]


def test_trace_and_profile_fused_step_settle_both_ends(monkeypatch, tmp_path):
    """The ``--profile`` trace and ``profile_fused_step`` settle the
    profiler while it runs, before the traced work and after it."""
    seen = []
    def settle(start=True):
        seen.append((start, torch.autograd._profiler_enabled()))

    monkeypatch.setattr(timers, "settle_profiler", settle)
    monkeypatch.setattr(diagnostics, "settle_profiler", settle)
    with timers.trace(str(tmp_path)):
        seen.append("work")
    g, x, y = inputs()
    config = tgcn.GCNConfig(sizes=SIZES)
    params = tgcn.init_params(config, device="cpu")
    pair = ttrain.build_agg_pair(g, impl="xla", device="cpu")

    def step(*a):
        seen.append("step")
        return ttrain.make_train_step(config)(*a)

    args = (pair, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), None)
    diagnostics.profile_fused_step(step, (params, tadam.adam_init(params), *args), epochs=1)
    assert seen == [(True, True), "work", (False, True), "step", (True, True), "step", (False, True)]


def test_profile_fused_step_feeds_back_and_falls_through_on_the_cpu():
    """One warm step, then ``epochs`` traced steps, each fed the last one's
    params and state, which it returns: three Adam steps in all. On the CPU
    the trace has no device event, so no phase entry is added."""
    g, x, y = inputs()
    config = tgcn.GCNConfig(sizes=SIZES)
    params = tgcn.init_params(config, device="cpu")
    pair = ttrain.build_agg_pair(g, impl="xla", device="cpu")
    step = ttrain.make_train_step(config)
    args = (pair, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), None)
    reg = timers.TimerRegistry()
    got, p, s = diagnostics.profile_fused_step(step, (params, tadam.adam_init(params), *args), reg, epochs=2)
    assert got is reg and not reg._entries
    assert int(s.step) == 3
    want_p, want_s = params, tadam.adam_init(params)
    for _ in range(3):
        want_p, want_s, _, _ = step(want_p, want_s, *args)
    for a, b in zip(p, want_p):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_profile_fused_step_refuses_a_second_profiler():
    """``jax.profiler`` refuses a second trace with this message; torch
    would silently end the outer session, so the port refuses first."""
    g, x, y = inputs()
    config = tgcn.GCNConfig(sizes=SIZES)
    params = tgcn.init_params(config, device="cpu")
    step = ttrain.make_train_step(config)
    args = (params, tadam.adam_init(params), ttrain.build_agg_pair(g, impl="xla", device="cpu"),
            torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), None)
    with torch.profiler.profile(activities=timers.profiler_activities()):
        with pytest.raises(RuntimeError, match="Profile has already been started. Only one profile may be run"):
            diagnostics.profile_fused_step(step, args)


@pytest.fixture
def small_dataset(tmp_path):
    """A dataset the test writes with ``formats.Dataset.save``."""
    g, x, y = inputs()
    path = str(tmp_path / "small")
    Dataset(graph=g, features=x, labels=y.reshape(-1, 1), sets=np.zeros((N, 1), np.int32)).save(path)
    return path


def csv_rows(csv_dir) -> list[tuple[str, float]]:
    (name,) = os.listdir(csv_dir)
    rows = [line.rsplit(":", 1) for line in open(os.path.join(csv_dir, name)).read().splitlines()]
    return [(k, float(v)) for k, v in rows]


def test_cli_time_phases_matches_jax_on_the_cpu(small_dataset, tmp_path, capsys):
    """``-E 1 --time-phases train``: both CLIs print the fallback line and
    write the same keys, ``phase_`` rows included, in the same order."""
    argv = ["-E", "1", "--time-phases", "train", small_dataset, "2", "16", "16"]
    assert cli.main(["--device", "cpu", "--csv-dir", str(tmp_path / "port"), *argv]) == 0
    ours = capsys.readouterr().err.splitlines()
    assert jcli.main(["--csv-dir", str(tmp_path / "jax"), *argv]) == 0
    theirs = capsys.readouterr().err.splitlines()
    assert FALLBACK in ours and FALLBACK in theirs
    got, want = csv_rows(tmp_path / "port"), csv_rows(tmp_path / "jax")
    assert [k for k, _ in got] == [k for k, _ in want]
    phases = [k for k, _ in got if k.startswith("phase_")]
    assert "phase_0_0_matmul-spmm" in phases and "phase_loss-layer" in phases
    assert all(ms >= 0 for _, ms in got)


def test_cli_profile_writes_a_trace_of_the_run(small_dataset, tmp_path, capsys):
    """``--profile DIR``: exit 0, and DIR holds a Chrome trace whose phase
    spans are the step's (two epochs: each phase twice)."""
    prof = tmp_path / "prof"
    argv = ["--device", "cpu", "-E", "2", "--profile", str(prof), "--csv-dir", str(tmp_path), "train",
            small_dataset, "1", "8"]
    assert cli.main(argv) == 0
    events = json.load(open(prof / "trace.json"))["traceEvents"]
    names = [e["name"] for e in phase_spans(events)]
    assert names.count("adam-update") == 2 and names.count("0_0_matmul-spmm") == 2


def test_cli_profile_with_time_phases_refused_as_jax(small_dataset, tmp_path, capsys):
    """``--profile DIR --time-phases``: the JAX CLI trains, then its phase
    trace raises "Profile has already been started..." inside the outer
    trace, which is still written; no timer CSV. The port does the same."""
    argv = ["-E", "1", "--time-phases", "train", small_dataset, "1", "8"]
    with pytest.raises(RuntimeError, match="Profile has already been started. Only one profile may be run at a time."):
        cli.main(["--device", "cpu", "--profile", str(tmp_path / "port"), "--csv-dir", str(tmp_path / "pc"), *argv])
    assert os.path.getsize(tmp_path / "port" / "trace.json") > 0
    assert not os.listdir(tmp_path / "pc")
    with pytest.raises(RuntimeError, match="Profile has already been started. Only one profile may be run at a time."):
        jcli.main(["--profile", str(tmp_path / "jax"), "--csv-dir", str(tmp_path / "jc"), *argv])
    assert not os.listdir(tmp_path / "jc")


@pytest.mark.parametrize(
    "args",
    [["--time-phases"], ["--profile", "prof"], ["-P", "2", "-R", "1", "--model", "sage", "--time-phases"],
     ["-P", "2", "-R", "1", "--impl", "gather", "--profile", "prof"]],
    ids=lambda a: " ".join(a),
)
def test_cli_phase_flags_run(args, small_dataset, tmp_path, monkeypatch, capsys):
    """The flags no longer exit 2; at -P > 1 ``--time-phases`` adds no
    phase row (the JAX CLI times phases on one chip only)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "-E", "1", "--csv-dir", str(tmp_path / "csv"), *args, "train", small_dataset, "1", "8"]
    assert cli.main(argv) == 0
    keys = [k for k, _ in csv_rows(tmp_path / "csv")]
    assert any(k.startswith("phase_") for k in keys) == (args == ["--time-phases"])
