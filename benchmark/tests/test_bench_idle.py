"""The readers of the spans and counters the port records while traced: the
idle split of ``harness/idle.py`` on hand-built Chrome-trace events, the
``train-step`` span's mean and the exchange counter's GB an epoch a card,
and the four entries in ``BENCHMARK.json``."""

import os
from types import SimpleNamespace

import pytest

from benchmark.harness import idle, spec
from benchmark.harness.tracing import Traced
from benchmark.tests.helpers import ROOT, run_tiny, tiny_cell

NEW = ("idle_wait_ms", "idle_host_ms", "enqueue_ms", "exchange_gb")


def _op(card, ts, dur, corr, cat="kernel"):
    return {"cat": cat, "name": f"op{corr}", "ts": ts, "dur": dur, "pid": card,
            "args": {"device": card, "correlation": corr}}


def _launch(corr, ts, dur):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": dur, "pid": 100, "tid": 1,
            "args": {"correlation": corr}}


def _trace():
    """Window [0, 1000) us, two epochs. Card 0: busy [0, 100), [200, 300),
    [400, 500), [600, 700); the gap before 200 ends at an operation launched
    before it (all wait: 100), the one before 400 at one whose launch ends
    at 350 (host 50, wait 50), the one before 600 at one with no launch
    (host 100), then the trailing gap (host 300). Card 1: a copy and a
    kernel overlapping in [0, 250), idle from 250 to 900, where two
    operations start, the earlier launched ending at 880 (host 630, wait
    20); [900, 1000) busy."""
    events = [
        _op(0, -20, 120, 1), _op(0, 200, 100, 2), _op(0, 400, 100, 3), _op(0, 600, 100, 4),
        _launch(1, -40, 5), _launch(2, 20, 30), _launch(3, 300, 50),
        _op(1, 0, 200, 5, "gpu_memcpy"), _op(1, 50, 200, 6), _op(1, 900, 100, 7), _op(1, 900, 50, 8),
        _launch(5, -30, 5), _launch(6, 10, 5), _launch(7, 860, 20), _launch(8, 870, 20),
        _op(0, 1100, 50, 9),  # after the window
        {"cat": "kernel", "name": "spin_kernel", "ts": 150, "dur": 20, "pid": 0, "args": {"device": 0}},
    ]
    return Traced(events=events, epochs=2, cards=[0, 1], t0=0.0, t1=1000.0, host_s=1e-3)


def test_idle_split_on_hand_built_events():
    traced = _trace()
    assert idle.split_us(traced) == {0: (450.0, 150.0), 1: (630.0, 20.0)}
    for c, (host, wait) in idle.split_us(traced).items():
        assert host + wait == pytest.approx(traced.idle_shares()[c] * traced.window_s * 1e6)
    host_ms, wait_ms = idle.mean_ms(traced)
    assert host_ms == pytest.approx((450 + 630) / 2 / 1e3 / 2) and wait_ms == pytest.approx((150 + 20) / 2 / 1e3 / 2)
    ctx = SimpleNamespace(trace=traced)
    assert spec.load_module(ROOT, "metrics", "idle_host_ms").read(ctx) == pytest.approx(host_ms)
    assert spec.load_module(ROOT, "metrics", "idle_wait_ms").read(ctx) == pytest.approx(wait_ms)


def test_idle_split_of_a_card_with_nothing_on_it():
    traced = Traced(events=[], epochs=1, cards=[0], t0=0.0, t1=500.0, host_s=5e-4)
    assert idle.split_us(traced) == {0: (500.0, 0.0)}
    assert idle.mean_ms(Traced(events=[], epochs=1, cards=[], t0=0.0, t1=5.0, host_s=0.0)) is None


def test_enqueue_ms_is_the_mean_train_step_span():
    spans = [{"cat": "user_annotation", "name": "train-step", "ts": t, "dur": d, "pid": 1, "tid": 1}
             for t, d in ((0, 3000), (5000, 5000))]
    other = {"cat": "user_annotation", "name": "exchange", "ts": 10, "dur": 10_000, "pid": 1, "tid": 1}
    read = spec.load_module(ROOT, "metrics", "enqueue_ms").read
    traced = Traced(events=spans + [other], epochs=2, cards=[0], t0=0.0, t1=1e4, host_s=0.01)
    assert read(SimpleNamespace(trace=traced)) == pytest.approx(4.0)
    assert read(SimpleNamespace(trace=Traced([other], 2, [0], 0.0, 1e4, 0.01))) is None
    assert read(SimpleNamespace(trace=None)) is None


def test_exchange_gb_divides_by_epochs_and_cards(monkeypatch):
    from mg_gcn_tpu_torch import timers

    read = spec.load_module(ROOT, "metrics", "exchange_gb").read
    ctx = SimpleNamespace(trace=Traced([], 3, [0, 1, 2, 3], 0.0, 1.0, 1.0))
    monkeypatch.setattr(timers, "counters", lambda: {"exchange_bytes": {0: 7e9, 1: 5e9}})
    assert read(ctx) == pytest.approx(12 / 3 / 4)
    monkeypatch.setattr(timers, "counters", lambda: {})
    assert read(ctx) is None
    monkeypatch.delattr(timers, "counters")  # a port without the counter
    assert read(ctx) is None


def test_new_entries_follow_the_rules():
    bench = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    assert spec.problems(bench, ROOT) == []
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert [m["name"] for m in bench["per_layer"][-4:]] == list(NEW)
    assert entries["exchange_gb"]["workloads"] == ["gcn-reddit-p4-uniform"]
    for w in bench["workloads"]:
        names = {m["name"] for m in spec.load_cell(ROOT, w["name"], bench).per_layer}
        assert {"idle_wait_ms", "idle_host_ms", "enqueue_ms"} <= names


def test_tiny_four_partition_run_reads_its_steps():
    """Traced on the CPU (no card, so no device metric), the four-partition
    cell reads the ``train-step`` spans of its traced epochs."""
    out = run_tiny(tiny_cell("gcn-reddit-p4-uniform"), trace=True)
    assert out["correct"]
    assert out["metrics"]["enqueue_ms"]["value"] > 0
    assert not {"idle_wait_ms", "idle_host_ms", "exchange_gb"} & set(out["metrics"])
