"""The traced epochs and what is read from their device trace.

A few epochs of the cell's own step run under ``torch.profiler`` (CPU and
CUDA activity) after the measured window. Before them every card used runs
a burst of short spin kernels and goes idle, because a trace can miss its
first ~1 ms of card work; the readers leave those kernels out. The epochs
run inside one host span (:data:`WINDOW`), whose length is the traced
window.

A device event (kernel, copy, memset) is credited to a phase scope by the
rule of the port's ``xplane.attribute``: the launch is the host runtime or
driver call with the event's correlation id, and the scope is the innermost
span of that host thread, among those named like a phase, whose interval
holds the launch.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

PRIMER_KERNELS, PRIMER_CYCLES, PRIMER_EVENT = 32, 200_000, "spin_kernel"
SETTLE_S = 0.05
WINDOW = "benchmark.traced_epochs"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
PHASE_OPS = ("matmul-gemm", "matmul-spmm", "activation", "residual")
TOP = 10


def settle(devices, start: bool) -> None:
    """Every card of ``devices`` idle; at the start the primer kernels, then
    idle again; then :data:`SETTLE_S` of nothing."""
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    for c in cards:
        torch.cuda.synchronize(c)
    if start:
        for c in cards:
            with torch.cuda.device(c):
                for _ in range(PRIMER_KERNELS):
                    torch.cuda._sleep(PRIMER_CYCLES)
        for c in cards:
            torch.cuda.synchronize(c)
    time.sleep(SETTLE_S)


def is_phase(name: str) -> bool:
    """The port's phase scope names: ``<layer>_<0|1>_<op>``,
    ``<L>_loss-layer``, ``adam-update``."""
    if name == "adam-update" or name.endswith("_loss-layer"):
        return True
    parts = name.split("_")
    return len(parts) == 3 and parts[0].isdigit() and parts[1] in ("0", "1") and parts[2] in PHASE_OPS


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def merged(intervals) -> list:
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


@dataclass
class Traced:
    """The trace of ``epochs`` epochs on ``cards`` (card indices), its
    window [t0, t1] in the trace's microseconds, and ``host_s``, the
    window's length on the host clock."""

    events: list
    epochs: int
    cards: list
    t0: float
    t1: float
    host_s: float

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def device_events(self) -> list:
        """Kernels, copies and memsets that overlap the window, primers out."""
        return [e for e in self.events
                if e.get("cat") in DEVICE_CATS and PRIMER_EVENT not in e.get("name", "")
                and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e.get("dur", 0.0)) > self.t0]

    @staticmethod
    def card_of(e: dict) -> int:
        return int((e.get("args") or {}).get("device", e.get("pid", 0)))

    def intervals(self, events) -> dict:
        """{card: [(t0, t1), ...]} clipped to the window."""
        out = defaultdict(list)
        for e in events:
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), self.t1)
            if b > a:
                out[self.card_of(e)].append((a, b))
        return out

    def busy_s(self) -> dict:
        """{card: seconds in which an operation ran on it}."""
        iv = self.intervals(self.device_events())
        return {c: union_us(iv.get(c, ())) / 1e6 for c in self.cards}

    def idle_shares(self) -> dict:
        """{card: 1 - busy / window}."""
        return {c: 1.0 - b / self.window_s for c, b in self.busy_s().items()}

    def attributed(self) -> list:
        """(phase or "unattributed", device event) for every device event."""
        launches, scopes = {}, defaultdict(list)
        for e in self.events:
            cat, args = e.get("cat"), e.get("args") or {}
            if cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = ((e.get("pid"), e.get("tid")), float(e["ts"]))
            elif cat == "user_annotation" and is_phase(e.get("name", "")):
                t0 = float(e["ts"])
                scopes[(e.get("pid"), e.get("tid"))].append((t0, t0 + float(e.get("dur", 0.0)), e["name"]))
        out = []
        for e in self.device_events():
            phase = "unattributed"
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch is not None:
                thread, at = launch
                inside = [(t0, -t1, name) for t0, t1, name in scopes.get(thread, ()) if t0 <= at <= t1]
                if inside:
                    phase = max(inside)[2]
            out.append((phase, e))
        return out

    def scope_ms(self, keep) -> float:
        """Device ms an epoch credited to the phases ``keep(phase)`` accepts."""
        return sum(float(e.get("dur", 0.0)) for phase, e in self.attributed() if keep(phase)) / 1e3 / self.epochs

    def exposed_ms(self, is_copy) -> float | None:
        """Device ms an epoch of the copies ``is_copy(event)`` accepts that no
        kernel on any traced card overlaps; None where there is no such copy."""
        dev = self.device_events()
        copies = [e for e in dev if e.get("cat") == "gpu_memcpy" and is_copy(e)]
        if not copies:
            return None
        kernels = merged(iv for ivs in self.intervals([e for e in dev if e.get("cat") == "kernel"]).values()
                         for iv in ivs)
        copy_iv = merged(iv for ivs in self.intervals(copies).values() for iv in ivs)
        exposed = 0.0
        for a, b in copy_iv:
            covered = sum(max(0.0, min(b, k1) - max(a, k0)) for k0, k1 in kernels if k0 < b and k1 > a)
            exposed += (b - a) - covered
        return exposed / 1e3 / self.epochs

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the cards named by the innermost host span that holds the
        gap's middle (seconds)."""
        ops = defaultdict(float)
        for e in self.device_events():
            ops[e.get("name", "")[:160]] += float(e.get("dur", 0.0)) / 1e6
        gaps = []
        busy = self.intervals(self.device_events())
        for c in self.cards:
            edge = self.t0
            for a, b in merged(busy.get(c, ())) + [[self.t1, self.t1]]:
                if a > edge:
                    gaps.append((a - edge, edge, a, c))
                edge = max(edge, b)
        gaps = sorted(gaps, reverse=True)[:TOP]
        host = [e for e in self.events if e.get("cat") in HOST_CATS and e.get("name") != WINDOW]
        named = []
        for length, a, b, c in gaps:
            mid = (a + b) / 2
            holding = [(float(e["ts"]), e["name"]) for e in host
                       if float(e["ts"]) <= mid <= float(e["ts"]) + float(e.get("dur", 0.0))]
            what = max(holding)[1] if holding else "python, inside no op"
            label = what[:160] if len(self.cards) == 1 else f"cuda:{c} {what[:150]}"
            named.append([label, length / 1e6])
        return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]],
                "idle_gaps": named}


def trace_epochs(epoch, devices, epochs: int) -> Traced:
    """``epochs`` calls of ``epoch()`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if any(d.type == "cuda" for d in devices) else [])
    with profile(activities=acts) as prof:
        settle(devices, start=True)
        with record_function(WINDOW):
            h0 = time.perf_counter()
            for _ in range(epochs):
                epoch()
            host_s = time.perf_counter() - h0
        settle(devices, start=False)
    with tempfile.TemporaryDirectory(prefix="benchmark_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    window = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no window span")
    t0 = float(window[0]["ts"])
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    return Traced(events=events, epochs=epochs, cards=cards, t0=t0, t1=t0 + float(window[0]["dur"]), host_s=host_s)
