"""Device time by phase scope from a ``torch.profiler`` trace.

The counterpart of ``mg_gcn_tpu/xplane.py``, under its name so a reader
finds it: that module decodes ``jax.profiler``'s XPlane protobufs, this one
reads torch.profiler's events (the Chrome-trace events of
``export_chrome_trace``), not XPlane protobufs. It powers the fused-step
``--time-phases`` breakdown (the reference's CUDA-event ``epoch_gpu_phase``
CSV, matrix.hpp:107-157) without taking the step apart.

The rule is the JAX module's (``mg_gcn_tpu/xplane.py:150-165``): each device
event (a kernel, copy or memset on the card) is credited to the innermost
phase scope (a ``record_function`` span whose name :func:`_looks_like_phase`)
that launched it, anything else to ``"unattributed"``. The launch is the
host's runtime or driver call that carries the device event's correlation
id; the scope is the innermost phase span of that host thread whose
interval contains the call. So a kernel that starts on the card after its
scope has closed on the host still counts to the scope, and device time is
never matched to host spans by overlap.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def trace_events(prof, trace_dir: str | None = None) -> list[dict]:
    """The Chrome-trace events of a finished ``torch.profiler.profile``
    (which exports its trace once: ``trace_dir`` keeps it there as
    ``trace.json``); a list of events is returned as it is."""
    if isinstance(prof, list):
        return prof
    with tempfile.TemporaryDirectory(prefix="mggcn_phases_") as tmp:
        path = os.path.join(trace_dir or tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]


def device_events(events: list[dict]) -> list[dict]:
    """The device events of a trace (kernels, copies, memsets), without the
    primer kernels ``timers.settle_profiler`` puts before the traced work."""
    from .timers import PRIMER_EVENT

    return [e for e in events if e.get("cat") in DEVICE_CATS and PRIMER_EVENT not in e.get("name", "")]


def attribute(events: list[dict]) -> list[tuple[str, dict]]:
    """(phase key or ``"unattributed"``, event) for every device event of
    :func:`device_events`, in trace order."""
    launches = {}
    scopes = defaultdict(list)
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = ((e.get("pid"), e.get("tid")), float(e["ts"]))
        elif cat == "user_annotation" and _looks_like_phase(e.get("name", "")):
            t0 = float(e["ts"])
            scopes[(e.get("pid"), e.get("tid"))].append((t0, t0 + float(e.get("dur", 0.0)), e["name"]))
    out = []
    for e in device_events(events):
        phase = "unattributed"
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            thread, at = launch
            # spans on one thread nest: the innermost holding the launch
            # starts last (and, started together, ends first)
            inside = [(t0, -t1, name) for t0, t1, name in scopes.get(thread, ()) if t0 <= at <= t1]
            if inside:
                phase = max(inside)[2]
        out.append((phase, e))
    return out


def device_time_by_scope(prof) -> dict[str, float]:
    """Device milliseconds by phase key (and ``"unattributed"``) of a
    finished ``torch.profiler.profile`` or of its trace events; empty when
    the trace holds no device event (a trace of the CPU only)."""
    totals: dict[str, float] = defaultdict(float)
    for phase, e in attribute(trace_events(prof)):
        totals[phase] += float(e.get("dur", 0.0)) / 1e3
    return dict(totals)


def _looks_like_phase(comp: str) -> bool:
    """Phase keys follow the reference timer naming (gcn.hpp register_timer):
    '<layer>_<0|1>_<op>', '<L>_loss-layer', 'adam-update'."""
    if comp == "adam-update" or comp.endswith("_loss-layer"):
        return True
    parts = comp.split("_")
    return (
        len(parts) == 3
        and parts[0].isdigit()
        and parts[1] in ("0", "1")
        and parts[2] in ("matmul-gemm", "matmul-spmm", "activation", "residual")
    )
