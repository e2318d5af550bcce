"""Per-phase timing registry with CSV export (port of the JAX package's
``timers.py``; reference matrix.hpp:107-157, one ``prefix+name:ms`` line per
timer), the phase scopes of the model step (:func:`scope`, the counterpart
of ``jax.named_scope``) and the ``--profile`` trace (:func:`trace`)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Iterator, TextIO

import torch

_NO_SCOPE = contextlib.nullcontext()


class TimerRegistry:
    def __init__(self) -> None:
        self._entries: "OrderedDict[str, float]" = OrderedDict()

    def record(self, name: str, milliseconds: float) -> None:
        self._entries[name] = self._entries.get(name, 0.0) + milliseconds

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1e3)

    def dump(self, out: TextIO, prefix: str = "") -> None:
        """matrix.hpp:150-157 format: one ``<prefix><name>:<ms>`` per line."""
        for name, ms in self._entries.items():
            out.write(f"{prefix}{name}:{ms}\n")


def scope(name: str):
    """A ``torch.profiler.record_function`` span named ``name`` while a
    profiler runs, else a shared no-op: the phase scopes sit on the hot path
    and cost one flag read when nothing traces."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SCOPE


def profiler_activities() -> list:
    """The CPU, and the card where there is one."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


# A trace can miss the first device events after its profiler starts: in a
# long-lived process the first ~1 ms of card work of every trace, however
# long the profiler ran idle before it (chip_smoke phase 10 counts them).
# settle_profiler puts PRIMER_KERNELS short spin kernels (PRIMER_CYCLES
# clock cycles each; PRIMER_EVENT in their event name) there instead, and
# the trace readers (xplane.device_events) leave them out.
PRIMER_KERNELS, PRIMER_CYCLES, PRIMER_EVENT = 32, 200_000, "spin_kernel"
# seconds the card is left idle after the primer and before a profiler stops
PROFILER_SETTLE_S = 0.05


def settle_profiler(start: bool = True) -> None:
    """Called just after a profiler starts (``start``) and again just
    before it stops: the card idle; at the start the primer kernels, then
    the card idle again; then :data:`PROFILER_SETTLE_S`. So the trace holds
    the traced work's first and last device events. Nothing without a
    card."""
    if not torch.cuda.is_available():
        return
    torch.cuda.synchronize()
    if start:
        for _ in range(PRIMER_KERNELS):
            torch.cuda._sleep(PRIMER_CYCLES)
        torch.cuda.synchronize()
    time.sleep(PROFILER_SETTLE_S)


@contextlib.contextmanager
def trace(log_dir: str | None) -> Iterator[None]:
    """Optional ``torch.profiler`` trace (host and card) around a region,
    written into ``log_dir`` as a Chrome trace (``trace.json``), also when
    the region raises, as ``jax.profiler.trace`` writes its own."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=profiler_activities())
    try:
        with prof:
            settle_profiler()
            try:
                yield
            finally:
                settle_profiler(start=False)
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
