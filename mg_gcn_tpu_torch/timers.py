"""Per-phase timing registry with CSV export (port of the JAX package's
``timers.TimerRegistry``; reference matrix.hpp:107-157, one
``prefix+name:ms`` line per timer). The profiler ``trace`` hook waits for
the phase-timing slice (ROADMAP queue 1 item 8)."""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Iterator, TextIO


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
