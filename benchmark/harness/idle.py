"""Each card's idle time in the traced window, split by what it waited on.

The idle gaps are those of ``Traced.idle_shares``: between a card's merged
device intervals (kernels, copies, memsets, primers out) clipped to the
window. A gap [a, b) ends when the operation that starts at b starts; its
launch is the host runtime or driver call that carries the operation's
correlation id. Until that call returned the card waited on the host;
after it the operation was queued, and the card waited on another stream
or another card:

    host = clamp(min(b, launch_end) - a, 0, b - a)      wait = (b - a) - host

A gap after the card's last operation, and a gap whose operation has no
launch in the trace, is the host's whole. Where several operations start
at b, the one launched first ends the gap. On every card host + wait is
the idle time that ``idle_shares`` reads.
"""

from __future__ import annotations

from collections import defaultdict

from benchmark.harness.tracing import LAUNCH_CATS

NO_LAUNCH = float("inf")


def split_us(traced) -> dict:
    """{card: (host us, wait us)} over the traced window, for every card of
    ``traced.cards``."""
    launch_end = {}
    for e in traced.events:
        args = e.get("args") or {}
        if e.get("cat") in LAUNCH_CATS and "correlation" in args:
            launch_end[args["correlation"]] = float(e["ts"]) + float(e.get("dur", 0.0))
    ops = defaultdict(list)
    for e in traced.device_events():
        a = max(float(e["ts"]), traced.t0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), traced.t1)
        if b > a:
            launched = launch_end.get((e.get("args") or {}).get("correlation"), NO_LAUNCH)
            ops[traced.card_of(e)].append((a, launched, b))
    out = {}
    for c in traced.cards:
        host = wait = 0.0
        edge = traced.t0
        for a, launched, b in sorted(ops.get(c, ())) + [(traced.t1, NO_LAUNCH, traced.t1)]:
            if a > edge:
                gap = a - edge
                h = gap if launched == NO_LAUNCH else min(max(min(a, launched) - edge, 0.0), gap)
                host += h
                wait += gap - h
            edge = max(edge, b)
        out[c] = (host, wait)
    return out


def mean_ms(traced) -> tuple[float, float] | None:
    """(host ms, wait ms) an epoch, the mean over the cards; None without
    a card."""
    split = split_us(traced)
    if not split:
        return None
    cards, per = len(split), 1e3 * traced.epochs
    return (sum(h for h, _ in split.values()) / cards / per, sum(w for _, w in split.values()) / cards / per)
