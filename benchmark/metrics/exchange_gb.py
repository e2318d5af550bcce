"""GB an epoch a card that the port's exchange moved between partitions:
its ``exchange_bytes`` counter (``timers.counters``), over the traced
epochs and the cell's cards. The counter adds only while a profiler runs,
and the traced epochs are a run's only profiled region. Nothing where the
port has no such counter or counted nothing."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.cards:
        return None
    from mg_gcn_tpu_torch import timers

    counters = getattr(timers, "counters", None)
    by_part = counters().get("exchange_bytes") if counters is not None else None
    if not by_part:
        return None
    return sum(by_part.values()) / ctx.trace.epochs / len(ctx.trace.cards) / 1e9
