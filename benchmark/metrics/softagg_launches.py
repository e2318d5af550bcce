"""Products an epoch of the port's softmax aggregation (one forward, one
backward a layer): its ``softagg_launches`` counter (``timers.counters``)
summed over its keys, over the traced epochs. The counter adds only while
a profiler runs, and the traced epochs are a run's only profiled region.
Nothing where the port has no such counter or counted nothing."""


def read(ctx):
    if ctx.trace is None:
        return None
    from mg_gcn_tpu_torch import timers

    counters = getattr(timers, "counters", None)
    by_key = counters().get("softagg_launches") if counters is not None else None
    if not by_key:
        return None
    return sum(by_key.values()) / ctx.trace.epochs
