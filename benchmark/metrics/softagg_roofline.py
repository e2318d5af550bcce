"""The least time of an epoch's softmax aggregation (the family's work
count, ``softagg_least_s``: each layer's forward and backward pass at the
bf16 peak or the HBM rate) over the device time an epoch credited to the
port's ``*_matmul-spmm`` phase scopes, in %; nothing where the work has no
softmax aggregation or no kernel is credited there."""


def read(ctx):
    least_s = getattr(ctx.work, "softagg_least_s", None)
    if ctx.trace is None or not least_s:
        return None
    ms = ctx.trace.scope_ms(lambda phase: phase.endswith("_matmul-spmm"))
    return 100.0 * least_s * 1e3 / ms if ms > 0 else None
