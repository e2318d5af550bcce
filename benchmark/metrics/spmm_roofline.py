"""The least time of an epoch's sparse products (harness/work.py) over the
device time an epoch credited to the port's ``*_matmul-spmm`` phase scopes,
in %; nothing where no kernel is credited there."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.scope_ms(lambda phase: phase.endswith("_matmul-spmm"))
    return 100.0 * ctx.work.products_least_s * 1e3 / ms if ms > 0 else None
