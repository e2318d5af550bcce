"""Device ms an epoch credited to the port's dense phase scopes: the
``matmul-gemm``, ``activation`` and ``residual`` phases, the loss layer and
the Adam update; nothing where no kernel is credited there."""

DENSE = ("_matmul-gemm", "_activation", "_residual", "_loss-layer", "adam-update")


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.scope_ms(lambda phase: phase.endswith(DENSE))
    return ms if ms > 0 else None
