"""Device ms an epoch credited to the port's ``*_matmul-spmm`` phase scopes
(the attention: each head's scores, softmax and weighted aggregation, and
the backward products the attention ops scope on autograd's thread);
nothing where no kernel is credited there."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.scope_ms(lambda phase: phase.endswith("_matmul-spmm"))
    return ms if ms > 0 else None
