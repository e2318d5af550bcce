"""Device ms an epoch credited to the port's ``*_matmul-spmm`` phase scopes
(DeeperGCN's softmax aggregation: the column shift, the weights, the
operand, the product and the division forward, and the backward product
the aggregation op scopes on autograd's thread); nothing where no kernel
is credited there."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.scope_ms(lambda phase: phase.endswith("_matmul-spmm"))
    return ms if ms > 0 else None
