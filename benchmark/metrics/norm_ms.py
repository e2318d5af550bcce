"""Device ms an epoch credited to the port's ``*_activation`` phase scopes
(DeeperGCN's BatchNorm and ReLU, forward and the backward the BatchNorm op
scopes on autograd's thread); nothing where no kernel is credited
there."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.scope_ms(lambda phase: phase.endswith("_activation"))
    return ms if ms > 0 else None
