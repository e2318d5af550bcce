"""Device idle ms an epoch in which the card's next operation was not yet
launched, so the card waited on the host (``harness/idle.py``); the mean
over the cell's cards. With ``idle_wait_ms`` it makes up the idle time that
``idle_share`` reads."""

from benchmark.harness import idle


def read(ctx):
    if ctx.trace is None:
        return None
    split = idle.mean_ms(ctx.trace)
    return None if split is None else split[0]
