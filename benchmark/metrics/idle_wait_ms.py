"""Device idle ms an epoch in which the card's next operation was already
queued, so the card waited on another stream or card (``harness/idle.py``);
the mean over the cell's cards."""

from benchmark.harness import idle


def read(ctx):
    if ctx.trace is None:
        return None
    split = idle.mean_ms(ctx.trace)
    return None if split is None else split[1]
