"""The share of the traced window in which no kernel, copy or memset ran on
the card, in %; the mean over the cell's cards."""


def read(ctx):
    if ctx.trace is None:
        return None
    shares = ctx.trace.idle_shares()
    if not shares:
        return None
    return 100.0 * sum(shares.values()) / len(shares)
