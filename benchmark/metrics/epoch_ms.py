"""The window's wall time over the epochs completed in it (host clock)."""


def read(ctx):
    return ctx.epoch_s * 1e3
