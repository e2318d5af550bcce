"""Seconds from the start of ``run.py`` to the first timed epoch (host clock):
inputs, the port's build, kernel builds or loads, the first steps."""


def read(ctx):
    return ctx.setup_s
