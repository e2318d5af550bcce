"""Seconds of the port's operator build, from the host CSR to the operator
on the cards, ending when every card is idle (host clock)."""


def read(ctx):
    return ctx.build_s
