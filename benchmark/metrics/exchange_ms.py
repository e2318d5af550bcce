"""Device ms an epoch of copies between cards (peer copies) during which no
kernel ran on any of the cell's cards: the exchange's exposed time;
nothing where the trace holds no peer copy."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.exposed_ms(lambda e: "PtoP" in e.get("name", ""))
