"""The mean host ms of the port's ``train-step`` span over the traced
epochs: the host's time to issue one epoch's work, from the step's call to
its return, before the loss is read back; nothing where the port opens no
such span."""

STEP = "train-step"


def read(ctx):
    if ctx.trace is None:
        return None
    spans = [float(e.get("dur", 0.0)) for e in ctx.trace.events
             if e.get("cat") == "user_annotation" and e.get("name") == STEP]
    return sum(spans) / len(spans) / 1e3 if spans else None
