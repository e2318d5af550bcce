"""The least time of an epoch's work on the cards (harness/work.py: the
products at the aggregation dtype's peak or the HBM rate, the dense
products at the dense dtype's peak) over the measured window's epoch time,
in %. Elementwise work is not counted: a floor."""


def read(ctx):
    return 100.0 * ctx.work.least_s / ctx.epoch_s
