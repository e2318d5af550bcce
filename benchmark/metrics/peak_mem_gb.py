"""``torch.cuda.max_memory_allocated`` of the fullest card, from the port's
build (after the benchmark made its inputs) to the window's end, in GB."""


def read(ctx):
    return ctx.peak_bytes / 1e9
