"""What the harness asks of a family's driver: one object holding the port's
train step, its parameters and its optimizer state, built once and driven
through the first steps and then the measured window."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness.params import flatten


def sync(devices) -> None:
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def host_csr(graph):
    """The graph as the port's host ``formats.CSRData`` (binary values)."""
    from mg_gcn_tpu_torch.formats import CSRData

    return CSRData(indptr=graph.indptr, indices=graph.indices,
                   data=np.ones(graph.nnz, np.float32), shape=(graph.n, graph.n))


def hparams(config: dict) -> dict:
    o = config["optimizer"]
    return dict(lr=o["lr"], beta1=o["beta1"], beta2=o["beta2"], weight_decay=o["weight_decay"], eps=o["eps"])


class Trainer:
    """``step(params, state, *args) -> (params, state, loss, acc)``, the
    port's step, called once an epoch with the loss and accuracy read back,
    as the port's CLI loop (``cli._run_epochs``) calls it."""

    build_s: float = 0.0
    engine: str = ""

    def __init__(self, step, params, state, args: tuple, devices):
        self.step, self.params, self.state, self.args, self.devices = step, params, state, args, devices

    def epoch(self) -> tuple[float, float]:
        self.params, self.state, loss, acc = self.step(self.params, self.state, *self.args)
        return float(loss), float(acc)

    def replica(self, tree):
        """The first replica of a replicated tree (a list of per-card copies)."""
        return tree

    def flat_params(self) -> dict:
        return flatten(self.replica(self.params))

    def first_moment(self) -> dict:
        return flatten(self.replica(self.state).m)

    def close(self) -> None:
        self.step = self.params = self.state = self.args = None


def timed_build(build, devices):
    """(build(), seconds), the clock stopped after every card is idle."""
    t0 = time.perf_counter()
    out = build()
    sync(devices)
    return out, time.perf_counter() - t0
