"""Single-card training: the aggregation pair, the train step and the epoch
loop.

Port of ``mg_gcn_tpu/train.py:121-432`` (the reference's single-GPU path,
main.cpp:113-133): per epoch ``forward -> backward -> update -> sync``,
printing ``epoch loss acc seconds`` to stderr. PyTorch runs eagerly, so the
step is a plain function; nothing is compiled.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from . import resolve_device, sparse
from .formats import CSRData, Dataset
from .models.gcn import GCNConfig, init_params, loss_and_grad
from .nn import adam
from .ops import spmm_pattern
from .ops.spmm import AggPair, COOMat
from .timers import TimerRegistry

# engines of the JAX package that later slices port, by ROADMAP item
LATER_IMPLS = {
    "block": "ROADMAP queue 2 item 3 (block-sparse pattern kernels)",
    "edge": "ROADMAP queue 2 items 4-5 (edge-tile kernels)",
    "gather": "ROADMAP queue 2 item 6 (serial-gather kernel)",
    "pallas": "ROADMAP queue 2 item 10 (tiled-ELL kernel)",
    "halo": "ROADMAP queue 1 item 9 (distributed training)",
}


def build_agg_pair(
    graph: CSRData,
    impl: str = "auto",
    pattern_dtype: str = "bfloat16",
    device: str | torch.device = "cuda",
) -> AggPair:
    """Host preprocessing -> the device-resident (Âᵀ, Â) aggregation pair
    (gcn ctor, gcn.hpp:946-954: column-normalize A by in-degree, transpose;
    forward multiplies by Âᵀ, backward by Â).

    impl:
      "auto"    — on CUDA, a binary adjacency whose n_pad²/8 pack fits the
                  card's budget takes "pattern", a weighted one or one too
                  large "xla"; one stderr line names the engine. On the
                  CPU: "xla".
      "pattern" — the bit-packed dense-pattern kernel pair.
      "xla"     — the COO engine (index_select + index_add_).
    """
    dev = resolve_device(device)
    if impl in LATER_IMPLS:
        raise NotImplementedError(f"impl {impl!r} is not ported yet: {LATER_IMPLS[impl]}")
    if impl not in ("auto", "pattern", "xla"):
        raise ValueError(f"unknown aggregation impl {impl!r} (expected auto/pattern/xla)")
    if impl == "auto":
        if dev.type == "cuda":
            if spmm_pattern.pattern_feasible(graph, dev):
                impl = "pattern"
                why = "binary adjacency, bit pack fits the card"
            else:
                impl = "xla"
                why = "weighted adjacency, or bit pack over the card's budget"
            print(f"aggregation engine: {impl} (auto: {why})", file=sys.stderr)
        else:
            impl = "xla"
    if impl == "pattern":
        fwd, bwd = spmm_pattern.pattern_pair_from_binary_csr(graph, dtype=pattern_dtype, device=dev)
        return AggPair(fwd=fwd, bwd=bwd)
    a = sparse.normalize(graph, axis=True)
    return AggPair(fwd=COOMat.from_csr(sparse.transpose(a), device=dev), bwd=COOMat.from_csr(a, device=dev))


def make_train_step(
    config: GCNConfig, hparams: dict | None = None, optimizer: str = "adam"
) -> Callable:
    """The full GCN train step:
    (params, opt_state, pair, x, y, mask) -> (params, opt_state, loss, acc)."""
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    hp = dict(adam.DEFAULT_HPARAMS)
    if hparams:
        hp.update(hparams)

    def step(params, opt_state, pair, x, y, mask):
        loss, acc, grads = loss_and_grad(params, pair, x, y, config, mask)
        with torch.no_grad():
            if optimizer == "adam":
                params, opt_state = adam.adam_update(params, grads, opt_state, **hp)
            else:
                params = adam.sgd_update(params, grads, hp["lr"], hp["weight_decay"])
        return params, opt_state, loss, acc

    return step


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)
    accs: list = field(default_factory=list)
    epoch_seconds: list = field(default_factory=list)
    params: Any = None
    opt_state: Any = None
    engine: str = ""  # the aggregation engine the run used


def train(
    dataset: Dataset,
    hidden: list[int],
    epochs: int = 20,
    hparams: dict | None = None,
    config_kw: dict | None = None,
    impl: str = "xla",
    pattern_dtype: str = "bfloat16",
    seed: int | None = None,
    log: bool = True,
    timers: TimerRegistry | None = None,
    params: Any = None,
    opt_state: Any = None,
    f64: bool = False,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Full-batch training on one card (or the CPU with ``device="cpu"``).

    ``hidden`` is the list of hidden widths; the size schedule becomes
    [num_features, *hidden, num_labels] (main.cpp:93-98). ``seed=None`` uses
    the reference's bit-exact seed-99 init.
    """
    if f64:
        raise NotImplementedError("f64 mode is not ported yet: ROADMAP queue 1 item 4b")
    dev = resolve_device(device)
    sizes = (dataset.num_features, *hidden, dataset.num_labels)
    config = GCNConfig(sizes=tuple(int(s) for s in sizes), **(config_kw or {}))
    pair = build_agg_pair(dataset.graph, impl=impl, pattern_dtype=pattern_dtype, device=dev)
    x = torch.from_numpy(np.ascontiguousarray(dataset.features, np.float32)).to(dev)
    y = torch.from_numpy(dataset.labels.reshape(-1).astype(np.int64)).to(dev)
    mask = None
    if config.loss_mask == "train":
        mask = torch.from_numpy(dataset.sets.reshape(-1) == 0).to(dev)
    if params is None:
        params = init_params(config, seed, device=dev)
    if opt_state is None:
        opt_state = adam.adam_init(params)
    step = make_train_step(config, hparams)

    result = TrainResult(
        engine="pattern" if isinstance(pair.fwd, spmm_pattern.PatternMat) else "xla"
    )
    for e in range(epochs):
        t0 = time.perf_counter()
        params, opt_state, loss, acc = step(params, opt_state, pair, x, y, mask)
        loss, acc = float(loss), float(acc)  # waits for the card, like ctx.sync()
        dt = time.perf_counter() - t0
        result.losses.append(loss)
        result.accs.append(acc)
        result.epoch_seconds.append(dt)
        if timers is not None:
            timers.record(f"{e}_0_epoch", dt * 1e3)
        if log:
            print(f"{e} {loss} {acc} {dt}", file=sys.stderr)
    result.params, result.opt_state = params, opt_state
    return result
