"""Per-phase device timing breakdown (port of ``mg_gcn_tpu/diagnostics.py``).

The reference instruments every op with CUDA-event pairs and dumps
``epoch_gpu_phase`` timings to CSV (matrix.hpp:107-157, main.cpp:111). Two
equivalents here:

* :func:`profile_fused_step` (the ``--time-phases`` default): runs the real
  train step under ``torch.profiler`` and credits the card's kernel time to
  the reference's timer keys through the phase scopes of models/gcn.py
  (:func:`..xplane.device_time_by_scope`);
* :func:`profile_epoch` (fallback, where the trace holds no device event, as
  on the CPU): each phase run on its own and timed on the host clock, the
  card synchronized after each.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import torch

from .models.gcn import GCNConfig
from .ops import elementwise as ew
from .ops.softmax_xent import softmax_xent
from .ops.spmm import AggPair, spmm
from .timers import TimerRegistry, profiler_activities, settle_profiler


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def profile_fused_step(
    step_fn,
    args: tuple,
    timers: TimerRegistry | None = None,
    prefix: str = "phase_",
    epochs: int = 2,
    trace_dir: str | None = None,
):
    """Trace ``epochs`` calls of the real train step and record per-phase
    device milliseconds (averaged per epoch) under the reference timer keys.
    ``step_fn(*args)`` returns updated (params, opt_state, loss, ...); the
    first two are fed back. One warm step runs outside the trace, which
    starts and ends settled (:func:`~mg_gcn_tpu_torch.timers.settle_profiler`). Returns
    ``(timers, params, opt_state)``; no phase entry is added when the trace
    holds no device event (the caller may fall back to
    :func:`profile_epoch`). ``trace_dir`` also keeps the Chrome trace there.
    A profiler already running is refused, as ``jax.profiler`` refuses a
    second trace."""
    from .xplane import device_time_by_scope, trace_events

    if torch.autograd._profiler_enabled():
        raise RuntimeError("Profile has already been started. Only one profile may be run at a time.")
    timers = timers or TimerRegistry()
    params, opt_state, *rest_args = args
    out = step_fn(params, opt_state, *rest_args)
    params, opt_state = out[0], out[1]
    _sync(out[2])
    with torch.profiler.profile(activities=profiler_activities()) as prof:
        settle_profiler()
        for _e in range(epochs):
            out = step_fn(params, opt_state, *rest_args)
            params, opt_state = out[0], out[1]
            _sync(out[2])
        settle_profiler(start=False)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    totals = device_time_by_scope(trace_events(prof, trace_dir))
    for name, ms in sorted(totals.items()):
        timers.record(prefix + name, ms / epochs)
    return timers, params, opt_state


def _timed(timers: TimerRegistry, name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(out if isinstance(out, torch.Tensor) else out.grad)
    timers.record(name, (time.perf_counter() - t0) * 1e3)
    return out


def profile_epoch(
    params: Sequence[dict],
    pair: AggPair,
    x: torch.Tensor,
    y: torch.Tensor,
    config: GCNConfig,
    timers: TimerRegistry | None = None,
    prefix: str = "0_",
) -> TimerRegistry:
    """Run one un-fused, phase-timed epoch (forward + parity backward).

    Phase names mirror the reference timer keys: ``<layer>_0_matmul-gemm``,
    ``<layer>_0_matmul-spmm``, ``<layer>_0_activation``, ``loss-layer``,
    ``<layer>_1_*`` for backward (gcn.hpp naming), with the backward GEMM
    split into ``_gb``, ``_gw`` and ``_gout``; layer 0 has no backward SpMM.
    Residual projections are not replayed, as in the JAX package.
    """
    timers = timers or TimerRegistry()
    slope = config.leaky_slope
    _sync(x)

    def lin(h, w, b):
        return h @ w + b

    def act(h):
        return ew.leaky_relu(h, slope)

    def act_bwd(p, g):
        return ew.leaky_relu_grad(p, g, slope)

    def colsum(g):
        return torch.sum(g, dim=0, keepdim=True)

    def mat_t(a, b):
        return a.T @ b

    def mat_nt(a, b):
        return a @ b.T

    with torch.no_grad():
        h = x
        caches = []
        for i, layer in enumerate(params):
            meta = config.layer_meta(i)
            name = f"{prefix}{i}_0"
            if meta["lin_first"]:
                hw = _timed(timers, f"{name}_matmul-gemm", lin, h, layer["W"], layer["b"])
                ahw = _timed(timers, f"{name}_matmul-spmm", spmm, pair.fwd, hw)
            else:
                hw = _timed(timers, f"{name}_matmul-spmm", spmm, pair.fwd, h)
                ahw = _timed(timers, f"{name}_matmul-gemm", lin, hw, layer["W"], layer["b"])
            if meta["activation"]:
                ahw = _timed(timers, f"{name}_activation", act, ahw)
            caches.append(dict(h=h, post=ahw))
            h = ahw

        g = _timed(timers, f"{prefix}loss-layer", softmax_xent, h, y).grad
        for i in reversed(range(len(params))):
            meta = config.layer_meta(i)
            name = f"{prefix}{i}_1"
            layer, cache = params[i], caches[i]
            t = g
            if meta["activation"]:
                t = _timed(timers, f"{name}_activation", act_bwd, cache["post"], g)
            if meta["lin_first"]:
                g_hw = _timed(timers, f"{name}_matmul-spmm", spmm, pair.bwd, t) if meta["backward_spmm"] else t
                _timed(timers, f"{name}_gb", colsum, g_hw)
                _timed(timers, f"{name}_gw", mat_t, cache["h"], g_hw)
                g = _timed(timers, f"{name}_gout", mat_nt, g_hw, layer["W"]) if i > 0 else None
            else:
                _timed(timers, f"{name}_gb", colsum, t)
                _timed(timers, f"{name}_gw", mat_t, cache["h"], t)
                if i > 0:
                    g_hw = _timed(timers, f"{name}_gout", mat_nt, t, layer["W"])
                    g = (_timed(timers, f"{name}_matmul-spmm", spmm, pair.bwd, g_hw)
                         if meta["backward_spmm"] else g_hw)
    return timers
