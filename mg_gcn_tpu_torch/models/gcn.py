"""Full-batch GCN: layers, model, forward and backward passes.

Port of ``mg_gcn_tpu/models/gcn.py``. Parameters are a list of dicts of
tensors (``W``, ``b``, and ``Wres``/``bres`` for a residual projection), the
JAX package's tree. Two differentiation modes:

* **parity** (default) — a hand-written backward reproducing the reference
  CLI's deliberate deviations from exact gradients (gcn.hpp:460-489):
  layer 0 skips its backward SpMM (``backward_spmm = (i != 1)``,
  gcn.hpp:954) and forms no input gradient; in the SpMM-first order the
  weight gradient uses the layer *input* (``lin.setX(H)``, gcn.hpp:477); the
  activation gradient reads its sign from the post-activation, post-residual
  buffer (gcn.hpp:465).
* **exact** — autograd through :func:`~..ops.spmm.aggregate`, whose backward
  multiplies by the pre-transposed matrix.

Layer schedule (gcn.hpp:437-458): if ``out <= in`` compute ``Â(HW + b)``
(linear first: the bias rides through the aggregation) else ``(ÂH)W + b``;
LeakyReLU(0.01) on every layer but the last; an optional residual (identity
when ``in == out``, else a projection) after the activation.

Each phase runs in a :func:`~..timers.scope` named with the reference's
timer key (gcn.hpp register_timer sites), the JAX package's ``named_scope``
names: ``{layer}_{0|1}_{matmul-gemm|matmul-spmm|activation|residual}`` and
``{L}_loss-layer``, from which ``--time-phases`` credits the card's time
(``diagnostics.profile_fused_step``). In the exact mode the backward runs
in autograd, outside every scope.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..nn import init as init_lib
from ..ops import elementwise as ew
from ..ops.softmax_xent import softmax_xent
from ..ops.spmm import AggPair, aggregate, spmm
from ..timers import scope


@dataclass(frozen=True)
class GCNConfig:
    """Static model configuration. ``sizes`` is the full width schedule
    [num_features, d1, ..., dL, num_labels] (main.cpp:93-98)."""

    sizes: tuple[int, ...]
    residual: bool = False
    leaky_slope: float = 0.01
    parity: bool = True  # reference-exact backward quirks
    loss_mask: str = "all"  # "all" (reference) or "train"

    @property
    def num_layers(self) -> int:
        return len(self.sizes) - 1

    def layer_meta(self, i: int) -> dict:
        in_, out = self.sizes[i], self.sizes[i + 1]
        return dict(
            in_=in_,
            out=out,
            lin_first=out <= in_,  # HW.m() == AHW.m() test, gcn.hpp:441
            activation=i + 1 < self.num_layers,  # all but last, gcn.hpp:954
            backward_spmm=i != 0,  # layer-0 skip, gcn.hpp:954
            res_proj=self.residual and in_ != out,
            res_identity=self.residual and in_ == out,
        )


def init_params(
    config: GCNConfig,
    seed: int | None = None,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> list[dict]:
    """The parameter list. ``seed=None`` uses the reference's exact init
    (every matrix from a fresh seed-99 minstd engine, bit-equal to the JAX
    package); a seed draws from a ``torch.Generator`` instead."""
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    params = []
    for i in range(config.num_layers):
        meta = config.layer_meta(i)
        in_, out = meta["in_"], meta["out"]
        names = ["W", "b"] + (["Wres", "bres"] if meta["res_proj"] else [])
        layer = {}
        for name in names:
            if gen is None:
                arr = (
                    init_lib.kaiming_uniform_ref(in_, out)
                    if name.startswith("W")
                    else init_lib.bias_ref(out)
                )
                t = torch.from_numpy(arr)
            else:
                t = (
                    init_lib.kaiming_uniform(gen, in_, out)
                    if name.startswith("W")
                    else init_lib.bias_uniform(gen, out)
                )
            layer[name] = t.to(device=device, dtype=dtype)
        params.append(layer)
    return params


def _layer_forward(layer: dict, meta: dict, pair: AggPair, h: torch.Tensor, slope: float, tag: str = "L"):
    """One GCN layer forward; returns (output, cache for the backward).
    ``tag`` (the layer index) names the phase scopes."""
    w, b = layer["W"], layer["b"]
    if meta["lin_first"]:
        with scope(f"{tag}_0_matmul-gemm"):
            hw = h @ w + b  # bias precedes aggregation, gcn.hpp:116-123
        with scope(f"{tag}_0_matmul-spmm"):
            ahw = aggregate(pair, hw)
    else:
        with scope(f"{tag}_0_matmul-spmm"):
            hw = aggregate(pair, h)
        with scope(f"{tag}_0_matmul-gemm"):
            ahw = hw @ w + b
    if meta["activation"]:
        with scope(f"{tag}_0_activation"):
            ahw = ew.leaky_relu(ahw, slope)
    if meta["res_proj"]:
        with scope(f"{tag}_0_residual"):
            ahw = ahw + h @ layer["Wres"] + layer["bres"]
    elif meta["res_identity"]:
        with scope(f"{tag}_0_residual"):
            ahw = ahw + h
    # "post" is also the activation-sign source of the parity backward: the
    # reference reuses the overwritten AHW buffer (post activation AND
    # residual) for leaky_relu_backward (gcn.hpp:465)
    return ahw, dict(h=h, post=ahw)


def forward(
    params: Sequence[dict],
    pair: AggPair,
    x: torch.Tensor,
    config: GCNConfig,
    return_caches: bool = False,
):
    """Model forward: logits (and the per-layer caches if requested)."""
    h = x
    caches = []
    for i, layer in enumerate(params):
        h, cache = _layer_forward(layer, config.layer_meta(i), pair, h, config.leaky_slope, tag=str(i))
        caches.append(cache)
    return (h, caches) if return_caches else h


def _layer_backward(
    layer: dict,
    meta: dict,
    pair: AggPair,
    cache: dict,
    g: torch.Tensor,
    slope: float,
    need_input_grad: bool,
    tag: str = "L",
):
    """Reference-parity backward of one layer (gcn.hpp:460-489). A phase
    with no work (layer 0's skipped SpMM) opens no scope, as a JAX
    named_scope around no op leaves no trace."""
    grads = {}
    t = g
    if meta["activation"]:
        with scope(f"{tag}_1_activation"):
            t = ew.leaky_relu_grad(cache["post"], g, slope)
    w = layer["W"]
    g_out = None
    if meta["lin_first"]:
        g_hw = t
        if meta["backward_spmm"]:
            with scope(f"{tag}_1_matmul-spmm"):
                g_hw = spmm(pair.bwd, t)
        with scope(f"{tag}_1_matmul-gemm"):
            grads["b"] = torch.sum(g_hw, dim=0, keepdim=True)
            grads["W"] = cache["h"].T @ g_hw
            if need_input_grad:
                g_out = g_hw @ w.T
    else:
        with scope(f"{tag}_1_matmul-gemm"):
            grads["b"] = torch.sum(t, dim=0, keepdim=True)
            # deliberate reference deviation: the layer input, not ÂH
            # (lin.setX(H), gcn.hpp:477) — the shared HW buffer is long gone
            grads["W"] = cache["h"].T @ t
            g_hw = t @ w.T if need_input_grad else None
        if need_input_grad:
            g_out = g_hw
            if meta["backward_spmm"]:
                with scope(f"{tag}_1_matmul-spmm"):
                    g_out = spmm(pair.bwd, g_hw)
    if meta["res_proj"]:
        with scope(f"{tag}_1_residual"):
            grads["bres"] = torch.sum(g, dim=0, keepdim=True)
            grads["Wres"] = cache["h"].T @ g
            if g_out is not None:
                g_out = g_out + g @ layer["Wres"].T
    elif meta["res_identity"] and g_out is not None:
        g_out = g_out + g
    return grads, g_out


def loss_and_grad_parity(
    params: Sequence[dict],
    pair: AggPair,
    x: torch.Tensor,
    y: torch.Tensor,
    config: GCNConfig,
    mask: torch.Tensor | None = None,
):
    """Reference-exact forward + manual backward: (loss, acc, grads), grads
    in the structure of params."""
    logits, caches = forward(params, pair, x, config, return_caches=True)
    with scope(f"{len(params)}_loss-layer"):
        out = softmax_xent(logits, y, mask)
    g = out.grad
    grads: list = [None] * len(params)
    for i in reversed(range(len(params))):
        grads[i], g = _layer_backward(
            params[i], config.layer_meta(i), pair, caches[i], g, config.leaky_slope,
            need_input_grad=i > 0, tag=str(i),
        )
    return out.loss, out.acc, grads


def loss_and_grad(params, pair, x, y, config: GCNConfig, mask=None):
    """Dispatch on config.parity; returns (loss, acc, grads)."""
    if config.parity:
        with torch.no_grad():
            return loss_and_grad_parity(params, pair, x, y, config, mask)
    leaves = [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in params]
    with torch.enable_grad():
        out = softmax_xent(forward(leaves, pair, x, config), y, mask)
        flat = [v for layer in leaves for v in layer.values()]
        flat_grads = iter(torch.autograd.grad(out.loss, flat))
    grads = [{k: next(flat_grads) for k in layer} for layer in leaves]
    return out.loss.detach(), out.acc.detach(), grads
