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

The layer stack is written once, over a list of row blocks with the
aggregation as a callable over the list (:func:`forward_blocks`,
:func:`loss_and_grad_parity_blocks`): the one-card model is the case of one
block, and the row-partitioned step (``parallel/dist.py``) passes one block
a partition, its exchange-carrying products and its partition-summed loss.

Each phase runs in a :func:`~..timers.scope` named with the reference's
timer key (gcn.hpp register_timer sites), the JAX package's ``named_scope``
names: ``{layer}_{0|1}_{matmul-gemm|matmul-spmm|activation|residual}`` and
``{L}_loss-layer``, each around the loop over the blocks, from which
``--time-phases`` credits the card's time
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


def _layer_forward(layers, meta: dict, agg_fwd, hs, slope: float, tag: str = "L"):
    """One GCN layer on every block; ``layers[j]`` is the layer's
    parameters block j computes with and ``agg_fwd`` maps the blocks to
    their aggregated blocks. Returns (outputs, cache for the backward).
    ``tag`` (the layer index) names the phase scopes, each around the loop
    over the blocks."""
    if meta["lin_first"]:
        with scope(f"{tag}_0_matmul-gemm"):
            hw = [h @ lp["W"] + lp["b"] for h, lp in zip(hs, layers)]  # bias precedes aggregation, gcn.hpp:116-123
        with scope(f"{tag}_0_matmul-spmm"):
            ahw = agg_fwd(hw)
        del hw
    else:
        with scope(f"{tag}_0_matmul-spmm"):
            ah = agg_fwd(hs)
        with scope(f"{tag}_0_matmul-gemm"):
            ahw = [a @ lp["W"] + lp["b"] for a, lp in zip(ah, layers)]
        del ah
    if meta["activation"]:
        with scope(f"{tag}_0_activation"):
            ahw = [ew.leaky_relu(a, slope) for a in ahw]
    if meta["res_proj"]:
        with scope(f"{tag}_0_residual"):
            ahw = [a + h @ lp["Wres"] + lp["bres"] for a, h, lp in zip(ahw, hs, layers)]
    elif meta["res_identity"]:
        with scope(f"{tag}_0_residual"):
            ahw = [a + h for a, h in zip(ahw, hs)]
    # "post" is also the activation-sign source of the parity backward: the
    # reference reuses the overwritten AHW buffer (post activation AND
    # residual) for leaky_relu_backward (gcn.hpp:465)
    return ahw, dict(h=hs, post=ahw)


def forward_blocks(params: Sequence, agg_fwd, xs, config: GCNConfig, return_caches: bool = False):
    """The layer stack over blocks of rows: ``params[j]`` is the parameter
    list block j computes with, ``xs[j]`` its input rows, and ``agg_fwd``
    maps the blocks to their aggregated blocks (one block on one card, one
    a partition in ``parallel/dist.py``). The blocks' logits (and the
    per-layer caches if requested)."""
    hs, caches = xs, []
    for i in range(config.num_layers):
        hs, cache = _layer_forward([p[i] for p in params], config.layer_meta(i), agg_fwd, hs, config.leaky_slope,
                                   tag=str(i))
        caches.append(cache)
    return (hs, caches) if return_caches else hs


def _one_block(pair: AggPair):
    """(agg_fwd, agg_bwd) of the one-card pair on a list of one block."""
    return (lambda hs: [aggregate(pair, h) for h in hs]), (lambda gs: [spmm(pair.bwd, g) for g in gs])


def forward(
    params: Sequence[dict],
    pair: AggPair,
    x: torch.Tensor,
    config: GCNConfig,
    return_caches: bool = False,
):
    """Model forward: logits (and the per-layer caches if requested)."""
    hs, caches = forward_blocks([params], _one_block(pair)[0], [x], config, return_caches=True)
    if not return_caches:
        return hs[0]
    return hs[0], [{k: v[0] for k, v in cache.items()} for cache in caches]


def _layer_backward(layers, meta: dict, agg_bwd, cache: dict, gs, slope: float, need_input_grad: bool,
                    tag: str = "L"):
    """Reference-parity backward of one layer on every block
    (gcn.hpp:460-489): the blocks' gradients (the caller sums them) and
    their input gradients. A phase with no work (layer 0's skipped SpMM)
    opens no scope, as a JAX named_scope around no op leaves no trace."""
    ts = gs
    if meta["activation"]:
        with scope(f"{tag}_1_activation"):
            ts = [ew.leaky_relu_grad(p, g, slope) for p, g in zip(cache["post"], gs)]
    g_out = None
    if meta["lin_first"]:
        src = ts
        if meta["backward_spmm"]:
            with scope(f"{tag}_1_matmul-spmm"):
                src = agg_bwd(ts)
        with scope(f"{tag}_1_matmul-gemm"):
            grads = [dict(b=torch.sum(x, dim=0, keepdim=True), W=h.T @ x) for x, h in zip(src, cache["h"])]
            if need_input_grad:
                g_out = [x @ lp["W"].T for x, lp in zip(src, layers)]
    else:
        with scope(f"{tag}_1_matmul-gemm"):
            # deliberate reference deviation: the layer input, not ÂH
            # (lin.setX(H), gcn.hpp:477) — the shared HW buffer is long gone
            grads = [dict(b=torch.sum(t, dim=0, keepdim=True), W=h.T @ t) for t, h in zip(ts, cache["h"])]
            g_out = [t @ lp["W"].T for t, lp in zip(ts, layers)] if need_input_grad else None
        if need_input_grad and meta["backward_spmm"]:
            with scope(f"{tag}_1_matmul-spmm"):
                g_out = agg_bwd(g_out)
    if meta["res_proj"]:
        with scope(f"{tag}_1_residual"):
            for gr, g, h in zip(grads, gs, cache["h"]):
                gr["bres"], gr["Wres"] = torch.sum(g, dim=0, keepdim=True), h.T @ g
            if g_out is not None:
                g_out = [o + g @ lp["Wres"].T for o, g, lp in zip(g_out, gs, layers)]
    elif meta["res_identity"] and g_out is not None:
        g_out = [o + g for o, g in zip(g_out, gs)]
    return grads, g_out


def loss_and_grad_parity_blocks(params: Sequence, agg_fwd, agg_bwd, xs, config: GCNConfig, loss_layer):
    """Reference-parity forward and manual backward over blocks of rows
    (:func:`forward_blocks`'s ``params``, ``agg_fwd`` and ``xs``; ``agg_bwd``
    the backward matrix's products). ``loss_layer(logits)`` gives (loss,
    acc, the blocks' logits gradients). Returns (loss, acc, grads),
    ``grads[j]`` block j's gradients in the structure of its parameters,
    for the caller to sum."""
    hs, caches = forward_blocks(params, agg_fwd, xs, config, return_caches=True)
    with scope(f"{config.num_layers}_loss-layer"):
        loss, acc, gs = loss_layer(hs)
    grads: list = [[None] * config.num_layers for _ in params]
    for i in reversed(range(config.num_layers)):
        layer_grads, gs = _layer_backward([p[i] for p in params], config.layer_meta(i), agg_bwd, caches[i], gs,
                                          config.leaky_slope, need_input_grad=i > 0, tag=str(i))
        for j, g in enumerate(layer_grads):
            grads[j][i] = g
    return loss, acc, grads


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

    def loss_layer(logits):
        out = softmax_xent(logits[0], y, mask)
        return out.loss, out.acc, [out.grad]

    loss, acc, grads = loss_and_grad_parity_blocks([params], *_one_block(pair), [x], config, loss_layer)
    return loss, acc, grads[0]


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
