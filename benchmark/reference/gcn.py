"""The plain reference of full-batch GCN with MG-GCN's gradients, written
from its equations (gcn.hpp:437-489, 946-954, main.cpp:113-163), in plain
PyTorch, in the inputs' dtype (float32 with TF32 off on the card), the
aggregation's operand rounded to the configuration's dtype
(common.SparseOperator).

Â is A with each entry divided by its column's entry count (the in-degree);
the forward multiplies by Âᵀ, the backward by Â. A layer of width in → out
computes Âᵀ(HW + b) when out <= in, else (ÂᵀH)W + b, then LeakyReLU on every
layer but the last. The loss is the softmax cross-entropy averaged over all
rows. The backward keeps MG-GCN's quirks: layer 0 skips its backward
product and forms no input gradient; in the product-first order the weight
gradient takes the layer's input H, not ÂᵀH (gcn.hpp:477); the activation's
gradient reads its sign from the activation's output (gcn.hpp:465).
Adam with coupled weight decay (common.adam_step)."""

from __future__ import annotations

import torch

from benchmark.reference.common import (SparseOperator, coo_of, leaky_relu, operand_dtype, softmax_xent, train,
                                        transposed)


def operator(graph, device: torch.device, dtype: torch.dtype, blocks: int = 1, operand=None) -> SparseOperator:
    """Âᵀ (forward) and Â (backward) of the graph's binary adjacency."""
    rows, cols = coo_of(graph.indptr, graph.indices, device)
    rows, cols = transposed(rows, cols, graph.n)  # Aᵀ: row i holds node i's in-edges
    return SparseOperator(rows, cols, graph.n, dtype, blocks, operand)


def loss_and_grads(params: dict, op: SparseOperator, x, y, config: dict, rows: int | None = None):
    sizes, slope = config["sizes"], config["leaky_slope"]
    layers = len(sizes) - 1
    h, caches = x, []
    for i in range(layers):
        w, b = params[f"{i}.W"], params[f"{i}.b"]
        lin_first = sizes[i + 1] <= sizes[i]
        a = op.forward(h @ w + b) if lin_first else op.forward(h) @ w + b
        if i + 1 < layers:
            a = leaky_relu(a, slope)
        caches.append((h, a, lin_first))
        h = a
    loss, g = softmax_xent(h, y, rows)
    grads = {}
    for i in reversed(range(layers)):
        h_in, post, lin_first = caches[i]
        t = torch.where(post > 0, g, slope * g) if i + 1 < layers else g
        w = params[f"{i}.W"]
        if lin_first:
            g_hw = op.backward(t) if i > 0 else t
            grads[f"{i}.b"] = torch.sum(g_hw, dim=0, keepdim=True)
            grads[f"{i}.W"] = h_in.T @ g_hw
            g = g_hw @ w.T if i > 0 else None
        else:
            grads[f"{i}.b"] = torch.sum(t, dim=0, keepdim=True)
            grads[f"{i}.W"] = h_in.T @ t
            g = op.backward(t @ w.T) if i > 0 else None
    return loss, grads


def run(graph, x, y, params0: dict, config: dict, steps: int, faults=frozenset(), blocks: int = 1) -> dict:
    """``steps`` steps from ``params0`` on the graph (common.train's record).
    ``faults`` plants "half_batch" (the loss over the first half of the
    rows), "frozen" (the state left unchanged), "no_exchange" (only the
    diagonal blocks of ``blocks`` partitions aggregated)."""
    op = operator(graph, x.device, x.dtype, blocks if "no_exchange" in faults else 1, operand_dtype(config))
    rows = x.shape[0] // 2 if "half_batch" in faults else None
    with torch.no_grad():
        return train(lambda p: loss_and_grads(p, op, x, y, config, rows), params0, config["optimizer"], steps,
                     frozen="frozen" in faults)
