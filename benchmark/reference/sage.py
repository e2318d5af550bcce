"""The plain reference of GraphSAGE with the mean aggregator (Hamilton et
al. 2017, arXiv:1706.02216, Algorithm 1), in plain PyTorch, in the inputs'
dtype, the aggregation's operand rounded to the configuration's dtype: h' = LeakyReLU(h·W_self + (M·h)·W_neigh + b) with M the adjacency
with each row divided by its entry count, each hidden layer's output divided
by its l2 norm (eps 1e-12 under the root), no activation on the last layer,
the softmax cross-entropy over all rows, exact gradients (autograd), Adam
with coupled weight decay on both weight matrices (common.adam_step)."""

from __future__ import annotations

import torch

from benchmark.reference.common import Aggregate, SparseOperator, coo_of, leaky_relu, operand_dtype, softmax_xent, train


def operator(graph, device: torch.device, dtype: torch.dtype, blocks: int = 1, operand=None) -> SparseOperator:
    """M (forward) and Mᵀ (backward) of the graph's binary adjacency."""
    rows, cols = coo_of(graph.indptr, graph.indices, device)
    return SparseOperator(rows, cols, graph.n, dtype, blocks, operand)


def logits(params: dict, op: SparseOperator, x, config: dict) -> torch.Tensor:
    sizes, slope = config["sizes"], config["leaky_slope"]
    layers = len(sizes) - 1
    h = x
    for i in range(layers):
        h = h @ params[f"{i}.Wself"] + Aggregate.apply(h, op) @ params[f"{i}.Wneigh"] + params[f"{i}.b"]
        if i + 1 < layers:
            h = leaky_relu(h, slope)
            h = h * torch.rsqrt(torch.sum(h * h, dim=-1, keepdim=True) + 1e-12)
    return h


def loss_and_grads(params: dict, op: SparseOperator, x, y, config: dict, rows: int | None = None):
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        out = logits(leaves, op, x, config)
        loss, g = softmax_xent(out.detach(), y, rows)
        got = torch.autograd.grad(out, list(leaves.values()), grad_outputs=g)
    return loss, dict(zip(leaves, got))


def run(graph, x, y, params0: dict, config: dict, steps: int, faults=frozenset(), blocks: int = 1) -> dict:
    """``steps`` steps from ``params0`` (see reference/gcn.py's ``run``)."""
    op = operator(graph, x.device, x.dtype, blocks if "no_exchange" in faults else 1, operand_dtype(config))
    rows = x.shape[0] // 2 if "half_batch" in faults else None
    return train(lambda p: loss_and_grads(p, op, x, y, config, rows), params0, config["optimizer"], steps,
                 frozen="frozen" in faults)
