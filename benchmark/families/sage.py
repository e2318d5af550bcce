"""GraphSAGE-mean on one card, as the port's CLI trains it: the pair of
``models.sage.build_sage_pair`` (the engine ``impl`` picks) and the step of
``train.make_train_step(model="sage")``; and the work of a SAGE epoch.

Work: a layer in → out runs the mean product at width in and two dense
products (self and neighbour paths); the backward runs both weight
gradients on every layer and, on every layer but layer 0 (whose input needs
no gradient), both input gradients and the transposed product at width in."""

from __future__ import annotations

import sys

import torch

from benchmark.harness.params import to_layers, weight_bound
from benchmark.harness.trainer import Trainer, hparams, host_csr, timed_build
from benchmark.harness.work import Gemm, Product, Work, dense_dtype


def leaves(config: dict) -> list:
    s = config["sizes"]
    return [leaf for i in range(len(s) - 1)
            for leaf in ((f"{i}.Wself", (s[i], s[i + 1]), weight_bound(s[i])),
                         (f"{i}.Wneigh", (s[i], s[i + 1]), weight_bound(s[i])),
                         (f"{i}.b", (1, s[i + 1]), 1.0))]


def work(config: dict, n: int, nnz: int) -> Work:
    s, agg, dense = config["sizes"], config["aggregation_dtype"], dense_dtype(config)
    out = Work(cards=int(config.get("parts", 1)))
    for i in range(len(s) - 1):
        d_in, d_out = s[i], s[i + 1]
        out.products.append(Product(n, n, nnz, d_in, agg))
        out.gemms += [Gemm(n, d_in, d_out, dense)] * 2 + [Gemm(d_in, n, d_out, dense)] * 2
        if i > 0:
            out.products.append(Product(n, n, nnz, d_in, agg))
            out.gemms += [Gemm(n, d_out, d_in, dense)] * 2
    return out


def build(config: dict, traffic: dict, graph, x, y, params0: dict, devices) -> Trainer:
    from mg_gcn_tpu_torch.models.sage import SAGEConfig, build_sage_pair
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import ENGINE_OF, make_train_step

    dev = devices[0]
    csr = host_csr(graph)
    pair, build_s = timed_build(lambda: build_sage_pair(csr, impl=traffic["impl"],
                                                        dtype=config["aggregation_dtype"], device=dev), devices)
    port = SAGEConfig(sizes=tuple(config["sizes"]), leaky_slope=config["leaky_slope"], loss_mask="all",
                      l2_normalize=config["l2_normalize"])
    step = make_train_step(port, hparams(config), optimizer="adam", model="sage")
    params = to_layers({k: v.clone() for k, v in params0.items()})
    t = Trainer(step, params, adam.adam_init(params),
                (pair, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), None), devices)
    t.build_s, t.engine = build_s, ENGINE_OF[type(pair.fwd)]
    print(f"engine {t.engine}, build {build_s:.3f} s", file=sys.stderr)
    return t
