"""GCN on one card, as the port's CLI trains it (``cli._train_single``): the
pair of ``train.build_agg_pair`` (the engine ``impl`` picks) and the step of
``train.make_train_step(model="gcn")``; and the work of a GCN epoch.

Work (MG-GCN's schedule, ``GCNConfig.layer_meta``): a layer in → out runs
HW + b then the product at width out when out <= in, else the product at
width in then the dense product; the backward runs the product at the same
width on every layer but layer 0, the weight gradient Hᵀ·G (in × n × out)
on every layer, and the input gradient G·Wᵀ on every layer but layer 0."""

from __future__ import annotations

import sys

import torch

from benchmark.harness.params import to_layers, weight_bound
from benchmark.harness.trainer import Trainer, hparams, host_csr, timed_build
from benchmark.harness.work import Gemm, Product, Work, dense_dtype


def leaves(config: dict) -> list:
    s = config["sizes"]
    return [leaf for i in range(len(s) - 1)
            for leaf in ((f"{i}.W", (s[i], s[i + 1]), weight_bound(s[i])), (f"{i}.b", (1, s[i + 1]), 1.0))]


def work(config: dict, n: int, nnz: int) -> Work:
    s, agg, dense = config["sizes"], config["aggregation_dtype"], dense_dtype(config)
    out = Work(cards=int(config.get("parts", 1)))
    for i in range(len(s) - 1):
        d_in, d_out = s[i], s[i + 1]
        width = d_out if d_out <= d_in else d_in
        out.products.append(Product(n, n, nnz, width, agg))
        out.gemms += [Gemm(n, d_in, d_out, dense), Gemm(d_in, n, d_out, dense)]
        if i > 0:
            out.products.append(Product(n, n, nnz, width, agg))
            out.gemms.append(Gemm(n, d_out, d_in, dense))
    return out


def port_config(config: dict):
    from mg_gcn_tpu_torch.models.gcn import GCNConfig

    return GCNConfig(sizes=tuple(config["sizes"]), residual=False, leaky_slope=config["leaky_slope"],
                     parity=config["parity"], loss_mask="all")


def build(config: dict, traffic: dict, graph, x, y, params0: dict, devices) -> Trainer:
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import ENGINE_OF, build_agg_pair, make_train_step

    dev = devices[0]
    csr = host_csr(graph)
    pair, build_s = timed_build(lambda: build_agg_pair(csr, impl=traffic["impl"],
                                                       pattern_dtype=config["aggregation_dtype"], device=dev), devices)
    step = make_train_step(port_config(config), hparams(config), optimizer="adam", model="gcn")
    params = to_layers({k: v.clone() for k, v in params0.items()})
    t = Trainer(step, params, adam.adam_init(params),
                (pair, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), None), devices)
    t.build_s, t.engine = build_s, ENGINE_OF[type(pair.fwd)]
    print(f"engine {t.engine}, build {build_s:.3f} s", file=sys.stderr)
    return t
