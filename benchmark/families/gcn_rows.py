"""GCN row-partitioned over ``parts`` partitions driven by one process, as the
port's CLI trains it at ``-P N -R 1`` (``cli._train_dist``): the pair kind
``train.dist_engine`` picks for ``impl`` (the bit-pattern ring pair where its
packs fit, with the fused ring exchange the CLI takes for it by default;
else the halo or ring pair it names), ``parallel.dist.make_dist_train_step``
over ``dist.make_mesh``, the features, labels and row mask of
``dist.shard_dataset``. The work is the whole model's, as on one card
(families/gcn.py), against the peaks of all the partitions' cards."""

from __future__ import annotations

import sys

from benchmark.families import gcn
from benchmark.harness.params import to_layers
from benchmark.harness.trainer import Trainer, hparams, host_csr, timed_build

leaves = gcn.leaves
work = gcn.work


class RowTrainer(Trainer):
    def replica(self, tree):
        return tree[0]


def build(config: dict, traffic: dict, graph, x, y, params0: dict, devices) -> RowTrainer:
    import numpy as np
    import torch

    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.parallel import dist
    from mg_gcn_tpu_torch.train import dist_engine

    parts, dtype = int(config["parts"]), config["aggregation_dtype"]
    mesh = dist.make_mesh(parts, [str(d) for d in devices])
    cards = [d for d in mesh.replica_devices if d.type == "cuda"]
    card = min(torch.cuda.get_device_properties(d).total_memory for d in cards) if cards else None
    per_card = max(mesh.devices.count(d) for d in mesh.replica_devices)
    csr = host_csr(graph)
    pair_kind, why = dist_engine(csr, traffic["impl"], parts, per_card, card, processes=1)
    strategy = "fused" if pair_kind == "pattern" else "ring"
    step = dist.make_dist_train_step(gcn.port_config(config), mesh, graph.n, hparams(config), strategy=strategy,
                                     pair_kind=pair_kind, pattern_dtype=dtype, optimizer="adam")

    def make_pair():
        if pair_kind == "pattern":
            return dist.DistPatternPair.from_binary_csr(csr, mesh, dtype=dtype)
        a = sparse.normalize(csr, axis=True)
        return dist.build_pair(pair_kind, sparse.transpose(a), a, mesh)

    pair, build_s = timed_build(make_pair, mesh.replica_devices)
    ds = Dataset(graph=csr, features=x, labels=y.reshape(-1, 1), sets=np.zeros((graph.n, 1), np.int32))
    xs, ys, masks = dist.shard_dataset(ds, mesh, pair.n_pad if pair_kind == "pattern" else None)
    params = to_layers({k: v.clone() for k, v in params0.items()})
    t = RowTrainer(step, dist.replicate(params, mesh), dist.replicate(adam.adam_init(params), mesh),
                   (pair, xs, ys, masks), list(mesh.replica_devices))
    t.build_s, t.engine = build_s, f"{pair_kind}/{strategy}"
    print(f"engine {t.engine} ({why}), build {build_s:.3f} s", file=sys.stderr)
    return t
