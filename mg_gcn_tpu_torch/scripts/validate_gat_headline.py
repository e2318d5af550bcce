"""Headline-scale GAT convergence evidence.

Port of ``scripts/validate_gat_headline.py``: the 2-layer 2-head GAT,
(64, 64, 41), at full Reddit scale, on bench.py's planted 41-community
graph (n = 232,968, average degree 493, self loops; ``sparse.planted_graph``,
seed 3) with ``planted_features`` 64 wide at noise 2.0, seed 8, trained on
the bfloat16 attention graph for 30 epochs, one ``make_train_step(model=
"gat")`` step an epoch. Prints the per-epoch trajectory. The JAX script
reads bench.py's cached TPU edge schedule; this one builds the port's
attention graph from the graph.

    python -m mg_gcn_tpu_torch.scripts.validate_gat_headline [--n N] [--deg D] [--epochs E] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device, sparse
from ..models import gat
from ..nn import adam
from ..train import make_train_step
from . import device_line


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m mg_gcn_tpu_torch.scripts.validate_gat_headline",
                                 description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=232_968)
    ap.add_argument("--deg", type=float, default=493)
    ap.add_argument("--classes", type=int, default=41)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the per-epoch losses and accuracies."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    t0 = time.perf_counter()
    g, comm = sparse.planted_graph(args.n, args.deg, args.classes, seed=3)
    graph = gat.build_gat_graph(g, dtype="bfloat16", device=dev)
    print(f"graph up in {time.perf_counter() - t0:.0f}s (n={g.nrows} nnz={g.nnz})", file=sys.stderr)
    config = gat.GATConfig(sizes=(args.features, args.hidden, args.classes), heads=args.heads)
    x = torch.from_numpy(sparse.planted_features(comm, args.features, noise=2.0, seed=8)).to(dev)
    y = torch.from_numpy(comm.astype(np.int64)).to(dev)
    params = gat.init_params(config, 0, device=dev)
    opt = adam.adam_init(params)
    step = make_train_step(config, model="gat")
    losses, accs = [], []
    for e in range(args.epochs):
        t1 = time.perf_counter()
        params, opt, loss, acc = step(params, opt, graph, x, y, None)
        losses.append(float(loss))
        accs.append(float(acc))
        print(f"epoch {e}: loss={losses[-1]:.4f} acc={accs[-1]:.4f} {time.perf_counter() - t1:.2f}s", flush=True)
    return dict(losses=losses, accs=accs)


if __name__ == "__main__":
    main()
