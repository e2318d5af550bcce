"""Products-config (BASELINE config 2) convergence evidence.

Port of ``scripts/validate_products.py``. The bench's products problem: a
planted 48-community graph at ogbn-products scale (n = 2,449,029, average
degree 50, self loops; ``sparse.planted_graph``, seed 3), features
``planted_features`` 100 wide at noise 4.0, seed 4, and the (100, 256, 256,
48) GCN, trained 30 epochs on the pair ``impl="auto"`` builds (on a card
the ``gather`` engine for this graph, the CPU's COO engine), one
``make_train_step`` step an epoch. Prints the per-epoch trajectory. The
JAX script reads bench.py's cached TPU gather schedules; this one builds
the port's pair from the graph.

    python -m mg_gcn_tpu_torch.scripts.validate_products [--n N] [--deg D] [--epochs E] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device, sparse
from ..models.gcn import GCNConfig, init_params
from ..nn import adam
from ..train import ENGINE_OF, build_agg_pair, make_train_step
from . import device_line


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m mg_gcn_tpu_torch.scripts.validate_products", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=2_449_029)
    ap.add_argument("--deg", type=float, default=50)
    ap.add_argument("--classes", type=int, default=48)
    ap.add_argument("--features", type=int, default=100)
    ap.add_argument("--hidden", type=int, nargs="+", default=[256, 256])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the engine and the per-epoch losses and accuracies."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    t0 = time.perf_counter()
    g, comm = sparse.planted_graph(args.n, args.deg, args.classes, seed=3)
    pair = build_agg_pair(g, impl="auto", device=dev)
    engine = ENGINE_OF[type(pair.fwd)]
    print(f"pair up in {time.perf_counter() - t0:.0f}s (n={g.nrows} nnz={g.nnz}, engine {engine})", file=sys.stderr)
    x = torch.from_numpy(sparse.planted_features(comm, args.features, noise=4.0, seed=4)).to(dev)
    y = torch.from_numpy(comm.astype(np.int64)).to(dev)
    config = GCNConfig(sizes=(args.features, *args.hidden, args.classes))
    params = init_params(config, device=dev)
    opt = adam.adam_init(params)
    step = make_train_step(config)
    losses, accs = [], []
    for e in range(args.epochs):
        t1 = time.perf_counter()
        params, opt, loss, acc = step(params, opt, pair, x, y, None)
        losses.append(float(loss))
        accs.append(float(acc))
        print(f"epoch {e}: loss={losses[-1]:.4f} acc={accs[-1]:.4f} {time.perf_counter() - t1:.2f}s", flush=True)
    return dict(engine=engine, losses=losses, accs=accs)


if __name__ == "__main__":
    main()
