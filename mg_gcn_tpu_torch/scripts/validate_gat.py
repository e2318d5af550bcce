"""GAT learnability validation at moderate scale.

Port of ``scripts/validate_gat.py``. A planted 16-community graph (n =
65,536, average degree 50, 55% of the edges inside the community, self
loops; ``sparse.planted_graph``, seed 5) with weak features (a projection
of the community one-hot, a quarter of the unit noise's scale: 0.25 x
``planted_features`` at noise 4.0, seed 5); a 2-layer 2-head GAT, (64, 64,
16), bfloat16 attention graph, Adam at lr 5e-3, must separate the
communities in 30 epochs: accuracy > 0.95, then ``PASS``. Each epoch is
one ``make_train_step(model="gat")`` step (the SDDMM, ``edge`` and
``edge_t`` kernels on a card).

    python -m mg_gcn_tpu_torch.scripts.validate_gat [--n N] [--deg D] [--epochs E] [--device cpu]
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
    ap = argparse.ArgumentParser(prog="python -m mg_gcn_tpu_torch.scripts.validate_gat", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--deg", type=float, default=50)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Exits 1 unless the last epoch's accuracy passes 0.95; returns the
    last loss and accuracy."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(device_line(dev), flush=True)
    g, comm = sparse.planted_graph(args.n, args.deg, args.classes, seed=5)
    x = 0.25 * sparse.planted_features(comm, args.features, noise=4.0, seed=5)
    print(f"graph n={g.nrows} nnz={g.nnz}", flush=True)
    config = gat.GATConfig(sizes=(args.features, args.hidden, args.classes), heads=args.heads)
    t0 = time.perf_counter()
    graph = gat.build_gat_graph(g, dtype="bfloat16", device=dev)
    print(f"graph built {time.perf_counter() - t0:.1f}s", flush=True)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(comm.astype(np.int64)).to(dev)
    params = gat.init_params(config, 0, device=dev)
    opt = adam.adam_init(params)
    step = make_train_step(config, dict(lr=5e-3), model="gat")
    for e in range(args.epochs):
        s = time.perf_counter()
        params, opt, loss, acc = step(params, opt, graph, xt, yt, None)
        loss, acc = float(loss), float(acc)
        print(f"epoch {e}: loss={loss:.4f} acc={acc:.4f} {time.perf_counter() - s:.3f}s", flush=True)
    if not acc > 0.95:
        raise SystemExit(f"GAT failed to separate planted communities: {acc}")
    print("PASS", flush=True)
    return dict(loss=loss, acc=acc)


if __name__ == "__main__":
    main()
