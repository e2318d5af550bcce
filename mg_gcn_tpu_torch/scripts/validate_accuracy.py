"""Accuracy validation at Reddit scale: bf16 against int8 pattern aggregation.

Port of ``scripts/validate_accuracy.py``. A planted 41-community graph at
the headline bench's scale (n = 232,968, average degree 493, 55% of the
edges inside the community, self loops; ``sparse.planted_graph``, seed 3),
features a noisy projection of the community one-hot (608 wide, noise
10.0, seed 0), and the (608, 128, 128, 41) GCN trained for 20 epochs in
each pattern dtype through ``train.make_scan_train_steps``: the int8 mode
must reach the bf16 mode's final accuracy. Prints each run's accuracies on
stderr and the gap, bf16 - int8, on stdout.

    python -m mg_gcn_tpu_torch.scripts.validate_accuracy [--n N] [--deg D] [--epochs E] [--device cpu]

The JAX script draws its own planted graph (no self loops); this one
draws the port's ``planted_graph``, the JAX package's ``sparse.planted_graph``.
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
from ..train import build_agg_pair, make_scan_train_steps
from . import device_line


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m mg_gcn_tpu_torch.scripts.validate_accuracy", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=232_968)
    ap.add_argument("--deg", type=float, default=493)
    ap.add_argument("--classes", type=int, default=41)
    ap.add_argument("--features", type=int, default=608)
    ap.add_argument("--hidden", type=int, nargs="+", default=[128, 128])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {dtype: final accuracy} and the gap."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(device_line(dev), file=sys.stderr)
    t0 = time.perf_counter()
    g, comm = sparse.planted_graph(args.n, args.deg, args.classes, seed=3)
    x = torch.from_numpy(sparse.planted_features(comm, args.features, noise=10.0, seed=0)).to(dev)
    y = torch.from_numpy(comm.astype(np.int64)).to(dev)
    print(f"graph ready ({g.nnz} edges) in {time.perf_counter() - t0:.0f}s", file=sys.stderr)
    config = GCNConfig(sizes=(args.features, *args.hidden, args.classes))
    results = {}
    for dtype in ("bfloat16", "int8"):
        t0 = time.perf_counter()
        pair = build_agg_pair(g, impl="pattern", pattern_dtype=dtype, device=dev)
        steps = make_scan_train_steps(config, args.epochs)
        params = init_params(config, device=dev)
        _, _, losses, accs = steps(params, adam.adam_init(params), pair, x, y, None)
        accs, losses = accs.cpu().numpy(), losses.cpu().numpy()
        results[dtype] = float(accs[-1])
        marks = ", ".join(f"ep{e + 1} {accs[e]:.4f}" for e in (4, 9) if e < args.epochs - 1)
        print(f"[{dtype}] final acc {accs[-1]:.4f} ({marks}) loss {losses[-1]:.4f} "
              f"in {time.perf_counter() - t0:.0f}s", file=sys.stderr)
        del pair, steps
    gap = results["bfloat16"] - results["int8"]
    print(f"accuracy gap bf16 - int8 = {gap:+.4f}")
    return dict(results, gap=gap)


if __name__ == "__main__":
    main()
