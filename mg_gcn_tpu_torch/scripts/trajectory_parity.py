"""Full-scale trajectory parity against the float64 oracle.

Port of ``scripts/trajectory_parity.py``. Trains the parity-mode GCN, (64,
128, 128, 41), for 20 epochs on bench.py's planted Reddit-scale graph (n =
232,968, average degree 493, 41 communities; ``sparse.planted_graph``,
seed 3; ``planted_features`` at noise 10.0, seed 0) on the port's float32
COO engine (``impl="xla"``, the epochs through
``train.make_scan_train_steps``), and the same run in float64 on the
clean-room oracle ``tests/torch_oracle.py`` (plain torch, no code shared
with the port): Â and Âᵀ as float64 sparse CSR tensors on ``--device``,
the forward and the hand-rolled backward there, the softmax loss on the
host. Passes when the largest relative loss gap over
the epochs is below 5e-3 and the largest accuracy gap below 5e-3
(``trajectory_parity.py:165-166``). Writes the per-epoch losses and
accuracies of both sides to ``--out`` (``.bench_cache/trajectory_parity.json``
by default), and nothing else.

    python -m mg_gcn_tpu_torch.scripts.trajectory_parity [--epochs E] [--d D] [--n N] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

from .. import resolve_device, sparse
from ..models.gcn import GCNConfig, init_params
from ..nn import adam
from ..train import build_agg_pair, make_scan_train_steps
from . import device_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MAX_REL_LOSS, MAX_ACC = 5e-3, 5e-3


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m mg_gcn_tpu_torch.scripts.trajectory_parity", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--d", type=int, default=64, help="feature width")
    ap.add_argument("--n", type=int, default=232_968)
    ap.add_argument("--deg", type=float, default=493)
    ap.add_argument("--classes", type=int, default=41)
    ap.add_argument("--hidden", type=int, nargs="+", default=[128, 128])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, ".bench_cache", "trajectory_parity.json"))
    return ap.parse_args(argv)


def load_oracle():
    """``tests/torch_oracle.py`` of this checkout, loaded by path."""
    spec = importlib.util.spec_from_file_location("torch_oracle", os.path.join(REPO, "tests", "torch_oracle.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def to_sparse(csr, dev: torch.device) -> torch.Tensor:
    """A float64 sparse CSR tensor of ``csr`` on ``dev``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta", invariant checks off
        return torch.sparse_csr_tensor(torch.from_numpy(np.asarray(csr.indptr, np.int64)),
                                       torch.from_numpy(np.asarray(csr.indices, np.int64)),
                                       torch.from_numpy(np.asarray(csr.data, np.float64)), size=csr.shape).to(dev)


def main(argv=None) -> dict:
    """Exits 1 when a bound fails; returns the result written to ``--out``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(device_line(dev), file=sys.stderr)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 GEMMs, as the JAX side's "highest" precision
    t0 = time.perf_counter()
    g, comm = sparse.planted_graph(args.n, args.deg, args.classes, seed=3)
    x = sparse.planted_features(comm, args.d, noise=10.0, seed=0)
    y = comm.astype(np.int64)
    print(f"graph ready ({g.nnz} edges) in {time.perf_counter() - t0:.0f}s", file=sys.stderr)
    config = GCNConfig(sizes=(args.d, *args.hidden, args.classes))  # parity mode
    params0 = init_params(config, device=dev)
    hp = dict(adam.DEFAULT_HPARAMS)

    # the port: float32 COO engine, all epochs in one call
    t0 = time.perf_counter()
    pair = build_agg_pair(g, impl="xla", device=dev)
    steps = make_scan_train_steps(config, args.epochs, hp)
    _, _, losses, accs = steps(params0, adam.adam_init(params0), pair, torch.from_numpy(x).to(dev),
                               torch.from_numpy(y).to(dev), None)
    p_losses, p_accs = losses.cpu().tolist(), accs.cpu().tolist()
    for e, (loss, acc) in enumerate(zip(p_losses, p_accs)):
        print(f"[port f32] epoch {e}: loss={loss:.6f} acc={acc:.4f}", file=sys.stderr)
    print(f"port side: {time.perf_counter() - t0:.0f}s", file=sys.stderr)
    del pair, steps

    # the float64 oracle
    oracle = load_oracle()
    a = sparse.normalize(g, axis=True)
    a_s, a_t_s = to_sparse(a, dev), to_sparse(sparse.transpose(a), dev)
    x64, y_cpu = torch.from_numpy(x).to(dev, torch.float64), torch.from_numpy(y)
    tp = [{k: v.to(dev, torch.float64).reshape(-1) if k == "b" else v.to(dev, torch.float64)
           for k, v in layer.items()} for layer in params0]
    mstate = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in tp]
    vstate = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in tp]
    o_losses, o_accs = [], []
    t0 = time.perf_counter()
    for e in range(args.epochs):
        te = time.perf_counter()
        acts, h = oracle.forward_ref(a_t_s, tp, x64)
        loss, acc, g_loss = oracle.softmax_xent_ref(h.cpu(), y_cpu)
        grads = oracle.parity_backward_ref(a_s, a_t_s, tp, x64, acts, g_loss.to(dev))
        o_losses.append(float(loss))
        o_accs.append(float(acc))
        for i, layer in enumerate(tp):
            for k in layer:
                layer[k], mstate[i][k], vstate[i][k] = oracle.adam_step_ref(
                    layer[k], grads[i][k], mstate[i][k], vstate[i][k], e + 1, hp["lr"], hp["beta1"], hp["beta2"],
                    hp["weight_decay"], hp["eps"], decay=(k == "W"))
        print(f"[oracle f64] epoch {e}: loss={o_losses[-1]:.6f} acc={o_accs[-1]:.4f} "
              f"({time.perf_counter() - te:.1f}s)", file=sys.stderr)
    print(f"oracle side: {time.perf_counter() - t0:.0f}s", file=sys.stderr)

    d_loss = [abs(p - o) for p, o in zip(p_losses, o_losses)]
    d_acc = [abs(p - o) for p, o in zip(p_accs, o_accs)]
    rel = [dl / max(abs(o), 1e-9) for dl, o in zip(d_loss, o_losses)]
    out = dict(n=g.nrows, nnz=int(g.nnz), d=args.d, epochs=args.epochs, device=device_line(dev),
               max_abs_loss_delta=max(d_loss), max_rel_loss_delta=max(rel), max_acc_delta=max(d_acc),
               port_losses=p_losses, oracle_losses=o_losses, port_accs=p_accs, oracle_accs=o_accs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"max |dloss| = {max(d_loss):.3e} (rel {max(rel):.3e}), max |dacc| = {max(d_acc):.3e} -> {args.out}")
    if not (max(rel) < MAX_REL_LOSS and max(d_acc) < MAX_ACC):
        raise SystemExit(f"trajectory parity failed: max rel dloss {max(rel):.3e} (bound {MAX_REL_LOSS}), "
                         f"max dacc {max(d_acc):.3e} (bound {MAX_ACC})")
    return out


if __name__ == "__main__":
    main()
