"""Command-line interface, the port of ``mg_gcn_tpu/cli.py``'s ``train``
command on one card (reference main.cpp:50-133), for GCN and, with
``--model gat [--heads H] [--edge-weighted]``, GAT:

    python -m mg_gcn_tpu_torch.cli [-E epochs] [options] train <data_dir> <L> <d1> ... <dL>

The flags keep the JAX CLI's names and meanings, plus ``--device``
(default ``cuda``). Per-epoch output is ``epoch loss acc seconds`` on stderr
and a timer CSV under ``--csv-dir`` (main.cpp:100-111 conventions). Flags and
commands of later slices exit with code 2 and name their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mg_gcn_tpu_torch",
        description="full-batch GCN/GAT training on one CUDA card (PyTorch port of mg_gcn_tpu)",
    )
    p.add_argument("-P", type=int, default=1, metavar="num", help="number of devices")
    p.add_argument("-R", type=int, default=0, metavar="row", help="enable row partition")
    p.add_argument("-E", type=int, default=20, metavar="epochs", help="number of epochs")
    p.add_argument("-S", action="store_true", help="disable comm overlap (all_gather)")
    p.add_argument("-N", action="store_true", help="no-wait: force overlap (ring)")
    p.add_argument("--exact", action="store_true", help="exact autograd gradients")
    p.add_argument("--mask-train", action="store_true", help="loss on train set only")
    p.add_argument("--residual", action="store_true", help="residual connections per layer")
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    p.add_argument(
        "--impl",
        default="auto",
        choices=["auto", "pattern", "block", "edge", "gather", "xla", "pallas", "halo"],
        help="aggregation engine (this port: auto, pattern, block, edge, gather, xla, pallas; halo is a later slice)",
    )
    p.add_argument("--model", default="gcn", choices=["gcn", "sage", "gat"])
    p.add_argument("--heads", type=int, default=1,
                   help="attention heads per GAT layer (--model gat; concat on hidden layers, mean on the output)")
    p.add_argument("--edge-weighted", action="store_true",
                   help="weight the GAT attention by the graph's positive edge values (--model gat, one card)")
    p.add_argument(
        "--pattern-dtype",
        default="bfloat16",
        choices=["bfloat16", "float32", "int8"],
        help="operand dtype of the pattern, block and edge SpMM kernels",
    )
    p.add_argument("--f64", action="store_true", help="float64 numerics mode")
    p.add_argument("--mmap", action="store_true", help="memory-map features.bin")
    p.add_argument("--multihost", action="store_true", help="multi-process runtime")
    p.add_argument(
        "--exchange", default="auto", choices=["auto", "ring", "all_gather", "fused"]
    )
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--wd", type=float, default=5e-4)
    p.add_argument("--b1", type=float, default=0.9)
    p.add_argument("--b2", type=float, default=0.999)
    p.add_argument("--eps-adam", type=float, default=1e-8)
    p.add_argument("--seed", type=int, default=None, help="torch.Generator init instead of the seed-99 init")
    p.add_argument("--save", metavar="PATH", help="write checkpoint after training")
    p.add_argument("--save-every", type=int, default=0, metavar="N", help="also checkpoint every N epochs")
    p.add_argument("--load", metavar="PATH", help="resume from checkpoint")
    p.add_argument("--profile", metavar="DIR", help="profiler trace directory")
    p.add_argument("--time-phases", action="store_true", help="per-phase device timing")
    p.add_argument("--csv-dir", default="csvs")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    p.add_argument("--damping", type=float, default=0.85, help="pagerank damping")
    p.add_argument("--eps", type=float, default=1e-4, help="pagerank tolerance")
    p.add_argument("command", help="train")
    p.add_argument("args", nargs="*", help="command arguments")
    return p


def _csv_name(data_dir: str, sizes, P: int) -> str:
    # main.cpp:100-111: dataset dir name (prefixed "permuted_" when under a
    # permuted/ directory) + sizes + device count
    name = ""
    permuted = False
    for s in [s for s in os.path.normpath(data_dir).split(os.sep) if s]:
        if s == "permuted":
            permuted = True
        else:
            name = ("permuted_" if permuted else "") + s
    for s in sizes:
        name += f"_{s}"
    return f"{name}_{P}.csv"


def _not_ported(opts) -> str | None:
    """The first option of a later slice that ``opts`` asks for, with its
    ROADMAP item, or None."""
    later = [
        (opts.P > 1, "-P > 1 (distributed training): ROADMAP queue 1 item 9"),
        (opts.multihost, "--multihost: ROADMAP queue 1 item 9"),
        (opts.mmap, "--mmap: ROADMAP queue 1 item 9"),
        (opts.exchange != "auto", "--exchange: ROADMAP queue 1 item 9"),
        (opts.model == "sage", "--model sage: ROADMAP queue 1 item 6"),
        (opts.f64, "--f64: ROADMAP queue 1 item 4b"),
        (opts.time_phases, "--time-phases: ROADMAP queue 1 item 8"),
        (bool(opts.profile), "--profile: ROADMAP queue 1 item 8"),
    ]
    for asked, what in later:
        if asked:
            return what
    from .train import LATER_IMPLS

    if opts.impl in LATER_IMPLS:
        return f"--impl {opts.impl}: {LATER_IMPLS[opts.impl]}"
    return None


def _invalid(opts) -> str | None:
    """The JAX CLI's refusals of option combinations (``cli.py:192-209,
    298-307``), with its messages, or None."""
    if opts.edge_weighted and opts.model != "gat":
        return "--edge-weighted is a GAT option (--model gat)"
    if opts.model == "gat":
        if opts.P > 1 and not opts.R:
            return "-R 0 (column parallel) supports --model gcn only; use -R 1 for GAT"
        if opts.impl not in ("auto", "edge"):
            return "--model gat runs on the edge-tile attention kernels; use --impl auto or edge"
        if opts.residual:
            return "--residual is a GCN option (--model gcn)"
        if opts.edge_weighted and opts.P > 1:
            return "--edge-weighted GAT is single-chip (the distributed graph drops edge values); use -P 1"
    return None


def cmd_train(opts) -> int:
    invalid = _invalid(opts)
    if invalid:
        print(invalid, file=sys.stderr)
        return 2
    missing = _not_ported(opts)
    if missing:
        print(f"not ported yet: {missing}", file=sys.stderr)
        return 2
    if len(opts.args) < 2:
        print("train requires: <data_dir> <L> <d1> ... <dL>", file=sys.stderr)
        return 2
    data_dir = opts.args[0]
    num_sizes = int(opts.args[1])
    hidden = [int(x) for x in opts.args[2 : 2 + num_sizes]]
    if len(hidden) != num_sizes:
        print(f"expected {num_sizes} layer sizes", file=sys.stderr)
        return 2

    from . import resolve_device
    from .checkpoint import load_checkpoint, save_checkpoint
    from .formats import Dataset
    from .models import gat, gcn
    from .nn import adam
    from .timers import TimerRegistry
    from .train import build_agg_pair, make_train_step

    try:
        dev = resolve_device(opts.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    ds = Dataset.load(data_dir)
    print(f"{ds.num_nodes} {ds.graph.nnz}", file=sys.stderr)
    print(f"num_labels = {ds.num_labels}", file=sys.stderr)
    print(f"feature size = {ds.num_features}", file=sys.stderr)

    P = 1
    sizes = [ds.num_features, *hidden, ds.num_labels]
    hparams = dict(
        lr=opts.lr, beta1=opts.b1, beta2=opts.b2, weight_decay=opts.wd, eps=opts.eps_adam
    )
    loss_mask = "train" if opts.mask_train else "all"
    if opts.model == "gat":
        config = gat.GATConfig(sizes=tuple(sizes), heads=opts.heads, loss_mask=loss_mask,
                               edge_weighted=opts.edge_weighted)
        params = gat.init_params(config, opts.seed, device=dev)
    else:
        config = gcn.GCNConfig(sizes=tuple(sizes), parity=not opts.exact, residual=opts.residual,
                               loss_mask=loss_mask)
        params = gcn.init_params(config, opts.seed, device=dev)
    timers = TimerRegistry()
    os.makedirs(opts.csv_dir, exist_ok=True)
    csv_path = os.path.join(opts.csv_dir, _csv_name(data_dir, sizes, P))

    opt_state = adam.adam_init(params)
    if opts.load:
        params, opt_state = load_checkpoint(opts.load, (params, opt_state))

    with timers.span("0_preprocess"):
        if opts.model == "gat":
            # the attention ops need dynamic weights: int8 trains GAT in bf16 (cli.py:390)
            dtype = "bfloat16" if opts.pattern_dtype == "int8" else opts.pattern_dtype
            pair = gat.build_gat_graph(ds.graph, dtype=dtype, device=dev)
        else:
            pair = build_agg_pair(ds.graph, impl=opts.impl, pattern_dtype=opts.pattern_dtype, device=dev)
        x = torch.from_numpy(np.ascontiguousarray(ds.features, np.float32)).to(dev)
        y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
        mask = (
            torch.from_numpy(ds.sets.reshape(-1) == 0).to(dev)
            if config.loss_mask == "train"
            else None
        )
    step = make_train_step(config, hparams, optimizer=opts.optimizer, model=opts.model)
    for e in range(opts.E):
        t0 = time.perf_counter()
        params, opt_state, loss, acc = step(params, opt_state, pair, x, y, mask)
        loss, acc = float(loss), float(acc)
        dt = time.perf_counter() - t0
        timers.record(f"{e}_0_epoch", dt * 1e3)
        print(f"{e} {loss} {acc} {dt}", file=sys.stderr)
        if opts.save_every and opts.save and (e + 1) % opts.save_every == 0:
            save_checkpoint(opts.save, (params, opt_state))
    with open(csv_path, "w") as f:
        timers.dump(f)
    if opts.save:
        save_checkpoint(opts.save, (params, opt_state))
    return 0


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    if opts.command == "train":
        return cmd_train(opts)
    if opts.command in ("infer", "pagerank"):
        item = "4b" if opts.command == "infer" else "6"
        print(f"not ported yet: the {opts.command} command: ROADMAP queue 1 item {item}", file=sys.stderr)
        return 2
    print(f"Unknown command: {opts.command}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
