"""Command-line interface, the port of ``mg_gcn_tpu/cli.py``'s ``train``
command (reference main.cpp:50-133): GCN and, with ``--model gat [--heads H]
[--edge-weighted]``, GAT on one card; with ``-P N -R 1``, GCN row-partitioned
over N partitions driven by this one process (``parallel/dist.py``):

    python -m mg_gcn_tpu_torch.cli [-E epochs] [options] train <data_dir> <L> <d1> ... <dL>

The flags keep the JAX CLI's names and meanings, plus ``--device``: one
device (default ``cuda``) or, at ``-P N``, a comma list of the N partitions'
devices (``cuda:0,cuda:0,cuda:0,cuda:0`` puts four on one card; ``cpu`` puts
all on the CPU; ``cuda`` means ``cuda:0 .. cuda:N-1``). Per-epoch output is
``epoch loss acc seconds`` on stderr and a timer CSV under ``--csv-dir``
(main.cpp:100-111 conventions). Flags and commands of later slices exit with
code 2 and name their ROADMAP item.
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
        description="full-batch GCN/GAT training on CUDA cards (PyTorch port of mg_gcn_tpu)",
    )
    p.add_argument("-P", type=int, default=1, metavar="num", help="number of partitions (devices)")
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
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu; at -P N also a comma list of the N partitions' devices")
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
    dist = opts.P > 1
    later = [
        (dist and not opts.R, "-R 0 (column parallel): ROADMAP queue 1 item 9b"),
        (dist and opts.model == "gat", "--model gat with -P > 1: ROADMAP queue 1 item 9e"),
        (dist and opts.impl == "gather", "--impl gather with -P > 1: ROADMAP queue 1 item 9c"),
        (opts.multihost, "--multihost: ROADMAP queue 1 item 9g"),
        (opts.mmap, "--mmap: ROADMAP queue 1 item 9g"),
        (opts.model == "sage", "--model sage: ROADMAP queue 1 item 6 (at -P > 1, item 9f)"),
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

    P = opts.P
    try:
        if P > 1:
            mesh = _partition_ring(opts.device, P)
            dev = mesh.devices[0]
        else:
            dev = resolve_device(opts.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    ds = Dataset.load(data_dir)
    print(f"{ds.num_nodes} {ds.graph.nnz}", file=sys.stderr)
    print(f"num_labels = {ds.num_labels}", file=sys.stderr)
    print(f"feature size = {ds.num_features}", file=sys.stderr)

    sizes = [ds.num_features, *hidden, ds.num_labels]
    if P > 1:
        sizes[-1] = (sizes[-1] + P - 1) // P * P  # main.cpp:135
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

    if P > 1:
        params, opt_state, code = _train_dist(opts, ds, config, hparams, params, opt_state, timers, mesh)
    else:
        params, opt_state, code = _train_single(opts, ds, config, hparams, params, opt_state, timers, dev)
    if code:
        return code
    with open(csv_path, "w") as f:
        timers.dump(f)
    if opts.save:
        save_checkpoint(opts.save, (params, opt_state))
    return 0


def _partition_ring(spec: str, P: int):
    """The ring of ``-P`` partitions for ``--device``: ``cuda`` is ``cuda:0 ..
    cuda:P-1`` (fewer visible cards raise with the JAX CLI's message); one
    other device takes all P partitions; a comma list names each
    partition's device."""
    from .parallel.dist import make_mesh

    names = [d.strip() for d in spec.split(",")]
    if names == ["cuda"]:
        try:
            return make_mesh(P)
        except ValueError:
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise ValueError(f"requested -P {P} but only {visible} devices visible") from None
    if len(names) == 1:
        names = names * P
    if len(names) != P:
        raise ValueError(f"--device lists {len(names)} devices for -P {P}")
    return make_mesh(P, names)


def _run_epochs(opts, step, args, params, opt_state, timers, save_view=lambda p, o: (p, o)):
    """The epoch loop: ``epoch loss acc seconds`` on stderr, a timer per
    epoch, and ``--save-every`` checkpoints of ``save_view(params, state)``."""
    from .checkpoint import save_checkpoint

    for e in range(opts.E):
        t0 = time.perf_counter()
        params, opt_state, loss, acc = step(params, opt_state, *args)
        loss, acc = float(loss), float(acc)  # waits for the card, like ctx.sync()
        dt = time.perf_counter() - t0
        timers.record(f"{e}_0_epoch", dt * 1e3)
        print(f"{e} {loss} {acc} {dt}", file=sys.stderr)
        if opts.save_every and opts.save and (e + 1) % opts.save_every == 0:
            save_checkpoint(opts.save, save_view(params, opt_state))
    return params, opt_state


def _train_single(opts, ds, config, hparams, params, opt_state, timers, dev):
    from .models import gat
    from .train import build_agg_pair, make_train_step

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
    params, opt_state = _run_epochs(opts, step, (pair, x, y, mask), params, opt_state, timers)
    return params, opt_state, 0


def _train_dist(opts, ds, config, hparams, params, opt_state, timers, mesh):
    """``-P N -R 1`` GCN (``mg_gcn_tpu/cli.py:517-694``): the row-partitioned
    pattern pair where the JAX CLI's gate takes it (on a card; on the CPU
    when ``--impl pattern`` asks), with the fused ring exchange by default,
    else the COO ring pair. Returns (params, opt_state, exit code)."""
    from . import sparse
    from .ops.spmm_pattern import is_binary
    from .parallel import dist
    from .train import dist_pattern_engine

    P, n = mesh.parts, ds.num_nodes
    strategy = "all_gather" if opts.S else "ring"
    exchange_auto = opts.exchange == "auto"
    if not exchange_auto:
        strategy = opts.exchange
    cards = [d for d in mesh.replica_devices if d.type == "cuda"]
    card = min(torch.cuda.get_device_properties(d).total_memory for d in cards) if cards else None
    per_card = max(mesh.devices.count(d) for d in mesh.replica_devices)
    use_pattern = False
    if opts.impl in ("auto", "pattern"):
        if card is None:  # the CPU runs the plain versions where --impl pattern asks
            use_pattern = opts.impl == "pattern" and is_binary(ds.graph)
        else:
            use_pattern, why = dist_pattern_engine(ds.graph, P, per_card, card)
            print(f"aggregation engine: {'pattern' if use_pattern else 'xla'} (auto: {why})", file=sys.stderr)
    if opts.impl == "pattern" and not use_pattern:
        print("pattern impl not applicable here", file=sys.stderr)
        return params, opt_state, 2
    if strategy == "fused" and not use_pattern:
        print(
            "--exchange fused needs the bit-pattern pair (binary adjacency "
            "within the pattern memory budget)",
            file=sys.stderr,
        )
        return params, opt_state, 2
    with timers.span("0_preprocess"):
        if use_pattern:
            pair = dist.DistPatternPair.from_binary_csr(ds.graph, mesh, dtype=opts.pattern_dtype)
            xs, ys, masks = dist.shard_dataset(ds, mesh, pair.n_pad, opts.mask_train)
            pair_kind = "pattern"
            if exchange_auto and not opts.S and not opts.N:
                # the fused ring kernel for eligible pattern runs (cli.py:575-582);
                # -N pins the per-round ring, -S all_gather
                strategy = "fused"
                print("exchange: fused ring (auto)", file=sys.stderr)
        else:
            if n % P:
                print(
                    f"node count {n} not divisible by P={P}; pad the dataset "
                    "(prep pads to multiples of 8 like the reference)",
                    file=sys.stderr,
                )
                return params, opt_state, 2
            a = sparse.normalize(ds.graph, axis=True)  # main.cpp:143
            pair = dist.DistAggPair.from_csr_pair(sparse.transpose(a), a, mesh)
            xs, ys, masks = dist.shard_dataset(ds, mesh, mask_train=opts.mask_train)
            pair_kind = "coo"
    step = dist.make_dist_train_step(config, mesh, n, hparams, strategy=strategy, pair_kind=pair_kind,
                                     pattern_dtype=opts.pattern_dtype, optimizer=opts.optimizer)
    params, opt_state = _run_epochs(opts, step, (pair, xs, ys, masks), dist.replicate(params, mesh),
                                    dist.replicate(opt_state, mesh), timers, save_view=lambda p, o: (p[0], o[0]))
    return params[0], opt_state[0], 0


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
