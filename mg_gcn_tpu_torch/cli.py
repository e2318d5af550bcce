"""Command-line interface, the port of ``mg_gcn_tpu/cli.py`` (reference
main.cpp:50-133): ``train`` runs GCN, ``--model sage`` (GraphSAGE) and
``--model gat [--heads H] [--edge-weighted]`` on one card, with ``-P N -R 1``
GCN, SAGE and GAT row-partitioned over N partitions driven by this one
process (``parallel/dist.py``, ``parallel/dist_halo.py``,
``parallel/dist_gat.py``), and with ``-P N -R 0`` GCN column-parallel
(``parallel/dist_col.py``); ``infer``
loads a checkpoint and writes the forward pass's predictions; ``pagerank``
runs the power iteration:

    python -m mg_gcn_tpu_torch.cli [-E epochs] [options] train <data_dir> <L> <d1> ... <dL>
    python -m mg_gcn_tpu_torch.cli [options] --load CK infer <data_dir> <L> <d1> ... <dL>
    python -m mg_gcn_tpu_torch.cli [-P N] pagerank <data_dir>

The flags keep the JAX CLI's names and meanings, plus ``--device``: one
device (default ``cuda``) or, at ``-P N``, a comma list of the N partitions'
devices (``cuda:0,cuda:0,cuda:0,cuda:0`` puts four on one card; ``cpu`` puts
all on the CPU; ``cuda`` means ``cuda:0 .. cuda:N-1``). Per-epoch output is
``epoch loss acc seconds`` on stderr and a timer CSV under ``--csv-dir``
(main.cpp:100-111 conventions). ``--time-phases`` adds the per-phase device
times of GCN's step to that CSV (``diagnostics.py``), ``--profile DIR``
writes a torch.profiler Chrome trace of the run into DIR, and ``--f64`` runs
single-card GCN in float64 on the COO engine. Flags of later slices exit
with code 2 and name their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mg_gcn_tpu_torch",
        description="full-batch GCN/SAGE/GAT training on CUDA cards (PyTorch port of mg_gcn_tpu)",
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
        help="aggregation engine (halo: -P > 1 only)",
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
    p.add_argument("command", help="train | infer | pagerank")
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
        (opts.mmap, "--mmap: ROADMAP queue 1 item 9g"),
    ]
    for asked, what in later:
        if asked:
            return what
    return None


def _invalid(opts) -> str | None:
    """The JAX CLI's refusals of option combinations (``cli.py:181-222,
    281-307, 340-347``), in its order, with its messages, or None."""
    if opts.impl == "halo" and opts.P == 1:
        return "--impl halo is a distributed mode; use -P <num> -R 1"
    if opts.model == "sage" and opts.impl in ("block", "pallas"):
        return (f"--model sage does not support --impl {opts.impl}; "
                "use auto, pattern, edge, gather, xla, or halo")
    if opts.edge_weighted and opts.model != "gat":
        return "--edge-weighted is a GAT option (--model gat)"
    if opts.model == "gat":
        if opts.P > 1 and not opts.R:
            return "-R 0 (column parallel) supports --model gcn only; use -R 1 for GAT"
        if opts.impl not in ("auto", "edge"):
            return "--model gat runs on the edge-tile attention kernels; use --impl auto or edge"
    if opts.f64 and (opts.P > 1 or opts.model != "gcn" or opts.impl not in ("auto", "xla")):
        return "--f64 runs single-chip GCN on the COO/XLA engine (--impl auto/xla, -P 1, --model gcn)"
    if opts.model == "sage":
        if opts.residual:
            return "--residual is a GCN option (--model gcn)"
        if opts.optimizer == "sgd" and opts.P > 1:
            return "--optimizer sgd is not wired for distributed SAGE; use adam or --model gcn"
        if opts.P > 1 and not opts.R:
            return "-R 0 (column parallel) supports --model gcn only; use -R 1 for SAGE"
    if opts.model == "gat":
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

    from .checkpoint import load_checkpoint, save_checkpoint
    from .formats import Dataset
    from .models import gat, gcn, sage
    from .nn import adam
    from .timers import TimerRegistry, trace

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
        if not opts.R:
            # column parallel shards every width across the P partitions;
            # round all widths up (features are zero-padded to match)
            sizes = [(s + P - 1) // P * P for s in sizes]
    hparams = dict(
        lr=opts.lr, beta1=opts.b1, beta2=opts.b2, weight_decay=opts.wd, eps=opts.eps_adam
    )
    loss_mask = "train" if opts.mask_train else "all"
    if opts.model == "gat":
        config = gat.GATConfig(sizes=tuple(sizes), heads=opts.heads, loss_mask=loss_mask,
                               edge_weighted=opts.edge_weighted)
        params = gat.init_params(config, opts.seed, device=dev)
    elif opts.model == "sage":
        config = sage.SAGEConfig(sizes=tuple(sizes), loss_mask=loss_mask)
        params = sage.init_params(config, opts.seed, device=dev)
    else:
        config = gcn.GCNConfig(sizes=tuple(sizes), parity=not opts.exact, residual=opts.residual,
                               loss_mask=loss_mask)
        params = gcn.init_params(config, opts.seed, device=dev,
                                 dtype=torch.float64 if opts.f64 else torch.float32)
    timers = TimerRegistry()
    os.makedirs(opts.csv_dir, exist_ok=True)
    csv_path = os.path.join(opts.csv_dir, _csv_name(data_dir, sizes, P))

    opt_state = adam.adam_init(params)
    if opts.load:
        params, opt_state = load_checkpoint(opts.load, (params, opt_state))

    with trace(opts.profile):
        if P > 1:
            if not opts.R:
                train_dist = _train_col
            else:
                train_dist = {"sage": _train_dist_sage, "gat": _train_dist_gat}.get(opts.model, _train_dist)
            params, opt_state, code = train_dist(opts, ds, config, hparams, params, opt_state, timers, mesh)
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


def _single_pair(opts, graph, dev):
    """The one-card operator of ``--model``: GAT's attention graph, SAGE's
    row-normalized pair or GCN's aggregation pair."""
    from .models import gat, sage
    from .train import build_agg_pair

    if opts.model == "gat":
        # the attention ops need dynamic weights: int8 trains GAT in bf16 (cli.py:390)
        dtype = "bfloat16" if opts.pattern_dtype == "int8" else opts.pattern_dtype
        return gat.build_gat_graph(graph, dtype=dtype, device=dev)
    if opts.model == "sage":
        return sage.build_sage_pair(graph, impl=opts.impl, dtype=opts.pattern_dtype, device=dev)
    if opts.f64:
        return build_agg_pair(graph, impl="xla", device=dev, coo_val_dtype=np.float64)
    return build_agg_pair(graph, impl=opts.impl, pattern_dtype=opts.pattern_dtype, device=dev)


def _train_single(opts, ds, config, hparams, params, opt_state, timers, dev):
    """One card: the epochs, then under ``--time-phases`` (GCN) the step's
    per-phase device times (``mg_gcn_tpu/cli.py:415-427``): the traced step
    first, the un-fused replay where the trace holds no device event."""
    from .train import make_train_step

    with timers.span("0_preprocess"):
        pair = _single_pair(opts, ds.graph, dev)
        fdt = np.float64 if opts.f64 else np.float32
        x = torch.from_numpy(np.ascontiguousarray(ds.features, fdt)).to(dev)
        y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
        mask = (
            torch.from_numpy(ds.sets.reshape(-1) == 0).to(dev)
            if config.loss_mask == "train"
            else None
        )
    step = make_train_step(config, hparams, optimizer=opts.optimizer, model=opts.model)
    params, opt_state = _run_epochs(opts, step, (pair, x, y, mask), params, opt_state, timers)
    if opts.time_phases and opts.model == "gcn":
        from .diagnostics import profile_epoch, profile_fused_step

        before = len(timers._entries)
        _, params, opt_state = profile_fused_step(step, (params, opt_state, pair, x, y, mask), timers,
                                                  prefix="phase_")
        if len(timers._entries) == before:
            print("no device trace; falling back to un-fused phase replay", file=sys.stderr)
            profile_epoch(params, pair, x, y, config, timers, prefix="phase_")
    return params, opt_state, 0


def _card_bytes(mesh) -> int | None:
    """The smallest memory of the ring's cards, or None on the CPU."""
    cards = [d for d in mesh.replica_devices if d.type == "cuda"]
    return min(torch.cuda.get_device_properties(d).total_memory for d in cards) if cards else None


def _halo_lines(pair, P: int, n: int) -> None:
    """The JAX CLI's stderr lines for a halo pair (``cli.py:634-641``)."""
    from .parallel.dist_halo import DistHaloGatherMat

    if isinstance(pair.fwd, DistHaloGatherMat):
        print("halo local engine: serial-gather", file=sys.stderr)
    moved = P * sum(pair.fwd.round_widths)
    print(f"halo exchange: {moved} rows/SpMM fwd moved ({pair.fwd.halo_total} useful; dense bcast would move"
          f" {(P - 1) * n})", file=sys.stderr)


def _train_dist(opts, ds, config, hparams, params, opt_state, timers, mesh):
    """``-P N -R 1`` GCN (``mg_gcn_tpu/cli.py:517-694``): the pair
    ``train.dist_engine`` picks. The row-partitioned pattern pair where the
    JAX CLI's gate takes it (on a card; on the CPU where ``--impl pattern``
    asks), with the fused ring exchange by default; ``--impl gather`` the
    serial-gather ring blocks; ``--impl halo``, and ``auto`` otherwise, the
    halo pair (its local engine by ``train.halo_engine``); any other impl
    the COO ring pair. Returns (params, opt_state, exit code)."""
    from . import sparse
    from .parallel import dist
    from .train import dist_engine

    P, n = mesh.parts, ds.num_nodes
    strategy = "all_gather" if opts.S else "ring"
    exchange_auto = opts.exchange == "auto"
    if not exchange_auto:
        strategy = opts.exchange
    card = _card_bytes(mesh)
    per_card = max(mesh.devices.count(d) for d in mesh.replica_devices)
    try:
        pair_kind, why = dist_engine(ds.graph, opts.impl, P, per_card, card)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return params, opt_state, 2
    if card is not None and opts.impl in ("auto", "pattern"):
        print(f"aggregation engine: {pair_kind} (auto: {why})", file=sys.stderr)
    if pair_kind != "pattern":
        if n % P:
            print(
                f"node count {n} not divisible by P={P}; pad the dataset "
                "(prep pads to multiples of 8 like the reference)",
                file=sys.stderr,
            )
            return params, opt_state, 2
        if pair_kind == "gather" and strategy != "ring":
            print("--impl gather uses the ring exchange; drop -S / --exchange", file=sys.stderr)
            return params, opt_state, 2
    if strategy == "fused" and pair_kind != "pattern":
        print(
            "--exchange fused needs the bit-pattern pair (binary adjacency "
            "within the pattern memory budget)",
            file=sys.stderr,
        )
        return params, opt_state, 2
    # the fused ring kernel for eligible pattern runs (cli.py:575-582); -N
    # pins the per-round ring, -S all_gather
    fused_auto = pair_kind == "pattern" and exchange_auto and not opts.S and not opts.N
    try:  # a halo pair asked for another exchange: the JAX step's refusal
        step = dist.make_dist_train_step(config, mesh, n, hparams, strategy="fused" if fused_auto else strategy,
                                         pair_kind=pair_kind, pattern_dtype=opts.pattern_dtype,
                                         optimizer=opts.optimizer)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return params, opt_state, 2
    with timers.span("0_preprocess"):
        if pair_kind == "pattern":
            pair = dist.DistPatternPair.from_binary_csr(ds.graph, mesh, dtype=opts.pattern_dtype)
            xs, ys, masks = dist.shard_dataset(ds, mesh, pair.n_pad, opts.mask_train)
            if fused_auto:
                print("exchange: fused ring (auto)", file=sys.stderr)
        else:
            a = sparse.normalize(ds.graph, axis=True)  # main.cpp:143
            pair = dist.build_pair(pair_kind, sparse.transpose(a), a, mesh)
            if pair_kind in ("halo", "halo_gather"):
                _halo_lines(pair, P, n)
            del a
            xs, ys, masks = dist.shard_dataset(ds, mesh, mask_train=opts.mask_train)
    params, opt_state = _run_epochs(opts, step, (pair, xs, ys, masks), dist.replicate(params, mesh),
                                    dist.replicate(opt_state, mesh), timers, save_view=lambda p, o: (p[0], o[0]))
    return params[0], opt_state[0], 0


def _train_dist_sage(opts, ds, config, hparams, params, opt_state, timers, mesh):
    """``--model sage -P N -R 1`` (``mg_gcn_tpu/cli.py:697-795``, without its
    per-process slab branch) over the mean pair (M, Mᵀ): ``--impl halo``
    the halo pair (its local engine by ``train.halo_engine``, through
    ``train.dist_engine``), ``--impl gather`` the serial-gather ring
    blocks, every other impl
    (``auto`` too) the COO ring pair; ``-S`` the all_gather exchange.
    Returns (params, opt_state, exit code)."""
    from . import sparse
    from .parallel import dist
    from .train import dist_engine

    P, n = mesh.parts, ds.num_nodes
    if n % P:
        print(f"node count {n} not divisible by P={P}", file=sys.stderr)
        return params, opt_state, 2
    strategy = "all_gather" if opts.S else "ring"
    if opts.impl == "gather" and strategy != "ring":
        print("--impl gather uses the ring exchange; drop -S", file=sys.stderr)
        return params, opt_state, 2
    # SAGE's auto takes COO (cli.py:743-745); halo and gather as the GCN path
    pair_kind = "coo"
    if opts.impl in ("halo", "gather"):
        pair_kind = dist_engine(ds.graph, opts.impl, P, P, _card_bytes(mesh))[0]
    try:  # a halo pair asked for the all_gather exchange: the JAX step's refusal
        step = dist.make_dist_sage_train_step(config, mesh, n, hparams, strategy=strategy, pair_kind=pair_kind)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return params, opt_state, 2
    with timers.span("0_preprocess"):
        m = sparse.normalize(ds.graph, axis=False)
        pair = dist.build_pair(pair_kind, m, sparse.transpose(m), mesh)
        del m
        xs, ys, masks = dist.shard_dataset(ds, mesh, mask_train=opts.mask_train)
    params, opt_state = _run_epochs(opts, step, (pair, xs, ys, masks), dist.replicate(params, mesh),
                                    dist.replicate(opt_state, mesh), timers, save_view=lambda p, o: (p[0], o[0]))
    return params[0], opt_state[0], 0


def _train_dist_gat(opts, ds, config, hparams, params, opt_state, timers, mesh):
    """``--model gat -P N -R 1`` (``mg_gcn_tpu/cli.py:797-838``): the ring
    attention blocks of ``parallel/dist_gat.py``, bfloat16 when
    ``--pattern-dtype int8`` asks (the attention weights are dynamic).
    Returns (params, opt_state, exit code)."""
    from .parallel import dist, dist_gat

    P, n = mesh.parts, ds.num_nodes
    if n % P:
        print(f"node count {n} not divisible by P={P}", file=sys.stderr)
        return params, opt_state, 2
    with timers.span("0_preprocess"):
        dtype = "bfloat16" if opts.pattern_dtype == "int8" else opts.pattern_dtype
        graph = dist_gat.build_dist_gat_graph(ds.graph, mesh, dtype=dtype)
        xs, ys, masks = dist.shard_dataset(ds, mesh, mask_train=opts.mask_train)
    step = dist_gat.make_dist_gat_train_step(config, mesh, graph, hparams, optimizer=opts.optimizer)
    params, opt_state = _run_epochs(opts, step, (graph, xs, ys, masks), dist.replicate(params, mesh),
                                    dist.replicate(opt_state, mesh), timers, save_view=lambda p, o: (p[0], o[0]))
    return params[0], opt_state[0], 0


def _train_col(opts, ds, config, hparams, params, opt_state, timers, mesh):
    """``-P N -R 0`` (``mg_gcn_tpu/cli.py:431-484``): column-parallel GCN
    (``parallel/dist_col.py``) on the COO engine, Âᵀ held once a device,
    exact gradients; every width rounded to a multiple of P, the features
    zero-padded to it. Checkpoints hold the full (rounded) arrays. Returns
    (params, opt_state, exit code)."""
    from dataclasses import replace

    from . import sparse
    from .ops.spmm import COOMat
    from .parallel import dist_col

    if opts.mask_train or opts.residual:
        print("-R 0 (column parallel) does not support --mask-train/--residual; use -R 1", file=sys.stderr)
        return params, opt_state, 2
    if config.parity:
        print(
            "note: column path uses exact autodiff gradients (no parity "
            "quirks to mirror; the reference column path predates them)",
            file=sys.stderr,
        )
        config = replace(config, parity=False)
    with timers.span("0_preprocess"):
        a = sparse.normalize(ds.graph, axis=True)
        mats = dist_col.replicate_coo(COOMat.from_csr(sparse.transpose(a), device=mesh.devices[0]), mesh)
        del a
        x = np.zeros((ds.num_nodes, config.sizes[0]), np.float32)  # zero-padded to the rounded width
        x[:, : ds.num_features] = ds.features
        xs = dist_col.shard_columns(x, mesh)
        y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64))
        ys = [y.to(dev) for dev in mesh.devices]
    step = dist_col.make_col_train_step(config, mesh, ds.num_nodes, hparams, optimizer=opts.optimizer)
    params, opt_state = _run_epochs(
        opts, step, (mats, xs, ys), dist_col.shard_col_params(params, mesh),
        dist_col.shard_col_state(opt_state, mesh), timers,
        save_view=lambda p, o: (dist_col.gather_col_params(p), dist_col.gather_col_state(o)))
    return dist_col.gather_col_params(params), dist_col.gather_col_state(opt_state), 0


def cmd_infer(opts) -> int:
    """Inference: load a checkpoint, run the forward pass and write the
    predictions (``mg_gcn_tpu/cli.py:841-949``; the reference's
    gcn::operator(), gcn.hpp:966-969). GCN, SAGE and GAT on one card, GCN
    at ``-P N -R 1`` through ``parallel.dist.make_dist_infer`` on the COO
    ring pair. Writes ``predictions.bin`` (int32, (n, 1)) or ``--save``."""
    from .checkpoint import load_checkpoint
    from .formats import Dataset, write_dense
    from .models import gat, gcn, sage
    from .nn import adam

    if len(opts.args) < 2:
        print("infer requires: <data_dir> <L> <d1> ... <dL>", file=sys.stderr)
        return 2
    if not opts.load:
        print("infer requires --load CHECKPOINT", file=sys.stderr)
        return 2
    data_dir = opts.args[0]
    num_sizes = int(opts.args[1])
    hidden = [int(x) for x in opts.args[2 : 2 + num_sizes]]
    P = opts.P
    if P > 1 and not opts.R:
        # a -R 0 checkpoint has every width rounded to a multiple of P and
        # column-sharded semantics; this path does not reconstruct that
        print("-R 0 (column parallel) inference is not wired; train with -R 1 or infer with -P 1", file=sys.stderr)
        return 2
    if opts.impl == "halo" and P == 1:
        print("--impl halo is a distributed mode; use -P <num> -R 1", file=sys.stderr)
        return 2
    try:
        mesh = _partition_ring(opts.device, P) if P > 1 else None
        dev = mesh.devices[0] if P > 1 else resolve_device(opts.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    ds = Dataset.load(data_dir)
    sizes = [ds.num_features, *hidden, ds.num_labels]
    if P > 1:
        sizes[-1] = (sizes[-1] + P - 1) // P * P
    if opts.model == "sage":
        model, config = sage, sage.SAGEConfig(sizes=tuple(sizes))
    elif opts.model == "gat":
        model, config = gat, gat.GATConfig(sizes=tuple(sizes), heads=opts.heads, edge_weighted=opts.edge_weighted)
    else:
        model, config = gcn, gcn.GCNConfig(sizes=tuple(sizes), residual=opts.residual)
    if opts.model != "gcn" and P > 1:
        print(f"distributed infer supports --model gcn only (got {opts.model}); use -P 1", file=sys.stderr)
        return 2
    template = model.init_params(config, device=dev)
    params, _ = load_checkpoint(opts.load, (template, adam.adam_init(template)))
    x = torch.from_numpy(np.ascontiguousarray(ds.features, np.float32))
    if P > 1:
        from . import sparse
        from .parallel import dist

        if ds.num_nodes % P:
            print(f"node count {ds.num_nodes} not divisible by P={P}", file=sys.stderr)
            return 2
        a = sparse.normalize(ds.graph, axis=True)
        pair = dist.DistAggPair.from_csr_pair(sparse.transpose(a), a, mesh)
        infer = dist.make_dist_infer(config, mesh)
        t0 = time.perf_counter()
        logits = infer(dist.replicate(params, mesh), pair, dist.shard(x, mesh))
        preds = torch.cat([torch.argmax(part, dim=-1).cpu() for part in logits]).numpy().astype(np.int32)
    else:
        pair = _single_pair(opts, ds.graph, dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = model.forward(params, pair, x.to(dev), config)
        preds = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
    dt = time.perf_counter() - t0
    acc = float((preds == ds.labels.reshape(-1)).mean())
    print(f"inference: n={ds.num_nodes} acc={acc} seconds={dt}", file=sys.stderr)
    out = opts.save or "predictions.bin"
    write_dense(out, preds.reshape(-1, 1), np.int32)
    print(f"wrote {out}", file=sys.stderr)
    return 0


def cmd_pagerank(opts) -> int:
    """PageRank of ``<data_dir>/graph.bin`` (``mg_gcn_tpu/cli.py:956-978``):
    ``-P 1`` through ``models.pagerank.pagerank`` (impl="auto"), ``-P N``
    through ``pagerank_dist`` on the ``--device`` ring. Writes
    ``pagerank.bin`` (float32, (n, 1)) or ``--save``."""
    from .formats import read_pigo_csr, write_dense
    from .models.pagerank import pagerank, pagerank_dist

    if not opts.args:
        print("pagerank requires: <data_dir>", file=sys.stderr)
        return 2
    try:
        mesh = _partition_ring(opts.device, opts.P) if opts.P > 1 else None
        dev = None if opts.P > 1 else resolve_device(opts.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    graph = read_pigo_csr(os.path.join(opts.args[0], "graph.bin"))
    t0 = time.perf_counter()
    if opts.P > 1:
        p = pagerank_dist(graph, mesh, damping=opts.damping, eps=opts.eps)
    else:
        p = pagerank(graph, damping=opts.damping, eps=opts.eps, device=dev)
    p = p.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"pagerank n={p.shape[0]} sum={p.sum():.3f} seconds={dt}", file=sys.stderr)
    out = opts.save or "pagerank.bin"
    write_dense(out, p.reshape(-1, 1), np.float32)
    print(f"wrote {out}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    if opts.multihost:  # the JAX CLI forms its multi-process runtime for every command
        print("not ported yet: --multihost: ROADMAP queue 1 item 9g", file=sys.stderr)
        return 2
    commands = {"train": cmd_train, "infer": cmd_infer, "pagerank": cmd_pagerank}
    if opts.command in commands:
        return commands[opts.command](opts)
    print(f"Unknown command: {opts.command}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
