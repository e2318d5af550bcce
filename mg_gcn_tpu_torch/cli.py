"""Command-line interface, the port of ``mg_gcn_tpu/cli.py`` (reference
main.cpp:50-133): ``train`` runs GCN, ``--model sage`` (GraphSAGE),
``--model gat [--heads H | H1,H2,...] [--edge-weighted] [--activation elu]
[--skip L1,...]`` and ``--model deepergcn [--layers L]`` (DeeperGCN's ResGEN with softmax_sg
at t = 0.1, one hidden width: ``train <data_dir> 1 128``)
on one card, with ``-P N -R 1``
GCN, SAGE and GAT row-partitioned over N partitions driven by this
process (``parallel/dist.py``, ``parallel/dist_halo.py``,
``parallel/dist_gat.py``; each model's layers are ``models/``'s, one block
a partition). At ``-P N`` GAT refuses ``--edge-weighted`` (the partitions'
blocks hold no edge values) and ``--activation elu`` / ``--skip``, which
the shared layers would run but no test holds there yet. With ``-P N -R 0``
GCN runs column-parallel (``parallel/dist_col.py``). ``infer`` loads a
checkpoint and writes the forward pass's predictions; ``pagerank`` runs the
power iteration. ``--multihost`` joins a run of several processes
(``parallel/multihost.py``, from the ``MG_GCN_*`` variables): ``-P N -R 1``
GCN, SAGE and GAT and ``-P N -R 0`` split their partitions over the
processes, GCN and SAGE reading only each process's row slabs of the graph
under ``--impl halo`` / ``auto``; ``--mmap`` maps ``features.bin`` instead
of reading it whole:

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
single-card GCN in float64 on the COO engine. Across processes every process
prints its epoch lines and process 0 alone writes the CSV and checkpoints;
``pagerank`` and ``infer`` exit with code 2 there, as the JAX CLI fails
there too.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import resolve_device


def _heads(text: str) -> int | tuple[int, ...]:
    """``--heads``: one count for every GAT layer, or a comma list of one a
    layer (``4,4,6``)."""
    counts = tuple(int(h) for h in text.split(","))
    return counts[0] if len(counts) == 1 else counts


def _layers(text: str) -> tuple[int, ...]:
    """``--skip``: a comma list of layer indices (empty: none)."""
    return tuple(int(i) for i in text.split(",") if i.strip())


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
    p.add_argument("--model", default="gcn", choices=["gcn", "sage", "gat", "deepergcn"])
    p.add_argument("--heads", type=_heads, default=1,
                   help="attention heads per GAT layer, or a comma list of one count a layer (--model gat; concat "
                        "on hidden layers, mean on the output)")
    p.add_argument("--activation", default="leaky", choices=["leaky", "elu"],
                   help="activation between GAT layers: LeakyReLU 0.01 or ELU (--model gat, one card)")
    p.add_argument("--skip", type=_layers, default=(),
                   help="comma list of GAT layers whose input is added to their output before the activation "
                        "(equal widths; --model gat, one card)")
    p.add_argument("--edge-weighted", action="store_true",
                   help="weight the GAT attention by the graph's positive edge values (--model gat, one card)")
    p.add_argument("--layers", type=int, default=None,
                   help="GENConv layers (--model deepergcn; default 28, the ogbn-arxiv model)")
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


def _one_process_only(opts, processes: int) -> str | None:
    """Why ``opts`` cannot run across ``processes``, or None: ``pagerank``
    and ``infer`` gather a jax.Array that spans other processes' devices in
    the JAX CLI, which raises there, so the port has no multi-process form
    to hold them against."""
    if processes == 1:
        return None
    where = {"pagerank": "mg_gcn_tpu/models/pagerank.py:209", "infer": "mg_gcn_tpu/cli.py:925"}.get(opts.command)
    if where is None:
        return None
    return (f"{opts.command} across processes is not supported: the JAX package fails there too ({where} raises"
            " RuntimeError: Fetching value for jax.Array that spans non-addressable (non process local) devices"
            " is not possible)")


def _features(ds, dtype=np.float32) -> torch.Tensor:
    """The features as a host tensor of ``dtype``; a mapped file is read
    into memory here (the one-card paths hold every row)."""
    f = ds.features
    return torch.from_numpy(np.array(f, dtype) if isinstance(f, np.memmap) else np.ascontiguousarray(f, dtype))


def _main_process() -> bool:
    """Process 0 writes the run's files (CSV, checkpoints)."""
    from .parallel import multihost

    return multihost.process_index() == 0


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
    if opts.activation != "leaky" or opts.skip:
        if opts.model != "gat":
            return "--activation and --skip are GAT options (--model gat)"
        if opts.P > 1:
            return "--activation elu and --skip run on one card (the distributed GAT step has neither); use -P 1"
    return _invalid_deepergcn(opts)


def _invalid_deepergcn(opts) -> str | None:
    """``--model deepergcn``'s refusals (no JAX counterpart), or None."""
    if opts.model != "deepergcn":
        if opts.layers is not None:
            return "--layers is a DeeperGCN option (--model deepergcn)"
        return None
    if opts.P > 1:
        return ("--model deepergcn runs on one card (its BatchNorm statistics are not summed across "
                "partitions); use -P 1")
    if opts.impl not in ("auto", "gather"):
        return "--model deepergcn runs on the binary CSR walk; use --impl auto or gather"
    if opts.pattern_dtype == "int8":
        return ("--model deepergcn rounds its aggregation operand to bfloat16 or float32 (the operand is made "
                "every step: no int8 path)")
    if opts.residual:
        return "--residual is a GCN option (--model gcn; DeeperGCN's res+ blocks are always residual)"
    return None


def _gat_config(opts, sizes, **kw):
    """``--model gat``'s configuration from the flags."""
    from .models import gat

    return gat.GATConfig(sizes=tuple(sizes), heads=opts.heads, edge_weighted=opts.edge_weighted,
                         activation=opts.activation, skip=opts.skip, **kw)


def _deepergcn_config(opts, sizes, **kw):
    """``--model deepergcn``'s configuration from the flags: ``sizes`` is
    (features, the one hidden width, classes)."""
    from .models import deepergcn

    if len(sizes) != 3:
        raise ValueError(f"--model deepergcn takes one hidden width (all its GENConv layers are that wide; "
                         f"--layers gives the depth), got {len(sizes) - 2}")
    layers = {} if opts.layers is None else dict(layers=opts.layers)
    return deepergcn.DeeperGCNConfig(sizes=tuple(sizes), operand=opts.pattern_dtype, **layers, **kw)


def cmd_train(opts) -> int:
    invalid = _invalid(opts)
    if invalid:
        print(invalid, file=sys.stderr)
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
    from .models import deepergcn, gat, gcn, sage
    from .nn import adam
    from .parallel import multihost
    from .timers import TimerRegistry, trace

    P, processes = opts.P, multihost.process_count()
    try:
        if P > 1 or processes > 1:
            mesh = _partition_ring(opts.device, P)
            dev = mesh.devices[0]
        else:
            dev = resolve_device(opts.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    # across processes the halo pair builds from each process's row slabs
    # (mg_gcn_tpu/cli.py:238-262): no process reads the whole graph
    slab_graph = (processes > 1 and P > 1 and opts.R == 1 and opts.impl in ("halo", "auto")
                  and opts.model in ("gcn", "sage") and not opts.f64)
    ds = Dataset.load(data_dir, mmap_features=opts.mmap, graph_mode="header" if slab_graph else "full")
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
        try:
            config = _gat_config(opts, sizes, loss_mask=loss_mask)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        params = gat.init_params(config, opts.seed, device=dev)
    elif opts.model == "deepergcn":
        try:
            config = _deepergcn_config(opts, sizes, loss_mask=loss_mask)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        params = deepergcn.init_params(config, opts.seed, device=dev)
    elif opts.model == "sage":
        config = sage.SAGEConfig(sizes=tuple(sizes), loss_mask=loss_mask)
        params = sage.init_params(config, opts.seed, device=dev)
    else:
        config = gcn.GCNConfig(sizes=tuple(sizes), parity=not opts.exact, residual=opts.residual,
                               loss_mask=loss_mask)
        params = gcn.init_params(config, opts.seed, device=dev,
                                 dtype=torch.float64 if opts.f64 else torch.float32)
    timers = TimerRegistry()
    if _main_process():  # the JAX CLI makes it on every process (ROADMAP queue 3)
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
    if _main_process():  # the JAX CLI lets every process write these (ROADMAP queue 3)
        with open(csv_path, "w") as f:
            timers.dump(f)
        if opts.save:
            save_checkpoint(opts.save, (params, opt_state))
    return 0


def _partition_ring(spec: str, P: int):
    """The ring of ``-P`` partitions for ``--device``: ``cuda`` is ``cuda:0 ..
    cuda:P-1`` (fewer visible cards raise with the JAX CLI's message); one
    other device takes all P partitions; a comma list names each
    partition's device. Across W processes the same for this process's P / W
    partitions, ``cuda`` meaning the cards of ``MG_GCN_LOCAL_DEVICE_IDS``."""
    from .parallel import multihost
    from .parallel.dist import make_mesh

    processes = multihost.process_count()
    if P % processes:
        raise ValueError(f"-P {P} partitions do not split evenly over {processes} processes")
    local = P // processes
    names = [d.strip() for d in spec.split(",")]
    if names == ["cuda"]:
        try:
            return make_mesh(P)
        except ValueError:
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise ValueError(f"requested -P {P} but only {visible} devices visible") from None
    if len(names) == 1:
        names = names * local
    if len(names) != local:
        raise ValueError(f"--device lists {len(names)} devices for -P {P}"
                         + (f" over {processes} processes ({local} a process)" if processes > 1 else ""))
    return make_mesh(P, names)


def _run_epochs(opts, step, args, params, opt_state, timers, save_view=lambda p, o: (p, o)):
    """The epoch loop: ``epoch loss acc seconds`` on stderr, a timer per
    epoch, and ``--save-every`` checkpoints of ``save_view(params, state)``
    (called on every process, written by process 0)."""
    from .checkpoint import save_checkpoint

    for e in range(opts.E):
        t0 = time.perf_counter()
        params, opt_state, loss, acc = step(params, opt_state, *args)
        loss, acc = float(loss), float(acc)  # waits for the card, like ctx.sync()
        dt = time.perf_counter() - t0
        timers.record(f"{e}_0_epoch", dt * 1e3)
        print(f"{e} {loss} {acc} {dt}", file=sys.stderr)
        if opts.save_every and opts.save and (e + 1) % opts.save_every == 0:
            view = save_view(params, opt_state)  # on every process: it may gather
            if _main_process():
                save_checkpoint(opts.save, view)
    return params, opt_state


def _single_pair(opts, graph, dev):
    """The one-card operator of ``--model``: GAT's attention graph, SAGE's
    row-normalized pair, DeeperGCN's binary pair or GCN's aggregation
    pair."""
    from .models import deepergcn, gat, sage
    from .train import build_agg_pair

    if opts.model == "deepergcn":
        return deepergcn.build_deepergcn_graph(graph, device=dev)
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
        x = _features(ds, np.float64 if opts.f64 else np.float32).to(dev)
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


def _slab_halo_pair(header, mesh, norm: str, pair_kind: str):
    """The halo pair from each process's row slabs of ``graph.bin`` and
    ``graph_t.bin`` (``mg_gcn_tpu/cli.py:487-515``): process 0 checks that
    ``graph_t.bin`` is there and matches ``graph.bin``
    (``formats.check_pigo_transpose``), every process learns the outcome
    (a broadcast, the barrier), then ``DistHaloPair.from_pigo`` builds. A
    missing or stale transpose raises ValueError on every process, naming
    ``ensure_pigo_transpose``: the JAX CLI's transpose of the whole graph
    on process 0 has no counterpart (ROADMAP queue 3)."""
    from .formats import check_pigo_transpose
    from .parallel import multihost
    from .parallel.dist_halo import DistHaloPair

    d_dir = os.path.dirname(header.path)
    problem = None
    if mesh.rank == 0:
        try:
            check_pigo_transpose(d_dir)
        except ValueError as exc:
            problem = str(exc)
    problem = multihost.broadcast_object(problem)
    if problem:
        raise ValueError(problem)
    return DistHaloPair.from_pigo(header.path, os.path.join(d_dir, "graph_t.bin"), mesh,
                                  engine="gather" if pair_kind == "halo_gather" else "xla", norm=norm)


def _train_dist(opts, ds, config, hparams, params, opt_state, timers, mesh):
    """``-P N -R 1`` GCN (``mg_gcn_tpu/cli.py:517-694``): the pair
    ``train.dist_engine`` picks. The row-partitioned pattern pair where the
    JAX CLI's gate takes it (on a card; on the CPU where ``--impl pattern``
    asks; one process only), with the fused ring exchange by default;
    ``--impl gather`` the serial-gather ring blocks; ``--impl halo``, and
    ``auto`` otherwise, the halo pair (its local engine by
    ``train.halo_engine``; across processes from each one's row slabs); any
    other impl the COO ring pair. Returns (params, opt_state, exit code)."""
    from . import sparse
    from .formats import GraphHeader
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
        pair_kind, why = dist_engine(ds.graph, opts.impl, P, per_card, card, processes=mesh.world)
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
            if isinstance(ds.graph, GraphHeader):
                try:
                    pair = _slab_halo_pair(ds.graph, mesh, "gcn", pair_kind)
                except ValueError as exc:
                    print(exc, file=sys.stderr)
                    return params, opt_state, 2
            else:
                a = sparse.normalize(ds.graph, axis=True)  # main.cpp:143
                pair = dist.build_pair(pair_kind, sparse.transpose(a), a, mesh)
                del a
            if pair_kind in ("halo", "halo_gather"):
                _halo_lines(pair, P, n)
            xs, ys, masks = dist.shard_dataset(ds, mesh, mask_train=opts.mask_train)
    params, opt_state = _run_epochs(opts, step, (pair, xs, ys, masks), dist.replicate(params, mesh),
                                    dist.replicate(opt_state, mesh), timers, save_view=lambda p, o: (p[0], o[0]))
    return params[0], opt_state[0], 0


def _train_dist_sage(opts, ds, config, hparams, params, opt_state, timers, mesh):
    """``--model sage -P N -R 1`` (``mg_gcn_tpu/cli.py:697-795``) over the
    mean pair (M, Mᵀ): ``--impl halo`` the halo pair (its local engine by
    ``train.halo_engine``, through ``train.dist_engine``), ``--impl
    gather`` the serial-gather ring blocks, every other impl (``auto``
    too) the COO ring pair; ``-S`` the all_gather exchange. Across
    processes ``--impl halo`` and ``auto`` build the halo pair from each
    process's row slabs (:func:`_slab_halo_pair`). Returns (params,
    opt_state, exit code)."""
    from . import sparse
    from .formats import GraphHeader
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
    # SAGE's auto takes COO (cli.py:743-745), but the slab build halo;
    # halo and gather as the GCN path
    on_disk = isinstance(ds.graph, GraphHeader)
    pair_kind = "coo"
    if opts.impl in ("halo", "gather") or on_disk:
        pair_kind = dist_engine(ds.graph, "halo" if on_disk else opts.impl, P, P, _card_bytes(mesh),
                                processes=mesh.world)[0]
    try:  # a halo pair asked for the all_gather exchange: the JAX step's refusal
        step = dist.make_dist_sage_train_step(config, mesh, n, hparams, strategy=strategy, pair_kind=pair_kind)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return params, opt_state, 2
    with timers.span("0_preprocess"):
        if on_disk:
            try:
                pair = _slab_halo_pair(ds.graph, mesh, "sage", pair_kind)
            except ValueError as exc:
                print(exc, file=sys.stderr)
                return params, opt_state, 2
        else:
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
    Across processes each reads the whole graph, as the JAX CLI does, and
    builds its own partitions' blocks. Returns (params, opt_state, exit
    code)."""
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
    zero-padded to it. Across processes each holds Âᵀ on its cards and its
    partitions' column shards. Checkpoints hold the full (rounded) arrays,
    gathered on every process. Returns (params, opt_state, exit code)."""
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
        save_view=lambda p, o: (dist_col.gather_col_params(p, mesh), dist_col.gather_col_state(o, mesh)))
    return dist_col.gather_col_params(params, mesh), dist_col.gather_col_state(opt_state, mesh), 0


def cmd_infer(opts) -> int:
    """Inference: load a checkpoint, run the forward pass and write the
    predictions (``mg_gcn_tpu/cli.py:841-949``; the reference's
    gcn::operator(), gcn.hpp:966-969). GCN, SAGE, GAT and DeeperGCN (its
    BatchNorm over the whole graph, as in training) on one card, GCN
    at ``-P N -R 1`` through ``parallel.dist.make_dist_infer`` on the COO
    ring pair. Writes ``predictions.bin`` (int32, (n, 1)) or ``--save``."""
    from .checkpoint import load_checkpoint
    from .formats import Dataset, write_dense
    from .models import deepergcn, gat, gcn, sage
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
    ds = Dataset.load(data_dir, mmap_features=opts.mmap)
    sizes = [ds.num_features, *hidden, ds.num_labels]
    if P > 1:
        sizes[-1] = (sizes[-1] + P - 1) // P * P
    if opts.model == "sage":
        model, config = sage, sage.SAGEConfig(sizes=tuple(sizes))
    elif opts.model in ("gat", "deepergcn"):
        try:
            model, config = (gat, _gat_config(opts, sizes)) if opts.model == "gat" else \
                (deepergcn, _deepergcn_config(opts, sizes))
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
    else:
        model, config = gcn, gcn.GCNConfig(sizes=tuple(sizes), residual=opts.residual)
    if opts.model != "gcn" and P > 1:
        print(f"distributed infer supports --model gcn only (got {opts.model}); use -P 1", file=sys.stderr)
        return 2
    template = model.init_params(config, device=dev)
    params, _ = load_checkpoint(opts.load, (template, adam.adam_init(template)))
    x = _features(ds)
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
    from .parallel import multihost

    opts = build_parser().parse_args(argv)
    if opts.multihost:  # the JAX CLI forms its multi-process runtime for every command
        try:
            multihost.initialize()
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
    try:
        refused = _one_process_only(opts, multihost.process_count())
        if refused:
            print(refused, file=sys.stderr)
            return 2
        commands = {"train": cmd_train, "infer": cmd_infer, "pagerank": cmd_pagerank}
        if opts.command in commands:
            return commands[opts.command](opts)
        print(f"Unknown command: {opts.command}", file=sys.stderr)
        return 2
    finally:
        # leave the group before exit: a gloo group torn down by the
        # interpreter's exit while a peer disconnects can abort the process
        multihost.shutdown()


if __name__ == "__main__":
    sys.exit(main())
