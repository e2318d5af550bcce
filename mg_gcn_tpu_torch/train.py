"""Single-card training: the aggregation pair, the train step (GCN, SAGE
and GAT), the multi-epoch step and the GCN epoch loop.

Port of ``mg_gcn_tpu/train.py:121-432`` (the reference's single-GPU path,
main.cpp:113-133): per epoch ``forward -> backward -> update -> sync``,
printing ``epoch loss acc seconds`` to stderr. PyTorch runs eagerly, so the
step is a plain function; nothing is compiled. The multi-epoch step
(:func:`make_scan_train_steps`, the JAX package's ``lax.scan``) captures
the step on a card once as a CUDA graph and replays it an epoch at a time.
"""

from __future__ import annotations

import gc
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from . import resolve_device, sparse
from .formats import CSRData, Dataset, GraphHeader
from .models.gcn import GCNConfig, init_params, loss_and_grad
from .nn import adam
from .ops import spmm_edges, spmm_gather, spmm_pattern, spmm_pattern_sparse
from .ops.spmm import AggPair, COOMat
from .ops.spmm_pallas import TiledMat
from .timers import TimerRegistry, scope

IMPLS = ("auto", "pattern", "block", "edge", "gather", "xla", "pallas")
# impl="auto" takes the block pair over the dense pack when tiles or planes
# are this sparse (the JAX package's rule, train.py:165-179)
BLOCK_TILE_OCC_MAX = 0.5
BLOCK_PLANE_OCC_MAX = 0.3
# expected edge-tile slot fill at and above which the edge engine is taken
# over the gather engine (the JAX package's crossover, train.py:65-75)
EDGE_FILL_MIN = 0.3
# impl="auto" takes the binary CSR walk over a pack that fits up to this
# share of the pack's bits set: on uniform graphs on an H100 the walk's
# products of a GCN epoch beat the pattern pair's at 1 bit in 8 and lost at
# 1 in 4 at n = 65,536, and won at every density from 1 in 32 down at
# n = 233,472 (scripts/probe_walk_vs_pack.py)
WALK_DENSITY_MAX = 1 / 8
ENGINE_OF = {
    spmm_pattern.PatternMat: "pattern",
    spmm_pattern_sparse.BlockPatternMat: "block",
    spmm_edges.EdgeTileMat: "edge",
    spmm_gather.GatherMat: "gather",
    COOMat: "xla",
    TiledMat: "pallas",
}


def _edge_or_gather(graph: CSRData) -> str:
    """The O(nnz) engine for ``graph``: "edge" when the expected edge-tile
    slot fill is at least EDGE_FILL_MIN, else "gather".

    The JAX package also asks ``_gather_feasible`` (the TPU's SMEM step
    budget) and takes "edge" where a gather schedule would not fit. The card
    has no such budget, so for a graph the TPU finds infeasible the two
    packages pick different engines (ROADMAP queue 3)."""
    fill = spmm_edges.expected_fill(graph.nrows, graph.ncols, graph.nnz)
    return "edge" if fill >= EDGE_FILL_MIN else "gather"


def auto_engine(graph: CSRData, card_bytes: int | None, pre_normalized: bool = False,
                pattern_dtype: str = "bfloat16") -> tuple[str, str]:
    """(engine, reason) of :func:`_auto_pick`."""
    impl, why, _ = _auto_pick(graph, card_bytes, pre_normalized, pattern_dtype)
    return impl, why


def _auto_pick(graph: CSRData, card_bytes: int | None, pre_normalized: bool,
               pattern_dtype: str) -> tuple[str, str, bool]:
    """(engine, reason, stream_bf16) that impl="auto" picks for ``graph`` on
    a card of ``card_bytes`` memory, or on the CPU for ``card_bytes=None``,
    with the products' operand in ``pattern_dtype``. From the JAX package's rule
    (train.py:161-187), for a raw binary adjacency: the block pair when tile
    occupancy < BLOCK_TILE_OCC_MAX or plane occupancy < BLOCK_PLANE_OCC_MAX
    and its store (tile occupancy x n_pad²/8) fits PATTERN_MEM_FRACTION of
    the card and the builder's int32 addressing
    (``spmm_pattern_sparse.MAX_STORE_WORDS``); else, when the n_pad²/8 pack
    fits, the binary CSR walk ("gather") where its kernel takes the operand
    dtype (float32, bfloat16), at most WALK_DENSITY_MAX of the pack's bits
    are set, the entries fit its int32 indices and its two index lists
    (4·nnz + 8·(n + 1) bytes each) the pack's budget; else the pattern
    pair; else :func:`_edge_or_gather`, as for a weighted adjacency. The
    JAX rule keeps the pattern pair where the pack fits (ROADMAP queue 3).
    On the CPU the COO engine. The occupancies come from the CSR arrays; a
    graph known by its counts only skips the block rule.

    ``stream_bf16`` is true only where the walk takes a pack's place with a
    bfloat16 operand: it then keeps the pattern pair's rounding points, the
    operand streamed in bfloat16. Every other gather pick is float32."""
    if card_bytes is None:
        return "xla", "no card", False
    pack_gb, budget_gb = spmm_pattern.pack_budget_gb(graph.nrows, card_bytes)
    binary = not pre_normalized and spmm_pattern.is_binary(graph)
    occ = ""
    if binary and hasattr(graph, "indptr"):
        tile_occ, plane_occ = spmm_pattern_sparse.estimate_occupancy(graph)
        occ = f"tile occupancy {tile_occ:.3f}, plane occupancy {plane_occ:.3f}, "
        sparse_tiles = tile_occ < BLOCK_TILE_OCC_MAX or plane_occ < BLOCK_PLANE_OCC_MAX
        store_gb, addressable_gb = tile_occ * pack_gb, spmm_pattern_sparse.MAX_STORE_WORDS * 4 / 1e9
        if sparse_tiles and store_gb <= budget_gb and store_gb < addressable_gb:
            return "block", f"binary adjacency, {occ}block store {store_gb:.2f} GB within {budget_gb:.1f} GB", False
    if not pre_normalized and spmm_pattern.pattern_feasible(graph, card_bytes):
        bits = pack_gb * 8e9
        walk_gb = (4 * graph.nnz + 8 * (graph.nrows + 1)) / 1e9
        limits = (
            (spmm_pattern.DTYPES.get(pattern_dtype) in spmm_gather._B_CODE, "which the CSR walk does not take"),
            (graph.nnz <= WALK_DENSITY_MAX * bits, f"denser than 1 bit in {1 / WALK_DENSITY_MAX:g}"),
            (graph.nnz < 2**31, "2^31 entries or more (the walk's int32 indices)"),
            (2 * walk_gb <= budget_gb, "two index lists past the budget"),
        )
        past = [text for ok, text in limits if not ok]
        why = (f"binary adjacency, {occ}bit pack {pack_gb:.3g} GB within {budget_gb:.1f} GB, 1 bit in"
               f" {bits / max(graph.nnz, 1):.3g} set, CSR index list {walk_gb:.3g} GB, {pattern_dtype} operand"
               + "".join(f", {text}" for text in past))
        return ("pattern", why, False) if past else ("gather", why, pattern_dtype == "bfloat16")
    why = f"bit pack {pack_gb:.1f} GB over {budget_gb:.1f} GB" if binary else "weighted adjacency"
    fill = spmm_edges.expected_fill(graph.nrows, graph.ncols, graph.nnz)
    impl = _edge_or_gather(graph)
    return impl, f"{why}, expected edge-tile fill {fill:.3f} {'>=' if impl == 'edge' else '<'} {EDGE_FILL_MIN}", False


def card_memory(dev: torch.device) -> int | None:
    """The memory of card ``dev``, or None for the CPU: the card size the
    rules of impl="auto" take."""
    return torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else None


def mean_engine(graph: CSRData, dev: torch.device, have_pack: bool = False) -> str:
    """The engine impl="auto" picks for the row-normalized operators of SAGE
    and PageRank (``mg_gcn_tpu/models/sage.py:71-83``,
    ``pagerank.py:41-49``): the pattern pair when a pack is at hand or
    :func:`~.ops.spmm_pattern.pattern_feasible` (GCN's pack rule), else on a
    card :func:`_edge_or_gather` and on the CPU the COO engine. No block
    rule, as in the JAX package. On a card one stderr line names the engine."""
    card = card_memory(dev)
    if have_pack or spmm_pattern.pattern_feasible(graph, card):
        impl = "pattern"
    else:
        impl = "xla" if card is None else _edge_or_gather(graph)
    if card is not None:
        print(f"aggregation engine: {impl} (auto, row-normalized operator)", file=sys.stderr)
    return impl


def dist_pattern_engine(graph: CSRData, parts: int, per_card: int, card_bytes: int) -> tuple[bool, str]:
    """(take the pattern pair, reason) at ``parts`` partitions: the JAX
    CLI's gate (cli.py:546-552), a binary adjacency whose two packs,
    2·n²/8/P bytes a partition, fit PATTERN_MEM_FRACTION of a card of
    ``card_bytes``. A card holds the packs of all its ``per_card``
    partitions."""
    if not spmm_pattern.is_binary(graph):
        return False, "weighted adjacency"
    pack_gb = 2 * graph.nrows**2 / 8 / parts * per_card / 1e9
    budget_gb = spmm_pattern.PATTERN_MEM_FRACTION * card_bytes / 1e9
    fits = pack_gb <= budget_gb
    return fits, (f"binary adjacency, packs of {per_card} partition(s) {pack_gb:.2f} GB a card"
                  f" {'within' if fits else 'over'} {budget_gb:.1f} GB")


def halo_engine(graph: CSRData | GraphHeader, on_card: bool) -> str:
    """The local engine of the halo pair (``mg_gcn_tpu/train.py:78-119``):
    on a card "gather" when the expected edge-tile slot fill of the whole
    graph is below EDGE_FILL_MIN, else "xla" (COO); on the CPU "xla", as
    the JAX package takes off the TPU. ``graph`` may be a
    :class:`~.formats.GraphHeader`: the rule reads its counts only, and asks
    no slab budget of ``graph.bin`` or ``graph_t.bin`` (ROADMAP queue 3).

    The JAX package also asks ``_gather_feasible`` of the largest row slab's
    block (the TPU's SMEM step budget) and takes "xla" where it fails. The
    card has no such budget (as in :func:`_edge_or_gather`), so for such a
    graph the two packages pick different engines (ROADMAP queue 3)."""
    if not on_card:
        return "xla"
    fill = spmm_edges.expected_fill(graph.nrows, graph.ncols, graph.nnz)
    return "gather" if fill < EDGE_FILL_MIN else "xla"


def dist_engine(graph: CSRData | GraphHeader, impl: str, parts: int, per_card: int, card_bytes: int | None,
                processes: int = 1) -> tuple[str, str]:
    """(pair kind, reason) of the ``-P N -R 1`` GCN path for ``impl``, as
    the JAX CLI picks it (``mg_gcn_tpu/cli.py:543-640``), with ``per_card``
    of the ``parts`` partitions on each card of ``card_bytes`` memory (None:
    the CPU): "pattern" where impl is auto or pattern and
    :func:`dist_pattern_engine` takes the pack (on the CPU only where
    ``--impl pattern`` asks, for a binary adjacency); "gather" for impl
    gather; for impl halo, and for auto otherwise, "halo" or "halo_gather"
    by :func:`halo_engine`'s local engine; else "coo". The pattern pair is
    gated off across ``processes`` > 1 and for a graph left on disk (a
    :class:`~.formats.GraphHeader`), as the JAX CLI gates it (cli.py:548).
    impl="pattern" where the pack cannot run raises."""
    why = "no card"
    if impl in ("auto", "pattern"):
        if processes > 1 or isinstance(graph, GraphHeader):
            fits, why = False, f"{processes} processes" if processes > 1 else "graph on disk"
        elif card_bytes is None:
            fits = impl == "pattern" and spmm_pattern.is_binary(graph)
        else:
            fits, why = dist_pattern_engine(graph, parts, per_card, card_bytes)
        if fits:
            return "pattern", why
        if impl == "pattern":
            raise ValueError("pattern impl not applicable here")
    if impl == "gather":
        return "gather", "--impl gather"
    if impl in ("auto", "halo"):
        local = halo_engine(graph, card_bytes is not None)
        return ("halo_gather" if local == "gather" else "halo"), f"{why}; halo local engine {local}"
    return "coo", f"--impl {impl}"


def build_agg_pair(
    graph: CSRData,
    impl: str = "auto",
    pattern_dtype: str = "bfloat16",
    device: str | torch.device = "cuda",
    pre_normalized: bool = False,
    tile_br: int = 512,
    tile_bc: int = 512,
    coo_val_dtype=np.float32,
) -> AggPair:
    """Host preprocessing -> the device-resident (Âᵀ, Â) aggregation pair
    (gcn ctor, gcn.hpp:946-954: column-normalize A by in-degree, transpose;
    forward multiplies by Âᵀ, backward by Â). ``pre_normalized`` takes
    ``graph`` as Â already.

    impl:
      "auto"    — :func:`auto_engine`; on CUDA one stderr line names the
                  engine and the reason. Where it takes the binary CSR walk
                  over a pack that fits, the walk keeps the pattern pair's
                  rounding points: a bfloat16 ``pattern_dtype`` streams the
                  (pre-scaled) operand in bfloat16 (:func:`_auto_pick`'s
                  ``stream_bf16``).
      "pattern" — the bit-packed dense-pattern kernel pair (raw binary
                  adjacency only).
      "block"   — the block-sparse pattern kernel pair over the occupied
                  tiles (raw binary adjacency only), in ``pattern_dtype``.
      "edge"    — the weighted-CSR edge kernels, in ``pattern_dtype``
                  (bfloat16, float32 or int8).
      "gather"  — the serial-gather kernel, float32: a raw binary adjacency
                  takes the w-less pair with diagonal scales
                  (spmm_gather.gather_pair_from_binary_csr).
      "xla"     — the COO engine (index_select + index_add_), its values
                  in ``coo_val_dtype`` (np.float64: the f64 mode).
      "pallas"  — the tiled-ELL kernel, float32, (tile_br × tile_bc) tiles
                  (a debug and cross-check engine: ``TiledMat.from_csr`` refuses a
                  store over 4e9 bytes).
    A build that cannot run raises; nothing falls back to another engine.
    """
    dev = resolve_device(device)
    if impl not in IMPLS:
        raise ValueError(f"unknown aggregation impl {impl!r} (expected {'/'.join(IMPLS)}; 'halo' is a "
                         "distributed mode — see parallel.dist_halo)")
    stream_bf16 = False
    if impl == "auto":
        card = card_memory(dev)
        impl, why, stream_bf16 = _auto_pick(graph, card, pre_normalized, pattern_dtype)
        if card is not None:
            print(f"aggregation engine: {impl} (auto: {why})", file=sys.stderr)
    if impl in ("pattern", "block"):
        if pre_normalized:
            raise ValueError(f"the {impl} pair needs the raw binary adjacency")
        build = (spmm_pattern.pattern_pair_from_binary_csr if impl == "pattern"
                 else spmm_pattern_sparse.block_pattern_pair_from_binary_csr)
        fwd, bwd = build(graph, dtype=pattern_dtype, device=dev)
        return AggPair(fwd=fwd, bwd=bwd)
    if impl == "gather" and not pre_normalized and bool((graph.data == 1).all()):
        fwd, bwd = spmm_gather.gather_pair_from_binary_csr(graph, device=dev, stream_bf16=stream_bf16)
        return AggPair(fwd=fwd, bwd=bwd)
    a = graph if pre_normalized else sparse.normalize(graph, axis=True)
    a_t = sparse.transpose(a)
    if impl == "gather":
        fwd, bwd = spmm_gather.gather_pair_from_csr_pair(a_t, a, device=dev)
    elif impl == "edge":
        fwd, bwd = spmm_edges.edge_pair_from_csr_pair(a_t, a, dtype=pattern_dtype, device=dev)
    elif impl == "pallas":
        fwd, bwd = (TiledMat.from_csr(m, br=tile_br, bc=tile_bc, device=dev) for m in (a_t, a))
    else:
        fwd, bwd = (COOMat.from_csr(m, device=dev, val_dtype=coo_val_dtype) for m in (a_t, a))
    return AggPair(fwd=fwd, bwd=bwd)


def make_train_step(
    config, hparams: dict | None = None, optimizer: str = "adam", model: str = "gcn"
) -> Callable:
    """The full train step:
    (params, opt_state, pair, x, y, mask) -> (params, opt_state, loss, acc).

    ``model`` selects the family: "gcn" (``pair`` an :class:`AggPair`,
    parity or exact per ``config.parity``), "sage" (``pair`` the
    ``models.sage.build_sage_pair`` pair, exact autograd) or "gat"
    (``pair`` the ``models.gat.build_gat_graph`` pair, exact autograd), as
    ``mg_gcn_tpu/train.py:283-290`` dispatches. Adam decays every ``W*``
    leaf (SAGE's ``Wself`` and ``Wneigh``)."""
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if model == "gcn":
        lag = loss_and_grad
    elif model == "gat":
        from .models.gat import loss_and_grad as lag
    elif model == "sage":
        from .models.sage import loss_and_grad as lag
    else:
        raise ValueError(f"unknown model {model!r}")
    hp = dict(adam.DEFAULT_HPARAMS)
    if hparams:
        hp.update(hparams)

    def step(params, opt_state, pair, x, y, mask):
        with scope("train-step"):
            loss, acc, grads = lag(params, pair, x, y, config, mask)
            with torch.no_grad(), scope("adam-update"):
                if optimizer == "adam":
                    params, opt_state = adam.adam_update(params, grads, opt_state, **hp)
                else:
                    params = adam.sgd_update(params, grads, hp["lr"], hp["weight_decay"])
        return params, opt_state, loss, acc

    return step


# steps make_scan_train_steps runs on scratch copies before its capture:
# they take the one-time work out of the captured region (each kernel
# library's nvcc build and load, the launchers' cudaFuncSetAttribute,
# autograd's device thread, cuBLAS's workspace for the capture stream)
SCAN_WARMUP_STEPS = 2


def scan_route(device: torch.device) -> tuple[str, str]:
    """(route, reason) of :func:`make_scan_train_steps` for tensors on
    ``device``, by rule before anything runs: "graph" (the step captured once
    as a CUDA graph, replayed an epoch at a time) on a card; "loop" (the
    step called an epoch at a time, nothing read back between epochs) on
    the CPU, which has no graphs, and where the card's current stream is
    capturing already: a capture does not nest, so the epochs go into the
    caller's graph."""
    if device.type != "cuda":
        return "loop", "the CPU has no CUDA graphs"
    with torch.cuda.device(device):
        if torch.cuda.is_current_stream_capturing():
            return "loop", "the current stream is capturing already; a capture does not nest"
    return "graph", "the step captured once as a CUDA graph, replayed an epoch at a time"


def _clone_tree(tree) -> list:
    return [{k: v.clone() for k, v in layer.items()} for layer in tree]


def _clone_state(state: adam.AdamState) -> adam.AdamState:
    return adam.AdamState(step=state.step.clone(), m=_clone_tree(state.m), v=_clone_tree(state.v))


def _leaves(params, state: adam.AdamState) -> list:
    """The tensors of (params, state), in one fixed order."""
    return [v for tree in (params, state.m, state.v) for layer in tree for v in layer.values()] + [state.step]


def _same(a, b) -> bool:
    """``a`` is ``b``, or both are tuples of the same objects (a GAT graph)."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(x is y for x, y in zip(a, b))
    return a is b


def _where(exc: BaseException) -> str:
    """The innermost line ``exc`` was raised from: the operation that broke
    a capture."""
    frames = traceback.extract_tb(exc.__traceback__)
    if not frames:
        return "an unknown operation"
    f = frames[-1]
    return f"{os.path.basename(f.filename)}:{f.lineno} ({(f.line or '').strip()})"


@dataclass
class _Capture:
    """One captured epoch: the graph and its static buffers."""

    key: tuple  # the leaves' names, shapes and dtypes
    inputs: tuple  # (pair, x, y, mask), held so their memory outlives the graph
    graph: Any
    params: list
    opt_state: adam.AdamState
    losses: torch.Tensor  # [num_epochs]
    accs: torch.Tensor
    epoch: torch.Tensor  # int64 (1,): the slot the next replay writes
    warmup_s: float
    capture_s: float


def _capture_key(params, opt_state) -> tuple:
    return tuple((i, k, tuple(v.shape), v.dtype) for i, layer in enumerate(params) for k, v in layer.items()) + (
        opt_state.step.dtype,)


def _capture(step, params, opt_state, pair, x, y, mask, num_epochs: int, model: str) -> _Capture:
    """Warm the step up on a side stream on scratch copies, then capture one
    epoch on that stream: the step on the static buffers, its results
    copied back into them, its loss and accuracy written into slot
    ``epoch`` of the outputs, ``epoch`` advanced, the cyclic collector off
    (``torch.cuda.graph`` collects once before it begins). A capture that
    fails raises with the line that broke it."""
    dev = x.device
    t0 = time.perf_counter()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        p, o = _clone_tree(params), _clone_state(opt_state)
        for _ in range(SCAN_WARMUP_STEPS):
            p, o, loss, acc = step(p, o, pair, x, y, mask)
    torch.cuda.current_stream(dev).wait_stream(side)
    loss_dtype, acc_dtype = loss.dtype, acc.dtype
    del p, o, loss, acc
    torch.cuda.synchronize(dev)
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    static_p, static_o = _clone_tree(params), _clone_state(opt_state)
    losses = torch.zeros(num_epochs, dtype=loss_dtype, device=dev)
    accs = torch.zeros(num_epochs, dtype=acc_dtype, device=dev)
    epoch = torch.zeros(1, dtype=torch.int64, device=dev)
    graph = torch.cuda.CUDAGraph()
    failure = None
    collecting = gc.isenabled()
    gc.disable()  # a graph the collector frees mid-capture (cudaGraphExecDestroy) would break the capture
    try:
        with torch.cuda.graph(graph, stream=side):
            try:
                p, o, loss, acc = step(static_p, static_o, pair, x, y, mask)
                for dst, src in zip(_leaves(static_p, static_o), _leaves(p, o)):
                    dst.copy_(src)
                losses.index_copy_(0, epoch, loss.reshape(1))
                accs.index_copy_(0, epoch, acc.reshape(1))
                epoch.add_(1)
            except Exception as exc:  # raised below, once the capture has ended
                failure = exc
    except Exception as exc:  # the capture's end; the first failure is the one to name
        failure = failure or exc
    finally:
        if collecting:
            gc.enable()
    if failure is not None:
        raise RuntimeError(f"CUDA graph capture of the {model} step failed at {_where(failure)}: "
                           f"{type(failure).__name__}: {failure}") from failure
    return _Capture(key=_capture_key(params, opt_state), inputs=(pair, x, y, mask), graph=graph, params=static_p,
                    opt_state=static_o, losses=losses, accs=accs, epoch=epoch, warmup_s=warmup_s,
                    capture_s=time.perf_counter() - t0)


class ScanSteps:
    """The callable :func:`make_scan_train_steps` returns: ``step`` (a
    :func:`make_train_step` step) ``num_epochs`` times a call, on the route
    :func:`scan_route` gives, with the last capture kept. A plain object,
    not a closure, so that dropping it frees its graph and pool at once: a
    graph freed by the cyclic collector during another capture would break
    that capture."""

    def __init__(self, step: Callable, num_epochs: int, model: str):
        self.step, self.num_epochs, self.model = step, num_epochs, model
        self.route: str | None = None
        self.captures: list[dict] = []  # warm-up and capture seconds, one entry a capture
        self._kept: _Capture | None = None

    def __call__(self, params, opt_state, pair, x, y, mask):
        route, why = scan_route(x.device)
        if route != self.route:
            print(f"scan route: {route} ({why})", file=sys.stderr)
            self.route = route
        if route == "loop":
            losses, accs = [], []
            for _ in range(self.num_epochs):
                params, opt_state, loss, acc = self.step(params, opt_state, pair, x, y, mask)
                losses.append(loss)
                accs.append(acc)
            return params, opt_state, torch.stack(losses), torch.stack(accs)
        key, inputs, cap = _capture_key(params, opt_state), (pair, x, y, mask), self._kept
        if cap is None or cap.key != key or not all(map(_same, cap.inputs, inputs)):
            self._kept = cap = None  # the old graph's memory goes before the new capture
            self._kept = cap = _capture(self.step, params, opt_state, pair, x, y, mask, self.num_epochs, self.model)
            self.captures.append(dict(warmup_s=cap.warmup_s, capture_s=cap.capture_s))
        for dst, src in zip(_leaves(cap.params, cap.opt_state), _leaves(params, opt_state)):
            dst.copy_(src)
        cap.epoch.zero_()
        for _ in range(self.num_epochs):
            cap.graph.replay()
        return _clone_tree(cap.params), _clone_state(cap.opt_state), cap.losses.clone(), cap.accs.clone()


def make_scan_train_steps(config, num_epochs: int, hparams: dict | None = None, model: str = "gcn") -> ScanSteps:
    """``num_epochs`` Adam steps of ``model`` ("gcn", "sage" or "gat", as
    :func:`make_train_step` dispatches) in one call:
    (params, opt_state, pair, x, y, mask) -> (params, opt_state,
    losses[num_epochs], accs[num_epochs]), the losses and accuracies tensors
    on the step's device. Port of ``mg_gcn_tpu/train.py:307-345``
    (``lax.scan``, one dispatch).

    The route is :func:`scan_route`'s, printed on stderr at the first call
    (and again where it changes). "graph": the first call warms the step up
    on copies (:data:`SCAN_WARMUP_STEPS` steps, whose results are dropped)
    and captures one epoch (:func:`_capture`); each call copies the caller's
    parameters and Adam state into the graph's buffers, replays the graph
    ``num_epochs`` times (Adam's step count and bias corrections live on the
    card, so each replay is the next epoch), reads nothing back, and returns
    clones that alias nothing. The graph is kept for the identity of
    (pair, x, y, mask) and the leaves' shapes and dtypes: a call on its own
    results replays it, another pair recaptures. The kernel wrappers count
    their host launches only: the warm-up steps' and the captured epoch's;
    a replay launches the graph, not the wrappers, so it adds nothing to
    their counters (a device trace of the replay sees its kernels).
    "loop": :func:`make_train_step`'s step ``num_epochs`` times, the losses
    stacked on the device. The returned :class:`ScanSteps` records its route
    in ``.route`` and each capture's warm-up and capture seconds in
    ``.captures``."""
    if num_epochs < 1:
        raise ValueError(f"num_epochs must be at least 1, got {num_epochs}")
    return ScanSteps(make_train_step(config, hparams, model=model), num_epochs, model)  # raises on an unknown model


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)
    accs: list = field(default_factory=list)
    epoch_seconds: list = field(default_factory=list)
    params: Any = None
    opt_state: Any = None
    engine: str = ""  # the aggregation engine the run used: a value of ENGINE_OF


def train(
    dataset: Dataset,
    hidden: list[int],
    epochs: int = 20,
    hparams: dict | None = None,
    config_kw: dict | None = None,
    impl: str = "xla",
    pattern_dtype: str = "bfloat16",
    seed: int | None = None,
    log: bool = True,
    timers: TimerRegistry | None = None,
    params: Any = None,
    opt_state: Any = None,
    f64: bool = False,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Full-batch training on one card (or the CPU with ``device="cpu"``).

    ``hidden`` is the list of hidden widths; the size schedule becomes
    [num_features, *hidden, num_labels] (main.cpp:93-98). ``seed=None`` uses
    the reference's bit-exact seed-99 init. ``f64`` runs the whole step in
    float64 on the COO engine (``mg_gcn_tpu/train.py:375-400``, the twin of
    the reference's double kernel templates): the float32 normalization's
    values widened, float64 features and init; no kernel of the port has a
    float64 mode, so other impls are refused.
    """
    if f64:
        if impl not in ("xla", "auto"):
            raise ValueError(
                f"f64 mode runs on the COO/XLA engine only (impl {impl!r}; "
                "the Pallas kernels compute in bf16/int8/f32)"
            )
        impl = "xla"
    fdt = np.float64 if f64 else np.float32
    dev = resolve_device(device)
    sizes = (dataset.num_features, *hidden, dataset.num_labels)
    config = GCNConfig(sizes=tuple(int(s) for s in sizes), **(config_kw or {}))
    pair = build_agg_pair(dataset.graph, impl=impl, pattern_dtype=pattern_dtype, device=dev, coo_val_dtype=fdt)
    x = torch.from_numpy(np.ascontiguousarray(dataset.features, fdt)).to(dev)
    y = torch.from_numpy(dataset.labels.reshape(-1).astype(np.int64)).to(dev)
    mask = None
    if config.loss_mask == "train":
        mask = torch.from_numpy(dataset.sets.reshape(-1) == 0).to(dev)
    if params is None:
        params = init_params(config, seed, device=dev, dtype=torch.float64 if f64 else torch.float32)
    if opt_state is None:
        opt_state = adam.adam_init(params)
    step = make_train_step(config, hparams)

    result = TrainResult(engine=ENGINE_OF[type(pair.fwd)])
    for e in range(epochs):
        t0 = time.perf_counter()
        params, opt_state, loss, acc = step(params, opt_state, pair, x, y, mask)
        loss, acc = float(loss), float(acc)  # waits for the card, like ctx.sync()
        dt = time.perf_counter() - t0
        result.losses.append(loss)
        result.accs.append(acc)
        result.epoch_seconds.append(dt)
        if timers is not None:
            timers.record(f"{e}_0_epoch", dt * 1e3)
        if log:
            print(f"{e} {loss} {acc} {dt}", file=sys.stderr)
    result.params, result.opt_state = params, opt_state
    return result
