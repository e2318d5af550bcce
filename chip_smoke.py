#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``mg_gcn_tpu_torch``.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, in order, each with its seconds; any failure exits non-zero before
the result line:

1. device — the card's name and power limit (nvidia-smi) and torch's name;
2. build  — nvcc builds the kernels from the sources in this checkout, one
   process per source, all at once;
3. kernels vs plain, n = 20,000 — each pattern kernel (fwd, bwd) x
   {bfloat16, float32, int8} x d in {41, 128}; ``edge`` in {bfloat16,
   float32} and ``edge_i8`` x d in {41, 128, 256} on a weighted graph;
   ``gather`` {weighted, binary, binary + bfloat16 stream} x d in
   {48, 100, 256} at average degree 50 — each against its plain PyTorch
   version on the card: float within rtol 1e-5 / atol 1e-6 of the output
   scale of the plain version summed in float64 (same rounded inputs; the
   reference does not move with the order of index_add_'s atomics), int8
   equal; each check logs the share of the tolerance it used;
4. main path at full width — bench.py's uniform configuration
   (n = 232,968, random_graph(n, 493, seed=1) ~ 115M edges, 608 features,
   41 classes, sizes (608, 128, 128, 41), parity mode, Adam, seed-99 init)
   through ``train.build_agg_pair`` / ``train.train`` with impl="auto":
   auto must pick the pattern pair; one float32 pattern step must agree
   with the COO engine (run with PyTorch's deterministic algorithms, so
   its sums, and the comparison, repeat from run to run) within rtol 1e-4: the loss, and every gradient leaf
   in norm, ||pattern - COO|| <= 1e-4 ||COO|| (element-wise, the two sum
   orders can put a near-zero pre-activation on either side of the
   LeakyReLU, which moves single elements by a step); then 5
   bfloat16 epochs and 1 int8 epoch with finite losses. The kernels' launch
   counters are zeroed before this phase and read after it: exactly 3 fwd +
   2 bwd launches an epoch in each dtype;
5. pattern kernels at the main-path shape — each kernel x dtype x width
   against its plain version again, timed with CUDA events beside its bound
   and beside torch.sparse.mm (float32; a yardstick the port never calls);
6. the O(nnz) engines on the main path's binary graph — ``train`` with
   impl="edge" (bfloat16) and impl="gather" (float32), 5 epochs each with
   finite losses, their epoch seconds beside the pattern pair's: evidence
   for the rule of impl="auto";
7. path A, weighted Reddit on the edge engine — the same graph with
   bench.py's edge values (rng(5).random + 0.5): auto must pick ``edge``;
   one float32 step against the COO engine by the rule of phase 4; 5
   bfloat16 epochs and 1 int8 epoch with finite losses; counters zeroed
   before and read after: exactly 5 ``edge`` launches an epoch (float32,
   bfloat16) and 5 ``edge_i8`` in the int8 epoch;
8. edge kernels at path A's shape — as phase 5, on path A's Âᵀ, then
   (logged only) ``gather`` on the same matrix;
9. path B, products scale on the gather engine — BASELINE config 2's model
   (100 features, 48 classes, sizes (100, 256, 256, 48)) on bench.py's
   uniform products graph, random_graph(2,449,029, 50, seed=3): auto must
   pick ``gather`` (the binary pair); one float32 step against the COO
   engine; 5 epochs with finite losses and exactly 5 ``gather`` launches an
   epoch; peak memory and the pair's build seconds;
10. gather kernel at path B's shape — as phase 5, on path B's Aᵀ, then
   (logged only) ``edge`` on the same matrix;
11. CLI — ``python -m mg_gcn_tpu_torch.cli -E 3 train <dir> 2 128 128`` on a
   small binary dataset: stderr lines and the timer CSV.

Then, each on its own line: the ``{"kernels": [...]}`` JSON, the
nvidia-smi name and power limit, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

N_MAIN, DEG_MAIN, FEATURES, CLASSES, HIDDEN = 232_968, 493, 608, 41, [128, 128]
N_SMALL, DEG_SMALL = 20_000, 64
WIDTHS = (41, 128)
DTYPES = ("bfloat16", "float32", "int8")
EPOCHS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}  # dense, no sparsity
KERNELS = {
    "pattern_fwd": "mg_gcn_tpu/ops/spmm_pattern.py:265",
    "pattern_bwd": "mg_gcn_tpu/ops/spmm_pattern.py:280",
    "edge": "mg_gcn_tpu/ops/spmm_edges.py:550",
    "edge_i8": "mg_gcn_tpu/ops/spmm_edges.py:604",
    "gather": "mg_gcn_tpu/ops/spmm_gather.py:499",
}
SOURCES = {"pattern_fwd": "spmm_pattern.cu", "pattern_bwd": "spmm_pattern.cu", "edge": "spmm_edges.cu",
           "edge_i8": "spmm_edges.cu", "gather": "spmm_gather.cu"}
# path A: bench.py's weighted section (edge values rng(5).random + 0.5 on
# the main path's graph); path B: BASELINE config 2's model on bench.py's
# uniform products-scale graph (bench.py:586, 607, 623)
EDGE_WIDTHS, GATHER_WIDTHS = (41, 128, 256), (48, 100, 256)
N_PROD, DEG_PROD, FEATURES_PROD, CLASSES_PROD, HIDDEN_PROD = 2_449_029, 50, 100, 48, [256, 256]
DEG_GATHER_SMALL = 50


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of ``fn`` over ``reps`` calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def operand(n_pad: int, d: int, dtype: str, seed: int) -> torch.Tensor:
    """A padded kernel operand (n_pad, d_pad) as the wrapper would pass it."""
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = torch.zeros((n_pad, sp.round_up(max(d, 8), 8)), device="cuda", dtype=sp.DTYPES[dtype])
    if dtype == "int8":
        b[:, :d] = torch.randint(-127, 128, (n_pad, d), device="cuda", generator=gen).to(torch.int8)
    else:
        b[:, :d] = torch.randn((n_pad, d), device="cuda", generator=gen).to(b.dtype)
    return b


def check_close(kind: str, got: torch.Tensor, want: torch.Tensor, dtype: str) -> tuple[float, float]:
    """(max |got - want|, share of the tolerance used); raises past it.

    ``want`` is the plain version's result: summed exactly (int64) for int8,
    which must be equal, and in float64 for a float kernel, so that the
    reference does not move with the order of CUDA ``index_add_``'s atomics
    from run to run. A float kernel is held within rtol 1e-5 / atol 1e-6 of
    the output's scale: its inputs are the reference's, rounded the same
    way, and only its float32 sums differ. The share used is the largest
    |got - want| / (1e-5 |want| + 1e-6 scale) over the elements."""
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if dtype == "int8":
        if err != 0.0:
            raise AssertionError(f"{kind}: int8 result differs from the plain version by {err}")
        return err, 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    use = float((diff / (1e-5 * want.double().abs() + 1e-6 * scale)).max()) if err else 0.0
    if not use <= 1.0:
        raise AssertionError(f"{kind}: {use:.3f} of the tolerance rtol 1e-5 / atol 1e-6 x {scale} used")
    return err, use


def phase_kernels_small() -> None:
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    g = sparse.random_graph(N_SMALL, DEG_SMALL, seed=3)
    fwd, _ = sp.pattern_pair_from_binary_csr(g, device="cuda")
    for name, kernel, plain in (("pattern_fwd", sp.pattern_fwd, sp.pattern_fwd_plain),
                                ("pattern_bwd", sp.pattern_bwd, sp.pattern_bwd_plain)):
        for dtype in DTYPES:
            for d in WIDTHS:
                b = operand(fwd.n_pad, d, dtype, seed=d)
                got = kernel(fwd.pack, b)
                torch.cuda.synchronize()
                err, use = check_close(f"{name} {dtype} d={d}", got, plain(fwd.pack, b, torch.float64), dtype)
                ms = cuda_ms(lambda: kernel(fwd.pack, b), 10)
                plain_ms = cuda_ms(lambda: plain(fwd.pack, b), 3)
                log(f"  {name} {dtype:8s} d={d:3d}: max_err {err:.3e} (tolerance used {use:.3f})"
                    f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")


def main_dataset():
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset

    t0 = time.perf_counter()
    g = sparse.random_graph(N_MAIN, DEG_MAIN, seed=1)
    # bench.py's uniform labels and planted features (sparse.planted_features)
    labels = np.random.default_rng(0).integers(0, CLASSES, N_MAIN).astype(np.int32)
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((CLASSES, FEATURES)).astype(np.float32)
    x = proj[labels] + 10.0 * rng.standard_normal((N_MAIN, FEATURES)).astype(np.float32)
    ds = Dataset(graph=g, features=x, labels=labels.reshape(-1, 1), sets=np.zeros((N_MAIN, 1), np.int32))
    log(f"  graph n={g.nrows} nnz={g.nnz} built in {time.perf_counter() - t0:.1f} s")
    return ds


def wrappers() -> dict:
    """Every kernel wrapper of the port, by the name the kernels line uses."""
    from mg_gcn_tpu_torch.ops import spmm_edges as se
    from mg_gcn_tpu_torch.ops import spmm_gather as sg
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    return {"pattern_fwd": sp.pattern_fwd, "pattern_bwd": sp.pattern_bwd, "edge": se.edge,
            "edge_i8": se.edge_i8, "gather": sg.gather}


def counts() -> dict:
    return {name: dict(fn.launches) for name, fn in wrappers().items()}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches.clear()


def per_dtype(c: dict, name: str, dtype: str) -> int:
    return sum(v for (dt, _), v in c[name].items() if dt == dtype)


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms, on for the COO step only: CUDA
    index_add_ (the COO engine's sum) then adds in a fixed order instead of
    by atomics, so the COO step, and the comparison against it, comes out
    the same in every run. warn_only: ops without a deterministic variant
    run as they are."""
    prev = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def coo_step(params, coo, x, y, config):
    """The COO engine's float32 step, run twice under :func:`deterministic`;
    logs whether the two repeat bit for bit."""
    from mg_gcn_tpu_torch.models.gcn import loss_and_grad

    with deterministic():
        first = loss_and_grad(params, coo, x, y, config)
        again = loss_and_grad(params, coo, x, y, config)
    same = bool(torch.equal(first[0], again[0])) and all(
        torch.equal(g[k], h[k]) for g, h in zip(first[2], again[2]) for k in g)
    log(f"  COO step repeats bit for bit: {same}")
    return first


def compare_with_coo(engine: str, got, coo) -> None:
    """One float32 step against the COO engine from the same parameters:
    the loss within rtol 1e-4 and every gradient leaf in norm,
    ||engine - COO|| <= 1e-4 ||COO|| (element-wise, the two sum orders can
    put a near-zero pre-activation on either side of the LeakyReLU, which
    moves single elements by a step)."""
    (loss_p, acc_p, grads_p), (loss_c, acc_c, grads_c) = got, coo
    if not math.isclose(float(loss_p), float(loss_c), rel_tol=1e-4):
        raise AssertionError(f"float32 {engine} loss {float(loss_p)} vs COO {float(loss_c)}")
    norm_err, worst, elem_err = 0.0, "", 0.0
    for i, (gp, gc) in enumerate(zip(grads_p, grads_c)):
        for k in gc:
            rel = float(torch.linalg.vector_norm(gp[k] - gc[k]) / torch.linalg.vector_norm(gc[k]))
            if not rel <= 1e-4:
                raise AssertionError(f"layer {i} grad {k}: ||{engine} - COO|| / ||COO|| = {rel} > 1e-4")
            if rel >= norm_err:
                norm_err, worst = rel, f"layer {i} {k}"
            elem_err = max(elem_err, float((gp[k] - gc[k]).abs().max() / gc[k].abs().max()))
    log(f"  first step: {engine} f32 loss {float(loss_p)!r} vs COO {float(loss_c)!r}, acc {float(acc_p)!r}"
        f" vs {float(acc_c)!r}; gradients: max ||diff||/||COO|| {norm_err:.3e} ({worst}),"
        f" max |diff| / max|COO| {elem_err:.3e}")


def phase_main_path(ds) -> dict:
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params, loss_and_grad
    from mg_gcn_tpu_torch.ops.spmm_pattern import PatternMat
    from mg_gcn_tpu_torch.train import build_agg_pair, train

    dev = torch.device("cuda")
    sizes = (FEATURES, *HIDDEN, CLASSES)
    config = GCNConfig(sizes=sizes)
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    params = init_params(config, device=dev)
    out = {}

    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    pair = build_agg_pair(ds.graph, impl="auto", pattern_dtype="float32", device=dev)
    if not isinstance(pair.fwd, PatternMat):
        raise AssertionError(f"impl='auto' chose {type(pair.fwd).__name__}, not the pattern pair")
    torch.cuda.synchronize()
    out["pattern_build_s"] = time.perf_counter() - t0
    loss_p, acc_p, grads_p = loss_and_grad(params, pair, x, y, config)
    torch.cuda.synchronize()
    del pair
    t0 = time.perf_counter()
    coo = build_agg_pair(ds.graph, impl="xla", device=dev)
    out["coo_build_s"] = time.perf_counter() - t0
    loss_c, acc_c, grads_c = coo_step(params, coo, x, y, config)
    torch.cuda.synchronize()
    del coo
    torch.cuda.empty_cache()
    compare_with_coo("pattern", (loss_p, acc_p, grads_p), (loss_c, acc_c, grads_c))

    torch.cuda.reset_peak_memory_stats()
    res = train(ds, HIDDEN, epochs=EPOCHS, impl="auto", pattern_dtype="bfloat16", device=dev)
    if res.engine != "pattern" or not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"bf16 run: engine {res.engine}, losses {res.losses}")
    out["bf16"] = dict(losses=res.losses, accs=res.accs, epoch_seconds=res.epoch_seconds,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    res8 = train(ds, HIDDEN, epochs=1, impl="auto", pattern_dtype="int8", device=dev)
    if res8.engine != "pattern" or not all(math.isfinite(v) for v in res8.losses):
        raise AssertionError(f"int8 run: engine {res8.engine}, losses {res8.losses}")
    out["int8"] = dict(losses=res8.losses, accs=res8.accs, epoch_seconds=res8.epoch_seconds)
    torch.cuda.synchronize()
    out["launches"] = counts()  # the main path ends here

    for dtype, epochs in (("float32", 1), ("bfloat16", EPOCHS), ("int8", 1)):
        f = per_dtype(out["launches"], "pattern_fwd", dtype)
        b = per_dtype(out["launches"], "pattern_bwd", dtype)
        if (f, b) != (3 * epochs, 2 * epochs):
            raise AssertionError(f"{dtype}: {f} fwd / {b} bwd launches in {epochs} epoch(s), want 3/2 each")
    steady = sorted(res.epoch_seconds[1:])
    out["bf16_epoch_s_median"] = steady[len(steady) // 2]
    log(f"  launches on the main path: {out['launches']}")
    log(f"  pattern pair build {out['pattern_build_s']:.2f} s, COO pair build {out['coo_build_s']:.1f} s,"
        f" bf16 epoch median (epochs 1-{EPOCHS - 1}) {out['bf16_epoch_s_median']:.4f} s,"
        f" peak memory {out['bf16']['peak_mem_gb']:.2f} GB")
    return out


def library_sparse(ds, transpose: bool):
    from mg_gcn_tpu_torch import sparse

    g = sparse.transpose(ds.graph) if transpose else ds.graph
    return csr_library(torch.from_numpy(g.indptr).cuda(), torch.from_numpy(g.indices).cuda(),
                       torch.ones(g.nnz, device="cuda"), g.shape)


def csr_library(indptr, indices, values, shape):
    """A float32 CSR tensor for torch.sparse.mm, the yardstick of the
    kernels lines (the port never calls it)."""
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(indptr, indices.long(), values, size=shape, check_invariants=False)


def elt_size(t: torch.Tensor) -> int:
    return (torch.finfo(t.dtype).bits if t.is_floating_point() else torch.iinfo(t.dtype).bits) // 8


def kernel_row(name, dtype, d, n, nnz, launches, check, ms, plain_ms, library_ms, moved) -> dict:
    """One entry of the kernels line. ``check`` is check_close's (max_err,
    tolerance used). bound_ms is the larger of the bytes the function must
    move (``moved``: each input read once, each output written once) over
    the memory rate and its 2*nnz*d operations over the peak rate of the
    operand type."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 2.0 * nnz * d / PEAK_OPS[dtype]
    err, use = check
    return dict(
        name=name, route="cuda", source=f"mg_gcn_tpu_torch/csrc/{SOURCES[name]}", replaces=KERNELS[name],
        dtype=dtype, d=d, n=n, nnz=nnz, launches=launches, max_abs_err=err, max_err=err, tolerance_used=use,
        ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms,
    )


def log_row(r: dict) -> None:
    log(f"  {r['name']} {r['dtype']:8s} d={r['d']:3d}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms,"
        f" {r['bound_by']}), plain {r['plain_ms']:.1f} ms, torch.sparse.mm {r['library_ms']},"
        f" launches {r['launches']}, max_err {r['max_abs_err']:.3e} (tolerance used {r['tolerance_used']:.3f})")


def phase_kernels_main(ds, launches: dict) -> list[dict]:
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    fwd, _ = sp.pattern_pair_from_binary_csr(ds.graph, device="cuda")
    n, n_pad, nnz = fwd.n, fwd.n_pad, fwd.nnz
    rows = []
    for name, kernel, plain in (("pattern_fwd", sp.pattern_fwd, sp.pattern_fwd_plain),
                                ("pattern_bwd", sp.pattern_bwd, sp.pattern_bwd_plain)):
        lib = library_sparse(ds, transpose=name == "pattern_fwd")
        for dtype in DTYPES:
            for d in WIDTHS:
                b = operand(n_pad, d, dtype, seed=d)
                got = kernel(fwd.pack, b)
                torch.cuda.synchronize()
                check = check_close(f"{name} {dtype} d={d} (main shape)", got, plain(fwd.pack, b, torch.float64),
                                    dtype)
                del got
                ms = cuda_ms(lambda: kernel(fwd.pack, b), 5)
                plain_ms = cuda_ms(lambda: plain(fwd.pack, b), 2)
                library_ms = None
                if dtype == "float32":
                    bl = b[:n, :d].contiguous()
                    library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
                moved = n_pad * n_pad / 8 + n * d * elt_size(b) + n * d * 4
                rows.append(kernel_row(name, dtype, d, n, nnz, launches[name].get((dtype, b.shape[1]), 0),
                                       check, ms, plain_ms, library_ms, moved))
                log_row(rows[-1])
        del lib
    return rows


# ---------------------------------------------------------------------------
# the O(nnz) engines: edge (path A) and gather (path B)


def time_against_plain(label, kernel, plain, args, dtype, reps, plain_reps):
    """Check the CSR kernel ``kernel(*args)`` against its plain version on
    the card (summed in float64 for a float kernel: see check_close), then
    time both; returns ((max_err, tolerance used), kernel ms, plain ms), the
    plain version's ms None for ``plain_reps=0``."""
    from mg_gcn_tpu_torch.ops.spmm_edges import csr_plain

    got = kernel(*args)
    torch.cuda.synchronize()
    check = check_close(label, got, plain(*args) if dtype == "int8" else csr_plain(*args, torch.float64), dtype)
    del got
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: plain(*args), plain_reps) if plain_reps else None
    return check, cuda_ms(lambda: kernel(*args), reps), plain_ms


def phase_csr_kernels_small() -> None:
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.ops import spmm_edges as se
    from mg_gcn_tpu_torch.ops import spmm_gather as sg

    g = sparse.random_graph(N_SMALL, DEG_SMALL, seed=3, weights="uniform")
    ip, ix = torch.from_numpy(g.indptr).cuda(), torch.from_numpy(g.indices).cuda()
    wq = torch.from_numpy(np.random.default_rng(4).integers(-127, 128, g.nnz).astype(np.int8)).cuda()
    for dtype in DTYPES:
        name = "edge_i8" if dtype == "int8" else "edge"
        kernel, plain = (se.edge_i8, se.edge_i8_plain) if dtype == "int8" else (se.edge, se.edge_plain)
        w = wq if dtype == "int8" else torch.from_numpy(g.data).cuda().to(se.DTYPES[dtype])
        for d in EDGE_WIDTHS:
            b = operand(N_SMALL, d, dtype, seed=d)
            (err, use), ms, plain_ms = time_against_plain(f"{name} {dtype} d={d}", kernel, plain, (ip, ix, w, b),
                                                          dtype, 10, 3)
            log(f"  {name:7s} {dtype:8s} d={d:3d}: max_err {err:.3e} (tolerance used {use:.3f})"
                f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")
    g = sparse.random_graph(N_SMALL, DEG_GATHER_SMALL, seed=5)
    ip, ix = torch.from_numpy(g.indptr).cuda(), torch.from_numpy(g.indices).cuda()
    wts = torch.from_numpy(np.random.default_rng(6).random(g.nnz, np.float32) + 0.5).cuda()
    for mode, w, dtype in (("weighted", wts, "float32"), ("binary", None, "float32"),
                           ("binary stream", None, "bfloat16")):
        for d in GATHER_WIDTHS:
            b = operand(N_SMALL, d, dtype, seed=d)
            (err, use), ms, plain_ms = time_against_plain(
                f"gather {mode} d={d}", sg.gather, sg.gather_plain, (ip, ix, w, b), dtype, 10, 3)
            log(f"  gather  {mode:13s} d={d:3d}: max_err {err:.3e} (tolerance used {use:.3f})"
                f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")


def drive_path(engine: str, ds, hidden, runs) -> dict:
    """One O(nnz)-engine path through the entry points a user calls:
    ``build_agg_pair(impl="auto")`` must pick ``engine``; its float32 step
    is held against the COO engine; then ``train(impl="auto")`` for each
    (pattern_dtype, epochs) of ``runs`` with finite losses. The launch
    counters are zeroed just before and read just after."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params, loss_and_grad
    from mg_gcn_tpu_torch.train import ENGINE_OF, build_agg_pair, train

    dev = torch.device("cuda")
    config = GCNConfig(sizes=(ds.num_features, *hidden, ds.num_labels))
    x = torch.from_numpy(ds.features).to(dev)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
    params = init_params(config, device=dev)
    out = {}

    reset_counts()  # the path starts here
    t0 = time.perf_counter()
    pair = build_agg_pair(ds.graph, impl="auto", pattern_dtype="float32", device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    if ENGINE_OF[type(pair.fwd)] != engine:
        raise AssertionError(f"impl='auto' chose {type(pair.fwd).__name__}, not the {engine} engine")
    step = loss_and_grad(params, pair, x, y, config)
    torch.cuda.synchronize()
    out["fwd"] = pair.fwd  # the forward matrix, for the kernels at this path's shape
    del pair
    t0 = time.perf_counter()
    coo = build_agg_pair(ds.graph, impl="xla", device=dev)
    out["coo_build_s"] = time.perf_counter() - t0
    step_coo = coo_step(params, coo, x, y, config)
    torch.cuda.synchronize()
    del coo
    torch.cuda.empty_cache()
    compare_with_coo(engine, step, step_coo)
    del step, step_coo

    torch.cuda.reset_peak_memory_stats()
    for dtype, epochs in runs:
        res = train(ds, hidden, epochs=epochs, impl="auto", pattern_dtype=dtype, device=dev)
        if res.engine != engine or not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"{engine} {dtype} run: engine {res.engine}, losses {res.losses}")
        out[dtype] = dict(losses=res.losses, accs=res.accs, epoch_seconds=res.epoch_seconds)
        for e, (loss, acc, sec) in enumerate(zip(res.losses, res.accs, res.epoch_seconds)):
            log(f"  {engine} {dtype} epoch {e} {loss} {acc} {sec}")
    torch.cuda.synchronize()
    out["launches"] = counts()  # the path ends here
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches on the path: { {k: v for k, v in out['launches'].items() if v} }")
    log(f"  {engine} pair build {out['build_s']:.2f} s, COO pair build {out['coo_build_s']:.1f} s,"
        f" peak memory in training {out['peak_mem_gb']:.2f} GB")
    return out


def phase_engines_binary(ds, pattern_median: float) -> None:
    """The O(nnz) engines on the main path's binary graph, where impl="auto"
    picks the pattern pair: ``train`` with impl="edge" in bfloat16 (the
    pattern run's dtype) and impl="gather" in float32 (its one mode), EPOCHS
    epochs each, for the rule of impl="auto" (ROADMAP queue 1 item 5b).
    Losses must be finite; no launch counter is read."""
    from mg_gcn_tpu_torch.train import train

    for impl, dtype in (("edge", "bfloat16"), ("gather", "float32")):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train(ds, HIDDEN, epochs=EPOCHS, impl=impl, pattern_dtype=dtype, device="cuda", log=False)
        total = time.perf_counter() - t0
        if res.engine != impl or not all(math.isfinite(v) for v in res.losses):
            raise AssertionError(f"{impl} on the binary graph: engine {res.engine}, losses {res.losses}")
        steady = sorted(res.epoch_seconds[1:])
        log(f"  {impl} {dtype} on the binary graph: epoch median (epochs 1-{EPOCHS - 1})"
            f" {steady[len(steady) // 2]:.5f} s (pattern bfloat16 {pattern_median:.5f} s),"
            f" epochs {res.epoch_seconds}, losses {res.losses[0]} -> {res.losses[-1]},"
            f" peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, build + train {total:.1f} s")
        del res
        torch.cuda.empty_cache()


def expect_launches(launches: dict, want: dict) -> None:
    """``want``: {(kernel name, dtype): launches}; every other kernel of the
    port must not have launched on the path."""
    for name, per in launches.items():
        for dtype in {dt for dt, _ in per} | {dt for n, dt in want if n == name}:
            got, exp = per_dtype(launches, name, dtype), want.get((name, dtype), 0)
            if got != exp:
                raise AssertionError(f"{name} {dtype}: {got} launches on the path, want {exp}")


def path_a_dataset(ds):
    """bench.py's weighted section: the main path's graph with edge values
    rng(5).random + 0.5 (bench.py:386-399)."""
    from mg_gcn_tpu_torch.formats import CSRData, Dataset

    g = ds.graph
    w = np.random.default_rng(5).random(g.nnz, np.float32) + 0.5
    return Dataset(graph=CSRData(g.indptr, g.indices, w, g.shape), features=ds.features, labels=ds.labels,
                   sets=ds.sets)


def path_b_dataset():
    """BASELINE config 2 on one card, bench.py's uniform products section:
    random_graph(2,449,029, 50, seed=3), 100 features and 48 labels from
    rng(4) (bench.py:586, 607, 697-699)."""
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset

    t0 = time.perf_counter()
    g = sparse.random_graph(N_PROD, DEG_PROD, seed=3)
    rng = np.random.default_rng(4)
    x = rng.random((N_PROD, FEATURES_PROD), np.float32)
    y = rng.integers(0, CLASSES_PROD, N_PROD).astype(np.int32)
    log(f"  graph n={g.nrows} nnz={g.nnz} built in {time.perf_counter() - t0:.1f} s")
    return Dataset(graph=g, features=x, labels=y.reshape(-1, 1), sets=np.zeros((N_PROD, 1), np.int32))


def phase_edge_main(fwd, launches: dict) -> list[dict]:
    """The edge kernels at path A's shape (its forward matrix Âᵀ), each mode
    x width against its plain version, timed beside its bound and beside
    torch.sparse.mm on the same float32 CSR."""
    from mg_gcn_tpu_torch.formats import CSRData
    from mg_gcn_tpu_torch.ops import spmm_edges as se

    host = CSRData(fwd.indptr.cpu().numpy(), fwd.indices.cpu().numpy(), fwd.w.cpu().numpy(), (fwd.n_out, fwd.n_in))
    weights = {"float32": fwd.w, "bfloat16": fwd.w.to(torch.bfloat16),
               "int8": se.edge_tile_mat_from_csr(host, dtype="int8", device="cuda").wq}
    del host
    lib = csr_library(fwd.indptr, fwd.indices, fwd.w, (fwd.n_out, fwd.n_in))
    rows = []
    for dtype in DTYPES:
        name = "edge_i8" if dtype == "int8" else "edge"
        kernel, plain = (se.edge_i8, se.edge_i8_plain) if dtype == "int8" else (se.edge, se.edge_plain)
        for d in (128, 41):
            b = operand(fwd.n_in, d, dtype, seed=d)
            check, ms, plain_ms = time_against_plain(f"{name} {dtype} d={d} (path A shape)", kernel, plain,
                                                     (fwd.indptr, fwd.indices, weights[dtype], b), dtype, 5, 2)
            library_ms = None
            if dtype == "float32":
                bl = b[:, :d].contiguous()
                library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
            moved = (8 * (fwd.n_out + 1) + 4 * fwd.nnz + elt_size(weights[dtype]) * fwd.nnz
                     + fwd.n_in * d * elt_size(b) + fwd.n_out * d * 4)
            rows.append(kernel_row(name, dtype, d, fwd.n_out, fwd.nnz, launches[name].get((dtype, b.shape[1]), 0),
                                   check, ms, plain_ms, library_ms, moved))
            log_row(rows[-1])
    cross_engine("path A's Âᵀ (edge regime)", fwd, fwd.w, rows)
    return rows


def cross_engine(where: str, mat, w32, rows: list[dict]) -> None:
    """Logs the other O(nnz) engine's kernel on the matrix of a path, beside
    that path's own rows, for the rule of impl="auto" (ROADMAP queue 1 item
    5b): on ``mat`` (CSR on the card, float32 weights ``w32`` or None for a
    binary matrix), ``gather`` in float32 and with the bfloat16 operand
    stream, and ``edge`` in float32 and bfloat16 (weights of ones for a
    binary matrix), each checked against its plain version. Not part of
    the kernels line: no path runs these launches."""
    from mg_gcn_tpu_torch.ops import spmm_edges as se
    from mg_gcn_tpu_torch.ops import spmm_gather as sg

    ones = torch.ones(mat.nnz, device="cuda") if w32 is None else w32
    own = {(r["name"], r["dtype"], r["d"]): r["ms"] for r in rows}
    for d in sorted({r["d"] for r in rows}, reverse=True):
        for name, dtype, kernel, plain, w in (
            ("gather", "float32", sg.gather, sg.gather_plain, w32),
            ("gather", "bfloat16", sg.gather, sg.gather_plain, w32),
            ("edge", "float32", se.edge, se.edge_plain, ones),
            ("edge", "bfloat16", se.edge, se.edge_plain, ones.to(torch.bfloat16)),
        ):
            if (name, dtype, d) in own:
                continue
            b = operand(mat.n_in, d, dtype, seed=d)
            (err, use), ms, _ = time_against_plain(f"{name} {dtype} d={d} on {where}", kernel, plain,
                                                   (mat.indptr, mat.indices, w, b), dtype, 5, 0)
            log(f"  cross-engine on {where}: {name} {dtype} B d={d}: {ms:.3f} ms, max_err {err:.3e}"
                f" (tolerance used {use:.3f})")
            del b
            torch.cuda.empty_cache()


def phase_gather_main(fwd, launches: dict) -> list[dict]:
    """The gather kernel at path B's shape (its forward matrix Aᵀ, binary):
    the path's float32 walk at each of its widths, and (logged, not in the
    kernels line: the path does not run it) the bfloat16 operand stream at
    the widest, against the plain version, timed beside the bound and beside
    torch.sparse.mm on the same float32 CSR."""
    from mg_gcn_tpu_torch.ops import spmm_gather as sg

    ones = torch.ones(fwd.nnz, device="cuda")
    lib = csr_library(fwd.indptr, fwd.indices, ones, (fwd.n_out, fwd.n_in))
    del ones
    measured = []
    for dtype, d in (("float32", 256), ("float32", 100), ("float32", 48), ("bfloat16", 256)):
        b = operand(fwd.n_in, d, dtype, seed=d)
        check, ms, plain_ms = time_against_plain(f"gather {dtype} d={d} (path B shape)", sg.gather,
                                                 sg.gather_plain, (fwd.indptr, fwd.indices, None, b), dtype, 5, 2)
        library_ms = None
        if dtype == "float32":
            bl = b[:, :d].contiguous()
            library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
            del bl
        moved = 8 * (fwd.n_out + 1) + 4 * fwd.nnz + fwd.n_in * d * elt_size(b) + fwd.n_out * d * 4
        measured.append(kernel_row("gather", dtype, d, fwd.n_out, fwd.nnz,
                                   launches["gather"].get((dtype, b.shape[1]), 0),
                                   check, ms, plain_ms, library_ms, moved))
        log_row(measured[-1])
        del b
        torch.cuda.empty_cache()
    del lib
    cross_engine("path B's Aᵀ (gather regime)", fwd, None, measured)
    return [r for r in measured if r["dtype"] == "float32"]  # the path's own mode; the stream row is logged only



def phase_cli() -> None:
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.formats import Dataset

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(5)
        n = 50_000
        Dataset(
            graph=sparse.random_graph(n, 20, seed=5),
            features=rng.standard_normal((n, 32)).astype(np.float32),
            labels=rng.integers(0, 7, (n, 1)).astype(np.int32),
            sets=np.zeros((n, 1), np.int32),
        ).save(os.path.join(tmp, "toy"))
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        r = subprocess.run(
            [sys.executable, "-m", "mg_gcn_tpu_torch.cli", "-E", "3", "--csv-dir",
             os.path.join(tmp, "csvs"), "train", os.path.join(tmp, "toy"), "2", "128", "128"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        )
        if r.returncode != 0:
            raise AssertionError(f"CLI exited {r.returncode}:\n{r.stderr}")
        lines = r.stderr.splitlines()
        ds = Dataset.load(os.path.join(tmp, "toy"))
        want = [f"{n} {ds.graph.nnz}", f"num_labels = {ds.num_labels}", "feature size = 32"]
        if lines[:3] != want or not any(line.startswith("aggregation engine: pattern") for line in lines):
            raise AssertionError(f"CLI stderr header {lines[:3]} != {want}, or no pattern engine line")
        epochs = [line.split() for line in lines if re.fullmatch(r"\d+ \S+ \S+ \S+", line)]
        if [int(e[0]) for e in epochs] != [0, 1, 2] or not all(math.isfinite(float(e[1])) for e in epochs):
            raise AssertionError(f"CLI epoch lines {epochs}")
        csv = os.path.join(tmp, "csvs", "toy_32_128_128_7_1.csv")
        keys = [line.split(":")[0] for line in open(csv).read().splitlines()]
        if keys != ["0_preprocess", "0_0_epoch", "1_0_epoch", "2_0_epoch"]:
            raise AssertionError(f"CLI timer CSV keys {keys}")
        log("  " + "\n  ".join(lines))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mg_gcn_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("[1] device")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {smi}")
    log(f"  torch: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("[2] build")
    built = _build.build_all()
    for name, (seconds, compiler_log) in built.items():
        log(f"  {name}: built in {seconds:.1f} s")
        log("  " + "\n  ".join(line for line in compiler_log.splitlines() if "ptxas" in line))
    if not built:
        log("  kernels already built")

    t_phase = [time.perf_counter()]

    def phase(title: str) -> None:
        now = time.perf_counter()
        log(f"  ({now - t_phase[0]:.1f} s)")
        t_phase[0] = now
        log(title)

    phase(f"[3] kernels vs plain, n = {N_SMALL}")
    phase_kernels_small()
    phase_csr_kernels_small()

    phase(f"[4] main path, n = {N_MAIN}")
    ds = main_dataset()
    main_path = phase_main_path(ds)
    bf16 = main_path["bf16"]
    for e, (loss, acc, s) in enumerate(zip(bf16["losses"], bf16["accs"], bf16["epoch_seconds"])):
        log(f"  bf16 epoch {e} {loss} {acc} {s}")

    phase("[5] pattern kernels at the main-path shape")
    kernels = phase_kernels_main(ds, main_path["launches"])
    torch.cuda.empty_cache()  # the 6.8 GB pack goes before the O(nnz) paths

    phase("[6] the O(nnz) engines on the main path's binary graph")
    phase_engines_binary(ds, main_path["bf16_epoch_s_median"])

    phase("[7] path A: weighted Reddit on the edge engine")
    from mg_gcn_tpu_torch.ops.spmm_edges import expected_fill

    ds_a = path_a_dataset(ds)
    del ds
    g = ds_a.graph
    log(f"  expected edge-tile fill {expected_fill(g.nrows, g.ncols, g.nnz):.4f}")
    path_a = drive_path("edge", ds_a, HIDDEN, [("bfloat16", EPOCHS), ("int8", 1)])
    expect_launches(path_a["launches"], {("edge", "float32"): 5, ("edge", "bfloat16"): 5 * EPOCHS,
                                         ("edge_i8", "int8"): 5})
    del ds_a, g

    phase("[8] edge kernels at path A's shape")
    kernels += phase_edge_main(path_a.pop("fwd"), path_a["launches"])
    torch.cuda.empty_cache()

    phase(f"[9] path B: products scale on the gather engine, n = {N_PROD}")
    ds_b = path_b_dataset()
    path_b = drive_path("gather", ds_b, HIDDEN_PROD, [("float32", EPOCHS)])
    if path_b["fwd"].has_w:
        raise AssertionError("impl='auto' built a weighted gather pair for a binary graph")
    expect_launches(path_b["launches"], {("gather", "float32"): 5 * (1 + EPOCHS)})
    del ds_b

    phase("[10] gather kernel at path B's shape")
    kernels += phase_gather_main(path_b.pop("fwd"), path_b["launches"])
    torch.cuda.empty_cache()

    phase("[11] CLI")
    phase_cli()
    phase("done")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
