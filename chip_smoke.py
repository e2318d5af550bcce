#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``mg_gcn_tpu_torch``.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, in order; any failure exits non-zero before the result line:

1. device — the card's name and power limit (nvidia-smi) and torch's name;
2. build  — nvcc builds the kernels from the sources in this checkout;
3. kernels vs plain, n = 20,000 — each pattern kernel (fwd, bwd) x
   {bfloat16, float32, int8} x d in {41, 128} against its plain PyTorch
   version on the card: float within rtol 1e-5 / atol 1e-6 of the output
   scale (same rounded inputs, only the sum order differs), int8 equal;
4. main path at full width — bench.py's uniform configuration
   (n = 232,968, random_graph(n, 493, seed=1) ~ 115M edges, 608 features,
   41 classes, sizes (608, 128, 128, 41), parity mode, Adam, seed-99 init)
   through ``train.build_agg_pair`` / ``train.train`` with impl="auto":
   auto must pick the pattern pair; one float32 pattern step must agree
   with the COO engine within rtol 1e-4: the loss, and every gradient leaf
   in norm, ||pattern - COO|| <= 1e-4 ||COO|| (element-wise, the two sum
   orders can put a near-zero pre-activation on either side of the
   LeakyReLU, which moves single elements by a step); then 5
   bfloat16 epochs and 1 int8 epoch with finite losses. The kernels' launch
   counters are zeroed before this phase and read after it: exactly 3 fwd +
   2 bwd launches an epoch in each dtype;
5. kernels at the main-path shape — each kernel x dtype x width against
   its plain version again, timed with CUDA events beside its bound and
   beside torch.sparse.mm (float32; a yardstick the port never calls);
6. CLI — ``python -m mg_gcn_tpu_torch.cli -E 3 train <dir> 2 128 128`` on a
   small binary dataset: stderr lines and the timer CSV.

Then, each on its own line: the ``{"kernels": [...]}`` JSON, the
nvidia-smi name and power limit, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

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
}


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


def check_close(kind: str, got: torch.Tensor, want: torch.Tensor, dtype: str) -> float:
    """max |got - want|; raises past the stated tolerance."""
    err = float((got.double() - want.double()).abs().max())
    if dtype == "int8":
        if err != 0.0:
            raise AssertionError(f"{kind}: int8 result differs from the plain version by {err}")
        return err
    scale = float(want.abs().max())
    bad = (got - want).abs() > 1e-5 * want.abs() + 1e-6 * scale
    if bool(bad.any()):
        raise AssertionError(f"{kind}: {int(bad.sum())} elements past rtol 1e-5 / atol 1e-6 x {scale}")
    return err


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
                err = check_close(f"{name} {dtype} d={d}", got, plain(fwd.pack, b), dtype)
                ms = cuda_ms(lambda: kernel(fwd.pack, b), 10)
                plain_ms = cuda_ms(lambda: plain(fwd.pack, b), 3)
                log(f"  {name} {dtype:8s} d={d:3d}: max_err {err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms")


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


def counts() -> dict:
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    return {"pattern_fwd": dict(sp.pattern_fwd.launches), "pattern_bwd": dict(sp.pattern_bwd.launches)}


def reset_counts() -> None:
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp

    sp.pattern_fwd.launches.clear()
    sp.pattern_bwd.launches.clear()


def per_dtype(c: dict, name: str, dtype: str) -> int:
    return sum(v for (dt, _), v in c[name].items() if dt == dtype)


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
    loss_c, acc_c, grads_c = loss_and_grad(params, coo, x, y, config)
    torch.cuda.synchronize()
    del coo
    torch.cuda.empty_cache()
    if not math.isclose(float(loss_p), float(loss_c), rel_tol=1e-4):
        raise AssertionError(f"float32 pattern loss {float(loss_p)} vs COO {float(loss_c)}")
    norm_err = elem_err = 0.0
    for i, (gp, gc) in enumerate(zip(grads_p, grads_c)):
        for k in gc:
            rel = float(torch.linalg.vector_norm(gp[k] - gc[k]) / torch.linalg.vector_norm(gc[k]))
            if not rel <= 1e-4:
                raise AssertionError(f"layer {i} grad {k}: ||pattern - COO|| / ||COO|| = {rel} > 1e-4")
            norm_err = max(norm_err, rel)
            elem_err = max(elem_err, float((gp[k] - gc[k]).abs().max() / gc[k].abs().max()))
    log(f"  first step: pattern f32 loss {float(loss_p)!r} vs COO {float(loss_c)!r}, acc {float(acc_p)!r}"
        f" vs {float(acc_c)!r}; gradients: max ||diff||/||COO|| {norm_err:.3e},"
        f" max |diff| / max|COO| {elem_err:.3e}")

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
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(g.indptr), torch.from_numpy(g.indices.astype(np.int64)),
            torch.ones(g.nnz), size=g.shape, device="cuda", check_invariants=False,
        )


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
                err = check_close(f"{name} {dtype} d={d} (main shape)", got, plain(fwd.pack, b), dtype)
                del got
                ms = cuda_ms(lambda: kernel(fwd.pack, b), 5)
                plain_ms = cuda_ms(lambda: plain(fwd.pack, b), 2)
                library_ms = None
                if dtype == "float32":
                    bl = b[:n, :d].contiguous()
                    library_ms = cuda_ms(lambda: torch.sparse.mm(lib, bl), 5)
                elt = torch.finfo(b.dtype).bits // 8 if b.is_floating_point() else 1
                moved = n_pad * n_pad / 8 + n * d * elt + n * d * 4
                t_bytes, t_ops = moved / HBM_BYTES_PER_S, 2.0 * nnz * d / PEAK_OPS[dtype]
                d_pad = b.shape[1]
                rows.append(dict(
                    name=name, route="cuda", source="mg_gcn_tpu_torch/csrc/spmm_pattern.cu",
                    replaces=KERNELS[name], dtype=dtype, d=d, n=n, nnz=nnz,
                    launches=launches[name].get((dtype, d_pad), 0),
                    max_abs_err=err, max_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=library_ms,
                ))
                r = rows[-1]
                log(f"  {name} {dtype:8s} d={d:3d}: {ms:.3f} ms (bound {r['bound_ms']:.3f} ms, {r['bound_by']}),"
                    f" plain {plain_ms:.1f} ms, torch.sparse.mm {library_ms}, launches {r['launches']},"
                    f" max_err {err:.3e}")
        del lib
    return rows


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

    log(f"[3] kernels vs plain, n = {N_SMALL}")
    phase_kernels_small()

    log(f"[4] main path, n = {N_MAIN}")
    ds = main_dataset()
    main_path = phase_main_path(ds)
    bf16 = main_path["bf16"]
    for e, (loss, acc, s) in enumerate(zip(bf16["losses"], bf16["accs"], bf16["epoch_seconds"])):
        log(f"  bf16 epoch {e} {loss} {acc} {s}")

    log("[5] kernels at the main-path shape")
    kernels = phase_kernels_main(ds, main_path["launches"])
    del ds

    log("[6] CLI")
    phase_cli()
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
