"""Times the SDDMM kernel (``ops.sddmm.sddmm``) at the GAT path's shape on
the card, for widths and dtypes given on the command line.

The graph is ``chip_smoke.py``'s GAT graph: ``sparse.random_graph(232,968,
493, seed=1)`` through ``models.gat.build_gat_graph`` (nnz 114,964,049);
the operands are made as ``sddmm_edge_tiles`` hands them to the kernel
(random normal from seed d, cast to the dtype, or quantized per feature
with g = qa·qb in int8, padded to d_pad). Each case is launched once, held
against the plain version summed in float64 (the largest difference over
the largest magnitude), then timed twice by CUDA events over 5 launches.

``--root DIR`` imports ``mg_gcn_tpu_torch`` from the checkout DIR instead
of this file's, so one call can time two commits' kernels on one card
(``parent, change, change, parent``)::

    python3 mg_gcn_tpu_torch/bench_sddmm.py --cases float32:256,bfloat16:256
    python3 mg_gcn_tpu_torch/bench_sddmm.py --root /path/to/parent --cases float32:256

Prints the card's name and power limit, then one line a case.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

N_GAT, DEG_GAT, SEED_GAT = 232_968, 493, 1  # chip_smoke.py's N_MAIN, DEG_MAIN, the graph's seed
REPS = 5  # launches a timing


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", required=True, help="comma-separated dtype:d, e.g. float32:256,bfloat16:64")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose mg_gcn_tpu_torch is timed (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("bench_sddmm: no CUDA device", file=sys.stderr)
        return 1
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.ops import sddmm as sd
    from mg_gcn_tpu_torch.ops.spmm_edges import DTYPES, pad_features

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
    except OSError:
        smi = ""
    print(f"card: {smi.splitlines()[0] if smi else 'not read'}")
    print(f"root: {os.path.abspath(args.root)} ({sd.__file__})")
    t0 = time.perf_counter()
    mat, _ = gat.build_gat_graph(sparse.random_graph(N_GAT, DEG_GAT, seed=SEED_GAT), dtype="float32", device="cuda")
    print(f"graph: n = {mat.n_out}, nnz = {mat.nnz}, built in {time.perf_counter() - t0:.1f} s", flush=True)

    def operands(d: int, dtype: str):
        gen = torch.Generator(device="cuda").manual_seed(d)
        a = torch.randn((mat.n_out, d), device="cuda", generator=gen)
        b = torch.randn((mat.n_in, d), device="cuda", generator=gen)
        if dtype != "int8":
            return pad_features(a, DTYPES[dtype]), pad_features(b, DTYPES[dtype]), None
        (aq, qa), (bq, qb) = sd.quantize_per_feature(a), sd.quantize_per_feature(b)
        am, bm = pad_features(aq, torch.int8), pad_features(bq, torch.int8)
        g = torch.zeros(am.shape[1], device="cuda")
        g[:d] = qa * qb
        return am, bm, g

    def cuda_ms(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    for case in args.cases.split(","):
        dtype, d = case.split(":")[0], int(case.split(":")[1])
        a, b, g = operands(d, dtype)
        run = lambda: sd.sddmm(mat.indptr, mat.indices, a, b, g)  # noqa: E731
        got = run()
        exact = sd.sddmm_plain(mat.indptr, mat.indices, a.double(), b.double(), g)
        rel = float((got.double() - exact).abs().max() / exact.abs().max())
        del got, exact
        times = [cuda_ms(run), cuda_ms(run)]
        print(f"sddmm {dtype:8s} d={d:3d} d_pad={a.shape[1]:3d}: {times[0]:.3f} / {times[1]:.3f} ms"
              f"  (max |diff| / max |score| against float64: {rel:.2e})", flush=True)
        del a, b, g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
