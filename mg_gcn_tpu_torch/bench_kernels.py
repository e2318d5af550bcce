"""Times hand-written kernels of the port on the card at their paths' shapes,
for the cases given on the command line; each case is first held against
its plain version.

The kernels and their shapes (the graph is ``chip_smoke.py``'s main graph,
``sparse.random_graph(232,968, 493, seed=1)``, nnz 114,964,049):

- ``sddmm`` (``ops.sddmm.sddmm``): the graph through
  ``models.gat.build_gat_graph``; operands as ``sddmm_edge_tiles`` hands
  them to the kernel (random normal from seed d, cast to the dtype, or
  quantized per feature with g = qa·qb in int8, padded to d_pad); widths
  64, 128, 256 unless given;
- ``pattern_bwd`` (``ops.spmm_pattern.pattern_bwd``): the graph's n_pad =
  233,472 pack; widths 128 and 41, the main path's;
- ``ring_bwd`` (``ops.spmm_pattern_ring.ring_pattern_bwd``): partition 0's
  four 61,440-row blocks of the graph's ``-P 4`` ring pack; widths 128 and
  44 (d_pad 48), the dist path's;
- ``block_fwd`` and ``block_bwd`` (``ops.spmm_pattern_sparse``): the tile
  store (tile_r 512) of ``chip_smoke.py``'s banded graph instead,
  ``sparse.banded_graph(232,968, 493, 4096, seed=7)`` (bench.py:276-292),
  nnz 110,503,948; widths 128 and 41, the banded path's.

The pattern and block kernels' operands are random normal from seed d
(int8 uniform in ±127), padded to d_pad, as ``chip_smoke.operand`` makes
them. A case is ``kernel``, ``kernel:dtype`` or ``kernel:dtype:d``; a part
left out means every dtype (float32, bfloat16, int8) or the kernel's
widths. Each case is launched once and held against the plain version
summed in float64 (the largest difference over the largest magnitude; an
int32 result must be equal), then timed twice by CUDA events over 5
launches.

``--root DIR`` imports ``mg_gcn_tpu_torch`` from the checkout DIR instead
of this file's, so one call can time two commits' kernels on one card
(``parent, change, change, parent``)::

    python3 mg_gcn_tpu_torch/bench_kernels.py pattern_bwd ring_bwd
    python3 mg_gcn_tpu_torch/bench_kernels.py block_fwd block_bwd
    python3 mg_gcn_tpu_torch/bench_kernels.py --root /path/to/parent sddmm:float32:256

Prints the card's name and power limit, then one line a case.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

N_MAIN, DEG_MAIN, SEED_MAIN = 232_968, 493, 1  # chip_smoke.py's N_MAIN, DEG_MAIN, the graph's seed
BAND_HALF, BAND_SEED = 4096, 7  # chip_smoke.py's banded graph
PARTS = 4  # chip_smoke.py's DIST_PARTS
WIDTHS = {"sddmm": (64, 128, 256), "pattern_bwd": (128, 41), "ring_bwd": (128, 44), "block_fwd": (128, 41),
          "block_bwd": (128, 41)}
BLOCK = ("block_fwd", "block_bwd")
DTYPES = ("float32", "bfloat16", "int8")
REPS = 5  # launches a timing


def parse_cases(specs: list[str]) -> list[tuple[str, str, int]]:
    """(kernel, dtype, d) for each ``kernel[:dtype[:d]]`` in ``specs``."""
    cases = []
    for spec in specs:
        parts = spec.split(":")
        if parts[0] not in WIDTHS or len(parts) > 3 or (len(parts) > 1 and parts[1] not in DTYPES):
            raise SystemExit(f"bench_kernels: bad case {spec!r} (kernel[:dtype[:d]], kernel one of {sorted(WIDTHS)})")
        dtypes = parts[1:2] or DTYPES
        widths = [int(parts[2])] if len(parts) == 3 else WIDTHS[parts[0]]
        cases += [(parts[0], dtype, d) for dtype in dtypes for d in widths]
    return cases


def card_name() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
    except OSError:
        smi = ""
    return smi.splitlines()[0] if smi else "not read"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="+", help="kernel[:dtype[:d]], e.g. pattern_bwd sddmm:float32:256")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose mg_gcn_tpu_torch is timed (default: this one)")
    args = ap.parse_args()
    cases = parse_cases(args.cases)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 1
    from mg_gcn_tpu_torch import sparse
    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.ops import sddmm as sd
    from mg_gcn_tpu_torch.ops import spmm_pattern as sp
    from mg_gcn_tpu_torch.ops import spmm_pattern_ring as ring
    from mg_gcn_tpu_torch.ops import spmm_pattern_sparse as sps
    from mg_gcn_tpu_torch.ops.spmm_edges import pad_features
    from mg_gcn_tpu_torch.parallel import dist

    print(f"card: {card_name()}")
    print(f"root: {os.path.abspath(args.root)} ({sp.__file__})")
    graphs = {}

    def graph_for(kernel: str):
        """The main graph, or the banded graph for the block kernels, each
        built once on the host."""
        which = "banded" if kernel in BLOCK else "main"
        if which not in graphs:
            t0 = time.perf_counter()
            graphs[which] = (sparse.banded_graph(N_MAIN, DEG_MAIN, BAND_HALF, seed=BAND_SEED) if which == "banded"
                             else sparse.random_graph(N_MAIN, DEG_MAIN, seed=SEED_MAIN))
            g = graphs[which]
            print(f"{which} graph: n = {g.nrows}, nnz = {g.nnz}, built in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        return graphs[which]

    def build(kernel: str):
        """The kernel's fixed operand on the card: the GAT graph, the main
        pack, partition 0's ring pack and m, or the banded graph's tile
        store."""
        graph = graph_for(kernel)
        if kernel in BLOCK:
            return sps.block_pattern_pair_from_binary_csr(graph, device="cuda")[0]
        if kernel == "sddmm":
            return gat.build_gat_graph(graph, dtype="float32", device="cuda")[0]
        if kernel == "pattern_bwd":
            return sp.pack_bits_on_device(graph, sp.round_up(graph.nrows, sp.N_ALIGN), torch.device("cuda"))
        pair = dist.DistPatternPair.from_binary_csr(graph, dist.make_mesh(PARTS, ["cuda:0"] * PARTS),
                                                    dtype="bfloat16")
        return pair.pack_bwd[0], pair.m_loc

    def operand(rows: int, d: int, dtype: str, seed: int) -> torch.Tensor:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        b = torch.zeros((rows, sp.round_up(max(d, 8), 8)), device="cuda", dtype=sp.DTYPES[dtype])
        if dtype == "int8":
            b[:, :d] = torch.randint(-127, 128, (rows, d), device="cuda", generator=gen).to(torch.int8)
        else:
            b[:, :d] = torch.randn((rows, d), device="cuda", generator=gen).to(b.dtype)
        return b

    def sddmm_operands(mat, d: int, dtype: str):
        gen = torch.Generator(device="cuda").manual_seed(d)
        a = torch.randn((mat.n_out, d), device="cuda", generator=gen)
        b = torch.randn((mat.n_in, d), device="cuda", generator=gen)
        if dtype != "int8":
            return pad_features(a, sp.DTYPES[dtype]), pad_features(b, sp.DTYPES[dtype]), None
        (aq, qa), (bq, qb) = sd.quantize_per_feature(a), sd.quantize_per_feature(b)
        am, bm = pad_features(aq, torch.int8), pad_features(bq, torch.int8)
        g = torch.zeros(am.shape[1], device="cuda")
        g[:d] = qa * qb
        return am, bm, g

    def case(kernel: str, fixed, dtype: str, d: int):
        """(run, float64 plain, d_pad, geometry or None) of one case; the
        geometry query where this checkout's kernel has one."""
        if kernel == "sddmm":
            a, b, g = sddmm_operands(fixed, d, dtype)
            return (lambda: sd.sddmm(fixed.indptr, fixed.indices, a, b, g),
                    lambda: sd.sddmm_plain(fixed.indptr, fixed.indices, a.double(), b.double(), g), a.shape[1], None)
        acc = None if dtype == "int8" else torch.float64
        if kernel in BLOCK:
            b = operand(fixed.n_pad, d, dtype, seed=d)
            run, plain = getattr(sps, kernel), getattr(sps, f"{kernel}_plain")
            geometry = getattr(sps, f"{kernel}_geometry", None)
            return (lambda: run(fixed, b), lambda: plain(fixed, b, acc), b.shape[1],
                    geometry and (lambda: geometry(fixed.n_pad, fixed.tile_r, b.shape[1], b.dtype)))
        if kernel == "pattern_bwd":
            b = operand(fixed.shape[0], d, dtype, seed=d)
            geometry = getattr(sp, "pattern_bwd_geometry", None)
            return (lambda: sp.pattern_bwd(fixed, b), lambda: sp.pattern_bwd_plain(fixed, b, acc), b.shape[1],
                    geometry and (lambda: geometry(fixed.shape[0], b.shape[1], b.dtype)))
        pack, m = fixed
        slots = operand(PARTS * m, d, dtype, seed=d).reshape(PARTS, m, -1)
        geometry = getattr(ring, "ring_pattern_bwd_geometry", None)
        return (lambda: ring.ring_pattern_bwd(pack, slots), lambda: ring.ring_pattern_bwd_plain(pack, slots, acc),
                slots.shape[2], geometry and (lambda: geometry(PARTS, m, slots.shape[2], slots.dtype)))

    def cuda_ms(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    built, fixed = None, None
    for kernel, dtype, d in cases:
        if kernel != built:
            fixed = None  # one kernel's operand on the card at a time
            torch.cuda.empty_cache()
            built, fixed = kernel, build(kernel)
        run, plain, d_pad, geometry = case(kernel, fixed, dtype, d)
        got, want = run(), plain()
        diff = float((got.double() - want.double()).abs().max())
        rel = diff / max(float(want.double().abs().max()), 1e-300)
        if want.dtype == torch.int32 and diff != 0.0:
            raise AssertionError(f"{kernel} {dtype} d={d}: the int32 result differs from the plain version by {diff}")
        del got, want
        times = [cuda_ms(run), cuda_ms(run)]
        print(f"{kernel} {dtype:8s} d={d:3d} d_pad={d_pad:3d}: {times[0]:.3f} / {times[1]:.3f} ms  (max |diff| /"
              f" max |out| against the plain version: {rel:.2e}){'  geometry ' + str(geometry()) if geometry else ''}",
              flush=True)
        del run, plain, geometry
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
