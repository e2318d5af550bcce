"""Per-launch times of the two engines that ``train.auto_engine`` weighs for a
raw binary adjacency whose n²/8 pack fits the card: the pattern kernels
(``pattern_fwd`` and ``pattern_bwd`` over the pack) and the binary CSR walk
(``gather``), with bfloat16 operands at d_pad 128 and 48, on uniform random
graphs over a sweep of densities. Its crossover sets
``train.WALK_DENSITY_MAX``.

Each graph is drawn on the device (every entry an independent coin of
probability 1/k, rows and columns 0..n-1), its pack and its CSR built from
the same draw; ``pattern_bwd`` (P B) and ``gather`` on the CSR (A B) must
agree within float32 summation order. One JSON line a graph: the ms a launch
of each kernel and width (CUDA events, the mean of ``--reps`` launches after
a warm-up), the products of one epoch of the gcn-reddit cell on each engine
(forward 3 at d_pad 128 and 1 at 48, backward 2 and 1; the walk takes its
forward launches on Aᵀ, which a uniform draw makes alike), and the bytes
each streams a launch besides its row gathers: the pack n²/8, the index list
4·nnz + 8·(n + 1).

    python -m mg_gcn_tpu_torch.scripts.probe_walk_vs_pack [--n 65536 233472] [--inv-density 8 16 32 64] [--reps 3]

``--n`` takes multiples of 4096 (the pack's row groups). On a machine
without CUDA it runs the kernels' plain versions and times nothing, a check
at a small n.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import spmm_gather as sg
from ..ops import spmm_pattern as sp

ROWS_A_DRAW = 2048  # rows drawn at once: ROWS_A_DRAW x n float32 of coins
# launches an epoch of the cell, by d_pad: pattern_fwd, pattern_bwd, and the walk both ways
FWD, BWD, WALK = {128: 3, 48: 1}, {128: 2, 48: 1}, {128: 5, 48: 2}


def uniform_graph(n: int, k: int, seed: int, dev: torch.device):
    """(pack, indptr, indices) of one draw: entry (i, j) set with probability 1/k."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    words = n // 32
    pack = torch.zeros((n, words), dtype=torch.int32, device=dev)
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    parts = []
    for r0 in range(0, n, ROWS_A_DRAW):
        r1 = min(r0 + ROWS_A_DRAW, n)
        coins = torch.rand((r1 - r0, n), generator=gen, device=dev) < 1.0 / k
        rows, cols = torch.nonzero(coins, as_tuple=True)  # row-major: each row's columns ascending
        del coins
        sp.add_bits(pack[r0:r1].view(-1), rows * words, cols)
        counts[r0:r1] = torch.bincount(rows, minlength=r1 - r0)
        parts.append(cols.to(torch.int32))
        del rows, cols
    indices = torch.cat(parts)
    del parts
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(counts, 0)
    return pack, indptr, indices


def launch_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` launches after one, NaN off a card."""
    fn()
    if not torch.cuda.is_available():
        return float("nan")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def probe(n: int, k: int, reps: int, dev: torch.device) -> dict:
    """One graph's line (see the module's docstring)."""
    pack, indptr, indices = uniform_graph(n, k, seed=n + k, dev=dev)
    nnz = indices.numel()
    out = {"n": n, "inv_density": k, "nnz": nnz, "pack_gb": n * n / 8 / 1e9,
           "index_gb": (4 * nnz + 8 * (n + 1)) / 1e9, "ms": {}}
    for d_pad in (128, 48):
        b = torch.randn((n, d_pad), generator=torch.Generator(device=dev).manual_seed(d_pad), device=dev)
        b = b.to(torch.bfloat16)
        walk, bwd = sg.gather(indptr, indices, None, b), sp.pattern_bwd(pack, b)
        err = float((walk - bwd).abs().max() / bwd.abs().max().clamp(min=1e-30))
        if not err <= 1e-5:
            raise AssertionError(f"n {n}, 1/{k}, d_pad {d_pad}: gather and pattern_bwd differ by {err:.3e}")
        del walk, bwd
        for name, fn in (("pattern_fwd", lambda: sp.pattern_fwd(pack, b)),
                         ("pattern_bwd", lambda: sp.pattern_bwd(pack, b)),
                         ("gather", lambda: sg.gather(indptr, indices, None, b))):
            out["ms"][f"{name}.{d_pad}"] = launch_ms(fn, reps)
        del b
    ms = out["ms"]
    out["epoch_products_ms"] = {
        "pattern": sum(c * ms[f"pattern_fwd.{d}"] for d, c in FWD.items())
        + sum(c * ms[f"pattern_bwd.{d}"] for d, c in BWD.items()),
        "walk": sum(c * ms[f"gather.{d}"] for d, c in WALK.items()),
    }
    del pack, indptr, indices
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> list[dict]:
    """Prints and returns one line a (n, density)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[65_536, 233_472])
    ap.add_argument("--inv-density", type=int, nargs="+", default=[8, 16, 32, 64])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if any(n % sp.GROUP for n in args.n):
        ap.error(f"--n takes multiples of {sp.GROUP}")
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    lines = []
    for n in args.n:
        for k in args.inv_density:
            lines.append(probe(n, k, args.reps, dev))
            print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
