"""The readings the DeeperGCN cell's limits are set from, on its card at
its own size, as ``limits.py`` and ``gat_limits.py`` take them for the
other cells: the numbers of ``harness/compare.py`` for sound runs of the
port on many seeds (the lower readings), for the controls and for the
faults (the upper readings).

    python3 benchmark/tools/deepergcn_limits.py --seeds 12 --controls 3 --out readings.jsonl

Controls, each against the reference at the configuration's precision: the
port with TF32 in its dense layers ("tf32"); the reference in the port's
place with TF32 ("tf32_ref"); the reference in the port's place with both
operands of each aggregation product rounded to float8 e4m3 under a
per-tensor scale ("fp8_ref"), the precision below the configuration's
bfloat16 (the port has no aggregation path below bfloat16: its operand is
made every step). Faults, planted in the reference put in the port's
place: the loss over half of the rows ("half_batch"), the state left
unchanged ("frozen"), the ``res+`` add left out ("no_residual"). One JSON
line a reading, with every leaf's readings under "leaves"; the
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import compare, runner, spec  # noqa: E402
from benchmark.tools.limits import leaves, program_numbers  # noqa: E402

FAULTS = ("half_batch", "frozen", "no_residual")
REFERENCE_CONTROLS = {"tf32_ref": ({"tf32"}, None), "fp8_ref": (set(), {"aggregation_dtype": "float8_e4m3fn"})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/tools/deepergcn_limits.py")
    p.add_argument("--workload", default="deepergcn-reddit-uniform")
    p.add_argument("--seeds", type=int, default=12, help="sound runs of the port")
    p.add_argument("--controls", type=int, default=3, help="seeds of each control and each fault")
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(ROOT, args.workload)
    devices = runner.cards(cell.chips)
    reference = spec.load_module(ROOT, "reference", cell.reference)
    with open(args.out, "a") as out:
        def emit(kind: str, seed: int, got: dict, per_leaf: dict, seconds: float) -> None:
            line = dict(cell=cell.name, kind=kind, seed=seed, seconds=seconds,
                        **{k: v for k, (v, _) in got.items()}, at={k: w for k, (_, w) in got.items()},
                        leaves=per_leaf)
            out.write(json.dumps(line) + "\n")
            out.flush()
            runner.log(json.dumps({k: v for k, v in line.items() if k != "leaves"}))

        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            t0 = time.perf_counter()
            got = program_numbers(cell, seed, devices, reference)
            emit("sound", seed, got["numbers"], got["leaves"], time.perf_counter() - t0)
            if i < args.controls:
                kinds = [(f"fault-{f}", {f}, None) for f in FAULTS]
                kinds += [(f"control-{k}", f, c) for k, (f, c) in REFERENCE_CONTROLS.items()]
                for kind, faults, change in kinds:
                    t0 = time.perf_counter()
                    rec = reference.run(got["graph"], got["x"], got["y"], got["params0"],
                                        {**cell.config, **(change or {})}, runner.FIRST_STEPS, faults=faults)
                    emit(kind, seed, compare.numbers(rec, got["ref"]), leaves(rec, got["ref"]),
                         time.perf_counter() - t0)
            del got
            gc.collect()
            torch.cuda.empty_cache()
        low = copy.deepcopy(cell)
        low.config["tf32"] = True
        for i in range(args.controls):
            seed = args.first_seed + 7919 * i
            t0 = time.perf_counter()
            got = program_numbers(low, seed, devices, reference, cell.config)
            emit("control-tf32", seed, got["numbers"], got["leaves"], time.perf_counter() - t0)
            del got
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
