"""The readings a cell's limits are set from, on the cell's cards at its own
size: the numbers of ``harness/compare.py`` for sound runs of the port on
many seeds (the lower readings), for the controls (the upper readings), and
for the faults a training cell can have, planted in the reference put in
the port's place.

    python3 benchmark/tools/limits.py --workload <cell> --seeds 12 --controls 3 --out readings.jsonl

Controls, each against the reference at the configuration's precision:
the port with its own int8 aggregation path (the precision below the
configuration's bfloat16 operand); the port with TF32 switched on for the
dense layers (below float32 with TF32 off); and the reference itself put in
the port's place with TF32 on ("tf32_ref"). Faults: the loss over
half of the rows ("half_batch"), the state left unchanged ("frozen"), and
on a partitioned configuration the exchange between partitions left out
("no_exchange"), planted in the reference put in the port's place. One
JSON line a reading, with every leaf's readings under "leaves"; the
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


def program_numbers(cell: spec.Cell, seed: int, devices, reference, ref_config: dict | None = None) -> dict:
    """The port's first steps against the reference (at ``ref_config``, by
    default the cell's own), as a run compares them."""
    family = spec.load_module(ROOT, "families", cell.family)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config.get("tf32", False))
    graph, x, y, params0 = runner.make_inputs(ROOT, cell, seed, devices[0])
    trainer = family.build(cell.config, cell.traffic, graph, x, y, params0, devices)
    record = runner.first_steps(trainer, params0, cell.config["optimizer"], runner.FIRST_STEPS)
    trainer.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev0 = devices[0]
    xs, ys = torch.from_numpy(x).to(dev0), torch.from_numpy(y).to(dev0)
    ref = reference.run(graph, xs, ys, params0, ref_config or cell.config, runner.FIRST_STEPS,
                        blocks=int(cell.config.get("parts", 1)))
    return dict(graph=graph, x=xs, y=ys, params0=params0, ref=ref, numbers=compare.numbers(record, ref),
                leaves=leaves(record, ref))


def leaves(prog: dict, ref: dict) -> dict:
    """Every leaf's readings of the compared numbers (compare.scaled), and
    each step's loss gap."""
    return {"loss_steps": [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])],
            "grad_gap": compare.scaled(prog["grad1"], ref["grad1"]),
            "grad_dir": compare.scaled(prog["grad1"], ref["grad1"], diff=True),
            "change_gap": compare.scaled(prog["change"], ref["change"], compare.kept(ref))}


def planted(reference, got: dict, cell: spec.Cell, faults=frozenset(), tf32: bool = False) -> dict:
    """The reference in the port's place, with ``faults`` or in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return reference.run(got["graph"], got["x"], got["y"], got["params0"], cell.config, runner.FIRST_STEPS,
                             faults=faults, blocks=int(cell.config.get("parts", 1)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/tools/limits.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12, help="sound runs of the port")
    p.add_argument("--controls", type=int, default=3, help="seeds of each control and each fault")
    p.add_argument("--control", action="append", choices=("int8", "tf32", "tf32_ref"),
                   help="the controls to read (default all)")
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(ROOT, args.workload)
    devices = runner.cards(cell.chips)
    reference = spec.load_module(ROOT, "reference", cell.reference)
    faults = ["half_batch", "frozen"] + (["no_exchange"] if int(cell.config.get("parts", 1)) > 1 else [])
    controls = {"int8": dict(aggregation_dtype="int8"), "tf32": dict(tf32=True), "tf32_ref": None}
    controls = {k: v for k, v in controls.items() if k in (args.control or controls)}
    with open(args.out, "a") as out:
        def emit(kind: str, seed: int, got: dict, per_leaf: dict, seconds: float) -> None:
            line = dict(cell=cell.name, kind=kind, seed=seed, seconds=seconds,
                        **{k: v for k, (v, _) in got.items()}, at={k: w for k, (_, w) in got.items()},
                        leaves=per_leaf)
            out.write(json.dumps(line) + "\n")
            out.flush()
            runner.log(json.dumps(line))

        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            t0 = time.perf_counter()
            got = program_numbers(cell, seed, devices, reference)
            emit("sound", seed, got["numbers"], got["leaves"], time.perf_counter() - t0)
            if i < args.controls:
                kinds = [(f"fault-{f}", dict(faults={f})) for f in faults]
                if "tf32_ref" in controls:
                    kinds.append(("control-tf32_ref", dict(tf32=True)))
                for kind, how in kinds:
                    t0 = time.perf_counter()
                    rec = planted(reference, got, cell, **how)
                    emit(kind, seed, compare.numbers(rec, got["ref"]), leaves(rec, got["ref"]),
                         time.perf_counter() - t0)
            del got
            gc.collect()
            torch.cuda.empty_cache()
        for name, change in controls.items():
            if change is None:  # read beside the sound runs
                continue
            low = copy.deepcopy(cell)
            low.config.update(change)
            for i in range(args.controls):
                seed = args.first_seed + 7919 * i
                t0 = time.perf_counter()
                got = program_numbers(low, seed, devices, reference, cell.config)
                emit(f"control-{name}", seed, got["numbers"], got["leaves"], time.perf_counter() - t0)
                del got
                gc.collect()
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
