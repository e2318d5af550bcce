"""The controls of ``correct`` on the card, at each cell's own size, come out
not correct on three seeds: the port with its own int8 aggregation path (the
precision below the bfloat16 operand the configurations state), and the port
with TF32 in its dense layers (below their float32 with TF32 off). Run on
the card (``python -m pytest benchmark/tests -m cuda``); skips without
enough cards."""

import json
import os
import time

import pytest
import torch

from benchmark.harness import runner, spec
from benchmark.tests.helpers import ROOT

pytestmark = pytest.mark.cuda

with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    CELLS = [w["name"] for w in json.load(fh)["workloads"]]
SEEDS = (3_400_000_001, 3_400_000_003, 3_400_000_005)
CONTROLS = {"int8": {"aggregation_dtype": "int8"}, "tf32": {"tf32": True}}


@pytest.mark.parametrize("control", sorted(CONTROLS))
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, control):
    cell = spec.load_cell(ROOT, name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA card(s)")
    for seed in SEEDS:
        out = runner.run(ROOT, cell, seed, 1.0, False, runner.cards(cell.chips), time.perf_counter(),
                         control=CONTROLS[control])
        assert not out["correct"], (seed, out["checks"])
