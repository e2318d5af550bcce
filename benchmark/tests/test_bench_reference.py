"""The plain references against a float64 twin of themselves and against the
port's COO engine on the CPU, at a tiny size; and the reference modules
import nothing of the port."""

import subprocess
import sys

import pytest
import torch

from benchmark.harness import compare, runner, spec
from benchmark.tests.helpers import ROOT, SEED, run_tiny, tiny_cell


def _reference_record(cell, dtype):
    graph, x, y, params0 = runner.make_inputs(ROOT, cell, SEED, torch.device("cpu"))
    ref = spec.load_module(ROOT, "reference", cell.reference)
    p = {k: v.to(dtype) for k, v in params0.items()}
    return ref.run(graph, torch.from_numpy(x).to(dtype), torch.from_numpy(y), p, cell.config, 3)


def _float32(cell):
    cell.config["aggregation_dtype"] = "float32"
    return cell


@pytest.mark.parametrize("name", ["gcn-reddit-uniform", "sage-reddit-uniform"])
def test_reference_against_float64_twin(name):
    cell = _float32(tiny_cell(name))
    r32 = _reference_record(cell, torch.float32)
    r64 = _reference_record(cell, torch.float64)
    got = compare.numbers(r32, r64)
    # float32 rounding of a few hundred nodes' sums through four layers and three Adam steps
    assert got["loss_gap"][0] < 3e-6
    assert got["grad_gap"][0] < 1e-5
    assert got["change_gap"][0] < 1e-4
    assert got["grad_dir"][0] < 1e-5
    assert r64["losses"][2] < r64["losses"][0]


@pytest.mark.parametrize("name", ["gcn-reddit-uniform", "sage-reddit-uniform", "gcn-reddit-banded"])
def test_reference_against_port_coo(name):
    """On the CPU ``impl="auto"`` is the port's COO engine in float32: the
    same sums as the reference's in float32, in another order."""
    cell = _float32(tiny_cell(name))
    cell.traffic["impl"] = "auto"
    out = run_tiny(cell)
    assert out["correct"]
    for k in compare.NUMBERS:
        # Adam's first step moves an element by ±lr, so the summation order
        # of a near-nought gradient shows in the change
        bound = 1e-3 if k == "change_gap" else 1e-5
        assert out["checks"][k]["value"] < bound, (k, out["checks"][k])


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.reference.gcn, benchmark.reference.sage, benchmark.reference.common;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'mg_gcn_tpu_torch', 'mg_gcn_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", ["gcn-reddit-uniform", "sage-reddit-uniform", "gcn-reddit-banded",
                                  "gcn-reddit-p4-uniform"])
def test_reference_rounds_where_the_port_does(name):
    """With a bfloat16 operand the reference rounds the aggregation's operand
    as the configuration states (after the forward's scaling, before the
    backward's product): against the port's bfloat16 pattern pair on the CPU
    the numbers are float32 summation order alone, where the reference in
    float32 reads the bfloat16 rounding, some thousand times more."""
    cell = tiny_cell(name)
    assert cell.config["aggregation_dtype"] == "bfloat16"
    out = run_tiny(cell)
    assert out["correct"]
    for k in compare.NUMBERS:
        bound = 1e-3 if k == "change_gap" else 1e-5
        assert out["checks"][k]["value"] < bound, (k, out["checks"][k])
