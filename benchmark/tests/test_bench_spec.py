"""BENCHMARK.json against the naming rules, every cell's files found by
name, and a new cell and a new metric added as new files plus entries."""

import json
import os
import shutil

from benchmark.harness import compare, spec
from benchmark.tests.helpers import ROOT, run_tiny, tiny_cell


def _bench():
    return spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_names_units_and_files_follow_the_rules():
    bench = _bench()
    assert spec.problems(bench, ROOT) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_problems_sees_bad_names():
    bench = _bench()
    bench["per_layer"] = [dict(bench["per_layer"][0], name="bad name", unit="tokens per second")]
    found = spec.problems(bench)
    assert any("bad name" in p for p in found) and any("bad unit" in p for p in found)


def test_every_cell_found_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"], bench)
        assert cell.chips in (1, 4)
        for kind, name in (("families", cell.family), ("reference", cell.reference),
                           ("graphs", cell.traffic["graph"])):
            assert spec.load_module(ROOT, kind, name) is not None
        assert set(cell.limits) == set(compare.NUMBERS)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "epoch_ms"}
        assert cell.per_layer
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1


def test_new_cell_and_metric_from_files_alone(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    bench["workloads"].append({"name": "gcn-reddit-sparse", "config": "gcn-reddit", "traffic": "sparse", "chips": 1,
                               "why": "a sparser uniform graph"})
    bench["per_layer"].append({"name": "entries_k", "unit": "k", "better": "higher", "source": "host_clock",
                               "layer": "operator build", "moves": "setup_s", "workloads": ["gcn-reddit-sparse"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "traffic", "sparse.json"), "w") as fh:
        json.dump({"graph": "uniform", "draws_per_row": 4, "self_loops": True, "impl": "auto", "traced_epochs": 2},
                  fh)
    with open(os.path.join(b, "workloads", "gcn-reddit-sparse.json"), "w") as fh:
        json.dump({"limits": dict.fromkeys(compare.NUMBERS, 1e-4)}, fh)
    with open(os.path.join(b, "metrics", "entries_k.py"), "w") as fh:
        fh.write("def read(ctx):\n    return ctx.work.products[0].nnz / 1e3\n")
    assert spec.problems(spec.load_json(os.path.join(root, "BENCHMARK.json")), root) == []
    cell = tiny_cell("gcn-reddit-sparse", draws=4, root=root)
    assert "entries_k" in [m["name"] for m in cell.per_layer]
    out = run_tiny(cell, trace=True, root=root)
    assert out["correct"]
    assert out["metrics"]["entries_k"]["value"] > 0
