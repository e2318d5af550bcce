"""What a cell is, found by name: ``BENCHMARK.json`` at the checkout's root
and the files of the benchmark's own folders.

    benchmark/configs/<config>.json      a model configuration (``file`` of its entry)
    benchmark/traffic/<traffic>.json     a traffic mix: graph layout, its parameters, engine choice
    benchmark/workloads/<cell>.json      a cell's limits on the numbers that decide ``correct``
    benchmark/graphs/<layout>.py         a graph generator: ``make(n, params, seed, device)``
    benchmark/families/<family>.py       the port's driver and the work count of a model family
    benchmark/reference/<family>.py      the plain reference of a model family
    benchmark/metrics/<metric>.py        one metric's reader: ``read(ctx) -> float | None``

A later cell or metric is new files plus new entries in ``BENCHMARK.json``:
nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass, field
from types import ModuleType

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
BENCH_DIR = "benchmark"


def bench_root(root: str) -> str:
    return os.path.join(root, BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(root: str, kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module (names may hold ``-`` and ``.``)."""
    path = os.path.join(bench_root(root), kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    modname = f"benchmark.{kind}.{name.replace('-', '_').replace('.', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """Everything one run of one cell needs, read from the files."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json entries this cell reports
    per_layer: list = field(default_factory=list)

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def reference(self) -> str:
        return self.config["reference"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, traffic,
    limits and the metrics it reports; raises for a name it does not hold."""
    bench = bench if bench is not None else load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=load_json(os.path.join(root, entry["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(os.path.join(bench_root(root), "traffic", f"{w['traffic']}.json")),
        limits=load_json(os.path.join(bench_root(root), "workloads", f"{name}.json"))["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def problems(bench: dict, root: str | None = None) -> list[str]:
    """What in ``bench`` breaks the naming rules or points at a missing file
    (with ``root``): empty for a sound file."""
    out = []

    def name_ok(what: str, s) -> None:
        if not isinstance(s, str) or not NAME_RE.fullmatch(s):
            out.append(f"{what}: bad name {s!r}")

    def line_ok(what: str, s) -> None:
        if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s or "\t" in s:
            out.append(f"{what}: bad text {s!r}")

    for c in bench["configs"]:
        name_ok("config", c["name"])
        line_ok("config source", c["source"])
        for k in c["reduced"]:
            name_ok("reduced key", k)
        if root is not None and not os.path.isfile(os.path.join(root, c["file"])):
            out.append(f"config {c['name']}: no file {c['file']}")
    configs = {c["name"] for c in bench["configs"]}
    seen = set()
    for w in bench["workloads"]:
        for key in ("name", "config", "traffic"):
            name_ok(f"workload {key}", w[key])
        line_ok("workload why", w["why"])
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: unknown config {w['config']}")
        if (w["config"], w["traffic"]) in seen:
            out.append(f"workload {w['name']}: config and traffic repeated")
        seen.add((w["config"], w["traffic"]))
        if root is not None:
            for kind, stem in (("traffic", w["traffic"]), ("workloads", w["name"])):
                if not os.path.isfile(os.path.join(bench_root(root), kind, f"{stem}.json")):
                    out.append(f"workload {w['name']}: no {kind} file {stem}.json")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    if len(set(names)) != len(names):
        out.append("metric names repeat")
    for m in bench["end_to_end"] + bench["per_layer"]:
        name_ok("metric", m["name"])
        if not UNIT_RE.fullmatch(m["unit"]):
            out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher") or m["source"] not in SOURCES:
            out.append(f"metric {m['name']}: bad better or source")
        if root is not None and not os.path.isfile(os.path.join(bench_root(root), "metrics", f"{m['name']}.py")):
            out.append(f"metric {m['name']}: no reader metrics/{m['name']}.py")
    for m in bench["per_layer"]:
        line_ok("layer", m["layer"])
        if m["moves"] not in {e["name"] for e in bench["end_to_end"]}:
            out.append(f"metric {m['name']}: moves unknown metric {m['moves']}")
    return out
