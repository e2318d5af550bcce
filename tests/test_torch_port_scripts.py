"""The port's validation scripts (``mg_gcn_tpu_torch/scripts/``) at toy
sizes on the CPU, each against its own pass condition, and their defaults
against the JAX scripts' full sizes. (That they import no JAX is
``test_torch_port_host.py::test_port_source_imports_no_jax``.)"""

import ast
import importlib
import json
import os

import pytest
import torch

from mg_gcn_tpu_torch.scripts import (
    trajectory_parity, validate_accuracy, validate_gat, validate_gat_headline, validate_products,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_validate_accuracy_prints_the_gap(capsys):
    out = validate_accuracy.main("--n 600 --deg 20 --classes 5 --features 32 --hidden 16 16 --epochs 4"
                                 " --device cpu".split())
    printed = capsys.readouterr()
    assert f"accuracy gap bf16 - int8 = {out['gap']:+.4f}" in printed.out
    assert out["gap"] == out["bfloat16"] - out["int8"] and 0 < out["int8"] <= 1
    assert "[bfloat16] final acc" in printed.err and "[int8] final acc" in printed.err


def test_validate_gat_passes(capsys):
    out = validate_gat.main("--n 1024 --deg 50 --classes 4 --epochs 30 --device cpu".split())
    assert out["acc"] > 0.95
    assert capsys.readouterr().out.rstrip().endswith("PASS")


def test_validate_gat_fails_below_the_bar():
    with pytest.raises(SystemExit, match="failed to separate"):
        validate_gat.main("--n 1024 --deg 50 --classes 4 --epochs 2 --device cpu".split())


def test_validate_products_prints_the_trajectory(capsys):
    out = validate_products.main("--n 3000 --deg 10 --classes 6 --features 16 --hidden 16 16 --epochs 3"
                                 " --device cpu".split())
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("epoch ")]
    assert out["engine"] == "xla" and len(lines) == len(out["losses"]) == 3
    assert out["losses"][-1] < out["losses"][0]


def test_validate_gat_headline_prints_the_trajectory(capsys):
    out = validate_gat_headline.main("--n 1500 --deg 20 --classes 5 --features 16 --hidden 8 --epochs 3"
                                     " --device cpu".split())
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("epoch ")]
    assert len(lines) == len(out["losses"]) == 3 and out["losses"][-1] < out["losses"][0]


def test_trajectory_parity_within_bounds_writes_only_its_out(tmp_path, monkeypatch, capsys):
    """Within the JAX script's bounds; the JSON goes to ``--out`` and
    nowhere else: the working directory stays empty, and the default
    ``.bench_cache/trajectory_parity.json`` and ``TRAJECTORY.json`` are left
    as they were."""
    def stamp(path):
        return os.stat(path).st_mtime_ns if os.path.exists(path) else None

    guarded = [os.path.join(REPO, ".bench_cache", "trajectory_parity.json"), os.path.join(REPO, "TRAJECTORY.json")]
    before = [stamp(p) for p in guarded]
    work, out_dir = tmp_path / "work", tmp_path / "out"
    work.mkdir()
    monkeypatch.chdir(work)
    out = trajectory_parity.main(f"--n 1500 --deg 20 --classes 5 --d 16 --hidden 16 16 --epochs 5 --device cpu"
                                 f" --out {out_dir / 'parity.json'}".split())
    assert [stamp(p) for p in guarded] == before and os.listdir(work) == []
    assert os.listdir(out_dir) == ["parity.json"]
    with open(out_dir / "parity.json") as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert out["max_rel_loss_delta"] < 5e-3 and out["max_acc_delta"] < 5e-3
    assert len(out["port_losses"]) == len(out["oracle_losses"]) == 5
    assert "max |dloss|" in capsys.readouterr().out


@pytest.mark.parametrize("name,jax_names", [
    ("validate_accuracy", dict(n="N", deg="DEG", classes="CLASSES", features="FEATURES", hidden="HIDDEN",
                               epochs="EPOCHS")),
    ("validate_gat", dict(n="N", deg="DEG", classes="CLASSES", features="FEATURES", hidden="HIDDEN", heads="HEADS",
                          epochs="EPOCHS")),
    ("trajectory_parity", dict(n="N", deg="DEG", classes="CLASSES", hidden="HIDDEN")),
])
def test_defaults_are_the_jax_scripts_full_sizes(name, jax_names):
    """The scripts' defaults against the JAX scripts' constants, read from
    their sources (not imported: the scripts import JAX)."""
    with open(os.path.join(REPO, "scripts", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name) and isinstance(node.value, (ast.Constant, ast.List))}
    args = importlib.import_module(f"mg_gcn_tpu_torch.scripts.{name}").parse_args([])
    for ours, theirs in jax_names.items():
        assert getattr(args, ours) == consts[theirs], ours
    assert args.device == "cuda"


def test_products_and_headline_defaults():
    """validate_products.py and validate_gat_headline.py keep their sizes in
    bench.py's cache keys (products_pg_2449029_50_48, pg_232968_493_41) and
    their code: (100, 256, 256, 48) and (64, 64, 41), 2 heads; 30 epochs."""
    p, h = validate_products.parse_args([]), validate_gat_headline.parse_args([])
    assert (p.n, p.deg, p.classes, p.features, p.hidden, p.epochs) == (2_449_029, 50, 48, 100, [256, 256], 30)
    assert (h.n, h.deg, h.classes, h.features, h.hidden, h.heads, h.epochs) == (232_968, 493, 41, 64, 64, 2, 30)
    assert trajectory_parity.parse_args([]).epochs == 20 and trajectory_parity.parse_args([]).d == 64


def test_probe_walk_vs_pack_builds_one_draw_for_both_engines():
    """The probe's graph on the CPU: its pack and CSR hold one draw (the
    plain ``pattern_bwd`` equals ``gather`` inside ``probe``), about 1 bit
    in k set, and the line's bytes are the pack's and the index list's."""
    from mg_gcn_tpu_torch.scripts import probe_walk_vs_pack

    lines = probe_walk_vs_pack.main("--n 4096 --inv-density 8 64 --reps 1".split())
    for line, k in zip(lines, (8, 64)):
        assert line["n"] == 4096 and line["inv_density"] == k
        assert abs(line["nnz"] * k / 4096**2 - 1) < 0.02
        assert line["pack_gb"] == 4096**2 / 8 / 1e9 and line["index_gb"] == (4 * line["nnz"] + 8 * 4097) / 1e9
        names = ("pattern_fwd", "pattern_bwd", "gather")
        assert set(line["ms"]) == {f"{name}.{d}" for name in names for d in (128, 48)}
    from mg_gcn_tpu_torch.ops.spmm_pattern import decode_pattern

    pack, indptr, indices = probe_walk_vs_pack.uniform_graph(4096, 8, seed=1, dev=torch.device("cpu"))
    rows, cols = decode_pattern(pack, 0, 4096)
    key = (rows * 4096 + cols).sort().values
    csr_rows = torch.repeat_interleave(torch.arange(4096), indptr.diff())
    assert int(indptr[-1]) == indices.numel() and torch.equal(key, csr_rows * 4096 + indices.long())
