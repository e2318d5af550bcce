"""Port vs JAX package: the CLI's ``infer`` command — GCN, SAGE and GAT on
one device and GCN at ``-P 4 -R 1`` (``make_dist_infer``), each from a
checkpoint the JAX CLI wrote, with the JAX CLI's predictions and stderr
line, and the JAX CLI's refusals."""

import os

import numpy as np
import pytest
import torch

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu.formats import read_dense as jread_dense
from mg_gcn_tpu_torch import checkpoint, cli
from mg_gcn_tpu_torch.formats import Dataset, read_dense
from mg_gcn_tpu_torch.models import gcn
from mg_gcn_tpu_torch.nn import adam

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _last_err(capsys) -> list[str]:
    return capsys.readouterr().err.splitlines()


@pytest.mark.parametrize(
    "model_args,parts",
    [(["--model", "gcn"], 1), (["--model", "sage"], 1), (["--model", "gat", "--heads", "2"], 1),
     (["--model", "gcn"], 4)],
    ids=["gcn", "sage", "gat", "gcn-P4"],
)
def test_cli_infer_matches_jax(tmp_path, capsys, model_args, parts):
    """The JAX CLI trains 2 epochs and saves; both CLIs then infer from that
    checkpoint: equal predictions.bin (int32, (n, 1)) and equal
    ``inference: n=... acc=...`` lines."""
    ck = str(tmp_path / "ck.npz")
    dist = ["-P", str(parts), "-R", "1"] if parts > 1 else []
    impl = ["--impl", "xla"] if parts > 1 else []  # the COO ring on the JAX side's CPU mesh
    assert jcli.main([*dist, *impl, *model_args, "-E", "2", "--csv-dir", str(tmp_path), "--save", ck, "train",
                      GOLDEN, "1", "8"]) == 0
    capsys.readouterr()
    out, jout = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    assert cli.main([*dist, *model_args, "--device", "cpu", "--load", ck, "--save", out, "infer", GOLDEN, "1",
                     "8"]) == 0
    got = _last_err(capsys)
    assert jcli.main([*dist, *model_args, "--load", ck, "--save", jout, "infer", GOLDEN, "1", "8"]) == 0
    want = _last_err(capsys)
    assert got[-2].split(" seconds=")[0] == want[-2].split(" seconds=")[0]
    assert got[-2].startswith(f"inference: n={Dataset.load(GOLDEN).num_nodes} acc=") and got[-1] == f"wrote {out}"
    p, jp = read_dense(out, np.int32), jread_dense(jout, np.int32)
    assert p.shape == (256, 1) and p.dtype == np.int32
    np.testing.assert_array_equal(p, jp)


@pytest.mark.parametrize(
    "args",
    [
        ["infer", GOLDEN],
        ["infer", GOLDEN, "1", "8"],
        ["-P", "2", "-R", "0", "--load", "ck.npz", "infer", GOLDEN, "1", "8"],
        ["-P", "2", "-R", "1", "--model", "sage", "--load", "ck.npz", "infer", GOLDEN, "1", "8"],
        ["-P", "3", "-R", "1", "--load", "{p3}", "infer", GOLDEN, "1", "8"],
    ],
    ids=["no-sizes", "no-load", "R0", "sage-P2", "n-not-divisible"],
)
def test_cli_infer_refusals_match_jax(tmp_path, capsys, args):
    """Each exits 2 with the JAX CLI's message. n = 256 is not divisible by
    P = 3; that check follows the checkpoint's load, as in the JAX CLI, so
    it gets a checkpoint of the -P 3 widths (7 labels rounded up to 9)."""
    p3 = str(tmp_path / "p3.npz")
    params = gcn.init_params(gcn.GCNConfig(sizes=(16, 8, 9)), device="cpu")
    checkpoint.save_checkpoint(p3, (params, adam.adam_init(params)))
    args = [a.replace("{p3}", p3) for a in args]
    assert cli.main(["--device", "cpu,cpu,cpu" if "3" in args else "cpu", *args]) == 2
    got = _last_err(capsys)
    assert jcli.main(args) == 2
    want = _last_err(capsys)
    assert got[-1:] == want[-1:]


def test_cli_infer_names_later_items(capsys, monkeypatch):
    assert cli.main(["--device", "cpu", "--impl", "halo", "--load", "x", "infer", GOLDEN, "1", "8"]) == 2
    assert "--impl halo is a distributed mode; use -P <num> -R 1" in capsys.readouterr().err
    assert cli.main(["--multihost", "--device", "cpu", "--load", "x", "infer", GOLDEN, "1", "8"]) == 2
    assert "ROADMAP queue 1 item 9g" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--load", "x", "infer", GOLDEN, "1", "8"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
