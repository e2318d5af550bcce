"""The port across two processes on the CPU (gloo), held against the one
process run: ``multihost.initialize`` from the ``MG_GCN_*`` variables, the
ring's ownership (one partition a process at ``-P 2``, two at ``-P 4``),
the per-process slab builds and the exchange.

* The library (``tests/torch_port_mp_worker.py``): GCN on the COO, gather,
  halo and halo-gather pairs and SAGE on the halo pair, 3 epochs at
  ``-P 2`` and ``-P 4``, and the all_gather exchange (COO, the pattern
  pair) and the pattern pair's fused ring, which gather every partition's
  block: losses, accuracies and final parameters on both
  processes equal the one-process run's bit for bit (``reduce_parts``
  folds every partition's partial in partition order on every process).
  ``from_slabs`` reads only a process's own slabs, and its blocks and send
  lists equal the one-process build's.
* The CLI: ``--multihost -P 2 -R 1 --impl halo --mmap -E 3 train``: the
  epoch lines equal across the processes and the one-process port CLI's
  bit for bit, epoch 0 within rtol 1e-5 of the JAX CLI's one-process
  ``-P 2`` line; the CSV and the checkpoint written once, by process 0. A
  missing ``graph_t.bin`` fails both processes fast, naming
  ``ensure_pigo_transpose``; GAT, ``-R 0``, ``pagerank`` and ``infer`` at
  two processes exit 2 naming ROADMAP queue 1 item 9i.

Every launch runs with one thread a process and is killed, both processes,
after at most 120 s. The JAX package's own two-process tests stay ``slow``
and are not run here."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu_torch import formats, sparse
from mg_gcn_tpu_torch.formats import Dataset
from tests.torch_port_mp_worker import ROOT, TIMEOUT_S, WORKER, free_port, launch

N, FEATURES, CLASSES = 96, 12, 5
CASES = ["gcn:coo:2", "gcn:gather:2", "gcn:halo:2", "gcn:halo_gather:2", "sage:halo:2",
         "gcn:coo:4", "gcn:gather:4", "gcn:halo:4", "sage:halo:4",
         # the exchanges that gather every block, and the pattern pair's fused ring
         "gcn:coo-all_gather:4", "sage:coo-all_gather:4", "gcn:pattern:2", "gcn:pattern-all_gather:4"]
EPOCH = re.compile(r"^(\d+) (\S+) (\S+) \S+$")


def _write_dataset(directory: str, transpose: bool = True) -> Dataset:
    rng = np.random.default_rng(1)
    ds = Dataset(graph=sparse.random_graph(N, 5, seed=3, weights="random"),
                 features=rng.standard_normal((N, FEATURES)).astype(np.float32),
                 labels=rng.integers(0, CLASSES, (N, 1)).astype(np.int32),
                 sets=rng.integers(0, 3, (N, 1)).astype(np.int32))
    ds.save(directory)
    if transpose:
        formats.ensure_pigo_transpose(directory)
    return ds


@pytest.fixture(scope="module")
def dataset(tmp_path_factory) -> str:
    d = str(tmp_path_factory.mktemp("mp") / "ds")
    _write_dataset(d)
    return d


@pytest.fixture(scope="module")
def library_runs(dataset, tmp_path_factory):
    """(one-process results, [process 0's, process 1's]) of every case."""
    tmp = tmp_path_factory.mktemp("lib")
    cases = [*CASES, "slabs:2", "slabs:4"]
    worker = [WORKER, dataset]
    one, ranks = str(tmp / "one.npz"), [str(tmp / f"rank{r}.npz") for r in range(2)]
    assert launch([[*worker, one, "cpu", *cases]], [str(tmp / "one.log")]) == [0]
    logs = [str(tmp / f"rank{r}.log") for r in range(2)]
    codes = launch([[*worker, path, "cpu", *cases] for path in ranks], logs, world=2)
    assert codes == [0, 0], [open(log).read()[-3000:] for log in logs]
    return np.load(one), [np.load(path) for path in ranks]


@pytest.mark.parametrize("case", CASES)
def test_two_processes_bit_equal_one_process(library_runs, case):
    one, ranks = library_runs
    keys = [k for k in one.files if k.startswith(case + "/")]
    assert {f"{case}/losses", f"{case}/accs"} <= set(keys) and any("/param/" in k for k in keys)
    assert np.isfinite(one[f"{case}/losses"]).all()
    for rank, got in enumerate(ranks):
        for k in keys:
            assert got[k].dtype == one[k].dtype and np.array_equal(got[k], one[k]), f"process {rank}: {k}"


@pytest.mark.parametrize("parts", [2, 4])
def test_slab_builds_read_owned_slabs_only(library_runs, parts):
    """Each process's ``slab_of`` saw its own partitions only, once each;
    its local blocks and send lists, and the agreed widths, entry count
    and useful volume, equal the one-process build's."""
    one, ranks = library_runs
    key, per = f"slabs:{parts}", parts // 2
    assert one[f"{key}/read"].tolist() == list(range(parts))
    for rank, got in enumerate(ranks):
        assert got[f"{key}/read"].tolist() == list(range(rank * per, (rank + 1) * per))
        assert np.array_equal(got[f"{key}/meta"], one[f"{key}/meta"])
        mine = [k for k in got.files if k.startswith(key + "/") and k.split("/")[1].isdigit()]
        assert {int(k.split("/")[1]) for k in mine} == set(range(rank * per, (rank + 1) * per))
        for k in mine:
            assert np.array_equal(got[k], one[k]), f"process {rank}: {k}"


CLI_ARGS = ["-P", "2", "-R", "1", "--impl", "halo", "-E", "3"]


def _epochs(log: str) -> list[tuple[str, str, str]]:
    return [m.groups() for m in map(EPOCH.match, open(log).read().splitlines()) if m]


@pytest.fixture(scope="module")
def cli_runs(dataset, tmp_path_factory):
    """The two-process CLI run (each process its own --csv-dir and --save,
    so that a file written by process 1 would show) and the one-process
    port CLI run at -P 2."""
    tmp = tmp_path_factory.mktemp("cli")
    cli = ["-m", "mg_gcn_tpu_torch.cli", "--device", "cpu", *CLI_ARGS]
    tail = ["train", dataset, "1", "8"]
    logs = [str(tmp / f"rank{r}.log") for r in range(2)]
    argvs = [[*cli, "--multihost", "--mmap", "--csv-dir", str(tmp / f"csv{r}"), "--save", str(tmp / f"ck{r}.npz"),
              *tail] for r in range(2)]
    codes = launch(argvs, logs, world=2)
    assert codes == [0, 0], [open(log).read()[-3000:] for log in logs]
    one = str(tmp / "one.log")
    assert launch([[*cli[:3], "cpu,cpu", *cli[4:], "--csv-dir", str(tmp / "csv_one"), "--save",
                    str(tmp / "ck_one.npz"), *tail]], [one]) == [0]
    return tmp, logs, one


def test_cli_epoch_lines_equal_across_processes(cli_runs):
    _, logs, _ = cli_runs
    lines = [_epochs(log) for log in logs]
    assert [e[0] for e in lines[0]] == ["0", "1", "2"]
    assert all(np.isfinite(float(e[1])) for e in lines[0])
    assert lines[0] == lines[1]
    for log in logs:
        text = open(log).read()
        assert "exchange route: gloo (no card)" in text and "halo exchange:" in text


def test_cli_bit_equal_one_process_cli(cli_runs):
    _, logs, one = cli_runs
    assert _epochs(logs[0]) == _epochs(one) == _epochs(logs[1])


def test_cli_epoch0_close_to_jax(cli_runs, dataset, tmp_path, capsys):
    """Epoch 0 against the JAX CLI's one-process ``-P 2`` halo run (its
    CPU mesh)."""
    _, logs, _ = cli_runs
    assert jcli.main([*CLI_ARGS[:-1], "1", "--csv-dir", str(tmp_path), "train", dataset, "1", "8"]) == 0
    want = [m.groups() for m in map(EPOCH.match, capsys.readouterr().err.splitlines()) if m][0]
    got = _epochs(logs[0])[0]
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)


def test_cli_writes_checkpoint_and_csv_once(cli_runs):
    tmp, _, _ = cli_runs
    assert os.listdir(tmp / "csv0") == os.listdir(tmp / "csv_one") and len(os.listdir(tmp / "csv0")) == 1
    assert not os.path.exists(tmp / "csv1") and not os.path.exists(tmp / "ck1.npz")
    got, want = np.load(tmp / "ck0.npz"), np.load(tmp / "ck_one.npz")
    assert got.files == want.files
    for k in got.files:
        assert np.array_equal(got[k], want[k]), k


def test_cli_missing_transpose_fails_fast(tmp_path):
    """No ``graph_t.bin``: process 0's check fails both processes at once
    (exit 2), naming ``ensure_pigo_transpose``; nothing is transposed."""
    d = str(tmp_path / "ds")
    _write_dataset(d, transpose=False)
    logs = [str(tmp_path / f"rank{r}.log") for r in range(2)]
    argv = ["-m", "mg_gcn_tpu_torch.cli", "--device", "cpu", "--multihost", *CLI_ARGS, "--csv-dir", str(tmp_path),
            "train", d, "1", "8"]
    assert launch([argv, argv], logs, world=2) == [2, 2]
    for log in logs:
        assert "graph_t.bin is missing: run mg_gcn_tpu_torch.formats.ensure_pigo_transpose" in open(log).read()
    assert not os.path.exists(os.path.join(d, "graph_t.bin"))


ITEM_9I = "ROADMAP queue 1 item 9i"
REFUSED = {
    "gat": (["-P", "2", "-R", "1", "--model", "gat", "train"], ITEM_9I),
    "R0": (["-P", "2", "-R", "0", "train"], ITEM_9I),
    "pagerank": (["-P", "2", "pagerank"], ITEM_9I),
    "infer": (["-P", "2", "-R", "1", "--load", "ck.npz", "infer"], ITEM_9I),
    "P3": (["-P", "3", "-R", "1", "train"], "-P 3 partitions do not split evenly over 2 processes"),
    "P1": (["-P", "1", "train"], "-P 1 partitions do not split evenly over 2 processes"),
}


def test_cli_later_paths_exit_2(dataset, tmp_path):
    """At two processes each of GAT, -R 0, pagerank and infer exits 2 on
    both, naming ROADMAP queue 1 item 9i, and a -P that does not split
    over the processes exits 2 saying so (the runs side by side)."""
    procs, logs = [], {}
    base = {k: v for k, v in os.environ.items() if not k.startswith("MG_GCN_")}
    try:
        for name, (args, _) in REFUSED.items():
            port = free_port()
            tail = [dataset] if args[-1] == "pagerank" else [dataset, "1", "8"]
            for rank in range(2):
                log = str(tmp_path / f"{name}{rank}.log")
                logs[(name, rank)] = log
                env = dict(base, OMP_NUM_THREADS="1", PYTHONPATH=ROOT, MG_GCN_COORDINATOR=f"localhost:{port}",
                           MG_GCN_NUM_PROCESSES="2", MG_GCN_PROCESS_ID=str(rank))
                with open(log, "w") as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "mg_gcn_tpu_torch.cli", "--device", "cpu", "--multihost",
                         "--csv-dir", str(tmp_path), *args, *tail], cwd=ROOT, env=env, stdout=out,
                        stderr=subprocess.STDOUT))
        codes = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [2] * len(procs)
    for (name, _), log in logs.items():
        text, message = open(log).read(), REFUSED[name][1]
        assert message in text and ("not ported yet:" in text) == (message == ITEM_9I), (name, text[-2000:])
