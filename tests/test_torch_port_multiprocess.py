"""The port across two processes on the CPU (gloo), held against the one
process run: ``multihost.initialize`` from the ``MG_GCN_*`` variables, the
ring's ownership (one partition a process at ``-P 2``, two at ``-P 4``),
the per-process slab builds and the exchange.

* The library (``tests/torch_port_mp_worker.py``): GCN on the COO, gather,
  halo and halo-gather pairs, SAGE on the halo pair, GAT (``-R 1``) and
  column-parallel GCN (``-R 0``), 3 epochs at ``-P 2`` and ``-P 4``, and
  the all_gather exchange (COO, the pattern pair) and the pattern pair's
  fused ring, which gather every partition's block: losses, accuracies,
  final parameters and Adam moments on both processes equal the
  one-process run's bit for bit (``reduce_parts`` folds every partition's
  partial in partition order on every process). The gradients that cross
  processes: GAT's on a graph of only cross-partition edges, which reach
  the parameters only through the ring hops' backward (equal to one
  card's; wrong with the hops detached), and the column path's, the true
  ones, not P times them. ``from_slabs`` reads only a process's own
  slabs, and its blocks and send lists equal the one-process build's.
* The CLI: ``--multihost -P 2 -R 1 --impl halo --mmap -E 3 train``, ``-P 2
  -R 1 --model gat`` and ``-P 2 -R 0``: the epoch lines equal across the
  processes and the one-process port CLI's bit for bit, the halo and
  column runs' epoch 0 within rtol 1e-5 of the JAX CLI's one-process
  ``-P 2`` line; the CSV and the checkpoint written once, by process 0. A
  missing ``graph_t.bin`` fails both processes fast, naming
  ``ensure_pigo_transpose``; ``pagerank`` and ``infer`` at two processes
  exit 2, naming the JAX package's own failure there.

Every launch runs with one thread a process and is killed, both processes,
after at most 120 s. The JAX package's own two-process tests stay ``slow``
and are not run here."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import torch

from mg_gcn_tpu import cli as jcli
from mg_gcn_tpu_torch import convert, formats, sparse
from mg_gcn_tpu_torch.formats import Dataset
from mg_gcn_tpu_torch.models import gat, gcn
from mg_gcn_tpu_torch.ops.spmm import AggPair, COOMat
from tests.torch_port_mp_worker import (GRAD_SEED, GRAD_SIZES, HIDDEN, ROOT, TIMEOUT_S, WORKER, cross_problem,
                                        free_port, launch)

N, FEATURES, CLASSES = 96, 12, 5
CASES = ["gcn:coo:2", "gcn:gather:2", "gcn:halo:2", "gcn:halo_gather:2", "sage:halo:2",
         "gcn:coo:4", "gcn:gather:4", "gcn:halo:4", "sage:halo:4",
         # the exchanges that gather every block, and the pattern pair's fused ring
         "gcn:coo-all_gather:4", "sage:coo-all_gather:4", "gcn:pattern:2", "gcn:pattern-all_gather:4",
         # the paths whose exchanges carry gradients between processes
         "gat:2", "gat:4", "col:2", "col:4"]
GRAD_CASES = ["gatgrad:2", "gatgrad:4", "gatgrad-cut:2", "gatgrad-cut:4", "colgrad:2", "colgrad:4"]
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
    cases = [*CASES, *GRAD_CASES, "slabs:2", "slabs:4"]
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


def assert_leaves_close(got: dict, want, bound: float) -> None:
    """Per leaf of ``want`` (a list of numpy dicts), ‖got − want‖ ≤ bound ·
    ‖want‖; ``got`` maps ``i/k`` to the leaf."""
    for i, layer in enumerate(want):
        for k, w in layer.items():
            g = np.asarray(got[f"{i}/{k}"], np.float64).reshape(w.shape)
            diff = np.linalg.norm(g - w)
            assert diff <= bound * np.linalg.norm(w), f"layer {i} {k}: {diff} > {bound} x {np.linalg.norm(w)}"


def grads_of(results, case: str) -> dict:
    prefix = f"{case}/grad/"
    return {k[len(prefix):]: results[k] for k in results.files if k.startswith(prefix)}


@pytest.mark.parametrize("parts", [2, 4])
def test_ring_hops_carry_gradient_across_processes(library_runs, parts):
    """On a graph whose every edge crosses partitions (at -P 2 every hop
    crosses processes, at -P 4 every other one), e_src and z reach a row
    only through the ring hops, so every gradient of layer 0 and ``a_src``'s
    come only through the hops' backward (``dist._Hop``, the reverse
    ring): on both processes bit for bit the one-process run's and within
    1e-5 of the one-card GAT step's gradients; with the hops detached more
    than 10 % off in norm."""
    one, ranks = library_runs
    case = f"gatgrad:{parts}"
    graph, x, y = cross_problem(parts)
    config = gat.GATConfig(sizes=GRAD_SIZES, heads=2)
    params = gat.init_params(config, seed=GRAD_SEED, device="cpu")
    loss, _, want = gat.loss_and_grad(params, gat.build_gat_graph(graph, dtype="float32", device="cpu"),
                                      torch.from_numpy(x), torch.from_numpy(y), config)
    want = convert.params_to_numpy(want)
    for got in ranks:
        assert float(got[f"{case}/loss"]) == float(one[f"{case}/loss"])
        for k, v in grads_of(one, case).items():
            assert np.array_equal(grads_of(got, case)[k], v), k
    np.testing.assert_allclose(float(one[f"{case}/loss"]), float(loss), rtol=1e-5)
    assert_leaves_close(grads_of(ranks[1], case), want, 1e-5)
    cut = grads_of(ranks[1], f"gatgrad-cut:{parts}")
    for i in range(config.num_layers):
        for k in ("a_src", "W"):
            ref = want[i][k]
            assert np.linalg.norm(cut[f"{i}/{k}"].reshape(ref.shape) - ref) > 0.1 * np.linalg.norm(ref), (i, k)


@pytest.mark.parametrize("parts", [2, 4])
def test_column_gradients_across_processes_are_the_true_ones(library_runs, dataset, parts):
    """The column step across two processes: every process's loss is the
    one loss, and its gathered gradients equal the one-process run's bit
    for bit and the one-card exact GCN gradients within 1e-5 of each
    leaf's norm: the true ones, not P times them (the JAX column step's
    fault, ``test_torch_port_dist_col.py``)."""
    one, ranks = library_runs
    case = f"colgrad:{parts}"
    ds = Dataset.load(dataset)
    sizes = tuple(-(-s // parts) * parts for s in (ds.num_features, HIDDEN, ds.num_labels))
    config = gcn.GCNConfig(sizes=sizes, parity=False)
    a = sparse.normalize(ds.graph, axis=True)
    pair = AggPair(COOMat.from_csr(sparse.transpose(a), device="cpu"), COOMat.from_csr(a, device="cpu"))
    x = np.zeros((ds.num_nodes, sizes[0]), np.float32)
    x[:, : ds.num_features] = ds.features
    loss, _, want = gcn.loss_and_grad(gcn.init_params(config, device="cpu"), pair, torch.from_numpy(x),
                                      torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)), config)
    want = convert.params_to_numpy(want)
    for got in ranks:
        assert float(got[f"{case}/loss"]) == float(one[f"{case}/loss"])
        for k, v in grads_of(one, case).items():
            assert np.array_equal(grads_of(got, case)[k], v), k
        assert_leaves_close(grads_of(got, case), want, 1e-5)
    np.testing.assert_allclose(float(one[f"{case}/loss"]), float(loss), rtol=1e-5)


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


LATER_CLI = {"gat": ["-P", "2", "-R", "1", "--model", "gat", "--heads", "2", "-E", "3"],
             "col": ["-P", "2", "-R", "0", "-E", "3"]}


@pytest.fixture(scope="module")
def later_cli_runs(dataset, tmp_path_factory):
    """For ``--model gat -R 1`` and ``-R 0`` at ``-P 2``: (tmp dir, the
    two processes' logs, the one-process log) of the two-process CLI run
    (each process its own --csv-dir and --save) and the one-process port
    CLI run."""
    runs = {}
    for name, args in LATER_CLI.items():
        tmp = tmp_path_factory.mktemp(name)
        tail = [*args, "train", dataset, "1", "8"]
        logs = [str(tmp / f"rank{r}.log") for r in range(2)]
        argvs = [["-m", "mg_gcn_tpu_torch.cli", "--device", "cpu", "--multihost", "--csv-dir", str(tmp / f"csv{r}"),
                  "--save", str(tmp / f"ck{r}.npz"), *tail] for r in range(2)]
        codes = launch(argvs, logs, world=2)
        assert codes == [0, 0], [open(log).read()[-3000:] for log in logs]
        one = str(tmp / "one.log")
        assert launch([["-m", "mg_gcn_tpu_torch.cli", "--device", "cpu,cpu", "--csv-dir", str(tmp / "csv_one"),
                        "--save", str(tmp / "ck_one.npz"), *tail]], [one]) == [0]
        runs[name] = (tmp, logs, one)
    return runs


@pytest.mark.parametrize("name", list(LATER_CLI))
def test_cli_gat_and_column_bit_equal_one_process_cli(later_cli_runs, name):
    """``--multihost`` GAT (``-R 1``) and the column path (``-R 0``): three
    finite epoch lines, equal on both processes and to the one-process
    port CLI's at ``--device cpu,cpu`` bit for bit, each process naming
    its route."""
    _, logs, one = later_cli_runs[name]
    want = _epochs(one)
    assert [e[0] for e in want] == ["0", "1", "2"] and all(np.isfinite(float(e[1])) for e in want)
    for log in logs:
        assert _epochs(log) == want
        assert "exchange route: gloo (no card)" in open(log).read()


def test_cli_column_epoch0_close_to_jax(later_cli_runs, dataset, tmp_path, capsys):
    """The two-process ``-P 2 -R 0`` run's epoch 0 against the JAX CLI's
    one-process ``-P 2 -R 0`` line (its CPU mesh; epoch 0 is before any
    update, where the JAX step's P× gradient does not show)."""
    _, logs, _ = later_cli_runs["col"]
    assert jcli.main(["-P", "2", "-R", "0", "-E", "1", "--csv-dir", str(tmp_path), "train", dataset, "1", "8"]) == 0
    want = [m.groups() for m in map(EPOCH.match, capsys.readouterr().err.splitlines()) if m][0]
    got = _epochs(logs[0])[0]
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)


@pytest.mark.parametrize("name", list(LATER_CLI))
def test_cli_gat_and_column_write_checkpoint_and_csv_once(later_cli_runs, name):
    """Process 0 alone writes the CSV and the checkpoint, equal to the
    one-process run's: for ``-R 0`` the full rounded arrays, gathered from
    both processes' shards."""
    tmp, _, _ = later_cli_runs[name]
    assert os.listdir(tmp / "csv0") == os.listdir(tmp / "csv_one") and len(os.listdir(tmp / "csv0")) == 1
    assert not os.path.exists(tmp / "csv1") and not os.path.exists(tmp / "ck1.npz")
    got, want = np.load(tmp / "ck0.npz"), np.load(tmp / "ck_one.npz")
    assert got.files == want.files
    for k in got.files:
        assert np.array_equal(got[k], want[k]), k
    if name == "col":
        assert got["leaf_0"].shape == (12, 8)  # layer 0 W, every shard


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


def test_pagerank_dist_refuses_a_ring_across_processes():
    """``pagerank_dist`` on a ring that spans two processes raises before any
    exchange, naming the JAX package's own failure there
    (``mg_gcn_tpu/models/pagerank.py:209``)."""
    from mg_gcn_tpu_torch.models.pagerank import pagerank_dist
    from mg_gcn_tpu_torch.parallel import dist

    ring = dist.Ring((torch.device("cpu"),), world=2, rank=0)
    with pytest.raises(NotImplementedError) as err:
        pagerank_dist(sparse.random_graph(16, 3, seed=1), ring)
    assert str(err.value) == ("pagerank -P N across processes: the JAX package fails there too"
                              " (mg_gcn_tpu/models/pagerank.py:209 raises RuntimeError on a jax.Array that spans"
                              " non-addressable devices)")


JAX_FAILS = ("across processes is not supported: the JAX package fails there too ({}"
             " raises RuntimeError: Fetching value for jax.Array that spans non-addressable (non process local)"
             " devices is not possible)")
REFUSED = {
    "pagerank": (["-P", "2", "pagerank"], "pagerank " + JAX_FAILS.format("mg_gcn_tpu/models/pagerank.py:209")),
    "infer": (["-P", "2", "-R", "1", "--load", "ck.npz", "infer"],
              "infer " + JAX_FAILS.format("mg_gcn_tpu/cli.py:925")),
    "P3": (["-P", "3", "-R", "1", "train"], "-P 3 partitions do not split evenly over 2 processes"),
    "P1": (["-P", "1", "train"], "-P 1 partitions do not split evenly over 2 processes"),
}


def test_cli_later_paths_exit_2(dataset, tmp_path):
    """At two processes each of pagerank and infer exits 2 on both, naming
    the JAX package's own failure there (the JAX CLI raises on a jax.Array
    that spans both processes' devices), and a -P that does not split over
    the processes exits 2 saying so (the runs side by side)."""
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
        assert message in text and "not ported yet" not in text, (name, text[-2000:])
