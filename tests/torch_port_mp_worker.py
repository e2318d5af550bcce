"""One process of the port's multi-process tests
(``tests/test_torch_port_multiprocess.py``, and on the card
``tests/test_torch_port_cuda.py``), run as

    PYTHONPATH=. python tests/torch_port_mp_worker.py <dataset dir> <out.npz> <device> <case> ...

from the repository root. With ``MG_GCN_COORDINATOR`` set it joins the run
(``multihost.initialize``); without it, it is the one-process run the others
are held against. Each case is ``<model>:<pair kind>[-<exchange>]:<P>``
(``gcn:coo:4``, ``gcn:coo-all_gather:4``, ``sage:halo:2``; the pattern pair
on the binary graph in float32, fused by default), ``gat:<P>`` (two heads,
bfloat16 ring blocks of the whole graph) or ``col:<P>`` (column-parallel
GCN, ``-R 0``; ``slabs:<P>`` records the halo build instead;
``gatgrad[-cut]:<P>`` and ``colgrad:<P>`` record one step's gradients on
:func:`cross_problem` and on the dataset, ``-cut`` with the GAT ring hops
detached): 3 epochs of
the port's distributed step from the seed-99 parameters, on this process's
partitions, with the pair built as the CLI builds it (the halo kinds from
each process's row slabs of ``graph.bin`` and ``graph_t.bin``, features
mapped). Writes every case's losses, accuracies, final parameters and Adam
moments (the column path's gathered to full arrays; and for ``slabs``, the
slab ids read and the local blocks) to ``out.npz``. No
JAX here. :func:`launch` starts such processes (or the CLI's) for the
tests, as one run or alone, and kills every one left after its timeout."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import scipy.sparse as sps
import torch

from mg_gcn_tpu_torch import sparse
from mg_gcn_tpu_torch.formats import CSRData, Dataset, read_pigo_csr_slab
from mg_gcn_tpu_torch.models import gat, gcn, sage
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.ops.spmm import COOMat
from mg_gcn_tpu_torch.parallel import dist, dist_col, dist_gat, multihost
from mg_gcn_tpu_torch.parallel.dist_halo import DistHaloMat, DistHaloPair

EPOCHS = 3
HIDDEN = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)  # run by path: ``tests`` may name another package where it runs
TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argvs: list[list[str]], logs: list[str], world: int | None = None, device_ids: str | None = None,
           timeout: float = TIMEOUT_S) -> list[int]:
    """Start ``python <argv>`` once an argv from the repository root, with
    one thread a process, as the ranks of one run of ``world`` processes
    (``MG_GCN_*`` set; ``MG_GCN_LOCAL_DEVICE_IDS`` = ``device_ids``) or,
    with ``world`` None, alone. Waits at most ``timeout`` seconds for all,
    then kills every one still running. Returns the exit codes; each
    process's output goes to its log."""
    port, procs = free_port(), []
    base = {k: v for k, v in os.environ.items() if not k.startswith("MG_GCN_")}
    base.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=ROOT)
    try:
        for rank, (argv, log) in enumerate(zip(argvs, logs)):
            env = dict(base)
            if world is not None:
                env.update(MG_GCN_COORDINATOR=f"localhost:{port}", MG_GCN_NUM_PROCESSES=str(world),
                           MG_GCN_PROCESS_ID=str(rank), **({"MG_GCN_LOCAL_DEVICE_IDS": device_ids} if device_ids else {}))
            with open(log, "w") as out:
                procs.append(subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env, stdout=out,
                                              stderr=subprocess.STDOUT))
        return [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _pair(kind: str, model: str, directory: str, ds, mesh):
    if kind == "pattern":
        g = Dataset.load(directory).graph
        binary = type(g)(g.indptr, g.indices, np.ones_like(g.data), g.shape)
        return dist.DistPatternPair.from_binary_csr(binary, mesh, dtype="float32")
    if kind in ("halo", "halo_gather"):
        engine = "gather" if kind == "halo_gather" else "xla"
        return DistHaloPair.from_pigo(f"{directory}/graph.bin", f"{directory}/graph_t.bin", mesh, engine=engine,
                                      norm=model)
    full = Dataset.load(directory).graph
    if model == "gcn":
        a = sparse.normalize(full, axis=True)
        return dist.build_pair(kind, sparse.transpose(a), a, mesh)
    m = sparse.normalize(full, axis=False)
    return dist.build_pair(kind, m, sparse.transpose(m), mesh)


def record(out: dict, case: str, losses, accs, params, state) -> None:
    out[f"{case}/losses"] = np.array(losses)
    out[f"{case}/accs"] = np.array(accs)
    for name, tree in (("param", params), ("m", state.m), ("v", state.v)):
        for i, layer in enumerate(tree):
            for k, v in layer.items():
                out[f"{case}/{name}/{i}/{k}"] = v.detach().cpu().numpy()


def run_gat_case(parts: int, directory: str, device: str, out: dict) -> None:
    """``gat:<P>``: the distributed GAT step, two heads, bfloat16 blocks."""
    mesh = dist.make_mesh(parts, [device] * (parts // multihost.process_count()))
    ds = Dataset.load(directory, mmap_features=True)
    config = gat.GATConfig(sizes=(ds.num_features, HIDDEN, -(-ds.num_labels // parts) * parts), heads=2,
                           loss_mask="train")
    params = gat.init_params(config, device=device)
    graph = dist_gat.build_dist_gat_graph(ds.graph, mesh, dtype="bfloat16")
    step = dist_gat.make_dist_gat_train_step(config, mesh, graph)
    xs, ys, masks = dist.shard_dataset(ds, mesh, mask_train=True)
    p, st = dist.replicate(params, mesh), dist.replicate(adam.adam_init(params), mesh)
    losses, accs = [], []
    for _ in range(EPOCHS):
        p, st, loss, acc = step(p, st, graph, xs, ys, masks)
        losses.append(float(loss))
        accs.append(float(acc))
    record(out, f"gat:{parts}", losses, accs, p[0], st[0])


def run_col_case(parts: int, directory: str, device: str, out: dict) -> None:
    """``col:<P>``: the column-parallel step (``-R 0``), every width rounded
    to a multiple of P as the CLI rounds it."""
    mesh = dist_col.make_col_mesh(parts, [device] * (parts // multihost.process_count()))
    ds = Dataset.load(directory)
    sizes = tuple(-(-s // parts) * parts for s in (ds.num_features, HIDDEN, ds.num_labels))
    config = gcn.GCNConfig(sizes=sizes, parity=False)
    params = gcn.init_params(config, device=device)
    a = sparse.normalize(ds.graph, axis=True)
    mats = dist_col.replicate_coo(COOMat.from_csr(sparse.transpose(a), device=mesh.devices[0]), mesh)
    x = np.zeros((ds.num_nodes, sizes[0]), np.float32)
    x[:, : ds.num_features] = ds.features
    xs = dist_col.shard_columns(x, mesh)
    ys = [torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev) for dev in mesh.devices]
    step = dist_col.make_col_train_step(config, mesh, ds.num_nodes)
    p, st = dist_col.shard_col_params(params, mesh), dist_col.shard_col_state(adam.adam_init(params), mesh)
    losses, accs = [], []
    for _ in range(EPOCHS):
        p, st, loss, acc = step(p, st, mats, xs, ys)
        losses.append(float(loss))
        accs.append(float(acc))
    record(out, f"col:{parts}", losses, accs, dist_col.gather_col_params(p, mesh), dist_col.gather_col_state(st, mesh))


GRAD_N, GRAD_SIZES, GRAD_SEED = 96, (5, 4, 3), 7


def cross_problem(parts: int):
    """(graph, x, y) of the gradient cases: every row of slab j links to 3
    random nodes of slab (j + 1) % P only, so every score and aggregated
    feature comes over the ring (``test_torch_port_dist_gat.cross_graph``);
    features and labels from a numpy seed."""
    n, m = GRAD_N, GRAD_N // parts
    rng = np.random.default_rng(GRAD_SEED)
    rows = np.repeat(np.arange(n), 3)
    cols = ((rows // m + 1) % parts) * m + rng.integers(0, m, rows.size)
    a = sps.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    a.data[:] = 1.0
    x = rng.standard_normal((n, GRAD_SIZES[0])).astype(np.float32)
    y = rng.integers(0, GRAD_SIZES[-1], n).astype(np.int64)
    return CSRData(a.indptr.astype(np.int64), a.indices.astype(np.int32), a.data, a.shape), x, y


def record_grads(out: dict, case: str, loss, grads) -> None:
    out[f"{case}/loss"] = np.array(float(loss))
    for i, layer in enumerate(grads):
        for k, v in layer.items():
            out[f"{case}/grad/{i}/{k}"] = v.detach().cpu().numpy()


def gat_grads(case: str, parts: int, device: str, out: dict) -> None:
    """``gatgrad[-cut]:<P>``: one float32 GAT step's loss and gradients
    (two heads, ``init_params(seed=7)``) on :func:`cross_problem`, summed
    over the partitions; ``-cut`` detaches every ring hop's output."""
    mesh = dist.make_mesh(parts, [device] * (parts // multihost.process_count()))
    graph, x, y = cross_problem(parts)
    config = gat.GATConfig(sizes=GRAD_SIZES, heads=2)
    params = gat.init_params(config, seed=GRAD_SEED, device=device)
    if case.startswith("gatgrad-cut"):
        hop = dist_gat._ppermute
        dist_gat._ppermute = lambda blocks, ring: [b.detach() for b in hop(blocks, ring)]
    try:
        g = dist_gat.build_dist_gat_graph(graph, mesh, dtype="float32")
        loss, _, grads = dist_gat.dist_gat_loss_and_grad([params] * len(mesh.devices), g,
                                                         dist.shard(x, mesh), dist.shard(y, mesh), config)
    finally:
        dist_gat._ppermute = dist._ppermute
    record_grads(out, case, loss, grads)


def col_grads(case: str, parts: int, directory: str, device: str, out: dict) -> None:
    """``colgrad:<P>``: one column-parallel step's loss and gradients on the
    dataset (widths rounded to P), gathered to full arrays."""
    mesh = dist_col.make_col_mesh(parts, [device] * (parts // multihost.process_count()))
    ds = Dataset.load(directory)
    sizes = tuple(-(-s // parts) * parts for s in (ds.num_features, HIDDEN, ds.num_labels))
    config = gcn.GCNConfig(sizes=sizes, parity=False)
    a = sparse.normalize(ds.graph, axis=True)
    mats = dist_col.replicate_coo(COOMat.from_csr(sparse.transpose(a), device=mesh.devices[0]), mesh)
    x = np.zeros((ds.num_nodes, sizes[0]), np.float32)
    x[:, : ds.num_features] = ds.features
    ys = [torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev) for dev in mesh.devices]
    params = dist_col.shard_col_params(gcn.init_params(config, device=device), mesh)
    loss, _, grads = dist_col.col_loss_and_grad(params, mats, dist_col.shard_columns(x, mesh), ys, config,
                                                ds.num_nodes, mesh)
    record_grads(out, case, loss, dist_col.gather_col_params(grads, mesh))


def run_case(case: str, directory: str, device: str, out: dict) -> None:
    model, kind, parts = case.split(":")
    kind, _, strategy = kind.partition("-")
    strategy = strategy or ("fused" if kind == "pattern" else "ring")
    parts = int(parts)
    mesh = dist.make_mesh(parts, [device] * (parts // multihost.process_count()))
    ds = Dataset.load(directory, mmap_features=True, graph_mode="header")
    sizes = (ds.num_features, HIDDEN, -(-ds.num_labels // parts) * parts)
    if model == "gcn":
        config = gcn.GCNConfig(sizes=sizes, loss_mask="train")
        params = gcn.init_params(config, device=device)
        step = dist.make_dist_train_step(config, mesh, ds.num_nodes, strategy=strategy, pair_kind=kind,
                                         pattern_dtype="float32")
    else:
        config = sage.SAGEConfig(sizes=sizes, loss_mask="train")
        params = sage.init_params(config, device=device)
        step = dist.make_dist_sage_train_step(config, mesh, ds.num_nodes, strategy=strategy, pair_kind=kind)
    pair = _pair(kind, model, directory, ds, mesh)
    xs, ys, masks = dist.shard_dataset(ds, mesh, getattr(pair, "n_pad", None), mask_train=True)
    p, st = dist.replicate(params, mesh), dist.replicate(adam.adam_init(params), mesh)
    losses, accs = [], []
    for _ in range(EPOCHS):
        p, st, loss, acc = step(p, st, pair, xs, ys, masks)
        losses.append(float(loss))
        accs.append(float(acc))
    record(out, case, losses, accs, p[0], st[0])


def record_slabs(parts: int, directory: str, device: str, out: dict) -> None:
    """The raw halo build of ``graph.bin`` (``DistHaloMat.from_slabs``): the
    slab ids read, and each local partition's blocks and send lists."""
    path = f"{directory}/graph.bin"
    mesh = dist.make_mesh(parts, [device] * (parts // multihost.process_count()))
    n = Dataset.load(directory, graph_mode="header").num_nodes
    m, read = n // parts, []

    def slab_of(j):
        read.append(j)
        return read_pigo_csr_slab(path, j * m, (j + 1) * m)

    mat = DistHaloMat.from_slabs(slab_of, n, mesh)
    key = f"slabs:{parts}"
    out[f"{key}/read"] = np.array(read)
    out[f"{key}/meta"] = np.array([mat.nnz, mat.halo_total, mat.halo_width, *mat.round_widths])
    for i, j in enumerate(mesh.local):
        blocks = [("loc", mat.loc[i])] + [(f"rem{s}", mat.rem[i][s]) for s in range(parts - 1)]
        for name, blk in blocks:
            for field in ("rows", "cols", "vals"):
                out[f"{key}/{j}/{name}/{field}"] = getattr(blk, field).cpu().numpy()
        for s in range(parts - 1):
            out[f"{key}/{j}/send{s}"] = mat.send_idx[i][s].cpu().numpy()


def main(argv: list[str]) -> int:
    directory, path, device, *cases = argv
    torch.set_num_threads(1)
    if "MG_GCN_COORDINATOR" in os.environ:
        multihost.initialize()
    out: dict = {}
    for case in cases:
        model, _, rest = case.partition(":")
        if model in ("slabs", "gat", "col"):
            run = {"slabs": record_slabs, "gat": run_gat_case, "col": run_col_case}[model]
            run(int(rest), directory, device, out)
        elif model.startswith("gatgrad"):
            gat_grads(case, int(rest), device, out)
        elif model == "colgrad":
            col_grads(case, int(rest), directory, device, out)
        else:
            run_case(case, directory, device, out)
    np.savez(path, **out)
    print(f"worker {multihost.process_index()} of {multihost.process_count()}: {len(cases)} cases", file=sys.stderr)
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
