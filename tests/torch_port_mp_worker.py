"""One process of the port's multi-process tests
(``tests/test_torch_port_multiprocess.py``, and on the card
``tests/test_torch_port_cuda.py``), run as

    PYTHONPATH=. python tests/torch_port_mp_worker.py <dataset dir> <out.npz> <device> <case> ...

from the repository root. With ``MG_GCN_COORDINATOR`` set it joins the run
(``multihost.initialize``); without it, it is the one-process run the others
are held against. Each case is ``<model>:<pair kind>[-<exchange>]:<P>``
(``gcn:coo:4``, ``gcn:coo-all_gather:4``, ``sage:halo:2``; the pattern pair
on the binary graph in float32, fused by default; ``slabs:<P>`` records the
halo build instead): 3 epochs of
the port's distributed step from the seed-99 parameters, on this process's
partitions, with the pair built as the CLI builds it (the halo kinds from
each process's row slabs of ``graph.bin`` and ``graph_t.bin``, features
mapped). Writes every case's losses, accuracies and final parameters (and
for ``slabs``, the slab ids read and the local blocks) to ``out.npz``. No
JAX here. :func:`launch` starts such processes (or the CLI's) for the
tests, as one run or alone, and kills every one left after its timeout."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from mg_gcn_tpu_torch import sparse
from mg_gcn_tpu_torch.formats import Dataset, read_pigo_csr_slab
from mg_gcn_tpu_torch.models import gcn, sage
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.parallel import dist, multihost
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
    out[f"{case}/losses"] = np.array(losses)
    out[f"{case}/accs"] = np.array(accs)
    for i, layer in enumerate(p[0]):
        for k, v in layer.items():
            out[f"{case}/param/{i}/{k}"] = v.detach().cpu().numpy()


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
        if case.startswith("slabs:"):
            record_slabs(int(case.split(":")[1]), directory, device, out)
        else:
            run_case(case, directory, device, out)
    np.savez(path, **out)
    print(f"worker {multihost.process_index()} of {multihost.process_count()}: {len(cases)} cases", file=sys.stderr)
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
