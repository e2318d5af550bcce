"""Dataset preparation — the reference ``test/data/prep.py`` equivalent.

Port of ``mg_gcn_tpu/data/prep.py``. Writes training directories
(graph.bin / features.bin / labels.bin / sets.bin) in the reference's binary
formats with its pipeline (prep.py:101-126): pad the node count and the
feature width to multiples of P (default 8), add self loops, build the
train/val/test set ids, optionally write a seeded random-permutation variant
under ``permuted/`` (prep.py:87-94), and report the P×P communication-volume
matrix of the uniform row partition (prep.py:232-272).

Sources:

* ``toy`` — the reference's two 4-node graphs (prep.py:155-168);
* ``synthetic`` — uniform random graphs at any scale (Reddit-shaped by
  default);
* ``reddit`` / ``cora`` / ``ogbn-*`` — through DGL/OGB where those packages
  are installed; without them the command exits with a message.

``cluster`` reorders an existing dataset by a locality order (RCM, BFS or
degree), the layout the block-sparse pattern pair skips tiles on.

Usage:
    python -m mg_gcn_tpu_torch.data.prep toy [-o DIR]
    python -m mg_gcn_tpu_torch.data.prep synthetic -n 232968 --deg 493 --feat 602 \\
        --labels 41 [-s SEED] [-P 8] [-o DIR]
    python -m mg_gcn_tpu_torch.data.prep reddit [-s SEED] [-o DIR]
    python -m mg_gcn_tpu_torch.data.prep commvolume DATA_DIR -P 4
    python -m mg_gcn_tpu_torch.data.prep cluster DATA_DIR [OUT_DIR] [--cluster rcm|bfs|degree]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import sparse as host_sparse
from ..formats import CSRData, Dataset, ensure_pigo_transpose, read_pigo_csr

TOYA = dict(
    graph=[[0, 1, 0, 1], [1, 0, 1, 0], [0, 1, 0, 1], [1, 0, 1, 0]],
    labels=[0, 1, 0, 1],
    sets=[0, 0, 1, 2],
    features=[[0, 1], [1, 0], [0, 1], [1, 0]],
)
TOYB = dict(
    graph=[[0, 1, 1, 1], [1, 1, 1, 0], [0, 1, 1, 1], [1, 1, 1, 0]],
    labels=[0, 1, 0, 1],
    sets=[0, 0, 1, 2],
    features=[[0, 1], [1, 0], [0, 1], [1, 0]],
)


def pad_graph(
    graph: CSRData,
    features: np.ndarray,
    labels: np.ndarray,
    sets: np.ndarray,
    P: int = 8,
    self_loops: bool = True,
) -> Dataset:
    """Pad nodes and the feature width to multiples of P, adding self loops
    in between (prep.py:101-126's order)."""
    n = graph.nrows
    n_pad = (n + P - 1) // P * P
    sp = graph.to_scipy()
    if n_pad != n:
        import scipy.sparse as ss

        sp = ss.csr_matrix((sp.data, sp.indices, sp.indptr), shape=(n, n))
        sp.resize((n_pad, n_pad))
        features = np.pad(features, ((0, n_pad - n), (0, 0)))
        labels = np.pad(labels.reshape(-1), (0, n_pad - n))
        # padding nodes belong to no split (3), so --mask-train leaves them out
        sets = np.pad(sets.reshape(-1), (0, n_pad - n), constant_values=3)
    g = CSRData.from_scipy(sp.tocsr())
    if self_loops:
        g = host_sparse.add_self_loops(g)
    f = features.shape[1]
    f_pad = (f + P - 1) // P * P
    if f_pad != f:
        features = np.pad(features, ((0, 0), (0, f_pad - f)))
    return Dataset(
        graph=g,
        features=features.astype(np.float32),
        labels=np.asarray(labels).reshape(-1, 1).astype(np.int32),
        sets=np.asarray(sets).reshape(-1, 1).astype(np.int32),
    )


def reorder(ds: Dataset, perm: np.ndarray) -> Dataset:
    """The dataset with node ``perm[i]`` as node i (graph, features, labels
    and sets alike)."""
    return Dataset(
        graph=host_sparse.permute_symmetric(ds.graph, perm),
        features=ds.features[perm],
        labels=ds.labels.reshape(-1)[perm].reshape(-1, 1),
        sets=ds.sets.reshape(-1)[perm].reshape(-1, 1),
    )


def permuted_variant(ds: Dataset, seed: int) -> Dataset:
    """Seeded symmetric random permutation (prep.py:87-94)."""
    return reorder(ds, np.random.default_rng(seed).permutation(ds.num_nodes))


def make_toy(out_dir: str = ".") -> list[str]:
    import scipy.sparse as ss

    written = []
    for name, spec in (("toyA", TOYA), ("toyB", TOYB)):
        ds = Dataset(
            graph=CSRData.from_scipy(ss.csr_matrix(np.asarray(spec["graph"], np.float32))),
            features=np.asarray(spec["features"], np.float32),
            labels=np.asarray(spec["labels"], np.int32).reshape(-1, 1),
            sets=np.asarray(spec["sets"], np.int32).reshape(-1, 1),
        )
        path = os.path.join(out_dir, name)
        ds.save(path)
        written.append(path)
    return written


def _save(ds: Dataset, out_dir: str, name: str, perm_seed: int) -> str:
    """Save ``ds`` (or its permuted variant under ``permuted/``) with its
    transpose beside it; returns the directory."""
    if perm_seed:
        ds = permuted_variant(ds, perm_seed)
        path = os.path.join(out_dir, "permuted", name)
    else:
        path = os.path.join(out_dir, name)
    ds.save(path)
    # the transposed orientation slab builds read; the toys go without it,
    # to keep the reference's directory layout
    ensure_pigo_transpose(path)
    return path


def make_synthetic(
    n: int,
    deg: float,
    feat: int,
    num_labels: int,
    out_dir: str,
    name: str = "synthetic",
    P: int = 8,
    seed: int = 0,
    perm_seed: int = 0,
) -> str:
    g = host_sparse.random_graph(n, deg, seed=seed, self_loops=False)
    rng = np.random.default_rng(seed + 1)
    features = rng.random((n, feat), np.float32)
    labels = rng.integers(0, num_labels, n).astype(np.int32)
    sets = rng.choice([0, 0, 0, 1, 2], n).astype(np.int32)  # ~60/20/20
    return _save(pad_graph(g, features, labels, sets, P=P), out_dir, name, perm_seed)


def make_dgl(name: str, out_dir: str, P: int = 8, perm_seed: int = 0) -> str:
    """Real datasets through DGL/OGB, where installed (prep.py:128-153)."""
    try:
        if name == "reddit":
            from dgl.data import RedditDataset

            data = RedditDataset()
        elif name == "cora":
            from dgl.data import CoraGraphDataset

            data = CoraGraphDataset()
        elif name.startswith("ogbn-"):
            from ogb.nodeproppred import DglNodePropPredDataset  # noqa: F401

            return _make_ogb(name, out_dir, P, perm_seed)
        else:
            raise SystemExit(f"unknown dataset {name!r}")
    except ImportError as e:
        raise SystemExit(f"dataset {name!r} needs dgl/ogb installed (and network access): {e}")
    g = data[0]
    feats = g.ndata["feat"].numpy()
    labels = g.ndata["label"].numpy().astype(np.int32)
    sets = np.zeros(g.number_of_nodes(), np.int32)
    sets[g.ndata["val_mask"].numpy()] = 1
    sets[g.ndata["test_mask"].numpy()] = 2
    adj = CSRData.from_scipy(g.adjacency_matrix(scipy_fmt="csr"))
    return _save(pad_graph(adj, feats, labels, sets, P=P), out_dir, name, perm_seed)


def _make_ogb(name, out_dir, P, perm_seed):
    from ogb.nodeproppred import DglNodePropPredDataset

    dataset = DglNodePropPredDataset(name)
    g, label = dataset[0]
    n = g.number_of_nodes()
    split = dataset.get_idx_split()
    # 3 = in no split (papers100M's ~109M unlabeled nodes); the reference
    # writes sets but never reads them (main.cpp:85)
    sets = np.full(n, 3, np.int32)
    sets[split["train"].numpy()] = 0
    sets[split["valid"].numpy()] = 1
    sets[split["test"].numpy()] = 2
    feats = g.ndata["feat"].numpy()
    raw = label.numpy().reshape(-1)
    unlabeled = ~np.isfinite(raw.astype(np.float64))
    labels = np.where(unlabeled, 0, raw).astype(np.int32)  # NaN -> 0, not INT_MIN
    adj = CSRData.from_scipy(g.adjacency_matrix(scipy_fmt="csr"))
    return _save(pad_graph(adj, feats, labels, sets, P=P), out_dir, name, perm_seed)


def comm_volume_report(data_dir: str, P: int) -> np.ndarray:
    """P×P communication-volume matrix of the uniform row partition
    (prep.py:232-272, its '-c' mode)."""
    g = read_pigo_csr(os.path.join(data_dir, "graph.bin"))
    part = host_sparse.uniform_partition(g.nrows, P)
    vol = host_sparse.comm_volume(g, part)
    total = vol.sum() - np.trace(vol)
    print(f"partition boundaries: {list(part)}")
    print(vol)
    print(f"off-diagonal (cross-device) volume: {total}")
    return vol


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mg_gcn_tpu_torch.data.prep")
    p.add_argument("dataset", help="toy | synthetic | reddit | cora | ogbn-* | commvolume | cluster")
    p.add_argument("args", nargs="*")
    p.add_argument("-o", "--out", default=".")
    p.add_argument("-P", type=int, default=8, help="padding/partition multiple")
    p.add_argument("-s", "--seed", type=int, default=0, help="permutation seed (0 = none)")
    p.add_argument("-n", type=int, default=232968)
    p.add_argument("--deg", type=float, default=493)
    p.add_argument("--feat", type=int, default=602)
    p.add_argument("--labels", type=int, default=41)
    p.add_argument(
        "--cluster",
        choices=["rcm", "bfs", "degree"],
        help="the locality order of the cluster command (default rcm); it lets "
        "the block-sparse pattern pair skip tiles",
    )
    opts = p.parse_args(argv)
    if opts.dataset == "cluster":
        if not opts.args:
            print("cluster requires a data dir", file=sys.stderr)
            return 2
        ds = Dataset.load(opts.args[0])
        out = reorder(ds, host_sparse.cluster_order(ds.graph, opts.cluster or "rcm"))
        dest = opts.args[1] if len(opts.args) > 1 else opts.args[0] + "_clustered"
        out.save(dest)
        print(f"wrote {dest}")
        return 0
    if opts.dataset == "toy":
        for path in make_toy(opts.out):
            print(f"wrote {path}")
    elif opts.dataset == "synthetic":
        path = make_synthetic(opts.n, opts.deg, opts.feat, opts.labels, opts.out, P=opts.P, perm_seed=opts.seed)
        print(f"wrote {path}")
    elif opts.dataset == "commvolume":
        if not opts.args:
            print("commvolume requires a data dir", file=sys.stderr)
            return 2
        comm_volume_report(opts.args[0], opts.P)
    else:
        path = make_dgl(opts.dataset, opts.out, P=opts.P, perm_seed=opts.seed)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
