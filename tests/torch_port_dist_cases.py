"""Shared pieces of the port's row-partition tests against the JAX package
(``tests/test_torch_port_dist_halo.py``, ``_dist_gather.py``,
``_dist_sage.py``): small problems made from numpy seeds, the JAX steps on
the CPU mesh (parameters placed replicated, so a step compiles once) and the
port's steps on P CPU partitions."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec

from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.nn import adam as jadam
from mg_gcn_tpu_torch import convert, sparse
from mg_gcn_tpu_torch.formats import CSRData
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.parallel import dist


def jcsr(g: CSRData) -> JCSRData:
    return JCSRData(g.indptr, g.indices, g.data, g.shape)


def cpu_ring(parts: int) -> dist.Ring:
    return dist.make_mesh(parts, ["cpu"] * parts)


def np_tree(tree) -> list[dict]:
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in tree]


def weighted_graph(n: int, deg: int, seed: int) -> CSRData:
    """A non-symmetric weighted graph: uniform random edges, weights in
    [0.5, 1.5)."""
    g = sparse.random_graph(n, deg, seed=seed, weights="random")
    assert (g.to_scipy() != g.to_scipy().T).nnz, "the test graph must not be symmetric"
    return g


def banded_weighted(n: int, parts: int, seed: int) -> CSRData:
    """A banded graph whose band (± n / (4 P)) reaches only the neighbouring
    row slabs: at P >= 4 some halo rounds are empty on every partition."""
    g = sparse.banded_graph(n, 6, n // (4 * parts), seed)
    return CSRData(g.indptr, g.indices, np.random.default_rng(seed).random(g.nnz, np.float32) + 0.5, g.shape)


def features(n: int, f: int, c: int, seed: int, mask: bool = False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    train = rng.random(n) < 0.6 if mask else None
    return x, y, train


def jax_steps(step, mesh, params, jpair, x, y, train, steps: int) -> list:
    """``steps`` calls of a JAX dist step from ``params``: [(params, loss,
    acc)] as numpy."""
    rep = NamedSharding(mesh, PartitionSpec())
    params = jax.device_put(params, rep)
    opt = jax.device_put(jadam.adam_init(params), rep)
    args = (jnp.asarray(x), jnp.asarray(y)) + (() if train is None else (jnp.asarray(train),))
    out = []
    for _ in range(steps):
        params, opt, loss, acc = step(params, opt, jpair, *args)
        out.append((np_tree(params), float(loss), float(acc)))
    return out


def port_steps(step, ring, params_np, pair, x, y, train, steps: int) -> list:
    """``steps`` calls of the port's dist step from the numpy parameters
    ``params_np`` on the CPU partitions of ``ring``: [(params, loss, acc)]."""
    params = convert.params_from_numpy(params_np, "cpu")
    params, opt = dist.replicate(params, ring), dist.replicate(adam.adam_init(params), ring)
    xs, ys = dist.shard(x, ring), dist.shard(y.astype(np.int64), ring)
    masks = None if train is None else dist.shard(train, ring)
    out = []
    for _ in range(steps):
        params, opt, loss, acc = step(params, opt, pair, xs, ys, masks)
        out.append((convert.params_to_numpy(params[0]), float(loss), float(acc)))
    return out


def assert_steps_close(got: list, want: list, n: int, rtol: float, atol: float) -> None:
    """Every step's loss within ``rtol`` and accuracy within one node; the
    last parameters within (``rtol``, ``atol``)."""
    for (_, loss, acc), (_, jloss, jacc) in zip(got, want, strict=True):
        np.testing.assert_allclose(loss, jloss, rtol=rtol)
        assert abs(acc - jacc) * n <= 1.0 + 1e-6
    for layer, jlayer in zip(got[-1][0], want[-1][0], strict=True):
        for k in jlayer:
            np.testing.assert_allclose(layer[k], jlayer[k], rtol=rtol, atol=atol, err_msg=k)


def expand_rows(indptr: torch.Tensor) -> np.ndarray:
    """Per-entry row ids of a CSR block's indptr."""
    counts = indptr.diff()
    return torch.repeat_interleave(torch.arange(counts.numel()), counts).numpy()
