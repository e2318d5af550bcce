"""Port vs JAX package: host layer (formats, sparse, init, bit packing) and
the port's import boundary. Same numpy inputs into both packages."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mg_gcn_tpu import sparse as jsparse
from mg_gcn_tpu.nn import init as jinit
from mg_gcn_tpu.ops import spmm_pattern as jsp
from mg_gcn_tpu_torch import formats, sparse
from mg_gcn_tpu_torch.nn import init
from mg_gcn_tpu_torch.ops import spmm_pattern as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden")
PORT = os.path.join(REPO, "mg_gcn_tpu_torch")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def jax_numpy_sparse(monkeypatch):
    """mg_gcn_tpu.sparse on its numpy path (the port has no native path)."""
    from mg_gcn_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)
    return jsparse


def test_pigo_round_trip_is_byte_equal(tmp_path):
    src = os.path.join(GOLDEN, "graph.bin")
    g = formats.read_pigo_csr(src)
    out = tmp_path / "graph.bin"
    formats.write_pigo_csr(out, g)
    assert out.read_bytes() == open(src, "rb").read()


def test_dataset_round_trip(tmp_path):
    ds = formats.Dataset.load(GOLDEN)
    ds.save(tmp_path)
    for name in ("graph.bin", "features.bin", "labels.bin", "sets.bin"):
        assert (tmp_path / name).read_bytes() == open(os.path.join(GOLDEN, name), "rb").read()
    again = formats.Dataset.load(tmp_path)
    assert again.num_labels == ds.num_labels and again.num_features == ds.num_features


def test_read_pigo_matches_jax():
    from mg_gcn_tpu import formats as jformats

    path = os.path.join(GOLDEN, "graph.bin")
    a, b = formats.read_pigo_csr(path), jformats.read_pigo_csr(path)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.shape == b.shape


@pytest.mark.parametrize("axis", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_normalize_element_equal(jax_numpy_sparse, axis, seed):
    g = sparse.random_graph(300, 6, seed=seed, weights="random")
    np.testing.assert_array_equal(
        sparse.normalize(g, axis=axis).data, jax_numpy_sparse.normalize(g, axis=axis).data
    )


def test_transpose_element_equal(jax_numpy_sparse):
    g = sparse.normalize(sparse.random_graph(300, 6, seed=1, weights="random"), axis=True)
    a, b = sparse.transpose(g), jax_numpy_sparse.transpose(g)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.shape == b.shape


def test_random_graph_same_as_jax():
    a, b = sparse.random_graph(500, 7, seed=4), jsparse.random_graph(500, 7, seed=4)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_init_arrays_bit_equal():
    np.testing.assert_array_equal(init.minstd0_sequence(99, 1000), jinit.minstd0_sequence(99, 1000))
    for fan_in, fan_out in [(16, 16), (602, 41), (3, 7)]:
        a, b = init.kaiming_uniform_ref(fan_in, fan_out), jinit.kaiming_uniform_ref(fan_in, fan_out)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()
    assert init.bias_ref(41).tobytes() == jinit.bias_ref(41).tobytes()


def test_seeded_init_is_reproducible():
    a = init.kaiming_uniform(torch.Generator().manual_seed(5), 8, 4)
    b = init.kaiming_uniform(torch.Generator().manual_seed(5), 8, 4)
    assert torch.equal(a, b)
    bound = init.LEAKY_GAIN * np.sqrt(3.0 / 8)
    assert float(a.abs().max()) <= bound


@pytest.mark.parametrize("n,deg,seed", [(40, 4, 1), (600, 5, 2), (4100, 3, 3)])
def test_pack_csr_bits_bitwise_equal_to_jax(n, deg, seed):
    g = sparse.random_graph(n, deg, seed=seed)
    n_pad = sp.round_up(n, sp.N_ALIGN)
    mine = sp.pack_csr_bits(g, n_pad)
    assert mine.dtype == np.uint32
    np.testing.assert_array_equal(mine, jsp.pack_csr_bits(g, n_pad))
    # the device build (here on the CPU) gives the same int32 words
    dev = sp.pack_bits_on_device(g, n_pad, torch.device("cpu"))
    np.testing.assert_array_equal(dev.numpy(), mine.view(np.int32))


def test_pack_bit31_decodes():
    """A column whose bit index is 31 sets the int32 sign bit; the device
    build and the decode of the plain versions both handle it."""
    n = 4096
    cols = np.array([31 * 128, 31 * 128 + 5, 7], np.int32)  # bits 31, 31, 0
    g = formats.CSRData(
        indptr=np.array([0, 2, 3] + [3] * (n - 2), np.int64),
        indices=cols,
        data=np.ones(3, np.float32),
        shape=(n, n),
    )
    pack = sp.pack_bits_on_device(g, n, torch.device("cpu"))
    np.testing.assert_array_equal(pack.numpy(), sp.pack_csr_bits(g, n).view(np.int32))
    assert int(pack[0, 0]) < 0
    rows, got = sp.decode_pattern(pack, 0, n)
    assert sorted(zip(rows.tolist(), got.tolist())) == [(0, 31 * 128), (0, 31 * 128 + 5), (1, 7)]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)  # the same order in every test worker


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "mg_gcn_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_port_import_loads_no_jax():
    code = (
        "import sys\n"
        "import mg_gcn_tpu_torch.cli, mg_gcn_tpu_torch.train, mg_gcn_tpu_torch.convert\n"
        "import mg_gcn_tpu_torch.checkpoint, mg_gcn_tpu_torch.ops.spmm\n"
        "import mg_gcn_tpu_torch.ops.spmm_edges, mg_gcn_tpu_torch.ops.spmm_gather\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mg_gcn_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
