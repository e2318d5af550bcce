"""The block forward's plane formulation and its float32 operand split, on
the CPU: the plain versions of what ``csrc/spmm_pattern_sparse.cu``'s
tensor-core forward computes (``block_fwd_planes_plain``,
``split_bf16x3_plain``), held against the set-bit walk ``block_fwd_plain``
and against the JAX package's ``spmm_block_pattern`` in Pallas interpret
mode. Same numpy inputs into both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.ops import spmm_pattern_sparse as jsps
from mg_gcn_tpu_torch import sparse
from mg_gcn_tpu_torch.formats import CSRData
from mg_gcn_tpu_torch.ops import spmm_pattern_sparse as sps
from mg_gcn_tpu_torch.ops.spmm_pattern import apply_pattern_calls

CPU = torch.device("cpu")
# test_torch_port_block.py's tolerances: f32 and bf16 see the same rounded
# inputs on both sides and differ only in the order of their f32 sums
TOL = {"float32": 1e-5, "bfloat16": 1e-4}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    # the JAX block kernels run as tests/test_pattern_sparse.py runs them
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(jsps.pl, "pallas_call", patched)


@pytest.fixture(scope="module")
def banded():
    """test_torch_port_block.py's banded fixture: half-width 300, 9,000 nodes."""
    return sparse.banded_graph(9000, 6, 300, seed=5)


def _dense_tile_graph():
    """8,192 nodes: rows 0..511 dense over columns 0..4095 (one tile with all
    32 planes live, bit 31 set in every word), row 600 with one edge into
    column 5000 (a tile with one live plane), and a sparse rest."""
    n = 8192
    rng = np.random.default_rng(4)
    rows = np.r_[np.repeat(np.arange(512), 4096), 600, rng.integers(1024, n, 3000)]
    cols = np.r_[np.tile(np.arange(4096), 512), 5000, rng.integers(0, n, 3000)]
    key = np.unique(rows.astype(np.int64) * n + cols)
    indptr = np.r_[0, np.cumsum(np.bincount(key // n, minlength=n))].astype(np.int64)
    return CSRData(indptr, (key % n).astype(np.int32), np.ones(key.size, np.float32), (n, n))


# ---------------------------------------------------------------------------
# the float32 split: x = hi + mid + lo, each a bfloat16


def _random_float32(seed, count=200_000):
    """Finite float32 of either sign, exponents uniform over [-100, 127],
    significands uniform over all 23 bits."""
    rng = np.random.default_rng(seed)
    exp = rng.integers(-100 + 127, 127 + 127 + 1, count).astype(np.uint32)
    bits = (rng.integers(0, 2, count).astype(np.uint32) << 31) | (exp << 23) | rng.integers(0, 1 << 23, count).astype(
        np.uint32)
    return bits.view(np.float32)


@pytest.mark.parametrize("case", ["random-0", "random-1", "full-significand", "extremes"])
def test_split_bf16x3_is_exact(case):
    if case.startswith("random"):
        x = _random_float32(int(case[-1]))
    elif case == "full-significand":  # 1 + k 2^-23 at large and small magnitudes
        k = np.arange(1, 1 << 12, dtype=np.float64)
        base = np.float32(1) + (k * 2.0**-23).astype(np.float32)
        x = np.concatenate([base, base * np.float32(2.0**90), base * np.float32(2.0**-90), -base])
    else:
        x = np.array([1 + 2**-23, 3.4028235e38, -3.4028235e38, 2.0**-100, -(2.0**-100), 0.0, 1.0, -1.5],
                     np.float32)
    assert np.isfinite(x).all()
    hi, mid, lo = sps.split_bf16x3_plain(torch.from_numpy(x))
    total = hi.double() + mid.double() + lo.double()  # each part has 8 significant bits: exact in float64
    np.testing.assert_array_equal(total.numpy(), x.astype(np.float64))
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).to(torch.float32), part)
    if case == "full-significand":
        assert bool((lo != 0).any())  # the last bits reach the third part


# ---------------------------------------------------------------------------
# the plane formulation: 0/1 planes times the tiles' B rows


@pytest.mark.parametrize("tile_r", [128, 512])
@pytest.mark.parametrize("dtype", ["float64", "int8"])
@pytest.mark.parametrize("graph", ["banded", "dense-tile"])
def test_planes_equal_the_set_bit_walk(banded, graph, dtype, tile_r):
    """Exactly block_fwd_plain: integer-valued operands sum exactly in
    float64 (and int8 in integers) in any order, so equality shows that the
    two formulations take the same terms."""
    g = banded if graph == "banded" else _dense_tile_graph()
    mat = sps.block_pattern_pair_from_binary_csr(g, device=CPU, tile_r=tile_r)[0]
    if graph == "dense-tile":
        masks = mat.pmask.numpy().view(np.uint32)
        assert (masks == 0xFFFFFFFF).any() and (np.bitwise_count(masks) == 1).any()
    b = torch.from_numpy(np.random.default_rng(tile_r).integers(-127, 128, (mat.n_pad, 24)))
    b = b.to(torch.int8 if dtype == "int8" else torch.float64)
    acc = None if dtype == "int8" else torch.float64
    got, want = sps.block_fwd_planes_plain(mat, b, acc), sps.block_fwd_plain(mat, b, acc)
    assert got.dtype == want.dtype == (torch.int32 if dtype == "int8" else torch.float64)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [8, 41, 130])
def test_planes_match_jax(banded, dtype, d):
    """The forward aggregation with the plane formulation in place of the
    kernel against the JAX package's, within test_spmm_block_pattern_matches_jax's
    tolerance (int8 equal)."""
    jfwd, _ = jsps.block_pattern_pair_from_binary_csr(JCSRData(banded.indptr, banded.indices, banded.data,
                                                               banded.shape), dtype=dtype)
    fwd, _ = sps.block_pattern_pair_from_binary_csr(banded, dtype=dtype, device=CPU)
    b = np.random.default_rng(d).standard_normal((banded.nrows, d)).astype(np.float32)
    want = np.asarray(jsps.spmm_block_pattern(jfwd, jnp.asarray(b)))
    got = apply_pattern_calls(fwd, torch.from_numpy(b), sps.block_fwd_planes_plain, sps.block_bwd_plain).numpy()
    assert got.shape == want.shape == (banded.nrows, d)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype] * np.abs(want).max())
