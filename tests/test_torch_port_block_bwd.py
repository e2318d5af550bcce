"""The block store's backward (``block_bwd``, the backward pattern walk of
``csrc/pattern_bwd.cuh`` over the compact tile store) on the CPU: a plain
twin of what the kernel computes (``spmm_pattern_sparse.block_bwd_groups_plain``)
held against a scalar walk of that order bit for bit, against the plain
version ``block_bwd_plain`` and against the JAX package's
``_bwd_kernel_sparse`` (through ``spmm_block_pattern``, orientation "P", in
Pallas interpret mode as tests/test_torch_port_block.py runs it). Same
numpy inputs into both, at tile_r 128 and 512.

The twin lists each output row's set bits in (tile in ``rb_ptr`` order,
word, bit) order, hands entry e to group e mod G (``block_bwd_split``, the
pattern walk's rule), sums each group's B rows in order, and meets the G
partial sums by the kernel's xor tree; it shares that core with the pattern
walk's twins (``spmm_pattern.groups_plain``).

Tolerances are tests/test_torch_port_pattern_bwd.py's (its ``assert_close``):
float32 and bfloat16 rtol 1e-5 / atol 1e-6 of the output's scale, the same
rounded operand on both sides summed in float32 in another order; int8
exact; the full row (every column of the graph, summed in float32 one term
after another) within the float32 sum-error bound 4 sqrt(deg + 2) 2^-24
sum|terms| of the float64 sum of the same rounded terms."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.ops import spmm_pattern_sparse as jsps
from mg_gcn_tpu_torch.formats import CSRData
from mg_gcn_tpu_torch.ops import spmm_pattern as sp
from mg_gcn_tpu_torch.ops import spmm_pattern_sparse as sps
from test_torch_port_pattern_bwd import FULL_ROW, assert_close, operand

WIDTHS = [8, 16, 41, 64, 128, 200]  # bf16 d_pad 8 (L = 1), 16 (2), 48 and 64 (8), 128 (16), 200 (32)
DTYPES = [torch.float32, torch.bfloat16, torch.int8]
TILE_RS = [128, 512]
N = 12_288  # three 4096-column groups
EMPTY_RB = slice(4096, 4608)  # a row block of 512 (four of 128) with no tile
SPLIT_ROWS = slice(9500, 9600)  # their row blocks' tiles lie in groups 0 and 2 only
EMPTY_ROWS = slice(200, 250)


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


def block_graph(seed: int = 1) -> CSRData:
    """N nodes, clustered as a block store wants them: about 6 columns a row
    within ±600 of the diagonal, bit 31 (column g*4096 + 31*128 + w of the
    row's own group g) in every tenth row, row FULL_ROW with every column
    (more set bits than a warp's list holds, over three tiles), rows
    EMPTY_ROWS and the row block EMPTY_RB empty, and SPLIT_ROWS with columns
    in group 0 as well, so their row blocks' tiles are groups 0 and 2."""
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(N):
        c = np.unique(np.clip(i + rng.integers(-600, 601, 6), 0, N - 1))
        if i % 10 == 0:
            c = np.union1d(c, [(i // 4096) * 4096 + 31 * 128 + i % 128])
        if SPLIT_ROWS.start <= i < SPLIT_ROWS.stop:
            c = np.union1d(c, rng.integers(0, 4096, 3))
        cols.append(c)
    cols[FULL_ROW] = np.arange(N)
    for r in [*range(EMPTY_ROWS.start, EMPTY_ROWS.stop), *range(EMPTY_RB.start, EMPTY_RB.stop)]:
        cols[r] = cols[r][:0]
    indptr = np.r_[0, np.cumsum([c.size for c in cols])].astype(np.int64)
    return CSRData(indptr, np.concatenate(cols).astype(np.int32), np.ones(indptr[-1], np.float32), (N, N))


@pytest.fixture(scope="module")
def graph():
    return block_graph()


@pytest.fixture(scope="module")
def stores(graph):
    """The backward matrix at each tile_r, its store built on the host."""
    return {tile_r: sps.block_pattern_pair_from_binary_csr(graph, dtype="float32", tile_r=tile_r, device="cpu",
                                                           build_on_device=False)[1] for tile_r in TILE_RS}


def scalar_walk(mat: sps.BlockPatternMat, b: torch.Tensor, rows) -> np.ndarray:
    """The kernel's order one entry at a time for output ``rows``: row r of
    each tile of the row's row block in rb_ptr order, its words, their bits;
    float32 (int64 for int8) vector adds into G groups, then the xor tree."""
    groups = sps.block_bwd_split(b.shape[1], b.dtype)["groups"]
    tiles = mat.tiles.numpy().view(np.uint32)
    rb_ptr, tile_g = mat.rb_ptr.tolist(), mat.tile_g.tolist()
    bb = b.to(torch.int64 if b.dtype == torch.int8 else torch.float32).numpy()
    out = []
    for i in rows:
        rb, r = divmod(i, mat.tile_r)
        acc = np.zeros((groups, b.shape[1]), bb.dtype)
        e = 0
        for t in range(rb_ptr[rb], rb_ptr[rb + 1]):
            for w in np.flatnonzero(tiles[t, r]):
                x = int(tiles[t, r, w])
                for bit in range(32):
                    if x >> bit & 1:
                        acc[e % groups] = acc[e % groups] + bb[tile_g[t] * 4096 + bit * 128 + w]
                        e += 1
        off = 1
        while off < groups:
            acc = acc + acc[np.arange(groups) ^ off]
            off *= 2
        out.append(acc[0])
    return np.stack(out)


def test_the_store_has_the_cases(stores):
    """The graph gives the kernel what it must walk: a row block with no
    tile, a row block whose tiles lie in non-adjacent groups, bit 31, and a
    full row over every tile of its row block."""
    for tile_r, mat in stores.items():
        rb_ptr, tile_g = mat.rb_ptr.tolist(), mat.tile_g.tolist()
        assert rb_ptr[EMPTY_RB.start // tile_r] == rb_ptr[EMPTY_RB.start // tile_r + 1]
        split = SPLIT_ROWS.start // tile_r
        assert tile_g[rb_ptr[split]:rb_ptr[split + 1]] == [0, 2], tile_r
        assert tile_g[rb_ptr[0]:rb_ptr[1]] == [0, 1, 2]
        assert bool((mat.tiles < 0).any())
        assert bool((mat.tiles[:3, FULL_ROW] == -1).all())


def test_split_is_the_pattern_walks():
    """block_bwd shares the backward pattern walk's rule, not a copy of it."""
    assert sps.block_bwd_split is sp.pattern_bwd_split


# ---------------------------------------------------------------------------
# the twin against a scalar walk of the order, bit for bit


@pytest.mark.parametrize("d", [8, 41, 128, 200])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile_r", TILE_RS)
def test_twin_follows_the_scalar_walk(stores, tile_r, dtype, d):
    """Rows of three-tile, two-tile (non-adjacent groups) and one-tile row
    blocks, an empty row, a row of the empty row block, the full row and the
    last row: the twin's bits are the scalar walk's."""
    mat = stores[tile_r]
    b = operand(mat.n_pad, sp.round_up(d, 8), dtype, seed=d)
    got = sps.block_bwd_groups_plain(mat, b)
    rows = [0, 1, FULL_ROW, EMPTY_ROWS.start, EMPTY_RB.start + 3, SPLIT_ROWS.start, 6000, N - 1]
    want = scalar_walk(mat, b, rows)
    np.testing.assert_array_equal(got[rows].numpy(), want.astype(got.numpy().dtype))


# ---------------------------------------------------------------------------
# the twin against the plain version


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile_r", TILE_RS)
def test_twin_matches_plain(stores, graph, tile_r, dtype, d):
    """block_bwd_groups_plain against block_bwd_plain (float: summed in
    float64; int8 equal); empty rows and the empty row block exactly 0."""
    mat = stores[tile_r]
    b = operand(mat.n_pad, sp.round_up(d, 8), dtype, seed=d)
    got = sps.block_bwd_groups_plain(mat, b)
    assert got.dtype == (torch.int32 if dtype == torch.int8 else torch.float32) and got.shape == b.shape
    assert not bool(got[EMPTY_ROWS].any()) and not bool(got[EMPTY_RB].any())
    if dtype == torch.int8:
        assert torch.equal(got, sps.block_bwd_plain(mat, b))
    else:
        exact = sps.block_bwd_plain(mat, b, torch.float64)
        deg = int(graph.indptr[FULL_ROW + 1] - graph.indptr[FULL_ROW])
        assert_close(got, exact, exact, sps.block_bwd_plain(mat, b.abs(), torch.float64), deg)


# ---------------------------------------------------------------------------
# the twin against the JAX package's _bwd_kernel_sparse


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("tile_r", TILE_RS)
def test_twin_matches_jax_bwd_kernel_sparse(monkeypatch, graph, tile_r, dtype, d):
    """spmm_block_pattern (orientation "P": pre-scale, cast or quantize,
    P B) with the twin in block_bwd's place against the JAX package's, whose
    P B is _bwd_kernel_sparse in interpret mode."""
    b = np.random.default_rng(d).standard_normal((graph.nrows, d)).astype(np.float32)
    jcsr = JCSRData(graph.indptr, graph.indices, graph.data, graph.shape)
    _, jbwd = jsps.block_pattern_pair_from_binary_csr(jcsr, dtype=dtype, tile_r=tile_r)
    want = np.asarray(jsps.spmm_block_pattern(jbwd, jnp.asarray(b)))
    _, bwd = sps.block_pattern_pair_from_binary_csr(graph, dtype=dtype, tile_r=tile_r, device="cpu")
    monkeypatch.setattr(sps, "block_bwd", sps.block_bwd_groups_plain)
    got = sps.spmm_block_pattern(bwd, torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (graph.nrows, d)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
        return
    # the float64 sums of the same rounded terms, through the same wrapper
    monkeypatch.setattr(sps, "block_bwd", lambda mat, x: sps.block_bwd_plain(mat, x, torch.float64))
    exact = sps.spmm_block_pattern(bwd, torch.from_numpy(b)).numpy()
    monkeypatch.setattr(sps, "block_bwd", lambda mat, x: sps.block_bwd_plain(mat, x.abs(), torch.float64))
    mag = sps.spmm_block_pattern(bwd, torch.from_numpy(b)).numpy()
    deg = int(graph.indptr[FULL_ROW + 1] - graph.indptr[FULL_ROW])
    assert_close(got, want, exact, mag, deg, sums=2)
