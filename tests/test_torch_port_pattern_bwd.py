"""The backward pattern walk's order (``csrc/pattern_bwd.cuh``) on the CPU:
a plain twin of what the kernel computes (``spmm_pattern.bwd_groups_plain``,
``pattern_bwd_groups_plain`` and ``ring_pattern_bwd_groups_plain``) held
against a scalar walk of that order bit for bit, against the plain versions
``pattern_bwd_plain`` / ``ring_pattern_bwd_plain`` and against the JAX
package's pattern backward (``spmm_pattern``, orientation "P", in Pallas
interpret mode as tests/test_torch_port_ops.py runs it). Same numpy inputs
into both.

The twin lists each output row's set bits in (round, word, bit) order,
hands entry e to group e mod G (``spmm_pattern.pattern_bwd_split``), sums
each group's B rows in order, and meets the G partial sums by the kernel's
xor tree (groups 2i and 2i + 1 first, then pairs of pairs).

Tolerance, float32 and bfloat16: the same rounded operand on both sides,
float32 sums in another order, so rtol 1e-5 / atol 1e-6 of the output's
scale (its largest magnitude); int8 sums are exact and equal. The full row
(thousands of terms, summed in float32 one after another) is held instead
to the float32 sum-error bound of tests/test_torch_port_cuda.py,
|float32 sum - exact| <= 4 sqrt(deg + 2) 2^-24 sum|terms| against the
float64 sum of the same rounded terms (twice that between two float32
sums): its error grows with the row's length, not with its result."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_gcn_tpu.ops import spmm_pattern as jsp
from mg_gcn_tpu_torch.formats import CSRData
from mg_gcn_tpu_torch.ops import spmm_pattern as sp
from mg_gcn_tpu_torch.ops import spmm_pattern_ring as ring
from mg_gcn_tpu_torch.parallel import dist

WIDTHS = [8, 16, 41, 64, 128, 200]  # bf16 d_pad 8 (L = 1), 16, 48 and 64 (L = 8), 128 (16), 200 (32)
DTYPES = [torch.float32, torch.bfloat16, torch.int8]
RTOL, ATOL_OF_SCALE = 1e-5, 1e-6
FULL_ROW = 7


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    # the JAX pattern kernels run as tests/test_spmm_pattern.py runs them
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jsp.pl, "pallas_call", patched)


def bwd_graph(n: int, seed: int, empty_slab_edges: bool = False) -> CSRData:
    """n nodes, about 6 random columns a row, row FULL_ROW with every column
    (more set bits than a warp's list holds), rows 100..149 empty, column
    bit 31 (g*4096 + 31*128 + w) set in every tenth row and, with
    ``empty_slab_edges``, no edge from rows < 4096 into columns 4096..8191
    (an empty round of a ring partition)."""
    rng = np.random.default_rng(seed)
    cols = [np.unique(rng.integers(0, n, 6)) for _ in range(n)]
    for r in range(0, n, 10):
        g = rng.integers(0, -(-n // 4096))
        cols[r] = np.union1d(cols[r], [min(n - 1, g * 4096 + 31 * 128 + int(rng.integers(0, 128)))])
    cols[FULL_ROW] = np.arange(n)
    for r in range(100, 150):
        cols[r] = cols[r][:0]
    if empty_slab_edges:
        for r in range(min(n, 4096)):
            cols[r] = cols[r][(cols[r] < 4096) | (cols[r] >= 8192)]
    indptr = np.r_[0, np.cumsum([c.size for c in cols])].astype(np.int64)
    return CSRData(indptr, np.concatenate(cols).astype(np.int32), np.ones(indptr[-1], np.float32), (n, n))


def operand(rows: int, d_pad: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, (rows, d_pad)).astype(np.int8))
    return torch.from_numpy(rng.standard_normal((rows, d_pad)).astype(np.float32)).to(dtype)


def assert_close(got, want, exact=None, mag=None, deg=None, sums: int = 1):
    """Every row but FULL_ROW within rtol / atol of the scale; with
    ``exact`` (the float64 sum), ``mag`` (the float64 sum of |terms|) and
    ``deg`` (terms a row), FULL_ROW within ``sums`` times the float32
    sum-error bound (``sums`` float32 sums compared: 1 against ``exact``, 2
    against another float32 sum)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    rest = np.arange(got.shape[0]) != FULL_ROW
    np.testing.assert_allclose(got[rest], want[rest], rtol=RTOL, atol=ATOL_OF_SCALE * np.abs(want).max(initial=0.0))
    if exact is not None:
        bound = sums * 4.0 * np.sqrt(deg + 2.0) * 2.0**-24 * np.asarray(mag, np.float64)[FULL_ROW]
        assert (np.abs(got[FULL_ROW] - want[FULL_ROW]) <= bound).all()
        assert (np.abs(got[FULL_ROW] - np.asarray(exact, np.float64)[FULL_ROW]) <= bound).all()


def row_degree(g: CSRData) -> int:
    return int(g.indptr[FULL_ROW + 1] - g.indptr[FULL_ROW])


def scalar_walk(pack: torch.Tensor, b: torch.Tensor, rows) -> np.ndarray:
    """The kernel's order one entry at a time for output ``rows`` of a stack
    of rounds (rounds, m, m/32): float32 (int64 for int8) vector adds."""
    rounds, m, _ = pack.shape
    groups = sp.pattern_bwd_split(b.shape[1], b.dtype)["groups"]
    pk = pack.numpy().view(np.uint32)
    bb = b.to(torch.int64 if b.dtype == torch.int8 else torch.float32).numpy()
    out = []
    for i in rows:
        acc = np.zeros((groups, b.shape[1]), bb.dtype)
        e = 0
        for s in range(rounds):
            for w in np.flatnonzero(pk[s, i]):
                x = int(pk[s, i, w])
                for bit in range(32):
                    if x >> bit & 1:
                        acc[e % groups] = acc[e % groups] + bb[s * m + (w // 128) * 4096 + bit * 128 + w % 128]
                        e += 1
        off = 1
        while off < groups:
            acc = acc + acc[np.arange(groups) ^ off]
            off *= 2
        out.append(acc[0])
    return np.stack(out)


# ---------------------------------------------------------------------------
# the rule


@pytest.mark.parametrize("dtype,d_pad,features,lanes,chunks", [
    (torch.bfloat16, 8, 8, 1, 1), (torch.bfloat16, 16, 8, 2, 1), (torch.bfloat16, 48, 8, 8, 1),
    (torch.bfloat16, 64, 8, 8, 1), (torch.bfloat16, 128, 8, 16, 1), (torch.bfloat16, 256, 8, 32, 1),
    (torch.bfloat16, 264, 8, 32, 2), (torch.float32, 8, 4, 2, 1), (torch.float32, 48, 4, 16, 1),
    (torch.float32, 128, 4, 32, 1), (torch.float32, 200, 4, 32, 2), (torch.int8, 8, 8, 1, 1),
    (torch.int8, 48, 16, 4, 1), (torch.int8, 64, 16, 4, 1), (torch.int8, 128, 16, 8, 1),
    (torch.int8, 200, 8, 32, 1), (torch.int8, 520, 8, 32, 3)])
def test_split_rule(dtype, d_pad, features, lanes, chunks):
    """F is 16 bytes of the dtype (8 for an int8 row of d_pad % 16 == 8); L
    the smallest power of two >= d_pad / F, capped at 32; G = 32 / L;
    chunks of 32 F features."""
    assert sp.pattern_bwd_split(d_pad, dtype) == {"features": features, "lanes": lanes, "groups": 32 // lanes,
                                                  "chunks": chunks}


@pytest.mark.parametrize("d_pad", [0, 12, -8])
def test_split_refuses_bad_widths(d_pad):
    with pytest.raises(ValueError, match="multiple of 8"):
        sp.pattern_bwd_split(d_pad, torch.bfloat16)


# ---------------------------------------------------------------------------
# the twin against a scalar walk of the order, bit for bit


@pytest.mark.parametrize("d", [8, 41, 128, 200])
@pytest.mark.parametrize("dtype", DTYPES)
def test_twin_follows_the_scalar_walk(dtype, d):
    """Rows of partition 0 of a P = 2 ring (the rounds walked as one stream,
    an empty round) and the full row: the twin's bits are the scalar
    walk's."""
    g = bwd_graph(2 * 4096 - 100, seed=1, empty_slab_edges=True)
    pair = dist.DistPatternPair.from_binary_csr(g, dist.make_mesh(2, ["cpu"] * 2))
    pack = pair.pack_bwd[0]
    assert not bool(pack[1].any())  # round 1 of partition 0 is empty
    slots = operand(2 * pair.m_loc, sp.round_up(d, 8), dtype, seed=d).reshape(2, pair.m_loc, -1)
    got = ring.ring_pattern_bwd_groups_plain(pack, slots)
    rows = [0, 1, 2, FULL_ROW, 100, 333, 4095]
    want = scalar_walk(pack, slots.reshape(2 * pair.m_loc, -1), rows)
    np.testing.assert_array_equal(got[rows].numpy(), want.astype(got.numpy().dtype))


# ---------------------------------------------------------------------------
# the twin against the plain versions


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_twin_matches_plain(dtype, d):
    """pattern_bwd_groups_plain against pattern_bwd_plain (float: summed in
    float64; int8 equal) on an 8,192-node pack with a full row, empty rows
    (exactly zero) and bit 31 set."""
    g = bwd_graph(8000, seed=2)
    n_pad = sp.round_up(g.nrows, sp.N_ALIGN)
    pack = sp.pack_bits_on_device(g, n_pad, torch.device("cpu"))
    assert bool((pack < 0).any())
    b = operand(n_pad, sp.round_up(d, 8), dtype, seed=d)
    got = sp.pattern_bwd_groups_plain(pack, b)
    assert got.dtype == (torch.int32 if dtype == torch.int8 else torch.float32) and got.shape == b.shape
    assert not bool(got[100:150].any()) and not bool(got[g.nrows:].any())
    if dtype == torch.int8:
        assert torch.equal(got, sp.pattern_bwd_plain(pack, b))
    else:
        exact = sp.pattern_bwd_plain(pack, b, torch.float64)
        assert_close(got, exact, exact, sp.pattern_bwd_plain(pack, b.abs(), torch.float64), row_degree(g))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("parts", [1, 2, 4])
def test_ring_twin_matches_plain(parts, dtype, d):
    """ring_pattern_bwd_groups_plain against ring_pattern_bwd_plain for
    partitions 0 and P - 1 of P slabs of 4,096 rows: an empty round
    (partition 0's round 1), bit 31, a full row (P rounds of set bits) and
    100 padded rows, whose outputs are 0."""
    g = bwd_graph(parts * 4096 - 100, seed=3, empty_slab_edges=True)
    pair = dist.DistPatternPair.from_binary_csr(g, dist.make_mesh(parts, ["cpu"] * parts))
    m, d_pad = pair.m_loc, sp.round_up(d, 8)
    if parts > 1:
        assert not bool(pair.pack_bwd[0][1].any())
    assert any(bool((p < 0).any()) for p in pair.pack_bwd)
    for j in sorted({0, parts - 1}):
        slots = operand(parts * m, d_pad, dtype, seed=d + j).reshape(parts, m, d_pad)
        got = ring.ring_pattern_bwd_groups_plain(pair.pack_bwd[j], slots)
        assert got.shape == (m, d_pad)
        if dtype == torch.int8:
            assert torch.equal(got, ring.ring_pattern_bwd_plain(pair.pack_bwd[j], slots))
        else:
            exact = ring.ring_pattern_bwd_plain(pair.pack_bwd[j], slots, torch.float64)
            mag = ring.ring_pattern_bwd_plain(pair.pack_bwd[j], slots.abs(), torch.float64)
            assert_close(got, exact, exact, mag, row_degree(g))
        if j == parts - 1:
            assert not bool(got[m - 100:].any())


# ---------------------------------------------------------------------------
# the twin against the JAX package's pattern backward


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_twin_matches_jax_pattern_bwd(monkeypatch, dtype, d):
    """spmm_pattern (orientation "P": pre-scale, cast or quantize, P B) with
    the twin in the kernel's place against the JAX package's, on a
    4,000-node graph with a full row, empty rows and bit 31."""
    g = bwd_graph(4000, seed=4)
    b = np.random.default_rng(d).standard_normal((g.nrows, d)).astype(np.float32)
    _, jbwd = jsp.pattern_pair_from_binary_csr(g, dtype=dtype)
    want = np.asarray(jsp.spmm_pattern(jbwd, jnp.asarray(b)))
    monkeypatch.setattr(sp, "pattern_bwd", sp.pattern_bwd_groups_plain)
    _, bwd = sp.pattern_pair_from_binary_csr(g, dtype=dtype, device="cpu")
    got = sp.spmm_pattern(bwd, torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (g.nrows, d)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
        return
    # the float64 sums of the same rounded terms, through the same wrapper
    monkeypatch.setattr(sp, "pattern_bwd", lambda pack, x: sp.pattern_bwd_plain(pack, x, torch.float64))
    exact = sp.spmm_pattern(bwd, torch.from_numpy(b)).numpy()
    monkeypatch.setattr(sp, "pattern_bwd", lambda pack, x: sp.pattern_bwd_plain(pack, x.abs(), torch.float64))
    mag = sp.spmm_pattern(bwd, torch.from_numpy(b)).numpy()
    assert_close(got, want, exact, mag, row_degree(g), sums=2)
