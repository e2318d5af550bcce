"""The SDDMM's lane-group order (``csrc/sddmm.cu``) on the CPU: its plain
twin ``sddmm.sddmm_groups_plain`` held against the JAX package's
``_sddmm_kernel`` in Pallas interpret mode (its default off the TPU, under
``jax.jit`` as ``test_torch_port_sddmm.py`` runs it) and against the port's
plain version ``sddmm_plain``. Same numpy inputs into both.

The twin computes each score as the kernel does at its width
(``sddmm.sddmm_geometry``): in each chunk c of L·F features, lane l of the
entry's group of L lanes sums its features c·L·F + l·F .. + F - 1 in order,
one float32 term at a time, the L partial sums meet by the xor tree (lanes
l and l ^ 1 first, then pairs of pairs), and the chunks' scores are added
in chunk order. A bfloat16 product is exact in float32, and an
int8 term ``f32(aq·bq)·g`` is rounded as the kernel rounds it, so in those
modes the twin gives the kernel's bits (``tests/test_torch_port_cuda.py``
holds it to them on the card).

Tolerance against JAX, as ``test_torch_port_sddmm.py``'s: the same rounded
inputs on both sides, float32 sums in another order, so 1e-5 of the
output's scale (its largest magnitude) in float32 and int8, 1e-4 in
bfloat16. Against the plain version summed in float64: the float32 sum
bound 4·sqrt(d_pad + 2)·2⁻²⁴·Σ|terms|, entry by entry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_gcn_tpu.formats import CSRData as JCSRData
from mg_gcn_tpu.ops import sddmm as jsd
from mg_gcn_tpu.ops import spmm_edges as jse
from mg_gcn_tpu_torch.formats import CSRData
from mg_gcn_tpu_torch.ops import sddmm as sd
from mg_gcn_tpu_torch.ops import spmm_edges as se
from tests.torch_port_slots import slots_to_csr_order

# every lane-group size of the rule: bf16 L = 1 (8) .. 32 (256), float32
# L = 2 .. 32, int8 8- and 16-byte loads (24 and 48)
WIDTHS = [8, 16, 24, 32, 48, 64, 128, 256]
DTYPES = ["float32", "bfloat16", "int8"]
TOL = {"float32": 1e-5, "bfloat16": 1e-4, "int8": 1e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def group_graph(n=300, seed=3, duplicates=True):
    """n nodes, up to 8 random entries a row, a hub row 7 with an entry in
    every column, empty rows 100..149 and, with ``duplicates``, every tenth
    row's first entry repeated (duplicate (row, col) entries)."""
    rng = np.random.default_rng(seed)
    cols = [np.unique(rng.integers(0, n, 8)) for _ in range(n)]
    cols[7] = np.arange(n)
    for r in range(100, 150):
        cols[r] = cols[r][:0]
    if duplicates:
        for r in range(0, n, 10):
            if cols[r].size:
                cols[r] = np.r_[cols[r][:1], cols[r]]
    indptr = np.r_[0, np.cumsum([c.size for c in cols])].astype(np.int64)
    data = (rng.random(indptr[-1]) + 0.5).astype(np.float32)
    return CSRData(indptr, np.concatenate(cols).astype(np.int32), data, (n, n))


GRAPH = group_graph()


def kernel_operands(csr, d_pad, dtype, seed):
    """(A, B, g) as the kernel takes them: float operands in ``dtype``, or
    int8 codes in [-127, 127] with a per-feature scale product g."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        a = torch.from_numpy(rng.integers(-127, 128, (csr.nrows, d_pad)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (csr.ncols, d_pad)).astype(np.int8))
        return a, b, torch.from_numpy((rng.random(d_pad) * 1e-3).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((csr.nrows, d_pad)).astype(np.float32)).to(se.DTYPES[dtype])
    b = torch.from_numpy(rng.standard_normal((csr.ncols, d_pad)).astype(np.float32)).to(se.DTYPES[dtype])
    return a, b, None


# ---------------------------------------------------------------------------
# the rule


@pytest.mark.parametrize("dtype,d_pad,lanes,features,shuffles", [
    ("bfloat16", 8, 1, 8, 0), ("bfloat16", 16, 2, 8, 4), ("bfloat16", 24, 4, 8, 6), ("bfloat16", 48, 8, 8, 7),
    ("bfloat16", 64, 8, 8, 7), ("bfloat16", 128, 16, 8, 8), ("bfloat16", 256, 32, 8, 9),
    ("bfloat16", 264, 32, 8, 9), ("float32", 8, 2, 4, 4), ("float32", 32, 8, 4, 7), ("float32", 48, 16, 4, 8),
    ("float32", 64, 16, 4, 8), ("float32", 128, 32, 4, 9), ("int8", 8, 1, 8, 0), ("int8", 16, 1, 16, 0),
    ("int8", 24, 4, 8, 6), ("int8", 40, 8, 8, 7), ("int8", 48, 4, 16, 6), ("int8", 64, 4, 16, 6),
    ("int8", 256, 16, 16, 8), ("int8", 264, 32, 8, 9), ("int8", 512, 32, 16, 9),
])
def test_geometry_rule(dtype, d_pad, lanes, features, shuffles):
    """F: 16 bytes a lane (8 for an int8 row of d_pad % 16 == 8); L: the
    smallest power of two >= d_pad / F, capped at 32; G = 32 / L; 8 entries
    a group a batch; the tree's shuffles a batch: a reduce-scatter over
    min(L, 8) lanes, then one step a doubling past 8."""
    geo = sd.sddmm_geometry(d_pad, se.DTYPES[dtype])
    assert geo == {"lanes": lanes, "groups": 32 // lanes, "entries": 8, "features": features, "shuffles": shuffles}
    assert lanes == 32 or lanes * features >= d_pad > lanes * features // 2


@pytest.mark.parametrize("d_pad", [0, 12, -8])
def test_geometry_refuses_bad_widths(d_pad):
    with pytest.raises(ValueError, match="multiple of 8"):
        sd.sddmm_geometry(d_pad, torch.bfloat16)


# ---------------------------------------------------------------------------
# the twin against the plain version, on the raw CSR (duplicates kept)


def tree_score(a_row, b_row, g, lanes, feats):
    """One score in the documented order, in numpy float32 scalars: in each
    chunk, each lane's terms in order (float32 terms as a float64 sum
    rounded once, the fused multiply-add), then the xor tree over the
    lanes; the chunks' scores added in chunk order."""
    d_pad = a_row.size
    chunk = lanes * feats
    score = None
    for c in range(0, d_pad, chunk):
        part = []
        for lane in range(lanes):
            acc = np.float32(0.0)
            for f in range(c + lane * feats, min(c + (lane + 1) * feats, d_pad)):
                x, y = np.float32(a_row[f]), np.float32(b_row[f])
                if g is not None:
                    acc = np.float32(acc + np.float32(np.float32(x * y) * np.float32(g[f])))
                else:
                    acc = np.float32(np.float64(acc) + np.float64(x) * np.float64(y))
            part.append(acc)
        off = 1
        while off < lanes:
            part = [np.float32(part[i] + part[i ^ off]) for i in range(lanes)]
            off *= 2
        score = part[0] if score is None else np.float32(score + part[0])
    return score


@pytest.mark.parametrize("d_pad", [8, 24, 64, 136, 264])
@pytest.mark.parametrize("dtype", DTYPES)
def test_twin_follows_the_documented_order(dtype, d_pad):
    """The vectorized twin gives, bit for bit, the scalar walk of its
    docstring on the hub row's entries and a duplicate pair."""
    indptr, indices = torch.from_numpy(GRAPH.indptr), torch.from_numpy(GRAPH.indices)
    a, b, g = kernel_operands(GRAPH, d_pad, dtype, seed=d_pad)
    got = sd.sddmm_groups_plain(indptr, indices, a, b, g).numpy()
    geo = sd.sddmm_geometry(d_pad, a.dtype)
    a32, b32 = a.to(torch.float32).numpy(), b.to(torch.float32).numpy()
    g32 = None if g is None else g.numpy()
    rows = np.repeat(np.arange(GRAPH.nrows), np.diff(GRAPH.indptr))
    for e in list(range(int(GRAPH.indptr[7]), int(GRAPH.indptr[7]) + 40)) + [0, 1]:
        want = tree_score(a32[rows[e]], b32[GRAPH.indices[e]], g32, geo["lanes"], geo["features"])
        assert got[e] == want, (e, got[e], want)


@pytest.mark.parametrize("d_pad", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_twin_matches_plain(dtype, d_pad):
    """The twin against sddmm_plain summed in float64 within the float32
    sum bound and against sddmm_plain in float32 within TOL of the scale,
    on the hub row, empty rows and duplicate entries (whose scores are
    equal)."""
    indptr, indices = torch.from_numpy(GRAPH.indptr), torch.from_numpy(GRAPH.indices)
    a, b, g = kernel_operands(GRAPH, d_pad, dtype, seed=d_pad)
    got = sd.sddmm_groups_plain(indptr, indices, a, b, g)
    assert got.dtype == torch.float32 and got.shape == (GRAPH.nnz,)
    exact = sd.sddmm_plain(indptr, indices, a.double(), b.double(), g)
    mag = sd.sddmm_plain(indptr, indices, a.double().abs(), b.double().abs(), g)
    assert bool(((got.double() - exact).abs() <= 4.0 * np.sqrt(d_pad + 2) * 2.0**-24 * mag).all())
    want = sd.sddmm_plain(indptr, indices, a, b, g).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype] * np.abs(want).max())
    dup = [int(GRAPH.indptr[r]) for r in range(0, GRAPH.nrows, 10) if GRAPH.indptr[r + 1] > GRAPH.indptr[r]]
    assert torch.equal(got[dup], got[[e + 1 for e in dup]])


# ---------------------------------------------------------------------------
# the twin against the JAX package's kernel


_jsddmm = jax.jit(jsd.sddmm_edge_tiles, static_argnames=("qskip", "select"))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_twin_matches_jax_sddmm_kernel(monkeypatch, dtype, d):
    """sddmm_edge_tiles with the twin in the kernel's place against the JAX
    package's (``_sddmm_kernel``) on the graph with its hub row, empty rows
    and duplicate entries (each kept, each scored), in CSR entry order."""
    rng = np.random.default_rng(d)
    a = rng.standard_normal((GRAPH.nrows, d)).astype(np.float32)
    b = rng.standard_normal((GRAPH.ncols, d)).astype(np.float32)
    jmat = jse.edge_tile_mat_from_csr(JCSRData(GRAPH.indptr, GRAPH.indices, GRAPH.data, GRAPH.shape), dtype=dtype)
    want = slots_to_csr_order(jmat, GRAPH, _jsddmm(jmat, jnp.asarray(a), jnp.asarray(b)))
    monkeypatch.setattr(sd, "sddmm", sd.sddmm_groups_plain)
    mat = se.edge_tile_mat_from_csr(GRAPH, dtype=dtype, device="cpu", merge=False)
    got = sd.sddmm_edge_tiles(mat, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype] * np.abs(want).max())
