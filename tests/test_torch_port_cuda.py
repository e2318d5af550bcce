"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from mg_gcn_tpu_torch import sparse
from mg_gcn_tpu_torch.formats import CSRData, Dataset
from mg_gcn_tpu_torch.ops import edge_softmax as esm
from mg_gcn_tpu_torch.ops import sddmm as sd
from mg_gcn_tpu_torch.ops import spmm_edges as se
from mg_gcn_tpu_torch.ops import spmm_gather as sg
from mg_gcn_tpu_torch.ops import spmm_pallas as tpl
from mg_gcn_tpu_torch.ops import spmm_pattern as sp
from mg_gcn_tpu_torch.ops import spmm_pattern_ring as ring
from mg_gcn_tpu_torch.ops import spmm_pattern_sparse as sps
from mg_gcn_tpu_torch.parallel import dist
from mg_gcn_tpu_torch.train import build_agg_pair, make_train_step, train

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden")
pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graph():
    return sparse.random_graph(5000, 16, seed=4)


def _operand(n_pad, d_pad, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-127, 128, (n_pad, d_pad), device="cuda", generator=gen).to(torch.int8)
    return torch.randn((n_pad, d_pad), device="cuda", generator=gen).to(dtype)


def _assert_within_sum_error(got, exact, mag, deg):
    """|float32 kernel - exact| <= 4 sqrt(deg + 2) u sum|terms| (u = 2^-24),
    element by element: ``exact`` and ``mag`` (the sum of |terms|) are
    float64 sums of the same rounded terms. The rounding errors of a
    float32 sum of deg terms in any order grow as sqrt(deg), not deg, so
    the bound stays tight on long rows: at 4,096 terms of unit scale it is
    about 0.05 of one term, and a dropped or doubled term fails it."""
    assert bool(((got.double() - exact).abs() <= 4.0 * (deg + 2).sqrt() * 2.0**-24 * mag).all())


def _assert_matches_plain(got, want, dtype):
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        # same rounded inputs on both sides; only the f32 sum order differs
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("d_pad", [8, 48, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_kernel_matches_plain(graph, which, dtype, d_pad):
    n_pad = sp.round_up(graph.nrows, sp.N_ALIGN)
    pack = sp.pack_bits_on_device(graph, n_pad, torch.device("cuda"))
    b = _operand(n_pad, d_pad, dtype, seed=d_pad)
    kernel, plain = (sp.pattern_fwd, sp.pattern_fwd_plain) if which == "fwd" else (sp.pattern_bwd, sp.pattern_bwd_plain)
    before = kernel.launches[(str(dtype).removeprefix("torch."), d_pad)]
    got = kernel(pack, b)
    torch.cuda.synchronize()
    assert kernel.launches[(str(dtype).removeprefix("torch."), d_pad)] == before + 1
    assert got.dtype == (torch.int32 if dtype == torch.int8 else torch.float32)
    _assert_matches_plain(got, plain(pack, b), dtype)


def test_kernels_decode_bit31_and_dense_rows():
    """Columns whose bit index is 31 (the int32 sign bit) and a fully dense
    row and column."""
    n = 4096
    rng = np.random.default_rng(0)
    cols = [np.arange(n)] + [np.unique(np.r_[rng.integers(0, n, 40), 31 * 128 + np.arange(0, 128, 3)])
                             for _ in range(n - 1)]
    cols = [np.unique(np.r_[c, 0]) for c in cols]  # column 0 is dense
    indptr = np.r_[0, np.cumsum([len(c) for c in cols])]
    g = CSRData(indptr, np.concatenate(cols).astype(np.int32), np.ones(indptr[-1], np.float32), (n, n))
    pack = sp.pack_bits_on_device(g, n, torch.device("cuda"))
    assert torch.equal(pack.cpu(), torch.from_numpy(sp.pack_csr_bits(g, n).view(np.int32)))
    b = _operand(n, 16, torch.int8, seed=1)
    _assert_matches_plain(sp.pattern_fwd(pack, b), sp.pattern_fwd_plain(pack, b), torch.int8)
    _assert_matches_plain(sp.pattern_bwd(pack, b), sp.pattern_bwd_plain(pack, b), torch.int8)
    # a dense row sums 4,096 terms: hold float32 against float64 sums of the
    # same terms (the float32 plain version's CUDA index_add_ sums in an
    # order that changes from run to run)
    b = _operand(n, 16, torch.float32, seed=1)
    rows, cols = sp.decode_pattern(pack, 0, n)
    for got, dst, src in ((sp.pattern_fwd(pack, b), cols, rows), (sp.pattern_bwd(pack, b), rows, cols)):
        zero = torch.zeros((n, 16), dtype=torch.float64, device="cuda")
        exact = zero.clone().index_add_(0, dst, b.double().index_select(0, src))
        mag = zero.index_add_(0, dst, b.double().abs().index_select(0, src))
        _assert_within_sum_error(got, exact, mag, torch.bincount(dst, minlength=n).double()[:, None])


def test_wrappers_reject_bad_operands(graph):
    n_pad = sp.round_up(graph.nrows, sp.N_ALIGN)
    pack = sp.pack_bits_on_device(graph, n_pad, torch.device("cuda"))
    with pytest.raises(ValueError, match="d_pad % 8"):
        sp.pattern_fwd(pack, torch.zeros((n_pad, 12), device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        sp.pattern_bwd(pack, torch.zeros((16, n_pad), device="cuda").T)
    with pytest.raises(ValueError, match="float32/bfloat16/int8"):
        sp.pattern_bwd(pack, torch.zeros((n_pad, 16), device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError, match="one CUDA device"):
        sp.pattern_fwd(pack.cpu(), torch.zeros((n_pad, 16), device="cuda"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_spmm_pattern_on_card_matches_cpu(dtype):
    g = sparse.random_graph(600, 5, seed=2)
    b = torch.from_numpy(np.random.default_rng(3).random((600, 41)).astype(np.float32))
    for i in range(2):  # forward (Pᵀ, post-scale) and backward (P, pre-scale)
        mat_gpu = sp.pattern_pair_from_binary_csr(g, dtype=dtype, device="cuda")[i]
        mat_cpu = sp.pattern_pair_from_binary_csr(g, dtype=dtype, device="cpu")[i]
        got = sp.spmm_pattern(mat_gpu, b.cuda()).cpu()
        want = sp.spmm_pattern(mat_cpu, b)
        if dtype == "int8":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_train_on_card_matches_cpu():
    ds = Dataset.load(GOLDEN)
    # the golden graph's 256 nodes fill one of 8 row blocks, so impl="auto"
    # takes the block pair there (JAX's rule); the pattern pair is asked for
    gpu = train(ds, [16, 16], epochs=5, impl="pattern", pattern_dtype="float32", device="cuda", log=False)
    cpu = train(ds, [16, 16], epochs=5, impl="pattern", pattern_dtype="float32", device="cpu", log=False)
    assert gpu.engine == "pattern"
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-5)


# ---------------------------------------------------------------------------
# the CSR kernels of the edge and gather engines


@pytest.fixture(scope="module")
def hub_graph():
    """random_graph(5000, 16) with uniform weights, a hub row (7) of degree
    5,000 and empty rows 100..199."""
    g = sparse.random_graph(5000, 16, seed=4, weights="uniform")
    rows = [g.indices[g.indptr[r] : g.indptr[r + 1]] for r in range(g.nrows)]
    rows[7] = np.arange(5000, dtype=np.int32)
    for r in range(100, 200):
        rows[r] = rows[r][:0]
    indptr = np.r_[0, np.cumsum([len(c) for c in rows])].astype(np.int64)
    data = np.random.default_rng(1).random(indptr[-1], np.float32) + 0.5
    return CSRData(indptr, np.concatenate(rows).astype(np.int32), data, g.shape)


def _csr_on_card(g):
    return torch.from_numpy(g.indptr).cuda(), torch.from_numpy(g.indices).cuda()


def _assert_within_sum_bound(got, indptr, indices, w, b):
    """The kernel within :func:`_assert_within_sum_error` of the plain
    version run in float64 on the same rounded inputs; empty rows exactly
    zero."""
    exact = se.csr_plain(indptr, indices, w, b, torch.float64)
    mag = se.csr_plain(indptr, indices, None if w is None else w.abs(), b.abs(), torch.float64)
    _assert_within_sum_error(got, exact, mag, indptr.diff().to(torch.float64)[:, None])
    assert not bool(got[100:200].any())


@pytest.mark.parametrize("d_pad", [8, 16, 48, 128, 256, 264])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_edge_kernels_match_plain(hub_graph, dtype, d_pad):
    """Every group size of the walk (d_pad 8: 16 groups of 2 lanes; 16: 8 of
    4; 48: 2 of 16; >= 128: one warp) on the hub row and empty rows, within
    the float32 sum bound of the float64 plain version (int8 equal); two
    launches give the same bits."""
    indptr, indices = _csr_on_card(hub_graph)
    b = _operand(hub_graph.ncols, d_pad, dtype, seed=d_pad)
    if dtype == torch.int8:
        w = torch.from_numpy(np.random.default_rng(2).integers(-127, 128, hub_graph.nnz).astype(np.int8)).cuda()
        kernel, key = se.edge_i8, ("int8", d_pad)
    else:
        w = torch.from_numpy(hub_graph.data).cuda().to(dtype)
        kernel, key = se.edge, (str(dtype).removeprefix("torch."), d_pad)
    before = kernel.launches[key]
    got = kernel(indptr, indices, w, b)
    again = kernel(indptr, indices, w, b)
    torch.cuda.synchronize()
    assert kernel.launches[key] == before + 2
    assert torch.equal(got, again)
    if dtype == torch.int8:
        assert got.dtype == torch.int32
        assert torch.equal(got, se.edge_i8_plain(indptr, indices, w, b))
    else:
        assert got.dtype == torch.float32
        _assert_within_sum_bound(got, indptr, indices, w, b)


@pytest.mark.parametrize("d_pad", [8, 16, 48, 104, 256, 264])
@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [True, False])
def test_gather_kernel_matches_plain(hub_graph, weighted, b_dtype, d_pad):
    """As test_edge_kernels_match_plain, binary and weighted."""
    indptr, indices = _csr_on_card(hub_graph)
    w = torch.from_numpy(hub_graph.data).cuda() if weighted else None
    b = _operand(hub_graph.ncols, d_pad, b_dtype, seed=d_pad)
    key = (str(b_dtype).removeprefix("torch."), d_pad)
    before = sg.gather.launches[key]
    got = sg.gather(indptr, indices, w, b)
    again = sg.gather(indptr, indices, w, b)
    torch.cuda.synchronize()
    assert sg.gather.launches[key] == before + 2
    assert torch.equal(got, again)
    _assert_within_sum_bound(got, indptr, indices, w, b)


@pytest.mark.parametrize("d_pad", [8, 16, 24, 48, 64, 128, 256])
def test_csr_walk_geometry_on_card(d_pad):
    """Each CSR kernel's launch geometry from the card: L and G by the
    rule of spmm_edges.csr_walk_geometry, a warp a row in blocks of 8, at
    least 24 warps resident an SM (3 blocks: the widest walks take 71
    registers a thread)."""
    n = 232_968
    rule = se.csr_walk_geometry(d_pad)
    for geo in (se.edge_geometry("edge", n, d_pad, torch.bfloat16), se.edge_geometry("edge", n, d_pad, torch.float32),
                se.edge_geometry("edge_i8", n, d_pad, torch.int8), se.edge_geometry("edge_t", n, d_pad, torch.bfloat16),
                sg.gather_geometry(n, d_pad, torch.float32, False), sg.gather_geometry(n, d_pad, torch.bfloat16, True)):
        assert {k: geo[k] for k in rule} == rule, geo
        assert geo["grid_x"] == -(-n // 8) and geo["threads"] == 256 and geo["blocks_per_sm"] >= 3, geo


def test_csr_kernels_write_zeros_for_an_empty_matrix():
    indptr = torch.zeros(301, dtype=torch.int64, device="cuda")
    indices = torch.zeros(0, dtype=torch.int32, device="cuda")
    b = _operand(200, 16, torch.float32, seed=0)
    for got in (
        se.edge(indptr, indices, torch.zeros(0, device="cuda"), b),
        se.edge_i8(indptr, indices, torch.zeros(0, dtype=torch.int8, device="cuda"), b.to(torch.int8)),
        sg.gather(indptr, indices, None, b),
    ):
        torch.cuda.synchronize()
        assert got.shape == (300, 16) and not bool(got.any())


def test_csr_wrappers_reject_bad_operands(hub_graph):
    indptr, indices = _csr_on_card(hub_graph)
    w = torch.from_numpy(hub_graph.data).cuda()
    b = torch.zeros((hub_graph.ncols, 16), device="cuda")
    with pytest.raises(ValueError, match="d_pad % 8"):
        se.edge(indptr, indices, w, torch.zeros((hub_graph.ncols, 12), device="cuda"))
    with pytest.raises(ValueError, match="compute dtype"):
        se.edge(indptr, indices, w.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="int64"):
        sg.gather(indptr.int(), indices, w, b)
    with pytest.raises(ValueError, match="one CUDA device"):
        sg.gather(indptr.cpu(), indices, w, b)
    with pytest.raises(ValueError, match="contiguous"):
        sg.gather(indptr, indices, None, torch.zeros((16, hub_graph.ncols), device="cuda").T)


@pytest.mark.parametrize("engine", ["float32", "bfloat16", "int8", "gather", "gather-stream"])
def test_spmm_on_card_matches_cpu(hub_graph, engine):
    b = torch.from_numpy(np.random.default_rng(3).standard_normal((hub_graph.ncols, 41)).astype(np.float32))
    if engine.startswith("gather"):
        kw = dict(stream_bf16=engine.endswith("stream"))
        got = sg.spmm_gather(sg.gather_mat_from_csr(hub_graph, device="cuda", **kw), b.cuda()).cpu()
        want = sg.spmm_gather(sg.gather_mat_from_csr(hub_graph, device="cpu", **kw), b)
    else:
        got = se.spmm_edge_tiles(se.edge_tile_mat_from_csr(hub_graph, dtype=engine, device="cuda"), b.cuda()).cpu()
        want = se.spmm_edge_tiles(se.edge_tile_mat_from_csr(hub_graph, dtype=engine, device="cpu"), b)
    if engine == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("impl", ["edge", "gather"])
def test_train_on_card_matches_cpu_o_nnz_engines(impl):
    ds = Dataset.load(GOLDEN)
    gpu = train(ds, [16, 16], epochs=5, impl=impl, pattern_dtype="float32", device="cuda", log=False)
    cpu = train(ds, [16, 16], epochs=5, impl=impl, pattern_dtype="float32", device="cpu", log=False)
    assert gpu.engine == cpu.engine == impl
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-5)


def test_auto_picks_edge_for_a_weighted_graph():
    g = sparse.random_graph(3000, 20, seed=1, weights="uniform")
    assert isinstance(build_agg_pair(g, impl="auto", device="cuda").fwd, se.EdgeTileMat)


def test_auto_takes_the_binary_csr_walk_on_a_uniform_graph():
    """A uniform binary graph (n = 50,000, 20 draws a row): its 354 MB pack
    fits the card, but about 1 bit in 2,600 is set, far below
    WALK_DENSITY_MAX, so auto takes the binary gather pair, streaming
    bfloat16. One GCN parity step at the
    benchmark's sizes (608, 128, 128, 128, 41) launches only ``gather``
    bfloat16: 3 forward and 2 backward products at d_pad 128, 1 and 1 at 48,
    and no pattern kernel. Its loss is within rtol 1e-5 and every gradient
    leaf within ||walk - pattern|| <= 1e-4 ||pattern|| of the same step on
    the pattern pair."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params, loss_and_grad

    n = 50_000
    g = sparse.random_graph(n, 20, seed=6)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((n, 608)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 41, n)).cuda()
    config = GCNConfig(sizes=(608, 128, 128, 128, 41))
    params = init_params(config, device="cuda")
    walk = build_agg_pair(g, impl="auto", pattern_dtype="bfloat16", device="cuda")
    assert isinstance(walk.fwd, sg.GatherMat) and walk.fwd.stream_bf16 and walk.bwd.stream_bf16
    for kernel in (sg.gather, sp.pattern_fwd, sp.pattern_bwd):
        kernel.launches.clear()
    loss_w, _, grads_w = loss_and_grad(params, walk, x, y, config)
    torch.cuda.synchronize()
    assert dict(sg.gather.launches) == {("bfloat16", 128): 5, ("bfloat16", 48): 2}
    assert not sum(sp.pattern_fwd.launches.values()) and not sum(sp.pattern_bwd.launches.values())
    del walk
    pack = build_agg_pair(g, impl="pattern", pattern_dtype="bfloat16", device="cuda")
    loss_p, _, grads_p = loss_and_grad(params, pack, x, y, config)
    np.testing.assert_allclose(float(loss_w), float(loss_p), rtol=1e-5)
    for layer_p, layer_w in zip(grads_p, grads_w):
        for k in layer_p:
            diff = torch.linalg.vector_norm(layer_w[k] - layer_p[k])
            assert diff <= 1e-4 * torch.linalg.vector_norm(layer_p[k]), k


# ---------------------------------------------------------------------------
# the attention kernels: sddmm, sddmm_qskip and edge_t


def _dense_operand(n, d, d_pad, dtype, seed):
    """(n, d_pad) operand with d live features and zero padding."""
    out = _operand(n, d_pad, dtype, seed)
    out[:, d:] = 0
    return out


# every lane-group size of the SDDMM's rule in each dtype (sd.sddmm_geometry):
# bf16 L = 1 (d_pad 8) .. 32 (256, and 264 in two chunks), float32 2 .. 32
# (264: three chunks), int8 8- and 16-byte loads, L = 1 .. 32 (264)
SDDMM_WIDTHS = [1, 2, 16, 24, 32, 41, 48, 64, 128, 256, 264]


def _sddmm_operands(g, d, dtype):
    d_pad = max(8, -(-d // 8) * 8)
    a = _dense_operand(g.nrows, d, d_pad, dtype, seed=d)
    b = _dense_operand(g.ncols, d, d_pad, dtype, seed=d + 1)
    gs = None
    if dtype == torch.int8:
        gs = torch.zeros(d_pad, device="cuda")
        gs[:d] = torch.rand(d, device="cuda", generator=torch.Generator(device="cuda").manual_seed(d)) * 1e-3
    return a, b, gs


@pytest.mark.parametrize("d", SDDMM_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_sddmm_kernels_match_plain(hub_graph, dtype, d):
    """Every score within the float32 sum bound of the plain version in
    float64 on the same rounded inputs (a degree-5,000 hub row, empty rows
    100..199), at every group size of the rule; two launches give the same
    bits, and the q-range kernel is bitwise equal to the default."""
    indptr, indices = _csr_on_card(hub_graph)
    a, b, g = _sddmm_operands(hub_graph, d, dtype)
    key = (str(dtype).removeprefix("torch."), a.shape[1])
    before = sd.sddmm.launches[key], sd.sddmm_qskip.launches[key]
    got = sd.sddmm(indptr, indices, a, b, g)
    again = sd.sddmm(indptr, indices, a, b, g)
    live = torch.nonzero(indptr.diff() > 0).flatten().int()
    skip = sd.sddmm_qskip(indptr, indices, live, a, b, g)
    torch.cuda.synchronize()
    assert (sd.sddmm.launches[key], sd.sddmm_qskip.launches[key]) == (before[0] + 2, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (hub_graph.nnz,)
    assert torch.equal(again, got)
    assert torch.equal(skip, got)
    exact = sd.sddmm_plain(indptr, indices, a.double(), b.double(), g)
    mag = sd.sddmm_plain(indptr, indices, a.double().abs(), b.double().abs(), g)
    _assert_within_sum_error(got, exact, mag, torch.tensor(float(a.shape[1]), dtype=torch.float64))


@pytest.mark.parametrize("d", SDDMM_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_sddmm_kernel_follows_the_group_order(hub_graph, dtype, d):
    """The kernel sums in the order of sd.sddmm_groups_plain (in each chunk
    each lane's features in order, then the xor tree over the group's lanes;
    the chunks' scores added in order), run on the CPU: bfloat16 and int8 bit for bit (their terms are exact in float32 or
    rounded as the kernel rounds them); float32 within 4 units in the last
    place of sum|terms| (the twin's fused multiply-add is a float64 sum
    rounded once more)."""
    indptr, indices = _csr_on_card(hub_graph)
    a, b, g = _sddmm_operands(hub_graph, d, dtype)
    got = sd.sddmm(indptr, indices, a, b, g).cpu()
    twin = sd.sddmm_groups_plain(indptr.cpu(), indices.cpu(), a.cpu(), b.cpu(), None if g is None else g.cpu())
    if dtype == torch.float32:
        mag = sd.sddmm_plain(indptr.cpu(), indices.cpu(), a.cpu().double().abs(), b.cpu().double().abs())
        assert bool(((got.double() - twin.double()).abs() <= 2.0**-22 * mag).all())
    else:
        assert torch.equal(got, twin)


@pytest.mark.parametrize("d_pad", [8, 16, 24, 32, 40, 48, 64, 128, 256, 264])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_sddmm_geometry_on_card(dtype, d_pad):
    """The SDDMM's launch geometry from the card: L, G, U, F and the
    shuffles of a batch by the rule of sd.sddmm_geometry (fewer than one
    shuffle an entry but at L = 32, 9 for 8 entries), a warp a row in
    blocks of 8, at least 32 warps resident an SM (4 blocks), and 32 KiB of
    dynamic shared memory (1,024 running scores a warp) exactly where a row
    is walked in chunks (L F < d_pad)."""
    n = 232_968
    rule = sd.sddmm_geometry(d_pad, dtype)
    geo = sd.sddmm_launch_geometry(n, d_pad, dtype)
    assert {k: geo[k] for k in rule} == rule, geo
    assert geo["shuffles"] < geo["groups"] * geo["entries"] or (geo["lanes"], geo["shuffles"]) == (32, 9), geo
    assert geo["grid_x"] == -(-n // 8) and geo["threads"] == 256 and geo["blocks_per_sm"] >= 4, geo
    assert geo["smem"] == (8 * 1024 * 4 if rule["lanes"] * rule["features"] < d_pad else 0), geo


@pytest.mark.parametrize("dtype,d_whole,d_chunked", [(torch.float32, 128, 256), (torch.bfloat16, 256, 264),
                                                    (torch.int8, 512, 1024)])
def test_sddmm_launches_after_geometry_query(hub_graph, dtype, d_whole, d_chunked):
    """One kernel (L = 32) serves a width walked whole and a wider one walked
    in chunks with running scores in shared memory: after a geometry query
    at the first, a launch at the second still runs and gives the bits of a
    launch made before the query."""
    indptr, indices = _csr_on_card(hub_graph)
    a, b, g = _sddmm_operands(hub_graph, d_chunked, dtype)
    assert sd.sddmm_geometry(d_whole, dtype)["lanes"] == sd.sddmm_geometry(d_chunked, dtype)["lanes"] == 32
    before = sd.sddmm(indptr, indices, a, b, g)
    sd.sddmm_launch_geometry(hub_graph.nrows, d_whole, dtype)
    after = sd.sddmm(indptr, indices, a, b, g)
    torch.cuda.synchronize()
    assert torch.equal(after, before)


@pytest.mark.parametrize("d", [1, 2, 16, 41, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_t_kernel_matches_plain(hub_graph, dtype, d):
    """Mᵀ(w) A for M = the hub graph's transpose: its transpose walk has the
    degree-5,000 hub (column 7 of M) and the empty columns 100..199 of M,
    whose output rows must be zero; at d_pad 8, 16, 48, 64 and >= 128 (every
    group size of the walk); two launches give the same bits."""
    from mg_gcn_tpu_torch import sparse

    m = sparse.transpose(hub_graph)
    mat = se.edge_tile_mat_from_csr(m, dtype="float32", device="cuda", merge=False)
    t = se.transposed_schedule(mat)
    w = mat.w.to(dtype)
    d_pad = max(8, -(-d // 8) * 8)
    a = _dense_operand(m.nrows, d, d_pad, dtype, seed=d)
    key = (str(dtype).removeprefix("torch."), d_pad)
    before = se.edge_t.launches[key]
    got = se.edge_t(t.t_indptr, t.t_rows, t.perm, w, a)
    again = se.edge_t(t.t_indptr, t.t_rows, t.perm, w, a)
    torch.cuda.synchronize()
    assert se.edge_t.launches[key] == before + 2
    assert torch.equal(got, again)
    assert got.dtype == torch.float32 and got.shape == (m.ncols, d_pad)
    wp = w[t.perm.long()]
    _assert_within_sum_bound(got, t.t_indptr, t.t_rows, wp, a)


def test_transposed_schedule_on_card_equals_cpu(hub_graph):
    cpu = se.transposed_schedule(se.edge_tile_mat_from_csr(hub_graph, device="cpu", merge=False))
    gpu = se.transposed_schedule(se.edge_tile_mat_from_csr(hub_graph, device="cuda", merge=False))
    for name in ("t_indptr", "t_rows", "perm"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name


def test_gat_step_on_card_matches_cpu():
    """One float32 GAT step (two layers, two heads) on the card against the
    port's CPU step from the same parameters: loss within rtol 1e-5, every
    gradient leaf within ||card - CPU|| <= 1e-4 ||CPU||."""
    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.nn import adam

    ds = Dataset.load(GOLDEN)
    config = gat.GATConfig(sizes=(ds.num_features, 16, ds.num_labels), heads=2)
    out = {}
    for dev in ("cpu", "cuda"):
        graph = gat.build_gat_graph(ds.graph, dtype="float32", device=dev)
        params = gat.init_params(config, 5, device=dev)
        x = torch.from_numpy(ds.features).to(dev)
        y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
        out[dev] = gat.loss_and_grad(params, graph, x, y, config)
        step = make_train_step(config, model="gat")
        p2, _, loss2, _ = step(params, adam.adam_init(params), graph, x, y, None)
        out[dev + " step"] = float(loss2)
    (lc, _, gc), (lg, _, gg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    np.testing.assert_allclose(out["cuda step"], out["cpu step"], rtol=1e-5)
    for layer_c, layer_g in zip(gc, gg):
        for k in layer_c:
            diff = torch.linalg.vector_norm(layer_g[k].cpu() - layer_c[k])
            assert diff <= 1e-4 * torch.linalg.vector_norm(layer_c[k]), k


def test_ppi_gat_step_on_card_matches_cpu_and_counts_its_launches():
    """One float32 step of the PPI form of GAT (per-layer heads, ELU, the
    skip across the middle layer) on the card against the port's CPU step
    from the same parameters: loss within rtol 1e-5, every gradient leaf
    within ||card - CPU|| <= 1e-4 ||CPU||; traced, the ``attn_launches``
    counter equals the launches the kernel wrappers record."""
    from mg_gcn_tpu_torch import timers
    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.ops.edge_attention import ATTN_LAUNCHES

    ds = Dataset.load(GOLDEN)
    config = gat.GATConfig(sizes=(ds.num_features, 16, 16, ds.num_labels), heads=(2, 2, 3), activation="elu",
                           skip=(1,))
    out = {}
    for dev in ("cpu", "cuda"):
        graph = gat.build_gat_graph(ds.graph, dtype="float32", device=dev)
        params = gat.init_params(config, 5, device=dev)
        x = torch.from_numpy(ds.features).to(dev)
        y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
        out[dev] = gat.loss_and_grad(params, graph, x, y, config)
    (lc, _, gc), (lg, _, gg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    for layer_c, layer_g in zip(gc, gg):
        for k in layer_c:
            diff = torch.linalg.vector_norm(layer_g[k].cpu() - layer_c[k])
            assert diff <= 1e-4 * torch.linalg.vector_norm(layer_c[k]), k

    def launched():
        return {k: sum(f.launches.values()) for k, f in (("sddmm", sd.sddmm), ("edge", se.edge), ("edge_t", se.edge_t),
                                                           ("softmax", esm.softmax_fwd), ("softmax_bwd", esm.softmax_bwd))}

    before, counted = launched(), dict(timers.counters().get(ATTN_LAUNCHES, {}))
    with torch.profiler.profile(activities=timers.profiler_activities()):
        gat.loss_and_grad(params, graph, x, y, config)
        torch.cuda.synchronize()
    after, now = launched(), timers.counters()[ATTN_LAUNCHES]
    by_kernel = {k: sum(n - counted.get(key, 0) for key, n in now.items() if key[0] == k) for k in after}
    # 7 heads and layers: one aggregation, its weights' SDDMM and its transposed product at the head's
    # width, the transposed product at d = 1 (the scores' column sums), the edge softmax's two
    # forward walks and its backward walk
    assert by_kernel == {k: after[k] - before[k] for k in after} == {"sddmm": 7, "edge": 7, "edge_t": 14,
                                                                      "softmax": 14, "softmax_bwd": 7}


# ---------------------------------------------------------------------------
# the edge softmax's fused walks (csrc/edge_softmax.cu)


def _softmax_operands(g, dtype, weighted, seed):
    """Score vectors (2 x normal, in ``dtype``), the clamped log-weight bias
    (or None) and a cotangent, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    e_dst, e_src = ((2.0 * torch.randn(m, device="cuda", generator=gen)).to(dtype) for m in (g.nrows, g.ncols))
    bias = torch.clamp(torch.log(torch.from_numpy(g.data).cuda()), -30.0, 30.0) if weighted else None
    return e_dst, e_src, bias, torch.randn(g.nnz, device="cuda", generator=gen)


@pytest.mark.parametrize("weighted", [False, True], ids=["binary", "edge-weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_softmax_walks_follow_the_twin(hub_graph, dtype, weighted):
    """``softmax_fwd`` (two launches) and ``softmax_bwd`` on the hub graph
    (a row of 5,000 entries, empty rows 100..199) against their plain
    versions on the card, each row summed in the walk's order, element by
    element: the weights and the row statistics within rtol 1e-5, the
    gradient of each entry within one ulp of its dtype (no value let off
    for being small); the gradient's row sums (``e_dst``'s) and its column
    sums through ``edge_t`` at d = 1 (``e_src``'s, the op's own call)
    within the float32 sum bound of float64 sums of the same entries; two
    launches give the same bits."""
    from mg_gcn_tpu_torch.ops import edge_attention as ea

    indptr, indices = _csr_on_card(hub_graph)
    e_dst, e_src, bias, dalpha = _softmax_operands(hub_graph, dtype, weighted, seed=12)
    args = (indptr, indices, e_dst, e_src, bias, 0.2)
    key = (str(dtype).removeprefix("torch."), 8)
    before = (esm.softmax_fwd.launches[key], esm.softmax_bwd.launches[key])
    (alpha, stats), again = esm.softmax_fwd(*args), esm.softmax_fwd(*args)
    (de, g_pre), (de2, g_pre2) = esm.softmax_bwd(*args, stats, dalpha), esm.softmax_bwd(*args, stats, dalpha)
    torch.cuda.synchronize()
    assert (esm.softmax_fwd.launches[key], esm.softmax_bwd.launches[key]) == (before[0] + 4, before[1] + 2)
    assert torch.equal(alpha, again[0]) and torch.equal(stats, again[1])
    assert torch.equal(de, de2) and torch.equal(g_pre, g_pre2)
    assert alpha.dtype == stats.dtype == de.dtype == torch.float32 and g_pre.dtype == dtype
    twin_alpha, twin_stats = esm.softmax_fwd_plain(*args, row_sums=esm.walk_row_sums)
    _, twin_g = esm.softmax_bwd_plain(*args, stats, dalpha, row_sums=esm.walk_row_sums)
    tiny = torch.finfo(torch.float32).tiny
    for got, want in ((alpha, twin_alpha), (stats, twin_stats)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tiny)
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 2.0**-23
    torch.testing.assert_close(g_pre.float(), twin_g.float(), rtol=ulp, atol=tiny)
    _assert_within_sum_bound(de[:, None], indptr, indices, g_pre, torch.ones((hub_graph.ncols, 1), device="cuda"))
    mat, sched = ea.build_attention_graph(hub_graph, str(dtype).removeprefix("torch."), "cuda")
    de_src = se.spmm_edge_tiles_t(mat, sched, torch.ones((hub_graph.nrows, 1), device="cuda"), w_slots=g_pre)
    cols, terms = indices.long(), g_pre.double()
    exact = torch.zeros(hub_graph.ncols, dtype=torch.float64, device="cuda").index_add_(0, cols, terms)
    mag = torch.zeros_like(exact).index_add_(0, cols, terms.abs())
    _assert_within_sum_error(de_src[:, 0], exact, mag, torch.bincount(cols, minlength=hub_graph.ncols).double())


def test_edge_softmax_on_card_matches_the_composite(hub_graph):
    """The op on the card (float32 graph, edge-weighted) against the
    composite it replaces on the card (sddmm -> leaky_relu -> + bias ->
    slot_softmax) under autograd: alpha and both vectors' gradients within
    1e-5 of their scale (float32 sums in another order; the bfloat16
    rounding points are held on the CPU, where the plain version meets the
    composite, and above, where the walks meet the plain version)."""
    from mg_gcn_tpu_torch.ops import edge_attention as ea
    from mg_gcn_tpu_torch.ops.elementwise import leaky_relu

    mat, sched = ea.build_attention_graph(hub_graph, "float32", "cuda")
    e_dst, e_src, bias, cot = _softmax_operands(hub_graph, torch.float32, True, seed=13)

    def composite(ed, es):
        s = ea.sddmm(mat, sched, torch.cat([ed, torch.ones_like(ed)], dim=1), torch.cat([torch.ones_like(es), es], 1))
        return ea.slot_softmax(mat, sched, leaky_relu(s, 0.2) + bias)

    out = []
    for fn in (composite, lambda ed, es: ea.edge_softmax(mat, sched, ed, es, 0.2, bias)):
        leaves = [v[:, None].clone().requires_grad_(True) for v in (e_dst, e_src)]
        alpha = fn(*leaves)
        out.append([alpha.detach(), *torch.autograd.grad(alpha, leaves, cot)])
    for want, got in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# DeeperGCN: the softmax aggregation on the binary walk (d_pad 256 forward,
# 128 backward, bfloat16 operands)


@pytest.fixture(scope="module")
def softagg_graph():
    return sparse.random_graph(20_000, 48, seed=6)


@pytest.mark.parametrize("d_pad", [128, 256])
def test_binary_bf16_walk_at_the_softmax_widths(softagg_graph, d_pad):
    """The binary walk with a bfloat16 operand at DeeperGCN's widths (one
    warp a row, one 128-feature chunk a pass at 128, two at 256) on a
    uniform graph, within the float32 sum bound of the float64 plain
    version; two launches give the same bits."""
    g = softagg_graph
    indptr, indices = _csr_on_card(g)
    b = _operand(g.ncols, d_pad, torch.bfloat16, seed=d_pad).abs()
    got, again = sg.gather(indptr, indices, None, b), sg.gather(indptr, indices, None, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    exact = se.csr_plain(indptr, indices, None, b, torch.float64)
    _assert_within_sum_error(got, exact, exact, indptr.diff().to(torch.float64)[:, None])
    geo = sg.gather_geometry(g.nrows, d_pad, torch.bfloat16, weighted=False)
    assert (geo["lanes"], geo["groups"]) == (32, 1)


def _softagg_both(graph, operand, seed):
    """(a, dx, the backward of |cot|) of the softmax aggregation at width
    128 on the CPU (the op's plain twin) and on the card, from the same x
    and cotangent."""
    from mg_gcn_tpu_torch.models.deepergcn import build_deepergcn_graph
    from mg_gcn_tpu_torch.ops.softmax_agg import softmax_aggregate

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((graph.nrows, 128), generator=gen) * 2.0
    cot = torch.randn((graph.nrows, 128), generator=gen) * 1e-3
    out = {}
    for dev in ("cpu", "cuda"):
        pair = build_deepergcn_graph(graph, device=dev)
        xd = x.to(dev).requires_grad_(True)
        a = softmax_aggregate(pair.fwd, pair.bwd, xd, 0.1, 1e-7, operand)
        dx, mag = (torch.autograd.grad(a, xd, c.to(dev), retain_graph=True)[0] for c in (cot, cot.abs()))
        out[dev] = (a.detach().cpu(), dx.cpu(), mag.cpu())
    return out["cpu"], out["cuda"]


@pytest.mark.parametrize("operand", ["bfloat16", "float32"])
def test_softmax_aggregate_on_card_matches_the_cpu_twin(softagg_graph, operand):
    """The op on the card against its plain twin on the CPU at width 128:
    the same rounding points, float32 sums in another order, and the card's
    exp against the CPU's (an ulp apart now and then, which may move a
    bfloat16 rounding). Element by element: in float32 within 1e-5 of each
    value; in bfloat16 within 2^-6 (each side lies within 2^-7, twice
    bfloat16's unit roundoff, of the exact softmax of positive terms,
    forward; of the sum of |terms|, backward),
    and all but a hundredth of the elements within 1e-5 (a dx element sums
    about 49 rounded quotients, each moved across a bfloat16 rounding by a
    float32 difference of den with a chance of a few in 1e5)."""
    (a, dx, mag), (a_c, dx_c, _) = _softagg_both(softagg_graph, operand, seed=3)
    assert bool(torch.isfinite(a_c).all()) and bool(torch.isfinite(dx_c).all())
    da, ddx = (a_c - a).abs(), (dx_c - dx).abs()
    if operand == "float32":
        assert bool((da <= 1e-5 * a).all()) and bool((ddx <= 1e-5 * mag + 1e-30).all())
        return
    assert bool((da <= 2.0**-6 * a).all()) and bool((ddx <= 2.0**-6 * mag + 1e-30).all())
    assert float((da > 1e-5 * a).double().mean()) < 1e-2
    assert float((ddx > 1e-5 * mag + 1e-30).double().mean()) < 1e-2


def test_deepergcn_step_on_card_matches_cpu():
    """A small DeeperGCN (4 GENConv layers of 16, the float32 operand) on
    the card against the port's CPU step from the same parameters: the
    loss within rtol 1e-5 and every gradient leaf within 1e-4 of the larger
    of its norm and the median leaf's (the benchmark's scale: a linear's
    bias that feeds only BatchNorms has a gradient of nought but for
    rounding), then the losses of three Adam steps within rtol 1e-5."""
    from mg_gcn_tpu_torch.models import deepergcn as dg
    from mg_gcn_tpu_torch.nn import adam

    ds = Dataset.load(GOLDEN)
    config = dg.DeeperGCNConfig(sizes=(ds.num_features, 16, ds.num_labels), layers=4, operand="float32")
    out = {}
    for dev in ("cpu", "cuda"):
        pair = dg.build_deepergcn_graph(ds.graph, device=dev)
        params = dg.init_params(config, 5, device=dev)
        x = torch.from_numpy(ds.features).to(dev)
        y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
        loss, _, grads = dg.loss_and_grad(params, pair, x, y, config)
        step, opt, losses = make_train_step(config, dict(weight_decay=0.0), model="deepergcn"), adam.adam_init(params), []
        for _ in range(3):
            params, opt, step_loss, _ = step(params, opt, pair, x, y, None)
            losses.append(float(step_loss))
        out[dev] = float(loss), {f"{i}.{k}": g.cpu() for i, layer in enumerate(grads) for k, g in layer.items()}, losses
    (lc, gc, sc), (lg, gg, sg_) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in gc.items()}
    scale = float(np.median(list(norms.values())))
    for k in gc:
        assert float(torch.linalg.vector_norm(gg[k] - gc[k])) <= 1e-4 * max(norms[k], scale), k
    np.testing.assert_allclose(sg_, sc, rtol=1e-5)


# ---------------------------------------------------------------------------
# the block-sparse pattern pair and the tiled-ELL kernel


def _block_graph(kind):
    """"gappy": 12,288 nodes with empty rows, an empty row block (rows
    4096-4607), an empty group (columns 4096-8191) and the last plane of
    group 0 (bit 31) set; "dense": 8,192 nodes, row 5 and column 4100 dense
    (8,192 terms each) and bit 31 set in every row."""
    rng = np.random.default_rng(3)
    if kind == "gappy":
        n = 12_288
        src = np.r_[rng.integers(0, 4096, 4000), rng.integers(4608, n, 4000), np.arange(3968, 4096)]
        dst = np.r_[rng.integers(0, 4096, 4000), rng.integers(8192, n, 4000), np.arange(3968, 4096)]
        keep = src % 7 != 3
        src, dst = src[keep], dst[keep]
    else:
        n = 8192
        src = np.r_[np.full(n, 5), np.arange(n), np.arange(n), rng.integers(0, n, 20_000)]
        dst = np.r_[np.arange(n), np.full(n, 4100), 3968 + np.arange(n) % 128, rng.integers(0, n, 20_000)]
    key = np.unique(src.astype(np.int64) * n + dst)
    indptr = np.r_[0, np.cumsum(np.bincount(key // n, minlength=n))].astype(np.int64)
    return CSRData(indptr, (key % n).astype(np.int32), np.ones(key.size, np.float32), (n, n))


def _assert_block_matches_plain(mat, which, b):
    kernel = sps.block_fwd if which == "fwd" else sps.block_bwd
    key = (str(b.dtype).removeprefix("torch."), b.shape[1])
    before = kernel.launches[key]
    got = kernel(mat, b)
    torch.cuda.synchronize()
    assert kernel.launches[key] == before + 1
    plain = sps.block_fwd_plain if which == "fwd" else sps.block_bwd_plain
    if b.dtype == torch.int8:
        assert got.dtype == torch.int32 and torch.equal(got, plain(mat, b))
        return got
    assert got.dtype == torch.float32
    rows, cols = (torch.cat(t) for t in zip(*sps.decode_tiles(mat)))
    dst, src = (cols, rows) if which == "fwd" else (rows, cols)
    zero = torch.zeros(got.shape, dtype=torch.float64, device="cuda")
    exact = zero.clone().index_add_(0, dst, b.double().index_select(0, src))
    mag = zero.index_add_(0, dst, b.double().abs().index_select(0, src))
    _assert_within_sum_error(got, exact, mag, torch.bincount(dst, minlength=got.shape[0]).double()[:, None])
    return got


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("tile_r", [128, 256, 512, 2048])
@pytest.mark.parametrize("kind", ["gappy", "dense"])
def test_block_kernels_match_plain(kind, tile_r, dtype, which):
    g = _block_graph(kind)
    mat = sps.block_pattern_pair_from_binary_csr(g, device="cuda", tile_r=tile_r)[0]
    host = sps.block_pattern_pair_from_binary_csr(g, device="cpu", tile_r=tile_r, build_on_device=False)[0]
    assert torch.equal(mat.tiles.cpu(), host.tiles) and torch.equal(mat.pmask.cpu(), host.pmask)
    got = _assert_block_matches_plain(mat, which, _operand(mat.n_pad, 48, dtype, seed=tile_r))
    if kind == "gappy":  # no tile reaches these output rows
        assert not bool(got[4096:4608 if which == "bwd" else 8192].any())


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d_pad", [8, 128, 200])
def test_block_kernels_at_every_width(d_pad, dtype, which):
    g = sparse.banded_graph(9000, 40, 700, seed=2)
    mat = sps.block_pattern_pair_from_binary_csr(g, device="cuda")[0]
    _assert_block_matches_plain(mat, which, _operand(mat.n_pad, d_pad, dtype, seed=d_pad))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_spmm_block_on_card_matches_cpu(dtype):
    g = sparse.banded_graph(6000, 12, 300, seed=4)
    b = torch.from_numpy(np.random.default_rng(3).random((6000, 41)).astype(np.float32))
    for i in range(2):  # forward (Pᵀ, post-scale) and backward (P, pre-scale)
        got = sps.spmm_block_pattern(sps.block_pattern_pair_from_binary_csr(g, dtype, device="cuda")[i], b.cuda())
        want = sps.spmm_block_pattern(sps.block_pattern_pair_from_binary_csr(g, dtype, device="cpu")[i], b)
        if dtype == "int8":
            assert torch.equal(got.cpu(), want)
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-7)


def test_block_wrappers_reject_bad_operands():
    mat = sps.block_pattern_pair_from_binary_csr(_block_graph("gappy"), device="cuda")[0]
    with pytest.raises(ValueError, match="d_pad % 8"):
        sps.block_fwd(mat, torch.zeros((mat.n_pad, 12), device="cuda"))
    with pytest.raises(ValueError, match="float32/bfloat16/int8"):
        sps.block_bwd(mat, torch.zeros((mat.n_pad, 16), device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        sps.block_bwd(mat, torch.zeros((16, mat.n_pad), device="cuda").T)


def test_train_block_on_card_matches_cpu():
    g = sparse.banded_graph(5000, 10, 200, seed=6)
    rng = np.random.default_rng(0)
    ds = Dataset(graph=g, features=rng.standard_normal((5000, 24)).astype(np.float32),
                 labels=rng.integers(0, 5, (5000, 1)).astype(np.int32), sets=np.zeros((5000, 1), np.int32))
    gpu = train(ds, [16, 16], epochs=5, impl="auto", pattern_dtype="float32", device="cuda", log=False)
    cpu = train(ds, [16, 16], epochs=5, impl="block", pattern_dtype="float32", device="cpu", log=False)
    assert gpu.engine == "block"
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-5)


@pytest.mark.parametrize("br", [64, 512])
@pytest.mark.parametrize("d", [1, 41, 128, 130, 300])
def test_tiled_kernel_matches_plain(hub_graph, d, br):
    """The hub row (degree 5,000) sets K; empty rows 100..199 come out 0."""
    mat = tpl.TiledMat.from_csr(hub_graph, br=br, bc=br, device="cuda")
    b = _operand(mat.n_cb * br, d, torch.float32, seed=d)
    before = tpl.tiled.launches[("float32", d)]
    got = tpl.tiled(mat, b)
    torch.cuda.synchronize()
    assert tpl.tiled.launches[("float32", d)] == before + 1
    assert got.shape == (mat.n_rb * br, d) and got.dtype == torch.float32
    exact = tpl.tiled_plain(mat, b, torch.float64)
    tiles_abs = tpl.TiledMat(mat.lcol, mat.val.abs(), mat.nsteps, mat.n_rows, mat.n_cols, mat.nnz, br, br)
    mag = tpl.tiled_plain(tiles_abs, b.abs(), torch.float64)
    deg = torch.zeros(got.shape[0], dtype=torch.float64, device="cuda")
    deg[: hub_graph.nrows] = torch.from_numpy(np.diff(hub_graph.indptr)).cuda().double()
    _assert_within_sum_error(got, exact, mag, deg[:, None])
    assert not bool(got[100:200].any())
    with pytest.raises(ValueError, match="float32"):
        tpl.tiled(mat, b.to(torch.bfloat16))


def _planes_graph():
    """8,192 nodes: rows 0..511 x columns 0..4095 all set (a tile with all 32
    planes live and bit 31 in every word), row 600 -> column 5000 (a tile
    with one live plane), and random edges in rows 1024..8191."""
    n = 8192
    rng = np.random.default_rng(4)
    rows = np.r_[np.repeat(np.arange(512), 4096), 600, rng.integers(1024, n, 6000)]
    cols = np.r_[np.tile(np.arange(4096), 512), 5000, rng.integers(0, n, 6000)]
    key = np.unique(rows.astype(np.int64) * n + cols)
    indptr = np.r_[0, np.cumsum(np.bincount(key // n, minlength=n))].astype(np.int64)
    return CSRData(indptr, (key % n).astype(np.int32), np.ones(key.size, np.float32), (n, n))


@pytest.fixture(scope="module")
def planes_mat():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mat = sps.block_pattern_pair_from_binary_csr(_planes_graph(), device="cuda")[0]
    masks = mat.pmask.cpu().numpy().view(np.uint32)
    assert (masks == 0xFFFFFFFF).any() and (np.bitwise_count(masks) == 1).any()
    assert bool((mat.tiles < 0).any())  # bit 31
    return mat


@pytest.mark.parametrize("d_pad", [8, 48, 128, 136, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_block_fwd_tensor_cores_match_plain(planes_mat, dtype, d_pad):
    """block_fwd on the tensor cores against its float64 plain version
    (int8 at +-127, equal), with a fully live tile and a one-plane tile, at
    every width class; two launches give the same bits."""
    b = _operand(planes_mat.n_pad, d_pad, dtype, seed=d_pad)
    if dtype == torch.int8:
        b[:, 0], b[:, 1] = 127, -127
    got = sps.block_fwd(planes_mat, b)
    again = sps.block_fwd(planes_mat, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = sps.block_fwd_plain(planes_mat, b, None if dtype == torch.int8 else torch.float64)
    _assert_matches_plain(got, want.to(got.dtype), dtype)


def test_block_fwd_float32_keeps_every_significand_bit(planes_mat):
    """float32 operands 1 + k 2^-23 need all 24 significand bits, and one
    column mixes magnitudes 2^40 apart: the three-part bf16 split with its
    two sets of sums keeps every sum within the float32 sum-error bound of
    the float64 sum (a TF32 or two-part split misses it by far)."""
    n = planes_mat.n_pad
    k = torch.arange(n, device="cuda") % (1 << 20) + 1
    base = (1.0 + k.double() * 2.0**-23).float()
    b = torch.zeros((n, 8), device="cuda")
    b[:, 0] = base
    b[:, 1] = torch.where(k % 2 == 0, base * 2.0**20, base * 2.0**-20)
    b[:, 2] = -3.0 * base
    got = sps.block_fwd(planes_mat, b)
    torch.cuda.synchronize()
    rows, cols = (torch.cat(t) for t in zip(*sps.decode_tiles(planes_mat)))
    zero = torch.zeros(got.shape, dtype=torch.float64, device="cuda")
    exact = zero.clone().index_add_(0, cols, b.double().index_select(0, rows))
    mag = zero.index_add_(0, cols, b.double().abs().index_select(0, rows))
    _assert_within_sum_error(got, exact, mag, torch.bincount(cols, minlength=n).double()[:, None])
    _assert_matches_plain(got, sps.block_fwd_plain(planes_mat, b, torch.float64).float(), torch.float32)


def test_block_fwd_float32_sums_do_not_lean(planes_mat):
    """On a positive float32 operand every error of a sum that leans toward
    zero has the same sign: sum(e sign(sum)) / sum|e| against the float64
    sum would be -1 for sums kept on the tensor cores from the first tile to
    the last (they truncate). Fresh sums a stage, added by float32 adds that
    round to nearest, keep it within +-0.15 (columns 0..4095 sum 512 bits of
    the fully set tile)."""
    b = _operand(planes_mat.n_pad, 128, torch.float32, seed=9).abs()
    got = sps.block_fwd(planes_mat, b).double()
    want = sps.block_fwd_plain(planes_mat, b, torch.float64)
    torch.cuda.synchronize()
    e = (got - want)[want != 0]
    lean = float((e * torch.sign(want[want != 0])).sum() / e.abs().sum().clamp_min(1e-300))
    assert float(e.abs().sum()) > 0 and abs(lean) <= 0.15, lean


def _long_group_graph():
    """77,824 nodes: every row has two edges into columns 0..4095, so group 0
    holds a tile of every row block (608 at tile_r = 128, 1,216 at 64: more
    than the 512 a block_fwd block tables at a time), and rows 0..8191 one
    edge into group 1."""
    n = 19 * 4096
    rng = np.random.default_rng(8)
    rows = np.r_[np.repeat(np.arange(n), 2), np.arange(8192)]
    cols = np.r_[rng.integers(0, 4096, 2 * n), 4096 + rng.integers(0, 4096, 8192)]
    key = np.unique(rows.astype(np.int64) * n + cols)
    indptr = np.r_[0, np.cumsum(np.bincount(key // n, minlength=n))].astype(np.int64)
    return CSRData(indptr, (key % n).astype(np.int32), np.ones(key.size, np.float32), (n, n))


@pytest.mark.parametrize("tile_r", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_block_fwd_group_of_many_tiles(tile_r, dtype):
    """block_fwd on a group of more tiles than its shared tile table holds
    (two and three windows of 512) against its float64 plain version, int8
    equal; two launches give the same bits."""
    mat = sps.block_pattern_pair_from_binary_csr(_long_group_graph(), device="cuda", tile_r=tile_r)[0]
    assert int(torch.diff(mat.g_ptr).max()) == mat.n_pad // tile_r > 512
    b = _operand(mat.n_pad, 48, dtype, seed=tile_r)
    got, again = sps.block_fwd(mat, b), sps.block_fwd(mat, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = sps.block_fwd_plain(mat, b, None if dtype == torch.int8 else torch.float64)
    _assert_matches_plain(got, want.to(got.dtype), dtype)


def _tiled_gappy_graph():
    """2,048 nodes, uniform weights: rows 0..511 have no entry in columns
    512..1023 (a tile with nsteps 0 at br = 512, four at br = 128), row 5 has
    no entry at all (a row whose slots are all padding), row 9 has 300
    entries in columns 0..511 (ELL K >= 64)."""
    n = 2048
    rng = np.random.default_rng(6)
    rows, cols = rng.integers(0, n, 30_000), rng.integers(0, n, 30_000)
    keep = ~((rows < 512) & (cols >= 512) & (cols < 1024)) & (rows != 5)
    rows, cols = np.r_[rows[keep], np.full(300, 9)], np.r_[cols[keep], rng.choice(512, 300, replace=False)]
    key = np.unique(rows.astype(np.int64) * n + cols)
    indptr = np.r_[0, np.cumsum(np.bincount(key // n, minlength=n))].astype(np.int64)
    data = rng.random(key.size).astype(np.float32) + 0.5
    return CSRData(indptr, (key % n).astype(np.int32), data, (n, n))


@pytest.mark.parametrize("br", [128, 512])
@pytest.mark.parametrize("d", [1, 41, 128, 200])
def test_tiled_skips_empty_tiles_and_padding(br, d):
    """tiled against its float64 plain version on a store with empty tiles
    (nsteps 0) and an all-padding row (its output 0); two launches give the
    same bits."""
    mat = tpl.TiledMat.from_csr(_tiled_gappy_graph(), br=br, bc=br, device="cuda")
    assert bool((mat.nsteps == 0).any()) and mat.ell_k >= 64
    b = _operand(mat.n_cb * br, d, torch.float32, seed=d)
    got, again = tpl.tiled(mat, b), tpl.tiled(mat, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert not bool(got[5].any())
    _assert_matches_plain(got, tpl.tiled_plain(mat, b, torch.float64).float(), torch.float32)


def test_new_geometries_fill_the_card():
    """block_fwd and tiled launch geometry at the banded and ELL paths'
    shapes: 16 warps an SM for block_fwd (one block of 512 threads), and the
    tiled grid covers every row block x 16-feature chunk."""
    geo = sps.block_fwd_geometry(233_472, 512, 128, torch.bfloat16)
    assert geo["threads"] == 512 and geo["blocks_per_sm"] >= 1 and geo["grid_y"] == 57, geo
    mat = tpl.TiledMat.from_csr(_tiled_gappy_graph(), device="cuda")
    geo = tpl.tiled_geometry(mat, 41)
    assert geo["grid_x"] == mat.n_rb and geo["grid_y"] == 3 and geo["blocks_per_sm"] >= 1, geo


def test_train_pallas_on_card_matches_cpu():
    ds = Dataset.load(GOLDEN)
    gpu = train(ds, [16, 16], epochs=5, impl="pallas", device="cuda", log=False)
    cpu = train(ds, [16, 16], epochs=5, impl="pallas", device="cpu", log=False)
    assert gpu.engine == cpu.engine == "pallas"
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-5)


# ---------------------------------------------------------------------------
# the ring pair and the row-partitioned step


def _ring_graph(parts):
    """A binary graph over P slabs of m = 4,096 rows: 100 padded rows in the
    last slab, and (P > 1) no edge from slab 0's rows into slab 1's columns,
    so partition 0's backward round 1 and partition 1's forward round P-1
    are empty."""
    n = parts * 4096 - 100
    g = sparse.random_graph(n, 16, seed=5)
    rows = np.repeat(np.arange(n), np.diff(g.indptr))
    keep = ~((rows < 4096) & (g.indices >= 4096) & (g.indices < 8192))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=n), out=indptr[1:])
    return CSRData(indptr, g.indices[keep], g.data[keep], g.shape)


@pytest.mark.parametrize("d", [8, 41, 64, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_ring_kernel_matches_plain(which, parts, dtype, d):
    """ring_fwd / ring_bwd against their plain versions summed in float64
    (int8: equal), every partition, with an empty round, bit 31 set and
    padded rows, whose outputs must be 0."""
    g = _ring_graph(parts)
    pair = dist.DistPatternPair.from_binary_csr(g, dist.make_mesh(parts, ["cuda:0"] * parts))
    packs = pair.pack_fwd if which == "fwd" else pair.pack_bwd
    kernel, plain = ((ring.ring_pattern_fwd, ring.ring_pattern_fwd_plain) if which == "fwd"
                     else (ring.ring_pattern_bwd, ring.ring_pattern_bwd_plain))
    assert any(bool((p < 0).any()) for p in packs)  # bit 31 of some word
    if parts > 1:
        assert not packs[1][parts - 1].any() if which == "fwd" else not packs[0][1].any()
    m, d_pad = pair.m_loc, sp.round_up(d, 8)
    key = (str(dtype).removeprefix("torch."), d_pad)
    for j in range(parts):
        slots = torch.zeros((parts, m, d_pad), dtype=dtype, device="cuda")
        slots[:, :, :d] = _operand(parts * m, d, dtype, seed=j).reshape(parts, m, d)
        before = kernel.launches[key]
        got = kernel(packs[j], slots)
        torch.cuda.synchronize()
        assert kernel.launches[key] == before + 1
        assert got.shape == (m, d_pad) and got.dtype == (torch.int32 if dtype == torch.int8 else torch.float32)
        if dtype == torch.int8:
            assert torch.equal(got, plain(packs[j], slots))
        else:
            want = plain(packs[j], slots, torch.float64)
            torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
        if j == parts - 1:
            assert not got[m - 100:].any()


def test_ring_wrappers_reject_bad_operands():
    pair = dist.DistPatternPair.from_binary_csr(_ring_graph(2), dist.make_mesh(2, ["cuda:0"] * 2))
    m = pair.m_loc
    with pytest.raises(ValueError, match="d_pad % 8"):
        ring.ring_pattern_fwd(pair.pack_fwd[0], torch.zeros((2, m, 12), device="cuda"))
    with pytest.raises(ValueError, match=r"\(P, m, d_pad\)"):
        ring.ring_pattern_bwd(pair.pack_bwd[0], torch.zeros((3, m, 16), device="cuda"))
    with pytest.raises(ValueError, match="one CUDA device"):
        ring.ring_pattern_fwd(pair.pack_fwd[0].cpu(), torch.zeros((2, m, 16), device="cuda"))


@pytest.mark.parametrize("orientation", ["PT", "P"])
def test_strategies_equal_in_int8_on_card(orientation):
    """fused = ring = all_gather in int8 on the card, and = the CPU."""
    g = _ring_graph(4)
    h = np.random.default_rng(1).standard_normal((4 * 4096, 41)).astype(np.float32)
    h[g.nrows:] = 0
    outs = {}
    for dev in ("cuda:0", "cpu"):
        mesh = dist.make_mesh(4, [dev] * 4)
        pair = dist.DistPatternPair.from_binary_csr(g, mesh, dtype="int8")
        for strategy in ("fused", "ring", "all_gather"):
            out = dist.dist_aggregate_pattern(pair, dist.shard(h, mesh), orientation, strategy=strategy)
            outs[(dev, strategy)] = torch.cat([o.cpu() for o in out])
    first = outs[("cuda:0", "fused")]
    assert all(torch.equal(first, o) for o in outs.values())


def test_dist_step_on_card_matches_cpu():
    """Three float32 steps of the fused P = 4 pattern step on one card
    against the CPU (plain versions), from the same seed-99 parameters;
    exactly 3 ring_fwd + 2 ring_bwd launches a partition and step."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params
    from mg_gcn_tpu_torch.nn import adam

    ds = Dataset.load(GOLDEN)
    config = GCNConfig(sizes=(ds.num_features, 16, 16, ds.num_labels))
    losses = {}
    for dev in ("cuda:0", "cpu"):
        mesh = dist.make_mesh(4, [dev] * 4)
        pair = dist.DistPatternPair.from_binary_csr(ds.graph, mesh, dtype="float32")
        xs, ys, masks = dist.shard_dataset(ds, mesh, pair.n_pad)
        params = init_params(config, device=dev)
        params, opt = dist.replicate(params, mesh), dist.replicate(adam.adam_init(params), mesh)
        step = dist.make_dist_train_step(config, mesh, ds.num_nodes, strategy="fused", pair_kind="pattern",
                                         pattern_dtype="float32")
        ring.ring_pattern_fwd.launches.clear()
        ring.ring_pattern_bwd.launches.clear()
        losses[dev] = []
        for _ in range(3):
            params, opt, loss, _ = step(params, opt, pair, xs, ys, masks)
            losses[dev].append(float(loss))
        if dev == "cuda:0":
            assert sum(ring.ring_pattern_fwd.launches.values()) == 3 * 3 * 4
            assert sum(ring.ring_pattern_bwd.launches.values()) == 3 * 2 * 4
    np.testing.assert_allclose(losses["cuda:0"], losses["cpu"], rtol=1e-5)


@pytest.mark.parametrize("strategy", ["fused", "all_gather"])
def test_dist_step_across_cards_equals_one_card(strategy):
    """Three bf16 pattern steps with one partition on each of min(4, cards)
    cards (the slots filled by peer copies) against the same steps with
    every partition on cuda:0: losses and parameters bit for bit."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params
    from mg_gcn_tpu_torch.nn import adam

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two CUDA cards")
    parts = min(4, cards)
    ds = Dataset.load(GOLDEN)
    config = GCNConfig(sizes=(ds.num_features, 16, 16, ds.num_labels))
    runs = []
    for devices in ([f"cuda:{i}" for i in range(parts)], ["cuda:0"] * parts):
        mesh = dist.make_mesh(parts, devices)
        pair = dist.DistPatternPair.from_binary_csr(ds.graph, mesh, dtype="bfloat16")
        xs, ys, masks = dist.shard_dataset(ds, mesh, pair.n_pad)
        params = init_params(config, device="cuda:0")
        params, opt = dist.replicate(params, mesh), dist.replicate(adam.adam_init(params), mesh)
        step = dist.make_dist_train_step(config, mesh, ds.num_nodes, strategy=strategy, pair_kind="pattern",
                                         pattern_dtype="bfloat16")
        losses = []
        for _ in range(3):
            params, opt, loss, _ = step(params, opt, pair, xs, ys, masks)
            losses.append(float(loss))
        runs.append((losses, [v.cpu() for layer in params[0] for v in layer.values()]))
    (losses, leaves), (want_losses, want_leaves) = runs
    assert losses == want_losses
    assert all(torch.equal(a, b) for a, b in zip(leaves, want_leaves))


# ---------------------------------------------------------------------------
# the forward walk (pattern_fwd, ring_fwd): register sums, staged bit tiles,
# row slices


def _fwd_stress_graph(kind):
    """n = 12,288: three 4096-column groups. "gappy": random edges (8 a row),
    rows 256..319 empty (two 32-row spans with no set bit), rows 5 and 4000
    setting every bit of words 0 and 130 (each lane group's 16 owned columns
    full), bit 31 (columns g*4096 + 31*128 + w) in 600 rows, and no edge into
    columns 8192..8447 (bits 0 and 1 of group 2), whose outputs must be 0.
    "dense": random edges and column 4100 set in every row (12,288 terms)."""
    n = 12_288
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)
    if kind == "dense":
        src, dst = np.r_[src, np.arange(n)], np.r_[dst, np.full(n, 4100)]
    else:
        full = np.arange(32) * 128
        src = np.r_[src, np.full(64, 5), np.full(64, 4000), rng.integers(0, n, 600)]
        dst = np.r_[dst, full, 4096 + 2 + full, full, 4096 + 2 + full,
                    rng.integers(0, 3, 600) * 4096 + 31 * 128 + rng.integers(0, 128, 600)]
        keep = ((src < 256) | (src >= 320)) & ((dst < 8192) | (dst >= 8448))
        src, dst = src[keep], dst[keep]
    key = np.unique(src.astype(np.int64) * n + dst)
    indptr = np.r_[0, np.cumsum(np.bincount(key // n, minlength=n))].astype(np.int64)
    return CSRData(indptr, (key % n).astype(np.int32), np.ones(key.size, np.float32), (n, n))


@pytest.mark.parametrize("d_pad", [8, 16, 48, 64, 128, 136, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("kind", ["gappy", "dense"])
def test_forward_walk_stress_matches_plain(kind, dtype, d_pad):
    """pattern_fwd on a three-group pack with an empty 64-row stretch, full
    words, bit 31 and unreached columns (0), or with a column set in every
    row (held to the float64 sum-error bound), at every width class of the
    walk (two lane groups a warp at d_pad <= 64, two feature chunks above
    128); int8 equal."""
    g = _fwd_stress_graph(kind)
    pack = sp.pack_bits_on_device(g, g.nrows, torch.device("cuda"))
    if kind == "gappy":
        assert not bool(pack[256:320].any()) and bool((pack[5, :1] == -1).all()) and bool((pack < 0).any())
    b = _operand(g.nrows, d_pad, dtype, seed=d_pad)
    got = sp.pattern_fwd(pack, b)
    torch.cuda.synchronize()
    if kind == "gappy":
        assert not bool(got[8192:8448].any())
    if dtype == torch.int8 or kind == "gappy":
        _assert_matches_plain(got, sp.pattern_fwd_plain(pack, b, None if dtype == torch.int8 else torch.float64)
                              .to(got.dtype), dtype)
        return
    rows, cols = sp.decode_pattern(pack, 0, g.nrows)
    zero = torch.zeros((g.nrows, d_pad), dtype=torch.float64, device="cuda")
    exact = zero.clone().index_add_(0, cols, b.double().index_select(0, rows))
    mag = zero.index_add_(0, cols, b.double().abs().index_select(0, rows))
    _assert_within_sum_error(got, exact, mag, torch.bincount(cols, minlength=g.nrows).double()[:, None])


@pytest.mark.parametrize("d_pad", [48, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("which", ["pattern", "ring"])
def test_forward_walks_repeat_bit_for_bit(which, dtype, d_pad):
    """Two launches of pattern_fwd / ring_pattern_fwd give the same bits: the
    sum order is fixed (row order in a slice, slices in order) and no
    atomics are used."""
    if which == "pattern":
        g = _fwd_stress_graph("gappy")
        pack = sp.pack_bits_on_device(g, g.nrows, torch.device("cuda"))
        b = _operand(g.nrows, d_pad, dtype, seed=3)
        first, again = sp.pattern_fwd(pack, b), sp.pattern_fwd(pack, b)
    else:
        pair = dist.DistPatternPair.from_binary_csr(_ring_graph(4), dist.make_mesh(4, ["cuda:0"] * 4))
        slots = _operand(4 * pair.m_loc, d_pad, dtype, seed=3).reshape(4, pair.m_loc, d_pad)
        first, again = ring.ring_pattern_fwd(pair.pack_fwd[1], slots), ring.ring_pattern_fwd(pair.pack_fwd[1], slots)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_forward_geometry_fills_the_card():
    """The launcher's geometry: at least 16 resident warps an SM; a small
    pack (48 column blocks) is split into row slices (clusters), a 65,536-
    node pack (256 column blocks at d_pad 128) is not, and both agree with
    the plain version. Rows come in multiples of 4096 (16 tiles of 256) and
    the slice count (1, 2, 4 or 8) divides them."""
    for n, sliced in ((12_288, True), (65_536, False)):
        for d_pad in (48, 128):
            geo = sp.pattern_fwd_geometry(n, d_pad, torch.bfloat16)
            assert geo["blocks_per_sm"] * geo["threads"] // 32 >= 16, geo
            assert geo["grid_x"] == n // 32 // 8 * geo["slices"], geo
        assert (sp.pattern_fwd_geometry(n, 128, torch.bfloat16)["slices"] > 1) == sliced
        g = sparse.random_graph(n, 4, seed=9)
        pack = sp.pack_bits_on_device(g, n, torch.device("cuda"))
        b = _operand(n, 128, torch.int8, seed=1)
        assert torch.equal(sp.pattern_fwd(pack, b), sp.pattern_fwd_plain(pack, b))
    geo = ring.ring_pattern_fwd_geometry(4, 61_440, 48, torch.bfloat16)
    assert geo["slices"] > 1 and geo["blocks_per_sm"] * geo["threads"] // 32 >= 16


# ---------------------------------------------------------------------------
# the backward walk (pattern_bwd, ring_bwd): the pack streamed by cp.async,
# a span's bits listed at once, lane groups sized to the row


def _bwd_stress_graph(n, full_row=7):
    """n nodes: 8 random columns a row, rows 256..319 empty, bit 31 (columns
    g*4096 + 31*128 + w) in every tenth row, and row ``full_row`` with every
    column set: n set bits, many times what a warp's list holds."""
    rng = np.random.default_rng(11)
    cols = [np.unique(rng.integers(0, n, 8)) for _ in range(n)]
    for r in range(0, n, 10):
        cols[r] = np.union1d(cols[r], [(r // 10) % (n // 4096) * 4096 + 31 * 128 + r % 128])
    for r in range(256, 320):
        cols[r] = cols[r][:0]
    cols[full_row] = np.arange(n)
    indptr = np.r_[0, np.cumsum([c.size for c in cols])].astype(np.int64)
    return CSRData(indptr, np.concatenate(cols).astype(np.int32), np.ones(indptr[-1], np.float32), (n, n))


def _assert_bwd_follows_twin(got, pack, b, deg, twin, plain):
    """int8 and bf16 equal to the kernel's twin bit for bit; float32 within
    the float32 sum bound of the float64 sum (``plain`` summed in float64)."""
    if b.dtype == torch.float32:
        _assert_within_sum_error(got, plain(pack, b, torch.float64), plain(pack, b.abs(), torch.float64), deg)
    else:
        assert torch.equal(got, twin(pack, b))


@pytest.mark.parametrize("d_pad", [8, 16, 48, 64, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_pattern_bwd_follows_the_twin(dtype, d_pad):
    """pattern_bwd on a 12,288-node pack (three 128-word blocks a row, so its
    last span is half zeros) with a full row, empty rows and bit 31, at
    every lane-group size: int8 and bf16 equal to pattern_bwd_groups_plain,
    float32 within the float32 sum bound; two launches equal bit for bit;
    empty rows 0."""
    g = _bwd_stress_graph(12_288)
    pack = sp.pack_bits_on_device(g, g.nrows, torch.device("cuda"))
    assert bool((pack < 0).any()) and bool((pack[7] == -1).all())
    b = _operand(g.nrows, d_pad, dtype, seed=d_pad)
    got, again = sp.pattern_bwd(pack, b), sp.pattern_bwd(pack, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert not bool(got[256:320].any())
    deg = torch.from_numpy(np.diff(g.indptr)).cuda().double()[:, None]
    _assert_bwd_follows_twin(got, pack, b, deg, sp.pattern_bwd_groups_plain, sp.pattern_bwd_plain)


@pytest.mark.parametrize("d_pad", [8, 16, 48, 64, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("parts", [1, 2, 4])
def test_ring_bwd_follows_the_twin(parts, dtype, d_pad):
    """ring_bwd for every partition of P slabs of 4,096 rows (one 128-word
    block a round, so a span holds two rounds' words) with a full row (P
    rounds of set bits), bit 31, empty rows and 100 padded rows (0): int8
    and bf16 equal to ring_pattern_bwd_groups_plain, float32 within the
    float32 sum bound; two launches equal bit for bit."""
    n = parts * 4096 - 100
    full = _bwd_stress_graph(parts * 4096)
    rows = np.repeat(np.arange(full.nrows), np.diff(full.indptr))
    keep = (rows < n) & (full.indices < n)
    indptr = np.r_[0, np.cumsum(np.bincount(rows[keep], minlength=n))].astype(np.int64)
    g = CSRData(indptr, full.indices[keep], full.data[keep], (n, n))
    pair = dist.DistPatternPair.from_binary_csr(g, dist.make_mesh(parts, ["cuda:0"] * parts))
    m = pair.m_loc
    deg = torch.zeros(parts * m, dtype=torch.float64, device="cuda")
    deg[:n] = torch.from_numpy(np.diff(g.indptr)).cuda().double()
    for j in range(parts):
        pack = pair.pack_bwd[j]
        slots = _operand(parts * m, d_pad, dtype, seed=j).reshape(parts, m, d_pad)
        got, again = ring.ring_pattern_bwd(pack, slots), ring.ring_pattern_bwd(pack, slots)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_bwd_follows_twin(got, pack, slots, deg[j * m:(j + 1) * m, None], ring.ring_pattern_bwd_groups_plain,
                                 ring.ring_pattern_bwd_plain)
        if j == 0:
            assert not bool(got[256:320].any())
        if j == parts - 1:
            assert not bool(got[m - 100:].any())


@pytest.mark.parametrize("d_pad", [8, 16, 48, 64, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_backward_geometry_follows_the_rule(dtype, d_pad):
    """The launch geometry of both backward kernels: lanes, groups and
    features by spmm_pattern.pattern_bwd_split, grid y = the split's chunks,
    blocks of 256 threads (a warp a row), rows / 8 of them in x, or with one
    group (32 lanes) one wave of them (the resident blocks over the SMs and
    the chunks) and, for the one-round pack, column windows by the L2's
    size; at least 16 resident warps an SM; a launch after the query still
    runs."""
    rule = sp.pattern_bwd_split(d_pad, dtype)
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    # one group and one round: column windows of whole 4096-column groups whose
    # B rows (a chunk's features) fill at most half the L2
    group_bytes = 4096 * min(d_pad, 32 * rule["features"]) * torch.empty((), dtype=dtype).element_size()
    window_words = props.L2_cache_size // 2 // group_bytes * 128
    windows = -(-233_472 // 32 // window_words) if rule["lanes"] == 32 and window_words < 233_472 // 32 else 1
    assert sp.pattern_bwd_geometry(233_472, d_pad, dtype)["windows"] == windows
    assert ring.ring_pattern_bwd_geometry(4, 61_440, d_pad, dtype)["windows"] == 1
    for geo, rows in ((sp.pattern_bwd_geometry(233_472, d_pad, dtype), 233_472),
                      (ring.ring_pattern_bwd_geometry(4, 61_440, d_pad, dtype), 61_440)):
        assert {k: geo[k] for k in ("lanes", "groups", "features")} == {k: rule[k] for k in ("lanes", "groups",
                                                                                         "features")}, geo
        blocks = rows // 8
        if rule["lanes"] == 32:
            blocks = min(blocks, geo["blocks_per_sm"] * sms // rule["chunks"])
        assert (geo["grid_x"], geo["grid_y"], geo["threads"]) == (blocks, rule["chunks"], 256), geo
        assert geo["resident_blocks"] == min(blocks * rule["chunks"], geo["blocks_per_sm"] * sms), geo
        assert geo["blocks_per_sm"] * geo["threads"] // 32 >= 16, geo
        assert geo["stages"] >= 3 and geo["loads"] >= 4 and geo["smem"] > 0, geo
    g = sparse.random_graph(4096, 8, seed=2)
    pack = sp.pack_bits_on_device(g, 4096, torch.device("cuda"))
    b = _operand(4096, d_pad, dtype, seed=1)
    _assert_matches_plain(sp.pattern_bwd(pack, b), sp.pattern_bwd_plain(pack, b), dtype)


@pytest.mark.parametrize("dtype,d_pad", [(torch.bfloat16, 264), (torch.float32, 256), (torch.float32, 512),
                                         (torch.float32, 608), (torch.bfloat16, 608), (torch.int8, 608)])
def test_pattern_bwd_column_windows_keep_the_order(dtype, d_pad):
    """With one group and B rows past half the L2 (65,536 nodes, chunks of
    256 bf16 or 128 float32 features: 32 MB a chunk; SAGE's widths 512 and
    608 walk 4-5 chunks in the one wave), pattern_bwd's one
    cooperative launch walks column windows in turn, a grid-wide barrier
    between two, each going on from the sums the one before stored: bf16 still equal to pattern_bwd_groups_plain bit for
    bit, float32 within the float32 sum bound; two launches equal."""
    n = 65_536
    g = sparse.random_graph(n, 8, seed=6)
    pack = sp.pack_bits_on_device(g, n, torch.device("cuda"))
    geo = sp.pattern_bwd_geometry(n, d_pad, dtype)
    assert geo["lanes"] == 32 and geo["windows"] >= 2, geo
    b = _operand(n, d_pad, dtype, seed=3)
    got, again = sp.pattern_bwd(pack, b), sp.pattern_bwd(pack, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    deg = torch.from_numpy(np.diff(g.indptr)).cuda().double()[:, None]
    _assert_bwd_follows_twin(got, pack, b, deg, sp.pattern_bwd_groups_plain, sp.pattern_bwd_plain)


# ---------------------------------------------------------------------------
# block_bwd on the backward walk: the tile store as the walk's word source


def _block_bwd_graph():
    """12,288 nodes (three groups), clustered: about 6 columns a row within
    ±600 of the diagonal, bit 31 (column g*4096 + 31*128 + w of the row's
    own group) in every tenth row, row 7 with every column (12,288 set bits
    over three tiles, many times what a warp's list holds), rows 200-249 and
    the row block 4096-4607 empty, and rows 9500-9599 with columns in group
    0 as well, so that their row blocks' tiles are groups 0 and 2."""
    rng = np.random.default_rng(12)
    n = 12_288
    cols = []
    for i in range(n):
        c = np.unique(np.clip(i + rng.integers(-600, 601, 6), 0, n - 1))
        if i % 10 == 0:
            c = np.union1d(c, [(i // 4096) * 4096 + 31 * 128 + i % 128])
        if 9500 <= i < 9600:
            c = np.union1d(c, rng.integers(0, 4096, 3))
        cols.append(c)
    cols[7] = np.arange(n)
    for r in [*range(200, 250), *range(4096, 4608)]:
        cols[r] = cols[r][:0]
    indptr = np.r_[0, np.cumsum([c.size for c in cols])].astype(np.int64)
    return CSRData(indptr, np.concatenate(cols).astype(np.int32), np.ones(indptr[-1], np.float32), (n, n))


@pytest.fixture(scope="module")
def block_bwd_graph():
    return _block_bwd_graph()


@pytest.mark.parametrize("d_pad", [8, 16, 48, 128, 264])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("tile_r", [128, 512])
def test_block_bwd_follows_the_twin(block_bwd_graph, tile_r, dtype, d_pad):
    """block_bwd over a store with a full row, bit 31, an empty row block
    and a row block whose tiles are groups 0 and 2, at every lane-group size
    and more than one feature chunk (d_pad 264: two in bf16 and int8, three
    in float32): int8 and bf16 equal to block_bwd_groups_plain, float32 within the
    float32 sum bound; two launches equal bit for bit, each one launch;
    empty rows and the empty row block 0."""
    g = block_bwd_graph
    mat = sps.block_pattern_pair_from_binary_csr(g, device="cuda", tile_r=tile_r)[1]
    rb_ptr, tile_g = mat.rb_ptr.tolist(), mat.tile_g.tolist()
    assert rb_ptr[4096 // tile_r] == rb_ptr[4096 // tile_r + 1]
    assert tile_g[rb_ptr[9500 // tile_r]:rb_ptr[9500 // tile_r + 1]] == [0, 2]
    b = _operand(mat.n_pad, d_pad, dtype, seed=d_pad)
    key = (str(dtype).removeprefix("torch."), d_pad)
    before = sps.block_bwd.launches[key]
    got, again = sps.block_bwd(mat, b), sps.block_bwd(mat, b)
    torch.cuda.synchronize()
    assert sps.block_bwd.launches[key] == before + 2
    assert torch.equal(got, again)
    assert not bool(got[200:250].any()) and not bool(got[4096:4608].any())
    deg = torch.from_numpy(np.diff(g.indptr)).cuda().double()[:, None]
    _assert_bwd_follows_twin(got, mat, b, deg, sps.block_bwd_groups_plain, sps.block_bwd_plain)


@pytest.mark.parametrize("d_pad", [8, 16, 48, 64, 128, 200, 264])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_block_bwd_geometry_follows_the_rule(dtype, d_pad):
    """block_bwd's launch geometry at the banded path's n_pad: lanes, groups
    and features by block_bwd_split, grid y = the split's chunks, blocks of
    256 threads (a warp a row), n_pad / 8 of them at every split (the
    regular grid, one group too), one column window; at least 16 resident
    warps an SM. A launch after the query still runs, and a width the
    kernel refuses is refused by the query too."""
    rule = sps.block_bwd_split(d_pad, dtype)
    geo = sps.block_bwd_geometry(233_472, 512, d_pad, dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert {k: geo[k] for k in ("lanes", "groups", "features")} == {k: rule[k] for k in ("lanes", "groups",
                                                                                     "features")}, geo
    assert (geo["grid_x"], geo["grid_y"], geo["threads"], geo["windows"]) == (233_472 // 8, rule["chunks"], 256,
                                                                             1), geo
    assert geo["resident_blocks"] == min(geo["grid_x"] * geo["grid_y"], geo["blocks_per_sm"] * sms), geo
    assert geo["blocks_per_sm"] * geo["threads"] // 32 >= 16, geo
    assert geo["stages"] >= 3 and geo["loads"] >= 4 and geo["smem"] > 0, geo
    mat = sps.block_pattern_pair_from_binary_csr(sparse.banded_graph(9000, 40, 700, seed=2), device="cuda")[1]
    _assert_block_matches_plain(mat, "bwd", _operand(mat.n_pad, d_pad, dtype, seed=1))
    with pytest.raises(RuntimeError, match="mggcn_block_bwd_geometry"):
        sps.block_bwd_geometry(233_472, 512, d_pad + 4, dtype)


# ---------------------------------------------------------------------------
# SAGE and PageRank: the pattern walks at d = 1, 512 and 608, the binary
# gather walk pre-scaled at d = 1, and the models on the card against the CPU


@pytest.mark.parametrize("d", [1, 512, 608])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_pattern_kernels_at_sage_and_pagerank_widths(graph, which, dtype, d):
    """pattern_fwd / pattern_bwd at PageRank's d = 1 (d_pad 8) and SAGE's
    512 and 608: float within the float32 sum bound of the float64 sum, int8
    equal; pattern_bwd's bf16 and int8 bit for bit its twin; two launches
    equal; one count a launch."""
    n_pad = sp.round_up(graph.nrows, sp.N_ALIGN)
    pack = sp.pack_bits_on_device(graph, n_pad, torch.device("cuda"))
    b = torch.zeros((n_pad, sp.round_up(d, 8)), device="cuda", dtype=dtype)
    b[:, :d] = _operand(n_pad, d, dtype, seed=d)
    kernel, plain = (sp.pattern_fwd, sp.pattern_fwd_plain) if which == "fwd" else (sp.pattern_bwd, sp.pattern_bwd_plain)
    key = (str(dtype).removeprefix("torch."), b.shape[1])
    before = kernel.launches[key]
    got, again = kernel(pack, b), kernel(pack, b)
    torch.cuda.synchronize()
    assert kernel.launches[key] == before + 2 and torch.equal(got, again)
    rows, cols = sp.decode_pattern(pack, 0, n_pad)
    dst = cols if which == "fwd" else rows
    deg = torch.bincount(dst, minlength=n_pad).double()[:, None]
    if which == "bwd":
        _assert_bwd_follows_twin(got, pack, b, deg, sp.pattern_bwd_groups_plain, sp.pattern_bwd_plain)
    elif dtype == torch.int8:
        assert torch.equal(got, plain(pack, b))
    else:
        _assert_within_sum_error(got, plain(pack, b, torch.float64), plain(pack, b.abs(), torch.float64), deg)


def test_gather_binary_prescaled_at_d1(hub_graph):
    """PageRank's products-scale operator: the binary walk over Aᵀ with a
    pre-scale of 1/max(outdeg, 1), float32 at d = 1 (d_pad 8), on the hub
    graph's pattern (a column in every row, empty rows) on the card against
    the CPU; the raw launch within the float32 sum bound."""
    from mg_gcn_tpu_torch.models import pagerank as pr
    from mg_gcn_tpu_torch.ops.spmm import spmm

    g = CSRData(hub_graph.indptr, hub_graph.indices, np.ones_like(hub_graph.data), hub_graph.shape)
    mat_gpu = pr._pagerank_mat(g, "gather", device="cuda")
    mat_cpu = pr._pagerank_mat(g, "gather", device="cpu")
    assert not mat_gpu.has_w and mat_gpu.scale_side == "pre"
    p = torch.from_numpy(np.random.default_rng(2).random((g.nrows, 1)).astype(np.float32))
    torch.testing.assert_close(spmm(mat_gpu, p.cuda()).cpu(), spmm(mat_cpu, p), rtol=1e-5, atol=1e-6)
    b = torch.zeros((g.nrows, 8), device="cuda")
    b[:, 0] = p[:, 0].cuda() * mat_gpu.scale
    before = sg.gather.launches[("float32", 8)]
    got = sg.gather(mat_gpu.indptr, mat_gpu.indices, None, b)
    torch.cuda.synchronize()
    assert sg.gather.launches[("float32", 8)] == before + 1
    deg = torch.diff(mat_gpu.indptr).double()[:, None]
    exact = se.csr_plain(mat_gpu.indptr, mat_gpu.indices, None, b, torch.float64)
    mag = se.csr_plain(mat_gpu.indptr, mat_gpu.indices, None, b.abs(), torch.float64)
    _assert_within_sum_error(got, exact, mag, deg)


@pytest.mark.parametrize("impl", ["pattern", "edge", "gather"])
def test_sage_step_on_card_matches_cpu(impl):
    """One float32 SAGE step (608-wide-style two layers on a small graph,
    l2-normalized) on the card against the port's CPU step from the same
    seed-99 parameters: loss within rtol 1e-5, every gradient leaf within
    ||card - CPU|| <= 1e-4 ||CPU||; the Adam step's loss too."""
    from mg_gcn_tpu_torch.models import sage
    from mg_gcn_tpu_torch.nn import adam

    ds = Dataset.load(GOLDEN)
    config = sage.SAGEConfig(sizes=(ds.num_features, 512, ds.num_labels))
    out = {}
    for dev in ("cpu", "cuda"):
        pair = sage.build_sage_pair(ds.graph, impl=impl, dtype="float32", device=dev)
        params = sage.init_params(config, device=dev)
        x = torch.from_numpy(ds.features).to(dev)
        y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).to(dev)
        out[dev] = sage.loss_and_grad(params, pair, x, y, config)
        step = make_train_step(config, model="sage")
        _, _, loss2, _ = step(params, adam.adam_init(params), pair, x, y, None)
        out[dev + " step"] = float(loss2)
    (lc, _, gc), (lg, _, gg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    np.testing.assert_allclose(out["cuda step"], out["cpu step"], rtol=1e-5)
    for layer_c, layer_g in zip(gc, gg):
        for k in layer_c:
            diff = torch.linalg.vector_norm(layer_g[k].cpu() - layer_c[k])
            assert diff <= 1e-4 * torch.linalg.vector_norm(layer_c[k]), k


def test_sage_auto_takes_the_pattern_pair_on_the_card():
    from mg_gcn_tpu_torch.models import sage

    assert isinstance(sage.build_sage_pair(sparse.random_graph(5000, 16, seed=4), device="cuda").fwd, sp.PatternMat)


@pytest.mark.parametrize("impl", ["auto", "pattern", "gather", "edge", "xla"])
def test_pagerank_on_card_matches_cpu(impl):
    """PageRank on the card against the CPU (the JAX tests' tolerance, rtol
    1e-4 / atol 1e-5); the pattern operator's launches are one float32
    d_pad 8 pattern_fwd an iteration."""
    from mg_gcn_tpu_torch.models import pagerank as pr

    g = sparse.random_graph(5000, 16, seed=4)
    before = sp.pattern_fwd.launches[("float32", 8)]
    mat = pr._pagerank_mat(g, impl, device="cuda")
    p_gpu, iters = pr.power_iterate(mat, g.nrows)
    p_cpu, _ = pr.power_iterate(pr._pagerank_mat(g, "xla", device="cpu"), g.nrows)
    np.testing.assert_allclose(p_gpu.cpu().numpy(), p_cpu.numpy(), rtol=1e-4, atol=1e-5)
    if impl in ("auto", "pattern"):
        assert isinstance(mat, sp.PatternMat)
        assert sp.pattern_fwd.launches[("float32", 8)] == before + iters
    got = pr.pagerank(g, impl=impl, device="cuda")
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), pr.pagerank(g, device="cpu").numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("strategy", ["ring", "all_gather"])
def test_pagerank_dist_on_card_matches_cpu(strategy):
    from mg_gcn_tpu_torch.models import pagerank as pr

    g = sparse.random_graph(5000, 16, seed=4)
    got = pr.pagerank_dist(g, dist.make_mesh(4, ["cuda:0"] * 4), strategy=strategy)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), pr.pagerank(g, device="cpu").numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the halo exchange and the serial-gather ring (parallel/dist_halo.py,
# dist.DistGatherPair): the gather kernel at rectangular halo-block shapes


def _halo_graph(kind):
    """A weighted graph over 4 slabs of 3,000 rows. "banded" (± 375 rows):
    halo blocks far narrower than the slab, and rounds that are empty on
    every partition; "random" (32 a row): halo blocks nearly as wide as the
    slab."""
    n = 4 * 3000
    if kind == "banded":
        g = sparse.banded_graph(n, 8, 375, seed=6)
    else:
        g = sparse.random_graph(n, 32, seed=6)
    w = np.random.default_rng(7).random(g.nnz, np.float32) + 0.5
    return sparse.normalize(CSRData(g.indptr, g.indices, w, g.shape), axis=True)


@pytest.mark.parametrize("d_pad", [8, 48, 104, 256])
@pytest.mark.parametrize("kind", ["banded", "random"])
def test_gather_at_halo_shapes_matches_plain(kind, d_pad):
    """Every block of a DistHaloGatherMat at P = 4 on one card (the diagonal
    m_loc × m_loc, each round's m_loc × w_s; w_s ≪ m_loc on the banded graph,
    ≈ m_loc on the random one, empty rounds launched too): the weighted
    float32 walk against its plain version summed in float64 within rtol 1e-5 /
    atol 1e-6 of the output's scale, two launches equal bit for bit, one
    launch counted each."""
    from mg_gcn_tpu_torch.parallel import dist_halo

    a = _halo_graph(kind)
    mat = dist_halo.DistHaloGatherMat.from_csr(a, dist.make_mesh(4, ["cuda:0"] * 4))
    widths = set(mat.round_widths)
    assert (max(widths) <= 1024) if kind == "banded" else (min(widths) > 2500)
    key = ("float32", d_pad)
    for j in range(4):
        for blk in [mat.loc[j], *mat.rem[j]]:
            assert blk.has_w and (blk.indices.numel() == 0 or int(blk.indices.max()) < blk.n_in)
            b = _operand(blk.n_in, d_pad, torch.float32, seed=j + d_pad)
            before = sg.gather.launches[key]
            got = sg.gather(blk.indptr, blk.indices, blk.w, b)
            again = sg.gather(blk.indptr, blk.indices, blk.w, b)
            torch.cuda.synchronize()
            assert sg.gather.launches[key] == before + 2 and got.shape == (blk.n_out, d_pad)
            assert torch.equal(got, again)
            want = se.csr_plain(blk.indptr, blk.indices, blk.w, b, torch.float64)
            torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6 * max(float(want.abs().max()), 1e-30))
            if blk.nnz == 0:
                assert not got.any()


@pytest.mark.parametrize("kind", ["halo_gather", "gather", "halo"])
def test_dist_gcn_step_on_card_matches_cpu(kind):
    """Three float32 steps at P = 4 on one card against the CPU (plain
    versions), parity mode, on the banded halo graph: losses within rtol
    1e-5; exactly 5 SpMMs x 4 partitions x 4 blocks = 80 gather launches a
    step on the kernel pairs (empty blocks launched), none on halo's COO."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params
    from mg_gcn_tpu_torch.nn import adam

    a = _halo_graph("banded")
    n = a.nrows
    rng = np.random.default_rng(8)
    x, y = rng.standard_normal((n, 12)).astype(np.float32), rng.integers(0, 5, n)
    config = GCNConfig(sizes=(12, 16, 16, 5))
    losses = {}
    for dev in ("cuda:0", "cpu"):
        mesh = dist.make_mesh(4, [dev] * 4)
        pair = dist.build_pair(kind, sparse.transpose(a), a, mesh)
        params = init_params(config, device=dev)
        params, opt = dist.replicate(params, mesh), dist.replicate(adam.adam_init(params), mesh)
        step = dist.make_dist_train_step(config, mesh, n, pair_kind=kind)
        sg.gather.launches.clear()
        losses[dev] = []
        for _ in range(3):
            params, opt, loss, _ = step(params, opt, pair, dist.shard(x, mesh), dist.shard(y, mesh))
            losses[dev].append(float(loss))
        if dev == "cuda:0":
            assert sum(sg.gather.launches.values()) == (0 if kind == "halo" else 3 * 80)
    np.testing.assert_allclose(losses["cuda:0"], losses["cpu"], rtol=1e-5)


@pytest.mark.parametrize("kind", ["coo", "halo", "gather", "halo_gather"])
def test_dist_sage_step_on_card_matches_cpu(kind):
    """SAGE's loss and exact gradients at P = 4 on one card against the CPU
    (d = 512 hidden, l2-normalized, the banded halo graph's mean pair):
    loss within rtol 1e-5, every gradient leaf within 1e-4 of its norm;
    gather launches 3 SpMMs x 4 x 4 = 48 on the kernel pairs."""
    from mg_gcn_tpu_torch.models import sage

    g = _halo_graph("banded")
    m = sparse.normalize(CSRData(g.indptr, g.indices, np.ones_like(g.data), g.shape), axis=False)
    n = g.nrows
    rng = np.random.default_rng(9)
    x, y = rng.standard_normal((n, 24)).astype(np.float32), rng.integers(0, 5, n)
    config = sage.SAGEConfig(sizes=(24, 512, 5))
    out = {}
    for dev in ("cuda:0", "cpu"):
        mesh = dist.make_mesh(4, [dev] * 4)
        pair = dist.build_pair(kind, m, sparse.transpose(m), mesh)
        params = sage.init_params(config, device=dev)
        sg.gather.launches.clear()
        out[dev] = dist.dist_sage_loss_and_grad([params] * 4, dist.sage_aggregation(kind, pair), dist.shard(x, mesh),
                                                dist.shard(y, mesh), config, n, mesh=mesh)
        if dev == "cuda:0":
            assert sum(sg.gather.launches.values()) == (48 if kind in ("gather", "halo_gather") else 0)
    (lg, _, gg), (lc, _, gc) = out["cuda:0"], out["cpu"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    for layer_g, layer_c in zip(gg, gc):
        for k in layer_c:
            assert torch.linalg.vector_norm(layer_g[k].cpu() - layer_c[k]) <= 1e-4 * torch.linalg.vector_norm(
                layer_c[k]), k


def _phase_events(config, impl, tmp_path):
    """One warm and two traced steps of ``config`` on the golden dataset
    through ``diagnostics.profile_fused_step``: (phase totals, [(phase,
    device event)])."""
    import json

    from mg_gcn_tpu_torch import diagnostics, xplane
    from mg_gcn_tpu_torch.models.gcn import init_params
    from mg_gcn_tpu_torch.nn import adam

    ds = Dataset.load(GOLDEN)
    pair = build_agg_pair(ds.graph, impl=impl, pattern_dtype="bfloat16", device="cuda")
    params = init_params(config, device="cuda")
    x = torch.from_numpy(ds.features).cuda()
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64)).cuda()
    timers, _, _ = diagnostics.profile_fused_step(make_train_step(config), (params, adam.adam_init(params), pair, x, y,
                                                  None), epochs=2, trace_dir=str(tmp_path))
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    return dict(timers._entries), xplane.attribute(events)


def test_phase_attribution_parity_step_on_card(tmp_path):
    """The parity step on the pattern pair: every pattern kernel launched
    from ctypes is credited, through its launch's correlation id, to the
    SpMM scope that launched it (two traced epochs: each forward scope 2
    ``pattern_fwd`` events, each backward one 2 ``pattern_bwd``), none is
    unattributed, and every phase key holds device time."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig

    ds = Dataset.load(GOLDEN)
    config = GCNConfig(sizes=(ds.num_features, 32, 16, ds.num_labels))
    totals, attributed = _phase_events(config, "pattern", tmp_path)
    seen = {}
    for phase, e in attributed:
        kind = "fwd" if "pattern_fwd_kernel" in e["name"] else "bwd" if "PackArgs" in e["name"] else None
        if kind:
            seen[(phase, kind)] = seen.get((phase, kind), 0) + 1
    want = {(f"{i}_0_matmul-spmm", "fwd"): 2 for i in range(3)} | {(f"{i}_1_matmul-spmm", "bwd"): 2 for i in (1, 2)}
    assert seen == want
    assert all(ms > 0 for ms in totals.values())
    assert {"phase_adam-update", "phase_3_loss-layer", "phase_0_1_matmul-gemm"} <= set(totals)


def test_phase_attribution_exact_step_on_card(tmp_path):
    """The exact (autograd) step: the forward's pattern kernels go to their
    scopes, the backward's (launched from autograd's thread, outside every
    scope) to ``unattributed`` — the port's rule (ROADMAP)."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig

    ds = Dataset.load(GOLDEN)
    config = GCNConfig(sizes=(ds.num_features, 32, ds.num_labels), parity=False)
    totals, attributed = _phase_events(config, "pattern", tmp_path)
    fwd = {p for p, e in attributed if "pattern_fwd_kernel" in e["name"]}
    bwd = [p for p, e in attributed if "PackArgs" in e["name"]]
    assert fwd == {"0_0_matmul-spmm", "1_0_matmul-spmm"}
    assert bwd and set(bwd) == {"unattributed"}
    assert not [k for k in totals if k.split("_")[2:3] == ["1"]]  # no backward phase key


def test_f64_step_on_card_matches_cpu():
    """``train(f64=True)`` on the card (the COO engine's index_add_ in
    float64) against the CPU: losses within 1e-12 relative, no kernel of
    the port launched."""
    ds = Dataset.load(GOLDEN)
    before = {k: dict(fn.launches) for k, fn in (("fwd", sp.pattern_fwd), ("gather", sg.gather))}
    card = train(ds, [16, 16], epochs=3, f64=True, device="cuda", log=False)
    cpu = train(ds, [16, 16], epochs=3, f64=True, device="cpu", log=False)
    assert card.engine == "xla" and card.params[0]["W"].dtype == torch.float64
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-12)
    assert {k: dict(fn.launches) for k, fn in (("fwd", sp.pattern_fwd), ("gather", sg.gather))} == before


# ---------------------------------------------------------------------------
# the distributed GAT and the column path (four partitions on one card)


def _gat_launches(config, graph) -> dict:
    """{(kernel, d_pad): launches} of one dist GAT step: per head, layer and
    block with entries, forward 4 sddmm (scores d = 2, two shifts and the
    log row sums d = 1) and 3 edge (rs1, rowsum d = 1, aggregation d =
    out); backward 2 sddmm (d = out, d = 1), 2 edge (d = 1, d = 2) and 2
    edge_t (d = 2, d = out). An empty block launches nothing."""
    live = sum(nnz > 0 for row in graph.block_nnz for nnz in row)
    want = {}
    for i in range(config.num_layers):
        wide = sp.round_up(max(config.sizes[i + 1], 8), 8)
        for name, narrow, n_wide in (("sddmm", 5, 1), ("edge", 4, 1), ("edge_t", 1, 1)):
            for d_pad, k in ((8, narrow), (wide, n_wide)):
                want[(name, d_pad)] = want.get((name, d_pad), 0) + k * config.heads * live
    return want


def test_dist_gat_step_on_card_matches_cpu():
    """One float32 dist GAT step at P = 4 on one card (two layers, two
    heads) against the CPU on a banded graph whose far blocks are empty:
    loss within rtol 1e-5, every gradient leaf within 1e-4 of its norm;
    exactly :func:`_gat_launches` launches by width, the empty blocks none."""
    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.parallel import dist_gat

    n = 8192
    g = sparse.banded_graph(n, 16, n // 8, 3)
    rng = np.random.default_rng(11)
    x, y = rng.standard_normal((n, 12)).astype(np.float32), rng.integers(0, 5, n)
    config = gat.GATConfig(sizes=(12, 16, 5), heads=2)
    out = {}
    for dev in ("cuda:0", "cpu"):
        mesh = dist.make_mesh(4, [dev] * 4)
        graph = dist_gat.build_dist_gat_graph(g, mesh, dtype="float32")
        params = gat.init_params(config, 4, device=dev)
        for fn in (sd.sddmm, se.edge, se.edge_t):
            fn.launches.clear()
        out[dev] = dist_gat.dist_gat_loss_and_grad([params] * 4, graph, dist.shard(x, mesh), dist.shard(y, mesh),
                                                   config)
        if dev == "cuda:0":
            torch.cuda.synchronize()
            assert any(nnz == 0 for row in graph.block_nnz for nnz in row)
            got = {(name, d_pad): v for name, fn in (("sddmm", sd.sddmm), ("edge", se.edge), ("edge_t", se.edge_t))
                   for (dt, d_pad), v in fn.launches.items()}
            assert got == _gat_launches(config, graph)
    (lg, _, gg), (lc, _, gc) = out["cuda:0"], out["cpu"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    for layer_g, layer_c in zip(gg, gc):
        for k in layer_c:
            assert torch.linalg.vector_norm(layer_g[k].cpu() - layer_c[k]) <= 1e-4 * torch.linalg.vector_norm(
                layer_c[k]), k


def test_attention_ops_on_an_empty_block_launch_nothing():
    """An attention block with no entry on the card: the SDDMM scores
    nothing, both products give zeros, and no kernel launches."""
    from mg_gcn_tpu_torch.ops import edge_attention as ea
    from mg_gcn_tpu_torch.parallel import dist_gat

    rows = torch.zeros(0, dtype=torch.int64, device="cuda")
    mat, sched = dist_gat.attention_block(rows, rows, 300, 200, "bfloat16")
    before = {fn: dict(fn.launches) for fn in (sd.sddmm, se.edge, se.edge_t)}
    a, b = torch.randn(300, 41, device="cuda"), torch.randn(200, 41, device="cuda")
    w = torch.zeros(0, device="cuda")
    scores = ea.sddmm(mat, sched, a, b)
    prod = ea.spmm_attn(mat, sched, w, b)
    prod_t = se.spmm_edge_tiles_t(mat, sched, a, w_slots=w)
    torch.cuda.synchronize()
    assert scores.shape == (0,) and prod.shape == (300, 41) and prod_t.shape == (200, 41)
    assert not bool(prod.any()) and not bool(prod_t.any())
    assert {fn: dict(fn.launches) for fn in (sd.sddmm, se.edge, se.edge_t)} == before


def test_column_step_on_card_matches_cpu():
    """Three float32 column steps at P = 4 on one card (the COO engine, Âᵀ
    held once on it) against the CPU: losses within rtol 1e-5; the first
    step's gradients within 1e-4 of their norms."""
    from mg_gcn_tpu_torch.models.gcn import GCNConfig, init_params
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.ops.spmm import COOMat
    from mg_gcn_tpu_torch.parallel import dist_col

    ds = Dataset.load(GOLDEN)
    a_t = sparse.transpose(sparse.normalize(ds.graph, axis=True))
    config = GCNConfig(sizes=(16, 32, 32, 8), parity=False)
    y = torch.from_numpy(ds.labels.reshape(-1).astype(np.int64))
    out = {}
    for dev in ("cuda:0", "cpu"):
        mesh = dist_col.make_col_mesh(4, [dev] * 4)
        mats = dist_col.replicate_coo(COOMat.from_csr(a_t, device=dev), mesh)
        xs, ys = dist_col.shard_columns(ds.features, mesh), [y.to(dev)] * 4
        params = dist_col.shard_col_params(init_params(config, device=dev), mesh)
        out[dev] = dist_col.col_loss_and_grad(params, mats, xs, ys, config, ds.num_nodes, mesh)
        out[dev + " mesh"] = mesh
        state = dist_col.shard_col_state(adam.adam_init(init_params(config, device=dev)), mesh)
        step, losses = dist_col.make_col_train_step(config, mesh, ds.num_nodes), []
        for _ in range(3):
            params, state, loss, _ = step(params, state, mats, xs, ys)
            losses.append(float(loss))
        out[dev + " losses"] = losses
    np.testing.assert_allclose(out["cuda:0 losses"], out["cpu losses"], rtol=1e-5)
    gg, gc = (dist_col.gather_col_params(out[d][2], out[d + " mesh"]) for d in ("cuda:0", "cpu"))
    for layer_g, layer_c in zip(gg, gc):
        for k in layer_c:
            assert torch.linalg.vector_norm(layer_g[k].cpu() - layer_c[k]) <= 1e-4 * torch.linalg.vector_norm(
                layer_c[k]), k


# ---------------------------------------------------------------------------
# the multi-epoch step: train.make_scan_train_steps as a replayed CUDA graph


def _scan_case(case: str, seed: int = 4, device: str = "cuda"):
    """(config, model, pair, x, y, params) of a small step: GCN on the
    pattern pair (bf16, int8; float32 in the exact mode) and on ``tiled``,
    SAGE on the pattern pair (bf16), GAT (bf16, 2 heads), DeeperGCN (bf16,
    4 layers of 32)."""
    from mg_gcn_tpu_torch.models import gat, gcn, sage

    n, classes = 3000, 7
    g = sparse.random_graph(n, 12, seed=seed)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, 24)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, classes, n)).to(device)
    if case == "sage":
        config = sage.SAGEConfig(sizes=(24, 32, classes))
        return config, "sage", sage.build_sage_pair(g, impl="pattern", dtype="bfloat16", device=device), x, y, \
            sage.init_params(config, device=device)
    if case == "gat":
        config = gat.GATConfig(sizes=(24, 16, classes), heads=2)
        return config, "gat", gat.build_gat_graph(g, dtype="bfloat16", device=device), x, y, \
            gat.init_params(config, None, device=device)
    if case == "deepergcn":
        from mg_gcn_tpu_torch.models import deepergcn

        config = deepergcn.DeeperGCNConfig(sizes=(24, 32, classes), layers=4)
        return config, "deepergcn", deepergcn.build_deepergcn_graph(g, device=device), x, y, \
            deepergcn.init_params(config, 2, device=device)
    impl, dtype = {"gcn-bf16": ("pattern", "bfloat16"), "gcn-int8": ("pattern", "int8"),
                   "gcn-f32-exact": ("pattern", "float32"), "gcn-tiled": ("pallas", "float32")}[case]
    config = gcn.GCNConfig(sizes=(24, 48, 48, classes), parity=case != "gcn-f32-exact")
    pair = build_agg_pair(g, impl=impl, pattern_dtype=dtype, device=device)
    return config, "gcn", pair, x, y, gcn.init_params(config, device=device)


# each kernel wrapper of the port, beside the piece of its kernel's device
# event name (a replayed graph's kernels are counted from a trace)
_WRAPPER_EVENTS = {"pattern_fwd": (sp.pattern_fwd, "pattern_fwd_kernel"), "pattern_bwd": (sp.pattern_bwd, "PackArgs"),
                   "edge": (se.edge, "csr::walk_kernel"), "edge_i8": (se.edge_i8, "csr::walk_kernel"),
                   "edge_t": (se.edge_t, "csr::walk_kernel"), "gather": (sg.gather, "csr::walk_kernel"),
                   "sddmm": (sd.sddmm, "sddmm_kernel"), "sddmm_qskip": (sd.sddmm_qskip, "sddmm_kernel"),
                   "block_fwd": (sps.block_fwd, "block_fwd_kernel"), "block_bwd": (sps.block_bwd, "TileArgs"),
                   "tiled": (tpl.tiled, "tiled_kernel"), "ring_fwd": (ring.ring_pattern_fwd, "ring_fwd_kernel"),
                   "ring_bwd": (ring.ring_pattern_bwd, "PackArgs")}
_EVENT_PIECES = ("pattern_fwd_kernel", "ring_fwd_kernel", "block_fwd_kernel", "TileArgs", "PackArgs",
                 "csr::walk_kernel", "sddmm_kernel", "tiled_kernel")


def _scan_counts() -> dict:
    return {(name, key): n for name, (fn, _) in _WRAPPER_EVENTS.items() for key, n in fn.launches.items() if n}


def _scan_reset() -> None:
    for fn, _ in _WRAPPER_EVENTS.values():
        fn.launches.clear()


def _piece(name: str):
    return next((p for p in _EVENT_PIECES if p in name), None)


def _traced_kernels(run):
    """The port's kernel events of one ``run()`` under torch.profiler,
    settled at both ends, by full name."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from mg_gcn_tpu_torch.timers import settle_profiler
    from mg_gcn_tpu_torch.xplane import trace_events

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        settle_profiler()
        run()
        settle_profiler(start=False)
    return Counter(e["name"] for e in trace_events(prof) if e.get("cat") == "kernel" and _piece(e["name"]))


def _by_piece(events=None, counts=None) -> dict:
    from collections import Counter

    out = Counter()
    for name, n in (events or {}).items():
        out[_piece(name)] += n
    for (name, _), n in (counts or {}).items():
        out[_WRAPPER_EVENTS[name][1]] += n
    return dict(out)


def _eager(step, params, opt, pair, x, y, epochs):
    losses, accs = [], []
    for _ in range(epochs):
        params, opt, loss, acc = step(params, opt, pair, x, y, None)
        losses.append(loss)
        accs.append(acc)
    return params, opt, torch.stack(losses), torch.stack(accs)


def _scan_leaves(run) -> list:
    from mg_gcn_tpu_torch.train import _leaves

    params, opt, losses, accs = run
    return _leaves(params, opt) + [losses, accs]


def _assert_runs_equal(got, want, exact: bool = True):
    for a, b in zip(_scan_leaves(got), _scan_leaves(want), strict=True):
        if exact:
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", ["gcn-bf16", "gcn-int8", "gcn-f32-exact", "gcn-tiled", "sage", "gat", "deepergcn"])
def test_scan_replay_equals_eager(case, capsys):
    """Three replayed epochs equal three eager steps from the same
    parameters bit for bit (GAT: where two eager runs agree), twice in a
    row. The counters count host launches only: the first call the warm-up
    steps and the captured epoch, the second (replay only) none; a traced
    replay's kernel events equal a traced eager call's name by name, and
    those the eager call's counted launches."""
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import SCAN_WARMUP_STEPS, make_scan_train_steps

    config, model, pair, x, y, params = _scan_case(case)
    step, steps = make_train_step(config, model=model), make_scan_train_steps(config, 3, model=model)
    opt = adam.adam_init(params)
    _scan_reset()
    eager_events = _traced_kernels(lambda: _eager(step, params, opt, pair, x, y, 3))
    eager_counts = _scan_counts()
    assert eager_counts and _by_piece(events=eager_events) == _by_piece(counts=eager_counts)
    _scan_reset()
    first = steps(params, opt, pair, x, y, None)
    torch.cuda.synchronize()
    first_counts = _scan_counts()
    _scan_reset()
    held = {}
    replay_events = _traced_kernels(lambda: held.update(second=steps(first[0], first[1], pair, x, y, None)))
    second = held["second"]
    assert _scan_counts() == {}
    assert replay_events == eager_events
    eager = _eager(step, params, opt, pair, x, y, 3)
    eager_more = _eager(step, eager[0], eager[1], pair, x, y, 3)
    exact = True
    if model == "gat":
        again = _eager(step, params, opt, pair, x, y, 3)
        exact = all(torch.equal(a, b) for a, b in zip(_scan_leaves(again), _scan_leaves(eager)))
    _assert_runs_equal(first, eager, exact)
    _assert_runs_equal(second, eager_more, exact)
    assert int(second[1].step) == 6
    assert first_counts == {k: v * (SCAN_WARMUP_STEPS + 1) // 3 for k, v in eager_counts.items()}
    assert steps.route == "graph" and len(steps.captures) == 1
    assert capsys.readouterr().err.count("scan route: graph") == 1


def test_settled_traces_hold_every_kernel():
    """A trace settled at both ends (``timers.settle_profiler``) holds
    every kernel of a short step: 30 traces of 3 exact float32 epochs,
    whose first kernel is a ``pattern_fwd``, each hold the launches
    counted."""
    from mg_gcn_tpu_torch.nn import adam

    config, model, pair, x, y, params = _scan_case("gcn-f32-exact")
    step, opt = make_train_step(config, model=model), adam.adam_init(params)
    _eager(step, params, opt, pair, x, y, 3)
    torch.cuda.synchronize()
    for _ in range(30):
        _scan_reset()
        events = _traced_kernels(lambda: _eager(step, params, opt, pair, x, y, 3))
        assert _by_piece(events=events) == _by_piece(counts=_scan_counts())


@pytest.mark.parametrize("case", ["gcn-bf16", "sage", "gat"])
def test_scan_second_pair_recaptures(case):
    """Another pair recaptures (and equals eager on it); the first pair's
    results are clones that a later call does not touch."""
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import make_scan_train_steps

    config, model, pair, x, y, params = _scan_case(case)
    *_, pair2, _, _, _ = _scan_case(case, seed=5)
    step, steps = make_train_step(config, model=model), make_scan_train_steps(config, 3, model=model)
    opt = adam.adam_init(params)
    one = steps(params, opt, pair, x, y, None)
    kept = [t.clone() for t in _scan_leaves(one)]
    two = steps(params, opt, pair2, x, y, None)
    assert len(steps.captures) == 2
    _assert_runs_equal(two, _eager(step, params, opt, pair2, x, y, 3))
    _assert_runs_equal(one, _eager(step, params, opt, pair, x, y, 3))
    assert all(torch.equal(a, b) for a, b in zip(_scan_leaves(one), kept))
    steps(one[0], one[1], pair2, x, y, None)
    assert len(steps.captures) == 2  # the same pair, the same leaves: the graph is replayed


def test_scan_captures_the_cooperative_backward_walk():
    """The float32 pattern pair at d_pad 128 on a 65,536-node pack: the
    backward walk is one cooperative launch over its column windows, and
    the replayed epochs equal the eager ones."""
    from mg_gcn_tpu_torch.models import gcn
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import make_scan_train_steps

    n = 65536
    g = sparse.random_graph(n, 4, seed=6)
    assert sp.pattern_bwd_geometry(n, 128, torch.float32)["windows"] > 1
    config = gcn.GCNConfig(sizes=(16, 128, 128, 5))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 5, n)).cuda()
    pair = build_agg_pair(g, impl="pattern", pattern_dtype="float32", device="cuda")
    params = gcn.init_params(config, device="cuda")
    opt = adam.adam_init(params)
    got = make_scan_train_steps(config, 2)(params, opt, pair, x, y, None)
    _assert_runs_equal(got, _eager(make_train_step(config), params, opt, pair, x, y, 2))


@pytest.mark.parametrize("case", ["gcn-bf16", "sage", "gat"])
def test_scan_loop_route_says_so(case, capsys):
    """The loop route, by rule: tensors on the CPU, and a call made while
    the card's stream is capturing already (its epochs go into the
    caller's graph, whose replay equals the eager steps)."""
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import make_scan_train_steps, scan_route

    assert scan_route(torch.device("cpu"))[0] == "loop"
    assert scan_route(torch.device("cuda"))[0] == "graph"
    config, model, pair, x, y, params = _scan_case(case)
    step, steps = make_train_step(config, model=model), make_scan_train_steps(config, 2, model=model)
    opt = adam.adam_init(params)
    want = _eager(step, params, opt, pair, x, y, 2)  # also builds the kernels outside the capture
    side, outer = torch.cuda.Stream(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer, stream=side):
        assert scan_route(torch.device("cuda"))[0] == "loop"
        got = steps(params, opt, pair, x, y, None)
    outer.replay()
    torch.cuda.synchronize()
    _assert_runs_equal(got, want)
    assert steps.route == "loop" and not steps.captures
    err = capsys.readouterr().err
    assert "scan route: loop (the current stream is capturing already" in err
    _, _, pair_cpu, x_cpu, y_cpu, params_cpu = _scan_case(case, device="cpu")
    steps_cpu = make_scan_train_steps(config, 2, model=model)
    out = steps_cpu(params_cpu, adam.adam_init(params_cpu), pair_cpu, x_cpu, y_cpu, None)
    assert out[2].device.type == "cpu" and steps_cpu.route == "loop"
    assert "scan route: loop (the CPU has no CUDA graphs)" in capsys.readouterr().err


def test_scan_capture_failure_names_the_operation(monkeypatch):
    """A step that reads from the card cannot be captured: the call raises
    with the line that broke the capture and keeps no graph; the counters
    hold the host launches made, the warm-up steps' and the failed
    capture's one epoch; the card works on after."""
    from mg_gcn_tpu_torch import train as ttrain
    from mg_gcn_tpu_torch.nn import adam

    config, model, pair, x, y, params = _scan_case("gcn-bf16")
    real = ttrain.make_train_step

    def reading_step(*args, **kw):
        inner = real(*args, **kw)

        def step(*a):
            out = inner(*a)
            # a host read, which a capturing stream does not allow
            float(out[2])
            return out

        return step

    monkeypatch.setattr(ttrain, "make_train_step", reading_step)
    steps = ttrain.make_scan_train_steps(config, 2, model=model)
    _scan_reset()
    with pytest.raises(RuntimeError, match=r"capture of the gcn step failed at test_torch_port_cuda\.py:\d+ "
                                           r"\(float\(out\[2\]\)\)"):
        steps(params, adam.adam_init(params), pair, x, y, None)
    assert not steps.captures
    warm = _scan_counts()
    monkeypatch.setattr(ttrain, "make_train_step", real)
    _scan_reset()
    want = _eager(make_train_step(config, model=model), params, adam.adam_init(params), pair, x, y, 2)
    torch.cuda.synchronize()
    assert warm == {k: v * (ttrain.SCAN_WARMUP_STEPS + 1) // 2 for k, v in _scan_counts().items()}
    _assert_runs_equal(ttrain.make_scan_train_steps(config, 2, model=model)(
        params, adam.adam_init(params), pair, x, y, None), want)


MP_CASES = ("gcn:halo_gather:2", "gcn:gather:2", "sage:halo_gather:2", "gcn:halo_gather:4")
MP_GAT_CASES = ("gat:2", "gat:4")


def _mp_worker():
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    # by path: a card machine may have another top-level package named tests
    spec = importlib.util.spec_from_file_location("torch_port_mp_worker", os.path.join(here, "torch_port_mp_worker.py"))
    mp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mp)
    return mp


def test_two_processes_on_one_card_bit_equal_one_process(tmp_path):
    """Two processes on cuda:0 (``MG_GCN_LOCAL_DEVICE_IDS=0``): the route
    stages card tensors through host memory over gloo, and 3 epochs of GCN
    on the halo pair and the gather ring and of SAGE on the halo pair, all on
    the gather kernel (deterministic), at -P 2 and -P 4, equal the
    one-process run on the card bit for bit: losses, accuracies and final
    parameters, on both processes (``tests/torch_port_mp_worker.py``)."""
    mp = _mp_worker()
    n, rng = 4096, np.random.default_rng(3)
    d = str(tmp_path / "ds")
    Dataset(graph=sparse.random_graph(n, 12, seed=3, weights="random"),
            features=rng.standard_normal((n, 24)).astype(np.float32),
            labels=rng.integers(0, 6, (n, 1)).astype(np.int32),
            sets=rng.integers(0, 3, (n, 1)).astype(np.int32)).save(d)
    from mg_gcn_tpu_torch.formats import ensure_pigo_transpose

    ensure_pigo_transpose(d)
    worker = [mp.WORKER, d]
    one = str(tmp_path / "one.npz")
    assert mp.launch([[*worker, one, "cuda:0", *MP_CASES]], [str(tmp_path / "one.log")], timeout=300) == [0]
    ranks, logs = [str(tmp_path / f"rank{r}.npz") for r in range(2)], [str(tmp_path / f"rank{r}.log") for r in range(2)]
    codes = mp.launch([[*worker, path, "cuda:0", *MP_CASES] for path in ranks], logs, world=2, device_ids="0",
                      timeout=300)
    assert codes == [0, 0], [open(log).read()[-3000:] for log in logs]
    for log in logs:
        assert "exchange route: card tensors staged through host over gloo" in open(log).read()
    want = np.load(one)
    for path in ranks:
        got = np.load(path)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert np.array_equal(got[k], want[k]), (path, k)


def test_gat_two_processes_on_one_card_against_one_process(tmp_path):
    """GAT (two heads, bfloat16 ring blocks) at -P 2 and -P 4 across two
    processes on cuda:0, the ring hops' gradients crossing the staged
    route: losses, accuracies, final parameters and Adam moments on both
    processes equal the one-process run on the card bit for bit, or, where
    two one-process runs already differ, within rtol 1e-5
    (``tests/torch_port_mp_worker.py``)."""
    mp = _mp_worker()
    n, rng = 4096, np.random.default_rng(5)
    d = str(tmp_path / "ds")
    Dataset(graph=sparse.random_graph(n, 12, seed=5), features=rng.standard_normal((n, 24)).astype(np.float32),
            labels=rng.integers(0, 6, (n, 1)).astype(np.int32),
            sets=rng.integers(0, 3, (n, 1)).astype(np.int32)).save(d)
    worker = [mp.WORKER, d]
    runs = [str(tmp_path / f"one{i}.npz") for i in range(2)]
    assert mp.launch([[*worker, runs[0], "cuda:0", *MP_GAT_CASES]], [str(tmp_path / "one0.log")], timeout=300) == [0]
    ranks, logs = [str(tmp_path / f"rank{r}.npz") for r in range(2)], [str(tmp_path / f"rank{r}.log") for r in range(2)]
    codes = mp.launch([[*worker, path, "cuda:0", *MP_GAT_CASES] for path in ranks], logs, world=2, device_ids="0",
                      timeout=300)
    assert codes == [0, 0], [open(log).read()[-3000:] for log in logs]
    for log in logs:
        assert "exchange route: card tensors staged through host over gloo" in open(log).read()
    want = np.load(runs[0])
    assert all(np.isfinite(want[f"{c}/losses"]).all() for c in MP_GAT_CASES)
    got = [np.load(path) for path in ranks]
    if all(np.array_equal(g[k], want[k]) for g in got for k in want.files):
        return
    assert mp.launch([[*worker, runs[1], "cuda:0", *MP_GAT_CASES]], [str(tmp_path / "one1.log")], timeout=300) == [0]
    again = np.load(runs[1])
    assert not all(np.array_equal(again[k], want[k]) for k in want.files), "one process repeats itself bit for bit"
    for g in got:
        for k in want.files:
            np.testing.assert_allclose(g[k], want[k], rtol=1e-5, err_msg=k)
