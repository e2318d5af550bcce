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
from mg_gcn_tpu_torch.ops import spmm_pattern as sp
from mg_gcn_tpu_torch.train import train

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
    for dtype in (torch.float32, torch.int8):
        b = _operand(n, 16, dtype, seed=1)
        _assert_matches_plain(sp.pattern_fwd(pack, b), sp.pattern_fwd_plain(pack, b), dtype)
        _assert_matches_plain(sp.pattern_bwd(pack, b), sp.pattern_bwd_plain(pack, b), dtype)


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
    gpu = train(ds, [16, 16], epochs=5, impl="auto", pattern_dtype="float32", device="cuda", log=False)
    cpu = train(ds, [16, 16], epochs=5, impl="pattern", pattern_dtype="float32", device="cpu", log=False)
    assert gpu.engine == "pattern"
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-5)
