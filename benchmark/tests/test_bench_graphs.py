"""The graph layouts: their size and that a seed gives the same graph."""

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.tests.helpers import ROOT

CPU = torch.device("cpu")


def _make(layout, n, params, seed):
    return spec.load_module(ROOT, "graphs", layout).make(n, params, seed, CPU)


def test_uniform_size_and_seed():
    params = {"draws_per_row": 20, "self_loops": True}
    g = _make("uniform", 2000, params, 2**31 + 7)
    # 40,000 draws into 4e6 cells: ~200 repeats merged; every self loop present
    assert 39_500 < g.nnz <= 42_000
    rows = np.repeat(np.arange(g.n), np.diff(g.indptr))
    assert np.all(np.isin(np.arange(g.n), rows[g.indices == rows]))
    again = _make("uniform", 2000, params, 2**31 + 7)
    assert np.array_equal(g.indptr, again.indptr) and np.array_equal(g.indices, again.indices)
    other = _make("uniform", 2000, params, 2**31 + 8)
    assert not np.array_equal(g.indices, other.indices)


@pytest.mark.parametrize("layout,params", [
    ("uniform", {"draws_per_row": 20, "self_loops": False}),
    ("banded", {"draws_per_row": 20, "half_width": 50}),
])
def test_rows_sorted_without_repeats(layout, params):
    g = _make(layout, 1500, params, 11)
    for r in range(g.n):
        cols = g.indices[g.indptr[r]:g.indptr[r + 1]]
        assert np.all(np.diff(cols) > 0)


def test_banded_stays_in_its_band():
    g = _make("banded", 3000, {"draws_per_row": 30, "half_width": 40}, 5)
    rows = np.repeat(np.arange(g.n), np.diff(g.indptr))
    assert np.abs(g.indices.astype(np.int64) - rows).max() <= 40
    # 30 draws over 81 columns a row: about 25 distinct
    assert 22 * 3000 < g.nnz < 27 * 3000
    again = _make("banded", 3000, {"draws_per_row": 30, "half_width": 40}, 5)
    assert np.array_equal(g.indices, again.indices)
