"""The work count of the two model families against worked values."""

import pytest

from benchmark.harness import spec
from benchmark.tests.helpers import ROOT

N, NNZ = 232_968, 114_964_049


def _work(config_name):
    cfg = spec.load_json(f"{ROOT}/benchmark/configs/{config_name}.json")
    return spec.load_module(ROOT, "families", cfg["family"]).work(cfg, N, NNZ)


def test_gcn_reddit_work():
    w = _work("gcn-reddit")
    # forward products at 128, 128, 128, 41; backward at 128, 128 and 41 (layer 0 skips its own)
    assert sorted(p.d for p in w.products) == [41, 41, 128, 128, 128, 128, 128]
    # 4 forward + 4 weight-gradient + 3 input-gradient dense products
    flops = 2 * N * (608 * 128 * 2 + 128 * 128 * 6 + 128 * 41 * 3)
    assert sum(g.flops for g in w.gemms) == pytest.approx(flops)
    # bytes of one product at d = 128: 4·nnz + 8·(n + 1) + 2·128·2n (bf16 in and out)
    p128 = next(p for p in w.products if p.d == 128)
    assert p128.bytes == 4 * NNZ + 8 * (N + 1) + 2 * 128 * 2 * N
    assert p128.least_s() == pytest.approx(p128.bytes / 3.35e12)  # bytes bound
    assert w.products_least_s == pytest.approx(
        (7 * (4 * NNZ + 8 * (N + 1)) + 4 * N * (5 * 128 + 2 * 41)) / 3.35e12)
    assert w.gemms_least_s == pytest.approx(flops / 67e12)
    assert w.least_s == pytest.approx(3.0412e-3, rel=1e-4)


def test_sage_reddit_work():
    w = _work("sage-reddit")
    assert sorted(p.d for p in w.products) == [512, 512, 608]
    flops = 2 * N * (608 * 512 * 4 + 512 * 41 * 6)
    assert sum(g.flops for g in w.gemms) == pytest.approx(flops)
    assert sum(g.flops for g in w.gemms) == pytest.approx(638.9e9, rel=1e-3)


def test_four_cards_count_the_same_work_against_four_peaks():
    one, four = _work("gcn-reddit"), _work("gcn-reddit-p4")
    assert four.cards == 4
    assert [p.d for p in four.products] == [128, 128, 128, 128, 128, 44, 44]
    assert four.least_s == pytest.approx(
        sum(p.least_s() for p in four.products) / 4 + sum(g.least_s() for g in four.gemms) / 4)
    assert one.cards == 1
