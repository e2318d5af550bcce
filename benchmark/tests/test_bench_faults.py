"""A run with the timed path broken underneath comes out not correct, once
for each fault a training cell can have: a step that returns its state
unchanged, half of the batch left out (the mean taken over the rest), and
in the four-partition cell the exchange between partitions left out. The
harness's look for a card is skipped: the port runs its plain CPU paths at
a tiny size; the numbers are held to the cells' own limits."""

import pytest
import torch

from benchmark.tests.helpers import run_tiny, tiny_cell

CELLS = ["gcn-reddit-uniform", "sage-reddit-uniform", "gcn-reddit-banded", "gcn-reddit-p4-uniform"]


def frozen(trainer):
    step = trainer.step

    def unchanged(params, state, *args):
        return (params, state, *step(params, state, *args)[2:])

    trainer.step = unchanged


def half_batch(trainer):
    pair, xs, ys, masks = trainer.args
    if isinstance(xs, torch.Tensor):  # one card: the loss over the first half of the rows
        keep = torch.arange(xs.shape[0]) < xs.shape[0] // 2
        trainer.args = (pair, xs, ys, keep)
        return
    n, m = pair.n, xs[0].shape[0]
    trainer.args = (pair, xs, ys, [torch.arange(j * m, (j + 1) * m) < n // 2 for j in range(len(xs))])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert run_tiny(tiny_cell(name))["correct"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [frozen, half_batch], ids=["frozen", "half_batch"])
def test_fault_is_not_correct(name, fault):
    out = run_tiny(tiny_cell(name), plant=fault)
    assert not out["correct"], out["checks"]


def test_exchange_left_out_is_not_correct(monkeypatch):
    from mg_gcn_tpu_torch.parallel import dist

    def own_block_only(blocks, j, order):
        own = blocks[j]
        out = torch.zeros((len(order), *own.shape), dtype=own.dtype, device=own.device)
        for s, k in enumerate(order):
            if k == j:
                out[s].copy_(own)
        return out

    monkeypatch.setattr(dist, "_slots", own_block_only)
    out = run_tiny(tiny_cell("gcn-reddit-p4-uniform"))
    assert not out["correct"], out["checks"]
