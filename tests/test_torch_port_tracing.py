"""The port's spans and its exchange counter (``timers``) on the CPU: the
row-partitioned GCN step on four partitions opens the one-card step's phase
scopes, one ``train-step`` span a step with the ``exchange`` and ``psum``
spans inside it, and counts the bytes its exchange moves; untraced it opens
no span, counts nothing, and traced or not it computes the same bits. The
one-card GAT step opens its phase scopes on both passes and counts its
attention launches, and the row-partitioned GAT step opens the same phase
scopes."""

import numpy as np
import pytest
import torch

from mg_gcn_tpu_torch import sparse, timers, xplane
from mg_gcn_tpu_torch import train as ttrain
from mg_gcn_tpu_torch.models import gcn as tgcn
from mg_gcn_tpu_torch.nn import adam
from mg_gcn_tpu_torch.ops import spmm_pattern as sp
from mg_gcn_tpu_torch.parallel import dist

PARTS = 4
N, F, C = 4096 * PARTS - 100, 10, 4  # rows padded to the slabs': a row mask
# layer 0 aggregate-first (10 -> 16) with a projection residual, layer 1
# linear-first with the identity residual, layer 2 linear-first
SIZES = (F, 16, 16, C)
STEP, EXCHANGE, PSUM = "train-step", "exchange", "psum"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs():
    g = sparse.random_graph(N, 4, seed=7, weights="ones")
    rng = np.random.default_rng(3)
    return g, rng.standard_normal((N, F)).astype(np.float32), rng.integers(0, C, N).astype(np.int64)


def _dist_run(config, strategy: str, traced: bool, steps: int = 1):
    """(events or None, params, opt_state, losses) of ``steps`` steps of the
    pattern pair's step on four CPU partitions."""
    g, x, y = _inputs()
    ring = dist.make_mesh(PARTS, ["cpu"] * PARTS)
    pair = dist.DistPatternPair.from_binary_csr(g, ring, dtype="bfloat16")
    params = tgcn.init_params(config, device="cpu")
    params, opt = dist.replicate(params, ring), dist.replicate(adam.adam_init(params), ring)
    rows = pair.n_pad
    xp, yp, mp = np.zeros((rows, F), np.float32), np.zeros(rows, np.int64), np.arange(rows) < N
    xp[:N], yp[:N] = x, y
    args = (pair, dist.shard(xp, ring), dist.shard(yp, ring), dist.shard(mp, ring))
    step = dist.make_dist_train_step(config, ring, N, strategy=strategy, pair_kind="pattern",
                                     pattern_dtype="bfloat16")
    losses = []

    def run():
        nonlocal params, opt
        for _ in range(steps):
            params, opt, loss, _ = step(params, opt, *args)
            losses.append(float(loss))

    if not traced:
        run()
        return None, params, opt, losses
    with torch.profiler.profile(activities=timers.profiler_activities()) as prof:
        run()
    return xplane.trace_events(prof), params, opt, losses


def _one_card_events(config):
    g, x, y = _inputs()
    params = tgcn.init_params(config, device="cpu")
    pair = ttrain.build_agg_pair(g, impl="pattern", pattern_dtype="bfloat16", device="cpu")
    step = ttrain.make_train_step(config)
    with torch.profiler.profile(activities=timers.profiler_activities()) as prof:
        step(params, adam.adam_init(params), pair, torch.from_numpy(x), torch.from_numpy(y), None)
    return xplane.trace_events(prof)


def _spans(events, keep):
    return [e for e in events if e.get("cat") == "user_annotation" and keep(e["name"])]


def _inside(e, outer) -> bool:
    return outer["tid"] == e["tid"] and outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("strategy,parity", [("fused", True), ("ring", True), ("all_gather", True),
                                             ("fused", False)])
def test_dist_step_spans(strategy, parity):
    """The phase scopes of a traced four-partition step are the one-card
    step's for the same configuration (each opened once in parity mode);
    each step is one ``train-step`` span, and every ``exchange`` and
    ``psum`` span lies inside one."""
    config = tgcn.GCNConfig(sizes=SIZES, residual=True, parity=parity)
    events, *_ = _dist_run(config, strategy, traced=True, steps=2)
    want = {e["name"] for e in _spans(_one_card_events(config), xplane._looks_like_phase)}
    assert "adam-update" in want and "1_0_matmul-spmm" in want
    names = [e["name"] for e in _spans(events, xplane._looks_like_phase)]
    assert set(names) == want
    if parity:
        assert len(names) == 2 * len(want)
    steps = _spans(events, lambda name: name == STEP)
    assert len(steps) == 2
    moves = _spans(events, lambda name: name in (EXCHANGE, PSUM))
    assert {e["name"] for e in moves} == {EXCHANGE, PSUM}
    assert all(any(_inside(e, s) for s in steps) for e in moves + _spans(events, xplane._looks_like_phase))


def _products(config) -> list[int]:
    """The padded widths of one parity step's products, forward and
    backward."""
    out = []
    for i in range(config.num_layers):
        meta = config.layer_meta(i)
        d = config.sizes[i + 1] if meta["lin_first"] else config.sizes[i]
        out += [d] * (2 if meta["backward_spmm"] else 1)
    return [sp.round_up(max(d, 8), 8) for d in out]


def test_fused_step_counts_the_exchange_bytes():
    """One traced fused step counts, for each product, the P - 1 blocks of
    m_loc x d_pad bf16 that land in each partition's slots, then the
    gradient fold into partition 0 and the loss's four folded or broadcast
    scalars (one replica here: the partitions share the CPU)."""
    config = tgcn.GCNConfig(sizes=SIZES, residual=True)
    before = timers.counters().get(timers.EXCHANGE_BYTES, {})
    _, params, *_ = _dist_run(config, "fused", traced=True)
    after = timers.counters()[timers.EXCHANGE_BYTES]
    got = {j: after.get(j, 0) - before.get(j, 0) for j in range(PARTS)}
    m_loc = 4096
    slots = (PARTS - 1) * m_loc * sum(_products(config)) * 2
    grads = sum(v.numel() * v.element_size() for layer in params[0] for v in layer.values())
    # float32 scalars: the mask count, loss and accuracy folded into
    # partition 0, the mask count broadcast to the others
    assert got == {0: slots + (PARTS - 1) * (grads + 3 * 4), **{j: slots + 4 for j in range(1, PARTS)}}
    assert sum(got.values()) == PARTS * (PARTS - 1) * m_loc * sum(_products(config)) * 2 + (PARTS - 1) * (
        grads + 4 * 4)


def test_untraced_step_opens_no_span_and_counts_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    before = timers.counters()
    assert timers.scope(STEP) is timers.scope(EXCHANGE)
    _dist_run(tgcn.GCNConfig(sizes=SIZES, residual=True), "fused", traced=False)
    assert opened == [] and timers.counters() == before


@pytest.mark.parametrize("strategy", ["fused", "ring"])
def test_traced_and_untraced_steps_equal_bit_for_bit(strategy):
    config = tgcn.GCNConfig(sizes=SIZES, residual=True)
    _, p_traced, o_traced, l_traced = _dist_run(config, strategy, traced=True, steps=2)
    _, p_plain, o_plain, l_plain = _dist_run(config, strategy, traced=False, steps=2)
    assert l_traced == l_plain
    for a, b in zip(p_traced[0] + o_traced[0].m + o_traced[0].v, p_plain[0] + o_plain[0].m + o_plain[0].v):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_one_card_step_is_one_train_step_span():
    events = _one_card_events(tgcn.GCNConfig(sizes=SIZES))
    (outer,) = _spans(events, lambda name: name == STEP)
    assert all(_inside(e, outer) for e in _spans(events, xplane._looks_like_phase))


def test_counter_adds_only_under_a_profiler():
    before = timers.counters().get("test_count", {})
    timers.count("test_count", 5, key=1)
    assert timers.counters().get("test_count", {}) == before
    with torch.profiler.profile(activities=timers.profiler_activities()):
        assert timers.counting()
        timers.count("test_count", 5, key=1)
        timers.count("test_count", 2, key=1)
    assert timers.counters()["test_count"][1] - before.get(1, 0) == 7


def test_timer_span_is_a_profiler_span():
    """``TimerRegistry.span`` (the CLI's ``0_preprocess``) records its host
    milliseconds and, under a profiler, a span of its name."""
    reg = timers.TimerRegistry()
    with torch.profiler.profile(activities=timers.profiler_activities()) as prof:
        with reg.span("0_preprocess"):
            torch.ones(3).sum()
    assert [e["name"] for e in _spans(xplane.trace_events(prof), lambda n: n == "0_preprocess")] == ["0_preprocess"]
    assert list(reg._entries) == ["0_preprocess"]


# ---------------------------------------------------------------------------
# GAT: phase scopes on both passes, and the attention's launch counter

GAT_SIZES = (F, 16, 16, C)


def _gat_inputs():
    g = sparse.random_graph(300, 6, seed=2, weights="ones")
    rng = np.random.default_rng(4)
    x, y = torch.from_numpy(rng.standard_normal((300, F)).astype(np.float32)), torch.from_numpy(rng.integers(0, C, 300))
    return g, x, y


def _gat_traced_step(monkeypatch=None, config=None):
    """(events, {kernel: Counter of CPU calls by d_pad}, counter delta) of one
    traced step of ``config``, by default the PPI form of GAT (heads 2, 2,
    3, ELU, the skip across layer 1), on a small graph; with
    ``monkeypatch`` the three kernel wrappers count their CPU calls as the
    card's count its launches."""
    from collections import Counter

    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.ops import edge_attention, sddmm as sd, spmm_edges as se

    calls = {"sddmm": Counter(), "edge": Counter(), "edge_t": Counter(), "softmax": Counter(),
             "softmax_bwd": Counter()}
    if monkeypatch is not None:
        for mod, name in ((sd, "sddmm"), (se, "edge"), (se, "edge_t")):
            def counted(*args, _real=getattr(mod, name), _name=name):
                out = _real(*args)
                calls[_name][args[-1].shape[1] if _name != "sddmm" else args[2].shape[1]] += 1
                return out
            monkeypatch.setattr(mod, name, counted)
        # the edge softmax's wrappers: two launches forward, one backward, at d_pad 8
        for name, key, n in (("softmax_fwd", "softmax", 2), ("softmax_bwd", "softmax_bwd", 1)):
            def fused(*args, _real=getattr(edge_attention, name), _key=key, _n=n):
                calls[_key][8] += _n
                return _real(*args)
            monkeypatch.setattr(edge_attention, name, fused)
    g, x, y = _gat_inputs()
    config = config or gat.GATConfig(sizes=GAT_SIZES, heads=(2, 2, 3), activation="elu", skip=(1,))
    params = gat.init_params(config, 3, device="cpu")
    step = ttrain.make_train_step(config, model="gat")
    before = dict(timers.counters().get(edge_attention.ATTN_LAUNCHES, {}))
    with torch.profiler.profile(activities=timers.profiler_activities()) as prof:
        step(params, adam.adam_init(params), gat.build_gat_graph(g, device="cpu"), x, y, None)
    after = timers.counters()[edge_attention.ATTN_LAUNCHES]
    return xplane.trace_events(prof), calls, {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def test_gat_step_opens_phase_scopes_on_both_passes():
    """Every layer's forward scopes and its backward attention scope (opened
    by the attention ops' backward, on the thread that runs it), the skip's
    residual scope, the loss layer; all inside the step's span."""
    events, _, _ = _gat_traced_step()
    names = {e["name"] for e in _spans(events, xplane._looks_like_phase)}
    layers = range(len(GAT_SIZES) - 1)
    want = {f"{i}_{p}_matmul-spmm" for i in layers for p in (0, 1)} | {f"{i}_0_matmul-gemm" for i in layers}
    want |= {"0_0_activation", "1_0_activation", "1_0_residual", "3_loss-layer", "adam-update"}
    assert names == want
    (outer,) = _spans(events, lambda name: name == STEP)
    assert all(_inside(e, outer) for e in _spans(events, xplane._looks_like_phase) if e["tid"] == outer["tid"])


def test_gat_launch_counter_equals_the_kernel_calls(monkeypatch):
    """``attn_launches`` counts each SDDMM, weighted and transposed product
    and each edge softmax walk the attention ops launch, by kernel and
    d_pad: 7 a head and layer (4 at d_pad 8: the edge softmax's two forward
    walks and its backward walk, and the transposed product at d = 1 that
    sums its gradient's columns; 3 at the head's width: the aggregation,
    its weights' SDDMM and its transposed product)."""
    _, calls, counted = _gat_traced_step(monkeypatch)
    assert counted == {(k, d): n for k, by_d in calls.items() for d, n in by_d.items()}
    assert sum(counted.values()) == 7 * (2 + 2 + 3)
    assert {k: n for k, n in counted.items() if k[0].startswith("softmax")} == {("softmax", 8): 14,
                                                                               ("softmax_bwd", 8): 7}
    assert {k: n for k, n in counted.items() if k[1] == 16} == {("sddmm", 16): 4, ("edge", 16): 4, ("edge_t", 16): 4}


def test_dist_gat_step_opens_the_one_card_phase_scopes():
    """The row-partitioned GAT step on two partitions (heads 2, 2, 3,
    LeakyReLU, no skip: what it runs) opens the one-card step's phase
    scopes, the attention ops' backward scopes and the loss layer included,
    all inside its step's span on that thread."""
    from mg_gcn_tpu_torch.models import gat
    from mg_gcn_tpu_torch.parallel import dist_gat

    config = gat.GATConfig(sizes=GAT_SIZES, heads=(2, 2, 3))
    events, _, _ = _gat_traced_step(config=config)
    want = {e["name"] for e in _spans(events, xplane._looks_like_phase)}
    assert {"2_1_matmul-spmm", "3_loss-layer", "adam-update"} <= want
    g, x, y = _gat_inputs()
    ring = dist.make_mesh(2, ["cpu"] * 2)
    graph = dist_gat.build_dist_gat_graph(g, ring, dtype="bfloat16")
    params = gat.init_params(config, 3, device="cpu")
    params, opt = dist.replicate(params, ring), dist.replicate(adam.adam_init(params), ring)
    step = dist_gat.make_dist_gat_train_step(config, ring, graph)
    with torch.profiler.profile(activities=timers.profiler_activities()) as prof:
        step(params, opt, graph, dist.shard(x, ring), dist.shard(y, ring), None)
    events = xplane.trace_events(prof)
    assert {e["name"] for e in _spans(events, xplane._looks_like_phase)} == want
    (outer,) = _spans(events, lambda name: name == STEP)
    assert all(_inside(e, outer) for e in _spans(events, xplane._looks_like_phase) if e["tid"] == outer["tid"])


# ---------------------------------------------------------------------------
# DeeperGCN: phase scopes on both passes, and the softmax aggregation's counter


def _deepergcn_traced_step(layers: int = 4):
    """(events, counter delta) of one traced DeeperGCN step, ``layers``
    GENConv layers of 16, on a small graph."""
    from mg_gcn_tpu_torch.models import deepergcn as dg
    from mg_gcn_tpu_torch.ops.softmax_agg import SOFTAGG_LAUNCHES

    g, x, y = _gat_inputs()
    config = dg.DeeperGCNConfig(sizes=(F, 16, C), layers=layers)
    params = dg.init_params(config, 3, device="cpu")
    step = ttrain.make_train_step(config, model="deepergcn")
    before = dict(timers.counters().get(SOFTAGG_LAUNCHES, {}))
    with torch.profiler.profile(activities=timers.profiler_activities()) as prof:
        step(params, adam.adam_init(params), dg.build_deepergcn_graph(g, device="cpu"), x, y, None)
    after = timers.counters()[SOFTAGG_LAUNCHES]
    return xplane.trace_events(prof), {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def test_deepergcn_step_opens_phase_scopes_on_both_passes():
    """Each GENConv's forward and backward ``matmul-spmm`` scopes (the
    backward opened by the aggregation op), each BatchNorm's forward and
    backward ``activation`` scopes (the backward opened by the BatchNorm
    op), the linears' ``matmul-gemm`` and the ``residual`` scopes forward,
    the loss layer and Adam; all inside the step's span on that thread."""
    layers = 4
    events, _ = _deepergcn_traced_step(layers)
    names = {e["name"] for e in _spans(events, xplane._looks_like_phase)}
    convs, norms = range(1, layers + 1), range(2, layers + 2)
    want = {f"{k}_{p}_matmul-spmm" for k in convs for p in (0, 1)} | {f"{k}_0_residual" for k in convs}
    want |= {f"{k}_{p}_activation" for k in norms for p in (0, 1)}
    want |= {f"{k}_0_matmul-gemm" for k in range(layers + 2)} | {f"{layers + 2}_loss-layer", "adam-update"}
    assert names == want
    (outer,) = _spans(events, lambda name: name == STEP)
    assert all(_inside(e, outer) for e in _spans(events, xplane._looks_like_phase) if e["tid"] == outer["tid"])


def test_deepergcn_counts_two_products_a_layer():
    """``softagg_launches`` counts each product the softmax aggregation
    issues: one forward at d_pad 2·16 ([w ⊙ m ‖ w]) and one backward at 16
    a layer."""
    _, counted = _deepergcn_traced_step(layers=4)
    assert counted == {("fwd", 32): 4, ("bwd", 16): 4}
