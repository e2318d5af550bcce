"""GAT on one card, as the port's CLI trains it (``cli._single_pair``,
``cli.cmd_train``): the attention graph of ``models.gat.build_gat_graph``
and the step of ``train.make_train_step(model="gat")``; and the work of a
GAT epoch.

Work, counted from the configuration's shapes and the graph's size, never
from the engine. Dense products, a layer i of H heads of width d on an
input of width k: the projection n·k·Hd, the 2H score vectors n·d·1; in
the backward the weight gradient k·n·Hd, the score vectors' 2H gradients
d·n·1 and 2H outer products n·1·d, and on every layer but layer 0 the input
gradient n·Hd·k. The attention, a head of width d over nnz entries
(:class:`Attention`, at the bf16 peak or the HBM rate, whichever binds): the
score SDDMM at width 2 ([e_dst, 1]·[1, e_src]), the softmax's forward pass
(scores read, weights written), the weighted aggregation at width d; in the
backward the weights' SDDMM at d, the transposed aggregation at d, and the
softmax's backward passes (weights and their gradient read, the scores'
gradient written, then read again for its row and column sums). Elementwise
work outside the attention is not counted."""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field

import torch

from benchmark.harness.params import to_layers
from benchmark.harness.trainer import Trainer, hparams, host_csr, timed_build
from benchmark.harness.work import DTYPE_BYTES, HBM_BYTES_S, PEAK_FLOPS, Gemm, Work, dense_dtype

F32 = 4


def glorot(fan_in: int, fan_out: int) -> float:
    """Glorot-uniform's bound, sqrt(6 / (fan_in + fan_out))."""
    return math.sqrt(6.0 / (fan_in + fan_out))


def layer_in(config: dict, i: int) -> int:
    s, h = config["sizes"], config["heads"]
    return s[i] * (h[i - 1] if i > 0 else 1)


def leaves(config: dict) -> list:
    """Per layer W (in, H·d), a_dst and a_src (H, d), b (H·d, or d on the
    averaged output); W's bound a head's (fan in, d out), the attention
    vectors' (d in, 1 out), b nought."""
    s, h = config["sizes"], config["heads"]
    out = []
    for i in range(len(s) - 1):
        k, d, H = layer_in(config, i), s[i + 1], h[i]
        last = i == len(s) - 2
        out += [(f"{i}.W", (k, H * d), glorot(k, d)), (f"{i}.a_dst", (H, d), glorot(d, 1)),
                (f"{i}.a_src", (H, d), glorot(d, 1)), (f"{i}.b", (d if last else H * d,), 0.0)]
    return out


@dataclass(frozen=True)
class Attention:
    """One pass of an attention head: its operations and the least bytes it
    moves, at the bf16 peak or the HBM rate."""

    what: str
    flops: float
    bytes: float

    def least_s(self, cards: int = 1) -> float:
        return max(self.flops / (PEAK_FLOPS["bfloat16"] * cards), self.bytes / (HBM_BYTES_S * cards))


def head_passes(n: int, nnz: int, d: int, dtype: str) -> list:
    """The passes of one head of width ``d`` over a graph of ``n`` nodes and
    ``nnz`` entries, the operands in ``dtype`` (a CSR: 4-byte columns, 8-byte
    row offsets; a per-entry value float32)."""
    b, csr = DTYPE_BYTES[dtype], 4.0 * nnz + 8.0 * (n + 1)

    def sddmm(width):  # both operands read once, a float32 score an entry written
        return 2.0 * nnz * width, csr + 2 * b * n * width + F32 * nnz

    def product(width):  # the weights and the operand read once, the float32 rows written
        return 2.0 * nnz * width, csr + b * nnz + b * n * width + F32 * n * width

    return [Attention("score_sddmm", *sddmm(2)),
            Attention("softmax_fwd", 0.0, 2.0 * F32 * nnz),
            Attention("aggregation", *product(d)),
            Attention("weights_sddmm", *sddmm(d)),
            Attention("aggregation_t", *product(d)),
            Attention("softmax_bwd", 0.0, 5.0 * F32 * nnz)]


@dataclass
class GatWork(Work):
    """:class:`Work` with the attention's passes: ``least_s`` counts them."""

    attention: list = field(default_factory=list)

    @property
    def attention_least_s(self) -> float:
        return sum(a.least_s(self.cards) for a in self.attention)

    @property
    def least_s(self) -> float:
        return self.products_least_s + self.gemms_least_s + self.attention_least_s


def work(config: dict, n: int, nnz: int) -> GatWork:
    s, h, dense = config["sizes"], config["heads"], dense_dtype(config)
    out = GatWork(cards=int(config.get("parts", 1)))
    for i in range(len(s) - 1):
        k, d, H = layer_in(config, i), s[i + 1], h[i]
        out.gemms += [Gemm(n, k, H * d, dense), Gemm(k, n, H * d, dense)]
        out.gemms += [Gemm(n, d, 1, dense), Gemm(d, n, 1, dense), Gemm(n, 1, d, dense)] * (2 * H)
        if i > 0:
            out.gemms.append(Gemm(n, H * d, k, dense))
        for _ in range(H):
            out.attention += head_passes(n, nnz, d, config["aggregation_dtype"])
    return out


def port_config(config: dict):
    from mg_gcn_tpu_torch.models.gat import GATConfig

    return GATConfig(sizes=tuple(config["sizes"]), heads=tuple(config["heads"]), att_slope=config["att_slope"],
                     activation=config["activation"], skip=tuple(config["skip"]), loss_mask="all")


def build(config: dict, traffic: dict, graph, x, y, params0: dict, devices) -> Trainer:
    from mg_gcn_tpu_torch.models.gat import build_gat_graph
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import make_train_step

    dtype = config["aggregation_dtype"]
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"GAT's attention runs in bfloat16 or float32, not {dtype}: its entry weights are made "
                         "every step, so there is no int8 path")
    dev = devices[0]
    step = make_train_step(port_config(config), hparams(config), optimizer="adam", model="gat")
    csr = host_csr(graph)
    pair, build_s = timed_build(lambda: build_gat_graph(csr, dtype=dtype, device=dev), devices)
    params = to_layers({k: v.clone() for k, v in params0.items()})
    t = Trainer(step, params, adam.adam_init(params),
                (pair, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), None), devices)
    t.build_s, t.engine = build_s, f"edge attention ({dtype})"
    print(f"engine {t.engine}, build {build_s:.3f} s", file=sys.stderr)
    return t
