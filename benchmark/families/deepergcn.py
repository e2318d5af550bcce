"""DeeperGCN on one card, as the port's CLI trains it (``cli._single_pair``,
``cli.cmd_train``): the binary pair of ``models.deepergcn.build_deepergcn_graph``
(the binary CSR walk, no degree scales) and the step of
``train.make_train_step(model="deepergcn")``; and the work of an epoch.

The benchmark's flat parameters follow the port's list (``models/deepergcn.py``):
``0`` the encoder, ``1`` GENConv_0, ``2 .. L`` the ``res+`` blocks, ``L + 1``
the head; a BatchNorm's scale is held as ``{k}.gamma_delta``, the scale
less 1, so that a leaf drawn at nought (``harness/params.py`` draws
uniform in ±bound) is PyTorch's γ = 1. :class:`DeeperGCNTrainer` hands the
port γ and reads it back in that form.

Work, counted from the configuration's shapes and the graph's size, never
from the engine. Dense products: the encoder n·f·h and its weight gradient;
each of the L GENConv linears and the head (n·h·out) with its weight and
input gradients. The aggregation of a layer as the least any
implementation needs (:class:`SoftAgg`, at the bf16 peak or the HBM rate,
whichever binds): forward, the CSR once, the n × h messages read once in
the aggregation dtype, the aggregate and its denominators (n × h float32
each) written, 4·nnz·h operations (the weighted sum and the weights' sum);
backward, the CSR, n × h in the aggregation dtype read, n × h float32
written, 2·nnz·h operations. BatchNorm and the elementwise work are not
counted."""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field

import torch

from benchmark.harness.params import flatten, to_layers
from benchmark.harness.trainer import Trainer, hparams, host_csr, timed_build
from benchmark.harness.work import DTYPE_BYTES, HBM_BYTES_S, PEAK_FLOPS, Gemm, Work, dense_dtype

F32 = 4
DELTA = "gamma_delta"


def leaves(config: dict) -> list:
    """[(name, shape, bound)] in the port's order: W and b of each linear
    with PyTorch's bound 1/√fan_in, a BatchNorm's scale less 1 and its
    shift at nought."""
    f, h, c = config["sizes"]
    out = [("0.W", (f, h), 1 / math.sqrt(f)), ("0.b", (h,), 1 / math.sqrt(f)),
           ("1.W", (h, h), 1 / math.sqrt(h)), ("1.b", (h,), 1 / math.sqrt(h))]
    last = config["layers"] + 1
    for k in range(2, last + 1):
        width = c if k == last else h
        out += [(f"{k}.{DELTA}", (h,), 0.0), (f"{k}.beta", (h,), 0.0),
                (f"{k}.W", (h, width), 1 / math.sqrt(h)), (f"{k}.b", (width,), 1 / math.sqrt(h))]
    return out


@dataclass(frozen=True)
class SoftAgg:
    """One pass of a layer's softmax aggregation: its operations and the
    least bytes it moves, at the bf16 peak or the HBM rate."""

    what: str
    flops: float
    bytes: float

    def least_s(self, cards: int = 1) -> float:
        return max(self.flops / (PEAK_FLOPS["bfloat16"] * cards), self.bytes / (HBM_BYTES_S * cards))


def layer_passes(n: int, nnz: int, d: int, dtype: str) -> list:
    b, csr = DTYPE_BYTES[dtype], 4.0 * nnz + 8.0 * (n + 1)
    return [SoftAgg("forward", 4.0 * nnz * d, csr + b * n * d + 2 * F32 * n * d),
            SoftAgg("backward", 2.0 * nnz * d, csr + b * n * d + F32 * n * d)]


@dataclass
class DeeperGCNWork(Work):
    """:class:`Work` with the softmax aggregation's passes: ``least_s``
    counts them."""

    softagg: list = field(default_factory=list)

    @property
    def softagg_least_s(self) -> float:
        return sum(a.least_s(self.cards) for a in self.softagg)

    @property
    def least_s(self) -> float:
        return self.products_least_s + self.gemms_least_s + self.softagg_least_s


def work(config: dict, n: int, nnz: int) -> DeeperGCNWork:
    (f, h, c), dense = config["sizes"], dense_dtype(config)
    out = DeeperGCNWork(cards=int(config.get("parts", 1)))
    out.gemms += [Gemm(n, f, h, dense), Gemm(f, n, h, dense)]
    for width in [h] * config["layers"] + [c]:
        out.gemms += [Gemm(n, h, width, dense), Gemm(h, n, width, dense), Gemm(n, width, h, dense)]
    for _ in range(config["layers"]):
        out.softagg += layer_passes(n, nnz, h, config["aggregation_dtype"])
    return out


def port_params(flat: dict) -> list:
    """The benchmark's flat parameters as the port's list (γ = 1 + delta)."""
    port = {(k[: -len(DELTA)] + "gamma" if k.endswith(DELTA) else k): (1.0 + v if k.endswith(DELTA) else v.clone())
            for k, v in flat.items()}
    return to_layers(port)


def bench_flat(tree, shift: bool) -> dict:
    """The port's list as the benchmark's flat leaves: ``gamma`` renamed
    ``gamma_delta``, and with ``shift`` less 1 (parameters; a moment is
    not shifted)."""
    out = {}
    for k, v in flatten(tree).items():
        if k.endswith(".gamma"):
            k, v = k[: -len("gamma")] + DELTA, v - 1.0 if shift else v
        out[k] = v
    return out


class DeeperGCNTrainer(Trainer):
    def flat_params(self) -> dict:
        return bench_flat(self.params, shift=True)

    def first_moment(self) -> dict:
        return bench_flat(self.state.m, shift=False)


def port_config(config: dict):
    from mg_gcn_tpu_torch.models.deepergcn import DeeperGCNConfig

    return DeeperGCNConfig(sizes=tuple(config["sizes"]), layers=config["layers"], aggr=config["aggr"], t=config["t"],
                           msg_eps=config["msg_eps"], norm=config["norm"], norm_eps=config["norm_eps"],
                           operand=config["aggregation_dtype"], loss_mask="all")


def build(config: dict, traffic: dict, graph, x, y, params0: dict, devices) -> Trainer:
    """The traffic's ``impl`` is not read: the model runs on the binary walk
    only."""
    from mg_gcn_tpu_torch.models.deepergcn import build_deepergcn_graph
    from mg_gcn_tpu_torch.nn import adam
    from mg_gcn_tpu_torch.train import make_train_step

    dtype = config["aggregation_dtype"]
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"DeeperGCN's aggregation runs in bfloat16 or float32, not {dtype}: its operand is made "
                         "every step, so there is no int8 path")
    dev = devices[0]
    step = make_train_step(port_config(config), hparams(config), optimizer="adam", model="deepergcn")
    pair, build_s = timed_build(lambda: build_deepergcn_graph(host_csr(graph), device=dev), devices)
    params = port_params(params0)
    t = DeeperGCNTrainer(step, params, adam.adam_init(params),
                         (pair, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), None), devices)
    t.build_s, t.engine = build_s, f"binary gather walk ({dtype} operand)"
    print(f"engine {t.engine}, build {build_s:.3f} s", file=sys.stderr)
    return t
