"""The numbers that decide ``correct``: the program's first steps against
the plain reference's, from the same inputs and initial parameters.

- ``loss_gap``: the largest |loss - reference loss| / |reference loss| over
  the steps.
- ``grad_gap``: the first step's gradient as the optimizer got it, worked
  out from the program's Adam state after that step
  (m / (1 - beta1), less the coupled weight decay wd·W of a weight matrix);
  by the worst leaf, the gap between the program's norm of the leaf and the
  reference's, over the larger of the reference's norm of that leaf and of
  the median leaf.
- ``change_gap``: the parameters' change after the steps, by the worst leaf
  as ``grad_gap``, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves under Adam by round-off alone).
- ``grad_dir``: the first gradient's leaves as ``grad_gap``, by the norm of
  the difference ||program - reference|| over the same scale. A gap of norms
  sees only the error along the reference; this sees an error in any
  direction, such as a gradient taken over part of the rows, whose norm is
  nearly the whole's.
"""

from __future__ import annotations

import math
import statistics

import torch

KEEP_FRACTION = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_dir")


def is_decayed(name: str) -> bool:
    return name.rsplit(".", 1)[-1].startswith("W")


def program_record(losses, m1: dict, params0: dict, params_end: dict, opt: dict) -> dict:
    """The program's record in the reference's form (common.train)."""
    grad1 = {}
    for k, m in m1.items():
        g = m.double() / (1.0 - opt["beta1"])
        if opt["weight_decay"] and is_decayed(k):
            g = g - opt["weight_decay"] * params0[k].double().to(g.device)
        grad1[k] = g
    change = {k: params_end[k].double().to(params0[k].device) - params0[k].double() for k in params_end}
    return dict(losses=list(losses), grad1=grad1, change=change)


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def scaled(prog: dict, ref: dict, keep=None, diff: bool = False) -> dict:
    """{leaf: reading} over the leaves in ``keep`` (all by default): the gap
    of the two norms, or with ``diff`` the norm of the difference, over the
    larger of the reference leaf's norm and the median leaf's."""
    keep = list(ref) if keep is None else keep
    rn = _norms({k: ref[k] for k in keep})
    if diff:
        got = _norms({k: prog[k].double().to(ref[k].device) - ref[k].double() for k in keep})
    else:
        pn = _norms({k: prog[k] for k in keep})
        got = {k: abs(pn[k] - rn[k]) for k in keep}
    med = statistics.median(rn.values())
    out = {k: got[k] / max(rn[k], med) if max(rn[k], med) > 0 else math.inf for k in keep}
    return {k: g if math.isfinite(g) else math.inf for k, g in out.items()}


def worst_leaf(prog: dict, ref: dict, keep=None, diff: bool = False) -> tuple[float, str]:
    """(the largest reading of :func:`scaled`, its leaf)."""
    got = scaled(prog, ref, keep, diff)
    k = max(got, key=got.get)
    return got[k], k


def kept(ref: dict) -> list:
    """The leaves whose reference gradient is at least :data:`KEEP_FRACTION`
    of the median leaf's."""
    gn = _norms(ref["grad1"])
    med = statistics.median(gn.values())
    return [k for k in ref["grad1"] if gn[k] >= KEEP_FRACTION * med]


def numbers(prog: dict, ref: dict) -> dict:
    """{name: (value, what)} of :data:`NUMBERS`; a non-finite loss reads inf."""
    pairs = list(zip(prog["losses"], ref["losses"]))
    if not all(math.isfinite(a) and math.isfinite(b) for a, b in pairs):
        return {k: (math.inf, "non-finite loss") for k in NUMBERS}
    loss = max((abs(a - b) / abs(b), f"step {s + 1}") for s, (a, b) in enumerate(pairs))
    keep = kept(ref)
    return {"loss_gap": loss,
            "grad_gap": worst_leaf(prog["grad1"], ref["grad1"]),
            "change_gap": worst_leaf(prog["change"], ref["change"], keep),
            "grad_dir": worst_leaf(prog["grad1"], ref["grad1"], diff=True)}
