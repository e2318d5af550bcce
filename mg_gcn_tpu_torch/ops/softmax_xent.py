"""Numerically-stable softmax + cross-entropy loss over all rows.

Port of ``mg_gcn_tpu/ops/softmax_xent.py`` (reference gcn.hpp:639-935):

* softmax in the reference's op order: row max, exp(x - max), row sum,
  divide (gcn.hpp:651-675);
* loss = mean over **all** n rows of -log(softmax[row, Y[row]]) when no mask
  is given (the reference never consults sets.bin, main.cpp:85), with the
  probability clamped at ``finfo.tiny`` before the log;
* gradient (softmax - onehot(Y)) / n (gcn.hpp:785-818); with a mask, masked
  rows get zero gradient and n becomes the mask count;
* accuracy = fraction of rows whose argmax (first index on ties) is the label.

Every op is differentiable, so exact mode can take autograd through the loss
as the JAX package takes ``jax.grad`` through it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .elementwise import max_rows, subtract_rows_exp


class LossOut(NamedTuple):
    loss: torch.Tensor  # scalar
    acc: torch.Tensor  # scalar
    grad: torch.Tensor  # (n, c) gradient wrt logits


def softmax(x: torch.Tensor) -> torch.Tensor:
    e = subtract_rows_exp(x, max_rows(x))
    return e / torch.sum(e, dim=-1, keepdim=True)


def softmax_xent(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None
) -> LossOut:
    """Loss, accuracy and the logits gradient in one pass.

    ``labels`` is int (n,) or (n, 1); ``mask`` an optional boolean (n,) row
    mask, None reproducing the reference's all-rows behaviour.
    """
    y = labels.reshape(-1).long()
    n, c = logits.shape
    o = softmax(logits)
    p = torch.gather(o, 1, y[:, None])[:, 0]
    logp = torch.log(torch.clamp(p, min=torch.finfo(o.dtype).tiny))
    pred = torch.argmax(o.detach(), dim=-1)
    correct = (pred == y).to(logits.dtype)
    onehot = F.one_hot(y, c).to(o.dtype)
    if mask is None:
        g = (o - onehot) / n
        loss = -torch.sum(logp) / n
        acc = torch.sum(correct) / n
    else:
        m = mask.reshape(-1).to(logits.dtype)
        denom = torch.clamp(torch.sum(m), min=1)
        g = (o - onehot) * m[:, None] / denom
        loss = -torch.sum(logp * m) / denom
        acc = torch.sum(correct * m) / denom
    return LossOut(loss=loss, acc=acc, grad=g.detach())
