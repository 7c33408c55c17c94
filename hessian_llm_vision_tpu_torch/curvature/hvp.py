"""Hessian-vector products, forward-over-reverse (port of ``curvature/hvp.py``).

One engine: ``torch.func.jvp(torch.func.grad(loss))`` over a
``{name: tensor}`` params dict -- two forward+backward passes' worth of
work, no graph retained between calls.  Dict in, dict out; the Krylov
layer lifts it to flat vectors through ``utils.flatten.Flattener``.

Loss normalizations (explicit, as in the JAX package):

* ``"mean"``    -- the batch-mean loss;
* ``"sum"``     -- mean loss * batch_size (the reference's summed loss);
* ``"dataset"`` -- mean loss * batch_size / dataset_size (one batch's share
  of the dataset-mean Hessian).
"""

from __future__ import annotations

import contextlib
import enum
from typing import Any, Callable, Mapping, Optional

import torch

Params = Mapping[str, torch.Tensor]
LossFn = Callable[[Params, Any], torch.Tensor]


class Normalization(str, enum.Enum):
    MEAN = "mean"
    SUM = "sum"
    DATASET = "dataset"


def _scaled_loss_fn(loss_fn, batch, normalization, batch_size, dataset_size):
    """Wrap a mean-reduction loss into the requested normalization."""
    norm = Normalization(normalization)
    if norm is Normalization.SUM and batch_size is None:
        raise ValueError('normalization="sum" requires batch_size')
    if norm is Normalization.DATASET and (batch_size is None or dataset_size is None):
        raise ValueError('normalization="dataset" requires batch_size and dataset_size')

    def scaled(params):
        loss = loss_fn(params, batch)
        if norm is Normalization.SUM:
            return loss * batch_size
        if norm is Normalization.DATASET:
            return loss * (batch_size / dataset_size)
        return loss

    return scaled


@contextlib.contextmanager
def _fp32_matmuls():
    """True fp32 matmuls and convolutions (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _precision_context(precision: Optional[str]):
    """The JAX tiers "high" (bf16x3) and "highest" both map to true fp32;
    ``None`` keeps the ambient settings.  The lower tiers wait for the
    ported precision ladder."""
    if precision is None:
        return contextlib.nullcontext()
    if precision in ("high", "highest"):
        return _fp32_matmuls()
    raise NotImplementedError(
        f"precision={precision!r} is not ported yet (use 'high', 'highest' or None)"
    )


def hvp_fn(
    loss_fn: LossFn,
    *,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    dataset_size: Optional[int] = None,
    remat: bool = False,
    precision: Optional[str] = "high",
) -> Callable[[Params, Any, Params], dict[str, torch.Tensor]]:
    """Build ``(params, batch, vector) -> H @ vector`` (dicts keyed like
    ``params``)."""
    if remat:
        raise NotImplementedError("hvp_fn(remat=True) is not ported yet")
    Normalization(normalization)  # validate eagerly
    _precision_context(precision)

    def _hvp(params, batch, vector):
        scaled = _scaled_loss_fn(loss_fn, batch, normalization, batch_size, dataset_size)
        primals = dict(params)
        tangents = {n: vector[n] for n in primals}  # torch pytrees compare key order
        with _precision_context(precision):
            return torch.func.jvp(torch.func.grad(scaled), (primals,), (tangents,))[1]

    return _hvp


def hvp(
    loss_fn: LossFn,
    params: Params,
    batch: Any,
    vector: Params,
    *,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    dataset_size: Optional[int] = None,
    precision: Optional[str] = "high",
) -> dict[str, torch.Tensor]:
    """H(params) @ vector for the given batch, forward-over-reverse."""
    return hvp_fn(
        loss_fn, normalization=normalization, batch_size=batch_size,
        dataset_size=dataset_size, precision=precision,
    )(params, batch, vector)


def grad_and_loss(
    loss_fn: LossFn, params: Params, batch: Any
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, grad) in one reverse pass."""
    grad, loss = torch.func.grad_and_value(lambda p: loss_fn(p, batch))(dict(params))
    return loss, grad
