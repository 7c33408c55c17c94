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

A data-parallel loss (``parallel/hvp_sharded.py::ShardedLoss``: the loss
of this rank's rows and the mesh) is accepted wherever a loss is: the
gradient or HVP is taken of the local loss, then summed over the ranks
and divided by their number, outside the ``torch.func`` transform (c10d
collectives have no ``torch.func`` rules, and an autograd all-reduce
would backpropagate a sum, n times too large).  With equal shards that is
the gradient or HVP of the global-batch mean loss, and the normalizations
refer to the global batch size.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Mapping, Optional

import torch

from hessian_llm_vision_tpu_torch.models import precision as precision_tiers
from hessian_llm_vision_tpu_torch.obs.timing import span

Params = Mapping[str, torch.Tensor]
LossFn = Callable[[Params, Any], torch.Tensor]


_HVP_SPAN = span("hvp")


class Normalization(str, enum.Enum):
    MEAN = "mean"
    SUM = "sum"
    DATASET = "dataset"


def split_sharded(loss_fn) -> tuple:
    """``(loss of this rank's rows, the data-parallel loss)`` for a
    ``ShardedLoss``; ``(loss_fn, None)`` for any other loss."""
    local = getattr(loss_fn, "local_loss", None)
    return (loss_fn, None) if local is None else (local, loss_fn)


def _mean_over_ranks(tree: dict, sharded) -> dict:
    """Every leaf of ``tree`` averaged over the ranks, in one all-reduce."""
    names = list(tree)
    flat = torch.cat([tree[n].reshape(-1).float() for n in names])
    sharded.reduce_mean_(flat)
    out, off = {}, 0
    for n in names:
        t = tree[n]
        out[n] = flat[off:off + t.numel()].reshape(t.shape).to(t.dtype)
        off += t.numel()
    return out


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


def _precision_context(prec: Optional[str], loss_fn: Optional[LossFn] = None):
    """The outer precision scope of a curvature product
    (``models.precision.outer_precision``) for any of the JAX names,
    validated here, when the context is made: "high" and "highest" are
    both true fp32; ``None`` keeps the ambient settings.  The model config
    that an LM loss closure carries (``losses.lm_loss_fn``) sets the
    ambient TF32 flag."""
    precision_tiers.tier_of(prec)
    return precision_tiers.outer_precision(prec, getattr(loss_fn, "model_config", None))


def _remat_loss(loss_fn: LossFn) -> LossFn:
    """``loss_fn`` as one rematerialised region of the params' leaves; the
    batch's tensors are its constants."""
    from hessian_llm_vision_tpu_torch.utils.remat import remat

    def loss(params, batch):
        names = list(params)
        keys = [k for k, t in batch.items() if isinstance(t, torch.Tensor)]

        def region(*tensors):
            consts = dict(zip(keys, tensors[len(names):]))
            return loss_fn(dict(zip(names, tensors[:len(names)])), {**batch, **consts})

        return remat(region, *(params[n] for n in names), consts=tuple(batch[k] for k in keys))

    return loss


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
    ``params``).

    ``remat=True`` runs the loss as one rematerialised region
    (``utils/remat.py``; the JAX package's ``jax.checkpoint`` of the
    loss): the same values, its backward recomputing the forward one
    transform level down.  ``torch.func.grad`` alone keeps the forward's
    saved tensors through its whole backward and records the backward
    beside them; the region keeps only one copy of the activations at a
    time (PERF.md: GPT-2 124M's HVP peak at bs16 x seq512 45.4 -> 30.8 GB)."""
    Normalization(normalization)  # validate eagerly
    _precision_context(precision)
    local, sharded = split_sharded(loss_fn)
    fn = _remat_loss(local) if remat else local

    def _hvp(params, batch, vector):
        with _HVP_SPAN:
            scaled = _scaled_loss_fn(fn, batch, normalization, batch_size, dataset_size)
            primals = dict(params)
            tangents = {n: vector[n] for n in primals}  # torch pytrees compare key order
            with _precision_context(precision, loss_fn):
                out = torch.func.jvp(torch.func.grad(scaled), (primals,), (tangents,))[1]
            return out if sharded is None else _mean_over_ranks(out, sharded)

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
    """(loss, grad) in one reverse pass; for a data-parallel loss both are
    averaged over the ranks in one all-reduce."""
    local, sharded = split_sharded(loss_fn)
    grad, loss = torch.func.grad_and_value(lambda p: local(p, batch))(dict(params))
    if sharded is None:
        return loss, grad
    both = _mean_over_ranks({**grad, "\0loss": loss.detach().reshape(1)}, sharded)
    return both.pop("\0loss")[0], both
