"""Matrix-free linear operators on flat f32 ℝᴾ vectors (port of
``curvature/operators.py``).

An operator owns a ``matvec`` on flat f32 vectors and its dimension ``P``,
nothing else; Krylov solvers call the ``matvec`` directly.  PyTorch runs
eagerly, so a matvec is a plain Python function over the params and
batches it closes over; the JAX package's scan over stacked batches is a
loop over a list of batch dicts here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence

import torch

from hessian_llm_vision_tpu_torch.curvature.hvp import LossFn, Params, hvp_fn, split_sharded
from hessian_llm_vision_tpu_torch.utils import trees
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener, flat_order


@dataclasses.dataclass
class LinearOperator:
    """A symmetric matrix-free operator: ``matvec: (P,) f32 -> (P,) f32``."""

    matvec: Callable[[torch.Tensor], torch.Tensor]
    dim: int

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)

    def shifted(self, sigma: float) -> "LinearOperator":
        """A + sigma*I (damping)."""
        base = self.matvec
        return LinearOperator(lambda v: base(v) + sigma * v, self.dim)

    def scaled(self, alpha: float) -> "LinearOperator":
        base = self.matvec
        return LinearOperator(lambda v: alpha * base(v), self.dim)


def MatrixOperator(mat: torch.Tensor) -> LinearOperator:
    """Dense symmetric matrix as an operator (test fixtures)."""
    return LinearOperator(lambda v: mat.float() @ v.float(), mat.shape[0])


def HessianOperator(
    loss_fn: LossFn,
    params: Params,
    batch: Any,
    *,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    dataset_size: Optional[int] = None,
    remat: bool = False,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
) -> LinearOperator:
    """Single-batch Hessian of ``loss_fn`` at ``params``."""
    fl = flattener or Flattener(params)
    _hvp = hvp_fn(loss_fn, normalization=normalization, batch_size=batch_size,
                  dataset_size=dataset_size, remat=remat, precision=precision)
    return LinearOperator(lambda v: fl.flatten(_hvp(params, batch, fl.unflatten(v))), fl.size)


def DatasetHessianOperator(
    loss_fn: LossFn,
    params: Params,
    batches: Sequence[Any],
    *,
    normalization: str = "dataset",
    batch_size: Optional[int] = None,
    dataset_size: Optional[int] = None,
    remat: bool = True,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
) -> LinearOperator:
    """Hessian of the whole dataset, ``batches`` a list of equal-size batches.

    Normalization over the WHOLE dataset (as ``krylov.driver
    .dataset_spectrum_host``): ``"dataset"`` / ``"mean"`` give the Hessian
    of the dataset-mean loss, ``"sum"`` that of the dataset-summed loss
    (= dataset_size x mean).  ``remat=True`` (the default, as in the JAX
    package) recomputes each batch's forward in its backward (``hvp_fn``).
    For a data-parallel ``ShardedLoss`` the batches are this rank's rows,
    and the default ``batch_size`` is the global one (the rows times the
    ranks).
    """
    fl = flattener or Flattener(params)
    num_batches = len(batches)
    if batch_size is None:
        batch_size = next(iter(batches[0].values())).shape[0]
        sharded = split_sharded(loss_fn)[1]
        if sharded is not None:
            batch_size *= sharded.mesh.num_data
    if dataset_size is None:
        dataset_size = num_batches * batch_size
    _hvp = hvp_fn(loss_fn, normalization=normalization, batch_size=batch_size,
                  dataset_size=dataset_size, remat=remat, precision=precision)
    # per-batch contributions: "dataset" -> mean*(batch/N) sums to the
    # dataset mean; "mean" -> per-batch means must be averaged; "sum" ->
    # per-batch means*batch_size sum to the dataset-summed loss
    post_scale = 1.0 / num_batches if normalization == "mean" else 1.0

    def matvec(v):
        vt = fl.unflatten(v)
        acc = torch.zeros(fl.size, dtype=torch.float32, device=v.device)
        for batch in batches:
            acc += fl.flatten(_hvp(params, batch, vt))
        return acc * post_scale

    return LinearOperator(matvec, fl.size)


def LayerHessianOperator(
    loss_fn: LossFn,
    params: Params,
    batch: Any,
    mask: Mapping[str, bool],
    *,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    dataset_size: Optional[int] = None,
    flattener: Optional[Flattener] = None,
) -> LinearOperator:
    """Diagonal-block Hessian restricted to the masked parameters:
    ``v -> M H (M v)``, ``mask`` a ``{name: bool}`` from
    ``utils.trees.subtree_mask``."""
    fl = flattener or Flattener(params)
    _hvp = hvp_fn(loss_fn, normalization=normalization, batch_size=batch_size,
                  dataset_size=dataset_size)

    def matvec(v):
        vt = trees.mask_tree(fl.unflatten(v), mask)
        return fl.flatten(trees.mask_tree(_hvp(params, batch, vt), mask))

    return LinearOperator(matvec, fl.size)


def BlockDiagonalOperator(
    loss_fn: LossFn,
    params: Params,
    batch: Any,
    masks: Optional[Sequence[Mapping[str, bool]]] = None,
    *,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    dataset_size: Optional[int] = None,
    flattener: Optional[Flattener] = None,
) -> LinearOperator:
    """Block-diagonal Hessian action ``v -> Σᵢ Mᵢ H (Mᵢ v)``, one HVP per
    block.  With ``masks=None`` every parameter leaf is its own block."""
    fl = flattener or Flattener(params)
    if masks is None:
        masks = [{n: n == leaf for n in params} for leaf in flat_order(params)]
    _hvp = hvp_fn(loss_fn, normalization=normalization, batch_size=batch_size,
                  dataset_size=dataset_size)

    def matvec(v):
        vt = fl.unflatten(v)
        acc = torch.zeros(fl.size, dtype=torch.float32, device=v.device)
        for mask in masks:
            acc += fl.flatten(trees.mask_tree(_hvp(params, batch, trees.mask_tree(vt, mask)), mask))
        return acc

    return LinearOperator(matvec, fl.size)
