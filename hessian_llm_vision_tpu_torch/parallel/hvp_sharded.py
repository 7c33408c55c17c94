"""Data-parallel loss, gradient and HVP over a rank mesh (port of
``parallel/hvp_sharded.py``).

The batch is split over the mesh's data axis (``mesh.shard_batch``) and
the parameters are replicated: every rank evaluates its rows, and the
global-batch mean loss is the mean of the ranks' mean losses.  The JAX
package differentiates a ``pmean`` and lets XLA transpose it.  PyTorch's
``torch.func`` transforms cannot see a c10d collective, and the autograd
all-reduce of ``torch.distributed.nn.functional`` backpropagates a sum over
the ranks, n times too large.  So the differentiation stays local:
:class:`ShardedLoss` carries the loss of this rank's rows and the mesh,
and ``curvature/hvp.py`` (``hvp_fn``, ``grad_and_loss``) and
``krylov/driver.py::dataset_matvec`` take the local gradient or HVP, then
sum it over the ranks and divide by their number.  What builds on those
runs over a sharded loss unchanged: the Hessian operators, the host loops
and thick restart, probe-parallel SLQ, the host trainer and the fused
LanczosSGD step.  Engines that differentiate the loss themselves (the
layer-wise step's per-tensor HVP, the GGN's per-example gradients, the
linearized HVP) do not; calling a :class:`ShardedLoss` inside a
``torch.func`` transform, or on parameters that require grad, raises.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator, LinearOperator
from hessian_llm_vision_tpu_torch.parallel.mesh import Mesh
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


class ShardedLoss:
    """The global-batch mean loss of the ranks of ``mesh``, each holding
    its rows (equal shards).  ``local_loss(params, batch)`` is the mean loss
    of this rank's rows; calling the object returns the global mean, a 0-d
    f32 tensor with no graph.  Differentiate it only through
    ``curvature.hvp`` (``hvp_fn``, ``grad_and_loss``) and the Krylov
    drivers, which recognise it."""

    def __init__(self, loss_fn: Callable[[Any, Any], torch.Tensor], mesh: Mesh):
        self.local_loss = loss_fn
        self.mesh = mesh
        # the outer precision scope reads the LM config a loss closure carries
        self.model_config = getattr(loss_fn, "model_config", None)

    def reduce_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over the data axis, in place; returns ``t``."""
        self.mesh.sum_(t, "data")
        if self.mesh.num_data > 1:
            t.div_(self.mesh.num_data)
        return t

    def __call__(self, params, batch) -> torch.Tensor:
        if torch._C._functorch.peek_interpreter_stack() is not None or (
                torch.is_grad_enabled() and any(p.requires_grad for p in params.values())):
            raise TypeError(
                "a ShardedLoss has no gradient of its own: differentiate it through "
                "curvature.hvp (hvp_fn, grad_and_loss) or the Krylov drivers, which take "
                "the local gradient and average it over the ranks")
        with torch.no_grad():
            loss = self.local_loss(params, batch).float().reshape(1).clone()
        return self.reduce_mean_(loss)[0]


def make_sharded_loss(loss_fn: Callable[[Any, Any], torch.Tensor], mesh: Mesh) -> ShardedLoss:
    """Lift a mean-reduction loss to the mesh: each rank passes its rows
    (``shard_batch``), and gradients and HVPs are those of the global mean."""
    return ShardedLoss(loss_fn, mesh)


def sharded_grad_fn(loss_fn: Callable[[Any, Any], torch.Tensor], mesh: Mesh):
    """``(params, batch) -> (global mean loss, grad)``, ``batch`` this
    rank's rows: the whole batch's mean loss and its gradient on every rank."""
    sharded = make_sharded_loss(loss_fn, mesh)
    return lambda params, batch: grad_and_loss(sharded, params, batch)


def ShardedHessianOperator(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    params: Any,
    batch: Any,
    mesh: Mesh,
    *,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    dataset_size: Optional[int] = None,
    remat: bool = False,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
) -> LinearOperator:
    """Data-parallel Hessian operator on flat (P,) vectors, ``batch`` this
    rank's rows.  ``normalization`` refers to the GLOBAL batch (pass the
    global ``batch_size`` for "sum" and "dataset"), so results compare
    with ``HessianOperator`` on the whole batch in one process."""
    return HessianOperator(
        make_sharded_loss(loss_fn, mesh), params, batch, normalization=normalization,
        batch_size=batch_size, dataset_size=dataset_size, remat=remat, precision=precision,
        flattener=flattener,
    )
