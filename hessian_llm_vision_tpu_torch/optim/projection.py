"""Gradient transforms built on a *frozen* saved spectrum (port of
``optim/projection.py``).

The forgetting suppressor trains task B with ``g ← g − Σᵢ (vᵢᵀg)vᵢ`` over
task A's saved eigenbasis; periodic-refresh LanczosSGD reuses a stored
(V, λ) between refreshes.  The basis is constant, so both are plain
:class:`optim.manual.GradientTransformation`s: chain them in front of any
rule, ``chain(project_gradients(V, fl), sgd_momentum(...))``.  The rank-k
apply is ``ops/spectral.py``'s: the CUDA kernel pair on a card.
"""

from __future__ import annotations

import torch

from hessian_llm_vision_tpu_torch.ops.spectral import project_out, spectral_adjust
from hessian_llm_vision_tpu_torch.optim.manual import GradientTransformation
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


def _frozen(apply) -> GradientTransformation:
    """A stateless transform ``g -> unflatten(apply(flatten(g)))``."""

    def init(params):
        return ()

    def update(grads, state, params=None):
        return apply(grads), state

    return GradientTransformation(init, update)


def project_gradients(basis: torch.Tensor, flattener: Flattener) -> GradientTransformation:
    """``g ← g − Σᵢ(vᵢᵀg)vᵢ`` with a fixed orthonormal row basis (k, P)."""
    return _frozen(lambda grads: flattener.unflatten(
        project_out(flattener.flatten(grads), basis)))


def frozen_spectral_adjust(
    basis: torch.Tensor, eigvals: torch.Tensor, delta: float, flattener: Flattener,
) -> GradientTransformation:
    """The Lanczos adjustment with a fixed saved spectrum (the reuse phase
    of periodic-refresh LanczosSGD)."""
    return _frozen(lambda grads: flattener.unflatten(
        spectral_adjust(flattener.flatten(grads), basis, eigvals, delta)))
