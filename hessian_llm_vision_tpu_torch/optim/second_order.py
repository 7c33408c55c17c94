"""Gauss-Newton and natural-gradient steps by CG inverse solves (port of
``optim/second_order.py``): ``p ← p − lr·(G + λI)⁻¹ g`` with the GGN, and
``p ← p − lr·(F + λI)⁻¹ g`` with the Fisher of the negative
log-likelihood, each solved by :func:`krylov.cg.cg_solve`."""

from __future__ import annotations

from typing import Any, Callable

import torch

from hessian_llm_vision_tpu_torch.curvature.ggn import FisherOperator, GGNOperator
from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
from hessian_llm_vision_tpu_torch.krylov.cg import cg_solve
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


def _cg_step(operator, model_fn, out_fn, loss_fn, params_template, *, lr, damping, cg_tol,
             cg_iters):
    fl = Flattener(params_template)

    def step(params, batch):
        loss, grad = grad_and_loss(loss_fn, params, batch)
        g = fl.flatten(grad)
        del grad
        op = operator(model_fn, out_fn, params, batch, damping=damping, flattener=fl)
        res = cg_solve(op.matvec, g, tol=cg_tol, max_iters=cg_iters)
        with torch.no_grad():
            new = {n: t.clone() for n, t in
                   fl.unflatten(fl.flatten(params) - lr * res.x).items()}
        return new, {"loss": loss.detach(), "cg_iters": res.num_iters,
                     "cg_residual": res.residual_norm}

    return step


def make_gauss_newton_step(
    model_fn: Callable,
    out_loss_fn: Callable,
    loss_fn: Callable[[Any, Any], torch.Tensor],
    params_template: Any,
    *,
    lr: float = 1.0,
    damping: float = 1e-3,
    cg_tol: float = 1e-3,
    cg_iters: int = 20,
):
    """``step(params, batch) -> (params, metrics)``: the damped GN update;
    metrics ``loss``, ``cg_iters``, ``cg_residual``."""
    return _cg_step(GGNOperator, model_fn, out_loss_fn, loss_fn, params_template, lr=lr,
                    damping=damping, cg_tol=cg_tol, cg_iters=cg_iters)


def make_natural_gradient_step(
    model_fn: Callable,
    nll_fn: Callable,
    loss_fn: Callable[[Any, Any], torch.Tensor],
    params_template: Any,
    *,
    lr: float = 0.5,
    damping: float = 1e-3,
    cg_tol: float = 1e-3,
    cg_iters: int = 20,
):
    """``p ← p − lr·F⁻¹g`` (the reference's lr is 0.5)."""
    return _cg_step(FisherOperator, model_fn, nll_fn, loss_fn, params_template, lr=lr,
                    damping=damping, cg_tol=cg_tol, cg_iters=cg_iters)
