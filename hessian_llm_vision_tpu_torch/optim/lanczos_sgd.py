"""LanczosSGD, the fused step and the layer-wise step (port of
``optim/lanczos_sgd.py``).

Per step:

1. the gradient of the batch loss (averaged over ``accum_steps``
   micro-batches, the leading axis of every batch tensor);
2. grad-seeded k-iteration Lanczos with CGS2 reorthogonalization on the
   batch Hessian (an f32 (k, P) basis);
3. Ritz pairs (λᵢ, vᵢ) from ``eigh(T)`` and ``V = Sᵀ Q``;
4. ``g ← g + Σᵢ (1/λᵢ − 1/(λᵢ+δ))(vᵢ·g)vᵢ`` (``ops/spectral.py``, the CUDA
   kernel pair on a card);
5. SGD with momentum and weight decay at the scheduled rate.

``refresh_every=N`` with ``lanczos_momentum=m`` recomputes the eigenspace
every N steps and blends it ``V ← m·V_old + (1−m)·V_new`` (eigenvalues
too), except at step 0.  Under ``accum_steps > 1`` the Lanczos matvec is
the HVP averaged over all micro-batches (the host trainer instead
refreshes on the first).  The layer-wise step runs one Lanczos per
parameter tensor on its diagonal Hessian block and adjusts that tensor's
gradient only.

With ``basis_sharding`` the (k, P) basis is split along P over the ranks
of a mesh (``krylov/sharded.py``): the refresh's Lanczos stores each
rank's range, and each rank adjusts its slice of the gradient with the
rank-k pair on its slice of the basis (pass 1, an all-reduce of the k
coefficients, pass 2); the adjusted slices are gathered, and momentum and
the parameter step act on the whole, replicated parameters.

PyTorch runs eagerly, so "fused" names the JAX package's single program:
here it is one Python step that keeps the whole refresh on the device.
``eigh`` of the k x k tridiagonal runs on the host in LAPACK's ``syevd``
through SciPy, the routine and the eigenvector signs of the JAX package's
CPU ``eigh``: the EMA blend of Ritz vectors depends on those signs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from hessian_llm_vision_tpu_torch.curvature.hvp import (
    _precision_context,
    grad_and_loss,
    hvp_fn,
)
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.krylov.sharded import p_shard
from hessian_llm_vision_tpu_torch.ops.spectral import adjust_coeffs, spectral_adjust
from hessian_llm_vision_tpu_torch.optim.manual import (
    ScheduleOrFloat,
    _lr_at,
    apply_updates,
    sgd_momentum,
)
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener, flat_order
from hessian_llm_vision_tpu_torch.utils.norms import norm


@dataclasses.dataclass(frozen=True)
class LanczosSGDConfig:
    k: int = 10
    delta: float = 1e-4
    lr: ScheduleOrFloat = 1e-3
    momentum: float = 0.9
    weight_decay: float = 0.0
    refresh_every: int = 1
    lanczos_momentum: float = 0.0
    accum_steps: int = 1
    normalization: str = "sum"  # HVP scaling; "sum" == loss *= batch_size
    remat: bool = False


class LanczosSGDState(NamedTuple):
    params: dict
    momentum: dict
    step: int
    eigvals: torch.Tensor  # (k,) f32
    basis: torch.Tensor  # (k, P) f32


def _micro(batch, i: int) -> dict:
    return {k: v[i] for k, v in batch.items()}


def _grad_and_loss(loss_fn, params, batch, accum_steps: int):
    """Mean loss and gradient, summed over micro-batches in order when
    ``accum_steps > 1`` (the JAX package's scan), then scaled by
    ``1/accum_steps``."""
    if accum_steps == 1:
        return grad_and_loss(loss_fn, params, batch)
    names = list(params)
    loss = torch.zeros((), dtype=torch.float32, device=params[names[0]].device)
    acc = [torch.zeros_like(params[n]) for n in names]
    for i in range(accum_steps):
        l_i, g_i = grad_and_loss(loss_fn, params, _micro(batch, i))
        loss = loss + l_i
        torch._foreach_add_(acc, [g_i[n] for n in names])
        del g_i
    inv = 1.0 / accum_steps
    return loss * inv, dict(zip(names, torch._foreach_mul(acc, inv)))


def _accum_hvp(hvp, params, batch, accum_steps: int):
    """The micro-batch-averaged HVP as ``vector dict -> dict``."""
    if accum_steps == 1:
        return lambda vt: hvp(params, batch, vt)

    def matvec(vt):
        names = list(params)
        acc = [torch.zeros_like(params[n]) for n in names]
        for i in range(accum_steps):
            out = hvp(params, _micro(batch, i), vt)
            torch._foreach_add_(acc, [out[n] for n in names])
            del out
        return dict(zip(names, torch._foreach_div(acc, accum_steps)))

    return matvec


def ritz_from_tridiag(res) -> tuple[torch.Tensor, torch.Tensor]:
    """``(eigvals (m,) f32, V (m, P) f32)`` of a stored-basis Lanczos run:
    ``eigh(T)`` in f32 by LAPACK ``syevd`` on the host (see the module
    docstring), then ``V = Sᵀ Q`` on the basis's device."""
    import scipy.linalg

    T = res.tridiag().detach().to("cpu", torch.float32).numpy()
    ev, evec = scipy.linalg.eigh(T, driver="evd")
    dev = res.basis.device
    eigvals = torch.as_tensor(ev, dtype=torch.float32, device=dev)
    V = torch.as_tensor(evec.T, dtype=torch.float32, device=dev) @ res.basis
    return eigvals, V


def _momentum_step(cfg, state, adjusted: dict):
    """``optim.manual.sgd_momentum`` on the adjusted gradient: ``buf = μ·buf
    + (g + wd·p)``, ``p ← p − lr·buf``; new tensors."""
    tx = sgd_momentum(cfg.lr, cfg.momentum, cfg.weight_decay)
    updates, opt = tx.update(adjusted, {"step": state.step, "momentum": state.momentum},
                             state.params)
    return apply_updates(state.params, updates), opt["momentum"]


@torch.no_grad()
def _blend_rows_(new: torch.Tensor, old: torch.Tensor, m: float) -> None:
    """``new ← m·old + (1−m)·new``, one row at a time (no (k, P) transient)."""
    for i in range(new.shape[0]):
        new[i] = m * old[i] + (1 - m) * new[i]


def make_lanczos_sgd_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    params_template: Any,
    config: LanczosSGDConfig,
    *,
    batch_size: Optional[int] = None,
    basis_sharding=None,
):
    """Returns ``(init_fn, step_fn)``.

    ``init_fn(params) -> LanczosSGDState`` (the basis zeros until the first
    refresh); ``step_fn(state, batch) -> (state, metrics)`` with metrics
    ``loss, grad_norm, eig_max, eig_min, lr``.  ``batch_size`` is required
    for the "sum" HVP normalization (the reference's
    ``loss *= len(input_ids)``).  The refresh's Lanczos basis is freed as
    soon as the Ritz vectors are formed.  ``basis_sharding``
    (``parallel.mesh.basis_sharding``): every rank of the mesh steps with
    the same params, and ``state.basis`` is its (k, width) block of the
    basis's columns; ``loss_fn`` may be a data-parallel ``ShardedLoss``.
    """
    fl = Flattener(params_template)
    cfg = config
    sh = p_shard(basis_sharding, fl.size)
    _hvp = hvp_fn(loss_fn, normalization=cfg.normalization, batch_size=batch_size,
                  remat=cfg.remat)

    def init_fn(params) -> LanczosSGDState:
        device = next(iter(params.values())).device
        cols = fl.size if sh is None else sh.width
        return LanczosSGDState(
            params=dict(params),
            momentum={n: torch.zeros_like(p) for n, p in params.items()},
            step=0,
            eigvals=torch.ones(cfg.k, dtype=torch.float32, device=device),
            basis=torch.zeros((cfg.k, cols), dtype=torch.float32, device=device),
        )

    def fresh_spectrum(params, batch, g_flat):
        matvec_tree = _accum_hvp(_hvp, params, batch, cfg.accum_steps)
        res = lanczos(lambda v: fl.flatten(matvec_tree(fl.unflatten(v))), fl.size, cfg.k,
                      v0=g_flat, reorth=True, store_basis=True, basis_sharding=basis_sharding)
        return ritz_from_tridiag(res)

    def adjust(g_flat, V, eigvals):
        if sh is None:
            return spectral_adjust(g_flat, V, eigvals, cfg.delta)
        return sh.gather(sh.rank_k(sh.part(g_flat), V, adjust_coeffs(eigvals, cfg.delta)))

    def step_fn(state: LanczosSGDState, batch):
        loss, grad = _grad_and_loss(loss_fn, state.params, batch, cfg.accum_steps)
        g_flat = fl.flatten(grad)
        del grad
        eigvals, V = state.eigvals, state.basis
        if state.step % cfg.refresh_every == 0:
            eigvals, V = fresh_spectrum(state.params, batch, g_flat)
            m = cfg.lanczos_momentum
            if m > 0 and state.step != 0:  # step 0: no EMA of the placeholders
                eigvals = m * state.eigvals + (1 - m) * eigvals
                _blend_rows_(V, state.basis, m)
        adjusted = fl.unflatten(adjust(g_flat, V, eigvals))
        params, buf = _momentum_step(cfg, state, adjusted)
        metrics = {
            "loss": loss.detach(),
            "grad_norm": norm(g_flat) if sh is None else sh.norm(sh.part(g_flat)),
            "eig_max": eigvals[-1],
            "eig_min": eigvals[0],
            "lr": _lr_at(cfg.lr, state.step),
        }
        return LanczosSGDState(params, buf, state.step + 1, eigvals, V), metrics

    return init_fn, step_fn


class LayerwiseLanczosSGDState(NamedTuple):
    params: dict
    momentum: dict
    step: int


def make_layerwise_lanczos_sgd_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    params_template: Any,
    config: LanczosSGDConfig,
    *,
    batch_size: Optional[int] = None,
    min_leaf_size: int = 2,
):
    """Per-parameter-tensor LanczosSGD.

    For every tensor, in the flat order: a grad-seeded ``k_i = min(k,
    size)``-iteration reorthogonalised Lanczos of its diagonal Hessian block
    -- the HVP a ``torch.func.jvp`` of the gradient of the loss in that
    tensor alone, the others held fixed, in fp32 -- then the spectral
    adjustment of its gradient.  Tensors with ``size < min_leaf_size`` or
    ``k_i < 2`` pass through unadjusted.  Every step refreshes;
    ``refresh_every``, ``lanczos_momentum`` and ``accum_steps`` do not apply.
    Metrics: ``loss``, ``layer_eig_max``, ``layer_eig_min`` (one entry per
    adjusted tensor).
    """
    cfg = config
    names = flat_order(params_template)
    if cfg.normalization == "sum" and batch_size is None:
        raise ValueError('normalization="sum" requires batch_size')
    hvp_scale = float(batch_size) if cfg.normalization == "sum" else 1.0

    def init_fn(params) -> LayerwiseLanczosSGDState:
        return LayerwiseLanczosSGDState(
            params=dict(params),
            momentum={n: torch.zeros_like(p) for n, p in params.items()},
            step=0,
        )

    def leaf_matvec(params, batch, name):
        p_leaf = params[name]

        def leaf_loss(x):
            return hvp_scale * loss_fn({**params, name: x}, batch)

        def matvec(v):
            with _precision_context("highest", loss_fn):
                out = torch.func.jvp(torch.func.grad(leaf_loss), (p_leaf,),
                                     (v.view(p_leaf.shape).to(p_leaf.dtype),))[1]
            return out.reshape(-1).float()

        return matvec

    def step_fn(state: LayerwiseLanczosSGDState, batch):
        loss, grad = grad_and_loss(loss_fn, state.params, batch)
        adjusted, eig_max, eig_min = {}, [], []
        for name in names:
            size = state.params[name].numel()
            k_i = min(cfg.k, size)
            if size < min_leaf_size or k_i < 2:
                adjusted[name] = grad[name]
                continue
            g_leaf = grad[name].reshape(-1).float()
            res = lanczos(leaf_matvec(state.params, batch, name), size, k_i, v0=g_leaf,
                          reorth=True, store_basis=True)
            eigvals, V = ritz_from_tridiag(res)
            del res
            adjusted[name] = spectral_adjust(g_leaf, V, eigvals, cfg.delta).view(
                grad[name].shape).to(grad[name].dtype)
            eig_max.append(eigvals[-1])
            eig_min.append(eigvals[0])
        del grad
        params, buf = _momentum_step(cfg, state, adjusted)
        device = loss.device
        metrics = {
            "loss": loss.detach(),
            "layer_eig_max": torch.stack(eig_max) if eig_max else torch.zeros(0, device=device),
            "layer_eig_min": torch.stack(eig_min) if eig_min else torch.zeros(0, device=device),
        }
        return LayerwiseLanczosSGDState(params, buf, state.step + 1), metrics

    return init_fn, step_fn
