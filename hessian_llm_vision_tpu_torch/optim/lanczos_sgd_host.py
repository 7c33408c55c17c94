"""Host-driven LanczosSGD (port of ``optim/lanczos_sgd_host.py``).

Per step: one gradient (optionally accumulated over micro-batches); every
``refresh_every`` steps a grad-seeded k-iteration Lanczos of the batch
Hessian (k HVPs, three-term recurrence without reorthogonalization, rows
stored in ``basis_dtype``), a host ``numpy.linalg.eigh`` of T and the Ritz
rotation; then the rank-k spectral adjustment of the gradient
(``ops/spectral.py``, the CUDA kernel pair on a card) and an SGD step with
momentum and weight decay.

Memory at GPT-2 124M scale: the (k, P) Lanczos rows live in ONE
preallocated buffer written in place, and the EMA blend runs row by row
in place, so no f32 (k, P) transient is formed for a bf16 basis.
``step`` updates ``state.params`` and ``state.momentum`` IN PLACE under
``torch.no_grad()`` -- the tensors given to :meth:`init` are the ones that
change; pass clones if the caller needs the originals.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp_fn
from hessian_llm_vision_tpu_torch.krylov.lanczos import host_recurrence_step
from hessian_llm_vision_tpu_torch.ops.spectral import spectral_adjust
from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import LanczosSGDConfig
from hessian_llm_vision_tpu_torch.optim.manual import _lr_at
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

Params = dict[str, torch.Tensor]


def _map_batch(fn: Callable[[torch.Tensor], torch.Tensor], batch: Mapping) -> dict:
    """Apply ``fn`` to every tensor of a dict batch."""
    return {k: fn(v) for k, v in batch.items()}


@dataclasses.dataclass
class HostLanczosSGDState:
    """Mutable state: ``step`` updates it in place, so the stale (k, P)
    basis can be freed before a refresh allocates the new one."""

    params: Params
    momentum: Params
    step: int
    eigvals: torch.Tensor  # (k,) f32
    basis: Optional[torch.Tensor]  # (k, P) in basis_dtype, None before 1st refresh


class HostLanczosSGDTrainer:
    """``step(state, batch)`` driven from the host; refreshes every
    ``config.refresh_every`` steps with grad-seeded Lanczos."""

    def __init__(
        self,
        loss_fn: Callable[[Params, Any], torch.Tensor],
        params_template: Mapping[str, torch.Tensor],
        config: LanczosSGDConfig,
        *,
        batch_size: Optional[int] = None,
        basis_dtype: torch.dtype = torch.float32,
        refresh_batch_size: Optional[int] = None,
        refresh_precision: str = "high",
        refresh_linearized: bool = False,
    ):
        """``basis_dtype=torch.bfloat16`` halves the stored (k, P) basis;
        the Lanczos recurrence stays f32.  ``refresh_batch_size``: run the
        refresh HVPs on only the first N sequences of the batch.
        ``refresh_precision``: "high" or "highest" (both true fp32 here).
        ``config.accum_steps > 1``: batch tensors carry a leading
        ``(accum, batch, ...)`` axis; the step averages the micro-batch
        gradients and refreshes on the first micro-batch."""
        if refresh_linearized:
            raise NotImplementedError("refresh_linearized is not ported yet")
        self.cfg = config
        self.basis_dtype = basis_dtype
        self.refresh_batch_size = refresh_batch_size
        self.loss_fn = loss_fn
        self.fl = Flattener(params_template)
        self._hvp = hvp_fn(
            loss_fn, normalization=config.normalization, batch_size=batch_size,
            remat=config.remat, precision=refresh_precision,
        )

    @property
    def precision_guard(self):
        return None

    @precision_guard.setter
    def precision_guard(self, guard):
        raise NotImplementedError("the refresh precision guard is not ported yet")

    def init(self, params: Params) -> HostLanczosSGDState:
        device = next(iter(params.values())).device
        return HostLanczosSGDState(
            params=dict(params),
            momentum={n: torch.zeros_like(p) for n, p in params.items()},
            step=0,
            eigvals=torch.ones(self.cfg.k, dtype=torch.float32, device=device),
            basis=None,
        )

    def _grad(self, params: Params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        loss, grad = grad_and_loss(self.loss_fn, params, batch)
        return loss.detach(), self.fl.flatten(grad)

    def _hvp_flat(self, v: torch.Tensor, params: Params, batch) -> torch.Tensor:
        return self.fl.flatten(self._hvp(params, batch, self.fl.unflatten(v)))

    def refresh_spectrum(self, params: Params, batch, g_flat: torch.Tensor):
        """Grad-seeded k-iteration Lanczos; returns (eigvals (k,) f32,
        Ritz basis (k, P) in ``basis_dtype``)."""
        k = self.cfg.k
        basis = torch.zeros((k, g_flat.shape[0]), dtype=self.basis_dtype, device=g_flat.device)
        q_cur = g_flat / torch.clamp(torch.linalg.vector_norm(g_flat), min=1e-30)
        q_prev = torch.zeros_like(q_cur)
        beta_prev = torch.zeros((), dtype=torch.float32, device=g_flat.device)
        alphas, betas = [], []
        for i in range(k):
            basis[i] = q_cur  # in-place row write, cast to basis_dtype
            w = self._hvp_flat(q_cur, params, batch)
            alpha, beta, q_next = host_recurrence_step(w, q_cur, q_prev, beta_prev)
            q_prev, q_cur, beta_prev = q_cur, q_next, beta
            alphas.append(float(alpha))
            betas.append(float(beta))
        del q_prev, q_cur, w
        a = np.asarray(alphas)
        b = np.asarray(betas)[:-1]
        ev, evec = np.linalg.eigh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))
        # Ritz rotation SᵀQ in basis_dtype: no f32 (k, P) transient
        evecs = torch.as_tensor(evec.T, dtype=torch.float32, device=basis.device)
        V = torch.matmul(evecs.to(basis.dtype), basis)
        return torch.as_tensor(ev, dtype=torch.float32, device=basis.device), V

    @torch.no_grad()
    def _ema_blend_(self, old: torch.Tensor, new: torch.Tensor) -> None:
        """``old ← m·old + (1−m)·new`` in f32, stored in ``basis_dtype``,
        one row at a time."""
        m = self.cfg.lanczos_momentum
        for i in range(old.shape[0]):
            old[i] = m * old[i].float() + (1.0 - m) * new[i].float()

    @torch.no_grad()
    def _adjust_update(self, state: HostLanczosSGDState, g_flat: torch.Tensor) -> None:
        cfg = self.cfg
        adj = spectral_adjust(g_flat, state.basis, state.eigvals, cfg.delta)
        lr_t = _lr_at(cfg.lr, state.step)
        for name, a in self.fl.unflatten(adj).items():
            p, buf = state.params[name], state.momentum[name]
            if cfg.weight_decay:
                a = a + cfg.weight_decay * p
            buf.mul_(cfg.momentum).add_(a)
            p.sub_(lr_t * buf)

    def step(self, state: HostLanczosSGDState, batch):
        """Advance one step IN PLACE; returns (state, metrics)."""
        accum = max(self.cfg.accum_steps, 1)
        if accum > 1:
            losses, g_flat = [], None
            for i in range(accum):
                loss_i, g_i = self._grad(state.params, _map_batch(lambda x, i=i: x[i], batch))
                losses.append(loss_i)
                if g_flat is None:
                    g_flat = torch.zeros_like(g_i)
                g_flat += (1.0 / accum) * g_i
            loss = torch.stack(losses).mean()
            # refresh on the first micro-batch (sub-batch approximation)
            batch = _map_batch(lambda x: x[0], batch)
        else:
            loss, g_flat = self._grad(state.params, batch)
        if state.step % self.cfg.refresh_every == 0 or state.basis is None:
            m = self.cfg.lanczos_momentum
            use_ema = m > 0 and state.step > 0 and state.basis is not None
            if not use_ema:
                state.basis = None  # free the stale basis before the refresh
            rbatch = batch
            if self.refresh_batch_size is not None:
                rbatch = _map_batch(lambda x: x[: self.refresh_batch_size], batch)
            new_ev, new_V = self.refresh_spectrum(state.params, rbatch, g_flat)
            if use_ema:
                state.eigvals = m * state.eigvals + (1 - m) * new_ev
                self._ema_blend_(state.basis, new_V)
                del new_V
            else:
                state.eigvals, state.basis = new_ev, new_V
        self._adjust_update(state, g_flat)
        state.step += 1
        metrics = {
            "loss": loss,
            "eig_max": state.eigvals[-1],
            "eig_min": state.eigvals[0],
        }
        return state, metrics


class HostLayerwiseLanczosSGDTrainer:
    """Layer-wise (block-diagonal) host LanczosSGD: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("HostLayerwiseLanczosSGDTrainer is not ported yet")
