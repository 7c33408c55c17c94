"""Host-driven LanczosSGD (port of ``optim/lanczos_sgd_host.py``).

Per step: one gradient (optionally accumulated over micro-batches); every
``refresh_every`` steps a grad-seeded k-iteration Lanczos of the batch
Hessian (k HVPs, or with ``refresh_linearized`` one residual pass and k
tangent maps; three-term recurrence without reorthogonalization, rows
stored in ``basis_dtype``), a host ``numpy.linalg.eigh`` of T and the Ritz
rotation; then the rank-k spectral adjustment of the gradient
(``ops/spectral.py``, the CUDA kernel pair on a card) and an SGD step with
momentum and weight decay.  :class:`HostLayerwiseLanczosSGDTrainer` does
the same per parameter tensor, on the diagonal blocks of the Hessian.

Memory at GPT-2 124M scale: the (k, P) Lanczos rows live in ONE
preallocated buffer written in place, and the EMA blend runs row by row
in place, so no f32 (k, P) transient is formed for a bf16 basis.
``step`` updates ``state.params`` and ``state.momentum`` IN PLACE under
``torch.no_grad()`` -- the tensors given to :meth:`init` are the ones that
change; pass clones if the caller needs the originals.

With ``basis_sharding`` (``parallel.mesh.basis_sharding``, and the one way
to run a model-parallel loss, whose flat vectors are each rank's own:
``utils/flatten.py::ModelAxisLayout``) the refresh's vectors and the stored
basis are this rank's parts (``krylov/sharded.py``), and the adjust runs
the rank-k pair on them with one all-reduce of its k coefficients between
the passes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp_fn
from hessian_llm_vision_tpu_torch.krylov.lanczos import host_recurrence_step
from hessian_llm_vision_tpu_torch.krylov.sharded import p_shard
from hessian_llm_vision_tpu_torch.ops.spectral import adjust_coeffs, spectral_adjust
from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import LanczosSGDConfig
from hessian_llm_vision_tpu_torch.optim.manual import _lr_at
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener
from hessian_llm_vision_tpu_torch.utils.norms import norm

Params = dict[str, torch.Tensor]


def _host_ritz(alphas: list, betas: list, rows: torch.Tensor):
    """``eigh`` of T from host floats (numpy, float64), and the Ritz
    rotation ``SᵀQ`` of the Lanczos rows in their own dtype (no f32 (k, P)
    transient for a bf16 basis); returns (eigvals (k,) f32, V)."""
    a = np.asarray(alphas)
    b = np.asarray(betas)[:-1]
    ev, evec = np.linalg.eigh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))
    evecs = torch.as_tensor(evec.T, dtype=torch.float32, device=rows.device)
    return (torch.as_tensor(ev, dtype=torch.float32, device=rows.device),
            torch.matmul(evecs.to(rows.dtype), rows))


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
        basis_sharding=None,
    ):
        """``basis_dtype=torch.bfloat16`` halves the stored (k, P) basis;
        the Lanczos recurrence stays f32.  ``refresh_batch_size``: run the
        refresh HVPs on only the first N sequences of the batch.
        ``refresh_precision``: the outer precision of the refresh HVPs, any
        tier of ``models/precision.py`` ("high" and "highest" are both true
        fp32).  ``precision_guard`` (an
        ``optim.precision_guard.RefreshPrecisionGuard``, None by default)
        is consulted before every refresh; its escalations land through
        :meth:`set_refresh_tier`.
        ``config.accum_steps > 1``: batch tensors carry a leading
        ``(accum, batch, ...)`` axis; the step averages the micro-batch
        gradients and refreshes on the first micro-batch.
        ``refresh_linearized``: pay the refresh's primal forward and
        backward once per refresh (``curvature/linearized.py``) and run
        the k Lanczos iterations on the tangent map; the residuals live on
        the device during the refresh (``residual_bytes`` counts them).
        ``basis_sharding``: the basis split over a mesh's ranks (the
        module's docstring)."""
        self.cfg = config
        self.refresh_linearized = refresh_linearized
        self.basis_dtype = basis_dtype
        self.refresh_batch_size = refresh_batch_size
        self.loss_fn = loss_fn
        self._batch_size = batch_size
        self.fl = Flattener(params_template)
        self.sh = p_shard(basis_sharding, self.fl.size)
        if self.sh is not None and refresh_linearized:
            raise NotImplementedError("refresh_linearized with a sharded basis is not ported")
        self.precision_guard = None
        self._refresh_count = 0
        self._build_refresh_hvp(loss_fn, refresh_precision)

    def _build_refresh_hvp(self, loss_fn, precision: str) -> None:
        """(Re)build the refresh HVP for a precision tier: at construction
        and when the precision guard escalates."""
        self._hvp = hvp_fn(
            loss_fn, normalization=self.cfg.normalization, batch_size=self._batch_size,
            remat=self.cfg.remat, precision=precision,
        )
        if self.refresh_linearized:
            from hessian_llm_vision_tpu_torch.curvature.linearized import (
                linearized_hvp_programs,
            )

            self._resid, self._tangent = linearized_hvp_programs(
                loss_fn, self.cfg.normalization, precision, self.fl, self._batch_size)
        self.refresh_precision = precision
        #: the loss the refresh HVPs differentiate (a tier's rebuilt model;
        #: the gradient keeps ``loss_fn``)
        self.refresh_loss_fn = loss_fn

    def set_refresh_tier(self, tier) -> None:
        """Apply a precision-guard tier (``optim.precision_guard.GuardTier``)."""
        self._build_refresh_hvp(tier.loss_fn, tier.precision)

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
        k, sh = self.cfg.k, self.sh
        if sh is None:
            q_cur = g_flat / torch.clamp(norm(g_flat), min=1e-30)
        else:
            q_cur = sh.local(g_flat)
            q_cur = q_cur / torch.clamp(sh.norm(q_cur), min=1e-30)
        basis = torch.zeros((k, q_cur.shape[0]), dtype=self.basis_dtype, device=g_flat.device)
        q_prev = torch.zeros_like(q_cur)
        beta_prev = torch.zeros((), dtype=torch.float32, device=g_flat.device)
        consts = None
        if self.refresh_linearized:
            # one primal forward+backward for all k iterations
            consts = self._resid(params, batch)
            matvec = lambda v: self._tangent(v, consts)  # noqa: E731
        elif sh is None:
            matvec = lambda v: self._hvp_flat(v, params, batch)  # noqa: E731
        else:
            matvec = lambda v: sh.local(self._hvp_flat(sh.gather(v), params, batch))  # noqa: E731
        alphas, betas = [], []
        for i in range(k):
            basis[i] = q_cur  # in-place row write, cast to basis_dtype
            w = matvec(q_cur)
            alpha, beta, q_next = host_recurrence_step(w, q_cur, q_prev, beta_prev, sh)
            q_prev, q_cur, beta_prev = q_cur, q_next, beta
            alphas.append(float(alpha))
            betas.append(float(beta))
        del q_prev, q_cur, w, matvec, consts
        return _host_ritz(alphas, betas, basis)

    @torch.no_grad()
    def _ema_blend_(self, old: torch.Tensor, new: torch.Tensor) -> None:
        """``old ← m·old + (1−m)·new`` in f32, stored in ``basis_dtype``,
        one row at a time."""
        m = self.cfg.lanczos_momentum
        for i in range(old.shape[0]):
            old[i] = m * old[i].float() + (1.0 - m) * new[i].float()

    @torch.no_grad()
    def _adjust_update(self, state: HostLanczosSGDState, g_flat: torch.Tensor) -> None:
        cfg, sh = self.cfg, self.sh
        if sh is None:
            adj = spectral_adjust(g_flat, state.basis, state.eigvals, cfg.delta)
        else:
            adj = sh.gather(sh.rank_k(sh.local(g_flat), state.basis,
                                      adjust_coeffs(state.eigvals, cfg.delta)))
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
            if self.precision_guard is not None:
                # pre-refresh drift check; λmax of the previous refresh is
                # the sharpening signal (the eigvals outlive a freed basis)
                self.precision_guard.maybe_recheck(
                    self, state.params, rbatch, step=state.step,
                    refresh_index=self._refresh_count,
                    eig_max=float(state.eigvals[-1]) if self._refresh_count > 0 else None,
                )
            self._refresh_count += 1
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


@dataclasses.dataclass
class HostLayerwiseState:
    """Mutable state of the layer-wise trainer: per adjusted tensor (the
    trainer's ``active`` list) its eigenvalues and (k_i, size) Ritz basis,
    None before the first refresh."""

    params: Params
    momentum: Params
    step: int
    eigvals: list  # (k_i,) f32 per active tensor
    bases: list  # (k_i, size) in basis_dtype per active tensor


class HostLayerwiseLanczosSGDTrainer:
    """Layer-wise (block-diagonal) LanczosSGD at LLM scale, host-driven.

    One k_i-iteration Lanczos per parameter tensor on its diagonal Hessian
    block, then the per-tensor spectral adjustment:

    * ONE masked HVP (``krylov/driver.py::masked_batch_hvp``) serves every
      tensor: the block is a span ``[off, off + size)`` of the flat vector;
    * the three-term recurrence (no reorthogonalization) runs on full-P
      vectors;
    * each Ritz basis is stored sliced, (k_i, size) in ``basis_dtype``, so
      all of them together hold at most k x P entries;
    * one pass adjusts each tensor's contiguous slice of the flat gradient
      (``ops/spectral.py``, the CUDA kernel pair on a card), then momentum
      SGD updates the params IN PLACE, as :class:`HostLanczosSGDTrainer`.

    ``refresh_every`` amortizes the (tensors x k) HVPs of a refresh, with
    the EMA of ``lanczos_momentum`` over every tensor's eigenvalues and
    basis.  ``config.accum_steps`` must be 1.  The precision guard attaches
    as it does to :class:`HostLanczosSGDTrainer`.
    """

    def __init__(
        self,
        loss_fn: Callable[[Params, Any], torch.Tensor],
        params_template: Mapping[str, torch.Tensor],
        config: LanczosSGDConfig,
        *,
        batch_size: Optional[int] = None,
        basis_dtype: torch.dtype = torch.float32,
        min_leaf_size: int = 2,
        refresh_precision: str = "high",
    ):
        from hessian_llm_vision_tpu_torch.utils import trees

        if config.accum_steps > 1:
            raise ValueError("HostLayerwiseLanczosSGDTrainer: accum_steps > 1 is not supported")
        self.cfg = config
        self.basis_dtype = basis_dtype
        self.loss_fn = loss_fn
        self.fl = Flattener(params_template)
        if config.normalization == "sum":
            if batch_size is None:
                raise ValueError('normalization="sum" requires batch_size')
            self._hvp_scale = float(batch_size)
        else:
            self._hvp_scale = 1.0
        self.precision_guard = None
        self._refresh_count = 0
        self._build_refresh_hvp(loss_fn, refresh_precision)
        labels, spans = trees.partition_labels(params_template)
        #: (label, offset, size, k_i) of every adjusted tensor, in flat order
        self.active = [(label, off, size, min(config.k, size))
                       for label, (off, size) in zip(labels, spans)
                       if size >= min_leaf_size and min(config.k, size) >= 2]

    def _build_refresh_hvp(self, loss_fn, precision: str) -> None:
        """(Re)build the masked refresh HVP for a precision tier."""
        from hessian_llm_vision_tpu_torch.krylov.driver import masked_batch_hvp

        self._mhvp = masked_batch_hvp(loss_fn, "mean", precision, self.fl)
        self.refresh_precision = precision
        self.refresh_loss_fn = loss_fn

    def set_refresh_tier(self, tier) -> None:
        """Apply a precision-guard tier (``optim.precision_guard.GuardTier``)."""
        self._build_refresh_hvp(tier.loss_fn, tier.precision)

    def init(self, params: Params) -> HostLayerwiseState:
        n = len(self.active)
        return HostLayerwiseState(
            params=dict(params),
            momentum={name: torch.zeros_like(p) for name, p in params.items()},
            step=0, eigvals=[None] * n, bases=[None] * n,
        )

    def _grad(self, params: Params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        loss, grad = grad_and_loss(self.loss_fn, params, batch)
        return loss.detach(), self.fl.flatten(grad)

    def refresh_leaf(self, params: Params, batch, g_flat: torch.Tensor, off: int, size: int,
                     k_i: int):
        """Grad-seeded k_i-iteration Lanczos of one diagonal block; returns
        (eigvals (k_i,) f32, Ritz basis (k_i, size) in ``basis_dtype``)."""
        seg = g_flat[off:off + size]
        q_cur = torch.zeros_like(g_flat)
        q_cur[off:off + size] = seg / torch.clamp(norm(seg), min=1e-30)
        q_prev = torch.zeros_like(q_cur)
        beta_prev = torch.zeros((), dtype=torch.float32, device=g_flat.device)
        rows = torch.empty((k_i, size), dtype=self.basis_dtype, device=g_flat.device)
        alphas, betas = [], []
        for i in range(k_i):
            rows[i] = q_cur[off:off + size]
            w = self._mhvp(q_cur, off, size, params, batch)
            if self._hvp_scale != 1.0:
                w = w * self._hvp_scale
            alpha, beta, q_next = host_recurrence_step(w, q_cur, q_prev, beta_prev)
            q_prev, q_cur, beta_prev = q_cur, q_next, beta
            alphas.append(float(alpha))
            betas.append(float(beta))
        del q_prev, q_cur, w
        return _host_ritz(alphas, betas, rows)

    @torch.no_grad()
    def _adjust_update(self, state: HostLayerwiseState, g_flat: torch.Tensor) -> None:
        cfg = self.cfg
        adj = g_flat.clone()
        for (_, off, size, _), V, ev in zip(self.active, state.bases, state.eigvals):
            adj[off:off + size] = spectral_adjust(g_flat[off:off + size], V, ev, cfg.delta)
        lr_t = _lr_at(cfg.lr, state.step)
        for name, a in self.fl.unflatten(adj).items():
            p, buf = state.params[name], state.momentum[name]
            if cfg.weight_decay:
                a = a + cfg.weight_decay * p
            buf.mul_(cfg.momentum).add_(a)
            p.sub_(lr_t * buf)

    def step(self, state: HostLayerwiseState, batch):
        """Advance one step IN PLACE; returns (state, metrics)."""
        loss, g_flat = self._grad(state.params, batch)
        if state.step % self.cfg.refresh_every == 0 or state.bases[0] is None:
            m = self.cfg.lanczos_momentum
            use_ema = m > 0 and state.step > 0 and state.bases[0] is not None
            if self.precision_guard is not None:
                self.precision_guard.maybe_recheck(
                    self, state.params, batch, step=state.step,
                    refresh_index=self._refresh_count,
                    eig_max=(max(float(e[-1]) for e in state.eigvals)
                             if state.bases[0] is not None else None),
                )
            self._refresh_count += 1
            for i, (_, off, size, k_i) in enumerate(self.active):
                ev, V = self.refresh_leaf(state.params, batch, g_flat, off, size, k_i)
                if use_ema:
                    state.eigvals[i] = m * state.eigvals[i] + (1 - m) * ev
                    state.bases[i] = (m * state.bases[i].float()
                                      + (1 - m) * V.float()).to(self.basis_dtype)
                else:
                    state.eigvals[i], state.bases[i] = ev, V
        self._adjust_update(state, g_flat)
        state.step += 1
        metrics = {
            "loss": loss,
            "layer_eig_max": torch.stack([e[-1] for e in state.eigvals]),
            "layer_eig_min": torch.stack([e[0] for e in state.eigvals]),
        }
        return state, metrics


def refresh_precision_probe(
    trainer, params: Params, batch, *, seed: int = 0,
    ritz_iters: int = 10, referee_loss_fn: Optional[Callable] = None,
) -> dict:
    """The trainer's refresh HVP at ``refresh_precision`` against the fp32
    referee at these params, on one batch (``krylov.matvec_precision_probe``,
    about 2 x ``ritz_iters`` HVPs; the probe vector drawn from a CPU
    generator seeded with ``seed``).  Either host trainer: the probe runs
    the full Hessian, which bounds the layer-wise trainer's masked HVPs
    (the same product restricted to a block).  ``referee_loss_fn``: a
    clean-model loss when the low precision is baked into the model
    (``--refresh_precision mixed``, ``block_matmul_precision``); without it
    both arms would run the low-precision blocks."""
    from hessian_llm_vision_tpu_torch.krylov.driver import matvec_precision_probe

    return matvec_precision_probe(
        trainer.refresh_loss_fn, params, batch,
        generator=torch.Generator().manual_seed(seed),
        precision=trainer.refresh_precision, flattener=trainer.fl,
        ritz_iters=ritz_iters, referee_loss_fn=referee_loss_fn,
    )
