"""Host-driven T-only spectra at LLM scale (port of the dataset path of
``krylov/driver.py``).

A Python loop drives the Lanczos three-term recurrence over per-batch
HVPs; no (k, P) basis is held, so memory is the params, a few P-vectors
and one HVP's working set.  alpha and beta stay 0-d device tensors until
the loop ends (a ``callback`` opts into a host copy per iteration).

There is one iteration: the per-batch HVPs summed in place, the scale
(:func:`dataset_matvec`), then ``host_recurrence_step``.  The JAX package's
``fused=True`` folds that into one program to save TPU dispatch round
trips; in eager PyTorch it would launch the same kernels in the same order,
so it is not ported.  :func:`dataset_thick_restart_host` runs thick-restart
Lanczos over the same matvec, for the same reason without the JAX
package's fused thick-restart step.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.curvature.hvp import LossFn, hvp_fn
from hessian_llm_vision_tpu_torch.krylov.lanczos import (
    LanczosResult,
    host_recurrence_step,
    stack_tridiag,
    start_vector,
)
from hessian_llm_vision_tpu_torch.krylov.thick_restart import (
    ThickRestartResult,
    lanczos_thick_restart,
)
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

Callback = Callable[[int, np.ndarray, np.ndarray], None]


def dataset_norm(normalization: str, num_batches: int, batch_size: Optional[int] = None):
    """Whole-dataset loss scaling, as ``DatasetHessianOperator``:
    "dataset"/"mean" -> Hessian of the dataset-mean loss; "sum" -> of the
    dataset-summed loss (= N x mean).  Returns ``(per_batch_norm, scale)``."""
    if normalization in ("dataset", "mean"):
        return "mean", 1.0 / num_batches
    if normalization == "sum":
        if batch_size is None:
            raise ValueError('normalization="sum" requires batch_size')
        return "mean", float(batch_size)
    raise ValueError(normalization)


def dataset_matvec(
    loss_fn: LossFn,
    params,
    batch_list: Sequence[Any],
    *,
    normalization: str = "dataset",
    batch_size: Optional[int] = None,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``q -> H q`` of the whole dataset (``dataset_norm``'s scaling): the
    per-batch HVPs summed in place into one f32 P-vector, then scaled."""
    fl = flattener or Flattener(params)
    per_batch_norm, scale = dataset_norm(normalization, len(batch_list), batch_size)
    _hvp = hvp_fn(loss_fn, normalization=per_batch_norm, precision=precision)

    def matvec(q: torch.Tensor) -> torch.Tensor:
        tangent = fl.unflatten(q)
        w = torch.zeros(fl.size, dtype=torch.float32, device=q.device)
        for batch in batch_list:
            w.add_(fl.flatten(_hvp(params, batch, tangent)))
        return w.mul_(scale)

    return matvec


def _iteration_end(i, num_iters, t0, q, alphas, betas, callback, progress):
    if callback is not None:
        a, b = stack_tridiag(alphas, betas)
        callback(i, a.cpu().numpy(), b.cpu().numpy())
    if progress:
        if q.is_cuda:
            torch.cuda.synchronize(q.device)
        print(f"lanczos iter {i + 1}/{num_iters}  {time.perf_counter() - t0:.2f}s", flush=True)


def dataset_spectrum_host(
    loss_fn: LossFn,
    params,
    batch_list: Sequence[Any],
    num_iters: int,
    *,
    v0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    normalization: str = "dataset",
    batch_size: Optional[int] = None,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
    callback: Optional[Callback] = None,
    progress: bool = False,
    operator: str = "hessian",
) -> LanczosResult:
    """T-only Lanczos of the dataset-mean Hessian, host-driven.

    ``batch_list``: equal-size batches on the params' device.  Exactly one
    of ``v0`` / ``generator`` gives the start vector.  Returns a
    :class:`LanczosResult` with ``basis=None``; feed it to
    ``ritz_decomposition``.  ``callback(i, alphas, betas)`` receives host
    copies of T each iteration (resumable checkpoints); ``progress`` prints
    each iteration's seconds, synchronised with the device.
    """
    if operator in ("ggn", "fisher"):
        raise NotImplementedError(f"operator={operator!r} is not ported yet (ROADMAP A10h)")
    if operator != "hessian":
        raise ValueError(f"unknown operator {operator!r}")
    fl = flattener or Flattener(params)
    matvec = dataset_matvec(loss_fn, params, batch_list, normalization=normalization,
                            batch_size=batch_size, precision=precision, flattener=fl)
    q_cur = start_vector(v0, generator, fl.size)
    q_prev = torch.zeros_like(q_cur)
    beta_prev = torch.zeros((), dtype=torch.float32, device=q_cur.device)
    alphas, betas = [], []
    for i in range(num_iters):
        t0 = time.perf_counter()
        alpha, beta, q_next = host_recurrence_step(matvec(q_cur), q_cur, q_prev, beta_prev)
        q_prev, q_cur, beta_prev = q_cur, q_next, beta
        alphas.append(alpha)
        betas.append(beta)
        _iteration_end(i, num_iters, t0, q_cur, alphas, betas, callback, progress)
    alphas, betas = stack_tridiag(alphas, betas)
    return LanczosResult(alphas=alphas, betas=betas, basis=None)


def dataset_thick_restart_host(
    loss_fn: LossFn,
    params,
    batch_list: Sequence[Any],
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    v0: Optional[torch.Tensor] = None,
    inner: Optional[int] = None,
    normalization: str = "dataset",
    batch_size: Optional[int] = None,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
    store_dtype: torch.dtype = torch.float32,
    which: str = "lm",
    tol: float = 1e-6,
    max_restarts: int = 100,
    basis_sharding=None,
    progress: bool = False,
) -> ThickRestartResult:
    """Converged k extremal eigenpairs of the dataset-mean Hessian:
    ``lanczos_thick_restart`` over :func:`dataset_matvec`, with the
    normalization of ``dataset_norm``.  Each inner iteration is the
    dataset HVP, α, the CGS2 pass (the rank-k kernel pair on CUDA) and the
    row write; α and β are fetched once per restart cycle.  A draw from
    ``generator`` lands on the params' device."""
    fl = flattener or Flattener(params)
    matvec = dataset_matvec(loss_fn, params, batch_list, normalization=normalization,
                            batch_size=batch_size, precision=precision, flattener=fl)
    device = next(iter(params.values())).device
    return lanczos_thick_restart(
        matvec, fl.size, k, generator=generator, v0=v0, inner=inner,
        max_restarts=max_restarts, tol=tol, which=which, store_dtype=store_dtype,
        basis_sharding=basis_sharding, progress=progress, device=device,
    )


def single_batch_spectrum_host_fused(
    loss_fn: LossFn,
    params,
    batch: Any,
    num_iters: int,
    *,
    v0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
    qprev_bf16: bool = False,
    callback: Optional[Callback] = None,
    progress: bool = False,
) -> LanczosResult:
    """T-only single-batch Lanczos (the CLI's ``--fused_step``): one HVP and
    ``host_recurrence_step`` per iteration, the lagged vector kept in one
    buffer updated in place.  ``qprev_bf16`` stores that buffer in bf16
    (half a P-vector saved; it enters only ``- beta_prev * q_prev``, a
    ~1e-3-relative perturbation of the extreme Ritz values)."""
    fl = flattener or Flattener(params)
    _hvp = hvp_fn(loss_fn, normalization=normalization, batch_size=batch_size,
                  precision=precision)
    q_cur = start_vector(v0, generator, fl.size)
    q_prev = torch.zeros(fl.size, dtype=torch.bfloat16 if qprev_bf16 else torch.float32,
                         device=q_cur.device)
    beta_prev = torch.zeros((), dtype=torch.float32, device=q_cur.device)
    alphas, betas = [], []
    for i in range(num_iters):
        t0 = time.perf_counter()
        w = fl.flatten(_hvp(params, batch, fl.unflatten(q_cur)))
        alpha, beta, q_next = host_recurrence_step(w, q_cur, q_prev.float(), beta_prev)
        q_prev.copy_(q_cur)
        q_cur, beta_prev = q_next, beta
        alphas.append(alpha)
        betas.append(beta)
        _iteration_end(i, num_iters, t0, q_cur, alphas, betas, callback, progress)
    alphas, betas = stack_tridiag(alphas, betas)
    return LanczosResult(alphas=alphas, betas=betas, basis=None)
