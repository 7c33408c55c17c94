"""Host-driven T-only spectra at LLM scale (port of ``krylov/driver.py``).

A Python loop drives the Lanczos three-term recurrence over per-batch
curvature products (Hessian, or GGN / Fisher); no (k, P) basis is held, so
memory is the params, a few P-vectors and one product's working set.
alpha and beta stay 0-d device tensors until the loop ends (a
``callback`` opts into a host copy per iteration).  Beside the dataset
loop: per-leaf or per-block spectra over one masked HVP
(:func:`layerwise_spectrum_host`), the linearized single-batch loop
(:func:`linearized_spectrum_host`) and the parameter-shaped loop with
low-precision-stored vectors (:func:`bigmodel_spectrum_host`), and the
precision probe (:func:`matvec_precision_probe`) that the precision ladder
gates on.

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

from hessian_llm_vision_tpu_torch.curvature.hvp import (
    LossFn,
    _precision_context,
    hvp_fn,
    split_sharded,
)
from hessian_llm_vision_tpu_torch.krylov.lanczos import (
    MATVEC_SPAN,
    UPDATE_SPAN,
    LanczosResult,
    host_recurrence_step,
    raw_start,
    stack_tridiag,
    start_vector,
)
from hessian_llm_vision_tpu_torch.krylov.sharded import p_shard
from hessian_llm_vision_tpu_torch.krylov.thick_restart import (
    ThickRestartResult,
    lanczos_thick_restart,
)
from hessian_llm_vision_tpu_torch.ops.spectral import project_out, project_out_reference
from hessian_llm_vision_tpu_torch.utils import trees
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener, flat_order
from hessian_llm_vision_tpu_torch.utils.norms import norm

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


def _batch_product(operator, loss_fn, per_batch_norm, precision, model_fn, out_loss_fn):
    """``(params, batch, vector dict) -> dict``: the per-batch HVP, or the
    per-batch GGN ``Jᵀ H_out J v`` (Fisher = GGN of the NLL) for
    ``operator="ggn" | "fisher"``, whose ``out_loss_fn`` is already a
    per-batch mean."""
    if operator in ("ggn", "fisher"):
        if model_fn is None or out_loss_fn is None:
            raise ValueError(f"operator={operator!r} needs model_fn+out_loss_fn")
        from hessian_llm_vision_tpu_torch.curvature.ggn import ggn_product

        _precision_context(precision)

        def ggn(params, batch, vector):
            with _precision_context(precision):
                return ggn_product(model_fn, out_loss_fn, params, batch, vector)

        return ggn
    if operator != "hessian":
        raise ValueError(f"unknown operator {operator!r}")
    return hvp_fn(loss_fn, normalization=per_batch_norm, precision=precision)


def batch_hvp(loss_fn: LossFn, precision: Optional[str], fl: Flattener):
    """``(v, params, batch) -> H v`` on flat f32 vectors: one batch's HVP
    of the batch-mean loss at ``precision`` (the probes' matvec)."""
    _hvp = hvp_fn(loss_fn, normalization="mean", precision=precision)

    def hv(v: torch.Tensor, params, batch) -> torch.Tensor:
        return fl.flatten(_hvp(params, batch, fl.unflatten(v)))

    return hv


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def matvec_precision_probe(
    loss_fn: LossFn,
    params,
    batch: Any,
    *,
    vector: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    precision: Optional[str] = "high",
    referee_precision: str = "highest",
    referee_loss_fn: Optional[LossFn] = None,
    flattener: Optional[Flattener] = None,
    ritz_iters: int = 0,
    reorth: bool = False,
) -> dict:
    """Measure the requested-precision HVP against an fp32 referee on one
    batch (the JAX package's probe, same keys).

    Low-precision curvature error depends on the checkpoint, not only on
    the model: it grows as training sharpens the landscape.  For one unit
    probe vector ``v`` (``vector``, or a draw from ``generator``), ``w = H v``
    runs at ``precision`` and at ``referee_precision``; the result holds

    * ``rel_err`` -- ``‖w_req − w_ref‖ / ‖w_ref‖``;
    * ``alpha_rel_err`` -- relative error of the Rayleigh quotient ``vᵀw``
      (meaningless near a zero mean curvature; reported, not gated);
    * ``seconds_requested`` / ``seconds_referee`` -- one HVP each, timed
      on the second call, synchronised with the device;
    * with ``ritz_iters=N > 0``: ``ritz_rel_err``, the worst relative
      disagreement of λmin and λmax between an N-iteration Lanczos in each
      arm from ``v`` (:func:`_tiny_lanczos_extremes`), of the referee's
      scale, and both arms' extremes.

    ``ritz_rel_err`` gates a job, not ``rel_err``: extreme Ritz values are
    robust to spectrally incoherent matvec noise.  ``reorth=True``
    reorthogonalises the probe's Lanczos (CGS2); on ill-conditioned
    trained checkpoints the plain recurrence measures trajectory
    divergence rather than operator error.  ``referee_loss_fn``: a
    separately built loss when the low precision is baked into the model
    (``block_matmul_precision``); defaults to ``loss_fn``.
    """
    fl = flattener or Flattener(params)
    if (vector is None) == (generator is None):
        raise ValueError("pass exactly one of vector / generator")
    device = next(iter(params.values())).device
    if vector is None:
        vector = torch.randn(fl.size, generator=generator, device=generator.device)
    v = start_vector(vector.to(device), None, fl.size)
    req = batch_hvp(loss_fn, precision, fl)
    ref = batch_hvp(referee_loss_fn or loss_fn, referee_precision, fl)

    def timed(hv):
        w = hv(v, params, batch)  # warm-up; the second call is timed
        _sync(w)
        t0 = time.perf_counter()
        _sync(hv(v, params, batch))
        return w, time.perf_counter() - t0

    w_req, t_req = timed(req)
    w_ref, t_ref = timed(ref)
    a_req, a_ref = float(torch.dot(v, w_req)), float(torch.dot(v, w_ref))
    stats = {
        "rel_err": float(norm(w_req - w_ref))
        / max(float(norm(w_ref)), 1e-30),
        "alpha_rel_err": abs(a_req - a_ref) / max(abs(a_ref), 1e-30),
        "alpha_requested": a_req,
        "alpha_referee": a_ref,
        "seconds_requested": t_req,
        "seconds_referee": t_ref,
    }
    del w_req, w_ref
    if ritz_iters > 0:
        lo_q, hi_q = _tiny_lanczos_extremes(req, v, params, batch, ritz_iters, reorth=reorth)
        lo_r, hi_r = _tiny_lanczos_extremes(ref, v, params, batch, ritz_iters, reorth=reorth)
        scale_r = max(abs(lo_r), abs(hi_r), 1e-30)
        stats["ritz_rel_err"] = max(abs(hi_q - hi_r), abs(lo_q - lo_r)) / scale_r
        stats["ritz_extremes_requested"] = (lo_q, hi_q)
        stats["ritz_extremes_referee"] = (lo_r, hi_r)
    return stats


def _cgs2_pass(w: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``w − rowsᵀ (rows w)``: on CUDA the rank-k kernel pair (w and the
    coefficients f32, the rows streamed in their storage dtype); on the
    CPU the plain f32 version with the rows upcast, the JAX probe's
    arithmetic."""
    if w.is_cuda:
        return project_out(w, rows)
    return project_out_reference(w, rows)


def _tiny_lanczos_extremes(
    hv, v0: torch.Tensor, params, batch: Any, num_iters: int, *, reorth: bool = False,
    basis_dtype: torch.dtype = torch.bfloat16,
) -> tuple[float, float]:
    """(λmin, λmax) of an ``num_iters``-iteration Lanczos over one batch's
    HVP ``hv(v, params, batch)`` from the unit ``v0``, host-driven.

    ``reorth=True`` stores each Lanczos vector as a row of a (num_iters, P)
    ``basis_dtype`` buffer (bf16: 2.5 GB at GPT-2 124M for 10 rows) and
    CGS2-reorthogonalises every iterate against the rows filled so far:
    two rank-k applies with c = −1 per iteration (:func:`_cgs2_pass`),
    arithmetic f32."""
    q_cur, q_prev = v0, torch.zeros_like(v0)
    beta_prev = torch.zeros((), dtype=torch.float32, device=v0.device)
    Q = (torch.zeros((num_iters, v0.shape[0]), dtype=basis_dtype, device=v0.device)
         if reorth else None)
    alphas, betas = [], []
    for i in range(num_iters):
        w = hv(q_cur, params, batch).float()
        alpha = torch.dot(q_cur, w)
        w = w - alpha * q_cur - beta_prev * q_prev
        if Q is not None:
            Q[i].copy_(q_cur)
            for _ in range(2):
                w = _cgs2_pass(w, Q[: i + 1])
        beta = norm(w)
        q_prev, q_cur = q_cur, w / torch.clamp(beta, min=1e-30)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    del Q
    a = torch.stack(alphas).double().cpu().numpy()
    b = torch.stack(betas[:-1]).double().cpu().numpy() if num_iters > 1 else np.zeros((0,))
    ev = np.linalg.eigvalsh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))
    return float(ev[0]), float(ev[-1])


def dataset_matvec(
    loss_fn: LossFn,
    params,
    batch_list: Sequence[Any],
    *,
    normalization: str = "dataset",
    batch_size: Optional[int] = None,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
    operator: str = "hessian",
    model_fn: Optional[Callable] = None,
    out_loss_fn: Optional[Callable] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``q -> A q`` of the whole dataset (``dataset_norm``'s scaling, the
    same for every operator): the per-batch products summed in place into
    one f32 P-vector, then scaled.  For a data-parallel Hessian loss
    (``parallel.hvp_sharded.ShardedLoss``) the products are of this rank's
    rows, and the sum is averaged over the ranks in one all-reduce at the
    end."""
    fl = flattener or Flattener(params)
    per_batch_norm, scale = dataset_norm(normalization, len(batch_list), batch_size)
    local, sharded = split_sharded(loss_fn)
    product = _batch_product(operator, local, per_batch_norm, precision, model_fn, out_loss_fn)

    def matvec(q: torch.Tensor) -> torch.Tensor:
        tangent = fl.unflatten(q)
        w = torch.zeros(fl.size, dtype=torch.float32, device=q.device)
        for batch in batch_list:
            w.add_(fl.flatten(product(params, batch, tangent)))
        w.mul_(scale)
        return w if sharded is None else sharded.reduce_mean_(w)

    return matvec


def _t_only(matvec, q_cur, num_iters, callback, progress, label="lanczos",
            sh=None) -> LanczosResult:
    """The three-term recurrence from the unit ``q_cur``, T only; with
    ``sh`` (``krylov/sharded.py``) on this rank's parts of the vectors,
    ``q_cur`` the start direction before ``sh.start`` normalises it."""
    if sh is not None:
        q_cur, whole = sh.start(q_cur), matvec
        matvec = lambda q: sh.local(whole(sh.gather(q)).float())  # noqa: E731
    q_prev = torch.zeros_like(q_cur)
    beta_prev = torch.zeros((), dtype=torch.float32, device=q_cur.device)
    alphas, betas = [], []
    for i in range(num_iters):
        t0 = time.perf_counter()
        with MATVEC_SPAN:
            w = matvec(q_cur)
        with UPDATE_SPAN:
            alpha, beta, q_next = host_recurrence_step(w, q_cur, q_prev, beta_prev, sh)
            del w
            q_prev, q_cur, beta_prev = q_cur, q_next, beta
            alphas.append(alpha)
            betas.append(beta)
        _iteration_end(i, num_iters, t0, q_cur, alphas, betas, callback, progress, label)
    alphas, betas = stack_tridiag(alphas, betas)
    return LanczosResult(alphas=alphas, betas=betas, basis=None)


def _iteration_end(i, num_iters, t0, q, alphas, betas, callback, progress, label="lanczos"):
    if callback is not None:
        a, b = stack_tridiag(alphas, betas)
        callback(i, a.cpu().numpy(), b.cpu().numpy())
    if progress:
        if q.is_cuda:
            torch.cuda.synchronize(q.device)
        print(f"{label} iter {i + 1}/{num_iters}  {time.perf_counter() - t0:.2f}s", flush=True)


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
    model_fn: Optional[Callable] = None,
    out_loss_fn: Optional[Callable] = None,
    basis_sharding=None,
) -> LanczosResult:
    """T-only Lanczos of the dataset-mean curvature operator, host-driven.

    ``operator``: "hessian" (from ``loss_fn``) or "ggn" / "fisher" (from
    ``model_fn`` + ``out_loss_fn``; Fisher == GGN of the NLL), with the
    same ``dataset_norm`` scale.  ``batch_list``: equal-size batches on the
    params' device.  Exactly one of ``v0`` / ``generator`` gives the start
    vector.  Returns a :class:`LanczosResult` with ``basis=None``; feed it
    to ``ritz_decomposition``.  ``callback(i, alphas, betas)`` receives
    host copies of T each iteration (resumable checkpoints); ``progress``
    prints each iteration's seconds, synchronised with the device.
    ``basis_sharding`` (``parallel.mesh.basis_sharding``): the Lanczos
    vectors split over the mesh's ranks (``krylov/sharded.py``); with the
    model-axis layout of a model-parallel model, which needs it, ``v0`` is
    this rank's rank vector.
    """
    fl = flattener or Flattener(params)
    matvec = dataset_matvec(loss_fn, params, batch_list, normalization=normalization,
                            batch_size=batch_size, precision=precision, flattener=fl,
                            operator=operator, model_fn=model_fn, out_loss_fn=out_loss_fn)
    sh = p_shard(basis_sharding, fl.size)
    q = start_vector(v0, generator, fl.size) if sh is None else raw_start(v0, generator, fl.size)
    return _t_only(matvec, q, num_iters, callback, progress, sh=sh)


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
    ``generator`` lands on the params' device.  ``basis_sharding``: the
    buffer split along P over the mesh's ranks (``lanczos_thick_restart``);
    ``loss_fn`` may be a data-parallel ``ShardedLoss`` with it or
    without."""
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
        with MATVEC_SPAN:
            w = fl.flatten(_hvp(params, batch, fl.unflatten(q_cur)))
        with UPDATE_SPAN:
            alpha, beta, q_next = host_recurrence_step(w, q_cur, q_prev.float(), beta_prev)
            q_prev.copy_(q_cur)
            q_cur, beta_prev = q_next, beta
            alphas.append(alpha)
            betas.append(beta)
        _iteration_end(i, num_iters, t0, q_cur, alphas, betas, callback, progress)
    alphas, betas = stack_tridiag(alphas, betas)
    return LanczosResult(alphas=alphas, betas=betas, basis=None)


def masked_batch_hvp(loss_fn: LossFn, per_batch_norm: str, precision: Optional[str],
                     fl: Flattener):
    """One block-restricted HVP for every parameter block:
    ``(v, start, size, params, batch) -> m ⊙ H (m ⊙ v)`` with ``m`` the
    indicator of ``[start, start + size)`` of the flat vector."""
    _hvp = hvp_fn(loss_fn, normalization=per_batch_norm, precision=precision)

    def mhvp(v, start: int, size: int, params, batch) -> torch.Tensor:
        masked = torch.zeros_like(v)
        masked[start:start + size] = v[start:start + size]
        out = fl.flatten(_hvp(params, batch, fl.unflatten(masked)))
        res = torch.zeros_like(out)
        res[start:start + size] = out[start:start + size]
        return res

    return mhvp


def layerwise_spectrum_host(
    loss_fn: LossFn,
    params,
    batch: Any,
    num_iters: int,
    *,
    generator: Optional[torch.Generator] = None,
    v0s: Optional[dict] = None,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
    min_size: int = 2,
    progress: bool = False,
    group_regex: Optional[str] = None,
) -> dict:
    """Per-leaf block-diagonal spectra, host-driven: ``{label:
    LanczosResult}`` in flatten order, T only.

    One masked HVP (:func:`masked_batch_hvp`) serves every block.
    ``group_regex`` merges leaves into one block per regex group (e.g.
    ``trees.BLOCK_GROUP_REGEX``: one spectrum per transformer block);
    non-matching leaves are skipped, as are blocks below ``min_size``.  A
    block runs ``min(num_iters, size)`` iterations.  Start vectors: either
    ``v0s[label]`` (the block's ``size`` entries) or a draw of ``size``
    normals from ``generator`` per block, in label order; each lands on
    the params' device.
    """
    if (v0s is None) == (generator is None):
        raise ValueError("pass exactly one of v0s / generator")
    fl = flattener or Flattener(params)
    scale, per_batch_norm = 1.0, normalization
    if normalization == "sum":
        if batch_size is None:
            raise ValueError('normalization="sum" requires batch_size')
        per_batch_norm, scale = "mean", float(batch_size)
    mhvp = masked_batch_hvp(loss_fn, per_batch_norm, precision, fl)
    device = next(iter(params.values())).device
    labels, spans = trees.partition_labels(params)
    if group_regex is not None:
        labels, spans = trees.group_spans(labels, spans, group_regex)
    results = {}
    for label, (off, size) in zip(labels, spans):
        if size < min_size:
            continue
        block = v0s[label] if v0s is not None else torch.randn(size, generator=generator)
        q = torch.zeros(fl.size, dtype=torch.float32, device=device)
        q[off:off + size] = torch.as_tensor(block, dtype=torch.float32).to(device)

        def matvec(v, off=off, size=size):
            w = mhvp(v, off, size, params, batch)
            return w.mul_(scale) if scale != 1.0 else w

        results[label] = _t_only(matvec, start_vector(q, None, fl.size), min(num_iters, size),
                                 None, False)
        if progress:
            from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition

            ev = ritz_decomposition(results[label]).eigvals
            print(f"{label:60s} P={size:9d} max={float(ev.max()):10.4f} "
                  f"min={float(ev.min()):10.4f}", flush=True)
    return results


def linearized_spectrum_host(
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
    callback: Optional[Callback] = None,
    progress: bool = False,
) -> LanczosResult:
    """T-only single-batch Lanczos over the linearized HVP: one residual
    pass (``curvature/linearized.py``), then every iteration runs the
    tangent map alone.  The residuals stay on the device for the whole
    loop (``curvature.linearized.residual_bytes`` counts them)."""
    from hessian_llm_vision_tpu_torch.curvature.linearized import (
        concrete_residual_bytes,
        linearized_hvp_programs,
    )

    fl = flattener or Flattener(params)
    q0 = start_vector(v0, generator, fl.size)
    resid_p, tangent_p = linearized_hvp_programs(loss_fn, normalization, precision, fl, batch_size)
    t0 = time.perf_counter()
    consts = resid_p(params, batch)
    if progress:
        if q0.is_cuda:
            torch.cuda.synchronize(q0.device)
        print(f"linearized residual pass: {concrete_residual_bytes(consts)} bytes in "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
    res = _t_only(lambda q: tangent_p(q, consts), q0, num_iters, callback, progress,
                  label="linearized lanczos")
    del consts
    return res


def bigmodel_spectrum_host(
    loss_fn: LossFn,
    params,
    batch: Any,
    num_iters: int,
    *,
    v0: dict,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    precision: Optional[str] = "high",
    q_dtype: torch.dtype = torch.bfloat16,
    callback: Optional[Callback] = None,
    progress: bool = False,
) -> LanczosResult:
    """T-only single-batch Lanczos for models near the memory limit.

    The Krylov vectors are parameter-shaped ``{name: tensor}`` dicts stored
    in ``q_dtype`` (no flat P-vector exists); every dot, AXPY and norm is
    f32, leaf by leaf, and each HVP output leaf is cast to ``q_dtype`` as
    soon as the HVP returns (eager PyTorch materialises the whole f32
    output dict first).  bf16 storage moves the extreme Ritz values by
    about 1e-3 relative.  ``v0``: the start as a dict of leaves (any float
    dtype, any device; normalised here).
    """
    device = next(iter(params.values())).device
    names = flat_order(params)
    _hvp = hvp_fn(loss_fn, normalization=normalization, batch_size=batch_size,
                  precision=precision)

    def tdot(a, b):
        return sum(torch.dot(a[n].reshape(-1).float(), b[n].reshape(-1).float()) for n in names)

    v0 = {n: v0[n].to(device=device, dtype=torch.float32) for n in names}
    nrm = torch.clamp(torch.sqrt(tdot(v0, v0)), min=1e-30)
    q_cur = {n: (v0[n] / nrm).to(q_dtype) for n in names}
    del v0
    q_prev = {n: torch.zeros_like(q_cur[n]) for n in names}
    beta_prev = torch.zeros((), dtype=torch.float32, device=device)
    alphas, betas = [], []
    for i in range(num_iters):
        t0 = time.perf_counter()
        with MATVEC_SPAN:
            w = _hvp(params, batch, {n: q_cur[n].float() for n in names})
        with UPDATE_SPAN:
            for n in names:  # each f32 leaf is freed as soon as it is cast
                w[n] = w[n].to(q_dtype)
            alpha = tdot(q_cur, w)
            for n in names:
                w[n] = (w[n].float() - alpha * q_cur[n].float()
                        - beta_prev * q_prev[n].float()).to(q_dtype)
            beta = torch.sqrt(tdot(w, w))
            inv = 1.0 / torch.clamp(beta, min=1e-30)
            q_prev, q_cur = q_cur, {n: (w[n].float() * inv).to(q_dtype) for n in names}
            del w
            beta_prev = beta
            alphas.append(alpha)
            betas.append(beta)
        _iteration_end(i, num_iters, t0, beta, alphas, betas, callback, progress)
    alphas, betas = stack_tridiag(alphas, betas)
    return LanczosResult(alphas=alphas, betas=betas, basis=None)
