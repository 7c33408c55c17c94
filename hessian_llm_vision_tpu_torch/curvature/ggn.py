"""Gauss-Newton and Fisher operators (port of ``curvature/ggn.py``).

``GGN = Jᵀ H_out J``: ``J v`` by ``torch.func.jvp`` of the model function,
the output-space Hessian by forward-over-reverse on the output loss, and
``Jᵀ u`` by ``torch.func.vjp`` -- two passes through the model and no
second-order pass through it.  For exponential-family likelihood losses
(softmax cross-entropy, squared error) the GGN equals the Fisher
information matrix, so :func:`FisherOperator` is the GGN of the negative
log-likelihood.

The empirical Fisher ``(1/n) Gᵀ (G v)`` over the (n, P) matrix of
per-example gradients is the two-pass contraction of the rank-k apply:
on CUDA tensors it is the hand-written kernel pair
(``ops/kernels.py::rank_k_dots`` with c = 1/n, then ``rank_k_axpy`` onto
zeros), on CPU tensors a plain version that rounds as the JAX package's
``dot_general`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch

from hessian_llm_vision_tpu_torch.curvature.hvp import Params, _precision_context
from hessian_llm_vision_tpu_torch.curvature.operators import LinearOperator
from hessian_llm_vision_tpu_torch.utils import remat
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

ModelFn = Callable[[Params, Any], torch.Tensor]
OutLossFn = Callable[[torch.Tensor, Any], torch.Tensor]


def ggn_product(model_fn: ModelFn, out_loss_fn: OutLossFn, params: Params, batch: Any,
                vector: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``Jᵀ H_out J v`` for one batch, dicts keyed like ``params``."""
    primals = dict(params)
    tangents = {n: vector[n] for n in primals}  # torch pytrees compare key order

    def f(p):
        return model_fn(p, batch)

    outputs, jv = torch.func.jvp(f, (primals,), (tangents,))
    h_jv = torch.func.jvp(torch.func.grad(lambda o: out_loss_fn(o, batch)), (outputs,), (jv,))[1]
    del outputs, jv
    _, vjp_fn = torch.func.vjp(f, primals)
    return vjp_fn(h_jv)[0]


def GGNOperator(
    model_fn: ModelFn,
    out_loss_fn: OutLossFn,
    params: Params,
    batch: Any,
    *,
    damping: float = 0.0,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
) -> LinearOperator:
    """``v -> (Jᵀ H_out J + damping·I) v``.  ``model_fn(params, batch) ->
    outputs`` (e.g. logits); ``out_loss_fn(outputs, batch) -> scalar``, a
    convex output-space loss.  ``precision`` as ``hvp_fn``'s ("high" and
    "highest" are true fp32)."""
    fl = flattener or Flattener(params)
    _precision_context(precision)

    def matvec(v):
        with _precision_context(precision):
            out = fl.flatten(ggn_product(model_fn, out_loss_fn, params, batch, fl.unflatten(v)))
        return out + damping * v if damping else out

    return LinearOperator(matvec, fl.size)


def FisherOperator(
    model_fn: ModelFn,
    nll_fn: OutLossFn,
    params: Params,
    batch: Any,
    *,
    damping: float = 0.0,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
) -> LinearOperator:
    """Fisher information matvec, the GGN of the negative log-likelihood
    (exact for exponential-family heads such as softmax cross-entropy)."""
    return GGNOperator(model_fn, nll_fn, params, batch, damping=damping, precision=precision,
                       flattener=flattener)


def ef_apply(G: torch.Tensor, v: torch.Tensor, n: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out + (1/n) Gᵀ (G v)``, f32 (P,); ``out`` defaults to zeros.

    CUDA: the rank-k kernel pair, in blocks of at most the kernel's row
    limit, each block added onto the running sum by pass 2.  CPU: v and
    the dots rounded to G's dtype, f32 accumulation (JAX ``ggn.py``'s
    ``dot_general`` pair), then the 1/n.
    """
    v = v.float()
    if v.is_cuda:
        from hessian_llm_vision_tpu_torch.ops import kernels

        acc = torch.zeros_like(v) if out is None else out
        for s in range(0, G.shape[0], kernels._MAX_K):
            Gb = G[s:s + kernels._MAX_K]
            w = kernels.rank_k_dots(v, Gb, torch.full((Gb.shape[0],), 1.0 / n, device=v.device))
            acc = kernels.rank_k_axpy(acc, Gb, w)
        return acc
    if v.device.type != "cpu" or G.device.type != "cpu":
        raise ValueError(f"ef_apply: no path for v on {v.device} with G on {G.device}")
    dots = G.float() @ v.to(G.dtype).float()
    res = (dots.to(G.dtype).float() @ G.float()) / n
    return res if out is None else out + res


def _grad_chunks(loss_fn_per_example, params, batch, chunk, precision, fl):
    """Per-example gradients, one (chunk, P) f32 block at a time; the
    loss's rematerialised regions run plainly under ``vmap``
    (``utils/remat.py``)."""
    n = next(iter(batch.values())).shape[0]
    grad_one = torch.func.grad(loss_fn_per_example)
    for s in range(0, n, chunk):
        ex = {k: x[s:s + chunk] for k, x in batch.items()}
        with _precision_context(precision), remat.plain():
            g = torch.func.vmap(lambda e: fl.flatten(grad_one(params, e)))(ex)
        yield g


def per_example_grads(
    loss_fn_per_example: Callable[[Params, Any], torch.Tensor],
    params: Params,
    batch: Mapping[str, torch.Tensor],
    *,
    chunk_size: Optional[int] = None,
    grad_dtype: torch.dtype = torch.float32,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
) -> torch.Tensor:
    """The (n, P) matrix G of flat per-example gradients in ``grad_dtype``,
    from ``torch.func.vmap(torch.func.grad(...))`` over ``chunk_size``
    examples at a time."""
    fl = flattener or Flattener(params)
    n = next(iter(batch.values())).shape[0]
    chunk = min(chunk_size or n, n)
    return torch.cat([g.to(grad_dtype) for g in _grad_chunks(loss_fn_per_example, params, batch,
                                                             chunk, precision, fl)])


def EmpiricalFisherOperator(
    loss_fn_per_example: Callable[[Params, Any], torch.Tensor],
    params: Params,
    batch: Mapping[str, torch.Tensor],
    *,
    damping: float = 0.0,
    flattener: Optional[Flattener] = None,
    chunk_size: Optional[int] = None,
    materialize: bool = True,
    grad_dtype: torch.dtype = torch.float32,
    precision: Optional[str] = "high",
) -> LinearOperator:
    """Empirical Fisher ``(1/n) Σᵢ gᵢ gᵢᵀ`` as an operator.

    ``loss_fn_per_example(params, example) -> scalar``; ``batch`` tensors
    carry a leading example axis.  ``materialize=True`` stores G once in
    ``grad_dtype`` (:func:`per_example_grads`; bf16 halves it) and applies
    it by :func:`ef_apply`; ``materialize=False`` stores nothing and
    recomputes the f32 gradients chunk by chunk in every matvec
    (O(chunk·P) memory at n gradients per matvec).
    """
    fl = flattener or Flattener(params)
    n = next(iter(batch.values())).shape[0]
    chunk = min(chunk_size or n, n)

    def damped(res, v):
        return res + damping * v if damping else res

    if materialize:
        G = per_example_grads(loss_fn_per_example, params, batch, chunk_size=chunk,
                              grad_dtype=grad_dtype, precision=precision, flattener=fl)
        return LinearOperator(lambda v: damped(ef_apply(G, v, n), v), fl.size)

    def matvec(v):
        res = None
        for g in _grad_chunks(loss_fn_per_example, params, batch, chunk, precision, fl):
            res = ef_apply(g, v, n, res)
        return damped(res, v)

    return LinearOperator(matvec, fl.size)
