"""Rematerialisation that composes with ``torch.func``.

The JAX package has no file of its own for this: it wraps a loss, a query
block, a loss chunk or a pipeline tick in ``jax.checkpoint`` where it uses
it.  ``torch.utils.checkpoint`` does not compose with ``torch.func.grad``
and ``torch.func.jvp``, the transforms every curvature product here is
made of, so :func:`remat` is an ``autograd.Function`` in the functorch
style (``setup_context``, ``save_for_backward``, ``save_for_forward``, a
``jvp`` staticmethod), like ``models/collectives.py``'s:

* ``forward`` runs the region and keeps none of its intermediates: the
  Function saves only its inputs;
* ``backward`` runs the region again under ``torch.func.vjp`` and pulls
  the cotangents back through it.  Under the outer ``jvp`` of an HVP its
  inputs are dual tensors, so the recompute carries their tangents and the
  second-order terms come out right;
* ``jvp`` is the region's own, ``torch.func.jvp`` of it.

Under ``torch.func.grad`` the backward runs one transform level down.
functorch's ``grad`` differentiates with ``create_graph=True`` and keeps
the forward's saved tensors until it returns, so a recompute recorded at
its level would be kept whole, region after region, and save nothing.  One
level down, the HVP's tangents (forward mode) and an outer ``grad`` (a
reverse-over-reverse product) still see every operation.  Tensors made
inside a transform belong to its level, so whatever a region reads besides
its differentiable inputs -- masks, token ids, weights of the loss -- goes
in as ``consts``: saved, taken down a level with the inputs, and never
differentiated.

Under ``jvp(grad(f))`` a region runs about three times (the forward, its
jvp, the recompute in backward), where XLA runs a checkpointed region
about twice.  The recompute runs under the precision scopes
(``models/precision.py``) open when the region was called.  A region that
issues collectives issues them again in the backward, so every rank must
recompute its regions in one order.

Two transforms take the regions plainly (:func:`plain`): ``vmap`` (the
per-example gradients of ``curvature/ggn.py``), under which functorch
cannot run the recompute, and the linearized HVP's ``make_fx`` trace.
Inside a region a nested :func:`remat` runs plainly too.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
from torch._C import _functorch
from torch._functorch.pyfunctorch import retrieve_current_functorch_interpreter

_inside = threading.local()


class _Remat(torch.autograd.Function):
    @staticmethod
    def forward(fn, n, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn, ctx.n = inputs[0], inputs[1]
        ctx.save_for_backward(*inputs[2:])
        ctx.save_for_forward(*inputs[2:])

    @staticmethod
    def backward(ctx, *cts):
        tensors, level = ctx.saved_tensors, None
        if any(_functorch.is_gradtrackingtensor(t) for t in tensors + cts):
            interpreter = retrieve_current_functorch_interpreter()
            level = interpreter.level()
            tensors, cts = ([_functorch._unwrap_for_grad(t, level) for t in ts]
                            for ts in (tensors, cts))
        xs, consts = tensors[:ctx.n], tensors[ctx.n:]
        with contextlib.nullcontext() if level is None else interpreter.lower():
            _, pullback = torch.func.vjp(lambda *a: ctx.fn(*a, *consts), *xs)
            grads = pullback(cts[0] if len(cts) == 1 else tuple(cts))
        if level is not None:
            grads = [_functorch._wrap_for_grad(g, level) for g in grads]
        return (None, None, *grads) + (None,) * len(consts)

    @staticmethod
    def jvp(ctx, _fn_t, _n_t, *ts):
        tensors = ctx.saved_tensors
        xs, consts = tensors[:ctx.n], tensors[ctx.n:]
        ts = tuple(torch.zeros_like(x) if t is None else t for x, t in zip(xs, ts))
        return torch.func.jvp(lambda *a: ctx.fn(*a, *consts), xs, ts)[1]


def _region(fn: Callable) -> Callable:
    """``fn`` under its scopes, marked as running inside a region."""
    from hessian_llm_vision_tpu_torch.models.precision import rescoped  # models import this module

    scoped = rescoped(fn)

    def run(*tensors):
        depth = getattr(_inside, "depth", 0)
        _inside.depth = depth + 1
        try:
            return scoped(*tensors)
        finally:
            _inside.depth = depth

    return run


@contextlib.contextmanager
def plain():
    """Inside the block every :func:`remat` runs its ``fn`` plainly: the
    linearized HVP's ``make_fx`` trace (``curvature/linearized.py``), which
    runs classic forward-mode AD, where the Function's ``jvp`` could not
    open a level of its own (its residuals are kept between calls anyway,
    as ``jax.checkpoint`` cannot shrink a linearization's either), and
    ``vmap``."""
    depth = getattr(_inside, "depth", 0)
    _inside.depth = depth + 1
    try:
        yield
    finally:
        _inside.depth = depth


def remat(fn: Callable, *xs: torch.Tensor, consts: tuple = ()):
    """``fn(*xs, *consts)`` (a tensor or a tuple of tensors), with its
    intermediates recomputed in the backward pass instead of kept.  ``xs``
    are floating-point tensors, differentiated; ``consts`` are tensors that
    are not (masks, token ids, loss weights); ``fn`` reads no other tensor
    made inside a transform."""
    if getattr(_inside, "depth", 0):
        return fn(*xs, *consts)
    return _Remat.apply(_region(fn), len(xs), *xs, *consts)
