"""Linearized HVPs (port of ``curvature/linearized.py``): pay the primal
once per (params, batch), then run every Lanczos iteration on the tangent
map alone.

A forward-over-reverse HVP re-runs the primal forward and backward under
every matvec, although Lanczos, KPM and the trainer's refresh hold
(params, batch) fixed over all their iterations.  The JAX package splits
``jax.linearize`` of the gradient into a residual program and a tangent
program.  Here the same split is made on one ``make_fx`` trace of
``torch.func.grad`` under forward-mode AD, taken on fake tensors (no
device work) with params, batch and tangent as graph inputs:

* the *residual graph* holds every node that does not depend on the
  tangent; it runs once per (params, batch) and returns the residuals,
  the intermediate values the tangent part reads;
* the *tangent graph* holds the rest and maps a tangent to ``H v`` from
  the residuals alone.

``torch.func.linearize`` gives the same tangent map (the tests hold them
equal), but it traces with the params and the batch baked in as
constants, so it would trace again, and evaluate the function twice
more, for every new (params, batch) -- once per trainer refresh.  The
trace here is made once per input signature and reused.

The catch is memory: the residuals are kept between calls
(:func:`residual_bytes` counts them without running the model).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch
import torch.autograd.forward_ad as fwAD
from torch.multiprocessing.reductions import StorageWeakRef

from hessian_llm_vision_tpu_torch.curvature.hvp import (
    LossFn,
    _precision_context,
    _scaled_loss_fn,
)
from hessian_llm_vision_tpu_torch.utils import remat
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


class _Split:
    """The traced HVP split in two graphs.  ``residual(*params, *batch)``
    returns the residuals; ``tangent(*residuals, *tangents)`` returns the
    HVP leaves in ``names`` order.  ``passed[i]`` marks a residual that is
    a param or batch tensor passed through; ``fake`` holds the others'
    fake values from the trace."""

    def __init__(self, names, batch_keys, residual, tangent, passed, fake):
        self.names, self.batch_keys = names, batch_keys
        self.residual, self.tangent = residual, tangent
        self.passed, self.fake = passed, fake


def _signature(params, batch) -> tuple:
    return tuple((k, tuple(t.shape), t.dtype, t.device) for k, t in (*params.items(), *batch.items()))


def _trace_split(loss_fn, normalization, batch_size, dataset_size, params, batch,
                 precision=None) -> _Split:
    """Trace the HVP on fake tensors and split it at the tangent.

    The trace runs inside ``precision``'s outer scope, so the graphs keep
    every bf16 or float64 cast of the model's scopes and every product
    whose TF32 flag differs from the outer scope's as a ``flag_einsum``
    node (``models/precision.py``), which sets its flag when replayed."""
    from torch.fx.experimental.proxy_tensor import make_fx

    names, bkeys = list(params), list(batch)
    n_in = len(names) + len(bkeys)

    def hvp_of(flat_p, flat_b, flat_t):
        scaled = _scaled_loss_fn(loss_fn, dict(zip(bkeys, flat_b)), normalization,
                                 batch_size, dataset_size)
        with _precision_context(precision, loss_fn), remat.plain(), fwAD.dual_level():
            duals = {n: fwAD.make_dual(p, t) for n, p, t in zip(names, flat_p, flat_t)}
            grads = torch.func.grad(scaled)(duals)
            return [fwAD.unpack_dual(grads[n]).tangent for n in names]

    flat_p = [params[n] for n in names]
    flat_b = [batch[k] for k in bkeys]
    flat_t = [torch.empty_like(p) for p in flat_p]
    gm = make_fx(hvp_of, tracing_mode="fake")(flat_p, flat_b, flat_t)
    gm.graph.eliminate_dead_code()
    nodes = list(gm.graph.nodes)
    inputs = [n for n in nodes if n.op == "placeholder"]
    out_node = next(n for n in nodes if n.op == "output")
    on_tangent = set(inputs[n_in:])
    for n in nodes:
        if n.op != "output" and any(a in on_tangent for a in n.all_input_nodes):
            on_tangent.add(n)
    # residuals: values off the tangent that the tangent part (or the
    # output) reads; params and batch among them are passed through
    residuals = [n for n in nodes if n not in on_tangent and n.op != "output"
                 and any(u in on_tangent or u is out_node for u in n.users)]

    primal = torch.fx.Graph()
    env = {}
    for n in nodes:
        if n.op == "placeholder" and n not in on_tangent:
            env[n] = primal.placeholder(n.name)
        elif n not in on_tangent and n.op != "output":
            env[n] = primal.node_copy(n, env.__getitem__)
    primal.output(tuple(env[n] for n in residuals))

    tangent = torch.fx.Graph()
    env = {n: tangent.placeholder(f"r_{i}") for i, n in enumerate(residuals)}
    for n in inputs[n_in:]:
        env[n] = tangent.placeholder(n.name)
    for n in nodes:
        if n in on_tangent and n.op != "placeholder":
            env[n] = tangent.node_copy(n, env.__getitem__)
    tangent.output(torch.fx.node.map_arg(out_node.args[0], env.__getitem__))
    passed = [n.op == "placeholder" for n in residuals]
    fake = [n.meta["val"] for n in residuals if n.op != "placeholder"]
    return _Split(names, bkeys, torch.fx.GraphModule(gm, primal),
                  torch.fx.GraphModule(gm, tangent), passed, fake)


def _distinct_storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors`` (a view counts
    with its base, once)."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[StorageWeakRef(s)] = s.nbytes()
    return int(sum(seen.values()))


@functools.lru_cache(maxsize=4)
def linearized_hvp_programs(
    loss_fn: LossFn,
    normalization: str,
    precision: Optional[str],
    fl: Flattener,
    batch_size: Optional[int] = None,
) -> tuple[Callable, Callable]:
    """``(residual_program, tangent_program)`` on flat f32 vectors, as the
    JAX package's: ``residual_program(params, batch) -> consts`` runs the
    primal once; ``tangent_program(v, consts, params, batch) -> H v`` runs
    the tangent map alone (params and batch are not read again; they keep
    the JAX signature).  The split is traced at the first call for each
    shape of (params, batch) and kept, so a second spectrum or refresh of
    the same loss pays no trace; the cache keeps the last 4 loss functions
    (and the models they close over) alive."""
    _precision_context(precision)  # validate eagerly
    splits: dict = {}

    def split_for(params, batch) -> _Split:
        key = _signature(params, batch)
        if key not in splits:
            splits[key] = _trace_split(loss_fn, normalization, batch_size, None, params, batch,
                                       precision)
        return splits[key]

    def residual_program(params, batch) -> tuple:
        sp = split_for(params, batch)
        with torch.no_grad(), _precision_context(precision, loss_fn):
            consts = sp.residual(*(params[n] for n in sp.names),
                                 *(batch[k] for k in sp.batch_keys))
        return (sp, tuple(consts))

    def tangent_program(v: torch.Tensor, consts, params=None, batch=None) -> torch.Tensor:
        sp, residuals = consts
        tangents = fl.unflatten(v.float())
        with torch.no_grad(), _precision_context(precision, loss_fn):
            out = sp.tangent(*residuals, *(tangents[n] for n in sp.names))
        return fl.flatten(dict(zip(sp.names, out)))

    return residual_program, tangent_program


def residual_bytes(
    loss_fn: LossFn,
    params_template,
    batch_template,
    *,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    precision: Optional[str] = None,
) -> int:
    """Bytes the residuals hold beyond the params and the batch, counted
    on the trace's fake tensors: nothing runs, and meta-device templates
    give the same count as real tensors.  Views count once with their
    base, as they do in memory.  ``precision``: the outer scope the
    residual program runs under (its bf16 casts change the count)."""
    _precision_context(precision)  # validate eagerly
    sp = _trace_split(loss_fn, normalization, batch_size, None,
                      dict(params_template), dict(batch_template), precision)
    return _distinct_storage_bytes(sp.fake)


def concrete_residual_bytes(consts) -> int:
    """The same count on the residuals that ``residual_program`` returned."""
    sp, residuals = consts
    return _distinct_storage_bytes(t for t, p in zip(residuals, sp.passed) if not p)


def linearized_matvec(
    loss_fn: LossFn,
    params,
    batch: Any,
    *,
    normalization: str = "mean",
    batch_size: Optional[int] = None,
    precision: Optional[str] = None,
    flattener: Optional[Flattener] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pays the residual pass now and returns ``v -> H v`` over the tangent
    map, a drop-in matvec at fixed (params, batch)."""
    fl = flattener or Flattener(params)
    resid_p, tangent_p = linearized_hvp_programs(loss_fn, normalization, precision, fl, batch_size)
    consts = resid_p(params, batch)
    return lambda v: tangent_p(v, consts)
