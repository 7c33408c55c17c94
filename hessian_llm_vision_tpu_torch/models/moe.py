"""Mixture-of-experts MLP for GPT-2 blocks (port of ``models/moe.py``).

Dense softmax gating by default: every expert evaluates every token and
the gate's softmax probabilities mix the outputs.  That is smooth and
twice differentiable, so forward-over-reverse HVPs are exact, and its
shapes are static.  The expert weights are stacked ``(E, ...)`` leaves
``w1`` (E, C, 4C), ``b1`` (E, 4C), ``w2`` (E, 4C, C), ``b2`` (E, C) beside
the ``gate`` dense layer, under the flax names.

``moe_top_k > 0`` routes each token to its top-k experts through buffers
of a static capacity (:func:`_topk_moe`).  The routing is piecewise
constant, so gradients and HVPs carry no routing curvature: curvature jobs
over such a config warn (:func:`warn_if_topk_curvature`).

Expert parallelism (:func:`make_ep_mesh`, :func:`moe_param_sharding`,
:func:`shard_params_for_ep`): each rank of the mesh's ``ep`` axis holds
E/ep of the stacked expert leaves, and a config built with
``parallel.param_sharding.model_parallel_config(cfg, ep_mesh)`` splits the
experts' work.  Dense gating: every rank mixes its experts' outputs for
all tokens and the sum over the axis adds the rest.  Top-k: the gate is
replicated, so every rank computes the same dispatch and keeps its
experts' slots.  The gate's probabilities and the tokens reach the
experts through ``copy_to_model``, so their gradients are summed over the
axis and come out whole on every rank.

Under sequence parallelism (``config.seq_sharding``) dense gating runs on
the rank's T-slice; top-k routing gathers every rank's slice first and
keeps its own after, so the capacity and the slot counts run over every
token of the sequences, as in the JAX package.  Expert and sequence
parallelism on one axis (a config with both, on one mesh): the T-slices
are gathered over the axis (their gradient reduce-scattered back), the
replicated gate routes every token on every rank, each rank runs its E/n
experts on every token, and the gate-weighted combine is reduce-scattered
back to the rank's T-slice.  The gate is a leaf the rank holds whole, so
under sequence parallelism its gradient is summed over the axis
(``models/losses.py::lm_loss_fn``), which adds the other ranks' experts.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hessian_llm_vision_tpu_torch.models import precision
from hessian_llm_vision_tpu_torch.models.collectives import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    reduce_scatter_to_model,
)
from hessian_llm_vision_tpu_torch.models.gpt2 import Dense, _as
from hessian_llm_vision_tpu_torch.models.losses import at_least_f32


class MoEMLP(nn.Module):
    """Softmax-gated mixture of ``config.n_experts`` MLPs, a drop-in for
    the transformer MLP (``config`` has ``n_embd``, ``n_experts``,
    ``moe_top_k``, ``moe_capacity_factor``)."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        E, C = config.n_experts, config.n_embd
        self.gate = Dense(C, E)
        self.w1 = nn.Parameter(torch.empty(E, C, 4 * C))
        self.b1 = nn.Parameter(torch.zeros(E, 4 * C))
        self.w2 = nn.Parameter(torch.empty(E, 4 * C, C))
        self.b2 = nn.Parameter(torch.zeros(E, C))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The expert kernels ``N(0, 0.02)``, as the flax module's."""
        nn.init.normal_(self.w1, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.w2, 0.0, 0.02, generator=generator)

    def forward(self, x):
        cfg = self.config
        local = self.w1.shape[0]  # this rank's experts: all of them, or E/ep under EP
        sp, mesh = cfg.seq_sharding, cfg.model_parallel
        ep = local < cfg.n_experts
        T = x.shape[1]
        if sp is not None and (cfg.moe_top_k or ep):  # every token of the sequences
            x = gather_from_model(x, sp.mesh, 1)
        probs = torch.softmax(at_least_f32(self.gate(x)), dim=-1).to(x.dtype)
        w1, b1, w2, b2 = (_as(p, x) for p in (self.w1, self.b1, self.w2, self.b2))
        first = 0
        if ep:
            if sp is None:  # replicated tokens: their gradients summed over the axis
                x, probs = copy_to_model(x, mesh), copy_to_model(probs, mesh)
            first = mesh.model_index * local
        if cfg.moe_top_k:
            y = _topk_moe(x, probs, w1, b1, w2, b2, cfg.moe_top_k, cfg.moe_capacity_factor,
                          first)
            if sp is not None and not ep:  # this rank's T-slice
                y = y[:, sp.mesh.model_index * T:(sp.mesh.model_index + 1) * T]
        else:
            h = F.gelu(precision.einsum("btc,ecf->btef", x, w1) + b1, approximate="tanh")
            y = precision.einsum("btef,efc->btec", h, w2) + b2
            y = precision.einsum("btec,bte->btc", y, probs[..., first:first + local])
        if not ep:
            return y
        # the other ranks' experts added; under SP only this rank's T-slice kept
        return reduce_from_model(y, mesh) if sp is None else reduce_scatter_to_model(y, mesh, 1)


def _topk_moe(x, probs, w1, b1, w2, b2, top_k: int, cap_factor: float, first: int = 0):
    """Capacity-based top-k dispatch, as the JAX package's: each token goes
    to its ``top_k`` experts with renormalised gate weights; each expert
    holds ``cap = ceil(top_k N / E * cap_factor)`` token slots, filled in
    top-k rank order, then token order (a cumulative sum); a token past an
    expert's capacity is dropped from it.  With ``top_k == E`` and room for
    every token it equals the dense mix.  The experts of ``w1`` ... are
    ``[first, first + len(w1))`` of the E that ``probs`` routes over (an
    expert-parallel rank's), and only their slots are computed."""
    B, T, C = x.shape
    E = probs.shape[-1]
    N = B * T
    cap = max(1, min(int(math.ceil(top_k * N / E * cap_factor)), N))
    pf = at_least_f32(probs.reshape(N, E))
    vals, sel = torch.topk(pf, top_k, dim=-1)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-30)
    slots = torch.arange(cap, device=x.device)
    combine = torch.zeros(N, E, cap, dtype=pf.dtype, device=x.device)
    counts = torch.zeros(E, dtype=torch.long, device=x.device)
    for j in range(top_k):
        mask = F.one_hot(sel[:, j], E)  # (N, E)
        pos = counts[None, :] + torch.cumsum(mask, dim=0) - mask
        within = ((pos < cap) & (mask > 0)).to(pf.dtype)
        slot = (pos[..., None] == slots).to(pf.dtype)  # (N, E, cap); none past cap
        combine = combine + vals[:, j, None, None] * within[..., None] * slot
        counts = counts + mask.sum(0)
    combine = combine[:, first:first + w1.shape[0]]
    dispatch = (combine > 0).to(x.dtype)
    expert_in = precision.einsum("nec,nd->ecd", dispatch, x.reshape(N, C))
    h = F.gelu(precision.einsum("ecd,edf->ecf", expert_in, w1) + b1[:, None, :],
               approximate="tanh")
    y = precision.einsum("ecf,efd->ecd", h, w2) + b2[:, None, :]
    return precision.einsum("nec,ecd->nd", combine.to(x.dtype), y).reshape(B, T, C)


class TopKCurvatureWarning(UserWarning):
    """Curvature job launched over piecewise-constant top-k MoE routing."""


def topk_curvature_warning(config) -> Optional[str]:
    """The warning text when ``config`` routes with top-k, else None: the
    routing is piecewise constant, so gradients and HVPs are exact only
    inside the active routing region, and a Ritz basis computed at a
    refresh can describe another operator than the steps that reuse it."""
    top_k = int(getattr(config, "moe_top_k", 0) or 0)
    n_experts = int(getattr(config, "n_experts", 0) or 0)
    if not (n_experts and top_k):
        return None
    return (
        f"curvature over TOP-K MoE routing (n_experts={n_experts}, "
        f"moe_top_k={top_k}): the routing is piecewise-constant, so "
        "HVPs/spectra are exact only within the ACTIVE routing region and "
        "carry zero routing curvature — Ritz pairs computed at a refresh "
        "boundary can describe a different operator than the steps that "
        "reuse them. Use the dense gating (moe_top_k=0 / drop --moe_top_k) "
        "for curvature-exact jobs; top-k results are region-conditional."
    )


def warn_if_topk_curvature(model_or_config, *, what: str = "curvature job") -> Optional[str]:
    """A :class:`TopKCurvatureWarning` (warnings module and stderr) when a
    curvature job runs on a top-k routed config; returns its text or None."""
    import sys
    import warnings

    config = getattr(model_or_config, "config", model_or_config)
    msg = topk_curvature_warning(config)
    if msg is not None:
        warnings.warn(f"[{what}] {msg}", TopKCurvatureWarning, stacklevel=2)
        print(f"WARNING [{what}]: {msg}", file=sys.stderr)
    return msg


_EXPERT_LEAF = ("w1", "w2", "b1", "b2")


def moe_param_sharding(params, mesh, *, ep_axis: str = "ep") -> dict:
    """``{name: spec}``: the stacked expert leaves (``...moe.w1|w2|b1|b2``)
    split dim 0 over ``ep_axis``; everything else replicated, and so is an
    expert leaf whose count does not divide the axis."""
    ep = mesh.shape[ep_axis]
    out = {}
    for name, leaf in params.items():
        *path, last = name.split(".")
        expert = bool(path) and path[-1] == "moe" and last in _EXPERT_LEAF
        out[name] = ((ep_axis,) + (None,) * (len(leaf.shape) - 1)
                     if expert and leaf.shape[0] % ep == 0 else ())
    return out


def ep_layout(params, mesh, *, ep_axis: str = "ep") -> dict:
    """``{name: Split or None}`` of :func:`moe_param_sharding` (the layout
    that ``parallel/param_sharding.py`` and ``utils/flatten.py`` read)."""
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import Split

    return {k: Split(0) if spec else None
            for k, spec in moe_param_sharding(params, mesh, ep_axis=ep_axis).items()}


def shard_params_for_ep(params, mesh, *, ep_axis: str = "ep") -> dict:
    """This rank's experts of the whole ``params`` (any dict with the
    model's names); every other leaf whole."""
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params

    return shard_params(params, ep_layout(params, mesh, ep_axis=ep_axis), mesh)


def make_ep_mesh(num_data: int, num_experts_axis: int):
    """Mesh('data', 'ep') over the ranks of the default group: batch axis x
    expert axis."""
    from hessian_llm_vision_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(num_data, num_experts_axis, axis_names=("data", "ep"))
