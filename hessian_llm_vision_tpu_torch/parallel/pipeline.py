"""Pipeline parallelism, GPipe style, over a mesh's ``pp`` axis (port of
``parallel/pipeline.py``).

The L transformer blocks are grouped into S stages and their parameters
stacked into ``blocks.<leaf>`` of shape ``(S, L/S, ...)``; rank s of the
pipeline axis holds ``(1, L/S, ...)``, its stage alone (the memory lever:
block parameters never replicate across the pipeline).  The batch is split
into M microbatches that rotate through the stages over ``M + S - 1``
ticks, one shift to the next stage per tick.  Embedding, final norm, head
and loss stay outside the staged region, so the whole remains an ordinary
``loss(params, batch)``: gradients, HVPs and Lanczos run through it
unchanged.

The JAX package writes the schedule as a ``shard_map`` over a ``lax.scan``
with one ``ppermute`` per tick and lets autodiff transpose it.  Here each
rank runs its own Python: stage s works on microbatch ``t - s`` at tick t
and skips its bubble ticks (the JAX ``jnp.where`` throws their results
away, so the function is the same); the shift, the exit and the sums of
the gradients are the differentiable collectives of
``models/collectives.py``, which gloo runs on CUDA tensors as broadcasts
and all-reduces.  The ranks' graphs differ, so their collectives must be
ordered alike in the backward pass too: the residual stream is one chain
on every rank (a stage that has nothing to do passes it on, stage 0 adds
its embedding to the zeros it receives, and the exit takes the chain's
end), so the backward runs the exit, then the shifts from the last tick
to the first, then the parameter sums, on every rank.

The mesh is ``Mesh(('data', 'pp'))`` (:func:`make_pipeline_mesh`): the
pipeline axis is the mesh's second axis and uses its model group.  With
``data_axis="data"`` each microbatch's rows split over the data axis and
the loss is the whole batch's on every rank.  The layout of the stacked
parameters (:func:`pipeline_param_sharding`) is a model-axis layout
(``{name: Split or None}``), so ``parallel.param_sharding.shard_params``,
``models.convert.gather_model_axis``, ``utils.flatten.ModelAxisLayout``
and ``krylov.sharded.ModelShard`` (the Krylov basis on the pipeline axis)
take it unchanged.

``remat_ticks=True`` (the JAX package's per-tick checkpointing) runs each
tick's stage work -- the embedding on stage 0 and the stage's blocks -- as
one rematerialised region (``utils/remat.py``) that saves its inputs only:
the residual stream it receives and the stage's parameters.  The shifts,
the exit and the parameter sums stay outside the regions, so a backward
recompute issues no collective that another rank does not expect.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch
import torch.utils._pytree as pytree
from torch.func import functional_call

from hessian_llm_vision_tpu_torch.models import precision
from hessian_llm_vision_tpu_torch.models.gpt2 import _as
from hessian_llm_vision_tpu_torch.models.collectives import (
    copy_params,
    reduce_from_axis,
    scatter_from_last_stage,
    shift_stages,
)
from hessian_llm_vision_tpu_torch.models.losses import at_least_f32, token_log_likelihood
from hessian_llm_vision_tpu_torch.parallel.mesh import Mesh, make_mesh
from hessian_llm_vision_tpu_torch.parallel.param_sharding import Split
from hessian_llm_vision_tpu_torch.utils.remat import remat

BLOCKS = "blocks."


def make_pipeline_mesh(num_data: int, num_stages: int) -> Mesh:
    """Mesh('data', 'pp') over the ranks of the default group: batch axis x
    pipeline-stage axis (the JAX grid ``reshape(num_data, num_stages)``)."""
    return make_mesh(num_data, num_stages, axis_names=("data", "pp"))


def _block_index(name: str, prefix: str) -> Optional[tuple]:
    head, _, rest = name.partition(".")
    if head.startswith(prefix) and head[len(prefix):].isdigit() and rest:
        return int(head[len(prefix):]), rest
    return None


def stack_pipeline_params(params: Mapping[str, torch.Tensor], n_layer: int, n_stages: int, *,
                          block_prefix: str = "h_") -> dict:
    """``h_{i}.<leaf>`` regrouped into ``blocks.<leaf>`` of shape
    ``(n_stages, n_layer // n_stages, ...)`` (stage-major, layer order
    kept); every other leaf (``wte``, ``wpe``, ``ln_f``, ``lm_head``)
    passes through.  Works on any dict with the model's names: params, a
    tangent, a gradient."""
    if n_layer % n_stages:
        raise ValueError(f"n_layer={n_layer} not divisible by n_stages={n_stages}")
    nb = n_layer // n_stages
    per_leaf: dict = {}
    out = {}
    for name, t in params.items():
        hit = _block_index(name, block_prefix)
        if hit is None:
            out[name] = t
        else:
            per_leaf.setdefault(hit[1], {})[hit[0]] = t
    for leaf, by_layer in per_leaf.items():
        if sorted(by_layer) != list(range(n_layer)):
            raise ValueError(f"blocks of {leaf!r}: layers {sorted(by_layer)}, expected {n_layer}")
        layers = torch.stack([by_layer[i] for i in range(n_layer)])
        out[BLOCKS + leaf] = layers.reshape((n_stages, nb) + tuple(layers.shape[1:]))
    return out


def unstack_pipeline_params(pipe_params: Mapping[str, torch.Tensor], *,
                            block_prefix: str = "h_") -> dict:
    """Inverse of :func:`stack_pipeline_params` (exact round trip)."""
    out = {}
    for name, t in pipe_params.items():
        if not name.startswith(BLOCKS):
            out[name] = t
            continue
        S, nb = t.shape[:2]
        for s in range(S):
            for j in range(nb):
                out[f"{block_prefix}{s * nb + j}.{name[len(BLOCKS):]}"] = t[s, j]
    return out


def pipeline_param_sharding(pipe_params: Mapping[str, torch.Tensor], mesh: Mesh, *,
                            pp_axis: str = "pp") -> dict:
    """``{name: Split(0) for blocks.*, None otherwise}``: the stacked blocks
    split along their stage dimension over ``pp_axis`` (the mesh's second
    axis), everything else replicated.  ``shard_params(pipe_params, this,
    mesh)`` keeps each rank's stage."""
    _check_pp_axis(mesh, pp_axis)
    return {name: Split(0) if name.startswith(BLOCKS) else None for name in pipe_params}


def _check_pp_axis(mesh: Mesh, pp_axis: str) -> None:
    if pp_axis != mesh.axis_names[1]:
        raise ValueError(f"the pipeline runs on the mesh's second axis {mesh.axis_names[1]!r}, "
                         f"not {pp_axis!r}")


def _data_split(mesh: Mesh, data_axis: Optional[str]) -> bool:
    if data_axis is None:
        return False
    if data_axis != mesh.axis_names[0]:
        raise ValueError(f"the batch splits over the mesh's first axis {mesh.axis_names[0]!r}, "
                         f"not {data_axis!r}")
    return mesh.num_data > 1


def exit_parts(num_microbatches: int, num_stages: int, scatter: bool) -> tuple:
    """Which microbatches ``(lo, hi)`` each stage holds after the exit:
    contiguous shares when scattered (equal when the stages divide M, as the
    JAX ``psum_scatter``; otherwise the first ``M % S`` stages take one
    more), all of them on every stage otherwise (the JAX ``psum``)."""
    M, S = num_microbatches, num_stages
    if not scatter:
        return ((0, M),) * S
    base, extra = divmod(M, S)
    parts, lo = [], 0
    for s in range(S):
        hi = lo + base + (s < extra)
        parts.append((lo, hi))
        lo = hi
    return tuple(parts)


def _data_rows(b: int, mesh: Mesh, split: bool) -> slice:
    if not split:
        return slice(0, b)
    n, d = mesh.num_data, mesh.data_index
    if b % n:
        raise ValueError(f"a microbatch of {b} rows does not split over {n} ranks of the data axis")
    return slice(d * b // n, (d + 1) * b // n)


def pipeline_apply(stage_fn: Callable[[Mapping[str, torch.Tensor], torch.Tensor], torch.Tensor],
                   stage_params: Mapping[str, torch.Tensor], inputs: torch.Tensor, mesh: Mesh, *,
                   input_fn: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None,
                   input_consts: Any = None, pp_axis: str = "pp",
                   data_axis: Optional[str] = None, scatter_outputs: bool = True,
                   remat_ticks: bool = False) -> torch.Tensor:
    """Rotate microbatched activations through the stage pipeline.

    ``stage_params``: this rank's stage, ``{leaf: (1, nb, ...)}`` (its
    slice of the stacked blocks, prefix stripped).  ``inputs``: ``(M, b,
    ...)`` microbatched raw inputs, the same on every rank; with
    ``data_axis`` each rank takes its rows of every microbatch.
    ``input_fn(input_consts, inputs[m]) -> (b, T, C)`` makes stage 0's
    activations inside the region (the embedding), so only the raw inputs
    enter it; ``None``: ``inputs`` are the activations.
    ``stage_fn(stage_params, x) -> x`` applies one stage's blocks.

    Schedule: at tick t stage s works on microbatch ``t - s`` (nothing in
    its bubble: the GPipe bubble is (S-1)/(M+S-1) of the ticks), then the
    residual stream shifts to the next stage; microbatch m leaves the last
    stage at tick ``m + S - 1``.  Exit (:func:`exit_parts`): with
    ``scatter_outputs`` each rank returns its share of the microbatches,
    ``(n_s, b, T, C)``, else all M.  What the caller computes from them is
    each rank's share: the transpose of the exit sums the ranks'
    cotangents at the last stage, so the caller sums its results over the
    axis (``make_pipelined_lm_loss`` sums its loss shares).
    ``remat_ticks``: each tick's work on a stage (stage 0's embedding of its
    microbatch, then the stage's blocks) is rematerialised; the leaves of
    ``input_consts`` must then be tensors.
    """
    _check_pp_axis(mesh, pp_axis)
    S, s = mesh.num_model, mesh.model_index
    M = inputs.shape[0]
    rows = _data_rows(inputs.shape[1], mesh, _data_split(mesh, data_axis))
    local = {k: v[0] for k, v in stage_params.items()}  # (1, nb, ...) -> (nb, ...)
    # every rank's link to the parameters (see models/collectives.py)
    link = next(iter(stage_params.values())).reshape(-1)[0]

    def enter(m):
        mb = inputs[m, rows]
        return input_fn(input_consts, mb) if input_fn is not None else mb

    names = list(local)
    const_leaves, const_spec = pytree.tree_flatten(input_consts)

    def work(carry, *tensors):
        """Stage s's tick: the tensors are its blocks' leaves, then on stage
        0 the microbatch's activations, or the embedding's consts and the
        microbatch's raw inputs."""
        x = carry
        if s == 0:
            rest = tensors[len(names):]
            x = carry + (rest[0] if input_fn is None else input_fn(
                pytree.tree_unflatten(list(rest[:-1]), const_spec), rest[-1]))
        return stage_fn(dict(zip(names, tensors[:len(names)])), x)

    # the activations' shape and dtype, the same on every rank: one
    # microbatch entered without a graph
    with torch.no_grad():
        probe = enter(0)
    # the residual stream, one chain on every rank; it starts from zeros
    # tied to the parameters, so every rank's collectives are in the graph
    carry = (link * 0).to(probe.dtype).expand(probe.shape)
    del probe
    outs = []
    last_tick = M + S - 2
    for t in range(last_tick + 1):
        m = t - s
        if 0 <= m < M:
            args, consts = (carry, *local.values()), ()
            if s == 0 and input_fn is None:
                args += (inputs[m, rows],)
            elif s == 0:
                args, consts = args + tuple(const_leaves), (inputs[m, rows],)
            x = remat(work, *args, consts=consts) if remat_ticks else work(*args, *consts)
            if s == S - 1:
                outs.append(x)
            carry = x
        if t < last_tick:
            moves = [(r, r + 1) for r in range(S - 1) if 0 <= t - r < M]
            carry = shift_stages(carry, link, mesh, moves)
    if s == S - 1:  # the chain ends in its last output
        stacked = torch.stack(outs)
    else:  # the exit takes the chain's end (zeros) in place of outputs
        stacked = carry.unsqueeze(0).expand((M,) + tuple(carry.shape)) * 0
    parts = exit_parts(M, S, scatter_outputs)
    return scatter_from_last_stage(stacked, link, mesh, parts)


def make_pipelined_lm_loss(model, mesh: Mesh, *, num_microbatches: int, pp_axis: str = "pp",
                           data_axis: Optional[str] = None, include_padding: bool = False,
                           remat_ticks: bool = False):
    """Pipelined GPT-2 LM loss: ``loss(pipe_params, batch) -> scalar``.

    ``pipe_params``: this rank's part of :func:`stack_pipeline_params`'s
    dict under :func:`pipeline_param_sharding` (its stage's blocks, the
    other leaves whole); ``batch``: the whole batch on every rank.  The
    blocks run per stage under ``cfg.block_matmul_precision`` (one tier:
    a per-layer tuple raises, as the JAX ``uniform_precision`` does); the
    embedding enters inside the region, and ``ln_f``, the tied or untied
    head and the shifted cross-entropy run outside it on each rank's
    microbatches (and, with ``data_axis``, its rows of them).  Each rank's
    share of the whole batch's mean (with the attention mask, unless
    ``include_padding``) is summed over the mesh, so the loss, and the
    gradient of every leaf a rank holds, are the whole model's on every
    rank.  ``remat_ticks``: :func:`pipeline_apply`'s.  The result is the
    usual ``loss_fn(params, batch)``:
    ``curvature/hvp.py``, ``HessianOperator``, ``krylov.driver`` and
    ``lanczos`` with ``basis_sharding(mesh, ModelAxisLayout(...))`` take it
    unchanged."""
    cfg = model.config
    if cfg.seq_sharding is not None:
        raise ValueError("make_pipelined_lm_loss does not support cfg.seq_sharding; use the "
                         "sequential model for seq-parallel runs")
    if cfg.model_parallel is not None:
        raise ValueError("make_pipelined_lm_loss does not support cfg.model_parallel: the "
                         "pipeline mesh has no model axis besides its stages")
    _check_pp_axis(mesh, pp_axis)
    split = _data_split(mesh, data_axis)
    block_prec = precision.uniform_precision(cfg.block_matmul_precision)
    block = model.h_0
    M, S = num_microbatches, mesh.num_model
    parts = exit_parts(M, S, True)
    # gradient sums: a stage's blocks over the data axis (each data rank
    # runs its rows through them), the other leaves over every rank
    block_axis, rest_axis = ("data", "mesh") if split else (None, "model")

    def stage_fn(bp, x):
        with precision.precision_scope(block_prec):
            for j in range(next(iter(bp.values())).shape[0]):
                x = functional_call(block, {k: v[j] for k, v in bp.items()}, (x,))
        return x

    def loss(pipe_params, batch):
        ids = batch["input_ids"]
        B, T = ids.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by num_microbatches={M}")
        names = list(pipe_params)
        axes = [block_axis if n.startswith(BLOCKS) else rest_axis for n in names]
        p = dict(zip(names, copy_params([pipe_params[n] for n in names], mesh, axes)))
        blocks = {n[len(BLOCKS):]: t for n, t in p.items() if n.startswith(BLOCKS)}
        idm = ids.reshape(M, B // M, T)

        def embed(consts, mb):
            wte, wpe = consts
            tok, pos = wte[mb], wpe[:T][None]
            if cfg.dtype == torch.bfloat16:
                return tok.to(cfg.dtype) + pos.to(cfg.dtype)
            return tok + pos

        ym = pipeline_apply(stage_fn, blocks, idm, mesh, input_fn=embed,
                            input_consts=(p["wte"], p["wpe"]), pp_axis=pp_axis,
                            data_axis=data_axis, scatter_outputs=True,
                            remat_ticks=remat_ticks)
        lo, hi = parts[mesh.model_index]
        rows = _data_rows(B // M, mesh, split)
        n, b = ym.shape[:2]
        y = functional_call(model.ln_f, {"scale": p["ln_f.scale"], "bias": p["ln_f.bias"]},
                            (ym.reshape(n * b, T, ym.shape[-1]),))
        if cfg.tie_word_embeddings:  # as models/gpt2.py::GPT2LMHead
            logits = precision.einsum("btc,vc->btv", y, _as(p["wte"], y))
        else:
            logits = precision.matmul(at_least_f32(y), p["lm_head.kernel"])
        mine = idm[lo:hi, rows].reshape(n * b, T)
        mask = batch.get("attention_mask")
        if mask is not None and not include_padding:
            w = mask[:, 1:].float()
            w_mine = w.reshape(M, B // M, T - 1)[lo:hi, rows].reshape(n * b, T - 1)
        else:
            w = torch.ones(B, T - 1, device=ids.device)
            w_mine = w[:n * b]
        ll = token_log_likelihood(at_least_f32(logits)[:, :-1], mine[:, 1:])
        share = -(ll * w_mine).sum() / torch.clamp(w.sum(), min=1.0)
        return reduce_from_axis(share, mesh, "mesh" if split else "model")

    # the outer precision scope sets the ambient TF32 flag from it
    loss.model_config = cfg
    return loss
