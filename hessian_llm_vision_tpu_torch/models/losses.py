"""Loss closures binding models to the curvature / training APIs
(port of ``models/losses.py``).

Everything downstream consumes ``loss_fn(params, batch) -> scalar mean
loss`` where ``params`` is a ``{name: tensor}`` dict and ``batch`` a dict:
``input_ids`` (B, T) and optional ``attention_mask`` for the language
models, ``image`` and ``label`` for the classifiers.  The model is
evaluated with ``torch.func.functional_call``, so the same closure serves
``torch.func.grad`` and forward-over-reverse HVPs.

``include_padding=True`` is the reference / HF ``labels=input_ids``
convention (mean over all B*(T-1) targets, pads included); the default
masks pad targets through ``attention_mask``.

On the model axis of a mesh (``parallel/``) the LM losses take a model's
slices: logits split over the vocabulary (``vocab_mesh``: a log-softmax
whose sums run over the axis, ``models/collectives.py``) and a rank's
T-slice of a sequence-parallel model (``seq_mesh``: its targets taken from
the whole ``input_ids``, so the last token of every slice keeps its next
token, and its sum of token losses summed over the axis).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from hessian_llm_vision_tpu_torch.models import precision
from hessian_llm_vision_tpu_torch.models.collectives import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    vocab_parallel_log_likelihood,
)
from hessian_llm_vision_tpu_torch.utils.remat import remat as remat_region


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """bf16/f16 -> f32; f32 and f64 stay as they are (a float64 copy of the
    params gives a float64 loss, the reference of the HVP checks)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch, integer labels."""
    logp = F.log_softmax(at_least_f32(logits), dim=-1)
    return -logp.gather(-1, labels[:, None]).squeeze(-1).mean()


def token_log_likelihood(logits, targets, vocab_mesh=None):
    """``log softmax(logits)[target]`` per position, in at least f32
    (``vocab_mesh``: ``logits`` are this rank's slice of the vocabulary)."""
    if vocab_mesh is not None:
        return vocab_parallel_log_likelihood(at_least_f32(logits), targets, vocab_mesh)
    logp = F.log_softmax(at_least_f32(logits), dim=-1)
    return logp.gather(-1, targets[..., None]).squeeze(-1)


def _targets(input_ids, attention_mask, include_padding, local_len: int, seq_mesh):
    """``(first, stop, weights (B, T-1))``: the positions ``[first, stop)``
    whose next-token losses this rank sums (all of them, or under
    ``seq_mesh`` those of its T-slice of ``local_len`` tokens, the last
    position of the sequence having no target) and every target's weight."""
    B, T = input_ids.shape
    first = 0 if seq_mesh is None else seq_mesh.model_index * local_len
    stop = min(first + local_len, T - 1)
    if attention_mask is not None and not include_padding:
        w = attention_mask[:, 1:].float()
    else:
        w = torch.ones(B, T - 1, device=input_ids.device)
    return first, stop, w


def causal_lm_loss(
    logits: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    include_padding: bool = False,
    vocab_mesh=None,
    seq_mesh=None,
) -> torch.Tensor:
    """Shifted next-token CE: mean over unmasked targets (default) or over
    all targets (``include_padding=True``).  ``vocab_mesh``: ``logits`` are
    this rank's slice of the vocabulary; ``seq_mesh``: this rank's T-slice
    of the positions, and ``input_ids`` the whole sequences."""
    first, stop, w = _targets(input_ids, attention_mask, include_padding, logits.shape[1],
                              seq_mesh)
    token_ll = token_log_likelihood(logits[:, :stop - first], input_ids[:, first + 1:stop + 1],
                                     vocab_mesh)
    total = (token_ll * w[:, first:stop]).sum()
    if seq_mesh is not None:
        total = reduce_from_model(total, seq_mesh)
    return -total / torch.clamp(w.sum(), min=1.0)


_HEAD_PRECISIONS = (None, "default", "high", "highest", "act_high", "weight_high")


def head_product(h: torch.Tensor, wk: torch.Tensor, head_precision: Optional[str]) -> torch.Tensor:
    """``h @ wk`` of the vocab head at ``head_precision``, the JAX package's
    five names mapped onto the card's tiers (``models/precision.py``):

    ==================  ==========================================================
    ``None``            the innermost scope's tier (inherited)
    ``"high"``,         the fp32 tier
    ``"highest"``
    ``"default"``       the bf16 tier (bf16 operands, f32 accumulation)
    ``"act_high"``      the weight operand rounded to bf16, then an fp32 product
    ``"weight_high"``   the activation operand rounded to bf16, then an fp32
                        product
    ==================  ==========================================================

    The TPU's "act_high" / "weight_high" split one operand into bf16
    passes (2 of the MXU's); the card has no per-operand pass count, so
    the port rounds the other operand once and multiplies in fp32: an
    interim deviation, with the same operand kept exact."""
    if head_precision not in _HEAD_PRECISIONS:
        raise ValueError(f"head_precision {head_precision!r}; expected one of {_HEAD_PRECISIONS}")
    if head_precision is None:
        return precision.matmul(h, wk)
    if head_precision == "act_high":
        wk = wk.to(torch.bfloat16).to(wk.dtype)
    elif head_precision == "weight_high":
        h = h.to(torch.bfloat16).to(h.dtype)
    tier = "default" if head_precision == "default" else "high"
    with precision.precision_scope(tier):
        return precision.matmul(h, wk)


def chunked_causal_lm_loss(
    hidden: torch.Tensor,
    out_kernel: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    include_padding: bool = False,
    remat: bool = True,
    unroll: bool = False,
    head_precision: Optional[str] = None,
    vocab_mesh=None,
    seq_mesh=None,
) -> torch.Tensor:
    """Shifted next-token CE computed over sequence chunks of the vocab
    projection, never forming the whole (B, T, V) logits at once.

    ``hidden`` (B, T, C) are the final pre-logit states, ``out_kernel``
    (C, V) the output projection.  Equal to :func:`causal_lm_loss` on the
    dense logits.  With ``remat`` (the default, as in the JAX package)
    each chunk's projection, log-softmax and gather run as one
    rematerialised region (``utils/remat.py``) that saves only its slice
    of ``hidden`` and the kernel, so under ``grad`` and ``jvp(grad(.))``
    no chunk's (B, chunk, V) logits outlive it; without, every chunk's
    stay live.  ``unroll`` (the JAX scan's) changes nothing here: the
    values are identical.  ``head_precision``: :func:`head_product`.
    ``vocab_mesh``: ``out_kernel`` holds this rank's columns of the
    vocabulary (the hidden states enter it through ``copy_to_model``), and
    the log-softmax's sums over the model axis run inside each region, so
    its backward issues them again, in the same order on every rank;
    ``seq_mesh``: ``hidden`` is this rank's T-slice and ``input_ids`` the
    whole sequences; both: the T-slices are gathered first, and every
    rank's loss covers every position.
    """
    gathered = vocab_mesh is not None and seq_mesh is not None
    if gathered:  # a vocab-split head sees every position; the gradient scattered back
        hidden, seq_mesh = gather_from_model(hidden, seq_mesh, 1), None
    first, stop, w = _targets(input_ids, attention_mask, include_padding, hidden.shape[1],
                              seq_mesh)
    h = at_least_f32(hidden[:, :stop - first])
    if vocab_mesh is not None and not gathered:
        h = copy_to_model(h, vocab_mesh)
    targets = input_ids[:, first + 1:stop + 1]
    wl = w[:, first:stop]
    wk = at_least_f32(out_kernel)
    partials = []
    for s in range(0, stop - first, chunk):
        hc, tc, wc = h[:, s : s + chunk], targets[:, s : s + chunk], wl[:, s : s + chunk]

        def body(hc, wk, tc, wc):
            ll = token_log_likelihood(head_product(hc, wk, head_precision), tc, vocab_mesh)
            return (ll * wc).sum()

        partials.append(remat_region(body, hc, wk, consts=(tc, wc)) if remat
                        else body(hc, wk, tc, wc))
    total = torch.stack(partials).sum()
    if seq_mesh is not None:
        total = reduce_from_model(total, seq_mesh)
    return -total / torch.clamp(w.sum(), min=1.0)


def lm_loss_fn(
    model: torch.nn.Module,
    *,
    include_padding: bool = False,
    loss_chunk: Optional[int] = None,
    loss_chunk_unroll: bool = False,
    head_precision: Optional[str] = None,
) -> Callable[[Mapping[str, torch.Tensor], Mapping[str, torch.Tensor]], torch.Tensor]:
    """LM loss closure for any LM head of the port (GPT-2, NeoX, LLaMA).

    ``loss_chunk``: compute the vocab projection + CE in sequence chunks of
    this size (:func:`chunked_causal_lm_loss`, each chunk rematerialised)
    against the model's own ``output_kernel`` (GPT-2's tied ``wte``,
    NeoX's ``embed_out``, LLaMA's ``lm_head``); ``None`` = dense logits.
    ``loss_chunk_unroll`` and ``head_precision`` go to the chunked loss
    (the dense path ignores them, as in the JAX package).

    On the model axis (the config's ``model_parallel`` and/or
    ``seq_sharding``) ``params`` are this rank's: a vocab-parallel head
    gives vocab-parallel logits, and under ``seq_sharding`` every leaf that
    the rank holds whole enters the model through ``copy_to_model`` (each
    rank's tokens give part of its gradient; a leaf split over the axis
    sees every position) and the loss is the sum over the axis of the
    ranks' token losses over the whole batch's count (a vocab-split head
    gives every rank every position's logits and the whole loss).
    """
    cfg = getattr(model, "config", None)
    mp = getattr(cfg, "model_parallel", None)
    sp = getattr(cfg, "seq_sharding", None)
    seq_mesh = None if sp is None else sp.mesh
    whole = {} if sp is None else {n: p.shape for n, p in model.named_parameters()}

    def vocab_mesh(width: int):
        return mp if mp is not None and width < cfg.vocab_size else None

    def inputs(params):
        if seq_mesh is None:
            return params
        return {k: copy_to_model(p, seq_mesh) if p.shape == whole.get(k) else p
                for k, p in params.items()}

    def loss(params, batch):
        ids = batch["input_ids"]
        logits = functional_call(model, inputs(params), (ids,))
        return causal_lm_loss(
            logits, ids, batch.get("attention_mask"),
            include_padding=include_padding, vocab_mesh=vocab_mesh(logits.shape[-1]),
            seq_mesh=seq_mesh if logits.shape[1] < ids.shape[1] else None,
        )

    def loss_chunked(params, batch):
        params = inputs(params)
        hidden = functional_call(
            model, params, (batch["input_ids"],), {"return_hidden": True}
        )
        kernel = model.output_kernel(params)
        return chunked_causal_lm_loss(
            hidden, kernel, batch["input_ids"],
            batch.get("attention_mask"), chunk=loss_chunk,
            include_padding=include_padding, unroll=loss_chunk_unroll,
            head_precision=head_precision, vocab_mesh=vocab_mesh(kernel.shape[1]),
            seq_mesh=seq_mesh,
        )

    fn = loss_chunked if loss_chunk else loss
    # the outer precision scope sets the ambient TF32 flag from it
    fn.model_config = getattr(model, "config", None)
    return fn


def classification_loss_fn(model: torch.nn.Module) -> Callable[[Mapping, Mapping], torch.Tensor]:
    """Classifier CE closure on a ``{"image", "label"}`` batch (the spiral
    points, MNIST and CIFAR images alike)."""

    def loss(params, batch):
        logits = functional_call(model, params, (batch["image"],))
        return softmax_cross_entropy(logits, batch["label"])

    return loss


def classification_loss_fn_bn(
    model: torch.nn.Module, batch_stats: Mapping[str, torch.Tensor], *,
    bn_train_mode: bool = False,
) -> Callable[[Mapping, Mapping], torch.Tensor]:
    """CE closure for a BatchNorm model (ResNet-50).  ``bn_train_mode``:
    BatchNorm normalises with the batch's own statistics (an eval model with
    BN in train mode); else with ``batch_stats``, the stored ones.  Either
    way ``batch_stats`` are constants of the closure: never differentiated,
    never written."""

    def loss(params, batch):
        logits = functional_call(model, {**params, **batch_stats}, (batch["image"],),
                                 {"use_running_average": not bn_train_mode})
        return softmax_cross_entropy(logits, batch["label"])

    return loss


def per_example_lm_losses(model: torch.nn.Module, params: Mapping[str, torch.Tensor],
                          batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Per-sequence LM losses (B,): each sequence's mean next-token CE over
    its unmasked targets (all of them without ``attention_mask``), the
    reference's loss-per-batch evaluator."""
    ids = batch["input_ids"]
    logits = functional_call(model, params, (ids,))
    token_ll = token_log_likelihood(logits[:, :-1], ids[:, 1:])
    mask = batch.get("attention_mask")
    if mask is not None:
        m = mask[:, 1:].to(token_ll.dtype)
        return -(token_ll * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)
    return -token_ll.mean(-1)
