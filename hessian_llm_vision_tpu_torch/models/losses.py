"""Loss closures binding models to the curvature / training APIs
(port of ``models/losses.py``).

Everything downstream consumes ``loss_fn(params, batch) -> scalar mean
loss`` where ``params`` is a ``{name: tensor}`` dict and ``batch`` a dict
with ``input_ids`` (B, T) and optional ``attention_mask``.  The model is
evaluated with ``torch.func.functional_call``, so the same closure serves
``torch.func.grad`` and forward-over-reverse HVPs.

``include_padding=True`` is the reference / HF ``labels=input_ids``
convention (mean over all B*(T-1) targets, pads included); the default
masks pad targets through ``attention_mask``.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch, integer labels."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).squeeze(-1).mean()


def _token_log_likelihood(logits, targets):
    logp = F.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, targets[..., None]).squeeze(-1)


def causal_lm_loss(
    logits: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    include_padding: bool = False,
) -> torch.Tensor:
    """Shifted next-token CE: mean over unmasked targets (default) or over
    all targets (``include_padding=True``)."""
    token_ll = _token_log_likelihood(logits[:, :-1], input_ids[:, 1:])
    if attention_mask is not None and not include_padding:
        mask = attention_mask[:, 1:].float()
        return -(token_ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return -token_ll.mean()


def chunked_causal_lm_loss(
    hidden: torch.Tensor,
    out_kernel: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    include_padding: bool = False,
) -> torch.Tensor:
    """Shifted next-token CE computed over sequence chunks of the vocab
    projection, never forming the whole (B, T, V) logits at once.

    ``hidden`` (B, T, C) are the final pre-logit states, ``out_kernel``
    (C, V) the output projection.  Equal to :func:`causal_lm_loss` on the
    dense logits.  The JAX package's per-chunk rematerialisation is not
    ported: under autodiff each chunk's logits stay live.
    """
    B, T, _ = hidden.shape
    h = hidden[:, :-1].float()
    targets = input_ids[:, 1:]
    if attention_mask is not None and not include_padding:
        w = attention_mask[:, 1:].float()
    else:
        w = torch.ones(B, T - 1, device=hidden.device)
    wk = out_kernel.float()
    partials = []
    for s in range(0, T - 1, chunk):
        ll = _token_log_likelihood(h[:, s : s + chunk] @ wk, targets[:, s : s + chunk])
        partials.append((ll * w[:, s : s + chunk]).sum())
    return -torch.stack(partials).sum() / torch.clamp(w.sum(), min=1.0)


def lm_loss_fn(
    model: torch.nn.Module,
    *,
    include_padding: bool = False,
    loss_chunk: Optional[int] = None,
) -> Callable[[Mapping[str, torch.Tensor], Mapping[str, torch.Tensor]], torch.Tensor]:
    """LM loss closure for :class:`~.gpt2.GPT2LMHead`.

    ``loss_chunk``: compute the vocab projection + CE in sequence chunks of
    this size (:func:`chunked_causal_lm_loss`); ``None`` = dense logits.
    """

    def loss(params, batch):
        logits = functional_call(model, params, (batch["input_ids"],))
        return causal_lm_loss(
            logits, batch["input_ids"], batch.get("attention_mask"),
            include_padding=include_padding,
        )

    def loss_chunked(params, batch):
        hidden = functional_call(
            model, params, (batch["input_ids"],), {"return_hidden": True}
        )
        return chunked_causal_lm_loss(
            hidden, model.output_kernel(params), batch["input_ids"],
            batch.get("attention_mask"), chunk=loss_chunk,
            include_padding=include_padding,
        )

    return loss_chunked if loss_chunk else loss
