"""Causal self-attention core (port of ``models/attention.py``).

Written as explicit matmul -> masked softmax -> matmul so that it is twice
differentiable under ``torch.func`` (forward-over-reverse HVPs).  SDPA is
not used: it is a library kernel, and its fused backends have no second
derivative.  The mask fills with ``finfo(float32).min`` through
``torch.where`` as the JAX package does; ``-inf`` would give NaN in the
second derivative.

Two paths behind one function:

* ``block_q=None`` (or ``>= T``): dense (B, H, T, T) scores.
* ``block_q=N``: a loop over query blocks, each attending to all T keys
  under the causal mask.  The values equal the dense path's; the JAX
  package's per-block rematerialisation is not ported, so this path saves
  no memory under autodiff yet.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = torch.finfo(torch.float32).min


def _masked_softmax_attend(qb, k, v, mask, scale):
    att = torch.einsum("bqhd,bkhd->bhqk", qb, k).float() * scale
    att = torch.where(mask, att, _NEG_INF)
    att = torch.softmax(att, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", att, v)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_q: int | None = None,
) -> torch.Tensor:
    """Causal softmax attention.  q, k, v: (B, T, H, D) -> (B, T, H, D).

    A ``block_q`` that does not divide T is an error, as in the JAX
    package: silently running dense would defeat the memory plan the flag
    exists for.
    """
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    pos = torch.arange(T, device=q.device)
    if block_q is None or block_q >= T:
        mask = pos[:, None] >= pos[None, :]
        return _masked_softmax_attend(q, k, v, mask, scale)
    if T % block_q != 0:
        raise ValueError(
            f"attn block_q={block_q} does not divide seq_len={T}; pick a "
            "divisor (or >= seq_len for the dense single-block path)"
        )
    out = []
    for s in range(0, T, block_q):
        mask = pos[s : s + block_q, None] >= pos[None, :]
        out.append(_masked_softmax_attend(q[:, s : s + block_q], k, v, mask, scale))
    return torch.cat(out, dim=1)
