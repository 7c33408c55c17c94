"""Causal self-attention core (port of ``models/attention.py``).

Written as explicit matmul -> masked softmax -> matmul so that it is twice
differentiable under ``torch.func`` (forward-over-reverse HVPs); both
matmuls run at the innermost precision scope (``models/precision.py``).  SDPA is
not used: it is a library kernel, and its fused backends have no second
derivative.  The mask fills with ``finfo(float32).min`` through
``torch.where`` as the JAX package does; ``-inf`` would give NaN in the
second derivative.

Two paths behind one function:

* ``block_q=None`` (or ``>= T``): dense (B, H, T, T) scores.
* ``block_q=N``: a loop over query blocks, each attending to all T keys
  under the causal mask.  The values equal the dense path's.  With
  ``remat`` (the default, as in the JAX package) each block's scores,
  mask, softmax and product with V run as one rematerialised region
  (``utils/remat.py``) that saves only its query block, K and V: under
  ``grad`` and ``jvp(grad(.))`` no (B, H, block, T) tile outlives its
  block, where the loop without remat keeps every block's.  K and V are
  the same tensors for every block, saved once by storage.  ``unroll``
  (the JAX scan's) changes nothing in eager PyTorch, whose loop is always
  unrolled; the values are identical either way.

``q_offset``: the queries are positions ``[q_offset, q_offset + Tq)`` of
the keys' ``[0, Tk)``, as on a rank of a sequence-parallel model, whose
queries are its slice of T and whose keys and values are gathered whole.
"""

from __future__ import annotations

import math

import torch

from hessian_llm_vision_tpu_torch.models import precision
from hessian_llm_vision_tpu_torch.models.losses import at_least_f32
from hessian_llm_vision_tpu_torch.utils.remat import remat as rematerialised

_NEG_INF = torch.finfo(torch.float32).min


def _masked_softmax_attend(qb, k, v, mask, scale):
    att = at_least_f32(precision.einsum("bqhd,bkhd->bhqk", qb, k)) * scale
    att = torch.where(mask, att, _NEG_INF)
    att = torch.softmax(att, dim=-1).to(v.dtype)
    return precision.einsum("bhqk,bkhd->bqhd", att, v)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_q: int | None = None,
    remat: bool = True,
    unroll: bool = False,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal softmax attention.  q (B, Tq, H, D), k and v (B, Tk, H, D)
    -> (B, Tq, H, D); Tq = Tk unless ``q_offset`` places the queries.

    A ``block_q`` that does not divide Tq is an error, as in the JAX
    package: silently running dense would defeat the memory plan the flag
    exists for.
    """
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    pos = torch.arange(T, device=q.device) + q_offset
    keys = torch.arange(k.shape[1], device=q.device)
    if block_q is None or block_q >= T:
        mask = pos[:, None] >= keys[None, :]
        return _masked_softmax_attend(q, k, v, mask, scale)
    if T % block_q != 0:
        raise ValueError(
            f"attn block_q={block_q} does not divide seq_len={T}; pick a "
            "divisor (or >= seq_len for the dense single-block path)"
        )
    out = []
    for s in range(0, T, block_q):
        mask = pos[s : s + block_q, None] >= keys[None, :]

        def body(qb, k, v, mask):
            return _masked_softmax_attend(qb, k, v, mask, scale)

        qb = q[:, s : s + block_q]
        out.append(rematerialised(body, qb, k, v, consts=(mask,)) if remat
                   else body(qb, k, v, mask))
    return torch.cat(out, dim=1)
