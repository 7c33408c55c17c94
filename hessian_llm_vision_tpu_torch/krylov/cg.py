"""Conjugate-gradient solves for SPD curvature operators (port of
``krylov/cg.py``).

They power the Gauss-Newton and natural-gradient steps
(``optim/second_order.py``).  The JAX package's ``lax.while_loop`` is a
Python loop here with the same exit test, ``sqrt(rs)/‖b‖ > tol and
i < max_iters``, and the same 1e-30 floors; the test reads one scalar from
the device per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from hessian_llm_vision_tpu_torch.utils.norms import norm

_FLOOR = 1e-30


class CGResult(NamedTuple):
    """``x`` (P,) f32; ``num_iters`` the iterations run; ``residual_norm``
    a 0-d tensor, the recurrence's ``‖r‖``."""

    x: torch.Tensor
    num_iters: int
    residual_norm: torch.Tensor


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-3,
    max_iters: int = 20,
) -> CGResult:
    """Solve ``A x = b`` for SPD matrix-free ``A`` (damp an indefinite
    Hessian first, e.g. ``LinearOperator.shifted``).  Without ``x0`` the
    start is zero and the first residual is ``b`` itself, so no matvec is
    spent on ``A·0``."""
    b = b.float()
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.float()
        r = b - matvec(x).float()
    p = r
    rs = torch.dot(r, r)
    b_norm = torch.clamp(norm(b), min=_FLOOR)
    i = 0
    while i < max_iters and float(torch.sqrt(rs) / b_norm) > tol:
        ap = matvec(p).float()
        alpha = rs / torch.clamp(torch.dot(p, ap), min=_FLOOR)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=_FLOOR)) * p
        rs = rs_new
        i += 1
    return CGResult(x=x, num_iters=i, residual_norm=torch.sqrt(rs))
