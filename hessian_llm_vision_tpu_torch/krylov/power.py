"""Power iteration for the extremal eigenpair (port of ``krylov/power.py``).

Converges to the eigenvalue of largest |λ|; for the largest *algebraic*
eigenvalue of an indefinite Hessian use a shifted operator.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from hessian_llm_vision_tpu_torch.krylov.lanczos import start_vector
from hessian_llm_vision_tpu_torch.utils.norms import norm


def power_iteration(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    num_iters: int = 100,
    *,
    generator: Optional[torch.Generator] = None,
    v0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(rayleigh_quotient, eigvec)`` after ``num_iters``
    iterations.  The start is a Gaussian draw from ``generator`` on its
    device, or ``v0`` (e.g. another package's draw); exactly one of the
    two."""
    v = start_vector(v0, generator, dim)
    for _ in range(num_iters):
        w = matvec(v).float()
        v = w / torch.clamp(norm(w), min=1e-30)
    lam = torch.dot(v, matvec(v).float())
    return lam, v
