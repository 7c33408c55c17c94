"""Lanczos tridiagonalization (port of ``krylov/lanczos.py``).

One implementation with explicit switches:

* ``reorth=True``  -- full CGS2 reorthogonalization against the stored
  basis every iteration (required for trustworthy Ritz values);
* ``store_basis=False`` -- T-only memory-light mode (implies no reorth).

The recurrence runs in f32 whatever the model dtype.  PyTorch runs
eagerly, so the loop is a plain Python loop; the CGS2 products are
``torch.matmul``, as the JAX package leaves them to XLA outside any kernel.
Grad-seeding is simply ``v0=grad``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

_EPS = 1e-30


class LanczosResult(NamedTuple):
    """``alphas`` (m,) diagonal, ``betas`` (m-1,) off-diagonal of T;
    ``basis`` (m, P) rows are the Krylov vectors (None in T-only mode)."""

    alphas: torch.Tensor
    betas: torch.Tensor
    basis: Optional[torch.Tensor]

    def tridiag(self) -> torch.Tensor:
        """Dense (m, m) tridiagonal T."""
        return (
            torch.diag(self.alphas)
            + torch.diag(self.betas, 1)
            + torch.diag(self.betas, -1)
        )


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v), min=_EPS)


def host_recurrence_step(w, q_cur, q_prev, beta_prev):
    """One Lanczos three-term update; returns ``(alpha, beta, q_next)`` with
    ``alpha`` and ``beta`` as 0-d f32 tensors on the vectors' device."""
    w = w.float()
    alpha = torch.dot(q_cur, w)
    w = w - alpha * q_cur - beta_prev * q_prev
    beta = torch.linalg.vector_norm(w)
    return alpha, beta, w / torch.clamp(beta, min=_EPS)


def lanczos(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    num_iters: int,
    *,
    v0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    reorth: bool = True,
    store_basis: bool = True,
) -> LanczosResult:
    """Run ``num_iters`` Lanczos iterations on the symmetric operator.

    Exactly one of ``v0`` (explicit start vector, e.g. the gradient) or
    ``generator`` (seeded random unit start on the generator's device)
    must be given.
    """
    if (v0 is None) == (generator is None):
        raise ValueError("pass exactly one of v0 / generator")
    if reorth and not store_basis:
        raise ValueError("reorth=True requires store_basis=True")
    if v0 is None:
        v0 = torch.randn(dim, generator=generator, device=generator.device)
    q_cur = _normalize(v0.float())
    q_prev = torch.zeros_like(q_cur)
    beta_prev = torch.zeros((), dtype=torch.float32, device=q_cur.device)
    basis = None
    if store_basis:
        basis = torch.zeros((num_iters, dim), dtype=torch.float32, device=q_cur.device)
    alphas, betas = [], []
    for i in range(num_iters):
        if basis is not None:
            basis[i] = q_cur
        w = matvec(q_cur).float()
        alpha = torch.dot(q_cur, w)
        w = w - alpha * q_cur - beta_prev * q_prev
        if reorth:
            # classical Gram-Schmidt, twice (CGS2) against rows 0..i
            Q = basis[: i + 1]
            w = w - Q.T @ (Q @ w)
            w = w - Q.T @ (Q @ w)
        beta = torch.linalg.vector_norm(w)
        q_prev, q_cur = q_cur, w / torch.clamp(beta, min=_EPS)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    return LanczosResult(
        alphas=torch.stack(alphas), betas=torch.stack(betas)[:-1], basis=basis
    )
