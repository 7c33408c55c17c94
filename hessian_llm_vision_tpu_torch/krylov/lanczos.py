"""Lanczos tridiagonalization (port of ``krylov/lanczos.py``).

One implementation with explicit switches:

* ``reorth=True``  -- full CGS2 reorthogonalization against the stored
  basis every iteration (required for trustworthy Ritz values);
* ``store_basis=False`` -- T-only memory-light mode (implies no reorth);
* ``basis_sharding`` -- the basis split along P over the ranks of a mesh
  (``krylov/sharded.py``): each rank stores its columns of every row, and
  the CGS2 pass is the rank-k pair on the slice around one all-reduce.

The recurrence runs in f32 whatever the model dtype.  PyTorch runs
eagerly, so the loop is a plain Python loop; the CGS2 products are
``torch.matmul``, as the JAX package leaves them to XLA outside any kernel.
Grad-seeding is simply ``v0=grad``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.krylov.sharded import PShard, normalize, p_shard
from hessian_llm_vision_tpu_torch.obs.timing import span
from hessian_llm_vision_tpu_torch.utils.norms import norm

_EPS = 1e-30
#: a Lanczos iteration's two spans: the operator call with its argument
#: casts, and the rest of the iteration up to any callback
MATVEC_SPAN = span("lanczos.matvec")
UPDATE_SPAN = span("lanczos.update")


class LanczosResult(NamedTuple):
    """``alphas`` (m,) diagonal, ``betas`` (m-1,) off-diagonal of T;
    ``basis`` (m, P) rows are the Krylov vectors (None in T-only mode)."""

    alphas: torch.Tensor
    betas: torch.Tensor
    basis: Optional[torch.Tensor]

    @property
    def num_iters(self) -> int:
        return self.alphas.shape[0]

    def tridiag(self) -> torch.Tensor:
        """Dense (m, m) tridiagonal T."""
        return (
            torch.diag(self.alphas)
            + torch.diag(self.betas, 1)
            + torch.diag(self.betas, -1)
        )


def raw_start(v0: Optional[torch.Tensor], generator: Optional[torch.Generator],
              dim: int) -> torch.Tensor:
    """The f32 start direction, not normalised: ``v0``, or a Gaussian draw
    from ``generator`` on its device; exactly one of the two must be given.
    A sharded run normalises it over the ranks (``PShard.start``)."""
    if (v0 is None) == (generator is None):
        raise ValueError("pass exactly one of v0 / generator")
    if v0 is None:
        v0 = torch.randn(dim, generator=generator, device=generator.device)
    return v0.float()


def start_vector(v0: Optional[torch.Tensor], generator: Optional[torch.Generator],
                 dim: int) -> torch.Tensor:
    """The unit f32 start vector: ``v0`` normalised, or a Gaussian draw from
    ``generator`` on its device; exactly one of the two must be given."""
    return normalize(raw_start(v0, generator, dim))


def host_recurrence_step(w, q_cur, q_prev, beta_prev, sh=None):
    """One Lanczos three-term update; returns ``(alpha, beta, q_next)`` with
    ``alpha`` and ``beta`` as 0-d f32 tensors on the vectors' device.
    ``sh`` (``krylov/sharded.py``): the vectors are this rank's parts, and
    the dot product and norm sum over the ranks."""
    w = w.float()
    alpha = torch.dot(q_cur, w) if sh is None else sh.dot(q_cur, w)
    w = w - alpha * q_cur - beta_prev * q_prev
    beta = norm(w) if sh is None else sh.norm(w)
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
    basis_sharding=None,
) -> LanczosResult:
    """Run ``num_iters`` Lanczos iterations on the symmetric operator.

    Exactly one of ``v0`` (explicit start vector, e.g. the gradient) or
    ``generator`` (seeded random unit start on the generator's device)
    must be given.  ``basis_sharding`` (``parallel.mesh.basis_sharding``):
    every rank of the mesh calls this with the same operator and start
    vector, stores only its range of P, and gets back ``basis`` as its
    (m, width) block of columns (``krylov/sharded.py``; gather the rows
    with ``PShard.gather``); T is the same on every rank.
    """
    if reorth and not store_basis:
        raise ValueError("reorth=True requires store_basis=True")
    if basis_sharding is not None:
        return _lanczos_sharded(matvec, p_shard(basis_sharding, dim), num_iters,
                                raw_start(v0, generator, dim), reorth, store_basis)
    q_cur = start_vector(v0, generator, dim)
    q_prev = torch.zeros_like(q_cur)
    beta_prev = torch.zeros((), dtype=torch.float32, device=q_cur.device)
    basis = None
    if store_basis:
        basis = torch.zeros((num_iters, dim), dtype=torch.float32, device=q_cur.device)
    alphas, betas = [], []
    for i in range(num_iters):
        with MATVEC_SPAN:
            w = matvec(q_cur).float()
        with UPDATE_SPAN:
            if basis is not None:
                basis[i] = q_cur
            alpha = torch.dot(q_cur, w)
            w = w - alpha * q_cur - beta_prev * q_prev
            if reorth:
                # classical Gram-Schmidt, twice (CGS2) against rows 0..i
                Q = basis[: i + 1]
                w = w - Q.T @ (Q @ w)
                w = w - Q.T @ (Q @ w)
            beta = norm(w)
            q_prev, q_cur = q_cur, w / torch.clamp(beta, min=_EPS)
            beta_prev = beta
            alphas.append(alpha)
            betas.append(beta)
    return LanczosResult(
        alphas=torch.stack(alphas), betas=torch.stack(betas)[:-1], basis=basis
    )


def _lanczos_sharded(matvec, sh: PShard, num_iters: int, q_full: torch.Tensor,
                     reorth: bool, store_basis: bool) -> LanczosResult:
    """:func:`lanczos` with the basis split along P: the operator takes the
    whole vector (gathered from the slices) and each rank keeps its range
    of the result; α, β and the CGS2 coefficients are sums over the ranks."""
    q_cur = sh.start(q_full)
    del q_full
    q_prev = torch.zeros_like(q_cur)
    beta_prev = torch.zeros((), dtype=torch.float32, device=q_cur.device)
    basis = None
    if store_basis:
        basis = torch.zeros((num_iters, sh.size), dtype=torch.float32, device=q_cur.device)
    alphas, betas = [], []
    for i in range(num_iters):
        with MATVEC_SPAN:
            w = sh.local(matvec(sh.gather(q_cur)).float())
        with UPDATE_SPAN:
            if basis is not None:
                basis[i] = q_cur
            alpha = sh.dot(q_cur, w)
            w = w - alpha * q_cur - beta_prev * q_prev
            if reorth:
                for _ in range(2):  # CGS2 against rows 0..i
                    w = sh.project_out(w, basis[: i + 1])
            beta = sh.norm(w)
            q_prev, q_cur = q_cur, w / torch.clamp(beta, min=_EPS)
            beta_prev = beta
            alphas.append(alpha)
            betas.append(beta)
    return LanczosResult(alphas=torch.stack(alphas), betas=torch.stack(betas)[:-1],
                         basis=None if basis is None else sh.trim(basis))


def stack_tridiag(alphas: list, betas: list) -> tuple[torch.Tensor, torch.Tensor]:
    """Lists of 0-d device scalars -> ``(alphas (m,), betas (m-1,))`` f32;
    the last beta (the norm of the residual after the last step) is not
    part of T."""
    a = torch.stack(alphas).float()
    b = torch.stack(betas[:-1]).float() if len(betas) > 1 else a.new_zeros(0)
    return a, b


def lanczos_checkpointed(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    num_iters: int,
    *,
    v0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    callback: Optional[Callable[[int, np.ndarray, np.ndarray], None]] = None,
    state_callback: Optional[Callable[[int, dict], None]] = None,
    resume_state: Optional[dict] = None,
    device: Optional[torch.device] = None,
) -> LanczosResult:
    """Host-driven T-only Lanczos with per-iteration callbacks, resumable.

    ``callback(i, alphas, betas)`` receives host (numpy) copies of T so far;
    ``state_callback(i, state)`` receives the full recurrence state
    (``q_prev``, ``q_cur``, ``beta_prev``, ``alphas``, ``betas``) that
    ``io.spectra.save_lanczos_state`` writes.  ``resume_state`` (as
    ``io.spectra.load_lanczos_state`` reads it) continues an interrupted run
    exactly where it stopped, with its vectors placed on ``device`` (the
    CPU when None); otherwise exactly one of ``v0`` / ``generator`` starts
    it.
    """
    if resume_state is None:
        q_cur = start_vector(v0, generator, dim)
        q_prev = torch.zeros_like(q_cur)
        beta_prev = torch.zeros((), dtype=torch.float32, device=q_cur.device)
        alphas, betas = [], []
    else:
        as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        q_cur = as_f32(resume_state["q_cur"])
        q_prev = as_f32(resume_state["q_prev"])
        beta_prev = as_f32(resume_state["beta_prev"])
        alphas = [as_f32(a) for a in resume_state["alphas"]]
        betas = [as_f32(b) for b in resume_state["betas"]]
    for i in range(len(alphas), num_iters):
        with MATVEC_SPAN:
            w = matvec(q_cur)
        with UPDATE_SPAN:
            alpha, beta, q_next = host_recurrence_step(w, q_cur, q_prev, beta_prev)
            del w
            q_prev, q_cur, beta_prev = q_cur, q_next, beta
            alphas.append(alpha)
            betas.append(beta)
        if callback is not None:
            a, b = stack_tridiag(alphas, betas)
            callback(i, a.cpu().numpy(), b.cpu().numpy())
        if state_callback is not None:
            state_callback(i, {"q_prev": q_prev, "q_cur": q_cur, "beta_prev": beta_prev,
                               "alphas": alphas, "betas": betas})
    alphas, betas = stack_tridiag(alphas, betas)
    return LanczosResult(alphas=alphas, betas=betas, basis=None)
