"""Thick-restart Lanczos (port of ``krylov/thick_restart.py``): converged
extremal eigenpairs with an (inner+1, P) basis buffer.

Each restart cycle runs Lanczos to ``inner`` vectors, keeps the best ``kk``
Ritz vectors, and restarts with them plus the last Lanczos vector (Wu &
Simon, SIAM J. Matrix Anal. 2000), until the wanted pairs meet a residual
tolerance.  Memory stays (m+1)·P whatever the number of restarts; the buffer
may be stored in bf16 while the recurrence runs in f32.  The (m, m)
projected matrix -- diag(θ) plus an arrowhead row and column after a
restart, tridiagonal in the new directions -- is solved on the host in
float64.

The CGS2 pass is the repo's rank-k apply with c = −1 on the filled rows
(``ops.spectral.project_out``), so on CUDA tensors it launches the
hand-written kernel pair.  α and β stay 0-d device tensors and are fetched
once per restart cycle; the breakdown test is the one host sync of an
inner iteration.

The JAX package has an unfused path (``_rotate_one`` row by row, scalars
fetched each iteration) and a fused one (one donating program per
iteration, ``_restart_rotate``).  In eager PyTorch both would launch the
same kernels, so the port has one loop and one in-place restart
(:func:`_restart_rotate`), whose peak is the buffer plus one (kk, P) f32
block, or for a bf16 buffer one (m+1, 4M) f32 chunk.

Under ``basis_sharding`` each rank of the mesh holds its range of P of
every buffer row (``krylov/sharded.py``): the matvec gets the whole vector,
gathered from the slices; α, the norms and the CGS2 coefficients are
all-reduced, so every rank takes the same branch and solves the same
projected matrix; the restart rotation is local, with f32 coefficients.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.krylov.sharded import PShard, p_shard
from hessian_llm_vision_tpu_torch.ops.spectral import project_out
from hessian_llm_vision_tpu_torch.utils.norms import norm

_EPS = 1e-30
# columns of P per f32 transient when the final Ritz rows are formed from a
# bf16 buffer: (m+1) x 4M x 4 bytes, 272 MB at m = 16
_ROTATE_CHUNK = 1 << 22


class ThickRestartResult(NamedTuple):
    """Converged-first wanted eigenpairs of the operator."""

    eigvals: np.ndarray  # (k,) wanted Ritz values, ascending
    # (k, P) f32 rows are the Ritz vectors, on the buffer's device; under
    # basis_sharding this rank's (k, width) block of their columns
    vectors: torch.Tensor
    residuals: np.ndarray  # (k,) |beta_m * S[m-1, i]| residual estimates
    restarts: int
    converged: bool
    matvecs: int


def _orth_body(Q: torch.Tensor, w: torch.Tensor, n_filled: int, sh: Optional[PShard] = None):
    """CGS2: orthogonalise f32 ``w`` against the first ``n_filled`` rows of
    the (m+1, P) buffer ``Q`` (f32 or bf16).  Returns ``(w, norm_after,
    norm_before)``; the ratio of the two norms is the breakdown test (an
    absolute threshold never fires in f32, where roundoff keeps ‖w‖ near
    1e-7·‖A q‖).

    Each pass is ``project_out(w, Q[:n_filled])``, the rank-k apply with
    c = −1.  ``Q[:n_filled]`` is a contiguous view, so only the filled rows
    are read; JAX's masked full buffer gives the same sums.  On CUDA that is
    the kernel pair, which streams the rows in their storage dtype and keeps
    w and the coefficients in f32: no (m+1, P) f32 copy of a bf16 buffer,
    and more exact than the JAX package, which rounds w and the
    coefficients to bf16 for a bf16 buffer.  On the CPU it is the plain
    version, which for a bf16 buffer rounds exactly as JAX does.  With a
    :class:`~hessian_llm_vision_tpu_torch.krylov.sharded.PShard` ``sh``,
    ``w`` and ``Q`` are this rank's slices and each pass is the pair on
    the slice around an all-reduce of ``w`` (the kernels' arithmetic on
    the CPU too)."""
    norm_of, project = (norm, project_out) if sh is None else (sh.norm, sh.project_out)
    nrm0 = norm_of(w)
    rows = Q[:n_filled]
    for _ in range(2):
        w = project(w, rows)
    return w, norm_of(w), nrm0


def _set_row(Q: torch.Tensor, i: int, v: torch.Tensor) -> None:
    """Row ``i`` of the buffer <- ``v`` in the storage dtype, in place."""
    Q[i].copy_(v)


def _rotate(Q: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """``Sᵀ Q``: the (k, P) f32 Ritz rows for f32 coefficients ``S`` of
    shape (m+1, k).  A bf16 buffer is upcast one P-chunk at a time, so no
    (m+1, P) f32 copy is made."""
    if Q.dtype == torch.float32:
        return S.T @ Q
    out = torch.empty((S.shape[1], Q.shape[1]), dtype=torch.float32, device=Q.device)
    for c0 in range(0, Q.shape[1], _ROTATE_CHUNK):
        out[:, c0:c0 + _ROTATE_CHUNK] = S.T @ Q[:, c0:c0 + _ROTATE_CHUNK].float()
    return out


def _restart_rotate(Q: torch.Tensor, S_pad: torch.Tensor) -> None:
    """The thick restart of the buffer, in place: rows 0..kk-1 <- ``S_padᵀ
    Q``, row kk <- the old row m (the (m+1)-th Lanczos vector), the rest
    zero.  A bf16 buffer is rotated one P-chunk at a time with f32
    coefficients and sums (:func:`_rotate`'s transient) and rounded once,
    to storage.  The JAX package rounds the coefficients to bf16 as well,
    which moves every restarted row by up to 2^-9 of each term and left
    GPT-2 124M's Ritz rows 4-5e-3 from orthonormal (chip_smoke.py 8a)."""
    kk = S_pad.shape[1]
    if Q.dtype == torch.float32:
        Q[:kk].copy_(S_pad.T @ Q)
    else:
        for c0 in range(0, Q.shape[1], _ROTATE_CHUNK):
            cols = slice(c0, c0 + _ROTATE_CHUNK)
            Q[:kk, cols] = S_pad.T @ Q[:, cols].float()
    Q[kk].copy_(Q[-1])
    Q[kk + 1:].zero_()


def _select(theta: np.ndarray, k: int, which: str) -> np.ndarray:
    """Indices of the k wanted Ritz values (into ascending-sorted theta)."""
    order = np.argsort(theta)
    if which == "la":
        return order[-k:]
    if which == "sa":
        return order[:k]
    if which == "both":
        lo = k // 2
        return np.concatenate([order[: k - lo], order[-lo:]]) if lo else order[:k]
    if which == "lm":
        return np.argsort(np.abs(theta))[-k:]
    raise ValueError(f"which={which!r}: use la | sa | lm | both")


def lanczos_thick_restart(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    v0: Optional[torch.Tensor] = None,
    inner: Optional[int] = None,
    max_restarts: int = 100,
    tol: float = 1e-6,
    which: str = "lm",
    store_dtype: torch.dtype = torch.float32,
    basis_sharding=None,
    progress: bool = False,
    device: Optional[torch.device] = None,
) -> ThickRestartResult:
    """Converged k extremal eigenpairs with an (inner+1, P) basis buffer.

    ``which``: "lm" largest |λ| (default), "la"/"sa" the algebraic ends,
    "both" k split across both ends.  Converged when |β_m S[m-1,i]| ≤ tol ·
    max|θ| for every wanted pair.  Exactly one of ``v0`` and ``generator``
    gives the start vector: ``v0`` on its device, or a Gaussian draw from
    the CPU ``generator`` copied to ``device`` (default the CPU).

    A breakdown (‖w‖ after CGS2 at most 1e-5 of before: an invariant
    subspace) zeroes the coupling and continues in a fresh Gaussian
    direction drawn from ``generator`` (a CPU generator seeded 0 when
    ``v0`` was given), so its draws differ from the JAX package's
    ``rng_key`` ones.  ``basis_sharding`` (``parallel.mesh.basis_sharding``):
    every rank of the mesh calls this with the same operator and start,
    stores its range of P of the (m+1, P) buffer, and gets ``vectors`` as
    its block of columns (``krylov/sharded.py``); the eigenvalues,
    residuals and counts are the same on every rank.
    """
    if (v0 is None) == (generator is None):
        raise ValueError("pass exactly one of v0 / generator")
    if max_restarts < 1:
        raise ValueError("max_restarts must be >= 1")
    m = inner if inner is not None else min(dim, max(2 * k + 2, k + 12))
    if not (k + 4 <= m <= dim):
        # m - kk new Krylov directions per restart; with fewer than ~3 the
        # method stalls and burns max_restarts
        raise ValueError(f"need inner >= k+4 and inner <= dim, got k={k} inner={m} dim={dim}")
    kk = min(k + max(3, k // 2), m - 3)  # thick-keep count (>= k+1)

    if v0 is None:
        v0 = torch.randn(dim, generator=generator).to(device or "cpu")
    redirect = generator if generator is not None else torch.Generator().manual_seed(0)
    sh = p_shard(basis_sharding, dim)
    q = v0.float()
    q = q / torch.clamp(norm(q), min=_EPS) if sh is None else sh.start(q)

    Q = torch.zeros((m + 1, q.shape[0]), dtype=store_dtype, device=q.device)
    _set_row(Q, 0, q)
    del q
    theta = np.zeros((0,), np.float64)  # retained Ritz values
    s = np.zeros((0,), np.float64)  # arrowhead couplings
    n_ret = 0  # retained rows at cycle start
    n_mv = 0

    for restart in range(max_restarts):
        B = np.zeros((m, m), np.float64)
        B[:n_ret, :n_ret] = np.diag(theta)
        B[:n_ret, n_ret] = s
        B[n_ret, :n_ret] = s
        alphas, betas = [], []
        for j in range(n_ret, m):
            qj = Q[j].float()
            if sh is None:
                w = matvec(qj).float()
                alphas.append(torch.dot(qj, w))
            else:
                w = sh.local(matvec(sh.gather(qj)).float())
                alphas.append(sh.dot(qj, w))
            n_mv += 1
            w, nrm, nrm0 = _orth_body(Q, w, j + 1, sh)
            if bool(nrm <= 1e-5 * torch.clamp(nrm0, min=1e-30)):  # the iteration's host sync
                # invariant subspace (what remains of A q is f32 roundoff):
                # zero the coupling, continue in a fresh direction
                fresh = torch.randn(dim, generator=redirect).to(Q.device)
                if sh is not None:
                    fresh = sh.local(fresh)
                w, nrm, _ = _orth_body(Q, fresh, j + 1, sh)
                betas.append(torch.zeros_like(nrm))
            else:
                betas.append(nrm)
            _set_row(Q, j + 1, w / torch.clamp(nrm, min=_EPS))
        ab = torch.stack([torch.stack(alphas), torch.stack(betas)]).double().cpu().numpy()
        for j in range(n_ret, m):
            B[j, j] = ab[0, j - n_ret]
            if j < m - 1:
                B[j, j + 1] = B[j + 1, j] = ab[1, j - n_ret]
        beta = float(ab[1, -1])

        evals, S = np.linalg.eigh(B)  # ascending
        resid = np.abs(beta * S[m - 1, :])
        wanted = _select(evals, k, which)
        scale = max(np.abs(evals).max(), 1e-30)
        done = bool((resid[wanted] <= tol * scale).all())
        if progress:
            print(f"[trlan] restart {restart}: wanted "
                  f"[{evals[wanted].min():.6g}, {evals[wanted].max():.6g}] "
                  f"max resid {resid[wanted].max():.2e}", flush=True)
        if done or restart == max_restarts - 1:
            order = wanted[np.argsort(evals[wanted])]
            S_out = np.zeros((m + 1, len(order)), np.float64)
            S_out[:m] = S[:, order]  # zero row m: the whole buffer, no slice copy
            V = _rotate(Q, torch.as_tensor(S_out, dtype=torch.float32, device=Q.device))
            if sh is not None:
                V = sh.trim(V)
            return ThickRestartResult(eigvals=evals[order], vectors=V, residuals=resid[order],
                                      restarts=restart + 1, converged=done, matvecs=n_mv)

        # thick restart: keep the kk best Ritz pairs by the same criterion
        keep = _select(evals, kk, which)
        S_pad = np.zeros((m + 1, kk), np.float64)
        S_pad[:m] = S[:, keep]
        _restart_rotate(Q, torch.as_tensor(S_pad, dtype=torch.float32, device=Q.device))
        theta = evals[keep]
        s = beta * S[m - 1, keep]
        n_ret = kk
