"""Deflated spectral density (port of ``krylov/deflate.py``): exact
extremal eigenpairs plus a stochastic density of the bulk.

1. ``lanczos_thick_restart`` computes the ``k`` largest-|λ| eigenpairs to
   a residual tolerance: exact spikes with certificates;
2. KPM then runs on the deflated operator ``(I−UUᵀ) A (I−UUᵀ)``, whose
   spectral support is the bulk only, so the Chebyshev rescaling maps the
   bulk, and not the whole range, onto [-1, 1] (Lin, Saad & Yang, SIAM
   Rev. 2016, §4.2).

The projector is ``ops.spectral.project_out``, the rank-k apply with
c = −1: on CUDA tensors the hand-written kernel pair, which streams a bf16
basis at half the bytes of an f32 one.  Under ``basis_sharding`` the
deflation basis stays split along P as thick restart left it, and the
projector is the pair on each rank's slice around an all-reduce of its
k-vector (``krylov/sharded.py``); KPM's vectors are whole on every rank.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.krylov.kpm import KPMDensity, kpm_density
from hessian_llm_vision_tpu_torch.krylov.sharded import p_shard
from hessian_llm_vision_tpu_torch.krylov.thick_restart import lanczos_thick_restart
from hessian_llm_vision_tpu_torch.ops.spectral import project_out


def deflated_matvec(
    matvec: Callable[[torch.Tensor], torch.Tensor], basis: torch.Tensor,
    basis_sharding=None, dim: Optional[int] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Matvec of ``(I−UUᵀ) A (I−UUᵀ)``: two rank-k applies around one
    matvec.  ``basis`` rows are orthonormal (Ritz vectors are); the deflated
    operator keeps A's spectrum on span(U)^⊥ and moves the k deflated
    eigenvalues to 0.  With ``basis_sharding``, ``basis`` is this rank's
    block of columns of the (k, ``dim``) basis: each projection runs on the
    slice and the whole vector is gathered again."""
    if basis_sharding is None:
        def mv(v: torch.Tensor) -> torch.Tensor:
            return project_out(matvec(project_out(v, basis)), basis)

        return mv
    sh = p_shard(basis_sharding, dim)

    def project(v: torch.Tensor) -> torch.Tensor:
        return sh.gather(sh.project_out(sh.part(v.float()), basis))

    def mv_sharded(v: torch.Tensor) -> torch.Tensor:
        return project(matvec(project(v)))

    return mv_sharded


class DeflatedDensity(NamedTuple):
    """Exact spikes + KPM bulk of the deflated operator.

    The combined density is ``ρ(λ) = (1/P) Σᵢ δ(λ−λᵢ) + ρ_bulk(λ)`` minus a
    k/P mass at 0, where the deflated directions land (k/P ≈ 4e-8 at 124M).
    """

    eigvals: np.ndarray  # (k,) deflated eigenvalues, ascending
    residuals: np.ndarray  # (k,) thick-restart residual certificates
    converged: bool
    bulk: KPMDensity  # KPM density of the deflated operator
    dim: int
    matvecs: int  # A applications in all (thick restart + KPM)

    def density(self, grid: np.ndarray) -> np.ndarray:
        """Bulk density on ``grid``; the spikes are ``eigvals``."""
        return self.bulk.density(grid)

    def trace_estimate(self, dim: Optional[int] = None) -> float:
        """``E[λ] = tr(A)/P``: the spikes' share plus the bulk estimate
        (the k zeros of the deflated operator add 0); with ``dim``, tr(A)."""
        est = float(np.sum(self.eigvals)) / self.dim + self.bulk.trace_estimate()
        return est * dim if dim is not None else est


def deflated_density(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    num_deflate: int,
    num_moments: int,
    generator: Optional[torch.Generator] = None,
    *,
    v0: Optional[torch.Tensor] = None,
    num_probes: int = 1,
    probes: Optional[torch.Tensor] = None,
    inner: Optional[int] = None,
    tol: float = 1e-6,
    store_dtype: torch.dtype = torch.float32,
    deflate_dtype: Optional[torch.dtype] = None,
    lmin: Optional[float] = None,
    lmax: Optional[float] = None,
    basis_sharding=None,
    progress: bool = False,
    device: Optional[torch.device] = None,
) -> DeflatedDensity:
    """Two-scale density: thick-restart the ``num_deflate`` largest-|λ|
    pairs, then KPM with ``num_moments`` moments on the deflated operator.

    Draws from the CPU ``generator``, in order: the thick restart's start
    vector (unless ``v0`` is given), the bulk range's start vector (unless
    ``lmin``/``lmax`` bound the deflated spectrum), the KPM probes (unless
    ``probes`` are given); each is copied to ``device`` (default the CPU).
    ``inner``/``tol``/``store_dtype`` pass to ``lanczos_thick_restart``.
    ``deflate_dtype`` stores the deflation basis itself in another dtype
    (bf16 halves its memory and the projector's bytes; the ~1e-3 leakage
    puts at most ~1e-3·|λ| of outlier weight back into the bulk, inside
    KPM's Jackson broadening).  ``basis_sharding``: every rank of the mesh
    calls this with the same operator and generator; the buffer and the
    deflation basis are split along P (``lanczos_thick_restart``'s), the
    KPM probes are whole and the same on every rank.
    """
    device = torch.device(device or "cpu")
    if v0 is None:
        if generator is None:
            raise ValueError("pass a generator, or v0 with probes and lmin/lmax")
        v0 = torch.randn(dim, generator=generator).to(device)
    res = lanczos_thick_restart(matvec, dim, num_deflate, v0=v0, inner=inner, tol=tol,
                                which="lm", store_dtype=store_dtype,
                                basis_sharding=basis_sharding, progress=progress)
    eigvals, residuals = res.eigvals, res.residuals
    converged, n_tr = res.converged, res.matvecs
    vecs = res.vectors
    del res  # no second reference to the basis below
    if deflate_dtype is not None and vecs.dtype != deflate_dtype:
        vecs = vecs.to(deflate_dtype)
    bulk = kpm_density(deflated_matvec(matvec, vecs, basis_sharding, dim), dim, num_moments,
                       generator, num_probes=num_probes, probes=probes, lmin=lmin, lmax=lmax,
                       progress=progress, device=device)
    # KPM matvecs: range estimation (12 when the bounds were omitted) + the
    # recurrence (num_moments - 1 per probe)
    kpm_mv = bulk.num_probes * (num_moments - 1) + (12 if lmin is None else 0)
    return DeflatedDensity(eigvals=eigvals, residuals=residuals, converged=converged,
                           bulk=bulk, dim=dim, matvecs=n_tr + kpm_mv)
