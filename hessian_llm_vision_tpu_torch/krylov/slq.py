"""Stochastic Lanczos quadrature / spectrum post-processing (port of
``krylov/slq.py``).

``eigvals, S = eigh(T); gammas = S[0, :]**2``; Ritz vectors ``V = Sᵀ Q``.
For a unit start vector v, ``Σᵢ γᵢ f(λᵢ)`` is the Gauss quadrature
estimate of ``vᵀ f(H) v ≈ tr(f(H))/P``.

The eigendecomposition of the small (m, m) T runs on the host in float64
(``torch.linalg.eigh`` on the CPU); eigvals and gammas are returned as f32
CPU tensors, the artifact's dtype.  Ritz vectors are formed in f32 on the
basis's device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from hessian_llm_vision_tpu_torch.krylov.lanczos import LanczosResult, lanczos


class Spectrum(NamedTuple):
    """Ritz values, SLQ weights, and (optionally) Ritz vectors: the
    artifact dict ``{'eigvals', 'gammas'[, 'V']}``."""

    eigvals: torch.Tensor  # (m,)
    gammas: torch.Tensor  # (m,) = first-row components squared
    ritz_vectors: Optional[torch.Tensor] = None  # (m, P), rows are Ritz vectors


def ritz_decomposition(result: LanczosResult, with_vectors: bool = False) -> Spectrum:
    """eigh on the tridiagonal T; optionally rotate the Krylov basis into
    Ritz vectors ``V = Sᵀ Q`` (rows)."""
    T = result.tridiag().detach().to("cpu", torch.float64)
    eigvals, eigvects = torch.linalg.eigh(T)
    gammas = eigvects[0, :] ** 2
    vecs = None
    if with_vectors:
        if result.basis is None:
            raise ValueError("Lanczos ran in T-only mode; no basis stored")
        basis = result.basis
        vecs = eigvects.T.to(basis.device, torch.float32) @ basis
    return Spectrum(eigvals=eigvals.float(), gammas=gammas.float(), ritz_vectors=vecs)


def ritz_vectors(result: LanczosResult) -> torch.Tensor:
    return ritz_decomposition(result, with_vectors=True).ritz_vectors


def quadrature(spectrum: Spectrum, f: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """SLQ estimate of ``vᵀ f(H) v = tr(f(H))/P`` (unit probe)."""
    return torch.dot(spectrum.gammas, f(spectrum.eigvals))


def trace_estimate(spectrum: Spectrum, dim: Optional[int] = None) -> torch.Tensor:
    """``Σ γᵢ λᵢ`` (≈0 for LM Hessians); with ``dim`` given, scaled to a
    tr(H) estimate."""
    est = torch.dot(spectrum.eigvals, spectrum.gammas)
    return est * dim if dim is not None else est


def spectral_density(spectrum: Spectrum, grid: torch.Tensor, sigma: float = 0.1) -> torch.Tensor:
    """Gaussian-broadened SLQ spectral density on ``grid``."""
    diffs = grid[:, None] - spectrum.eigvals[None, :]
    kernels = torch.exp(-0.5 * (diffs / sigma) ** 2) / (sigma * math.sqrt(2 * math.pi))
    return kernels @ spectrum.gammas


def slq_multi_probe(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    num_iters: int,
    generator: torch.Generator,
    num_probes: int,
    *,
    reorth: bool = True,
    device: Optional[torch.device] = None,
) -> Spectrum:
    """Average SLQ over ``num_probes`` random unit probes, one after another.

    Every probe's start vector is drawn from ``generator`` in probe order
    (on the generator's device) and moved to ``device`` (default: the
    generator's).  Eigvals and gammas are concatenated across probes with
    gammas scaled by 1/num_probes, so ``quadrature`` / ``spectral_density``
    work unchanged.
    """
    eigvals, gammas = [], []
    for _ in range(num_probes):
        v0 = torch.randn(dim, generator=generator, device=generator.device)
        res = lanczos(matvec, dim, num_iters, v0=v0.to(device or generator.device),
                      reorth=reorth, store_basis=reorth)
        spec = ritz_decomposition(res)
        eigvals.append(spec.eigvals)
        gammas.append(spec.gammas)
    return Spectrum(
        eigvals=torch.cat(eigvals), gammas=torch.cat(gammas) / num_probes, ritz_vectors=None
    )
