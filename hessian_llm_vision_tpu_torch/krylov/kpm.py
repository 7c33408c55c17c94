"""Kernel polynomial method (port of ``krylov/kpm.py``): a Chebyshev-moment
spectral density.

``μ_k = (1/n_probes) Σ_v vᵀ T_k(B) v`` with ``B = (A − center)/radius`` the
operator rescaled into [-1, 1], Jackson-damped against Gibbs ringing (Weiße
et al., Rev. Mod. Phys. 78, 275 (2006)).  The three-term Chebyshev
recurrence needs no basis and no orthogonalisation: two P-vectors at any
moment count, one matvec per moment.  Moments stay 0-d device tensors until
the end of each probe.  Each moment's sum runs in float64 over f32
products: an f32 dot over the 124M terms of GPT-2 124M can miss μ₀ = 1 by
more than 1e-6, where the JAX package sums in f32.

Probes are Rademacher vectors from a CPU ``torch.Generator``, copied to the
device, so a card run and a CPU run see the same probes; they differ from
the JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos_checkpointed


class KPMDensity(NamedTuple):
    """Chebyshev-moment density estimate of the operator's spectrum."""

    moments: np.ndarray  # (M,) Jackson-damped Chebyshev moments
    raw_moments: np.ndarray  # (M,) undamped moments
    center: float  # rescale: B = (A - center) / radius
    radius: float
    num_probes: int

    def density(self, grid: np.ndarray) -> np.ndarray:
        """Spectral density on ``grid`` (eigenvalue units)."""
        x = (np.asarray(grid, np.float64) - self.center) / self.radius
        x = np.clip(x, -1.0 + 1e-9, 1.0 - 1e-9)
        M = len(self.moments)
        # rho(x) = (mu_0 + 2 sum_k mu_k T_k(x)) / (pi sqrt(1 - x^2))
        tk = np.arccos(x)[None, :] * np.arange(M)[:, None]
        series = self.moments[0] + 2.0 * (self.moments[1:, None] * np.cos(tk[1:])).sum(0)
        rho = series / (np.pi * np.sqrt(1.0 - x**2))
        return rho / self.radius  # d lambda = radius d x

    def trace_estimate(self, dim: Optional[int] = None) -> float:
        """``E[λ] = tr(A)/P`` from the first two moments, center·μ₀ +
        radius·μ₁ (μ₀ ≈ 1 for unit probes); with ``dim`` given, tr(A)."""
        est = float(self.center * self.raw_moments[0] + self.radius * self.raw_moments[1])
        return est * dim if dim is not None else est


def rademacher(generator: torch.Generator, n: int, device=None) -> torch.Tensor:
    """(n,) f32 ±1 entries on ``device`` (default the CPU), drawn from the
    CPU ``generator`` as random bytes, 8 signs each, and unpacked on
    ``device``: an eighth of the draws and bytes copied of one draw per
    sign (0.5 GB a probe at GPT-2 124M's P)."""
    packed = torch.randint(0, 256, (-(-n // 8),), generator=generator, dtype=torch.uint8)
    packed = packed.to(device or "cpu")
    bits = (packed[:, None] >> torch.arange(8, dtype=torch.uint8, device=packed.device)) & 1
    return bits.reshape(-1)[:n].float().mul_(2.0).sub_(1.0)


def estimate_spectral_range(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    generator: Optional[torch.Generator] = None,
    num_iters: int = 12,
    safety: float = 1.05,
    *,
    v0: Optional[torch.Tensor] = None,
    device: Optional[torch.device] = None,
) -> tuple[float, float]:
    """(λ_min, λ_max) from a short T-only Lanczos pass, the half-width
    widened by ``safety``: KPM needs the spectrum strictly inside the
    rescaled [-1, 1].  The start vector is ``v0``, or a Gaussian draw from
    the CPU ``generator`` copied to ``device`` (default the CPU)."""
    if (v0 is None) == (generator is None):
        raise ValueError("pass exactly one of v0 / generator")
    if v0 is None:
        v0 = torch.randn(dim, generator=generator).to(device or "cpu")
    res = lanczos_checkpointed(matvec, dim, min(num_iters, dim), v0=v0)
    a = res.alphas.double().cpu().numpy()
    b = res.betas.double().cpu().numpy()
    ev = np.linalg.eigvalsh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))
    c = (ev[-1] + ev[0]) / 2
    half = (ev[-1] - ev[0]) / 2
    # extremal Ritz values underestimate the true extremes; widen
    half = max(half * safety, half + 1e-6)
    return float(c - half), float(c + half)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a · b`` summed in float64 (the products in f32)."""
    return torch.sum(a * b, dtype=torch.float64)


def _jackson(M: int) -> np.ndarray:
    k = np.arange(M, dtype=np.float64)
    n = float(M)
    return ((n - k + 1) * np.cos(np.pi * k / (n + 1))
            + np.sin(np.pi * k / (n + 1)) / np.tan(np.pi / (n + 1))) / (n + 1)


def kpm_density(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    num_moments: int,
    generator: Optional[torch.Generator] = None,
    *,
    num_probes: int = 1,
    probes: Optional[torch.Tensor] = None,
    lmin: Optional[float] = None,
    lmax: Optional[float] = None,
    jackson: bool = True,
    progress: bool = False,
    device: Optional[torch.device] = None,
) -> KPMDensity:
    """Estimate the spectral density with ``num_moments`` Chebyshev moments.

    ``lmin``/``lmax`` bound the spectrum; when omitted, a 12-iteration
    Lanczos pass estimates them (12 extra matvecs) from a start vector drawn
    from ``generator`` first.  Then each of ``num_probes`` probes is a
    Rademacher vector from ``generator`` scaled to unit norm, copied to
    ``device`` (default the CPU); ``probes``, a (n, P) tensor of unit
    vectors, replaces those draws.
    """
    if num_moments < 2:
        raise ValueError("need num_moments >= 2")
    if (lmin is None) != (lmax is None):
        raise ValueError("pass both lmin and lmax, or neither")
    if generator is None and (lmin is None or probes is None):
        raise ValueError("pass a generator, or both probes and lmin/lmax")
    device = torch.device(device or "cpu")
    if lmin is None:
        lmin, lmax = estimate_spectral_range(matvec, dim, generator, device=device)
    center = (lmax + lmin) / 2.0
    radius = max((lmax - lmin) / 2.0, 1e-30)
    if probes is not None:
        num_probes = probes.shape[0]

    mu = np.zeros(num_moments, np.float64)
    for p in range(num_probes):
        if probes is not None:
            v = probes[p].to(device, torch.float32)
        else:
            v = rademacher(generator, dim, device).div_(math.sqrt(dim))  # unit: mu_0 = 1
        t_prev, t_cur = v, (matvec(v) - center * v) / radius
        dev_moments = [_dot(v, v), _dot(v, t_cur)]
        for k in range(2, num_moments):
            # T_{k+1} = 2 B T_k - T_{k-1}, B T_k from A T_k
            t_next = 2.0 * ((matvec(t_cur) - center * t_cur) / radius) - t_prev
            t_prev, t_cur = t_cur, t_next
            dev_moments.append(_dot(v, t_next))
            if progress and k % 10 == 0:
                print(f"kpm probe {p + 1}/{num_probes} moment {k}/{num_moments}", flush=True)
        mu += torch.stack(dev_moments).cpu().numpy()
    mu /= num_probes

    damped = mu * _jackson(num_moments) if jackson else mu.copy()
    return KPMDensity(moments=damped, raw_moments=mu, center=float(center),
                      radius=float(radius), num_probes=num_probes)
