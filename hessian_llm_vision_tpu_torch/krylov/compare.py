"""Spectrum comparison utilities (port of ``krylov/compare.py``): numpy
over the arrays of two :class:`~.slq.Spectrum` (tensors or arrays)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.krylov.slq import Spectrum, spectral_density


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ritz_relative_error(a: Spectrum, b: Spectrum, top_k: Optional[int] = None) -> float:
    """Max relative error between sorted Ritz values (optionally only the
    top_k by magnitude, the well-converged extremal ones)."""
    ea = np.sort(_host(a.eigvals))
    eb = np.sort(_host(b.eigvals))
    n = min(len(ea), len(eb))
    ea, eb = ea[-n:], eb[-n:]
    if top_k is not None:
        order = np.argsort(np.abs(eb))[-top_k:]
        ea, eb = ea[order], eb[order]
    denom = np.maximum(np.abs(eb), 1e-12)
    return float(np.max(np.abs(ea - eb) / denom))


def density_overlap(
    a: Spectrum, b: Spectrum, num_points: int = 512, sigma: Optional[float] = None
) -> float:
    """Bhattacharyya-style overlap of the two broadened densities in [0, 1]."""
    lo = min(float(np.min(_host(a.eigvals))), float(np.min(_host(b.eigvals))))
    hi = max(float(np.max(_host(a.eigvals))), float(np.max(_host(b.eigvals))))
    pad = 0.05 * (hi - lo + 1e-9)
    grid = torch.linspace(lo - pad, hi + pad, num_points)
    if sigma is None:
        sigma = (hi - lo + 1e-9) / 100

    def density(s: Spectrum) -> np.ndarray:  # in f32 on the CPU, as the JAX package computes it
        f32 = lambda x: torch.as_tensor(_host(x), dtype=torch.float32)
        return spectral_density(Spectrum(f32(s.eigvals), f32(s.gammas)), grid, sigma).numpy()

    da, db, x = density(a), density(b), grid.numpy()
    da = da / np.trapezoid(da, x)
    db = db / np.trapezoid(db, x)
    return float(np.trapezoid(np.sqrt(da * db), x))


def wasserstein_distance(a: Spectrum, b: Spectrum) -> float:
    """Exact W1 (earth-mover) distance between the two discrete SLQ
    measures Σ γᵢ δ(λᵢ), in eigenvalue units: ∫|F_a(x) − F_b(x)| dx over
    the merged atom grid, each γ vector normalised to a probability."""
    ea, ga = _host(a.eigvals).astype(np.float64), _host(a.gammas).astype(np.float64)
    eb, gb = _host(b.eigvals).astype(np.float64), _host(b.gammas).astype(np.float64)
    ga, gb = ga / ga.sum(), gb / gb.sum()
    xs = np.concatenate([ea, eb])
    order = np.argsort(xs)
    xs = xs[order]
    # signed mass at each atom: +γ from a, −γ from b
    w = np.concatenate([ga, -gb])[order]
    cdf_diff = np.cumsum(w)[:-1]  # F_a − F_b between consecutive atoms
    return float(np.sum(np.abs(cdf_diff) * np.diff(xs)))


def summarize(spec: Spectrum) -> dict:
    ev = np.sort(_host(spec.eigvals))
    ga = _host(spec.gammas)
    return {
        "num_ritz": len(ev),
        "lambda_max": float(ev[-1]),
        "lambda_min": float(ev[0]),
        "top5": ev[-5:].tolist(),
        "trace_estimate": float(np.dot(_host(spec.eigvals), ga)),
        "weight_sum": float(ga.sum()),
    }


def subspace_overlap(va, vb) -> float:
    """Mean squared cosine of the principal angles between the row-spaces
    of two (k, P) Ritz bases, in [0, 1] (1.0 = identical subspaces).  In
    float64 on the device of a tensor argument (the host for arrays), so a
    card's bases are not copied to the host for the QR of two (P, k)
    matrices."""
    dev = next((v.device for v in (va, vb) if isinstance(v, torch.Tensor)), torch.device("cpu"))
    qa, qb = (torch.linalg.qr(torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                                              else v, device=dev).double().T).Q
              for v in (va, vb))  # (P, k) orthonormal columns
    s = torch.linalg.svdvals(qa.T @ qb)  # cos(principal angles)
    return float(torch.sum(s**2) / min(qa.shape[1], qb.shape[1]))
