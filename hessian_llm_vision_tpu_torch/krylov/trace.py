"""Stochastic trace estimators (port of ``krylov/trace.py``): Hutchinson
and Hutch++.

- **Hutchinson**: tr(A) ≈ (1/m) Σᵢ vᵢᵀAvᵢ with Rademacher probes, O(1/√m)
  error.
- **Hutch++** (Meyer, Musco, Musco, Woodruff 2021): a third of the matvecs
  sketch the range of A into Q, tr(QᵀAQ) is exact, and Hutchinson runs only
  on the deflated remainder (I−QQᵀ)A(I−QQᵀ): O(1/m) error.

Probes are Rademacher vectors drawn one after another from a CPU
``torch.Generator`` and copied to the device; they are kept as the rows of
an (m, P) block, so every matvec takes a contiguous row.  The JAX package's
``vmapped=True`` runs all probes as one wider program; PyTorch has no such
program, so both values of ``vmapped`` take the same loop over the matvec,
and the result is the same.  The QR of the (P, ⌈m/3⌉) sketch is
``torch.linalg.qr``, a library factorisation, as the JAX package leaves it
to XLA.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from hessian_llm_vision_tpu_torch.krylov.kpm import rademacher

__all__ = ["hutchinson_trace", "hutchpp_trace"]


def _probe_rows(generator: torch.Generator, n: int, dim: int, device) -> torch.Tensor:
    """(n, dim) Rademacher rows on ``device``, drawn one row at a time."""
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for i in range(n):
        out[i] = rademacher(generator, dim, device)
    return out


def _apply_rows(matvec: Callable, V: torch.Tensor) -> torch.Tensor:
    """Rows of A Vᵀ: one matvec per row of ``V``."""
    out = torch.empty_like(V)
    for i in range(V.shape[0]):
        out[i] = matvec(V[i])
    return out


def hutchinson_trace(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    num_probes: int,
    generator: Optional[torch.Generator] = None,
    vmapped: bool = True,
    *,
    probes: Optional[torch.Tensor] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Classical Hutchinson estimate of tr(A) with Rademacher probes from
    ``generator`` (or the rows of ``probes``, (num_probes, P)), as a 0-d
    tensor on ``device`` (default the CPU)."""
    if num_probes < 1:
        raise ValueError("num_probes must be >= 1")
    V = (probes.to(device or "cpu", torch.float32) if probes is not None
         else _probe_rows(generator, num_probes, dim, device or "cpu"))
    return torch.sum(V * _apply_rows(matvec, V)) / num_probes


def hutchpp_trace(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    num_probes: int,
    generator: Optional[torch.Generator] = None,
    vmapped: bool = True,
    *,
    sketch: Optional[torch.Tensor] = None,
    probes: Optional[torch.Tensor] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Hutch++ estimate of tr(A) with ``num_probes`` matvecs in all, as a
    0-d tensor on ``device`` (default the CPU).

    The budget m is s = ⌈m/3⌉ sketch probes, s matvecs for the exact
    low-rank term and g = m − 2s Hutchinson probes on the deflated
    operator, per the paper.  Needs m >= 3.  The s sketch rows, then the g
    probe rows, are drawn from ``generator``; ``sketch`` (s, P) and
    ``probes`` (g, P) replace those draws.
    """
    if num_probes < 3:
        raise ValueError("hutch++ needs num_probes >= 3 (one per phase)")
    s = -(-num_probes // 3)  # ceil(m/3)
    g = num_probes - 2 * s
    device = device or "cpu"

    S = (sketch.to(device, torch.float32) if sketch is not None
         else _probe_rows(generator, s, dim, device))
    AS = _apply_rows(matvec, S)
    del S
    # the sketch's columns are the rows of AS; LAPACK and cuSOLVER return Q
    # column-major, so Qᵀ's rows are contiguous and .contiguous() copies nothing
    Q = torch.linalg.qr(AS.T).Q
    del AS
    Qt = Q.T.contiguous()
    exact = torch.sum(Qt * _apply_rows(matvec, Qt))  # tr(Qᵀ A Q)
    if g == 0:
        return exact

    G = (probes.to(device, torch.float32) if probes is not None
         else _probe_rows(generator, g, dim, device))
    G = G - (G @ Q) @ Qt  # (I - QQᵀ) G, as rows
    AG = _apply_rows(matvec, G)
    AG = AG - (AG @ Q) @ Qt  # the left projector on A G
    return exact + torch.sum(G * AG) / g
