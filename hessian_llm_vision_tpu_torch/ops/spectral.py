"""Rank-k spectral gradient transforms (port of ``ops/spectral.py``).

LanczosSGD's adjustment and the projection optimizer are one primitive:

    out = g + Vᵀ · diag(c) · (V @ g)          V: (k, P) row basis

with c = 1/λ − 1/(λ+δ) (:func:`spectral_adjust`, damped Newton in the
Krylov subspace, identity elsewhere) or c = −1 (:func:`project_out`).  It
is two passes over V: ``w = c ⊙ (V g)`` (k dot products), then the rank-k
AXPY ``g + Vᵀ w``.

:func:`rank_k_apply` dispatches on the device of its tensors.  CPU tensors
take the plain PyTorch versions below; CUDA tensors always launch the
hand-written kernel pair of ``ops/csrc/rank_k.cu`` (``ops/kernels.py``),
for an f32 or bf16 basis, and anything else raises.  There is no switch
that turns the kernel off.
"""

from __future__ import annotations

import torch


def rank_k_dots_reference(
    g: torch.Tensor, basis: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """Pass 1, plain: ``coeffs ⊙ (basis @ g)`` in f32, shape (k,)."""
    return coeffs.float() * (basis.float() @ g.float())


def rank_k_axpy_reference(
    g: torch.Tensor, basis: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Pass 2, plain: ``g + basisᵀ @ w`` in f32, shape (P,)."""
    return g.float() + basis.float().T @ w.float()


def rank_k_apply_reference(
    g: torch.Tensor, basis: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """``g + basisᵀ · (coeffs ⊙ (basis @ g))`` with the basis upcast to f32."""
    return rank_k_axpy_reference(g, basis, rank_k_dots_reference(g, basis, coeffs))


def rank_k_apply_bf16(
    g: torch.Tensor, basis: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """The JAX package's bf16-streaming rank-k apply, rounding as it does.

    Both contractions take bf16 operands -- the basis, g rounded to bf16,
    and w rounded to bf16 -- with f32 accumulation (each bf16 product is
    exact in f32, so the upcast matmuls below give the same sums); the
    final AXPY adds to g in f32.  Bounded at ~1e-3 relative against the f32
    path.
    """
    g32 = g.float()
    vb = basis.to(torch.bfloat16).float()
    gb = g32.to(torch.bfloat16).float()
    w = (coeffs.float() * (vb @ gb)).to(torch.bfloat16).float()
    return g32 + w @ vb


def adjust_coeffs(eigvals: torch.Tensor, delta: float) -> torch.Tensor:
    """``c = 1/λ − 1/(λ+δ)`` with near-zero Ritz directions treated as
    identity (c=0).

    Either |λ| or |λ+δ| below ``1e-6·max|λ|`` (a zero mode, or a Ritz
    value at the damped pole λ ≈ −δ) carries no usable curvature: the
    gradient is left untouched along that direction instead of being
    multiplied by an infinite coefficient.
    """
    ev = eigvals.float()
    c = 1.0 / ev - 1.0 / (ev + delta)
    floor = 1e-6 * torch.clamp(ev.abs().max(), min=1e-30)
    bad = (ev.abs() < floor) | ((ev + delta).abs() < floor)
    return torch.where(bad, torch.zeros_like(c), c)


def rank_k_apply(
    g: torch.Tensor, basis: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """``g + basisᵀ · (coeffs ⊙ (basis @ g))``, f32 out.

    CPU: the plain versions (bf16 basis -> :func:`rank_k_apply_bf16`, the
    JAX dispatcher's choice).  CUDA: the hand-written kernel pair, which
    keeps g and w in f32 and so is more exact than the bf16 plain version.
    """
    if g.device.type == "cpu" and basis.device.type == "cpu":
        if basis.dtype == torch.bfloat16:
            return rank_k_apply_bf16(g, basis, coeffs)
        return rank_k_apply_reference(g, basis, coeffs)
    if g.is_cuda:
        from hessian_llm_vision_tpu_torch.ops import kernels

        return kernels.rank_k_apply(g, basis, coeffs)
    raise ValueError(
        f"rank_k_apply: no path for g on {g.device} with basis on {basis.device}"
    )


def spectral_adjust(
    g: torch.Tensor, basis: torch.Tensor, eigvals: torch.Tensor, delta: float
) -> torch.Tensor:
    """Lanczos gradient adjustment ``g + Σᵢ (1/λᵢ − 1/(λᵢ+δ))(vᵢ·g)vᵢ``,
    near-zero Ritz directions left unadjusted (:func:`adjust_coeffs`)."""
    return rank_k_apply(g, basis, adjust_coeffs(eigvals, delta))


def project_out(g: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Gradient projection ``g − Σᵢ (vᵢ·g)vᵢ`` (exact complement only for an
    orthonormal basis, which Ritz bases are)."""
    return rank_k_apply(g, basis, _minus_ones(basis))


def spectral_adjust_reference(g, basis, eigvals, delta):
    return rank_k_apply_reference(g, basis, adjust_coeffs(eigvals, delta))


def project_out_reference(g, basis):
    return rank_k_apply_reference(g, basis, _minus_ones(basis))


def _minus_ones(basis: torch.Tensor) -> torch.Tensor:
    return -torch.ones(basis.shape[0], dtype=torch.float32, device=basis.device)
