"""Lanczos with the basis in host memory (port of
``krylov/host_lanczos.py``).

The Krylov basis and T are built on the host while the matvec runs on the
device, one P-vector copied each way per iteration: for a (k, P) basis
larger than device memory (GPT-2 124M at 35 iterations is 17.4 GB) when
no mesh shards it.  The basis is float32 in page-locked host memory (when
the vectors go to a CUDA device); the recurrence and the CGS2
reorthogonalisation run on the host in float64, the basis rows upcast one
P-chunk at a time.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.krylov.lanczos import LanczosResult
from hessian_llm_vision_tpu_torch.utils.norms import norm

# columns of P per float64 transient of the host CGS2: rows x 1M x 8 bytes
_CHUNK = 1 << 20


def _cgs_pass(Q: torch.Tensor, w: torch.Tensor) -> None:
    """``w -= Qᵀ (Q w)`` in float64 for f32 rows ``Q`` and float64 ``w``,
    in place, without a float64 copy of the whole of ``Q``."""
    c = torch.zeros(Q.shape[0], dtype=torch.float64)
    for c0 in range(0, Q.shape[1], _CHUNK):
        c += Q[:, c0:c0 + _CHUNK].double() @ w[c0:c0 + _CHUNK]
    for c0 in range(0, Q.shape[1], _CHUNK):
        w[c0:c0 + _CHUNK] -= Q[:, c0:c0 + _CHUNK].double().T @ c


def lanczos_host_basis(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    num_iters: int,
    *,
    v0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    reorth: bool = True,
    callback: Optional[Callable[[int, np.ndarray, np.ndarray], None]] = None,
    device: Optional[torch.device] = None,
) -> LanczosResult:
    """Host-driven Lanczos with the basis in host memory; the matvec takes
    and returns f32 vectors on ``device`` (default: ``v0``'s device, else
    the CPU).  Exactly one of ``v0`` and the CPU ``generator`` gives the
    start vector.  ``callback(i, alphas, betas)`` fires each iteration.
    Returns a :class:`LanczosResult` whose basis is the (num_iters, P) f32
    host tensor."""
    if (v0 is None) == (generator is None):
        raise ValueError("pass exactly one of v0 / generator")
    if v0 is None:
        v0 = torch.randn(dim, generator=generator)
    device = torch.device(device or v0.device)
    v = v0.detach().to("cpu", torch.float64)
    v = v / norm(v)

    Q = torch.zeros((num_iters, dim), dtype=torch.float32, pin_memory=device.type == "cuda")
    alphas, betas = [], []
    beta_prev = 0.0
    q_prev = torch.zeros(dim, dtype=torch.float64)
    for i in range(num_iters):
        Q[i] = v
        w = matvec(Q[i].to(device, non_blocking=True)).to("cpu", torch.float64)
        alpha = float(v @ w)
        w -= alpha * v + beta_prev * q_prev
        if reorth:
            # CGS2 against the stored basis, on the host
            for _ in range(2):
                _cgs_pass(Q[: i + 1], w)
        beta = float(norm(w))
        alphas.append(alpha)
        betas.append(beta)
        if callback is not None:
            callback(i, np.asarray(alphas), np.asarray(betas[:-1]))
        q_prev, beta_prev = v, beta
        v = w / max(beta, 1e-30)

    return LanczosResult(alphas=torch.tensor(alphas, dtype=torch.float32),
                         betas=torch.tensor(betas[:-1], dtype=torch.float32), basis=Q)
