"""Plain Hessian-vector products and Lanczos recurrences: the benchmark's
reference for the spectrum cells.

* :func:`hvp` -- ``H v`` of a scalar loss, forward-over-reverse with
  ``torch.func``; :func:`dataset_matvec` -- the mean over batches of the
  per-batch HVPs, on flat vectors.
* :func:`lanczos_cgs2` -- Lanczos with full classical Gram-Schmidt
  reorthogonalisation done twice (CGS2) against every stored row, in f32.
* :func:`lanczos_stored` -- T-only Lanczos whose vectors (the start, each
  product and each update) are stored in a narrower dtype, every dot, AXPY
  and norm in f32 (the memory-light recurrence).

Both recurrences start from ``v0 / |v0|`` and give ``(alphas, betas)``
with ``betas[i]`` the norm of the residual after step ``i``.  Nothing here
reads the program under test.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """f32 products with TF32 on or off, for cuBLAS and cuDNN alike."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = tf32
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def flat_layout(shapes: dict) -> list:
    """``[(name, offset, numel, shape)]`` in sorted-name order."""
    out, off = [], 0
    for name in sorted(shapes):
        n = 1
        for s in shapes[name]:
            n *= s
        out.append((name, off, n, tuple(shapes[name])))
        off += n
    return out


def unflatten(vec: torch.Tensor, layout: list) -> dict:
    return {n: vec[o:o + k].view(s) for n, o, k, s in layout}


def flatten(tree: dict, layout: list) -> torch.Tensor:
    return torch.cat([tree[n].reshape(-1).float() for n, _, _, _ in layout])


def hvp(loss: Callable[[dict], torch.Tensor], weights: dict, vec: dict) -> dict:
    """``H vec`` of ``loss`` at ``weights`` (dicts of tensors)."""
    names = list(weights)
    return torch.func.jvp(torch.func.grad(loss), ({n: weights[n] for n in names},),
                          ({n: vec[n] for n in names},))[1]


def dataset_matvec(loss, weights: dict, batches: list, layout: list):
    """``v -> mean_b H_b v`` on flat f32 vectors (``loss(weights, batch)``)."""

    def matvec(v: torch.Tensor) -> torch.Tensor:
        vt = unflatten(v, layout)
        acc = torch.zeros_like(v)
        for b in batches:
            acc += flatten(hvp(lambda w: loss(w, b), weights, vt), layout)
        return acc / len(batches)

    return matvec


def lanczos_cgs2(matvec, v0: torch.Tensor, iters: int):
    """``iters`` steps of CGS2 Lanczos; returns ``(alphas, betas, basis)``,
    the basis's rows the unit vectors."""
    q = v0.float() / torch.linalg.vector_norm(v0.float())
    basis = torch.zeros(iters, q.numel(), dtype=torch.float32, device=q.device)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((), device=q.device)
    alphas, betas = [], []
    for i in range(iters):
        basis[i] = q
        w = matvec(q).float()
        alpha = torch.dot(q, w)
        w = w - alpha * q - beta_prev * q_prev
        rows = basis[:i + 1]
        for _ in range(2):
            w = w - rows.T @ (rows @ w)
        beta = torch.linalg.vector_norm(w)
        q_prev, q = q, w / beta
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas), basis


def cgs2_step(matvec, rows: torch.Tensor, beta_prev: float):
    """Step ``k = len(rows) - 1`` of :func:`lanczos_cgs2` from the stored
    rows ``q_0 .. q_k``: ``(alpha_k, beta_k, q_{k+1})``."""
    q, q_prev = rows[-1], rows[-2] if len(rows) > 1 else torch.zeros_like(rows[-1])
    w = matvec(q).float()
    alpha = torch.dot(q, w)
    w = w - alpha * q - beta_prev * q_prev
    for _ in range(2):
        w = w - rows.T @ (rows @ w)
    beta = torch.linalg.vector_norm(w)
    return alpha, beta, w / beta


def lanczos_stored(matvec, v0: torch.Tensor, iters: int, dtype: torch.dtype,
                   on_iteration: Optional[Callable[[int], None]] = None):
    """``iters`` T-only Lanczos steps with vectors stored in ``dtype``;
    returns ``(alphas, betas)``.  ``on_iteration(i)`` is called after step
    ``i``, once its scalars are on the host."""
    v0 = v0.float()
    q = (v0 / torch.linalg.vector_norm(v0)).to(dtype)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((), device=q.device)
    alphas, betas = [], []
    for i in range(iters):
        w = matvec(q.float()).to(dtype)
        alpha = torch.dot(q.float(), w.float())
        w = (w.float() - alpha * q.float() - beta_prev * q_prev.float()).to(dtype)
        beta = torch.linalg.vector_norm(w.float())
        q_prev, q = q, (w.float() / beta).to(dtype)
        del w
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
        if on_iteration is not None:
            float(beta)
            on_iteration(i)
    return torch.stack(alphas), torch.stack(betas)
