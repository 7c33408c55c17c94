"""The 2-norm of a flat vector, as accurate at tens of millions of entries
on the CPU as on the card.

PyTorch's CPU ``vector_norm`` of an f32 vector sums its squares in f32
over long runs, so its relative error grows with the length: about 1e-5 at
2**20 Gaussian entries and 1e-3 at VGG-16's 33.6M
(``tests/test_torch_norms.py`` reads it).  A Lanczos vector normalised
by it is that far from unit length, and the recurrence's alphas and betas
carry it.  On the CPU the squares are summed in float64; on the card the
f32 reduction is a tree, exact to a few ulps at these lengths, and is kept.
"""

from __future__ import annotations

import torch


def norm(v: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.vector_norm(v)``, 0-d, in ``v``'s dtype; an f32 (or
    narrower) vector on the CPU is summed in float64."""
    if v.device.type == "cpu" and v.dtype in (torch.float32, torch.float16, torch.bfloat16):
        return torch.linalg.vector_norm(v, dtype=torch.float64).to(v.dtype)
    return torch.linalg.vector_norm(v)
