"""Host-memory offload of the Krylov basis (port of ``parallel/offload.py``).

A basis too large for the card lives in pinned (page-locked) host memory,
from which copies to the card run asynchronously on the current stream;
``ops/native`` adjusts a gradient against such a basis on the host, with
no (k, P) transfer at all.
"""

from __future__ import annotations

from typing import Optional

import torch


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` in pinned host memory: a CUDA tensor is copied there; a CPU
    tensor is already on the host and is returned as it is."""
    if x.device.type == "cpu":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out


def to_device(x: torch.Tensor, device: Optional[torch.device] = None) -> torch.Tensor:
    """``x`` on ``device`` (default: the current CUDA device), copied with
    ``non_blocking=True``: from pinned memory the copy overlaps the host,
    and the current stream orders it before later work."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return x.to(device, non_blocking=True)
