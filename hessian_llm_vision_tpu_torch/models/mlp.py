"""MLP models of the synthetic and concept-test workloads (port of
``models/mlp.py``): a SiLU MLP for k-spiral classification and the
784-100-10 ReLU ``SimpleNet`` for MNIST.

Names and layouts are flax's (``Dense_0 ... Dense_n``, kernels (in, out)),
so weights carry across by name (``models/convert.py``).  flax infers the
input width at init; here it is the workloads' (2-d points, 28x28 images).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hessian_llm_vision_tpu_torch.models.gpt2 import Dense, init_weights


class SpiralMLP(nn.Module):
    """SiLU MLP on 2-d points: 2 -> [width] * depth -> num_classes."""

    def __init__(self, width: int = 64, depth: int = 3, num_classes: int = 3, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        widths = [2] + [width] * depth + [num_classes]
        for i in range(depth + 1):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        init_weights(self, generator)

    def forward(self, x):
        x = x.to(self.Dense_0.kernel.dtype)
        for i in range(self.depth):
            x = F.silu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.depth}")(x)


class SimpleNet(nn.Module):
    """784 -> hidden -> 10 ReLU net; flattens its (B, 28, 28, 1) input."""

    def __init__(self, hidden: int = 100, num_classes: int = 10, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = Dense(28 * 28, hidden)
        self.Dense_1 = Dense(hidden, num_classes)
        init_weights(self, generator)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.Dense_0.kernel.dtype)
        return self.Dense_1(F.relu(self.Dense_0(x)))
