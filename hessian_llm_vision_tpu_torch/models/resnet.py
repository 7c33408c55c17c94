"""ResNet-50 with BatchNorm (port of ``models/resnet.py``), on NHWC images.

Names and layouts are flax's: the stem ``Conv_0`` (7x7/2, no bias) and
``BatchNorm_0``, ``Bottleneck_0 ... Bottleneck_15`` each holding
``Conv_0 ... Conv_2`` and ``BatchNorm_0 ... BatchNorm_2`` (and
``Conv_3`` / ``BatchNorm_3`` for the downsampling shortcut), then
``Dense_0``.  So weights carry across by name and flat vectors compare
element by element (161 parameter leaves at the default stages).

BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``:
``scale`` and ``bias`` are parameters; ``mean`` and ``var`` are buffers,
the ``batch_stats`` collection, never differentiated and never written.
``forward(x, use_running_average=False)`` normalises with the batch's own
statistics, the variance as flax computes it, max(0, E[x^2] - E[x]^2);
``True`` reads the stored ones.  The JAX package never updates the stored
statistics, so they stay at their init values, mean 0 and var 1.  The
normalisation is written out in elementwise ops (no in-place running
update), so it runs under ``torch.func``'s grad and jvp.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hessian_llm_vision_tpu_torch.models.gpt2 import Dense, init_weights
from hessian_llm_vision_tpu_torch.models.vgg import Conv, max_pool


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channels of NCHW activations."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.eps = eps

    def forward(self, x, use_running_average: bool = True):
        if use_running_average:
            mean, var = self.mean.to(x.dtype), self.var.to(x.dtype)
        else:
            mean = x.mean((0, 2, 3))
            var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4 * features), each with BatchNorm, and
    a 1x1 strided projection of the shortcut when ``downsample``."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        self.Conv_0 = Conv(in_features, features, 1, use_bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, stride=strides, use_bias=False)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = Conv(features, 4 * features, 1, use_bias=False)
        self.BatchNorm_2 = BatchNorm(4 * features)
        if downsample:
            self.Conv_3 = Conv(in_features, 4 * features, 1, stride=strides, use_bias=False)
            self.BatchNorm_3 = BatchNorm(4 * features)

    def forward(self, x, use_running_average: bool = True):
        ura = use_running_average
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), ura))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), ura))
        y = self.BatchNorm_2(self.Conv_2(y), ura)
        residual = self.BatchNorm_3(self.Conv_3(x), ura) if self.downsample else x
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """ResNet-50 on (B, H, W, 3) images -> (B, num_classes) logits;
    ``stage_sizes`` blocks per stage (3, 4, 6, 3)."""

    def __init__(self, num_classes: int = 10, stage_sizes: Sequence[int] = (3, 4, 6, 3), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(3, 64, 7, stride=2, use_bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        features, c, i = 64, 64, 0
        for stage, num_blocks in enumerate(stage_sizes):
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"Bottleneck_{i}", Bottleneck(c, features, strides,
                                                              downsample=block == 0))
                c, i = 4 * features, i + 1
            features *= 2
        self.n_blocks = i
        self.Dense_0 = Dense(c, num_classes)
        init_weights(self, generator)

    def forward(self, x, use_running_average: bool = True):
        x = x.to(self.Conv_0.kernel.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), use_running_average))
        x = max_pool(x, 3, 2, "SAME")
        for i in range(self.n_blocks):
            x = getattr(self, f"Bottleneck_{i}")(x, use_running_average)
        return self.Dense_0(x.mean((2, 3)))


def batch_stats(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's ``batch_stats``: every BatchNorm's ``mean`` and ``var``
    buffer by dotted name (``BatchNorm_0.mean``, ...)."""
    return {n: b.detach() for n, b in model.named_buffers()}
