"""VGG-16 for CIFAR-scale inputs (port of ``models/vgg.py``): classic VGG
without batch norm, with a ``classifier_width`` classifier and a
``num_classes`` head.

The model takes NHWC images, as the JAX model does, and keeps flax's
names and layouts in its parameters (``Conv_0 ... Conv_12`` with kernels
(kh, kw, in, out), ``Dense_0 ... Dense_2``), so weights carry across by
name and flat vectors compare element by element.  Inside, activations
run NCHW for cuDNN: the kernel is permuted at use, and the features are
flattened in NHWC order before the classifier, as flax flattens them.

:class:`Conv` and :func:`max_pool` are flax's ``nn.Conv`` and
``nn.max_pool`` on NCHW activations, with flax's "SAME" padding, which
pads ``total // 2`` before and the rest after (PyTorch's symmetric
``padding=k // 2`` shifts the output by a pixel where the total is odd).
Convolutions take the precision tier of the curvature code's scope
(``models/precision.py::conv2d``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hessian_llm_vision_tpu_torch.models import precision
from hessian_llm_vision_tpu_torch.models.gpt2 import Dense, init_weights

_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M")


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax / XLA "SAME" padding of one spatial dim of size ``n`` for a
    window ``k`` at stride ``s``: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax's ``nn.Conv`` on NCHW activations: ``kernel`` (k, k, in, out),
    optional ``bias``, stride ``stride``, "SAME" or "VALID" padding."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int, stride: int = 1,
                 padding: str = "SAME", use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_size, kernel_size, in_features,
                                               out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x):
        k = self.kernel.shape[0]
        pad = 0
        if self.padding == "SAME":
            (hl, hh), (wl, wh) = (same_pads(n, k, self.stride) for n in x.shape[2:])
            if (hl, wl) == (hh, wh):
                pad = (hl, wl)
            else:
                x = F.pad(x, (wl, wh, hl, hh))
        y = precision.conv2d(x, self.kernel.permute(3, 2, 0, 1), stride=self.stride,
                             padding=pad)
        return y if self.bias is None else y + self.bias[:, None, None]

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """flax's default kernel init, LeCun normal over the fan-in k*k*in:
        truncated at 2 sigma and rescaled to unit variance."""
        fan_in = math.prod(self.kernel.shape[:3])
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def max_pool(x: torch.Tensor, k: int, s: int, padding: str = "VALID") -> torch.Tensor:
    """flax's ``nn.max_pool`` on NCHW activations; "SAME" pads with -inf."""
    if padding == "SAME":
        (hl, hh), (wl, wh) = (same_pads(n, k, s) for n in x.shape[2:])
        x = F.pad(x, (wl, wh, hl, hh), value=-math.inf)
    return F.max_pool2d(x, k, s)


class VGG16(nn.Module):
    """VGG-16 on (B, 32, 32, 3) images -> (B, num_classes) logits."""

    def __init__(self, num_classes: int = 10, classifier_width: int = 4096, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c, s, i = 3, 32, 0
        for v in _VGG16_CFG:
            if v == "M":
                s //= 2
            else:
                self.add_module(f"Conv_{i}", Conv(c, v, 3))
                c, i = v, i + 1
        self.Dense_0 = Dense(c * s * s, classifier_width)
        self.Dense_1 = Dense(classifier_width, classifier_width)
        self.Dense_2 = Dense(classifier_width, num_classes)
        init_weights(self, generator)

    def forward(self, x):
        x = x.to(self.Conv_0.kernel.dtype).permute(0, 3, 1, 2)
        i = 0
        for v in _VGG16_CFG:
            if v == "M":
                x = max_pool(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)
