"""Inputs drawn from the run's seed: weights, token batches, start vectors.

Every draw comes from a ``torch.Generator`` on the run's device, seeded by
:func:`derive` from ``--seed`` and a tag, so the same seed gives the same
inputs and no two draws share a stream.  Weights are one ``randn`` over all
P entries, scaled by the configuration's ``initializer_range`` (LayerNorm
scales then shifted to 1): a few large calls on the card, in float32, the
type the curvature products use.
"""

from __future__ import annotations

import hashlib

import torch

from benchmark.reference.lanczos import flat_layout, unflatten


def derive(seed: int, tag: str, *more: int) -> int:
    """A 63-bit generator seed from ``seed``, ``tag`` and ``more``."""
    text = ":".join([str(int(seed)), tag, *(str(int(m)) for m in more)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def weights(seed: int, shapes: dict, std: float, device: torch.device) -> dict:
    """``{name: tensor}``, each leaf its own f32 storage (as a model's
    parameters are: forward-mode AD gives a view's tangent the whole storage
    of its base): N(0, std) entries, and 1 + N(0, std) for the LayerNorm
    ``scale`` leaves, drawn in one call and then split."""
    layout = flat_layout(shapes)
    size = layout[-1][1] + layout[-1][2]
    buf = torch.randn(size, generator=generator(device, derive(seed, "weights")),
                      device=device)
    buf.mul_(std)
    tree = {n: t.clone() for n, t in unflatten(buf, layout).items()}
    del buf
    for name, t in tree.items():
        if name.endswith(".scale"):
            t.add_(1.0)
    return tree


def token_batches(seed: int, num_batches: int, batch: int, seq: int, vocab: int,
                  device: torch.device) -> torch.Tensor:
    """(num_batches, batch, seq) uniform token ids."""
    return torch.randint(0, vocab, (num_batches, batch, seq),
                         generator=generator(device, derive(seed, "tokens")), device=device)


def start_vector(seed: int, index: int, shapes: dict, device: torch.device) -> dict:
    """The ``index``-th spectrum's start direction, a dict of N(0, 1) leaves."""
    layout = flat_layout(shapes)
    size = layout[-1][1] + layout[-1][2]
    v = torch.randn(size, generator=generator(device, derive(seed, "start", index)),
                    device=device)
    return unflatten(v, layout)
