"""Evaluation helpers (port of ``train/evaluation.py``): mean loss, the
per-batch loss evaluator and classifier accuracy, under ``torch.no_grad()``."""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


@torch.no_grad()
def evaluate_accuracy(apply_fn, params, batches: Iterable) -> float:
    """Mean accuracy over (x, y) or ``{"image", "label"}`` batches for a
    classifier ``apply_fn(params, x)``."""
    dev = _device_of(params)
    total, correct = 0, 0
    for b in batches:
        x, y = (b["image"], b["label"]) if isinstance(b, Mapping) else b
        logits = apply_fn(params, torch.as_tensor(x, device=dev))
        correct += int((logits.argmax(-1) == torch.as_tensor(y, device=dev)).sum())
        total += len(y)
    return correct / max(total, 1)


@torch.no_grad()
def per_batch_losses(loss_fn, params, batches: Iterable) -> np.ndarray:
    """Loss per batch, no reduction (the reference's per-batch evaluator)."""
    return np.asarray([float(loss_fn(params, b)) for b in batches])


def evaluate_loss(loss_fn, params, batches: Iterable) -> float:
    return float(np.mean(per_batch_losses(loss_fn, params, batches)))
