"""Hand-written first-order update rules (port of ``optim/manual.py``).

Torch conventions, as the reference writes them by hand: the momentum
buffer folds in weight decay, and the update is the buffer (not Nesterov).
Adam and raw SGD are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

ScheduleOrFloat = Union[float, Callable[[int], float]]


def _lr_at(lr: ScheduleOrFloat, step: int) -> float:
    return lr(step) if callable(lr) else float(lr)


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) -> (updates,
    new_state)``.  Dicts of tensors in and out; inputs are not modified."""

    init: Callable
    update: Callable


def sgd_momentum(
    lr: ScheduleOrFloat, momentum: float = 0.9, weight_decay: float = 0.0
) -> GradientTransformation:
    """torch-convention SGD: ``buf = μ·buf + (g + wd·p); p -= lr·buf``."""

    def init(params):
        return {"step": 0, "momentum": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(grads, state, params=None):
        if weight_decay and params is None:
            raise ValueError("weight_decay requires params")
        buf = {}
        for n, g in grads.items():
            if weight_decay:
                g = g + weight_decay * params[n]
            buf[n] = momentum * state["momentum"][n] + g
        lr_t = _lr_at(lr, state["step"])
        updates = {n: -lr_t * b for n, b in buf.items()}
        return updates, {"step": state["step"] + 1, "momentum": buf}

    return GradientTransformation(init, update)
