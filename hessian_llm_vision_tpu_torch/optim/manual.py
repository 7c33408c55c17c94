"""Hand-written first-order update rules (port of ``optim/manual.py``).

Torch conventions, as the reference writes them by hand: the momentum
buffer folds in weight decay, and the update is the buffer (not Nesterov).
Each rule runs one ``torch._foreach_*`` op per arithmetic step over the
parameter list in name order (a few multi-tensor launches a step on a
card, not one launch per tensor), with the JAX package's order of
operations, so CPU results match it to the last few bits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import numpy as np
import torch

ScheduleOrFloat = Union[float, Callable[[int], float]]


def _lr_at(lr: ScheduleOrFloat, step: int) -> float:
    return lr(step) if callable(lr) else float(lr)


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) -> (updates,
    new_state)``.  Dicts of tensors in and out; inputs are not modified."""

    init: Callable
    update: Callable


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Apply ``transforms`` in order (optax's ``chain``): each one's
    updates are the next one's gradients; the state is the tuple of
    theirs."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        states = []
        for t, s in zip(transforms, state, strict=True):
            grads, s = t.update(grads, s, params)
            states.append(s)
        return grads, tuple(states)

    return GradientTransformation(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    """``p + u`` per name (optax's ``apply_updates``); new tensors."""
    names = list(params)
    return dict(zip(names, torch._foreach_add([params[n] for n in names],
                                              [updates[n] for n in names])))


def sgd_momentum(
    lr: ScheduleOrFloat, momentum: float = 0.9, weight_decay: float = 0.0
) -> GradientTransformation:
    """torch-convention SGD: ``buf = μ·buf + (g + wd·p); p -= lr·buf``."""

    def init(params):
        return {"step": 0, "momentum": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(grads, state, params=None):
        if weight_decay and params is None:
            raise ValueError("weight_decay requires params")
        names = list(grads)
        g = [grads[n] for n in names]
        if weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul([params[n] for n in names], weight_decay))
        buf = torch._foreach_mul([state["momentum"][n] for n in names], momentum)
        torch._foreach_add_(buf, g)
        updates = torch._foreach_mul(buf, -_lr_at(lr, state["step"]))
        return dict(zip(names, updates)), {"step": state["step"] + 1,
                                           "momentum": dict(zip(names, buf))}

    return GradientTransformation(init, update)


def _bias_scales(b1: float, b2: float, t: int) -> tuple[float, float]:
    """``1 / (1 - b**t)`` for both moments, in float32 as the JAX rule."""
    one, t32 = np.float32(1.0), np.float32(t)
    return (float(one / (one - np.float32(b1) ** t32)),
            float(one / (one - np.float32(b2) ** t32)))


def manual_adam(
    lr: ScheduleOrFloat,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> GradientTransformation:
    """Bias-corrected Adam as the reference's raw loop writes it: bias
    correction at ``t = step + 1``, the learning rate read at ``step``."""

    def init(params):
        return {"step": 0,
                "m": {n: torch.zeros_like(p) for n, p in params.items()},
                "v": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(grads, state, params=None):
        names = list(grads)
        g = [grads[n] for n in names]
        t = state["step"] + 1
        m = torch._foreach_mul([state["m"][n] for n in names], b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_mul([state["v"][n] for n in names], b2)
        g2 = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(g2, g)
        torch._foreach_add_(v, g2)
        del g2
        mhat_scale, vhat_scale = _bias_scales(b1, b2, t)
        num = torch._foreach_mul(m, mhat_scale)
        torch._foreach_mul_(num, -_lr_at(lr, state["step"]))
        den = torch._foreach_mul(v, vhat_scale)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(num, den)
        return dict(zip(names, num)), {"step": t, "m": dict(zip(names, m)),
                                       "v": dict(zip(names, v))}

    return GradientTransformation(init, update)


def raw_sgd(lr: ScheduleOrFloat) -> GradientTransformation:
    """Plain ``p -= lr·g`` (the reference's timing baseline)."""

    def init(params):
        return {"step": 0}

    def update(grads, state, params=None):
        names = list(grads)
        updates = torch._foreach_mul([grads[n] for n in names], -_lr_at(lr, state["step"]))
        return dict(zip(names, updates)), {"step": state["step"] + 1}

    return GradientTransformation(init, update)
