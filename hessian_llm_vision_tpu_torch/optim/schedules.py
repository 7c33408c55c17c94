"""LR schedules on int steps (port of ``optim/schedules.py``).

Linear decay ``lr * max(0, 1 - step/total)``, computed in float32 as the
JAX schedule is, and returned as a Python float.
"""

from __future__ import annotations

import numpy as np


def linear_decay(base_lr: float, total_steps: int):
    def schedule(step: int) -> float:
        frac = np.float32(1.0) - np.float32(step) / np.float32(total_steps)
        return float(np.float32(base_lr) * max(np.float32(0.0), frac))

    return schedule


def constant(base_lr: float):
    def schedule(step: int) -> float:
        return float(np.float32(base_lr))

    return schedule
