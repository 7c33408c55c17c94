"""Micro-batch reshaping for gradient accumulation (port of
``train/accumulate.py``): the train step loops over a leading micro-batch
axis that this helper produces."""

from __future__ import annotations

from typing import Mapping


def to_microbatches(batch: Mapping, accum_steps: int) -> dict:
    """Split the leading batch axis B of every array into
    (accum_steps, B/accum_steps)."""

    def split(x):
        b = x.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        return x.reshape(accum_steps, b // accum_steps, *x.shape[1:])

    return {k: split(v) for k, v in batch.items()}
