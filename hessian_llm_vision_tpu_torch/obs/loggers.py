"""Metric loggers (port of ``obs/loggers.py``): TensorBoard scalars, and
append-mode pickle stats, flushed every few records so partial stats
survive a crash, in the JAX package's file format."""

from __future__ import annotations

import os
import pickle
from typing import Dict, Sequence

import numpy as np


class TensorBoardLogger:
    """Scalars through ``torch.utils.tensorboard`` (needs the
    ``tensorboard`` package, imported here and not at module import)."""

    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(logdir, exist_ok=True)
        self._writer = SummaryWriter(logdir)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            if np.asarray(v).size == 1:  # vector metrics go to the pickle only
                self._writer.add_scalar(k, v, step)

    def close(self) -> None:
        self._writer.close()


class PickleStatsLogger:
    """Append-mode pickle stats (crash-resilient partial logs)."""

    def __init__(self, path: str, flush_every: int = 10):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self.path = path
        self.flush_every = flush_every
        self._buffer = []

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._buffer.append({"step": step, **metrics})
        if len(self._buffer) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._buffer:
            return
        with open(self.path, "ab") as f:
            pickle.dump(self._buffer, f)
        self._buffer = []

    def close(self) -> None:
        self.flush()

    @staticmethod
    def read(path: str):
        """Read back all appended chunks as one flat list (a file this
        program or the JAX package wrote: unpickling runs code)."""
        out = []
        with open(path, "rb") as f:
            while True:
                try:
                    out.extend(pickle.load(f))
                except EOFError:
                    break
        return out


class MultiLogger:
    def __init__(self, loggers: Sequence):
        self.loggers = list(loggers)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for lg in self.loggers:
            lg.log(step, metrics)

    def close(self) -> None:
        for lg in self.loggers:
            lg.close()
