"""Timing (port of ``obs/timing.py``): an accumulating wall-clock timer
whose sections can wait for the device, the HVPs/s meter, and a
``torch.profiler`` trace context."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


def _synchronize(tensors) -> None:
    """Wait for every CUDA device that holds one of ``tensors`` (a tensor,
    or a dict / list / tuple of them)."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    elif isinstance(tensors, dict):
        tensors = list(tensors.values())
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating named wall-clock timer.  A ``section(name, block_on=x)``
    waits for the devices holding ``x`` before it reads the clock, so the
    time includes their queued work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _synchronize(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts.get(name, 0), 1)

    def summary(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self.totals}


class HVPMeter:
    """HVPs/sec counter."""

    def __init__(self):
        self.num_hvps = 0
        self.seconds = 0.0

    def record(self, num_hvps: int, seconds: float) -> None:
        self.num_hvps += num_hvps
        self.seconds += seconds

    @property
    def hvps_per_sec(self) -> float:
        return self.num_hvps / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    present); writes ``logdir/trace.json`` (Chrome / Perfetto) on exit and
    yields the profiler for ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
