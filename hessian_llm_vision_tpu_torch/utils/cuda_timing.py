"""Device timing on one CUDA card.

* :func:`time_ms` -- mean device time of one call, CUDA events around a run
  of calls after a warm-up.
* :func:`in_turns` -- several candidates timed in rounds, in order and then
  in reverse (A B B A), so a drift of clocks or temperature falls on all of
  them alike; the median and the min-max of each.
* :func:`smi_samples` -- ``nvidia-smi``'s SM clock, power draw, power limit
  and temperature, sampled while a block runs.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
from typing import Callable, Iterator

import torch

SMI_FIELDS = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu")


def time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 10) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(
    fns: dict[str, Callable[[], object]], *, rounds: int = 5, iters: int = 20, warmup: int = 10
) -> dict[str, dict]:
    """Time each candidate ``2 * rounds`` times, ``iters`` calls a time; each
    round runs the candidates in order and then in reverse.  Per candidate:
    ``ms`` (median), ``min``, ``max`` and the ``runs``."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    runs: dict[str, list[float]] = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            runs[name].append(time_ms(fns[name], iters=iters, warmup=0))
    return {
        name: {"ms": statistics.median(r), "min": min(r), "max": max(r), "runs": r}
        for name, r in runs.items()
    }


def _smi_summary(lines: list[str]) -> dict:
    cols: dict[str, list[float]] = {f: [] for f in SMI_FIELDS}
    for line in lines:
        parts = [x.strip() for x in line.split(",")]
        if len(parts) != len(SMI_FIELDS):
            continue
        try:
            values = [float(x) for x in parts]
        except ValueError:  # "[N/A]" and the like
            continue
        for field, v in zip(SMI_FIELDS, values):
            cols[field].append(v)
    out = {"samples": len(cols["clocks.sm"])}
    for field, unit in zip(SMI_FIELDS, ("mhz", "w", "w", "c")):
        v = cols[field]
        out[f"{field.replace('.', '_')}_{unit}"] = [min(v), max(v)] if v else None
    return out


@contextlib.contextmanager
def smi_samples(period_ms: int = 100) -> Iterator[dict]:
    """``nvidia-smi`` every ``period_ms`` while the block runs; the yielded
    dict is filled on exit with the [min, max] of each field and the number
    of samples."""
    summary: dict = {}
    proc = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
         "--format=csv,noheader,nounits", "-lms", str(period_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        yield summary
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        summary.update(_smi_summary(out.splitlines()))
