"""The traced part of a run: ``torch.profiler`` over a few whole iterations
after the window, reduced to the numbers the per-layer readers take.

On a card the profiler records the device alone (``ProfilerActivity.CUDA``:
kineto's rows of categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``,
and the CUDA runtime and driver calls): recording every host operation as well slows
PyTorch's dispatch enough to leave the device idle two fifths of the time,
which the untraced run is not.  The benchmark's own spans (``iteration``
between boundaries, ``matvec``) are host-clock intervals, put on the
trace's clock by a marker kernel launched on the idle device as tracing
begins.  The traced window runs from that launch to the synchronisation
that ends it.  From the rows inside it:

* ``busy_s``: the union of the rows' intervals;
* ``gemm_s``: the summed time of matrix-product kernels (cuBLAS and CUTLASS
  names: GEMM, GEMV, ``xmma``, split-K reductions), ``work_s`` that of all;
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: the idle time between device rows, by what the host was
  doing when each gap began (the innermost benchmark span and CUDA runtime
  or driver call), the ten largest totals.

A trace that lost device rows is refused: the profiler drops rows as a
process ages, and a share computed from a partial trace is wrong.  Its rows
of category ``kernel`` are counted against the kernel launches that the
CUDA runtime and driver recorded inside the window (``rows``, ``launches``;
copies and fills have no launch, so they are not counted).  The window
begins with the marker launch on an idle device and ends synchronised, so a
whole trace has a row for every launch (on an H100 each launch's
correlation id has one kernel row), and one with fewer than ``ROW_SHARE``
of them has lost rows.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
from typing import Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# CUDA runtime and driver calls: cuBLAS launches some kernels through the
# driver (cuLaunchKernel), everything else through the runtime
HOST_CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")
GEMM_PATTERN = re.compile(r"gemm|gemv|xmma|cutlass|splitkreduce", re.IGNORECASE)
LAUNCH_PATTERN = re.compile(r"LaunchKernel", re.IGNORECASE)
TOP = 10
ROW_SHARE = 0.98


class TraceError(RuntimeError):
    """The trace cannot give the per-layer numbers."""


def merged(intervals: list) -> list:
    """The union of ``(start, end)`` intervals as disjoint ``[start, end]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(rows: list, lo: float, hi: float) -> list:
    """Rows ``(name, start, end)`` cut to ``[lo, hi]``; rows outside dropped."""
    return [(n, max(s, lo), min(e, hi)) for n, s, e in rows if e > lo and s < hi]


def _innermost(events: list, starts: list, t: float, depth: int) -> Optional[str]:
    """Name of the latest-starting of the ``depth`` events of ``events``
    (sorted by start) that start last at or before ``t``, if it contains
    ``t``: ``depth`` 1 for calls that do not nest, more for spans that do."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - depth), -1):
        name, s, e = events[j]
        if s <= t < e:
            return name
    return None


def reduce_events(events: list, spans: list, lo: float, hi: float) -> dict:
    """The numbers of a chrome-trace event list over the window ``[lo, hi]``;
    ``spans`` are ``(name, start, end)`` on the trace's clock (microseconds)."""
    rows, kernels, calls, launches = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        iv = (str(e.get("name", "?")), s, s + float(e["dur"]))
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            rows.append(iv)
            if cat == "kernel":
                kernels.append(iv)
        elif cat in HOST_CALL_CATEGORIES:
            calls.append(iv)
            if LAUNCH_PATTERN.search(iv[0]):
                launches.append(iv)
    rows = clip(rows, lo, hi)
    kernel_rows = len(clip(kernels, lo, hi))
    n_launch = sum(1 for _, s, _ in launches if lo <= s < hi)
    if kernel_rows < ROW_SHARE * n_launch:
        raise TraceError(f"the trace lost device rows: {kernel_rows} kernel rows for {n_launch} "
                         "kernel launches")
    busy_iv = merged([(s, e) for _, s, e in rows])
    busy = sum(e - s for s, e in busy_iv)
    by_name = collections.Counter()
    for n, s, e in rows:
        by_name[n] += e - s
    gemm = sum(t for n, t in by_name.items() if GEMM_PATTERN.search(n))
    work = sum(by_name.values())
    edges = [lo] + [x for iv in busy_iv for x in iv] + [hi]
    gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    spans = sorted(spans, key=lambda x: x[1])
    calls.sort(key=lambda x: x[1])
    span_starts, call_starts = [x[1] for x in spans], [x[1] for x in calls]
    labelled = collections.Counter()
    for length, t in gaps:
        span = _innermost(spans, span_starts, t, len(spans)) or "outside_spans"
        call = _innermost(calls, call_starts, t, 1) or "host"
        labelled[f"{span}:{call}"] += length
    us = 1e-6
    return {
        "window_s": (hi - lo) * us,
        "busy_s": busy * us,
        "work_s": work * us,
        "gemm_s": gemm * us,
        "rows": kernel_rows,
        "launches": n_launch,
        "device_ops": [[n, t * us] for n, t in by_name.most_common(TOP)],
        "idle_gaps": [[n, t * us] for n, t in labelled.most_common(TOP)],
    }


class Profiler:
    """``torch.profiler`` of the device (of the host on the CPU, where the
    tests run), with the host spans the window records."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(
            activities=[act.CUDA] if device.type == "cuda" else [act.CPU])
        self.h0 = None

    def start(self) -> None:
        """Begin on an idle device: the marker kernel is the first row."""
        import time

        self.prof.__enter__()
        self.h0 = time.perf_counter()
        if self.device.type == "cuda":
            self.torch.ones(1, device=self.device).add_(1.0)

    def stop(self, spans: list) -> dict:
        """End (after a synchronisation) and reduce; ``spans`` are
        ``(name, start, end)`` in ``time.perf_counter`` seconds."""
        import time

        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        h1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        events = data.get("traceEvents", []) if isinstance(data, dict) else data
        rows = [float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
        d0 = min(rows) if rows else 0.0
        to_trace = lambda t: d0 + (t - self.h0) * 1e6  # noqa: E731
        host = [(n, to_trace(a), to_trace(b)) for n, a, b in spans]
        return reduce_events(events, host, d0, to_trace(h1))
