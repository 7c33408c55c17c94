"""Timing (port of ``obs/timing.py``): the program's host spans, a trace of
the device by those spans, and a ``torch.profiler`` trace context.

A :class:`span` marks where the work of one layer is issued:

* ``hvp``: the body of ``curvature/hvp.py::hvp_fn``'s product;
* ``lanczos.matvec``: a Lanczos loop's operator call with its argument
  casts;
* ``lanczos.update``: the rest of that iteration up to its callback (the
  basis row, the three-term update, reorthogonalisation, the norm and the
  division, and the casts of a loop that stores its vectors in another
  dtype).

Spans cost one flag check and allocate nothing unless :func:`recording` is
on; then each span appends ``(name, start_ns, end_ns)`` on
``time.perf_counter_ns`` when it closes (spans nest, the inner one is
appended first).  A span never synchronises the device: on a card it
times the host's issue of the work, and :func:`span_trace` charges each
device row of a trace to the span that launched it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, List, Optional, Tuple

import torch

SpanRecord = Tuple[str, int, int]

#: the spans of the recording in force, or None
_records: Optional[List[SpanRecord]] = None


class span:
    """A named host span, a context manager.  Make one per call site, at
    module level: entering and leaving it then allocates nothing while
    recording is off.  The same span may nest in itself."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = name
        self._open: list = []  # (records, start_ns) of each open entry

    def __enter__(self) -> "span":
        if _records is not None:
            self._open.append((_records, time.perf_counter_ns()))
        return self

    def __exit__(self, *exc) -> None:
        if self._open:
            records, t0 = self._open.pop()
            if records is _records:
                records.append((self.name, t0, time.perf_counter_ns()))


@contextlib.contextmanager
def recording() -> Iterator[List[SpanRecord]]:
    """Record every span that closes inside the block; yields the list the
    records go to, in the order the spans closed.  A recording inside
    another takes the inner block's spans from it."""
    global _records
    outer, _records = _records, []
    try:
        yield _records
    finally:
        _records = outer


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


@contextlib.contextmanager
def span_trace(device: torch.device, logdir: str) -> Iterator[dict]:
    """``torch.profiler`` of one CUDA card alone (its kernels, copies and
    fills, and the runtime's and driver's calls) over the block, with the
    spans recorded.  Writes ``logdir/trace.json`` (Chrome / Perfetto), the
    spans and their clock under its ``programSpans``, and yields a dict
    that is filled on exit with ``obs.trace_summary.span_breakdown``'s
    numbers (``summarize_spans(logdir)`` reads them again).

    The block starts on an idle device and ends synchronised: a
    synchronisation at each end is an anchor of the spans' clock.  One
    kernel runs before the first: the first launch under a fresh profiler
    waits up to milliseconds for CUPTI's buffers, and a launch row so
    delayed would not pair with a clock read before it."""
    from torch.profiler import ProfilerActivity, profile

    from hessian_llm_vision_tpu_torch.obs.trace_summary import span_breakdown

    if device.type != "cuda":
        raise ValueError(f"span_trace traces a CUDA card, not {device}")
    out: dict = {}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=device).add_(1.0)
        open_ns = time.perf_counter_ns()
        torch.cuda.synchronize(device)
        with recording() as spans:
            yield out
        close_ns = time.perf_counter_ns()
        torch.cuda.synchronize(device)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    data["programSpans"] = {"open_ns": open_ns, "close_ns": close_ns, "spans": spans}
    with open(path, "w") as f:
        json.dump(data, f)
    out.update(span_breakdown(data["traceEvents"], spans, open_ns, close_ns))
