"""The measured window of a run.

The window opens with :meth:`Window.start` once set-up is done, and closes
at the first iteration boundary at or after ``seconds``: the driver calls
:meth:`Window.boundary` with the number of iterations it has issued since
the start, at the start of each iteration or at its end, and between jobs.
At the close the device is synchronised, so the window holds every issued
iteration whole and rates are all the work of the window over its whole
length.  The peak memory is read there.

A traced run then profiles ``trace_iters`` more iterations (fewer when the
job in flight ends first, none being never enough: the next job is traced
instead) with the benchmark's host spans: ``iteration`` between
boundaries, ``matvec`` where the driver opens it (``harness/trace.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from benchmark.harness.trace import Profiler


class Window:
    def __init__(self, seconds: float, device: torch.device, trace_iters: int = 0):
        self.seconds = float(seconds)
        self.device = device
        self.trace_iters = int(trace_iters)
        self.state = "setup"
        self.t_start = self.t_end = None
        self.iterations = 0
        self.peak_bytes = 0
        self.matvec_s = []     # synchronised matvec spans inside the window (traced runs)
        self.iteration_s = []  # the iterations those spans belong to, boundary to boundary
        self.trace: Optional[dict] = None
        self._profiler = None
        self._trace_from = 0
        self._spans = []  # host (name, start, end) while tracing
        self._iteration_t0 = None
        self._last_mark = None
        # on several ranks: ``agree(due) -> bool``, the ranks' any, so that
        # every rank closes at the same boundary
        self.agree = None

    # ---------------------------------------------------------------- clock
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self.sync()
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        self.t_start = time.perf_counter()
        self.state = "open"

    @property
    def finished(self) -> bool:
        return self.state == "done"

    @property
    def seconds_measured(self) -> float:
        return self.t_end - self.t_start

    def boundary(self, issued: int) -> None:
        """An iteration boundary; ``issued`` iterations were issued since
        :meth:`start`, all of them whole."""
        if self.state == "open":
            due = time.perf_counter() - self.t_start >= self.seconds
            if self.agree is not None:
                due = self.agree(due)
            if due:
                self.sync()
                self.t_end = time.perf_counter()
                self.iterations = issued
                if self.device.type == "cuda":
                    self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
                if self.trace_iters:
                    self._begin_trace(issued)
                else:
                    self.state = "done"
        elif self.state == "tracing":
            self._end_iteration_span()
            if issued - self._trace_from >= self.trace_iters:
                self._end_trace()
            else:
                self._begin_iteration_span()

    def job_end(self, issued: int) -> None:
        """A job (one spectrum) ended with ``issued`` iterations issued; a
        trace that holds at least one iteration ends with it."""
        self.boundary(issued)
        if self.state == "tracing" and issued > self._trace_from:
            self._end_iteration_span()
            self._end_trace()

    # ---------------------------------------------------------------- spans
    def matvec_span(self, fn, *args):
        """``fn(*args)`` inside a ``matvec`` span: synchronised and timed
        while the window is open in a traced run, a host span while
        tracing, plain otherwise."""
        if self.state == "open" and self.trace_iters:
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args)
            self.sync()
            self.matvec_s.append(time.perf_counter() - t0)
            return out
        if self.state == "tracing":
            t0 = time.perf_counter()
            out = fn(*args)
            self._spans.append(("matvec", t0, time.perf_counter()))
            return out
        return fn(*args)

    def mark_iteration(self) -> None:
        """Synchronised iteration clock for the matvec share (traced runs,
        window open): call at each iteration start."""
        if self.state == "open" and self.trace_iters:
            self.sync()
            now = time.perf_counter()
            if self._last_mark is not None:
                self.iteration_s.append(now - self._last_mark)
            self._last_mark = now

    # ---------------------------------------------------------------- trace
    def _begin_trace(self, issued: int) -> None:
        self.state = "tracing"
        self._trace_from = issued
        self._profiler = Profiler(self.device)
        self._profiler.start()
        self._begin_iteration_span()

    def _begin_iteration_span(self) -> None:
        self._iteration_t0 = time.perf_counter()

    def _end_iteration_span(self) -> None:
        if self._iteration_t0 is not None:
            self._spans.append(("iteration", self._iteration_t0, time.perf_counter()))
            self._iteration_t0 = None

    def _end_trace(self) -> None:
        self.trace = self._profiler.stop(self._spans)
        self._profiler = None
        self.state = "done"
