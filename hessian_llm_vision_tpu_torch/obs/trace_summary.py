"""Summarize a ``torch.profiler`` trace without TensorBoard (port of
``obs/trace_summary.py``).

``obs.timing.profile_trace`` writes a Chrome trace (``logdir/trace.json``);
this reads it back headlessly -- the loop "profile, find the hot op, fix,
re-profile" on a machine with no UI.  It also reads the JAX profiler's
``*.trace.json.gz``.  :func:`span_breakdown` charges a CUDA trace's device
time, launches and idle time to the program's spans (``obs.timing.span``),
as ``obs.timing.span_trace`` records them (:func:`summarize_spans` reads
one back).
"""

from __future__ import annotations

import bisect
import collections
import glob
import gzip
import json
import os
from typing import Dict, List, Optional, Tuple

#: the event categories of a kineto trace's GPU rows
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_file(logdir: str) -> Optional[str]:
    """The newest trace under ``logdir``: ``*.trace.json.gz`` (JAX) or
    ``*.json`` (``profile_trace``'s ``trace.json``)."""
    hits = [p for pattern in ("*.trace.json.gz", "*.json")
            for p in glob.glob(os.path.join(logdir, "**", pattern), recursive=True)]
    return max(hits, key=os.path.getmtime) if hits else None


def _load_trace(path_or_logdir: str):
    """The parsed JSON of a trace file, or of the newest trace under a
    directory (:func:`find_trace_file`), and its path."""
    path = (path_or_logdir if path_or_logdir.endswith((".gz", ".json"))
            else find_trace_file(path_or_logdir))
    if path is None:
        raise FileNotFoundError(f"no trace under {path_or_logdir!r}")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f), path


def load_trace_events(path_or_logdir: str) -> list:
    """The ``traceEvents`` of a trace file, or of the newest trace under a
    directory (:func:`find_trace_file`)."""
    data, _ = _load_trace(path_or_logdir)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def device_rows(events: list) -> Tuple[list, Dict[str, int]]:
    """The complete ("X") events that ran on a device, and how many each
    rule found: ``process_name`` (a row named TPU, GPU or device, as the
    JAX profiler names them) and ``cat`` (kineto's :data:`DEVICE_CATEGORIES`)."""
    pid_names: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = str(e.get("args", {}).get("name", "?"))
    rows, found = [], {"process_name": 0, "cat": 0}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        name = pid_names.get(e.get("pid"), "")
        by_name = "TPU" in name.upper() or "GPU" in name.upper() or "device" in name
        by_cat = e.get("cat") in DEVICE_CATEGORIES
        found["process_name"] += by_name
        found["cat"] += by_cat
        if by_name or by_cat:
            rows.append(e)
    return rows, found


def summarize_trace(
    path_or_logdir: str, top: int = 20, device_only: bool = True
) -> List[Tuple[str, float, float]]:
    """Aggregate op durations: ``[(name, total_ms, pct), ...]``, longest
    first; ``pct`` is of the kept events' total.  ``device_only=True``
    keeps the device rows (:func:`device_rows`), dropping host-side
    Python and dispatch."""
    events = load_trace_events(path_or_logdir)
    if device_only:
        kept = device_rows(events)[0]
    else:
        kept = [e for e in events if e.get("ph") == "X" and "dur" in e]
    agg = collections.Counter()
    for e in kept:
        agg[e.get("name", "?")] += e["dur"]
    total = sum(agg.values()) or 1
    return [(name, dur / 1e3, 100.0 * dur / total) for name, dur in agg.most_common(top)]


def print_trace_summary(path_or_logdir: str, top: int = 20) -> None:
    for name, ms, pct in summarize_trace(path_or_logdir, top=top):
        print(f"{ms:10.2f} ms  {pct:5.1f}%  {name[:90]}")


#: kineto's categories of the CUDA runtime's and driver's host calls (cuBLAS
#: launches some kernels through the driver's ``cuLaunchKernel``)
HOST_CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside_spans"
#: a whole trace has a kernel row for each kernel launch; one with fewer
#: than this share of them lost rows (CUPTI drops them as a process ages)
ROW_SHARE = 0.98


def _innermost_spans(spans: list) -> Tuple[list, list]:
    """``(starts, names)`` of nested ``(name, start, end)`` spans:
    ``names[i]`` is the innermost span from ``starts[i]`` to the next start
    (None outside every span)."""
    starts, names, stack = [], [], []
    last = (None, float("inf"), float("inf"))  # closes every open span
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])) + [last]:
        while stack and stack[-1][1] <= s:
            starts.append(stack.pop()[1])
            names.append(stack[-1][0] if stack else None)
        if name is not None:
            stack.append((name, e))
            starts.append(s)
            names.append(name)
    return starts, names


def _corr(e: dict):
    return e.get("args", {}).get("correlation")


def span_breakdown(events: list, spans: list, open_ns: int, close_ns: int,
                   top: int = 10) -> dict:
    """Device time, launches and idle time of a CUDA trace by the program's
    spans (``obs.timing.recording``'s ``(name, start_ns, end_ns)`` on
    ``time.perf_counter_ns``), for a trace that ``obs.timing.span_trace``
    took.

    Two anchors put the spans on the trace's clock, each a
    ``cudaDeviceSynchronize`` row paired with ``perf_counter_ns`` read just
    before its call: the first one (``open_ns``, on an idle device) and the
    first one after the last kernel launch (``close_ns``; the profiler
    synchronises again as it stops); the map between them is linear.  The
    block's device rows (kernels, copies, fills) are those whose runtime or
    driver call (``args.correlation``) comes after the first anchor, and
    rows with no call in the trace that lie between the anchors; the window
    runs from the first anchor's end to the second's, widened to hold every
    such row (CUPTI's device timestamps can drift from the host's by a few
    hundred µs over seconds).  Each row is charged to its call, and the call
    to the innermost span holding its start, so a kernel counts where it was
    launched, whenever it ran; each gap between rows to the innermost span
    holding its start; each launch between the anchors to the innermost span
    holding it.  What no span holds is charged to ``outside_spans``.  A
    trace with fewer kernel rows than ``ROW_SHARE`` of its launches lost
    rows, and is refused.

    Returns ``window_s``, ``busy_s`` (the union of the rows), ``work_s``
    (their sum), ``rows`` (kernel rows) and ``launches`` (kernel launches);
    ``spans``: ``{name: {count, host_s, device_s, launches, idle_s}}``, a
    nested span's time not in its parent's; ``idle_gaps``: the ``top``
    largest idle totals by ``span:call`` (the runtime or driver call in
    progress, ``host`` for none); ``anchors``: each anchor's offset (the
    trace's clock minus the host's) and their difference, in µs."""
    rows, calls = [], []
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            if e.get("cat") in DEVICE_CATEGORIES:
                rows.append(e)
            elif e.get("cat") in HOST_CALL_CATEGORIES:
                calls.append(e)
    calls.sort(key=lambda e: float(e["ts"]))
    syncs = [e for e in calls if e.get("name") == "cudaDeviceSynchronize"]
    if not syncs:
        raise ValueError("the trace has no cudaDeviceSynchronize to anchor its clock")
    opening = syncs[0]
    o_ts = float(opening["ts"])
    launches = [e for e in calls if "LaunchKernel" in str(e.get("name")) and float(e["ts"]) > o_ts]
    last = float(launches[-1]["ts"]) if launches else o_ts
    closing = next((e for e in syncs if float(e["ts"]) > last), None)
    if closing is None:
        raise ValueError("the trace has no cudaDeviceSynchronize after its last launch")
    c_ts = float(closing["ts"])
    scale = (c_ts - o_ts) / ((close_ns - open_ns) / 1e3)
    on_trace = lambda t: o_ts + (t - open_ns) / 1e3 * scale  # noqa: E731
    starts, names = _innermost_spans([(n, on_trace(a), on_trace(b)) for n, a, b in spans])

    def span_at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return (names[i] if i >= 0 else None) or OUTSIDE

    lo, hi = o_ts + float(opening["dur"]), c_ts + float(closing["dur"])
    by_corr = {_corr(c): c for c in calls}
    block = []
    for r in rows:
        call = by_corr.get(_corr(r))
        if call is None and lo <= float(r["ts"]) < hi:
            block.append((r, OUTSIDE))
        elif call is not None and float(call["ts"]) > o_ts:
            block.append((r, span_at(float(call["ts"]))))
    lo = min([lo] + [float(r["ts"]) for r, _ in block])
    hi = max([hi] + [float(r["ts"]) + float(r["dur"]) for r, _ in block])
    table: Dict[str, dict] = collections.defaultdict(
        lambda: {"count": 0, "host_s": 0.0, "device_s": 0.0, "launches": 0, "idle_s": 0.0})
    for n, a, b in spans:
        table[n]["count"] += 1
        table[n]["host_s"] += (b - a) * 1e-9
    intervals = []
    for r, name in block:
        s = float(r["ts"])
        table[name]["device_s"] += float(r["dur"]) * 1e-6
        intervals.append((s, s + float(r["dur"])))
    launches = [c for c in launches if float(c["ts"]) < c_ts]
    n_rows = sum(r.get("cat") == "kernel" for r, _ in block)
    if n_rows < ROW_SHARE * len(launches):
        raise ValueError(f"the trace lost device rows: {n_rows} kernel rows for "
                         f"{len(launches)} kernel launches")
    for c in launches:
        table[span_at(float(c["ts"]))]["launches"] += 1
    busy: list = []
    for s, e in sorted(intervals):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    call_starts = [float(c["ts"]) for c in calls]
    labelled = collections.Counter()
    for t, t_end in zip(edges[::2], edges[1::2]):
        if t_end <= t:
            continue
        name = span_at(t)
        table[name]["idle_s"] += (t_end - t) * 1e-6
        j = bisect.bisect_right(call_starts, t) - 1
        in_call = j >= 0 and t < call_starts[j] + float(calls[j]["dur"])
        labelled[f"{name}:{calls[j]['name'] if in_call else 'host'}"] += (t_end - t) * 1e-6
    off0, off1 = o_ts - open_ns / 1e3, c_ts - close_ns / 1e3
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "work_s": sum(e - s for s, e in intervals) * 1e-6,
        "rows": n_rows,
        "launches": len(launches),
        "spans": {k: dict(v) for k, v in table.items()},
        "idle_gaps": [[k, v] for k, v in labelled.most_common(top)],
        "anchors": {"open_offset_us": off0, "close_offset_us": off1,
                    "difference_us": off1 - off0},
    }


def summarize_spans(path_or_logdir: str) -> dict:
    """:func:`span_breakdown` of a trace that ``obs.timing.span_trace``
    wrote (its ``programSpans`` beside the ``traceEvents``)."""
    data, path = _load_trace(path_or_logdir)
    rec = data.get("programSpans") if isinstance(data, dict) else None
    if rec is None:
        raise ValueError(f"{path} holds no programSpans: not a span_trace trace")
    return span_breakdown(data["traceEvents"], [tuple(x) for x in rec["spans"]],
                          rec["open_ns"], rec["close_ns"])
