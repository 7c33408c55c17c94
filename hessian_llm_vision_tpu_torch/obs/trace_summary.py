"""Summarize a ``torch.profiler`` trace without TensorBoard (port of
``obs/trace_summary.py``).

``obs.timing.profile_trace`` writes a Chrome trace (``logdir/trace.json``);
this reads it back headlessly -- the loop "profile, find the hot op, fix,
re-profile" on a machine with no UI.  It also reads the JAX profiler's
``*.trace.json.gz``.
"""

from __future__ import annotations

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


def load_trace_events(path_or_logdir: str) -> list:
    """The ``traceEvents`` of a trace file, or of the newest trace under a
    directory (:func:`find_trace_file`)."""
    path = (path_or_logdir if path_or_logdir.endswith((".gz", ".json"))
            else find_trace_file(path_or_logdir))
    if path is None:
        raise FileNotFoundError(f"no trace under {path_or_logdir!r}")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
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
