"""Where a Lanczos iteration's time goes on one CUDA card, by the port's
spans (``obs/timing.py``: ``hvp``, ``lanczos.matvec``, ``lanczos.update``),
in the benchmark's two spectrum cells.

    python3 scripts/torch_span_profile.py [--out DIR]

Each cell is built as ``benchmark/run.py`` builds it: its configuration and
traffic file, its inputs drawn by ``benchmark/harness/inputs.py`` from one
fixed seed, its model from its family, and its driver's ``Port`` (the
program's path: ``lanczos(reorth=True)`` over ``DatasetHessianOperator`` in
``gpt2-124m.spectrum``, ``bigmodel_spectrum_host`` in
``pythia-1.4b.spectrum``).  An iteration starts at the operator's call in
the first, and at the callback that ends the one before in the second.

For each cell, after a one-iteration warm-up: four jobs of the traffic's
``lanczos_iters`` iterations with recording off, on, on and off (wall
seconds an iteration over each job, synchronised at its ends); then a job
traced by ``obs.timing.span_trace`` over the traffic's ``trace_iters``
iterations from the job's middle, between two iteration starts, after which
the job is stopped.  Then the host cost of a span with recording off and
on.  Prints one JSON line a cell (the trace's window, busy and work seconds,
launches and kernel rows, the table by span, the largest idle gaps by
``span:call``, the two anchors, and the shares of :func:`span_shares`) and
one for the span's cost, and on stderr the table by span with the anchors;
appends the lines to ``DIR/lines.jsonl`` and keeps each cell's trace with
its spans as ``DIR/<cell>/trace.json`` (``obs.trace_summary.summarize_spans``
reads it again).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import family, inputs, registry  # noqa: E402
from hessian_llm_vision_tpu_torch.obs.timing import recording, span, span_trace  # noqa: E402

CELLS = ("gpt2-124m.spectrum", "pythia-1.4b.spectrum")
SEED = 2100000001


class _Stop(Exception):
    """Ends a job once its trace is taken."""


class Cell:
    """A spectrum cell's program, inputs and start vector; one job is one
    spectrum of the traffic's ``lanczos_iters`` iterations."""

    def __init__(self, name: str, device: torch.device):
        bench = registry.load_benchmark(ROOT)
        cfg = registry.config(ROOT, bench, registry.cell(bench, name)["config"])
        mix = registry.mix(ROOT, name)
        shapes = family.reference(ROOT, cfg).shapes(cfg)
        B, T = mix["batch_size"], mix["seq_len"]
        weights = inputs.weights(SEED, shapes, cfg["initializer_range"], device)
        ids = inputs.token_batches(SEED, mix.get("num_batches", 1), B, T, cfg["vocab_size"],
                                   device)
        loss_fn = family.build(ROOT, cfg, shapes)[1]
        driver = registry.module(ROOT, "drivers", mix["driver"])
        self.incore = mix["driver"] == "spectrum_incore"
        self.port = (driver.Port(loss_fn, weights, ids, B) if self.incore
                     else driver.Port(loss_fn, weights, ids[0], getattr(torch, mix["vector_dtype"])))
        self.v0 = inputs.start_vector(SEED, 0, shapes, device)
        self.iters, self.trace_iters = mix["lanczos_iters"], mix["trace_iters"]

    def job(self, iters: int, at_start=None):
        """``at_start(i)`` at the start of iteration ``i`` (from 0 at the
        operator's call; from 1 at the callback)."""
        n = [0 if self.incore else 1]

        def tick():
            if at_start is not None:
                at_start(n[0])
            n[0] += 1

        if self.incore:
            self.port.spectrum(self.v0, iters, lambda mv, q: (tick(), mv(q))[1])
        else:
            self.port.spectrum(self.v0, iters, tick)


def timed_job(cell: Cell, device) -> float:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    cell.job(cell.iters)
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / cell.iters


def traced(cell: Cell, first: int, count: int, device, logdir: str) -> dict:
    """The trace's numbers over iterations ``first`` to ``first + count``
    of a job (``first + count < cell.iters``)."""
    trace = {}

    def at_start(i):
        if i == first:
            trace["ctx"] = span_trace(device, logdir)
            trace["out"] = trace["ctx"].__enter__()
        elif i == first + count:
            trace["ctx"].__exit__(None, None, None)
            raise _Stop

    try:
        cell.job(cell.iters, at_start)
    except _Stop:
        pass
    return trace["out"]


def span_shares(out: dict, iters: int) -> dict:
    """The traced window's device time charged to ``lanczos.update``, and
    the idle time in gaps that start in ``lanczos.update`` or in ``hvp``, in
    % of the window; the kernel launches an iteration."""
    spans, window = out["spans"], out["window_s"]

    def pct(name, key):
        return 100.0 * spans.get(name, {}).get(key, 0.0) / window

    return {"update_device_pct": pct("lanczos.update", "device_s"),
            "update_idle_pct": pct("lanczos.update", "idle_s"),
            "hvp_idle_pct": pct("hvp", "idle_s"),
            "launches_per_iter": out["launches"] / iters}


def print_spans(name: str, out: dict) -> None:
    a = out["anchors"]
    print(f"{name}: window {out['window_s']:.6f} s; anchors' offsets {a['open_offset_us']:.3f} "
          f"and {a['close_offset_us']:.3f} us, {a['difference_us']:.3f} us apart", file=sys.stderr)
    for span_name, row in sorted(out["spans"].items(), key=lambda kv: -kv[1]["device_s"]):
        print(f"  {span_name:16s} device {row['device_s']:.6f} s  launches {row['launches']:7d}  "
              f"idle {row['idle_s']:.6f} s", file=sys.stderr)


def span_cost(n=1_000_000, repeats=5):
    """ns a span (entered and left) with recording off and on, over an
    empty loop's."""
    sp = span("cost")

    def empty():
        for _ in range(n):
            pass

    def spans():
        for _ in range(n):
            with sp:
                pass

    def best(fn):
        out = []
        for _ in range(repeats):
            t0 = time.perf_counter_ns()
            fn()
            out.append(time.perf_counter_ns() - t0)
        return min(out) / n

    base = best(empty)
    off = best(spans)
    with recording():
        on = best(spans)
    return {"ns_per_span_off": off - base, "ns_per_span_on": on - base, "ns_empty_loop": base}


def card(device) -> dict:
    try:
        smi = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "unread"
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "span_profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_span_profile: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = [{"card": card(device)}]
    print(json.dumps(lines[0]), flush=True)
    for name in CELLS:
        torch.cuda.reset_peak_memory_stats(device)
        cell = Cell(name, device)
        cell.job(1)  # warm-up
        off, on = [], []
        for rec in (False, True, True, False):
            with recording() if rec else contextlib.nullcontext():
                (on if rec else off).append(timed_job(cell, device))
        n = cell.trace_iters
        out = traced(cell, cell.iters // 2, n, device, os.path.join(args.out, name))
        line = {"cell": name, "seed": SEED, "iters": cell.iters,
                "s_per_iter_recording_off": off, "s_per_iter_recording_on": on,
                "traced_iters": n, "traced_s_per_iter": out["window_s"] / n,
                "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30, **out,
                **span_shares(out, n)}
        print_spans(name, out)
        lines.append(line)
        print(json.dumps(line), flush=True)
        del cell
        torch.cuda.empty_cache()
    lines.append({"span_cost": span_cost()})
    print(json.dumps(lines[-1]), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "lines.jsonl"), "a") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
