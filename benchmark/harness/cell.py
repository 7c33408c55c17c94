"""One run of one cell: find it, check the card, run its driver, read its
metrics, check that no JAX module was loaded, print the result line.

The result is the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the correctness comparison read, beside its limit.  The same checks
are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import traceback

from benchmark.harness import launch, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hessian_llm_vision_tpu")


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__)
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (whole names: the port's package passes)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


class Run:
    """What a driver reads and fills.  The driver sets ``tokens_per_iteration``,
    ``flops_per_iteration``, ``checks`` (a list of ``(name, value, limit)``),
    ``attempted`` and ``failed``."""

    def __init__(self, args, root, bench, cell, config, mix, device, t0, rank=0, world=1,
                 dist=None, control=False):
        from benchmark.harness.window import Window

        self.args, self.root, self.bench, self.cell = args, root, bench, cell
        self.config, self.mix, self.device, self.t0 = config, mix, device, t0
        self.rank, self.world, self.dist, self.control = rank, world, dist, control
        self.seed = args.seed
        self.traced = bool(args.trace)
        self.window = Window(args.seconds, device, mix.get("trace_iters", 2) if args.trace else 0)
        self.tokens_per_iteration = 0
        self.flops_per_iteration = 0.0
        self.checks: list = []
        self.attempted = 0
        self.failed = 0
        self.peak_bytes = 0
        self.busy_s = self.window_s = None
        if dist is not None:
            self.window.agree = self._any

    def _any(self, flag: bool) -> bool:
        import torch

        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MAX)
        return bool(t.item())

    def setup_clock(self) -> float:
        """Seconds since the process started."""
        import time

        return time.perf_counter() - self.t0

    @property
    def setup_s(self) -> float:
        return self.window.t_start - self.t0

    def log(self, msg: str) -> None:
        print(f"[bench r{self.rank}] {msg}", file=sys.stderr, flush=True)


def _power_limit(device) -> str:
    if device.type != "cuda":
        return "none"
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or "unread"
    except (OSError, subprocess.TimeoutExpired):
        return "unread"


def _reduce(run: "Run") -> None:
    """Over the ranks: the fullest card's peak, the mean busy and window."""
    run.peak_bytes = run.window.peak_bytes
    trace = run.window.trace
    if trace is not None:
        run.busy_s, run.window_s = trace["busy_s"], trace["window_s"]
    if run.dist is None:
        return
    import torch

    dev = run.device
    peak = torch.tensor([float(run.peak_bytes)], dtype=torch.float64, device=dev)
    run.dist.all_reduce(peak, op=run.dist.ReduceOp.MAX)
    run.peak_bytes = int(peak.item())
    if trace is not None:
        both = torch.tensor([run.busy_s, run.window_s], dtype=torch.float64, device=dev)
        run.dist.all_reduce(both)
        run.busy_s, run.window_s = (float(x) / run.world for x in both.tolist())


def result(run: "Run") -> dict:
    """The result line's object."""
    metrics = {}
    for m in registry.metrics_for(run.bench, run.cell["name"], run.traced):
        value = registry.module(run.root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = run.device
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": _device_name(dev),
        "count": run.world,
        "memory_peak_bytes": int(run.peak_bytes),
        "power_limit": _power_limit(dev),
    }
    out = {"correct": _correct(run.checks), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    trace = run.window.trace
    if trace is not None:
        device["busy_s"], device["window_s"] = run.busy_s, run.window_s
        device["trace_kernel_rows"] = trace["rows"]
        device["trace_kernel_launches"] = trace["launches"]
        out["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in run.checks}
    return out


def _finite(obj):
    """``obj`` with every non-finite float as None: the line stays JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def _device_name(dev) -> str:
    if dev.type != "cuda":
        return dev.type
    import torch

    return torch.cuda.get_device_name(dev)


def _correct(checks: list) -> bool:
    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def main(argv=None, *, t0: float, root: str, device=None, control: bool = False) -> int:
    """The command's body.  ``device`` None: the command itself, which needs
    the cards the cell asks for; a ``torch.device`` (tests) runs there.
    ``control``: the driver's control in the program's place."""
    args = parse(argv)
    bench = registry.load_benchmark(root)
    cell = registry.cell(bench, args.workload)
    chips = int(cell["chips"])
    started = launch.rank_from_env()
    rank, world = (started[0], started[1]) if started else (0, chips)

    import torch

    if started is not None:
        device = torch.device(f"cuda:{rank}" if started[3] == "cuda" else "cpu")
    elif device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: the cell {cell['name']!r} needs {chips} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    elif isinstance(device, str):
        device = torch.device(device)
    procs, dist = [], None
    try:
        if world > 1:
            if started is None:
                port = launch.free_port()
                procs = launch.start_ranks([sys.executable, os.path.join(root, "benchmark",
                                                                         "run.py"), *sys_argv(args)],
                                           world, port, device.type)
            else:
                port = started[2]
            dist = launch.init_group(rank, world, port, device.type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.cuda.reset_peak_memory_stats(device)
        run = Run(args, root, bench, cell, registry.config(root, bench, cell["config"]),
                  registry.mix(root, cell["name"]), device, t0, rank, world, dist, control)
        registry.module(root, "drivers", run.mix["driver"]).run(run)
        _reduce(run)
        out = result(run)
        if dist is not None:
            dist.barrier()
            dist.destroy_process_group()
        codes = launch.wait_ranks(procs)
    except Exception:
        traceback.print_exc()
        launch.end_ranks(procs)
        return 1
    if any(codes):
        print(f"benchmark: ranks exited with {codes}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX modules were loaded in this process: {bad}", file=sys.stderr)
        return 3
    if rank != 0:
        return 0
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(_finite(out), allow_nan=False), flush=True)
    return 0


def sys_argv(args) -> list:
    return ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
            repr(args.seconds), "--trace", str(args.trace)]
