"""A cell on more than one card: one process a rank, rank 0 printing the
line.  Here two gloo ranks on the CPU, with a driver added as a file."""

import json
import os
import subprocess
import sys

from benchmark.tests import tiny

DRIVER = '''
"""A test driver: an all-reduce a boundary, across the run's ranks."""
import torch


def run(run):
    w = run.window
    x = torch.full((4,), float(run.rank + 1))
    w.start()
    issued, total = 0, 0.0
    while not w.finished:
        w.boundary(issued)
        y = x.clone()
        run.dist.all_reduce(y)
        total = float(y.sum())
        issued += 1
    run.tokens_per_iteration = 4
    run.attempted = w.iterations
    run.checks = [("sum_gap", abs(total - 4 * sum(range(1, run.world + 1))), 0.0)]
'''

RUNNER = """
import sys, time
sys.path.insert(0, {root!r}); sys.path.append({repo!r})
import torch
from benchmark.harness import cell
sys.exit(cell.main(["--workload", "ranks.probe", "--seed", "5", "--seconds", "0.5"],
                   t0=time.perf_counter(), root={root!r}, device=torch.device("cpu")))
"""


def test_two_gloo_ranks(tmp_path):
    root = tiny.make_root(tmp_path)
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "drivers", "allreduce_probe.py"), "w") as f:
        f.write(DRIVER)
    tiny.dump({"driver": "allreduce_probe"}, os.path.join(bdir, "workloads", "ranks.probe.json"))
    bench = tiny.load(os.path.join(root, "BENCHMARK.json"))
    bench["workloads"].append({"name": "ranks.probe", "config": "gpt2-tiny", "traffic": "probe",
                               "chips": 2, "why": "two ranks"})
    tiny.dump(bench, os.path.join(root, "BENCHMARK.json"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", RUNNER.format(root=root, repo=tiny.REPO)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1  # rank 1 printed nothing on standard output
    res = json.loads(lines[0])
    assert res["correct"] and res["device"]["count"] == 2 and res["attempted"] >= 1
    assert res["checks"] == {"sum_gap": {"value": 0.0, "limit": 0.0}}
