"""A copy of the benchmark at tiny sizes, for the tests: ``BENCHMARK.json``
and ``benchmark/`` under a temporary root, with a tiny GPT-2 and a tiny
NeoX configuration and a cell of each driven by the real drivers."""

from __future__ import annotations

import io
import json
import os
import shutil
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

GPT2 = dict(vocab_size=256, n_positions=64, n_ctx=64, n_embd=32, n_layer=2, n_head=2)
NEOX = dict(vocab_size=256, max_position_embeddings=64, hidden_size=32, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=2)
SHAPE = dict(batch_size=2, seq_len=16, lanczos_iters=8)
# CPU limits of the mechanics tests: a planted fault reads 1e-2 or more
LIMITS = {"spectrum_incore": {"t_gap": 1e-4, "step_gap": 1e-4, "q_gap": 1e-3},
          "spectrum_bigmodel": {"t_gap": 1e-3}}


def load(path):
    with open(path) as f:
        return json.load(f)


def dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(tmp: str) -> str:
    """The copy, with cells ``gpt2-tiny.spectrum`` and ``neox-tiny.spectrum``."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = load(os.path.join(REPO, "BENCHMARK.json"))
    cfgdir = os.path.join(root, "benchmark", "configs")
    for name, base, sizes in (("gpt2-tiny", "gpt2-124m", GPT2), ("neox-tiny", "pythia-1.4b", NEOX)):
        cfg = {**load(os.path.join(cfgdir, base + ".json")), **sizes}
        dump(cfg, os.path.join(cfgdir, name + ".json"))
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"benchmark/configs/{name}.json", "reduced": [],
                                 "why": "tests"})
    wdir = os.path.join(root, "benchmark", "workloads")
    for cell, base in (("gpt2-tiny.spectrum", "gpt2-124m.spectrum"),
                       ("neox-tiny.spectrum", "pythia-1.4b.spectrum")):
        mix = {**load(os.path.join(wdir, base + ".json")), **SHAPE}
        mix["limits"] = LIMITS[mix["driver"]]
        dump(mix, os.path.join(wdir, cell + ".json"))
        bench["workloads"].append({"name": cell, "config": cell.split(".")[0],
                                   "traffic": "spectrum", "chips": 1, "why": "tests"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["gpt2-tiny.spectrum"] + (
                ["neox-tiny.spectrum"] if "pythia-1.4b.spectrum" in m["workloads"] else [])
    dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root


def run(root: str, cell: str, seed: int = 7, seconds: float = 0.3, trace: int = 0,
        control: bool = False):
    """One run of ``cell`` on the CPU, in this process: ``(exit code,
    result dict or None, standard error)``."""
    if root not in sys.path:
        sys.path.insert(0, root)
    if REPO not in sys.path:
        sys.path.append(REPO)
    import torch

    from benchmark.harness import cell as cell_mod

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cell_mod.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                            "--trace", str(trace)], t0=time.perf_counter(), root=root,
                           device=torch.device("cpu"), control=control)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
