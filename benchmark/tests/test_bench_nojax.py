"""The check that no JAX module was loaded: whole top-level names, so the
port's package passes; a run in a fresh interpreter loads none, and a run
whose process holds one prints no result."""

import os
import subprocess
import sys

from benchmark.harness.cell import forbidden_modules
from benchmark.tests import tiny


def test_whole_top_level_names():
    assert forbidden_modules(["hessian_llm_vision_tpu_torch", "hessian_llm_vision_tpu_torch.x",
                              "torch", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["jax.numpy", "optax", "hessian_llm_vision_tpu.models"]) == [
        "hessian_llm_vision_tpu", "jax", "optax"]


RUNNER = """
import sys, time, json
sys.path.insert(0, {root!r}); sys.path.append({repo!r})
if {plant}:
    sys.modules["jax"] = type(sys)("jax")
import torch
from benchmark.harness import cell
rc = cell.main(["--workload", "gpt2-tiny.spectrum", "--seed", "11", "--seconds", "0.2"],
               t0=time.perf_counter(), root={root!r}, device=torch.device("cpu"))
print(json.dumps({{"rc": rc, "loaded": sorted(m for m in sys.modules
                                              if m.split(".")[0] in ("jax", "jaxlib", "flax"))}}))
"""


def _run(root, plant):
    code = RUNNER.format(root=root, repo=tiny.REPO, plant=plant)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=root)
    return out.stdout.strip().splitlines(), out.stderr


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.make_root(tmp_path)
    lines, err = _run(root, False)
    assert '"correct": true' in lines[-2], err[-2000:]
    assert lines[-1] == '{"rc": 0, "loaded": []}'


def test_a_process_holding_jax_prints_no_result(tmp_path):
    root = tiny.make_root(tmp_path)
    lines, err = _run(root, True)
    assert lines == ['{"rc": 3, "loaded": ["jax"]}']
    assert "JAX modules were loaded" in err
