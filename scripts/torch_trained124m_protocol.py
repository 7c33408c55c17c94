"""The JAX package's trained-GPT-2-124M protocol, run through the PyTorch
port on one CUDA card.

    python3 scripts/torch_trained124m_protocol.py [--out runs/trained124m]

Corpus: the running interpreter's own standard library as a byte-level
corpus (``--dataset local:<dir of os.py>``), as the JAX protocol used.

1. ``cli.train``: Adam, lr 1e-3, bs8 x seq512, blockwise attention and
   chunked loss of 256, 1000 steps, ``--save_state`` and
   ``--save_checkpoint``.
2. ``cli.train --resume_state ... --max_steps 1000``: ``--max_steps``
   counts the steps of one process, as in the JAX CLI, so the resumed run
   takes 1000 more steps (batch order and EMA restart) and its state
   reaches step 2000.
3. ``cli.spectrum``: the 35-iteration host-loop spectrum over 4 x bs8 x
   seq512 batches of the corpus on each checkpoint.

The checkpoints (0.5 GB each) stay under ``--out`` (git-ignored ``runs/``
by default); the train states (1.5 GB each) are deleted after their step
is read.  Prints the card line and one JSON line of the readings last and
writes it to ``chiprun_out/trained124m_protocol.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hessian_llm_vision_tpu_torch.cli import spectrum, train  # noqa: E402
from hessian_llm_vision_tpu_torch.io.checkpoints import load_checkpoint  # noqa: E402
from hessian_llm_vision_tpu_torch.obs.loggers import PickleStatsLogger  # noqa: E402

STEPS = 1000
TRAIN = ["--model", "gpt2", "--batch_size", "8", "--max_length", "512", "--attn_block_q", "256",
         "--loss_chunk", "256", "--optimiser", "adam", "--lr", "1e-3", "--log_every", "100",
         "--max_steps", str(STEPS)]
SPECTRUM = ["--model", "gpt2", "--num_batches", "4", "--batch_size", "8", "--max_length", "512",
            "--attn_block_q", "512", "--loss_chunk", "512", "--lanczos_iters", "35",
            "--host_loop", "--vector_seed", "997"]


def _train_run(argv: list, runs: str) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = train.main(argv + ["--out", runs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (path,) = glob.glob(os.path.join(runs, "**", "training_stats.pkl"), recursive=True)
    logs = PickleStatsLogger.read(path)
    return {"final_loss": final, "wall_s": wall, "last_logged_step": logs[-1]["step"],
            "loss_last": logs[-1]["loss"], "ema_last": logs[-1]["ema_loss"],
            "step_s_median_after_first_interval": statistics.median(
                r["step_time"] for r in logs[1:]),
            "first_interval_s": logs[0]["step_time"],
            "log": [{k: r[k] for k in ("step", "loss", "ema_loss", "step_time")} for r in logs]}


def _spectrum_run(argv: list) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, _ = spectrum.main(argv)
    torch.cuda.synchronize()
    return {"lambda_max": float(spec.eigvals.max()), "lambda_min": float(spec.eigvals.min()),
            "trace_estimate": float(torch.dot(spec.eigvals, spec.gammas)),
            "gamma_sum": float(spec.gammas.double().sum()), "main_s": time.perf_counter() - t0}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="runs/trained124m")
    out = p.parse_args().out
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    corpus = f"local:{os.path.dirname(os.__file__)}"
    os.makedirs(out, exist_ok=True)
    path = {name: os.path.join(out, name) for name in ("state1000", "state2000", "ckpt1000",
                                                         "ckpt2000")}
    res = {"card": card, "torch": torch.__version__, "corpus": corpus, "out": os.path.abspath(out)}
    res["train_1000"] = _train_run(TRAIN + ["--dataset", corpus, "--save_state",
                                            path["state1000"], "--save_checkpoint",
                                            path["ckpt1000"]], os.path.join(out, "runs1000"))
    res["train_2000"] = _train_run(TRAIN + ["--dataset", corpus, "--resume_state",
                                            path["state1000"], "--save_state", path["state2000"],
                                            "--save_checkpoint", path["ckpt2000"]],
                                   os.path.join(out, "runs2000"))
    for name in ("state1000", "state2000"):
        res[f"{name}_step"] = load_checkpoint(path[name])["step"]
        os.remove(path[name])
    for name in ("ckpt1000", "ckpt2000"):
        res[f"spectrum_{name}"] = _spectrum_run(SPECTRUM + ["--dataset", corpus,
                                                            "--checkpoint", path[name]])
    res["spectrum_init"] = _spectrum_run(SPECTRUM + ["--dataset", corpus])
    print(card)
    line = json.dumps({"trained124m_protocol": res})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "trained124m_protocol.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
