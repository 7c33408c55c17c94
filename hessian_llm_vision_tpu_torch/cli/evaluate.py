"""Evaluation CLI (port of ``cli/evaluate.py``): per-batch losses and, for a
workload with an ``apply_fn``, accuracy, without gradients.

The per-batch loss sweep of a model (random init from ``--seed`` or an LM
``--checkpoint``) over the ``--dataset`` batches, saved as a pickle
``{"per_batch_losses": ndarray}``.  The common flags and the printed lines
are the JAX CLI's (as there, the vgg16 and resnet50 workloads have no
``apply_fn`` and print no accuracy).

Runs on the first CUDA device unless ``--cpu`` is given; without ``--cpu``
and without a card it exits with an error.

Example:
  python -m hessian_llm_vision_tpu_torch.cli.evaluate --model gpt2-tiny \\
      --num_batches 8 --out_losses /tmp/losses.pkl --cpu
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.cli.common import add_common_args, device_for
from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
from hessian_llm_vision_tpu_torch.train.evaluation import evaluate_accuracy, per_batch_losses


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--out_losses", default=None, help="pickle of per-batch losses")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = device_for(args.cpu)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = build_workload(args, device)
    losses = per_batch_losses(wl.loss_fn, wl.params, wl.batches)
    print(f"{len(losses)} batches: mean {losses.mean():.4f}  "
          f"min {losses.min():.4f}  max {losses.max():.4f}")
    if wl.apply_fn is not None:
        acc = evaluate_accuracy(wl.apply_fn, wl.params, wl.batches)
        print(f"accuracy: {acc:.4f}")
    if args.out_losses:
        with open(args.out_losses, "wb") as f:
            pickle.dump({"per_batch_losses": np.asarray(losses)}, f)
        print(f"losses -> {args.out_losses}")
    return losses


if __name__ == "__main__":
    main()
