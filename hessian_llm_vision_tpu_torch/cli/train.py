"""Training CLI (port of ``cli/train.py``): host-driven LanczosSGD on GPT-2.

Runs on the first CUDA device unless ``--cpu`` is given; without ``--cpu``
and without a card it stops with an error and never continues on the CPU.
Flag names are the JAX CLI's.  Only this slice is ported: ``--model
gpt2|gpt2-tiny``, ``--optimiser lanczos-host``, ``--dataset
random|markov``; anything else exits with "not ported yet".

Example (GPT-2 124M, bs8/seq512, 4 steps on a card):
  python -m hessian_llm_vision_tpu_torch.cli.train --model gpt2 \\
      --optimiser lanczos-host --batch_size 8 --max_length 512 --k 10 \\
      --delta 1e-4 --refresh_every 2 --lanczos_momentum 0.9 --max_steps 4
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from hessian_llm_vision_tpu_torch.cli.common import device_for
from hessian_llm_vision_tpu_torch.cli.workloads import _lm_batches

_MODELS = ("gpt2", "gpt2-tiny")
_OPTIMISERS = ("lanczos-host",)
_DATASETS = ("random", "markov")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="gpt2-tiny", help="gpt2 | gpt2-tiny")
    p.add_argument("--optimiser", default="lanczos-host", help="lanczos-host")
    p.add_argument("--dataset", default="random", help="random | markov")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_length", type=int, default=64)
    p.add_argument("--num_batches", type=int, default=None,
                   help="synthetic batches to generate (default 4)")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--delta", type=float, default=1e-4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--refresh_every", type=int, default=1)
    p.add_argument("--lanczos_momentum", type=float, default=0.0)
    p.add_argument("--basis_bf16", action=argparse.BooleanOptionalAction, default=None,
                   help="store the Ritz basis in bf16 (default: on at >= 1e8 "
                   "params, off below)")
    p.add_argument("--refresh_batch_size", type=int, default=None,
                   help="run refresh HVPs on only the first N sequences")
    p.add_argument("--refresh_linearized", action="store_true",
                   help="lanczos-host: pay the refresh's primal fwd+bwd once "
                   "per refresh, run the k Lanczos HVPs on the cached "
                   "linearization (curvature/linearized.py); the residuals "
                   "stay on the device during the refresh "
                   "(curvature.linearized.residual_bytes counts them)")
    p.add_argument("--max_steps", type=int, default=0,
                   help="optimizer steps, cycling over the batches "
                   "(0 = one pass over the batches)")
    p.add_argument("--seed", type=int, default=0, help="parameter init seed")
    p.add_argument("--data_seed", type=int, default=42)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


def main(argv=None, on_step: Optional[Callable[[int, dict], None]] = None) -> float:
    """Train; prints one line per step and the final loss last.

    ``on_step(step, record)`` receives each step's floats: ``loss``,
    ``eig_min``, ``eig_max`` and ``seconds`` (host clock around the step,
    synchronised with the device).  Returns the final loss.
    """
    args = build_parser().parse_args(argv)
    if args.refresh_linearized and args.optimiser != "lanczos-host":
        raise SystemExit("--refresh_linearized applies to --optimiser lanczos-host")
    for flag, value, ported in (
        ("--model", args.model, _MODELS),
        ("--optimiser", args.optimiser, _OPTIMISERS),
        ("--dataset", args.dataset, _DATASETS),
    ):
        if value not in ported:
            raise SystemExit(f"{flag} {value}: not ported yet (ported: {', '.join(ported)})")
    device = device_for(args.cpu)
    # curvature is true fp32: TF32 gives wrong extreme eigenvalues
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.losses import lm_loss_fn
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import LanczosSGDConfig
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import HostLanczosSGDTrainer

    if args.model == "gpt2-tiny":
        cfg = GPT2Config.tiny(n_positions=max(64, args.max_length))
    else:
        cfg = GPT2Config.gpt2_124m(n_positions=max(args.max_length, 32))
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(args.seed)).to(device)
    params = {n: p.detach() for n, p in model.named_parameters()}
    batches = _lm_batches(args, cfg.vocab_size, device)

    basis_bf16 = args.basis_bf16
    if basis_bf16 is None:
        basis_bf16 = sum(p.numel() for p in params.values()) >= 10**8
        if basis_bf16:
            print("[train] >=1e8 params: bf16 Ritz basis on by default (--no-basis_bf16 for f32)")
    trainer = HostLanczosSGDTrainer(
        lm_loss_fn(model), params,
        LanczosSGDConfig(
            k=args.k, delta=args.delta, lr=args.lr, momentum=args.momentum,
            weight_decay=args.wd, refresh_every=args.refresh_every,
            lanczos_momentum=args.lanczos_momentum, normalization="sum",
        ),
        batch_size=args.batch_size,
        basis_dtype=torch.bfloat16 if basis_bf16 else torch.float32,
        refresh_batch_size=args.refresh_batch_size,
        refresh_linearized=args.refresh_linearized,
    )
    state = trainer.init(params)
    loss = float("nan")
    for step in range(args.max_steps or len(batches)):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batches[step % len(batches)])
        record = {k: float(v) for k, v in metrics.items()}  # waits for the device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        record["seconds"] = time.perf_counter() - t0
        loss = record["loss"]
        print(
            f"step {step}  loss {loss:.4f}  eig_min {record['eig_min']:.6g}  "
            f"eig_max {record['eig_max']:.6g}  {record['seconds']:.3f}s"
        )
        if on_step is not None:
            on_step(step, record)
    # last stdout line is the final loss (the JAX CLI's contract)
    print(loss)
    return loss


if __name__ == "__main__":
    main()
