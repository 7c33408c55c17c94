"""Training CLI (port of ``cli/train.py``): SGD, Adam and raw-SGD baselines
and host-driven LanczosSGD on GPT-2.

Flag names and defaults are the JAX CLI's.  Ported: ``--optimiser
sgd|adam|raw|lanczos-host`` with the loop (``--epochs``, ``--max_steps``
counted per process inside the epochs, ``--accumulation_steps``,
``--linear_decay_steps``, ``--log_every``), ``--save_checkpoint`` (the
params), ``--save_state`` / ``--resume_state`` (the train state;
lanczos-host keeps its params, momentum and step), ``--checkpoint`` and the
run directory ``--out/<optimiser>/<subsample>/lr=..._delta=...`` holding
``training_stats.pkl``, and the refresh precision of lanczos-host:
``--refresh_precision`` (``auto`` resolves it by probing the starting
params and installs the precision guard, ``optim/precision_guard.py``),
``--precision_recheck`` and ``--precision_check``.  The other optimisers
exit with "not ported yet"; the JAX CLI's ``--tensorboard``,
``--snapshot_*``, ``--post_spectrum_*``, ``--damping`` and ``--cg_iters``
are not registered yet.

Runs on the first CUDA device unless ``--cpu`` is given; without ``--cpu``
and without a card it stops with an error and never continues on the CPU.

Examples:
  python -m hessian_llm_vision_tpu_torch.cli.train --model gpt2-tiny --cpu \\
      --optimiser adam --lr 1e-3 --epochs 2 --save_state /tmp/st
  python -m hessian_llm_vision_tpu_torch.cli.train --model gpt2 \\
      --dataset local:<text dir> --batch_size 8 --max_length 512 \\
      --attn_block_q 256 --loss_chunk 256 --optimiser adam --lr 1e-3 \\
      --max_steps 1000 --log_every 100 --save_state st --save_checkpoint ck
  python -m hessian_llm_vision_tpu_torch.cli.train --model gpt2 \\
      --optimiser lanczos-host --batch_size 8 --max_length 512 --k 10 \\
      --refresh_every 2 --lanczos_momentum 0.9 --max_steps 4
  python -m hessian_llm_vision_tpu_torch.cli.train --model gpt2-tiny --cpu \\
      --optimiser lanczos-host --checkpoint ck --refresh_precision auto \\
      --precision_recheck 1 --max_steps 3
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from typing import Callable, Optional

import torch

from hessian_llm_vision_tpu_torch.cli.common import add_common_args, device_for
from hessian_llm_vision_tpu_torch.cli.precision import (
    lm_loss_factory,
    referee_loss_fn_for,
    report_precision_probe,
    resolve_mixed_precision,
    traced_ladder,
)
from hessian_llm_vision_tpu_torch.cli.train_optimizers import build_optimizer, check_optimiser
from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
from hessian_llm_vision_tpu_torch.io.checkpoints import load_checkpoint, save_checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--optimiser", default="sgd",
                   help="sgd | adam | raw | lanczos-host; lanczos, lanczos-layer, "
                   "lanczos-layer-host, gn and ngd are not ported yet")
    p.add_argument("--basis_bf16", action=argparse.BooleanOptionalAction, default=None,
                   help="lanczos-host: store the Ritz basis in bf16 (default: on at "
                   ">= 1e8 params, off below)")
    p.add_argument("--refresh_batch_size", type=int, default=None,
                   help="lanczos-host: run refresh HVPs on only the first N sequences")
    p.add_argument("--refresh_linearized", action="store_true",
                   help="lanczos-host: pay the refresh's primal fwd+bwd once "
                   "per refresh, run the k Lanczos HVPs on the cached "
                   "linearization (curvature/linearized.py); the residuals "
                   "stay on the device during the refresh "
                   "(curvature.linearized.residual_bytes counts them)")
    p.add_argument("--refresh_precision", default="high",
                   choices=["high", "highest", "default", "mixed", "auto"],
                   help="lanczos-host: matmul precision of the refresh HVPs. "
                   "'high' and 'highest' are fp32; 'default' runs them with bf16 "
                   "operands; 'mixed' = blocks 'default' + vocab head 'high' "
                   "(LMs only).  'auto' resolves the tier by probing the "
                   "STARTING params (post-resume) on the ladder mixed -> "
                   "blocks TF32 -> fp32 and installs the precision guard "
                   "(optim/precision_guard.py): periodic re-probes + "
                   "λmax-growth-triggered escalation")
    p.add_argument("--precision_recheck", type=int, default=0,
                   help="lanczos-host: re-probe the refresh precision against "
                   "the fp32 referee every N refreshes and escalate the tier on "
                   "a breach (0 = off; --refresh_precision auto defaults this to "
                   "10).  A 4x λmax growth since the last probe always triggers "
                   "a re-probe when the guard is installed")
    p.add_argument("--precision_check", action="store_true",
                   help="lanczos-host: before training, probe the refresh-"
                   "precision HVP against an fp32 referee at the starting params "
                   "(2x10 HVPs) and warn above the 2e-3 extreme-Ritz bar")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999, help="Adam beta2")
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after exactly N optimizer steps of this process "
                   "across epochs (0 = run all epochs)")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--delta", type=float, default=None,
                   help="LanczosSGD damping (default 1e-4) or, with --optimiser "
                   "adam, the Adam eps (default 1e-8)")
    p.add_argument("--accumulation_steps", type=int, default=1)
    p.add_argument("--lanczos_momentum", type=float, default=0.0)
    p.add_argument("--refresh_every", type=int, default=1)
    p.add_argument("--linear_decay_steps", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--save_checkpoint", default=None, help="save the final params")
    p.add_argument("--save_state", default=None,
                   help="save the full train state (params+optimizer+step) for resume")
    p.add_argument("--resume_state", default=None, help="resume from a --save_state file")
    return p


def _check_precision_flags(args) -> None:
    """The JAX CLI's checks: the precision probes guard the host trainer's
    refresh HVPs."""
    if args.precision_check and args.optimiser != "lanczos-host":
        raise SystemExit(
            "--precision_check probes the HOST trainers' refresh HVPs; "
            "use --optimiser lanczos-host/lanczos-layer-host (for spectrum "
            "jobs use spectrum --precision_check)"
        )
    if ((args.refresh_precision == "auto" or args.precision_recheck > 0)
            and args.optimiser != "lanczos-host"):
        raise SystemExit(
            "--refresh_precision auto / --precision_recheck guard the HOST "
            "trainers' refresh HVPs; use --optimiser lanczos-host/"
            "lanczos-layer-host"
        )
    if args.precision_recheck < 0:
        raise SystemExit("--precision_recheck must be >= 0")


def _refresh_probe_batch(args, wl, accum):
    """The probe batch of the refresh's memory plan: one micro-batch,
    further sliced by --refresh_batch_size."""
    probe_n = None
    if accum > 1:
        probe_n = max(wl.batch_size // accum, 1)
    if args.refresh_batch_size:
        probe_n = min(probe_n or args.refresh_batch_size, args.refresh_batch_size)
    batch = wl.batches[0]
    if probe_n is not None:
        batch = {k: v[:probe_n] for k, v in batch.items()}
    return batch


def _install_guard(args, wl, trainer, state0, accum):
    """--refresh_precision auto / --precision_recheck N: the refresh
    precision guard on the trainer, resolved at the starting params for
    'auto', else guarding the pinned tier.  None when neither is set."""
    if not (args.refresh_precision == "auto" or args.precision_recheck > 0):
        return None
    from hessian_llm_vision_tpu_torch.optim.precision_guard import (
        RefreshPrecisionGuard,
        default_tiers,
        tier_index_for,
    )

    factory = lm_loss_factory(wl, args)
    tiers = default_tiers(factory, wl.loss_fn)
    if args.refresh_linearized:
        tiers = traced_ladder(tiers, lambda t: (t.label, t.loss_fn, t.precision),
                              "precision-guard")
    referee = factory(None) if factory is not None else wl.loss_fn
    start = 0 if args.refresh_precision == "auto" else tier_index_for(
        tiers, args.refresh_precision)
    guard = RefreshPrecisionGuard(tiers, referee_loss_fn=referee,
                                  recheck_every=args.precision_recheck or 10,
                                  seed=args.seed + 7, start_index=start)
    trainer.precision_guard = guard
    if args.refresh_precision == "auto":
        tier = guard.resolve_initial(trainer, state0.params,
                                     _refresh_probe_batch(args, wl, accum), step=state0.step)
        print(f"[precision-guard] refresh tier resolved: {tier.label} (outer "
              f"{tier.precision}); re-probe every {guard.recheck_every} refreshes or on "
              f"{guard.growth_factor}x λmax growth")
    else:
        # guard the pinned tier: no initial probe; escalations stack on it
        trainer.set_refresh_tier(tiers[start])
        print(f"[precision-guard] guarding pinned tier {tiers[start].label}: re-probe "
              f"every {guard.recheck_every} refreshes / {guard.growth_factor}x λmax growth")
    return guard


def _precision_check(args, wl, trainer, state0, accum) -> None:
    """--precision_check: the refresh HVP against the fp32 referee at the
    starting params, reported by ``report_precision_probe``."""
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import refresh_precision_probe

    stats = refresh_precision_probe(
        trainer, state0.params, _refresh_probe_batch(args, wl, accum), seed=args.seed,
        referee_loss_fn=referee_loss_fn_for(args, wl),
    )
    report_precision_probe(
        stats, 10, what="refresh",
        hint="LanczosSGD's Ritz pairs will be unreliable; use "
             "--refresh_precision high (or highest)",
    )


def _reporting(step_fn, on_step, device: torch.device):
    """``step_fn`` that hands each step's floats and its host seconds
    (synchronised with the device) to ``on_step(step, record)``."""
    count = itertools.count()

    def step(state, batch):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        record = {k: float(v) for k, v in metrics.items()}  # waits for the device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        record["seconds"] = time.perf_counter() - t0
        on_step(next(count), record)
        return state, metrics

    return step


def main(argv=None, on_step: Optional[Callable[[int, dict], None]] = None) -> float:
    """Train; prints ``step N  loss X  ema Y  Ts`` at log points and the
    final loss last.  Returns the final loss.

    ``on_step(step, record)`` receives each step's scalar metrics as floats
    (``loss``; ``eig_min`` and ``eig_max`` for lanczos-host, ``grad_norm``
    otherwise) and ``seconds``; only with it does every step wait for the
    device."""
    from hessian_llm_vision_tpu_torch.io.runs import run_dir_name
    from hessian_llm_vision_tpu_torch.obs.loggers import MultiLogger, PickleStatsLogger
    from hessian_llm_vision_tpu_torch.optim.schedules import linear_decay
    from hessian_llm_vision_tpu_torch.train.accumulate import to_microbatches
    from hessian_llm_vision_tpu_torch.train.loop import train

    args = build_parser().parse_args(argv)
    if args.refresh_linearized and args.optimiser != "lanczos-host":
        raise SystemExit("--refresh_linearized applies to --optimiser lanczos-host")
    check_optimiser(args.optimiser)
    _check_precision_flags(args)
    device = device_for(args.cpu)
    # ambient matmuls are true fp32: TF32 and bf16 come only through the
    # precision ladder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # refresh HVPs run blocks 'default' + vocab head 'high'
    resolve_mixed_precision(args, "refresh_precision")
    if args.delta is None:
        args.delta = 1e-8 if args.optimiser == "adam" else 1e-4

    wl = build_workload(args, device)
    lr = linear_decay(args.lr, args.linear_decay_steps) if args.linear_decay_steps else args.lr
    rundir = run_dir_name(
        args.out, args.optimiser, args.subsample, lr=args.lr, delta=args.delta,
        batchsize=args.batch_size, k=args.k, accum=args.accumulation_steps,
        lanczosmomentum=args.lanczos_momentum,
    )
    os.makedirs(rundir, exist_ok=True)
    logger = MultiLogger([PickleStatsLogger(os.path.join(rundir, "training_stats.pkl"))])

    accum = args.accumulation_steps
    init_fn, step_fn, trainer = build_optimizer(args, wl, lr, accum)
    host_driven = trainer is not None
    batches = wl.batches
    if accum > 1:
        batches = [to_microbatches(b, accum) for b in batches]

    final = {"loss": float("nan")}

    def on_log(step, metrics):
        final.update(metrics)
        logger.log(step, metrics)
        print(f"step {step}  loss {metrics['loss']:.4f}  "
              f"ema {metrics['ema_loss']:.4f}  {metrics['step_time']:.3f}s")

    state0 = init_fn(wl.params)
    if args.resume_state:
        if host_driven:
            # the host trainer's state is a mutable dataclass: its resumable core
            core = load_checkpoint(args.resume_state, template={
                "params": state0.params, "momentum": state0.momentum, "step": state0.step})
            state0.params, state0.momentum = core["params"], core["momentum"]
            state0.step = core["step"]
        else:
            state0 = load_checkpoint(args.resume_state, template=state0)
        print(f"resumed train state <- {args.resume_state}")

    # after --resume_state: the probes must see the params training starts from
    guard = _install_guard(args, wl, trainer, state0, accum)
    if args.precision_check:
        _precision_check(args, wl, trainer, state0, accum)

    if on_step is not None:
        step_fn = _reporting(step_fn, on_step, device)
    state = train(step_fn, state0, batches, num_epochs=args.epochs, max_steps=args.max_steps,
                  log_every=args.log_every, on_log=on_log)
    logger.close()

    if guard is not None:
        summary = guard.summary()
        guard_path = os.path.join(rundir, "precision_guard.json")
        with open(guard_path, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"[precision-guard] final tier {guard.tier.label} ({len(guard.events)} probes, "
              f"{summary['escalations']} escalations) -> {guard_path}")

    if args.save_checkpoint:
        save_checkpoint(args.save_checkpoint, state.params)
        print(f"checkpoint -> {args.save_checkpoint}")
    if args.save_state:
        save_checkpoint(args.save_state, {"params": state.params, "momentum": state.momentum,
                                          "step": state.step} if host_driven else state)
        print(f"train state -> {args.save_state}")
    # last stdout line is the final loss (the JAX CLI's contract)
    print(final["loss"])
    return final["loss"]


if __name__ == "__main__":
    main()
