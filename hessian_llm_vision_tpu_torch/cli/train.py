"""Training CLI (port of ``cli/train.py``): SGD, Adam and raw-SGD baselines,
LanczosSGD (fused, layer-wise and host-driven), and Gauss-Newton and
natural-gradient steps on the language models and the classifiers.

Flag names and defaults are the JAX CLI's: ``--optimiser sgd | adam | raw
| lanczos | lanczos-layer | lanczos-host | lanczos-layer-host | gn | ngd``
with the loop (``--epochs``, ``--max_steps`` counted per process inside
the epochs, ``--accumulation_steps``, ``--linear_decay_steps``,
``--log_every``), ``--damping`` and ``--cg_iters`` (gn/ngd),
``--save_checkpoint`` (the params), ``--save_state`` / ``--resume_state``
(the train state; the host trainers keep their params, momentum and step,
gn/ngd their params), ``--checkpoint``, the run directory
``--out/<optimiser>/<subsample>/lr=..._delta=...`` holding
``training_stats.pkl`` (and with ``--tensorboard`` its
``tensorboard_logs/``), ``--snapshot_every`` (a T-only Lanczos of the batch
Hessian every N steps, saved as ``T_step<N>.npz`` in the run directory),
``--post_spectrum_iters`` (a reorthogonalised Lanczos with Ritz vectors on
the first batch after training, saved as ``eigenspace.npz`` or
``--post_spectrum_out``), and the refresh precision of the host trainers:
``--refresh_precision`` (``auto`` resolves it by probing the starting
params and installs the precision guard, ``optim/precision_guard.py``),
``--precision_recheck`` and ``--precision_check``.  With ``--augment`` or
``--noise`` on vgg16/resnet50 and ``--epochs`` > 1, each epoch trains on a
fresh draw of the transforms (``train.loop.EpochResampledBatches``).

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
  python -m hessian_llm_vision_tpu_torch.cli.train --model gpt2-tiny --cpu \\
      --optimiser lanczos --k 4 --refresh_every 2 --lanczos_momentum 0.5 \\
      --max_steps 3 --snapshot_every 1 --post_spectrum_iters 8
  python -m hessian_llm_vision_tpu_torch.cli.train --model gpt2-tiny --cpu \\
      --optimiser gn --lr 0.5 --damping 1e-2 --cg_iters 10 --max_steps 2
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
)
from hessian_llm_vision_tpu_torch.cli.train_optimizers import (
    HOST_TRAINERS,
    build_optimizer,
    check_optimiser,
)
from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
from hessian_llm_vision_tpu_torch.io.checkpoints import load_checkpoint, save_checkpoint
from hessian_llm_vision_tpu_torch.models.moe import warn_if_topk_curvature


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--optimiser", default="sgd",
                   help="sgd | adam | raw | lanczos | lanczos-host | lanczos-layer | "
                   "lanczos-layer-host | gn | ngd")
    p.add_argument("--basis_bf16", action=argparse.BooleanOptionalAction, default=None,
                   help="lanczos-host/-layer-host: store the Ritz basis in bf16 (default: on at "
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
                   help="lanczos-host/-layer-host: matmul precision of the refresh HVPs. "
                   "'high' and 'highest' are fp32; 'default' runs them with bf16 "
                   "operands; 'mixed' = blocks 'default' + vocab head 'high' "
                   "(LMs only).  'auto' resolves the tier by probing the "
                   "STARTING params (post-resume) on the ladder mixed -> "
                   "blocks TF32 -> fp32 and installs the precision guard "
                   "(optim/precision_guard.py): periodic re-probes + "
                   "λmax-growth-triggered escalation")
    p.add_argument("--precision_recheck", type=int, default=0,
                   help="lanczos-host/-layer-host: re-probe the refresh precision against "
                   "the fp32 referee every N refreshes and escalate the tier on "
                   "a breach (0 = off; --refresh_precision auto defaults this to "
                   "10).  A 4x λmax growth since the last probe always triggers "
                   "a re-probe when the guard is installed")
    p.add_argument("--precision_check", action="store_true",
                   help="lanczos-host/-layer-host: before training, probe the refresh-"
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
    p.add_argument("--damping", type=float, default=1e-3,
                   help="gn/ngd: the curvature's damping, (G + damping I)")
    p.add_argument("--cg_iters", type=int, default=20, help="gn/ngd: CG iterations at most")
    p.add_argument("--linear_decay_steps", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--save_checkpoint", default=None, help="save the final params")
    p.add_argument("--save_state", default=None,
                   help="save the full train state (params+optimizer+step) for resume")
    p.add_argument("--resume_state", default=None, help="resume from a --save_state file")
    p.add_argument("--tensorboard", action="store_true",
                   help="also log scalars to <run dir>/tensorboard_logs (needs the "
                   "tensorboard package)")
    p.add_argument("--snapshot_every", type=int, default=0,
                   help="every N steps, a T-only Lanczos of the current batch's Hessian "
                   "(the first micro-batch under accumulation), printed and saved as "
                   "<run dir>/T_step<N>.npz")
    p.add_argument("--snapshot_iters", type=int, default=10)
    p.add_argument("--post_spectrum_iters", type=int, default=0,
                   help="after training, a random-seeded reorthogonalised Lanczos of "
                   "this depth on the first batch, saved with its Ritz vectors")
    p.add_argument("--post_spectrum_out", default=None,
                   help="the post-training spectrum's path (default <run dir>/eigenspace)")
    return p


def _check_flags(args) -> None:
    """The JAX CLI's refusals: the precision probes guard the host
    trainers' refresh HVPs; the fused layer-wise step has no accumulation."""
    if args.precision_check and args.optimiser not in HOST_TRAINERS:
        raise SystemExit(
            "--precision_check probes the HOST trainers' refresh HVPs; "
            "use --optimiser lanczos-host/lanczos-layer-host (for spectrum "
            "jobs use spectrum --precision_check)"
        )
    if ((args.refresh_precision == "auto" or args.precision_recheck > 0)
            and args.optimiser not in HOST_TRAINERS):
        raise SystemExit(
            "--refresh_precision auto / --precision_recheck guard the HOST "
            "trainers' refresh HVPs; use --optimiser lanczos-host/"
            "lanczos-layer-host"
        )
    if args.precision_recheck < 0:
        raise SystemExit("--precision_recheck must be >= 0")
    if args.optimiser == "lanczos-layer" and args.accumulation_steps > 1:
        raise SystemExit(
            "--optimiser lanczos-layer does not support --accumulation_steps > 1 "
            "(per-leaf Lanczos runs on the full batch; drop the flag or use "
            "--optimiser lanczos)"
        )


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
        # waits for the device; a vector metric (layer_eig_*) as a list
        record = {k: float(v) if torch.as_tensor(v).numel() == 1 else torch.as_tensor(v).tolist()
                  for k, v in metrics.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        record["seconds"] = time.perf_counter() - t0
        on_step(next(count), record)
        return state, metrics

    return step


def _snapshot_hook(args, wl, rundir: str, accum: int):
    """``on_state(step, state, batch)`` for ``--snapshot_every``: a T-only
    Lanczos (no reorthogonalization) of the batch Hessian -- the first
    micro-batch under accumulation -- from a generator on the params'
    device seeded with the step; prints the extremes and saves
    ``T_step{step:06d}.npz``."""
    from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
    from hessian_llm_vision_tpu_torch.io.spectra import save_tridiag
    from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
    from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition

    def on_state(step, state, batch):
        params = getattr(state, "params", state)
        if accum > 1:
            batch = {k: v[0] for k, v in batch.items()}
        op = HessianOperator(wl.loss_fn, params, batch)
        device = next(iter(params.values())).device
        res = lanczos(op.matvec, op.dim, args.snapshot_iters,
                      generator=torch.Generator(device=device).manual_seed(step),
                      reorth=False, store_basis=False)
        ev = ritz_decomposition(res).eigvals
        print(f"[snapshot step {step}] lambda_max {float(ev.max()):.4f} "
              f"lambda_min {float(ev.min()):.4f}")
        save_tridiag(os.path.join(rundir, f"T_step{step:06d}"), res.alphas, res.betas, step=step)

    return on_state


def _post_spectrum(args, wl, params, rundir: str) -> None:
    """``--post_spectrum_iters``: a reorthogonalised Lanczos with Ritz vectors
    of the first batch's Hessian at the final params, from a generator on
    their device seeded with ``--seed + 1``, saved by ``save_spectrum``."""
    from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
    from hessian_llm_vision_tpu_torch.io.spectra import save_spectrum
    from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
    from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition

    op = HessianOperator(wl.loss_fn, params, wl.batches[0])
    device = next(iter(params.values())).device
    res = lanczos(op.matvec, op.dim, args.post_spectrum_iters,
                  generator=torch.Generator(device=device).manual_seed(args.seed + 1),
                  reorth=True)
    spec = ritz_decomposition(res, with_vectors=True)
    del res
    print(f"post-training spectrum: lambda_max {float(spec.eigvals.max()):.4f} "
          f"lambda_min {float(spec.eigvals.min()):.4f}")
    out = args.post_spectrum_out or os.path.join(rundir, "eigenspace")
    save_spectrum(out, spec, iters=args.post_spectrum_iters)
    print(f"eigenspace -> {out}.npz")


def main(argv=None, on_step: Optional[Callable[[int, dict], None]] = None) -> float:
    """Train; prints ``step N  loss X  ema Y  Ts`` at log points and the
    final loss last.  Returns the final loss.

    ``on_step(step, record)`` receives each step's metrics as floats, or
    lists for the layer-wise ``layer_eig_max`` / ``layer_eig_min`` (``loss``;
    ``eig_min`` and ``eig_max`` for lanczos and lanczos-host, ``grad_norm``
    for the first-order rules and lanczos, ``cg_iters`` and ``cg_residual``
    for gn/ngd), and ``seconds``; only with it does every step wait for the
    device."""
    from hessian_llm_vision_tpu_torch.io.runs import run_dir_name
    from hessian_llm_vision_tpu_torch.obs.loggers import (
        MultiLogger,
        PickleStatsLogger,
        TensorBoardLogger,
    )
    from hessian_llm_vision_tpu_torch.optim.schedules import linear_decay
    from hessian_llm_vision_tpu_torch.train.accumulate import to_microbatches
    from hessian_llm_vision_tpu_torch.train.loop import EpochResampledBatches, train

    args = build_parser().parse_args(argv)
    if args.refresh_linearized and args.optimiser != "lanczos-host":
        raise SystemExit("--refresh_linearized applies to --optimiser lanczos-host")
    check_optimiser(args.optimiser)
    _check_flags(args)
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
    if args.optimiser not in ("sgd", "adam", "raw"):
        # every other optimiser consumes curvature: warn on top-k routing
        warn_if_topk_curvature(wl.model, what=f"train --optimiser {args.optimiser}")
    lr = linear_decay(args.lr, args.linear_decay_steps) if args.linear_decay_steps else args.lr
    rundir = run_dir_name(
        args.out, args.optimiser, args.subsample, lr=args.lr, delta=args.delta,
        batchsize=args.batch_size, k=args.k, accum=args.accumulation_steps,
        lanczosmomentum=args.lanczos_momentum,
    )
    os.makedirs(rundir, exist_ok=True)
    loggers = [PickleStatsLogger(os.path.join(rundir, "training_stats.pkl"))]
    if args.tensorboard:
        try:
            loggers.append(TensorBoardLogger(os.path.join(rundir, "tensorboard_logs")))
        except ImportError as e:
            raise SystemExit(f"--tensorboard needs the 'tensorboard' package, which is not "
                             f"installed ({e})") from e
    logger = MultiLogger(loggers)

    accum = args.accumulation_steps
    init_fn, step_fn, trainer = build_optimizer(args, wl, lr, accum)
    host_driven = trainer is not None
    batches = wl.batches
    if accum > 1:
        batches = [to_microbatches(b, accum) for b in batches]
    if wl.make_batches is not None and args.epochs > 1:
        # --augment / --noise: each epoch redraws its crops, flips and noise;
        # epoch 0 equals wl.batches, so a one-epoch run is unchanged
        batches = EpochResampledBatches(
            wl.make_batches,
            transform=(lambda bs: [to_microbatches(b, accum) for b in bs]) if accum > 1 else None,
        )

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
    on_state = _snapshot_hook(args, wl, rundir, accum) if args.snapshot_every > 0 else None
    state = train(step_fn, state0, batches, num_epochs=args.epochs, max_steps=args.max_steps,
                  log_every=args.log_every, on_log=on_log, on_state=on_state,
                  on_state_every=args.snapshot_every)
    logger.close()

    if guard is not None:
        summary = guard.summary()
        guard_path = os.path.join(rundir, "precision_guard.json")
        with open(guard_path, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"[precision-guard] final tier {guard.tier.label} ({len(guard.events)} probes, "
              f"{summary['escalations']} escalations) -> {guard_path}")

    # gn/ngd carry the bare params dict as their state
    params = getattr(state, "params", state)
    if args.save_checkpoint:
        save_checkpoint(args.save_checkpoint, params)
        print(f"checkpoint -> {args.save_checkpoint}")
    if args.save_state:
        save_checkpoint(args.save_state, {"params": state.params, "momentum": state.momentum,
                                          "step": state.step} if host_driven else state)
        print(f"train state -> {args.save_state}")
    if args.post_spectrum_iters > 0:
        _post_spectrum(args, wl, params, rundir)
    # last stdout line is the final loss (the JAX CLI's contract)
    print(final["loss"])
    return final["loss"]


if __name__ == "__main__":
    main()
