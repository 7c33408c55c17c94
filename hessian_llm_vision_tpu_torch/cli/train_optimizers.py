"""Optimizer construction for the train CLI (port of
``cli/train_optimizers.py``): maps ``--optimiser`` and its knobs to
``(init_fn, step_fn, trainer)``; ``trainer`` is the host-driven LanczosSGD
trainer when one backs the step (the precision guard and
``--precision_check`` attach to it), else None."""

from __future__ import annotations

import torch

FIRST_ORDER = ("sgd", "adam", "raw")
HOST_TRAINERS = ("lanczos-host", "lanczos-layer-host")
OPTIMISERS = FIRST_ORDER + ("lanczos", "lanczos-layer") + HOST_TRAINERS + ("gn", "ngd")


def check_optimiser(name: str) -> None:
    """Exit for an unknown optimiser."""
    if name not in OPTIMISERS:
        raise SystemExit(f"unknown --optimiser {name!r}")


def _lanczos_config(args, lr, accum):
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import LanczosSGDConfig

    return LanczosSGDConfig(
        k=args.k, delta=args.delta, lr=lr, momentum=args.momentum,
        weight_decay=args.wd, refresh_every=args.refresh_every,
        lanczos_momentum=args.lanczos_momentum, accum_steps=accum,
        normalization="sum",
    )


def _host_trainer(args, wl, lr, accum):
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import (
        HostLanczosSGDTrainer,
        HostLayerwiseLanczosSGDTrainer,
    )

    if accum > 1 and args.optimiser == "lanczos-layer-host":
        raise SystemExit(f"--optimiser {args.optimiser} does not support "
                         "--accumulation_steps > 1 yet")
    cfg = _lanczos_config(args, lr, accum)
    basis_bf16 = args.basis_bf16
    if basis_bf16 is None:
        # below 1e8 params the f32 basis costs little and keeps exactness
        basis_bf16 = sum(p.numel() for p in wl.params.values()) >= 10**8
        if basis_bf16:
            print("[train] >=1e8 params: bf16 Ritz basis on by default (--no-basis_bf16 for f32)")
    basis_dtype = torch.bfloat16 if basis_bf16 else torch.float32
    # 'auto' resolves after --resume_state, through the precision guard
    refresh_prec = "high" if args.refresh_precision == "auto" else args.refresh_precision
    if args.optimiser == "lanczos-host":
        return HostLanczosSGDTrainer(
            wl.loss_fn, wl.params, cfg, batch_size=wl.batch_size, basis_dtype=basis_dtype,
            refresh_batch_size=args.refresh_batch_size, refresh_precision=refresh_prec,
            refresh_linearized=args.refresh_linearized,
        )
    return HostLayerwiseLanczosSGDTrainer(
        wl.loss_fn, wl.params, cfg, batch_size=wl.batch_size, basis_dtype=basis_dtype,
        refresh_precision=refresh_prec,
    )


def build_optimizer(args, wl, lr, accum):
    """``args.optimiser`` is one of ``OPTIMISERS`` (``check_optimiser``)."""
    if args.optimiser in FIRST_ORDER:
        from hessian_llm_vision_tpu_torch.optim.manual import manual_adam, raw_sgd, sgd_momentum
        from hessian_llm_vision_tpu_torch.train.loop import make_train_step

        tx = {
            "sgd": lambda: sgd_momentum(lr, args.momentum, args.wd),
            # the reference's Adam: betas = (momentum, beta2), eps = delta
            "adam": lambda: manual_adam(lr, b1=args.momentum, b2=args.beta2, eps=args.delta),
            "raw": lambda: raw_sgd(lr),
        }[args.optimiser]()
        init_fn, step_fn = make_train_step(wl.loss_fn, tx, accum_steps=accum)
        return init_fn, step_fn, None
    if args.optimiser in ("lanczos", "lanczos-layer"):
        from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import (
            make_lanczos_sgd_step,
            make_layerwise_lanczos_sgd_step,
        )

        maker = (make_lanczos_sgd_step if args.optimiser == "lanczos"
                 else make_layerwise_lanczos_sgd_step)
        cfg = _lanczos_config(args, lr, accum if args.optimiser == "lanczos" else 1)
        init_fn, step_fn = maker(wl.loss_fn, wl.params, cfg, batch_size=wl.batch_size)
        return init_fn, step_fn, None
    if args.optimiser in HOST_TRAINERS:
        trainer = _host_trainer(args, wl, lr, accum)
        return trainer.init, trainer.step, trainer

    from hessian_llm_vision_tpu_torch.optim.second_order import (
        make_gauss_newton_step,
        make_natural_gradient_step,
    )

    if wl.model_fn is None:
        raise SystemExit(f"--optimiser {args.optimiser} unsupported for {wl.name!r}")
    maker = make_gauss_newton_step if args.optimiser == "gn" else make_natural_gradient_step
    step = maker(wl.model_fn, wl.out_loss_fn, wl.loss_fn, wl.params, lr=args.lr,
                 damping=args.damping, cg_iters=args.cg_iters)
    # the train loop's API: the state is the params dict itself
    return dict, step, None
