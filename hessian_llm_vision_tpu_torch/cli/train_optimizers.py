"""Optimizer construction for the train CLI (port of
``cli/train_optimizers.py``): maps ``--optimiser`` and its knobs to
``(init_fn, step_fn, trainer)``; ``trainer`` is the host-driven LanczosSGD
trainer when one backs the step, else None."""

from __future__ import annotations

import torch

FIRST_ORDER = ("sgd", "adam", "raw")
PORTED = FIRST_ORDER + ("lanczos-host",)
NOT_PORTED = ("lanczos", "lanczos-layer", "lanczos-layer-host", "gn", "ngd")


def check_optimiser(name: str) -> None:
    """Exit for an optimiser the port does not have, or an unknown one."""
    if name in NOT_PORTED:
        raise SystemExit(f"--optimiser {name}: not ported yet (ROADMAP A8b; "
                         f"ported: {', '.join(PORTED)})")
    if name not in PORTED:
        raise SystemExit(f"unknown --optimiser {name!r}")


def build_optimizer(args, wl, lr, accum):
    """``args.optimiser`` is one of ``PORTED`` (``check_optimiser``)."""
    from hessian_llm_vision_tpu_torch.optim.manual import manual_adam, raw_sgd, sgd_momentum
    from hessian_llm_vision_tpu_torch.train.loop import make_train_step

    if args.optimiser in FIRST_ORDER:
        tx = {
            "sgd": lambda: sgd_momentum(lr, args.momentum, args.wd),
            # the reference's Adam: betas = (momentum, beta2), eps = delta
            "adam": lambda: manual_adam(lr, b1=args.momentum, b2=args.beta2, eps=args.delta),
            "raw": lambda: raw_sgd(lr),
        }[args.optimiser]()
        init_fn, step_fn = make_train_step(wl.loss_fn, tx, accum_steps=accum)
        return init_fn, step_fn, None

    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import LanczosSGDConfig
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import HostLanczosSGDTrainer

    cfg = LanczosSGDConfig(
        k=args.k, delta=args.delta, lr=lr, momentum=args.momentum,
        weight_decay=args.wd, refresh_every=args.refresh_every,
        lanczos_momentum=args.lanczos_momentum, accum_steps=accum,
        normalization="sum",
    )
    basis_bf16 = args.basis_bf16
    if basis_bf16 is None:
        # below 1e8 params the f32 basis costs little and keeps exactness
        basis_bf16 = sum(p.numel() for p in wl.params.values()) >= 10**8
        if basis_bf16:
            print("[train] >=1e8 params: bf16 Ritz basis on by default (--no-basis_bf16 for f32)")
    trainer = HostLanczosSGDTrainer(
        wl.loss_fn, wl.params, cfg, batch_size=wl.batch_size,
        basis_dtype=torch.bfloat16 if basis_bf16 else torch.float32,
        refresh_batch_size=args.refresh_batch_size,
        # 'auto' resolves after --resume_state, through the precision guard
        refresh_precision="high" if args.refresh_precision == "auto" else args.refresh_precision,
        refresh_linearized=args.refresh_linearized,
    )
    return trainer.init, trainer.step, trainer
