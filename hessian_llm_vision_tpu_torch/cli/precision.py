"""Precision resolution shared by the CLIs (port of ``cli/precision.py``):
the 'mixed' sugar, the ``--precision_check`` report, the
``make_loss_fn(spec)`` factory of the auto-precision planner, the
``--hvp_precision`` / ``--refresh_precision auto`` resolution with
persisted-plan reuse (``krylov/precplan.py``), and the clean-model referee
loss of the precision probes."""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Optional

import torch

from hessian_llm_vision_tpu_torch.cli.workloads import Workload


def resolve_mixed_precision(args, attr: str) -> None:
    """Expand the 'mixed' sugar on ``args.<attr>`` in place: the outer
    scope (embeddings, vocab head, loss) at 'high' and the transformer
    blocks at 'default' (bf16 operands), unless ``--block_precision``
    names them."""
    if getattr(args, attr, None) == "mixed":
        setattr(args, attr, "high")
        if not getattr(args, "block_precision", None):
            args.block_precision = "default"


def report_precision_probe(stats: dict, iters: int, *, what: str,
                           hint: str, bar: float = 2e-3) -> None:
    """The one report and warning of every ``--precision_check``: the
    2e-3 extreme-Ritz bar lives here and nowhere else."""
    print(
        f"[precision] {what} extreme-Ritz rel err vs f32 referee "
        f"({iters} iters): {stats['ritz_rel_err']:.3e}  "
        f"(matvec rel err {stats['rel_err']:.3e}; "
        f"{stats['seconds_requested']:.2f}s vs {stats['seconds_referee']:.2f}s "
        f"per HVP)",
        flush=True,
    )
    if stats["ritz_rel_err"] > bar:
        print(
            f"[precision] WARNING: extreme-Ritz error "
            f"{stats['ritz_rel_err']:.3e} exceeds the {bar:g} parity bar at "
            f"THIS checkpoint — {hint}",
            file=sys.stderr,
            flush=True,
        )


def lm_loss_factory(wl: Workload, args) -> Optional[Callable]:
    """``make_loss_fn(block_spec)`` for the planner and the guard: rebuilds
    only the model, with ``spec``'s precision fields, and its loss closure,
    reusing the workload's params and batches.  The rebuilt module lives
    on the meta device: ``functional_call`` swaps the workload's params in,
    so no weights are drawn or copied.  None for a model without a
    block-precision surface."""
    cfg = getattr(wl.model, "config", None)
    if cfg is None or not hasattr(cfg, "block_matmul_precision"):
        return None
    from hessian_llm_vision_tpu_torch.krylov.autoprec import spec_to_overrides
    from hessian_llm_vision_tpu_torch.models.losses import lm_loss_fn

    model_cls = type(wl.model)
    loss_chunk = getattr(args, "loss_chunk", None)

    def make_loss_fn(spec):
        with torch.device("meta"):
            m = model_cls(dataclasses.replace(cfg, **spec_to_overrides(spec)))
        return lm_loss_fn(m, loss_chunk=loss_chunk)

    return make_loss_fn


def _probe_batch(batch: dict) -> dict:
    """At most 4 sequences, as the JAX CLI's probe (its reorthogonalised
    basis and the HVP working set had to share a 16 GB chip); precision
    error is a property of the checkpoint's operand scales, not of the
    batch size."""
    if batch["input_ids"].shape[0] > 4:
        return {k: v[:4] for k, v in batch.items()}
    return batch


def resolve_auto_precision(args, wl: Workload, attr: str = "hvp_precision",
                           *, tol: float = 1e-3) -> Workload:
    """Expand ``--<attr> auto`` by probing the checkpoint
    (``krylov/autoprec.py``): ``args.<attr>`` and ``args.block_precision``
    become the fastest arm within the 1e-3 extreme-Ritz bar of the fp32
    referee, and the workload comes back with its model and loss rebuilt
    per the plan.  A plan file (``--precision_plan``, else a sibling of
    ``--checkpoint``) that matches the checkpoint's fingerprint and the
    context resolves it with no probe HVP; ``--reprobe`` probes again.
    No-op when ``args.<attr> != 'auto'``."""
    if getattr(args, attr, None) != "auto":
        if getattr(args, "reprobe", False) or getattr(args, "precision_plan", None):
            raise SystemExit(
                f"--reprobe/--precision_plan have no effect without --{attr} auto"
            )
        return wl
    if getattr(args, "block_precision", None):
        raise SystemExit(
            f"--block_precision conflicts with --{attr} auto (auto CHOOSES "
            "the block precisions; pin --hvp_precision high/mixed/default "
            "to combine with an explicit --block_precision)"
        )
    factory = lm_loss_factory(wl, args)
    if factory is None or getattr(args, "operator", "hessian") != "hessian":
        why = (
            "non-LM model: no transformer-block precision surface"
            if factory is None
            else f"--operator {args.operator}: the probe gates the Hessian program only"
        )
        print(f"[auto-precision] {why}; resolving to 'high'")
        setattr(args, attr, "high")
        return wl
    from hessian_llm_vision_tpu_torch.krylov.autoprec import (
        auto_precision_plan,
        default_candidates,
        spec_to_overrides,
    )
    from hessian_llm_vision_tpu_torch.krylov.precplan import (
        checkpoint_fingerprint,
        default_plan_path,
        load_plan,
        params_fingerprint,
        plan_context,
        save_plan,
    )

    cfg = wl.model.config
    candidates = default_candidates()
    probe_batch = _probe_batch(wl.batches[0])
    ritz_iters = getattr(args, "precision_check_iters", 10)
    plan_path = getattr(args, "precision_plan", None)
    if plan_path is None and getattr(args, "checkpoint", None):
        plan_path = default_plan_path(args.checkpoint)
    plan = fp = ctx = None
    if plan_path:
        if getattr(args, "checkpoint", None):
            fp = checkpoint_fingerprint(args.checkpoint)
        if fp is None:
            fp = params_fingerprint(wl.params)
        ctx = plan_context(model_config=cfg, probe_batch=probe_batch, tol=tol,
                           ritz_iters=ritz_iters,
                           candidate_labels=tuple(label for label, _ in candidates))
        if not getattr(args, "reprobe", False):
            plan = load_plan(plan_path, fingerprint=fp, context=ctx)
            if plan is not None:
                print(
                    f"[auto-precision] reusing persisted plan {plan_path} "
                    f"(params fingerprint + context match, 0 probe HVPs): "
                    f"{plan.label} (err {plan.ritz_rel_err:.2e} at probe "
                    "time; --reprobe to re-measure)"
                )
    if plan is None:
        seed = getattr(args, "vector_seed", 0) + 101
        plan = auto_precision_plan(
            factory, wl.params, probe_batch,
            generator=torch.Generator().manual_seed(seed), tol=tol,
            ritz_iters=ritz_iters, candidates=candidates, log=print,
        )
        print(plan.describe())
        if plan_path:
            save_plan(plan_path, plan, fingerprint=fp, context=ctx, provenance={
                "vector_seed": getattr(args, "vector_seed", 0),
                "source": "cli.resolve_auto_precision",
                "checkpoint": getattr(args, "checkpoint", None),
                "device": str(next(iter(wl.params.values())).device),
            })
            print(f"[auto-precision] plan -> {plan_path}")
    setattr(args, attr, plan.hvp_precision)
    args.block_precision = plan.block_precision
    with torch.device("meta"):
        new_model = type(wl.model)(dataclasses.replace(cfg, **spec_to_overrides(plan.block_precision)))
    return dataclasses.replace(wl, model=new_model, loss_fn=factory(plan.block_precision))


def referee_loss_fn_for(args, wl: Workload) -> Optional[Callable]:
    """A clean-model loss for the fp32 referee arm of ``--precision_check``:
    None when no block precision is baked into the model (the probe's
    outer 'highest' then suffices), else the workload's model rebuilt with
    ``block_matmul_precision=None`` (the model's inner scopes would
    otherwise override the referee's outer precision, and both arms would
    run the low-precision blocks)."""
    if not getattr(args, "block_precision", None):
        return None
    return lm_loss_factory(wl, args)(None)
