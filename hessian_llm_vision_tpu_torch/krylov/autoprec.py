"""Auto precision (port of ``krylov/autoprec.py``): probe the checkpoint
and pick the fastest matmul precision whose extreme Ritz values stay
within the bar of an fp32 referee -- per run, not per model.

Low-precision curvature error depends on the checkpoint: a tier that
passes the 1e-3 extreme-Ritz bar at random init can fabricate the
extremes of a trained checkpoint, where curvature is orders of magnitude
larger.  The planner walks a cost-ordered ladder of candidate arms, probes
each with a short reorthogonalised Lanczos on one batch against the
referee, and returns the first arm within ``tol``, else the referee.

The ladder on the card.  The JAX ladder is mixed -> strict (blocks
"high", bf16x3) -> blocks-X6 + head "high" -> the "highest" referee.  On
the H100 "high", "highest" and the X6 preset are all IEEE fp32
(``models/precision.py``), so the strict and X6 rungs would equal the
referee.  :func:`default_candidates` is re-based on the card's tiers:

* mixed -- blocks "default" (bf16 operands, f32 sums), head and loss at
  the outer "high";
* blocks-TF32 + head "high" -- blocks ``TF32_TF32_F32``;
* then the planner's fallback to the "highest" (fp32) referee.

An arm whose tier map equals the referee's (every product at the
referee's tier) is not probed: its error is 0 by definition.  A failing
arm (a factory or a backend that raises) is skipped with a log line, not
fatal.

Methodology, as in the JAX package: reorthogonalised probes (``reorth``
on by default; the plain recurrence is chaotic at trained-checkpoint
conditioning), and the decision quantity is the worst extreme-Ritz error
against the referee.  Cost: ``ritz_iters`` + 1 HVPs per arm and for the
referee.  The probe runs on one batch: the dataset-mean operator is a
convex combination of per-batch Hessians.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from hessian_llm_vision_tpu_torch.models.precision import tier_of
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

BlockSpec = Union[None, str, Tuple[Optional[str], ...]]


@dataclasses.dataclass(frozen=True)
class PrecisionArm:
    """One probed candidate."""

    label: str
    block_precision: Any  # spec handed to the model builder (spec_to_overrides)
    hvp_precision: str  # outer precision of the HVP
    ritz_rel_err: float  # worst extreme-Ritz rel err vs referee
    seconds_per_hvp: float  # steady-state, this device, probe batch
    extremes: Tuple[float, float]  # (λmin, λmax) estimates


@dataclasses.dataclass(frozen=True)
class AutoPrecisionPlan:
    """The chosen configuration + the evidence for it."""

    block_precision: Any
    hvp_precision: str
    label: str
    ritz_rel_err: float
    referee_extremes: Tuple[float, float]
    arms: Tuple[PrecisionArm, ...]  # every candidate probed, in order

    def describe(self) -> str:
        lines = [
            f"auto precision plan: {self.label} "
            f"(extreme-Ritz err {self.ritz_rel_err:.2e} vs f32 referee)"
        ]
        for a in self.arms:
            lines.append(
                f"  probed {a.label}: err {a.ritz_rel_err:.2e}, "
                f"{a.seconds_per_hvp * 1e3:.0f} ms/HVP"
            )
        return "\n".join(lines)


def spec_to_overrides(spec) -> dict:
    """Map a candidate spec to model-config field overrides: ``None`` / str
    / tuple = a ``block_matmul_precision`` value; a dict passes through
    (op-type splits: ``attn_scores_precision``, ``attn_matmul_precision``,
    ``mlp_matmul_precision``)."""
    if isinstance(spec, dict):
        return dict(spec)
    return {"block_matmul_precision": spec}


#: the JAX package's bf16 6-pass preset; true fp32 on the card
X6 = "BF16_BF16_F32_X6"
#: TF32 tensor cores, the card's rung between bf16 and fp32
TF32 = "TF32_TF32_F32"


def default_candidates(fast: str = "default", escalate: str = "high"):
    """The card's cost-ordered ladder: mixed (blocks ``fast``) -> blocks
    TF32 + head ``escalate``; the planner falls back to the referee.  The
    JAX ladder's strict and blocks-X6 rungs are fp32 here, the referee's
    tier, so they are not in it."""
    return [
        ("mixed (all blocks 1-pass bf16)", fast),
        ("blocks-TF32 + head " + escalate, {"block_matmul_precision": TF32}),
    ]


def op_split_candidates(fast: str = "default", escalate: str = "high"):
    """1-pass op-type escalation arms, cheapest first (opt-in, as in the
    JAX package: none passed on its trained checkpoint)."""
    return [
        ("mixed+scores-" + escalate,
         {"block_matmul_precision": fast, "attn_scores_precision": escalate}),
        ("mixed+attn-" + escalate,
         {"block_matmul_precision": fast, "attn_matmul_precision": escalate}),
        ("mixed+mlp-" + escalate,
         {"block_matmul_precision": fast, "mlp_matmul_precision": escalate}),
    ]


def escalation_prefixes(n_layers: int) -> Tuple[int, ...]:
    """Escalation ladder: 0 (pure mixed), then 1, 2, 3, then half-depth."""
    cand = [0, 1, 2, 3, max(1, n_layers // 2)]
    out: List[int] = []
    for c in cand:
        c = min(c, n_layers)
        if c not in out and c < n_layers:
            out.append(c)
    return tuple(out)


def prefix_block_spec(
    n_layers: int, n_high: int, *, escalate: str = "high", fast: str = "default",
) -> BlockSpec:
    """Per-block spec: first ``n_high`` blocks escalated, rest fast."""
    if n_high <= 0:
        return fast
    if n_high >= n_layers:
        return escalate
    return tuple([escalate] * n_high + [fast] * (n_layers - n_high))


def _spec_tiers(spec) -> set:
    """The tiers named anywhere in a spec (None = inherit)."""
    tiers = set()
    for value in spec_to_overrides(spec).values():
        for p in (value if isinstance(value, (tuple, list)) else (value,)):
            tiers.add(tier_of(p))
    return tiers


def _same_map_as_referee(spec, hvp_precision: str, referee_precision: str) -> bool:
    """True when every product of the arm runs at the referee's tier."""
    ref = tier_of(referee_precision)
    return tier_of(hvp_precision) == ref and _spec_tiers(spec) <= {None, ref}


def _probe_arm(hv, v0, params, batch, ritz_iters: int, *, reorth: bool = True):
    """(extremes, steady seconds/HVP) for one candidate."""
    from hessian_llm_vision_tpu_torch.krylov.driver import _sync, _tiny_lanczos_extremes

    _sync(hv(v0, params, batch))  # warm-up, untimed
    t0 = time.perf_counter()
    extremes = _tiny_lanczos_extremes(hv, v0, params, batch, ritz_iters, reorth=reorth)
    return extremes, (time.perf_counter() - t0) / max(ritz_iters, 1)


def auto_precision_plan(
    make_loss_fn: Callable[[Any], Callable[[Any, Any], torch.Tensor]],
    params: Any,
    batch: Any,
    n_layers: Optional[int] = None,
    *,
    generator: Optional[torch.Generator] = None,
    vector: Optional[torch.Tensor] = None,
    flattener: Optional[Flattener] = None,
    tol: float = 1e-3,
    ritz_iters: int = 8,
    outer_precision: str = "high",
    referee_precision: str = "highest",
    escalate: str = "high",
    fast: str = "default",
    prefixes: Optional[Sequence[int]] = None,
    candidates: Optional[Sequence[Tuple[str, Any]]] = None,
    reorth: bool = True,
    log: Optional[Callable[[str], None]] = None,
) -> AutoPrecisionPlan:
    """Pick the fastest precision configuration meeting the parity bar.

    ``make_loss_fn(spec)`` returns the loss closure of the model rebuilt
    per :func:`spec_to_overrides` (``None`` = inherit the outer precision
    everywhere).  Candidates: an explicit ``candidates`` list of ``(label,
    spec)``, or ``prefixes`` for the depth ladder, or
    :func:`default_candidates`.  The first arm whose extreme-Ritz error
    against the referee is within ``tol`` wins; otherwise strict blocks
    (``None`` at ``outer_precision``) when that differs from the referee,
    and last the referee's own precision.  The probe vector is ``vector``
    or a draw from ``generator``.
    """
    from hessian_llm_vision_tpu_torch.krylov.driver import batch_hvp
    from hessian_llm_vision_tpu_torch.krylov.lanczos import start_vector

    if ritz_iters < 1:
        raise ValueError("ritz_iters must be >= 1")
    say = log or (lambda s: None)
    fl = flattener or Flattener(params)
    if (vector is None) == (generator is None):
        raise ValueError("pass exactly one of vector / generator")
    device = next(iter(params.values())).device
    if vector is None:
        vector = torch.randn(fl.size, generator=generator, device=generator.device)
    v0 = start_vector(vector.to(device), None, fl.size)

    ref_hv = batch_hvp(make_loss_fn(None), referee_precision, fl)
    ref_ext, ref_dt = _probe_arm(ref_hv, v0, params, batch, ritz_iters, reorth=reorth)
    del ref_hv
    scale = max(abs(ref_ext[0]), abs(ref_ext[1]), 1e-30)
    say(f"[auto-precision] referee ({referee_precision}): extremes "
        f"({ref_ext[0]:.4g}, {ref_ext[1]:.4g}), {ref_dt * 1e3:.0f} ms/HVP")

    def err_of(ext) -> float:
        return max(abs(ext[0] - ref_ext[0]), abs(ext[1] - ref_ext[1])) / scale

    arms: List[PrecisionArm] = []

    def try_arm(label: str, spec, hvp_prec: str) -> PrecisionArm:
        hv = batch_hvp(make_loss_fn(spec), hvp_prec, fl)
        ext, dt = _probe_arm(hv, v0, params, batch, ritz_iters, reorth=reorth)
        arm = PrecisionArm(label=label, block_precision=spec, hvp_precision=hvp_prec,
                           ritz_rel_err=err_of(ext), seconds_per_hvp=dt, extremes=ext)
        arms.append(arm)
        say(f"[auto-precision] {label}: err {arm.ritz_rel_err:.2e}, {dt * 1e3:.0f} ms/HVP"
            + (" -> PASS" if arm.ritz_rel_err <= tol else ""))
        return arm

    def plan_of(arm: PrecisionArm) -> AutoPrecisionPlan:
        return AutoPrecisionPlan(block_precision=arm.block_precision,
                                 hvp_precision=arm.hvp_precision, label=arm.label,
                                 ritz_rel_err=arm.ritz_rel_err, referee_extremes=ref_ext,
                                 arms=tuple(arms))

    if candidates is None:
        if prefixes is not None:
            candidates = [
                ("mixed (all blocks 1-pass bf16)" if b == 0
                 else f"mixed+escalate[h_0..h_{b - 1}]",
                 prefix_block_spec(n_layers, b, escalate=escalate, fast=fast))
                for b in prefixes
            ]
        else:
            candidates = default_candidates(fast=fast, escalate=escalate)
    tried_strict = False
    for label, spec in candidates:
        try:
            if _same_map_as_referee(spec, outer_precision, referee_precision):
                say(f"[auto-precision] {label}: the referee's tier map, not probed")
                continue
            arm = try_arm(label, spec, outer_precision)
        except Exception as e:  # e.g. a factory or backend that refuses the spec
            say(f"[auto-precision] {label}: SKIPPED ({type(e).__name__}: {e})")
            continue
        tried_strict = tried_strict or spec is None or spec == escalate
        if arm.ritz_rel_err <= tol:
            return plan_of(arm)

    # strict fallback: every block escalated, outer precision unchanged
    # (skipped when probed already, or when it is the referee's map)
    if not tried_strict and not _same_map_as_referee(None, outer_precision, referee_precision):
        arm = try_arm(f"strict (all blocks {escalate})", None, outer_precision)
        if arm.ritz_rel_err <= tol:
            return plan_of(arm)

    say("[auto-precision] no cheaper arm met the bar; "
        f"falling back to {referee_precision}")
    return AutoPrecisionPlan(
        block_precision=None,
        hvp_precision=referee_precision,
        label=f"referee fallback ({referee_precision})",
        ritz_rel_err=0.0,
        referee_extremes=ref_ext,
        arms=tuple(arms),
    )
