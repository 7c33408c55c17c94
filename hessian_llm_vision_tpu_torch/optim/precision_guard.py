"""In-training refresh-precision guard (port of
``optim/precision_guard.py``): keep the precision guarantee through
training, not only at its start.

Curvature fidelity depends on the checkpoint: a tier that passes the
extreme-Ritz bar at init can fabricate the extremes once training has
sharpened the landscape.  The guard watches a host LanczosSGD trainer's
refreshes with the measured probe
(:func:`krylov.driver.matvec_precision_probe`):

* **initial resolve** -- at the params training starts from (after
  ``--resume_state``), walk the cost-ordered ladder and take the first
  tier whose extreme-Ritz error against the fp32 referee is within the bar
  (``--refresh_precision auto``);
* **periodic re-probe** -- every ``recheck_every`` refreshes, re-measure
  the current tier at the current params;
* **growth trigger** -- a ``growth_factor`` x jump of the refresh λmax
  since the last probe forces a re-probe;
* **escalation** -- on a breach, move up the ladder (re-probing each rung)
  and swap the trainer's refresh HVP (``trainer.set_refresh_tier``).  It
  never de-escalates.

Every probe is a :class:`GuardEvent`.  The probe is reorthogonalised (its
CGS2 pass on the rank-k kernel pair on a card); the JAX guard probes with
the plain recurrence, which its own auto-precision planner finds chaotic
on trained checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class GuardTier:
    """One rung of the escalation ladder."""

    label: str
    loss_fn: Callable[[Any, Any], torch.Tensor]  # refresh loss (tier model)
    precision: str  # outer precision of the refresh HVP


@dataclasses.dataclass(frozen=True)
class GuardEvent:
    """One probe (and its verdict) in the guard's evidence trail."""

    step: int  # optimizer step at probe time
    refresh_index: int  # how many refreshes had run
    tier: str  # tier label probed
    ritz_rel_err: float
    passed: bool
    escalated_to: Optional[str]  # next tier label when breached, else None
    trigger: str  # "initial" | "periodic" | "growth"
    eig_max: Optional[float]  # refresh λmax at probe time (None pre-refresh)

    def describe(self) -> str:
        verdict = "PASS" if self.passed else "BREACH"
        tail = f" -> escalate to {self.escalated_to}" if self.escalated_to else ""
        return (
            f"[precision-guard] step {self.step} refresh {self.refresh_index} "
            f"({self.trigger}): {self.tier} extreme-Ritz err "
            f"{self.ritz_rel_err:.3e} {verdict}{tail}"
        )


def default_tiers(
    make_loss_fn: Optional[Callable[[Any], Callable]],
    fallback_loss_fn: Callable,
) -> List[GuardTier]:
    """The card's cost-ordered ladder as guard tiers.

    LM models (``make_loss_fn`` from ``cli.precision.lm_loss_factory``):
    mixed -> blocks-TF32 + head high -> highest, the
    ``krylov.autoprec.default_candidates`` ladder plus the referee rung.
    The JAX ladder's strict-high and blocks-X6 rungs are fp32 on the card,
    the referee's tier, so they collapse into the top rung.  Models with
    no block-precision surface: the fp32 rung alone (the JAX ladder's
    "high" and "highest" are both fp32 here).
    """
    from hessian_llm_vision_tpu_torch.krylov.autoprec import TF32

    if make_loss_fn is None:
        return [GuardTier("highest", fallback_loss_fn, "highest")]
    return [
        GuardTier("mixed (all blocks 1-pass bf16)", make_loss_fn("default"), "high"),
        GuardTier("blocks-TF32 + head high", make_loss_fn({"block_matmul_precision": TF32}),
                  "high"),
        GuardTier("highest (fp32 everywhere)", make_loss_fn(None), "highest"),
    ]


def tier_index_for(tiers: Sequence[GuardTier], refresh_precision: str) -> int:
    """Starting rung for a user-pinned ``--refresh_precision`` value.

    'default' / 'mixed' start at the cheapest rung.  'high' and 'highest'
    both start at the top: on the card they are fp32, the referee rung
    (the JAX package starts 'high' at its strict bf16x3 rung, which is
    that same fp32 rung here).  The guard only ever moves up.
    """
    if refresh_precision in ("high", "highest"):
        return len(tiers) - 1
    return 0


class RefreshPrecisionGuard:
    """Drift detection + auto-escalation for a host trainer's refreshes.

    ``probe_fn(tier, params, batch) -> ritz_rel_err`` defaults to
    :func:`krylov.driver.matvec_precision_probe` against
    ``referee_loss_fn`` at "highest", its probe vector drawn from a CPU
    generator seeded with ``seed`` (the same vector every probe); it is
    injectable for tests.
    """

    def __init__(
        self,
        tiers: Sequence[GuardTier],
        *,
        referee_loss_fn: Callable[[Any, Any], torch.Tensor],
        bar: float = 2e-3,
        recheck_every: int = 10,
        ritz_iters: int = 8,
        growth_factor: float = 4.0,
        seed: int = 0,
        start_index: int = 0,
        probe_fn: Optional[Callable] = None,
        log: Callable[[str], None] = print,
    ):
        if not tiers:
            raise ValueError("guard needs at least one tier")
        if not (0 <= start_index < len(tiers)):
            raise ValueError(f"start_index {start_index} out of range")
        self.tiers = list(tiers)
        self.index = start_index
        self.referee_loss_fn = referee_loss_fn
        self.bar = bar
        self.recheck_every = recheck_every
        self.ritz_iters = ritz_iters
        self.growth_factor = growth_factor
        self.seed = seed
        self._probe_fn = probe_fn
        self.log = log
        self.events: List[GuardEvent] = []
        self._eig_max_at_last_probe: Optional[float] = None

    @property
    def tier(self) -> GuardTier:
        return self.tiers[self.index]

    def _probe(self, params, batch) -> float:
        if self._probe_fn is not None:
            return float(self._probe_fn(self.tier, params, batch))
        from hessian_llm_vision_tpu_torch.krylov.driver import matvec_precision_probe

        stats = matvec_precision_probe(
            self.tier.loss_fn, params, batch,
            generator=torch.Generator().manual_seed(self.seed),
            precision=self.tier.precision,
            referee_loss_fn=self.referee_loss_fn,
            ritz_iters=self.ritz_iters,
            reorth=True,
        )
        return float(stats["ritz_rel_err"])

    def _walk(self, trainer, params, batch, *, step: int, refresh_index: int,
              trigger: str, eig_max: Optional[float]) -> GuardTier:
        """Probe the current rung; escalate (re-probing) until pass/top."""
        self._eig_max_at_last_probe = eig_max
        while True:
            err = self._probe(params, batch)
            passed = err <= self.bar
            at_top = self.index >= len(self.tiers) - 1
            escalate = not passed and not at_top
            ev = GuardEvent(
                step=step, refresh_index=refresh_index, tier=self.tier.label,
                ritz_rel_err=err, passed=passed,
                escalated_to=self.tiers[self.index + 1].label if escalate else None,
                trigger=trigger, eig_max=eig_max,
            )
            self.events.append(ev)
            self.log(ev.describe())
            if passed:
                break
            if at_top:
                self.log(
                    "[precision-guard] WARNING: top tier "
                    f"{self.tier.label} still errs {err:.3e} > "
                    f"{self.bar:g} — refreshes keep the referee-grade tier"
                )
                break
            self.index += 1
            if trainer is not None:
                trainer.set_refresh_tier(self.tier)
        return self.tier

    def resolve_initial(self, trainer, params, batch, *, step: int = 0):
        """Walk the ladder at the actual starting params (post-resume)."""
        tier = self._walk(trainer, params, batch, step=step, refresh_index=0,
                          trigger="initial", eig_max=None)
        if trainer is not None:
            trainer.set_refresh_tier(tier)  # apply even when rung 0 passes
        return tier

    def maybe_recheck(self, trainer, params, batch, *, step: int, refresh_index: int,
                      eig_max: Optional[float]) -> bool:
        """Called by the trainer at every refresh boundary (pre-refresh);
        True when a probe ran.  ``eig_max`` is the λmax the previous
        refresh produced (the sharpening signal)."""
        periodic = (self.recheck_every > 0 and refresh_index > 0
                    and refresh_index % self.recheck_every == 0)
        grown = (eig_max is not None and self._eig_max_at_last_probe is not None
                 and self._eig_max_at_last_probe > 0
                 and eig_max / self._eig_max_at_last_probe >= self.growth_factor)
        if eig_max is not None and self._eig_max_at_last_probe is None:
            # first refresh after a pre-refresh probe: baseline the signal
            self._eig_max_at_last_probe = eig_max
        if not (periodic or grown):
            return False
        self._walk(trainer, params, batch, step=step, refresh_index=refresh_index,
                   trigger="growth" if grown else "periodic", eig_max=eig_max)
        return True

    def summary(self) -> dict:
        """JSON-safe evidence trail (saved next to training stats)."""
        return {
            "bar": self.bar,
            "recheck_every": self.recheck_every,
            "growth_factor": self.growth_factor,
            "final_tier": self.tier.label,
            "final_precision": self.tier.precision,
            "escalations": sum(1 for e in self.events if e.escalated_to is not None),
            "events": [dataclasses.asdict(e) for e in self.events],
        }
