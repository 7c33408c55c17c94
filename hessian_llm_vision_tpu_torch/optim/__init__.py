"""Optimizers: SGD, Adam and raw SGD update rules, LR schedules,
host-driven LanczosSGD and its refresh-precision guard.  The JAX
package's names, where the port has them (the fused and layerwise
LanczosSGD steps, projection and second-order steps come with A8b)."""

from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import LanczosSGDConfig
from hessian_llm_vision_tpu_torch.optim.manual import manual_adam, raw_sgd, sgd_momentum
from hessian_llm_vision_tpu_torch.optim.precision_guard import (
    GuardEvent,
    GuardTier,
    RefreshPrecisionGuard,
    default_tiers,
    tier_index_for,
)
from hessian_llm_vision_tpu_torch.optim.schedules import constant, linear_decay

__all__ = [
    "sgd_momentum",
    "manual_adam",
    "raw_sgd",
    "linear_decay",
    "constant",
    "LanczosSGDConfig",
    "GuardEvent",
    "GuardTier",
    "RefreshPrecisionGuard",
    "default_tiers",
    "tier_index_for",
]
