"""Optimizers: SGD, Adam and raw SGD update rules, LR schedules,
LanczosSGD (fused, layer-wise and host-driven), the frozen-spectrum
transforms, Gauss-Newton and natural-gradient steps, and the refresh
precision guard, under the JAX package's names."""

from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import (
    LanczosSGDConfig,
    LanczosSGDState,
    make_lanczos_sgd_step,
    make_layerwise_lanczos_sgd_step,
)
from hessian_llm_vision_tpu_torch.optim.manual import chain, manual_adam, raw_sgd, sgd_momentum
from hessian_llm_vision_tpu_torch.optim.precision_guard import (
    GuardEvent,
    GuardTier,
    RefreshPrecisionGuard,
    default_tiers,
    tier_index_for,
)
from hessian_llm_vision_tpu_torch.optim.projection import (
    frozen_spectral_adjust,
    project_gradients,
)
from hessian_llm_vision_tpu_torch.optim.schedules import constant, linear_decay
from hessian_llm_vision_tpu_torch.optim.second_order import (
    make_gauss_newton_step,
    make_natural_gradient_step,
)

__all__ = [
    "sgd_momentum",
    "manual_adam",
    "raw_sgd",
    "chain",
    "linear_decay",
    "constant",
    "LanczosSGDConfig",
    "LanczosSGDState",
    "make_lanczos_sgd_step",
    "make_layerwise_lanczos_sgd_step",
    "project_gradients",
    "frozen_spectral_adjust",
    "make_gauss_newton_step",
    "make_natural_gradient_step",
    "GuardEvent",
    "GuardTier",
    "RefreshPrecisionGuard",
    "default_tiers",
    "tier_index_for",
]
