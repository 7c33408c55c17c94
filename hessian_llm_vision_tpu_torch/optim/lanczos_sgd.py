"""LanczosSGD configuration (port of ``optim/lanczos_sgd.py``).

Per step: gradient -> grad-seeded k-step Lanczos on the batch Hessian ->
Ritz pairs (λᵢ, vᵢ) -> ``g ← g + Σᵢ (1/λᵢ − 1/(λᵢ+δ))(vᵢ·g)vᵢ`` -> SGD
with momentum and weight decay.  ``refresh_every=N`` with
``lanczos_momentum=m`` recomputes the eigenspace every N steps and blends
it ``V ← m·V_old + (1−m)·V_new`` (the same for eigenvalues).

Only the host-driven trainer (``optim/lanczos_sgd_host.py``) is ported;
the fused single-program step waits for a later slice.
"""

from __future__ import annotations

import dataclasses

from hessian_llm_vision_tpu_torch.optim.manual import ScheduleOrFloat


@dataclasses.dataclass(frozen=True)
class LanczosSGDConfig:
    k: int = 10
    delta: float = 1e-4
    lr: ScheduleOrFloat = 1e-3
    momentum: float = 0.9
    weight_decay: float = 0.0
    refresh_every: int = 1
    lanczos_momentum: float = 0.0
    accum_steps: int = 1
    normalization: str = "sum"  # HVP scaling; "sum" == loss *= batch_size
    remat: bool = False
