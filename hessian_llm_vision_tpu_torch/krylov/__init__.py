"""Krylov solvers on flat f32 vectors, under the JAX package's names."""

from hessian_llm_vision_tpu_torch.krylov.autoprec import (
    AutoPrecisionPlan,
    PrecisionArm,
    auto_precision_plan,
    default_candidates,
    escalation_prefixes,
    op_split_candidates,
    prefix_block_spec,
    spec_to_overrides,
)
from hessian_llm_vision_tpu_torch.krylov.cg import CGResult, cg_solve
from hessian_llm_vision_tpu_torch.krylov.compare import (
    density_overlap,
    ritz_relative_error,
    subspace_overlap,
    summarize,
    wasserstein_distance,
)
from hessian_llm_vision_tpu_torch.krylov.deflate import (
    DeflatedDensity,
    deflated_density,
    deflated_matvec,
)
from hessian_llm_vision_tpu_torch.krylov.driver import (
    dataset_spectrum_host,
    dataset_thick_restart_host,
    layerwise_spectrum_host,
    linearized_spectrum_host,
    matvec_precision_probe,
)
from hessian_llm_vision_tpu_torch.krylov.host_lanczos import lanczos_host_basis
from hessian_llm_vision_tpu_torch.krylov.kpm import (
    KPMDensity,
    estimate_spectral_range,
    kpm_density,
)
from hessian_llm_vision_tpu_torch.krylov.lanczos import (
    LanczosResult,
    lanczos,
    lanczos_checkpointed,
)
from hessian_llm_vision_tpu_torch.krylov.power import power_iteration
from hessian_llm_vision_tpu_torch.krylov.precplan import (
    checkpoint_fingerprint,
    default_plan_path,
    load_plan,
    params_fingerprint,
    plan_context,
    save_plan,
)
from hessian_llm_vision_tpu_torch.krylov.slq import (
    Spectrum,
    quadrature,
    ritz_decomposition,
    ritz_vectors,
    spectral_density,
    trace_estimate,
)
from hessian_llm_vision_tpu_torch.krylov.thick_restart import (
    ThickRestartResult,
    lanczos_thick_restart,
)
from hessian_llm_vision_tpu_torch.krylov.trace import hutchinson_trace, hutchpp_trace

__all__ = [
    "cg_solve",
    "CGResult",
    "power_iteration",
    "lanczos",
    "LanczosResult",
    "lanczos_checkpointed",
    "lanczos_thick_restart",
    "ThickRestartResult",
    "lanczos_host_basis",
    "dataset_spectrum_host",
    "dataset_thick_restart_host",
    "linearized_spectrum_host",
    "layerwise_spectrum_host",
    "AutoPrecisionPlan",
    "PrecisionArm",
    "auto_precision_plan",
    "checkpoint_fingerprint",
    "default_plan_path",
    "load_plan",
    "params_fingerprint",
    "plan_context",
    "save_plan",
    "default_candidates",
    "escalation_prefixes",
    "op_split_candidates",
    "prefix_block_spec",
    "spec_to_overrides",
    "matvec_precision_probe",
    "ritz_decomposition",
    "ritz_vectors",
    "trace_estimate",
    "quadrature",
    "spectral_density",
    "Spectrum",
    "hutchinson_trace",
    "hutchpp_trace",
    "KPMDensity",
    "estimate_spectral_range",
    "kpm_density",
    "DeflatedDensity",
    "deflated_density",
    "deflated_matvec",
    "ritz_relative_error",
    "density_overlap",
    "wasserstein_distance",
    "subspace_overlap",
    "summarize",
]
