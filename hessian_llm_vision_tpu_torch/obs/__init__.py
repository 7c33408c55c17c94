"""Metric loggers, timers and trace summaries."""

from hessian_llm_vision_tpu_torch.obs.loggers import (
    MultiLogger,
    PickleStatsLogger,
    TensorBoardLogger,
)
from hessian_llm_vision_tpu_torch.obs.timing import HVPMeter, Timer, profile_trace
from hessian_llm_vision_tpu_torch.obs.trace_summary import (
    find_trace_file,
    print_trace_summary,
    summarize_trace,
)

__all__ = [
    "Timer",
    "HVPMeter",
    "profile_trace",
    "find_trace_file",
    "summarize_trace",
    "print_trace_summary",
    "TensorBoardLogger",
    "PickleStatsLogger",
    "MultiLogger",
]
