"""Metric loggers, the program's spans, traces and their summaries."""

from hessian_llm_vision_tpu_torch.obs.loggers import (
    MultiLogger,
    PickleStatsLogger,
    TensorBoardLogger,
)
from hessian_llm_vision_tpu_torch.obs.timing import profile_trace, recording, span, span_trace
from hessian_llm_vision_tpu_torch.obs.trace_summary import (
    find_trace_file,
    print_trace_summary,
    span_breakdown,
    summarize_spans,
    summarize_trace,
)

__all__ = [
    "span",
    "recording",
    "span_trace",
    "profile_trace",
    "find_trace_file",
    "summarize_trace",
    "print_trace_summary",
    "span_breakdown",
    "summarize_spans",
    "TensorBoardLogger",
    "PickleStatsLogger",
    "MultiLogger",
]
