"""hvp_mfu: the curvature products' model FLOPs done in the window
(``flop_counts.hvp_flops`` from the configuration's shapes), over the
window's length times the card's f32 peak outside the tensor cores, in %.
A share of the whole step: every other piece of an iteration is in the
window's time."""

from benchmark.metrics.flop_counts import H100_FP32_FLOPS


def read(run):
    w = run.window
    if run.device.type != "cuda" or not w.iterations or not run.flops_per_iteration:
        return None
    return 100.0 * w.iterations * run.flops_per_iteration / (w.seconds_measured * H100_FP32_FLOPS)
