"""gemm_share_pct: the share of the device's kernel time in the traced
iterations spent in matrix-product kernels (cuBLAS and CUTLASS names), %."""


def read(run):
    t = run.window.trace
    if not t or not t["work_s"]:
        return None
    return 100.0 * t["gemm_s"] / t["work_s"]
