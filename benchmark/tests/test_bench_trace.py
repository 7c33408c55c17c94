"""The device-trace reduction on synthetic traces: the union behind the
idle share, the GEMM share, the labelled idle gaps, lost rows refused."""

import pytest

from benchmark.harness import trace


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_union_of_overlapping_intervals():
    assert trace.merged([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    assert trace.merged([(5, 6), (0, 1), (1, 2)]) == [[0, 2], [5, 6]]
    assert trace.merged([]) == []


def test_reduce_busy_idle_gemm_and_gaps():
    events = [
        ev("ampere_sgemm_128x64_nn", 10, 30),         # 10..40
        ev("vectorized_elementwise_kernel", 35, 10),  # 35..45, overlaps
        ev("gemv2T_kernel_val", 60, 20),              # 60..80
        ev("Memcpy DtoH", 90, 5, cat="gpu_memcpy"),   # 90..95
        ev("cudaLaunchKernel", 44, 3, cat="cuda_runtime"),
        ev("cudaLaunchKernel", 52, 2, cat="cuda_runtime"),
        ev("cudaLaunchKernel", 54, 2, cat="cuda_runtime"),
        ev("ampere_sgemm_128x64_nn", 150, 10),        # outside the window
    ]
    spans = [("iteration", 0, 100), ("matvec", 0, 50)]
    out = trace.reduce_events(events, spans, 0, 100)
    us = 1e-6
    assert out["window_s"] == pytest.approx(100 * us)
    assert out["busy_s"] == pytest.approx(60 * us)       # 35 + 20 + 5
    assert out["work_s"] == pytest.approx(65 * us)
    assert out["gemm_s"] == pytest.approx(50 * us)
    assert out["device_ops"][0] == ["ampere_sgemm_128x64_nn", pytest.approx(30 * us)]
    gaps = dict((k, v) for k, v in out["idle_gaps"])
    # idle: 0..10 and 45..60 in the matvec (the second in a launch call),
    # 80..90 and 95..100 in the rest of the iteration
    assert gaps["matvec:host"] == pytest.approx(10 * us)
    assert gaps["matvec:cudaLaunchKernel"] == pytest.approx(15 * us)
    assert gaps["iteration:host"] == pytest.approx(15 * us)
    assert sum(gaps.values()) == pytest.approx(40 * us)


def launched(n_launches, n_kernels, n_copies=0):
    return ([ev("cudaLaunchKernel", i, 0.5, cat="cuda_runtime") for i in range(n_launches)]
            + [ev("k", 10 + i * 0.1, 0.05) for i in range(n_kernels)]
            + [ev("Memcpy DtoD", 60 + i * 0.1, 0.05, cat="gpu_memcpy") for i in range(n_copies)])


def test_lost_rows_are_refused():
    with pytest.raises(trace.TraceError):
        trace.reduce_events(launched(20, 1), [], 0, 100)
    # copies have no launch: they do not make up for lost kernel rows
    with pytest.raises(trace.TraceError):
        trace.reduce_events(launched(100, 60, n_copies=40), [], 0, 100)
    with pytest.raises(trace.TraceError):
        trace.reduce_events(launched(100, 97), [], 0, 100)


def test_a_whole_trace_counts_its_rows_and_launches():
    out = trace.reduce_events(launched(100, 98, n_copies=5), [], 0, 100)
    assert (out["rows"], out["launches"]) == (98, 100)
    # the driver's launches (cuBLAS's cuLaunchKernel) count beside the runtime's
    driver = [ev("cuLaunchKernel", 70 + i, 0.5, cat="cuda_driver") for i in range(10)]
    out = trace.reduce_events(launched(100, 108) + driver, [], 0, 200)
    assert (out["rows"], out["launches"]) == (108, 110)
    with pytest.raises(trace.TraceError):
        trace.reduce_events(launched(100, 100) + driver, [], 0, 200)
