"""The port's host spans (``obs/timing.py``) and their charge of a CUDA
trace (``obs/trace_summary.py::span_breakdown``), on the CPU: a span off
records nothing; spans nest in order; every Lanczos loop records one
``lanczos.matvec`` holding its ``hvp`` and one ``lanczos.update`` an
iteration, with bit-identical alphas, betas and basis whether recording is
on or off; device rows go to the span that launched them (synthetic
traces), on a clock put back by two anchors."""

import json

import pytest
import torch

from hessian_llm_vision_tpu_torch.curvature.hvp import hvp_fn
from hessian_llm_vision_tpu_torch.krylov import driver
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos, lanczos_checkpointed
from hessian_llm_vision_tpu_torch.obs import timing
from hessian_llm_vision_tpu_torch.obs.trace_summary import span_breakdown, summarize_spans
from hessian_llm_vision_tpu_torch.parallel.mesh import basis_sharding, make_mesh
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

ITERS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_span_off_records_nothing_and_returns_the_block():
    sp = timing.span("x")

    def block():
        with sp:
            return 42

    assert block() == 42
    assert timing._records is None and sp._open == []
    with timing.recording() as rec:
        pass
    assert rec == []


def test_spans_nest_in_order():
    a, b, c = timing.span("a"), timing.span("b"), timing.span("c")
    with timing.recording() as rec:
        with a:
            with b:
                with a:  # a span may nest in itself
                    pass
        with c:
            pass
    assert [r[0] for r in rec] == ["a", "b", "a", "c"]
    inner_a, b_rec, outer_a, c_rec = rec
    assert outer_a[1] <= b_rec[1] <= inner_a[1] <= inner_a[2] <= b_rec[2] <= outer_a[2]
    assert outer_a[2] <= c_rec[1] <= c_rec[2]
    assert timing._records is None and a._open == b._open == []
    # an inner recording takes its block's spans; the outer one the rest
    with timing.recording() as outer:
        with a:
            with timing.recording() as inner:
                with b:
                    pass
    assert [r[0] for r in outer] == ["a"] and [r[0] for r in inner] == ["b"]
    # a span still open when its recording ends is recorded nowhere
    rec_ctx = timing.recording()
    rec = rec_ctx.__enter__()
    a.__enter__()
    rec_ctx.__exit__(None, None, None)
    a.__exit__(None, None, None)
    assert rec == [] and a._open == [] and timing._records is None


def _problem():
    g = torch.Generator().manual_seed(0)
    params = {"w1": torch.randn(5, 4, generator=g), "w2": torch.randn(4, generator=g)}
    x = torch.randn(8, 5, generator=g)
    y = torch.randn(8, generator=g)

    def loss(p, batch):
        return ((torch.tanh(batch["x"] @ p["w1"]) @ p["w2"] - batch["y"]) ** 2).mean()

    return loss, params, {"x": x, "y": y}


def _flat_matvec(loss, params, batch):
    fl = Flattener(params)
    hv = hvp_fn(loss, precision=None)
    return fl, lambda v: fl.flatten(hv(params, batch, fl.unflatten(v)))


def _check_spans(rec, iters):
    """One ``lanczos.matvec`` holding at least one ``hvp``, then one
    ``lanczos.update``, each iteration, in order."""
    names = [r[0] for r in rec]
    assert names.count("lanczos.matvec") == names.count("lanczos.update") == iters
    loops = [r for r in rec if r[0].startswith("lanczos.")]
    assert [r[0] for r in loops] == ["lanczos.matvec", "lanczos.update"] * iters
    for mv, up in zip(loops[::2], loops[1::2]):
        assert mv[2] <= up[1]
        inside = [r for r in rec if r[0] == "hvp" and mv[1] <= r[1] <= r[2] <= mv[2]]
        assert inside
    assert all(any(m[1] <= h[1] <= h[2] <= m[2] for m in loops[::2])
               for h in rec if h[0] == "hvp")


def _run(fn):
    off = fn()
    with timing.recording() as rec:
        on = fn()
    return off, on, rec


def _same(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("loop", ["lanczos_cgs2", "lanczos_sharded", "checkpointed",
                                  "dataset_host", "fused_host", "bigmodel"])
def test_every_lanczos_loop_spans_each_iteration_and_is_bit_identical(loop):
    loss, params, batch = _problem()
    fl, mv = _flat_matvec(loss, params, batch)
    v0 = torch.randn(fl.size, generator=torch.Generator().manual_seed(1))
    if loop == "lanczos_cgs2":
        fn = lambda: tuple(lanczos(mv, fl.size, ITERS, v0=v0, reorth=True))  # noqa: E731
    elif loop == "lanczos_sharded":
        sharding = basis_sharding(make_mesh())
        fn = lambda: tuple(lanczos(mv, fl.size, ITERS, v0=v0, reorth=True,  # noqa: E731
                                   basis_sharding=sharding))
    elif loop == "checkpointed":
        seen = []
        fn = lambda: tuple(lanczos_checkpointed(  # noqa: E731
            mv, fl.size, ITERS, v0=v0, callback=lambda i, a, b: seen.append(i)))
    elif loop == "dataset_host":
        fn = lambda: tuple(driver.dataset_spectrum_host(  # noqa: E731
            loss, params, [batch, batch], ITERS, v0=v0, batch_size=8, precision=None))
    elif loop == "fused_host":
        fn = lambda: tuple(driver.single_batch_spectrum_host_fused(  # noqa: E731
            loss, params, batch, ITERS, v0=v0, precision=None))
    else:
        tree = fl.unflatten(v0)
        fn = lambda: tuple(driver.bigmodel_spectrum_host(  # noqa: E731
            loss, params, batch, ITERS, v0=tree, precision=None, q_dtype=torch.bfloat16))
    off, on, rec = _run(fn)
    _same(off, on)
    assert on[0].shape == (ITERS,) and torch.isfinite(on[0]).all()
    _check_spans(rec, ITERS)
    if loop == "dataset_host":  # two batches: two products in each matvec
        assert [r[0] for r in rec].count("hvp") == 2 * ITERS


def test_the_callback_is_outside_the_iteration_spans():
    loss, params, batch = _problem()
    fl, mv = _flat_matvec(loss, params, batch)
    v0 = torch.randn(fl.size, generator=torch.Generator().manual_seed(2))
    calls = []
    with timing.recording() as rec:
        driver.bigmodel_spectrum_host(loss, params, batch, 3, v0=fl.unflatten(v0),
                                      precision=None,
                                      callback=lambda i, a, b: calls.append(len(rec)))
    # each callback runs after its iteration's spans closed, before the next opened
    ends = [k + 1 for k, r in enumerate(rec) if r[0] == "lanczos.update"]
    assert calls == ends


# ----------------------------------------------------------- span_breakdown

def ev(name, ts, dur, cat, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, name="cudaLaunchKernel", cat="cuda_runtime"):
    return ev(name, ts, 2, cat, corr)


def kernel(name, ts, dur, corr, cat="kernel"):
    return ev(name, ts, dur, cat, corr)


# A trace on the trace's clock (µs): a warm-up launch at 990, the opening
# synchronisation 1000..1003; then a matvec 1005..1055 holding an hvp
# 1010..1050, and an update 1055..1080; the closing synchronisation
# 1093..1200.  The host clock (ns) is ahead of the trace's by OFFSET_US and
# runs 5% fast: a map from one anchor alone would put the hvp span's end
# past the copy's call at 1052.
OFFSET_US, DRIFT = 5_000_000.0, 0.05


def host_ns(trace_us):
    """The host clock (ns) at a time on the trace's clock (µs)."""
    return round((trace_us + OFFSET_US) * 1e3 * (1 + DRIFT))


SPANS_US = [("hvp", 1010, 1050), ("lanczos.matvec", 1005, 1055),
            ("lanczos.update", 1055, 1080)]


def sync(ts, dur, corr):
    return ev("cudaDeviceSynchronize", ts, dur, "cuda_runtime", corr)


def trace_events():
    return [
        launch(990, 1),                                    # the warm-up
        kernel("fill", 992, 1, 1),
        sync(1000, 3, 20),                                 # the opening anchor
        launch(1006, 11),                                  # in the matvec, not in hvp
        kernel("cast", 1007, 4, 11),                       # 1007..1011
        launch(1012, 2),                                   # in hvp
        kernel("sgemm", 1014, 30, 2),                      # 1014..1044
        launch(1020, 3, name="cuLaunchKernel", cat="cuda_driver"),
        kernel("xmma_gemm", 1044, 10, 3),                  # 1044..1054
        ev("cudaMemcpyAsync", 1052, 3, "cuda_runtime", 4),  # in the matvec, not in hvp
        kernel("Memcpy DtoD", 1056, 4, 4, cat="gpu_memcpy"),  # runs in the update
        launch(1060, 5),                                   # in the update
        launch(1070, 6),                                   # in the update
        kernel("dot", 1061, 20, 5),                        # 1061..1081
        kernel("axpy", 1085, 5, 6),                        # runs after the update
        kernel("stray", 1095, 1, 99),                      # no call in the trace
        sync(1093, 107, 7),                                # the closing anchor
        kernel("late", 1300, 5, 8),                        # no call, after the block
    ]


def breakdown(spans_us=SPANS_US, events=None):
    spans = [(n, host_ns(a), host_ns(b)) for n, a, b in spans_us]
    return span_breakdown(trace_events() if events is None else events, spans,
                          host_ns(1000), host_ns(1093))


def test_rows_are_charged_to_the_span_that_launched_them():
    out = breakdown()
    sp = out["spans"]
    us = 1e-6
    assert sp["hvp"]["device_s"] == pytest.approx(40 * us)        # sgemm + xmma
    assert sp["hvp"]["launches"] == 2
    # the cast, and the copy that ran in the update but was issued in the matvec
    assert sp["lanczos.matvec"]["device_s"] == pytest.approx(8 * us)
    assert sp["lanczos.matvec"]["launches"] == 1
    # the axpy runs after the update closed (and would run during a next
    # hvp): it is the update's all the same
    assert sp["lanczos.update"]["device_s"] == pytest.approx(25 * us)
    assert sp["lanczos.update"]["launches"] == 2
    # a row with no call in the trace; not the warm-up's
    assert sp["outside_spans"]["device_s"] == pytest.approx(1 * us)
    assert (sp["hvp"]["count"], sp["lanczos.matvec"]["count"]) == (1, 1)
    assert sp["lanczos.update"]["host_s"] == pytest.approx(25 * (1 + DRIFT) * us, rel=1e-6)
    assert out["launches"] == 5 and out["rows"] == 6


def test_idle_time_goes_to_the_span_in_force():
    out = breakdown()
    us = 1e-6
    sp = out["spans"]
    # window 1003..1200; busy 1007..1011, 1014..1054, 1056..1060 (copy),
    # 1061..1081, 1085..1090, 1095..1096; a gap goes where it starts
    assert out["window_s"] == pytest.approx(197 * us)
    assert out["busy_s"] == pytest.approx((4 + 40 + 4 + 20 + 5 + 1) * us)
    assert sp["hvp"]["idle_s"] == pytest.approx(3 * us)             # 1011..1014
    assert sp["lanczos.matvec"]["idle_s"] == pytest.approx(2 * us)  # 1054..1056
    assert sp["lanczos.update"]["idle_s"] == pytest.approx(1 * us)  # 1060..1061
    assert sp["outside_spans"]["idle_s"] == pytest.approx((4 + 4 + 5 + 104) * us)
    gaps = dict(out["idle_gaps"])
    assert gaps["hvp:host"] == pytest.approx(3 * us)
    assert gaps["lanczos.matvec:cudaMemcpyAsync"] == pytest.approx(2 * us)
    assert gaps["lanczos.update:cudaLaunchKernel"] == pytest.approx(1 * us)
    assert gaps["outside_spans:host"] == pytest.approx(13 * us)  # 1003..1007, 1081..1085, 1090..1095
    assert gaps["outside_spans:cudaDeviceSynchronize"] == pytest.approx(104 * us)
    assert sum(gaps.values()) == pytest.approx(out["window_s"] - out["busy_s"])


def test_two_anchors_recover_offset_and_drift():
    out = breakdown()
    a = out["anchors"]
    assert a["open_offset_us"] == pytest.approx(1000 - host_ns(1000) / 1e3)
    assert a["close_offset_us"] == pytest.approx(1093 - host_ns(1093) / 1e3)
    # the offset between the clocks grows by the drift over the 93 µs between
    assert a["difference_us"] == pytest.approx(-93 * DRIFT, abs=2e-3)
    # a span 1 µs inside the hvp boundary on the trace's clock is placed there:
    # a shift of 2 µs would move the launch at 1012 out of it
    moved = [("hvp", 1011, 1050), ("lanczos.matvec", 1005, 1055),
             ("lanczos.update", 1055, 1080)]
    assert breakdown(moved)["spans"]["hvp"]["launches"] == 2
    moved[0] = ("hvp", 1013, 1050)
    assert breakdown(moved)["spans"]["hvp"]["launches"] == 1


def test_spans_change_no_window_total():
    with_spans, without = breakdown(), breakdown(spans_us=[])
    for key in ("window_s", "busy_s", "work_s", "rows", "launches"):
        assert with_spans[key] == without[key]
    assert set(without["spans"]) == {"outside_spans"}
    assert without["spans"]["outside_spans"]["device_s"] == pytest.approx(with_spans["work_s"])


def test_the_closing_anchor_is_the_first_synchronisation_after_the_last_launch():
    # one inside the hvp (before later launches), and the profiler's own as it stops
    more = trace_events() + [sync(1040, 1, 9), sync(1250, 5, 10)]
    assert breakdown(events=more)["anchors"] == breakdown()["anchors"]
    assert breakdown(events=more)["window_s"] == breakdown()["window_s"]


def test_the_window_holds_every_row_of_the_block():
    # device timestamps drifted late: the last row ends after the closing sync
    events = trace_events() + [launch(1075, 12), kernel("drifted", 1195, 10, 12)]
    out = breakdown(events=events)
    assert out["window_s"] == pytest.approx(202e-6)  # 1003..1205
    assert out["spans"]["lanczos.update"]["device_s"] == pytest.approx(35e-6)
    assert out["rows"] == 7 and out["launches"] == 6


def test_a_trace_without_its_anchors_is_refused(tmp_path):
    no_sync = [e for e in trace_events() if e["name"] != "cudaDeviceSynchronize"]
    with pytest.raises(ValueError, match="anchor"):
        breakdown(events=no_sync)
    with pytest.raises(ValueError, match="after its last launch"):
        breakdown(events=[e for e in trace_events() if e["ts"] != 1093])
    with pytest.raises(ValueError):
        timing.span_trace(torch.device("cpu"), str(tmp_path)).__enter__()


def test_a_trace_that_lost_kernel_rows_is_refused():
    # 44 launches in the update with 43 kernel rows: 49 rows for 49 launches
    launches = [launch(1060 + k * 0.2, 100 + k) for k in range(44)]
    rows = [kernel("k", 1061 + k * 0.2, 0.1, 100 + k) for k in range(43)]
    out = breakdown(events=trace_events() + launches + rows)
    assert (out["rows"], out["launches"]) == (49, 49)
    # one row fewer: 48 rows for 49 launches, below 98%
    with pytest.raises(ValueError, match="lost device rows: 48 kernel rows for 49"):
        breakdown(events=trace_events() + launches + rows[:-1])
    # copies do not make up for lost kernel rows
    copies = [ev("Memcpy DtoD", 1062, 1, "gpu_memcpy", 4) for _ in range(5)]
    with pytest.raises(ValueError, match="lost device rows"):
        breakdown(events=trace_events() + launches + rows[:-1] + copies)


def test_a_kept_trace_reads_back(tmp_path):
    spans = [(n, host_ns(a), host_ns(b)) for n, a, b in SPANS_US]
    data = {"traceEvents": trace_events(),
            "programSpans": {"open_ns": host_ns(1000), "close_ns": host_ns(1093),
                             "spans": spans}}
    (tmp_path / "trace.json").write_text(json.dumps(data))
    assert summarize_spans(str(tmp_path)) == breakdown()
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": trace_events()}))
    with pytest.raises(ValueError, match="programSpans"):
        summarize_spans(str(tmp_path))
