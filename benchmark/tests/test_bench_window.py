"""The window: it closes at the first boundary at or after its length,
holds whole iterations, and a traced run profiles the next ones."""

import time

import torch

from benchmark.harness.window import Window


def fake_job(window, iters, step_s, marks):
    for _ in range(iters):
        marks.append(window.state)
        window.boundary(len(marks) - 1)
        time.sleep(step_s)
    window.job_end(len(marks))


def test_closes_at_the_first_boundary_after_its_length():
    w = Window(0.05, torch.device("cpu"))
    w.start()
    issued = 0
    while not w.finished:
        w.boundary(issued)
        if w.finished:
            break
        time.sleep(0.012)
        issued += 1
    assert w.seconds_measured >= 0.05
    # the window holds the iterations issued before the closing boundary,
    # and the boundary before it came earlier than the length
    assert w.iterations == issued
    assert (w.iterations - 1) * 0.012 < 0.05 + 0.012


def test_traced_run_profiles_the_next_iterations():
    w = Window(0.03, torch.device("cpu"), trace_iters=2)
    w.start()
    issued, states = 0, []
    while not w.finished:
        w.boundary(issued)
        states.append(w.state)
        if w.finished:
            break
        time.sleep(0.01)
        issued += 1
    closed_at = w.iterations
    assert issued == closed_at + 2  # two more iterations were traced
    assert w.trace is not None and w.trace["window_s"] > 0.015


def test_trace_ends_with_the_job():
    w = Window(0.0, torch.device("cpu"), trace_iters=5)
    w.start()
    w.boundary(0)          # closes at once, tracing from 0
    assert w.state == "tracing"
    time.sleep(0.01)
    w.job_end(1)           # the job ended after one traced iteration
    assert w.finished and w.trace is not None


def test_matvec_spans_in_a_traced_window():
    w = Window(10.0, torch.device("cpu"), trace_iters=1)
    w.start()
    for i in range(3):
        w.mark_iteration()
        w.matvec_span(time.sleep, 0.01)
    assert len(w.matvec_s) == 3 and len(w.iteration_s) == 2
    assert all(m >= 0.01 for m in w.matvec_s)
