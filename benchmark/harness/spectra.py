"""What the spectrum drivers share: the closed loop of spectra over the
window, and the comparisons of their tridiagonals with the reference's."""

from __future__ import annotations

import torch

from benchmark.harness import inputs


class Boundaries:
    """Iteration boundaries of the jobs in the window: a driver calls
    :meth:`start` as each iteration begins, or :meth:`end` as it ends."""

    def __init__(self, window):
        self.window = window
        self.issued = 0

    def start(self) -> None:
        self.window.boundary(self.issued)
        self.issued += 1

    def end(self) -> None:
        self.issued += 1
        self.window.boundary(self.issued)


def loop(run, shapes: dict, spectrum) -> tuple:
    """Spectra back to back, each from the next seeded start vector, until
    the window (and a traced run's trace) is done.  ``spectrum(v0, marks)``
    runs one job, calling ``marks.start()`` or ``marks.end()`` at each
    iteration (:class:`Boundaries`), and returns ``(alphas, betas,
    extra)``.  Returns ``[(index, alphas, betas)]`` of every finished job,
    on the host in float64, and the last job's ``extra`` (each job's is
    dropped before the next job starts)."""
    w = run.window
    marks = Boundaries(w)
    out, j, extra = [], 0, None
    w.start()
    while not w.finished:
        extra = None
        a, b, extra = spectrum(inputs.start_vector(run.seed, j, shapes, run.device), marks)
        out.append((j, a.detach().cpu().double(), b.detach().cpu().double()))
        w.job_end(marks.issued)
        j += 1
    return out, extra


def tally(run, spectra: list, iters: int) -> None:
    """``attempted``: the window's iterations; ``failed``: those whose alpha
    or beta is not finite."""
    n = run.window.iterations
    bad = 0
    for g in range(n):
        _, a, b = spectra[g // iters]
        i = g % iters
        vals = [a[i]] + ([b[i]] if i < len(b) else [])
        bad += not all(torch.isfinite(v) for v in vals)
    run.attempted, run.failed = n, bad


def t_gap(a, b, ra, rb, m: int) -> float:
    """Largest gap of the first ``m`` alphas and betas from the reference's,
    over the largest of the reference's (the scale of T).  A job of ``n``
    steps has ``n - 1`` betas: where ``m`` is ``n``, ``m - 1`` are compared."""
    ra, rb = ra.double().cpu(), rb.double().cpu()
    k = min(m, len(b))
    gaps = [(a[:m] - ra[:m]).abs().max(), (b[:k] - rb[:k]).abs().max()]
    scale = max(ra[:m].abs().max(), rb[:k].abs().max())
    return float(max(gaps) / scale)
