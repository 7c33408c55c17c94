"""lanczos_overhead_pct: the share of a Lanczos iteration's wall time
outside its matvec, over the window's iterations of a traced run: each
matvec timed by a span synchronised on both sides, each iteration from one
matvec's start to the next's.  Read where the driver hands the matvec to
the Lanczos loop (the in-core path)."""


def read(run):
    w = run.window
    n = min(len(w.matvec_s), len(w.iteration_s))
    if n == 0:
        return None
    return 100.0 * (1.0 - sum(w.matvec_s[:n]) / sum(w.iteration_s[:n]))
