"""device_idle_pct: the share of the traced iterations' wall time in which
no operation ran on the device: 100 x (1 - busy / window), busy the union
of the device rows' intervals."""


def read(run):
    if not run.busy_s or not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
