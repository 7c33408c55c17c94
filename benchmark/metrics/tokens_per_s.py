"""tokens_per_s: tokens through the cell's unit of work, over the window's
whole length (in a spectrum cell, the rows x positions of every curvature
product of every iteration the window holds)."""


def read(run):
    w = run.window
    if not w.iterations or not run.tokens_per_iteration:
        return None
    return w.iterations * run.tokens_per_iteration / w.seconds_measured
