"""Tree-structured Parzen Estimator for the HPO CLI (port of
``utils/tpe.py``).

The sampler of the HPO CLI when optuna is not installed: the TPE algorithm
of Bergstra et al., "Algorithms for Hyper-Parameter Optimization" (NeurIPS
2011), independent per dimension as in optuna's default:

1. split the observed trials at the γ-quantile of loss into a good and a
   bad set;
2. fit a Parzen (Gaussian-kernel) density to each set, plus one
   range-wide prior kernel for exploration;
3. draw candidates from the good density l(x) and keep the one that
   maximises l(x)/g(x).

The space is ``{name: (kind, lo, hi)}`` with kind "int", "float" or
"log"; log parameters are modelled in log space.  Pure Python on the
standard library's ``random``, so for the same space, seed and history it
suggests exactly the JAX package's points.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence, Tuple

Space = Dict[str, Tuple[str, float, float]]


def _to_internal(kind: str, v: float) -> float:
    return math.log(v) if kind == "log" else float(v)


def _from_internal(kind: str, t: float, lo: float, hi: float) -> float:
    v = math.exp(t) if kind == "log" else t
    v = min(max(v, lo), hi)
    if kind == "int":
        v = int(min(max(int(round(v)), lo), hi))
    return v


class _Parzen:
    """1-d Gaussian mixture over observations in a bounded range, with one
    range-wide prior kernel (g(x) > 0 everywhere, and the sampler keeps
    exploring)."""

    def __init__(self, obs: Sequence[float], lo: float, hi: float):
        self.lo, self.hi = lo, hi
        width = hi - lo
        n = len(obs)
        # sorted once and walked by position, so duplicates (routine for int
        # params such as k) each see their own neighbours; the edge kernels
        # see virtual neighbours at lo and hi, as in optuna
        srt = sorted(float(x) for x in obs)
        self.mus = srt + [(lo + hi) / 2.0]
        # bandwidth: the wider neighbour gap, floored so that kernels never
        # collapse (duplicates have a zero gap and land on the floor)
        floor = width / max(min(100.0, n + 1.0), 1.0)
        sigmas = []
        for i in range(n):
            left = srt[i] - (srt[i - 1] if i > 0 else lo)
            right = (srt[i + 1] if i < n - 1 else hi) - srt[i]
            sigmas.append(min(max(max(left, right), floor), width))
        self.sigmas = sigmas + [width]  # the prior kernel spans the range
        self.w = 1.0 / len(self.mus)

    def sample(self, rng: random.Random) -> float:
        i = rng.randrange(len(self.mus))
        for _ in range(100):
            x = rng.gauss(self.mus[i], self.sigmas[i])
            if self.lo <= x <= self.hi:
                return x
        return rng.uniform(self.lo, self.hi)

    def logpdf(self, x: float) -> float:
        tot = 0.0
        for mu, s in zip(self.mus, self.sigmas):
            z = (x - mu) / s
            tot += self.w * math.exp(-0.5 * z * z) / (s * math.sqrt(2 * math.pi))
        return math.log(max(tot, 1e-300))


class TPESampler:
    """``suggest(trials)`` proposes the next point given the history, a
    list of ``{"params": {...}, "loss": float}`` (the HPO CLI's study
    format).  Failed trials (loss inf) always join the bad split; the first
    ``n_startup`` suggestions are uniform random, as in optuna's TPE."""

    def __init__(self, space: Space, seed: int = 0, gamma: float = 0.25,
                 n_startup: int = 10, n_candidates: int = 24):
        self.space = space
        self.rng = random.Random(seed)
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_candidates = n_candidates

    def _random_point(self) -> Dict[str, float]:
        point = {}
        for name, (kind, lo, hi) in self.space.items():
            t = self.rng.uniform(_to_internal(kind, lo), _to_internal(kind, hi))
            point[name] = _from_internal(kind, t, lo, hi)
        return point

    def suggest(self, trials: List[dict]) -> Dict[str, float]:
        done = [t for t in trials if t.get("loss") is not None]
        if len(done) < self.n_startup:
            return self._random_point()
        finite = [t for t in done if math.isfinite(t["loss"])]
        if len(finite) < 2:
            return self._random_point()
        n_good = max(1, int(math.ceil(self.gamma * len(finite))))
        by_loss = sorted(finite, key=lambda t: t["loss"])
        good = by_loss[:n_good]
        bad = by_loss[n_good:] + [t for t in done if not math.isfinite(t["loss"])]
        if not bad:
            return self._random_point()

        point = {}
        for name, (kind, lo, hi) in self.space.items():
            tlo, thi = _to_internal(kind, lo), _to_internal(kind, hi)
            l_dens = _Parzen([_to_internal(kind, t["params"][name]) for t in good], tlo, thi)
            g_dens = _Parzen([_to_internal(kind, t["params"][name]) for t in bad], tlo, thi)
            best_x, best_score = None, -math.inf
            for _ in range(self.n_candidates):
                x = l_dens.sample(self.rng)
                score = l_dens.logpdf(x) - g_dens.logpdf(x)
                if score > best_score:
                    best_x, best_score = x, score
            point[name] = _from_internal(kind, best_x, lo, hi)
        return point
