"""The port's TPE sampler (``utils/tpe.py``) against the JAX package's:
the same space, seed and history give exactly the same suggestions; and
the JAX package's own sampler cases, run on the port."""

import math
import random

import pytest

from hessian_llm_vision_tpu.utils import tpe as jtpe
from hessian_llm_vision_tpu_torch.utils import tpe
from hessian_llm_vision_tpu_torch.utils.tpe import TPESampler, _Parzen

SPACE = {
    "k": ("int", 5, 50),
    "lr": ("log", 1e-4, 1e-1),
    "momentum": ("float", 0.0, 0.99),
}


def _objective(point):
    # a smooth bowl with its optimum inside the space: lr 1e-2, k 20, m 0.5
    return ((math.log10(point["lr"]) + 2.0) ** 2 + ((point["k"] - 20) / 15.0) ** 2
            + (point["momentum"] - 0.5) ** 2)


def _study(sampler, n_trials, fail_every=0):
    trials = []
    for i in range(n_trials):
        point = sampler.suggest(trials)
        loss = math.inf if fail_every and i % fail_every == fail_every - 1 else _objective(point)
        trials.append({"params": point, "loss": loss})
    return trials


@pytest.mark.parametrize("seed,n_startup,fail_every", [(0, 10, 0), (3, 4, 5)],
                         ids=["default_startup", "short_startup_with_failures"])
def test_suggestions_equal_jax(seed, n_startup, fail_every):
    ours = _study(TPESampler(SPACE, seed=seed, n_startup=n_startup), 30, fail_every)
    ref = _study(jtpe.TPESampler(SPACE, seed=seed, n_startup=n_startup), 30, fail_every)
    assert [t["params"] for t in ours] == [t["params"] for t in ref]
    assert all(type(t["params"]["k"]) is int for t in ours)


def test_internal_maps_equal_jax():
    for kind, v, lo, hi in (("log", 3e-3, 1e-4, 1e-1), ("int", 7.6, 5, 50), ("int", 60.0, 5, 50),
                            ("float", -1.0, 0.0, 0.99)):
        t = tpe._to_internal(kind, min(max(v, lo), hi))
        assert t == jtpe._to_internal(kind, min(max(v, lo), hi))
        assert tpe._from_internal(kind, v, lo, hi) == jtpe._from_internal(kind, v, lo, hi)


def test_tpe_respects_space():
    sampler = TPESampler(SPACE, seed=0, n_startup=3)
    trials = []
    for _ in range(30):
        point = sampler.suggest(trials)
        assert isinstance(point["k"], int) and 5 <= point["k"] <= 50
        assert 1e-4 <= point["lr"] <= 1e-1
        assert 0.0 <= point["momentum"] <= 0.99
        trials.append({"params": point, "loss": _objective(point)})


def test_tpe_handles_inf_and_short_history():
    sampler = TPESampler(SPACE, seed=1, n_startup=2)
    trials = [{"params": sampler.suggest([]), "loss": math.inf},
              {"params": sampler.suggest([]), "loss": math.inf}]
    # an all-failed history falls back to random, still in the space
    point = sampler.suggest(trials)
    assert 5 <= point["k"] <= 50
    trials.append({"params": point, "loss": 1.0})
    trials.append({"params": sampler.suggest(trials), "loss": 2.0})
    # a mixed finite/inf history: the inf trials join the bad split
    point = sampler.suggest(trials)
    assert 1e-4 <= point["lr"] <= 1e-1


def test_parzen_duplicate_and_edge_bandwidths():
    """Duplicate observations get the floor bandwidth, not the range width;
    the edge kernels see virtual neighbours at lo and hi."""
    p = _Parzen([12.0, 12.0, 20.0], 5.0, 50.0)
    width, floor = 45.0, 45.0 / 4.0
    assert p.mus[:3] == [12.0, 12.0, 20.0]
    assert p.sigmas[0] == max(12.0 - 5.0, floor)
    assert p.sigmas[1] == max(8.0, floor)
    assert p.sigmas[2] == max(50.0 - 20.0, floor)
    assert all(s < width for s in p.sigmas[:3])
    assert p.sigmas[3] == width
    ref = jtpe._Parzen([12.0, 12.0, 20.0], 5.0, 50.0)
    assert (p.mus, p.sigmas, p.w) == (ref.mus, ref.sigmas, ref.w)
    assert p.logpdf(17.3) == ref.logpdf(17.3)


def test_tpe_beats_random_on_smooth_bowl():
    """Mean best-of-40 over 5 seeds: TPE beats the seeded random search on
    a smooth objective and lands near its optimum."""

    def random_best(seed):
        rng = random.Random(seed)
        return min(_objective({"k": rng.randint(5, 50),
                               "lr": math.exp(rng.uniform(math.log(1e-4), math.log(1e-1))),
                               "momentum": rng.uniform(0.0, 0.99)}) for _ in range(40))

    tpe_best = [min(t["loss"] for t in _study(TPESampler(SPACE, seed=s), 40)) for s in range(5)]
    rnd_best = [random_best(s) for s in range(5)]
    assert sum(tpe_best) / 5 < sum(rnd_best) / 5, (tpe_best, rnd_best)
    assert sum(tpe_best) / 5 < 0.05, tpe_best
