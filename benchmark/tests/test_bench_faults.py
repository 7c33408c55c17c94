"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at tiny size
on the CPU, once for each fault a spectrum cell can have (it runs on one
card: there is no exchange between cards to leave out)."""

import importlib

import pytest

from benchmark.tests import tiny

CELLS = ("gpt2-tiny.spectrum", "neox-tiny.spectrum")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("faults"))


def patch_hvp(monkeypatch, broken):
    """Every module that builds the program's HVP gets ``broken(hvp)``."""
    for name in ("curvature.operators", "krylov.driver"):
        mod = importlib.import_module(f"hessian_llm_vision_tpu_torch.{name}")
        orig = mod.hvp_fn
        monkeypatch.setattr(mod, "hvp_fn", lambda *a, _o=orig, **k: broken(_o(*a, **k)))


def unchanged(hvp):
    """A step that returns its state unchanged: the product gives back its
    vector."""
    return lambda params, batch, vector: {n: v.float().clone() for n, v in vector.items()}


def half_batch(hvp):
    """Half of the batch left out, the mean taken over the rest."""
    def f(params, batch, vector):
        rows = batch["input_ids"].shape[0] // 2
        return hvp(params, {k: v[:rows] for k, v in batch.items()}, vector)
    return f


def altered_answer(monkeypatch):
    """An alpha of T altered where the recurrence produces it."""
    for name, fn in (("krylov.lanczos", "lanczos"), ("krylov.driver", "bigmodel_spectrum_host")):
        mod = importlib.import_module(f"hessian_llm_vision_tpu_torch.{name}")
        orig = getattr(mod, fn)

        def wrapped(*a, _o=orig, **k):
            res = _o(*a, **k)
            alphas = res.alphas.clone()
            alphas[0] += 1e-2 * alphas.abs().max()
            return res._replace(alphas=alphas)

        monkeypatch.setattr(mod, fn, wrapped)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    rc, res, err = tiny.run(root, cell, seed=99)
    assert rc == 0 and res["correct"], err[-3000:]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_answer"])
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    if fault == "altered_answer":
        altered_answer(monkeypatch)
    else:
        patch_hvp(monkeypatch, {"unchanged": unchanged, "half_batch": half_batch}[fault])
    rc, res, err = tiny.run(root, cell, seed=99)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in res["checks"].values())
