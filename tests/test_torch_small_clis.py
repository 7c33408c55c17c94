"""The port's small CLIs against the JAX package's: ``evaluate`` (per-batch
losses from the JAX params), ``sweep`` and ``hpo`` (the same points and
scores from the same train-CLI results), ``devices_info`` and the
``python -m`` dispatch."""

import json
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import hessian_llm_vision_tpu.cli.train as jtrain
import hessian_llm_vision_tpu_torch.cli.train as train
from hessian_llm_vision_tpu import __main__ as jdispatch
from hessian_llm_vision_tpu.cli import devices_info as jdevices_info
from hessian_llm_vision_tpu.cli import evaluate as jevaluate
from hessian_llm_vision_tpu.cli import hpo as jhpo
from hessian_llm_vision_tpu.cli import sweep as jsweep
from hessian_llm_vision_tpu.cli.common import build_workload as jbuild_workload
from hessian_llm_vision_tpu_torch import __main__ as dispatch
from hessian_llm_vision_tpu_torch.cli import devices_info, evaluate, hpo, sweep
from hessian_llm_vision_tpu_torch.models.convert import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIRAL = ["--model", "spiral", "--batch_size", "30", "--num_points", "120"]


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    """The train CLI writes run directories under ./runs."""
    monkeypatch.chdir(tmp_path)


def test_evaluate_matches_jax_on_its_params(tmp_path, capsys):
    jevaluate.main(SPIRAL + ["--out_losses", str(tmp_path / "jax.pkl")])
    jout = capsys.readouterr().out
    carried = params_from_jax(jbuild_workload(jevaluate.build_parser().parse_args(SPIRAL)).params)
    build = evaluate.build_workload

    def with_jax_params(args, device):
        wl = build(args, device)
        wl.params = {n: carried[n] for n in wl.params}
        return wl

    evaluate.build_workload = with_jax_params
    try:
        losses = evaluate.main(SPIRAL + ["--cpu", "--out_losses", str(tmp_path / "port.pkl")])
    finally:
        evaluate.build_workload = build
    out = capsys.readouterr().out
    with open(tmp_path / "jax.pkl", "rb") as f:
        jz = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        z = pickle.load(f)
    assert list(z) == list(jz) == ["per_batch_losses"]
    assert z["per_batch_losses"].shape == jz["per_batch_losses"].shape == (4,)
    np.testing.assert_allclose(z["per_batch_losses"], jz["per_batch_losses"], rtol=1e-6)
    np.testing.assert_array_equal(z["per_batch_losses"], losses)
    # the same lines: batch count and accuracy over the same argmaxes
    assert out.splitlines()[1] == jout.splitlines()[1]
    assert out.splitlines()[0].startswith("4 batches: mean ")


def test_evaluate_prints_the_jax_lines_for_vgg16(capsys, tmp_path, monkeypatch):
    """vgg16's workload has no apply_fn in either package: the losses line
    and no accuracy line."""
    monkeypatch.setenv("HLV_CIFAR_DIR", str(tmp_path))
    monkeypatch.setenv("HLV_MNIST_DIR", str(tmp_path))
    argv = ["--model", "vgg16", "--batch_size", "2", "--num_batches", "1"]
    assert jbuild_workload(jevaluate.build_parser().parse_args(argv + ["--cpu"])).apply_fn is None
    losses = evaluate.main(argv + ["--cpu"])
    assert losses.shape == (1,) and np.isfinite(losses).all()
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("1 batches: mean ") and not any("accuracy" in x for x in out)


def _fake_train(scores, calls):
    """A train-CLI ``main`` that records its argv and returns the score of
    its ``--lr`` (or raises/exits as the score says)."""

    def main(argv, on_step=None):
        calls.append(list(argv))
        lr = argv[argv.index("--lr") + 1]
        score = scores[lr] if lr in scores else float(lr) ** 2
        if isinstance(score, BaseException):
            raise score
        return score

    return main


@pytest.mark.parametrize("bad", [["lr"], ["lr="], ["k=1", "=2"]], ids=["no_eq", "no_values",
                                                                      "no_key_values"])
def test_sweep_parse_grid_errors_as_jax(bad):
    if bad == ["k=1", "=2"]:  # a missing key parses in both packages
        assert sweep.parse_grid(bad) == jsweep.parse_grid(bad) == {"k": ["1"], "": ["2"]}
        return
    with pytest.raises(SystemExit, match="bad --grid entry"):
        sweep.parse_grid(bad)
    with pytest.raises(SystemExit, match="bad --grid entry"):
        jsweep.parse_grid(bad)


def test_sweep_matches_jax_and_scores_failures_inf(tmp_path, monkeypatch):
    scores = {"0.5": RuntimeError("diverged"), "0.7": float("nan"), "0.9": float("inf")}
    calls, jcalls = [], []
    monkeypatch.setattr(train, "main", _fake_train(scores, calls))
    monkeypatch.setattr(jtrain, "main", _fake_train(scores, jcalls))
    argv = ["--grid", "lr=0.3,0.5,0.1,0.7,0.9", "k=2,3", "--", "--model", "spiral", "--cpu"]
    out, jout = tmp_path / "new" / "dir" / "s.json", tmp_path / "j.json"
    results = sweep.main(["--out_json", str(out)] + argv)
    jresults = jsweep.main(["--out_json", str(jout)] + argv)
    assert calls == jcalls and len(calls) == 10
    assert calls[0] == ["--model", "spiral", "--cpu", "--lr", "0.3", "--k", "2"]
    assert results == jresults
    assert [r["final_loss"] for r in results[:4]] == [0.1 ** 2, 0.1 ** 2, 0.3 ** 2, 0.3 ** 2]
    assert all(r["final_loss"] == math.inf for r in results[4:])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(results))


def test_sweep_lets_system_exit_through(monkeypatch):
    monkeypatch.setattr(train, "main", _fake_train({"0.1": SystemExit("no card")}, []))
    with pytest.raises(SystemExit, match="no card"):
        sweep.main(["--grid", "lr=0.2,0.1"])


def test_sweep_runs_the_train_cli(tmp_path):
    results = sweep.main(["--grid", "lr=0.1,0.3", "--out_json", str(tmp_path / "s.json"), "--",
                          "--model", "spiral", "--cpu", "--optimiser", "sgd", "--epochs", "1",
                          "--batch_size", "60", "--log_every", "100"])
    assert len(results) == 2 and results[0]["final_loss"] <= results[1]["final_loss"]
    assert all(math.isfinite(r["final_loss"]) for r in results)


def _hpo_both(monkeypatch, tmp_path, argv):
    def fake(calls):
        """A train-CLI ``main`` scoring a bowl in log lr; lr > 1e-2 raises."""

        def main(args, on_step=None):
            calls.append(list(args))
            lr = float(args[args.index("--lr") + 1])
            if lr > 1e-2:
                raise RuntimeError("diverged")
            return (math.log10(lr) + 2.5) ** 2

        return main

    calls, jcalls = [], []
    monkeypatch.setattr(train, "main", fake(calls))
    monkeypatch.setattr(jtrain, "main", fake(jcalls))
    best = hpo.main(["--out_json", str(tmp_path / "p" / "best.json")] + argv)
    jbest = jhpo.main(["--out_json", str(tmp_path / "jbest.json")] + argv)
    assert calls == jcalls
    with open(tmp_path / "p" / "best.json") as f:
        assert json.load(f) == json.loads(json.dumps(best))
    return best, jbest


@pytest.mark.parametrize("optimiser,space", [("lanczos", "reference"), ("adam", "wide")])
def test_hpo_random_search_points_equal_jax(tmp_path, monkeypatch, capsys, optimiser, space):
    best, jbest = _hpo_both(monkeypatch, tmp_path, [
        "--trials", "12", "--sampler", "random", "--hpo_seed", "7", "--optimiser", optimiser,
        "--space", space, "--", "--model", "spiral", "--cpu"])
    assert best == jbest
    assert sorted(best) == ["backend", "loss", "params", "trials"]
    assert best["backend"] == "random-search" and len(best["trials"]) == 12
    assert "[hpo] seeded random search" in capsys.readouterr().out
    lrs = [t["params"]["lr"] for t in best["trials"]]
    if space == "wide":  # the Adam space's lr cap lifted from 1e-3 to 1e-1
        assert max(lrs) > 1e-3 and max(lrs) <= 1e-1
        assert any(t["loss"] == math.inf for t in best["trials"])


def test_hpo_auto_takes_the_tpe_sampler_as_jax(tmp_path, monkeypatch, capsys):
    best, jbest = _hpo_both(monkeypatch, tmp_path, [
        "--trials", "14", "--hpo_seed", "3", "--", "--model", "spiral"])
    assert best == jbest and best["backend"] == "tpe"
    assert capsys.readouterr().out.count(
        "[hpo] optuna not installed; using the native TPE sampler") == 2
    assert [type(t["params"]["k"]) for t in best["trials"]] == [int] * 14


def test_hpo_optuna_sampler_exits_without_optuna():
    with pytest.raises(SystemExit, match="optuna is not installed"):
        hpo.main(["--sampler", "optuna", "--trials", "1"])


def test_hpo_suggest_equals_jax():
    import random

    for opt in ("lanczos", "adam"):
        rng, jrng = random.Random(5), random.Random(5)
        for _ in range(5):
            assert hpo._suggest(hpo.SPACE[opt], rng=rng) == jhpo._suggest(jhpo.SPACE[opt],
                                                                         rng=jrng)
    assert hpo.SPACE == jhpo.SPACE


def test_hpo_runs_the_train_cli(tmp_path):
    best = hpo.main(["--trials", "2", "--optimiser", "adam", "--out_json",
                     str(tmp_path / "b.json"), "--", "--model", "spiral", "--cpu", "--epochs",
                     "1", "--batch_size", "60", "--log_every", "100"])
    assert math.isfinite(best["loss"]) and len(best["trials"]) == 2


def test_devices_info_cpu_rows(capsys, monkeypatch):
    rows = devices_info.main(["--cpu"])
    jrows = jdevices_info.main(["--cpu"])
    assert rows == [{"id": 0, "platform": "cpu", "kind": "cpu", "process": 0}]
    assert rows[0] == jrows[0]
    assert capsys.readouterr().out.startswith("backend: cpu  devices: 1  processes: 1")
    devices_info.main(["--cpu", "--json"])
    assert json.loads(capsys.readouterr().out) == rows
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        devices_info.main([])


def test_dispatch_commands_help_and_errors(capsys):
    assert list(dispatch.COMMANDS) == list(jdispatch.COMMANDS)
    assert [d for _, d in dispatch.COMMANDS.values()] == [d for _, d in
                                                          jdispatch.COMMANDS.values()]
    for name, (module, _) in dispatch.COMMANDS.items():
        assert module == jdispatch.COMMANDS[name][0].replace(
            "hessian_llm_vision_tpu.", "hessian_llm_vision_tpu_torch.")
    assert dispatch.main([]) == 0 and dispatch.main(["--help"]) == 0
    text = capsys.readouterr().out
    assert all(f"  {name:13s} " in text for name in dispatch.COMMANDS)
    assert dispatch.main(["no-such-command"]) == 2
    assert "unknown command 'no-such-command'" in capsys.readouterr().err


def test_dispatch_runs_spectrum(tmp_path):
    out = str(tmp_path / "spec")
    assert dispatch.main(["spectrum", "--model", "spiral", "--lanczos_iters", "4",
                          "--batch_size", "30", "--num_points", "120", "--hvp_precision",
                          "high", "--out_spectrum", out, "--cpu"]) == 0
    assert os.path.exists(out + ".npz")


def test_python_m_dispatch_in_a_subprocess():
    env = {**os.environ, "PYTHONPATH": ROOT}
    got = subprocess.run([sys.executable, "-m", "hessian_llm_vision_tpu_torch", "devices-info",
                          "--cpu", "--json"], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    assert json.loads(got.stdout)[0]["platform"] == "cpu"
    bad = subprocess.run([sys.executable, "-m", "hessian_llm_vision_tpu_torch", "nope"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert bad.returncode == 2
