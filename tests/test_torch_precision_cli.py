"""The precision flags of the port's CLIs on the CPU: ``--hvp_precision``
(default ``auto``, with the persisted plan and ``--reprobe``),
``--precision_check``, ``--block_precision``, ``--bf16``, and the train
CLI's ``--refresh_precision auto`` guard, with the JAX CLIs' messages and
report lines."""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.cli import precision as jprecision_cli
from hessian_llm_vision_tpu.cli import spectrum as jspectrum
from hessian_llm_vision_tpu.cli.workloads import build_workload as jbuild_workload
from hessian_llm_vision_tpu.krylov import driver as jdriver
from hessian_llm_vision_tpu.krylov import slq as jslq
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu_torch.cli import precision as precision_cli
from hessian_llm_vision_tpu_torch.cli import spectrum, train
from hessian_llm_vision_tpu_torch.io.checkpoints import save_checkpoint
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_from_jax

TINY = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "16", "--num_batches", "2",
        "--lanczos_iters", "6", "--host_loop", "--cpu"]
JAX_RTOL = 1e-5  # --hvp_precision high, port against the JAX driver, extreme Ritz values


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """JAX init params of gpt2-tiny, saved as a port checkpoint."""
    jmodel = JGPT2LMHead(JGPT2Config.tiny(n_positions=64))
    jparams = jmodel.init_params(jax.random.PRNGKey(11), seq_len=16)
    path = str(tmp_path_factory.mktemp("ck") / "ck.pt")
    save_checkpoint(path, gpt2_params_from_jax(jparams))
    return path, jparams


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = spectrum.main(argv)
    return res, out.getvalue()


def test_high_matches_the_jax_driver(jax_checkpoint):
    """--hvp_precision high from the same params and start vector as the
    JAX package's host loop at 'high'."""
    ck, jparams = jax_checkpoint
    (spec, res), _ = _run(TINY + ["--hvp_precision", "high", "--checkpoint", ck])
    jwl = jbuild_workload(jspectrum.build_parser().parse_args(TINY + ["--hvp_precision", "high"]))
    v0 = torch.randn(spec_dim(jparams), generator=torch.Generator().manual_seed(997))
    jres = jdriver.dataset_spectrum_host(jwl.loss_fn, jparams, jwl.batches, 6,
                                         v0=jax.numpy.asarray(v0.numpy()), batch_size=4,
                                         precision="high")
    jev = np.asarray(jslq.ritz_decomposition(jres).eigvals)
    scale = np.abs(jev).max()
    assert abs(float(spec.eigvals.max()) - jev.max()) <= JAX_RTOL * scale
    assert abs(float(spec.eigvals.min()) - jev.min()) <= JAX_RTOL * scale


def spec_dim(jparams) -> int:
    return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(jparams))


def test_auto_is_the_default_and_its_plan_persists(jax_checkpoint, tmp_path):
    """Default auto: the plan names every probed arm with its error and
    speed, lands next to --checkpoint, is reused with no probe, and
    --reprobe probes again."""
    ck, _ = jax_checkpoint
    local = str(tmp_path / "ck.pt")
    with open(ck, "rb") as src, open(local, "wb") as dst:
        dst.write(src.read())
    (spec, _), out = _run(TINY + ["--checkpoint", local])
    assert "[auto-precision] referee (highest)" in out
    assert "auto precision plan:" in out
    for label in ("mixed (all blocks 1-pass bf16)", "blocks-TF32 + head high"):
        assert f"probed {label}: err" in out and "ms/HVP" in out
    plan_path = local + ".autoprec.json"
    assert os.path.isfile(plan_path) and torch.isfinite(spec.eigvals).all()
    with open(plan_path) as f:
        doc = json.load(f)
    assert doc["version"] == 1 and doc["fingerprint"].startswith("sha256-ckpt:")
    _, again = _run(TINY + ["--checkpoint", local])
    assert "reusing persisted plan" in again and "0 probe HVPs" in again
    assert "[auto-precision] referee" not in again
    _, reprobed = _run(TINY + ["--checkpoint", local, "--reprobe"])
    assert "[auto-precision] referee" in reprobed and "plan ->" in reprobed
    # --precision_plan names another file
    other = str(tmp_path / "plan.json")
    _run(TINY + ["--precision_plan", other])
    assert os.path.isfile(other)


def _flag_products(monkeypatch) -> list:
    """The TF32 argument of every ``flag_einsum`` node of the linearized
    splits traced while the block runs (collected into the returned list)."""
    from hessian_llm_vision_tpu_torch.curvature import linearized

    flags, trace = [], linearized._trace_split

    def recording(*args, **kwargs):
        sp = trace(*args, **kwargs)
        flags.extend(n.args[3] for g in (sp.residual, sp.tangent) for n in g.graph.nodes
                     if "flag_einsum" in str(n.target))
        return sp

    monkeypatch.setattr(linearized, "_trace_split", recording)
    return flags


def test_linearized_runs_under_the_default_auto(monkeypatch):
    """--linearized with the default auto keeps the blocks-TF32 rung (once
    dropped: a traced graph now keeps each flag-switched product as a
    ``flag_einsum`` node) and runs the plan's arm: on the CPU, where TF32
    is fp32, blocks-TF32 itself, whose traced graph holds the fp32 head's
    products with the flag off under the TF32 blocks' ambient flag (the
    spectrum of 'high')."""
    lin = ["--num_batches", "1", "--linearized"]
    flags = _flag_products(monkeypatch)
    (spec, _), out = _run(TINY + lin)
    assert "dropped under --linearized" not in out
    assert "probed blocks-TF32 + head high: err" in out
    assert "probed mixed (all blocks 1-pass bf16)" in out
    assert "auto precision plan: blocks-TF32 + head high" in out
    assert flags and set(flags) == {False}
    (high, _), _ = _run(TINY + lin + ["--hvp_precision", "high"])
    torch.testing.assert_close(spec.eigvals, high.eigvals)


def test_auto_resolves_to_high_off_the_hessian():
    (spec, _), out = _run(TINY + ["--operator", "ggn"])
    assert "--operator ggn: the probe gates the Hessian program only; resolving to 'high'" in out


@pytest.mark.parametrize("extra,match", [
    (["--hvp_precision", "high", "--reprobe"],
     "--reprobe/--precision_plan have no effect without --hvp_precision auto"),
    (["--hvp_precision", "high", "--precision_plan", "p.json"],
     "--reprobe/--precision_plan have no effect without --hvp_precision auto"),
    (["--block_precision", "default"], "--block_precision conflicts with --hvp_precision auto"),
    (["--hvp_precision", "high", "--precision_check", "--operator", "ggn"],
     "--precision_check supports --operator hessian only"),
], ids=["reprobe", "precision_plan", "block_precision_with_auto", "check_ggn"])
def test_precision_flag_refusals(extra, match):
    with pytest.raises(SystemExit, match=match):
        spectrum.main(TINY + extra)


def test_block_precision_values_are_checked(capsys):
    with pytest.raises(SystemExit):
        spectrum.main(TINY + ["--block_precision", "BF16_BF16_F32_X3"])
    assert "presets the card runs" in capsys.readouterr().err


def test_precision_check_reports_as_the_jax_cli(capsys):
    """The report line of report_precision_probe: 'high' against 'highest'
    is 0 (both fp32), 'mixed' reports its own error, and the port's report
    prints the JAX report's text and warning for the same stats."""
    spectrum.main(TINY + ["--hvp_precision", "high", "--precision_check",
                          "--precision_check_iters", "6"])
    out = capsys.readouterr()
    assert "[precision] HVP extreme-Ritz rel err vs f32 referee (6 iters): 0.000e+00" in out.out
    assert "WARNING" not in out.err
    spectrum.main(TINY + ["--hvp_precision", "mixed", "--precision_check"])
    out = capsys.readouterr()
    assert "[precision] HVP extreme-Ritz rel err vs f32 referee (10 iters):" in out.out
    # the port's stats print the JAX report's exact text
    stats = {"ritz_rel_err": 3e-3, "rel_err": 1e-2, "seconds_requested": 0.5,
             "seconds_referee": 0.75}
    for report in (precision_cli.report_precision_probe, jprecision_cli.report_precision_probe):
        report(stats, 10, what="HVP", hint="h")
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 2 and lines[0] == lines[1]
    assert out.err.count("exceeds the 0.002 parity bar") == 2


def test_bf16_and_block_precision_run():
    (f32, _), _ = _run(TINY + ["--hvp_precision", "high"])
    (bf16, _), _ = _run(TINY + ["--hvp_precision", "high", "--bf16"])
    (blocks, _), _ = _run(TINY + ["--hvp_precision", "high", "--block_precision",
                                  "TF32_TF32_F32"])
    assert torch.isfinite(bf16.eigvals).all()
    assert not torch.equal(bf16.eigvals, f32.eigvals)
    torch.testing.assert_close(blocks.eigvals, f32.eigvals)  # TF32 is fp32 on the CPU


def test_train_auto_guard_runs_three_steps(tmp_path, capsys):
    argv = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "16", "--cpu",
            "--optimiser", "lanczos-host", "--k", "3", "--refresh_every", "1",
            "--max_steps", "3", "--refresh_precision", "auto", "--precision_recheck", "1",
            "--precision_check", "--out", str(tmp_path)]
    records = []
    train.main(argv, on_step=lambda s, r: records.append(r))
    out = capsys.readouterr().out
    assert len(records) == 3 and all(np.isfinite(r["loss"]) for r in records)
    assert "[precision-guard] refresh tier resolved:" in out
    assert "[precision] refresh extreme-Ritz rel err vs f32 referee (10 iters)" in out
    (path,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs
               if f == "precision_guard.json"]
    with open(path) as f:
        summary = json.load(f)
    assert summary["recheck_every"] == 1
    assert [e["trigger"] for e in summary["events"]][-2:] == ["periodic", "periodic"]
    assert summary["events"][0]["trigger"] == "initial"


def test_train_refresh_linearized_with_the_auto_guard(tmp_path, capsys):
    """--refresh_linearized --refresh_precision auto: the guard's ladder
    keeps the blocks-TF32 rung (once dropped) and the traced refreshes run."""
    records = []
    train.main(["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "16", "--cpu",
                "--optimiser", "lanczos-host", "--k", "3", "--refresh_every", "1",
                "--max_steps", "2", "--refresh_linearized", "--refresh_precision", "auto",
                "--out", str(tmp_path)], on_step=lambda s, r: records.append(r))
    out = capsys.readouterr().out
    assert "dropped under --linearized" not in out
    assert "[precision-guard] refresh tier resolved:" in out
    assert len(records) == 2 and all(np.isfinite(v) for r in records for v in r.values())


@pytest.mark.parametrize("extra,match", [
    (["--optimiser", "adam", "--precision_check"], "--precision_check probes the HOST"),
    (["--optimiser", "sgd", "--refresh_precision", "auto"], "guard the HOST"),
    (["--optimiser", "lanczos-host", "--precision_recheck", "-1"], "must be >= 0"),
], ids=["check_adam", "auto_sgd", "negative_recheck"])
def test_train_precision_flag_refusals(extra, match):
    with pytest.raises(SystemExit, match=match):
        train.main(["--model", "gpt2-tiny", "--cpu", "--max_steps", "1"] + extra)


def test_train_guards_a_pinned_tier(tmp_path, capsys):
    train.main(["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "16", "--cpu",
                "--optimiser", "lanczos-host", "--k", "3", "--max_steps", "2",
                "--refresh_precision", "default", "--precision_recheck", "1",
                "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[precision-guard] guarding pinned tier mixed (all blocks 1-pass bf16)" in out
