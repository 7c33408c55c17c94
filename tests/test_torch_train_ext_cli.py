"""The port's train CLI for the rest of training against the JAX train CLI on
the CPU, from the same checkpoint: the fused and layer-wise LanczosSGD,
the host layer-wise trainer, Gauss-Newton and natural gradient (per-step
losses within 1e-5, Ritz extremes within 1e-3); the JAX refusals; the
snapshots and the post-training spectrum against the port's own Lanczos
from the same generator, read by the JAX package; ``--tensorboard``; the
precision guard on the layer-wise host trainer; save and resume of gn and
the fused lanczos."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.cli import train as jtrain
from hessian_llm_vision_tpu.cli.workloads import build_workload as jbuild_workload
from hessian_llm_vision_tpu.io import load_spectrum as jload_spectrum
from hessian_llm_vision_tpu.io import save_checkpoint as jsave_checkpoint
from hessian_llm_vision_tpu_torch.cli import train
from hessian_llm_vision_tpu_torch.cli import workloads
from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
from hessian_llm_vision_tpu_torch.io.checkpoints import load_checkpoint, save_checkpoint
from hessian_llm_vision_tpu_torch.io.spectra import load_tridiag
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_from_jax
from hessian_llm_vision_tpu_torch.obs.loggers import PickleStatsLogger


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "16", "--cpu",
        "--num_batches", "3", "--log_every", "1"]
LOSS_RTOL = 1e-5
RITZ_RTOL = 1e-3
# per optimiser: a step count and knobs in the range the module tests hold
# to JAX ("mean"-scale Ritz values need delta ~ 1 to stay off the pole;
# gn/ngd need damping ~ 1 for a well-conditioned CG, see
# test_torch_optim_ext.py)
CASES = {
    "lanczos": ["--k", "4", "--delta", "10", "--lr", "0.01", "--refresh_every", "2",
                "--lanczos_momentum", "0.5", "--max_steps", "3"],
    "lanczos-layer": ["--k", "3", "--delta", "10", "--lr", "0.01", "--max_steps", "2"],
    "lanczos-layer-host": ["--k", "3", "--delta", "10", "--lr", "0.01", "--refresh_every", "2",
                           "--lanczos_momentum", "0.5", "--max_steps", "3",
                           "--no-basis_bf16"],
    "gn": ["--lr", "0.5", "--damping", "1", "--cg_iters", "8", "--max_steps", "2"],
    "ngd": ["--lr", "0.5", "--damping", "1", "--cg_iters", "8", "--max_steps", "2"],
}


def _checkpoints(tmp_path, argv):
    """The JAX CLI's init params (seed 5) saved for both CLIs."""
    jparams = jbuild_workload(jtrain.build_parser().parse_args(argv + ["--seed", "5"])).params
    jck, ck = str(tmp_path / "jck"), str(tmp_path / "ck.pt")
    jsave_checkpoint(jck, jparams)
    save_checkpoint(ck, gpt2_params_from_jax(jparams))
    return jck, ck


def _stats(out_root):
    (path,) = glob.glob(os.path.join(out_root, "**", "training_stats.pkl"), recursive=True)
    return PickleStatsLogger.read(path)


@pytest.mark.parametrize("optimiser", list(CASES))
def test_new_optimisers_match_jax_cli(tmp_path, capsys, optimiser):
    argv = TINY + ["--optimiser", optimiser] + CASES[optimiser]
    jck, ck = _checkpoints(tmp_path, argv)
    jfinal = jtrain.main(argv + ["--checkpoint", jck, "--out", str(tmp_path / "jruns")])
    jlast = capsys.readouterr().out.strip().splitlines()[-1]
    records = []
    final = train.main(argv + ["--checkpoint", ck, "--out", str(tmp_path / "runs")],
                       on_step=lambda s, r: records.append(r))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    np.testing.assert_allclose(float(last), float(jlast), rtol=LOSS_RTOL)
    np.testing.assert_allclose(final, jfinal, rtol=LOSS_RTOL)
    jstats, stats = _stats(str(tmp_path / "jruns")), _stats(str(tmp_path / "runs"))
    assert [r["step"] for r in stats] == [r["step"] for r in jstats]
    np.testing.assert_allclose([r["loss"] for r in stats], [r["loss"] for r in jstats],
                               rtol=LOSS_RTOL)
    ritz = [k for k in ("eig_max", "eig_min", "layer_eig_max", "layer_eig_min")
            if k in jstats[0]]
    assert bool(ritz) == optimiser.startswith("lanczos")
    for key in ritz:
        for r, jr in zip(stats, jstats):
            np.testing.assert_allclose(r[key], jr[key], rtol=RITZ_RTOL, atol=1e-4, err_msg=key)
    if optimiser in ("gn", "ngd"):
        assert [r["cg_iters"] for r in stats] == [r["cg_iters"] for r in jstats]
        assert [r["cg_iters"] for r in records] == [r["cg_iters"] for r in stats]
    if optimiser.startswith("lanczos-layer"):
        assert len(records[0]["layer_eig_max"]) == len(stats[0]["layer_eig_max"]) > 1


@pytest.mark.parametrize("argv,message", [
    (["--optimiser", "lanczos-layer-host", "--accumulation_steps", "2"],
     "--optimiser lanczos-layer-host does not support --accumulation_steps > 1 yet"),
    (["--optimiser", "lanczos-layer", "--accumulation_steps", "2"],
     "--optimiser lanczos-layer does not support --accumulation_steps > 1"),
    (["--optimiser", "lanczos-layer-host", "--refresh_linearized"],
     "--refresh_linearized applies to --optimiser lanczos-host"),
    (["--optimiser", "gn", "--precision_check"], "--precision_check probes the HOST trainers"),
    (["--optimiser", "lanczos", "--refresh_precision", "auto"],
     "--refresh_precision auto / --precision_recheck guard the HOST"),
    (["--optimiser", "bogus"], "unknown --optimiser 'bogus'"),
], ids=["layer_host_accum", "layer_accum", "linearized", "precision_check", "auto", "unknown"])
def test_refusals_are_the_jax_clis(tmp_path, argv, message):
    with pytest.raises(SystemExit) as ours:
        train.main(TINY + argv + ["--out", str(tmp_path)])
    assert message in str(ours.value)
    if argv[1] != "bogus":  # the JAX CLI refuses the same flags
        with pytest.raises(SystemExit) as ref:
            jtrain.main(TINY + argv + ["--out", str(tmp_path / "jax")])
        assert message in str(ref.value)


@pytest.mark.parametrize("optimiser", ["gn", "ngd"])
def test_second_order_needs_a_model_fn(tmp_path, monkeypatch, optimiser):
    build = workloads.build_workload

    def without_model_fn(args, device):
        wl = build(args, device)
        wl.model_fn = None
        return wl

    monkeypatch.setattr(train, "build_workload", without_model_fn)
    with pytest.raises(SystemExit, match=f"^--optimiser {optimiser} unsupported for "
                                         "'gpt2-tiny'$"):
        train.main(TINY + ["--optimiser", optimiser, "--out", str(tmp_path)])


@pytest.mark.parametrize("accum", [1, 2])
def test_snapshots_equal_the_ports_lanczos(tmp_path, accum):
    """--snapshot_every 1 on a 1-step Adam run: step 0's T is the T-only
    Lanczos of the final params' Hessian on the first (micro-)batch from a
    generator seeded with 0."""
    ck = str(tmp_path / "final.pt")
    argv = TINY + ["--optimiser", "adam", "--max_steps", "1", "--snapshot_every", "1",
                   "--snapshot_iters", "5", "--accumulation_steps", str(accum),
                   "--out", str(tmp_path), "--save_checkpoint", ck]
    train.main(argv)
    (path,) = glob.glob(str(tmp_path / "**" / "T_step000000.npz"), recursive=True)
    alphas, betas = load_tridiag(path)
    args = train.build_parser().parse_args(argv)
    wl = workloads.build_workload(args, torch.device("cpu"))
    batch = wl.batches[0]
    if accum > 1:
        batch = {k: v[: args.batch_size // accum] for k, v in batch.items()}
    op = HessianOperator(wl.loss_fn, load_checkpoint(ck), batch)
    res = lanczos(op.matvec, op.dim, 5, generator=torch.Generator().manual_seed(0),
                  reorth=False, store_basis=False)
    np.testing.assert_allclose(alphas, res.alphas.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(betas, res.betas.numpy(), rtol=1e-6, atol=1e-6)
    assert alphas.shape == (5,) and betas.shape == (4,)


def test_post_spectrum_reads_in_the_jax_package(tmp_path, capsys):
    ck, out = str(tmp_path / "final.pt"), str(tmp_path / "eig" / "space")
    argv = TINY + ["--optimiser", "lanczos", "--k", "3", "--delta", "10", "--max_steps", "2",
                   "--post_spectrum_iters", "6", "--post_spectrum_out", out,
                   "--out", str(tmp_path), "--save_checkpoint", ck, "--seed", "3"]
    train.main(argv)
    assert f"eigenspace -> {out}.npz" in capsys.readouterr().out
    spec = jload_spectrum(out + ".npz")
    assert spec.eigvals.shape == (6,) and spec.ritz_vectors.shape[0] == 6
    np.testing.assert_allclose(float(np.sum(spec.gammas)), 1.0, rtol=1e-5)
    wl = workloads.build_workload(train.build_parser().parse_args(argv), torch.device("cpu"))
    op = HessianOperator(wl.loss_fn, load_checkpoint(ck), wl.batches[0])
    ref = ritz_decomposition(lanczos(op.matvec, op.dim, 6,
                                     generator=torch.Generator().manual_seed(4)))
    np.testing.assert_allclose(np.asarray(spec.eigvals), ref.eigvals.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_tensorboard_event_file_reads_back(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    records = []
    train.main(TINY + ["--optimiser", "lanczos-layer-host", "--k", "3", "--delta", "10",
                       "--max_steps", "2", "--tensorboard", "--out", str(tmp_path)],
               on_step=lambda s, r: records.append(r))
    (logdir,) = glob.glob(str(tmp_path / "**" / "tensorboard_logs"), recursive=True)
    acc = EventAccumulator(logdir)
    acc.Reload()
    tags = acc.Tags()["scalars"]
    assert {"loss", "ema_loss", "step_time", "layer_eig_max_max"} <= set(tags)
    assert "layer_eig_max" not in tags  # vector metrics go to the pickle only
    losses = acc.Scalars("loss")
    assert [e.step for e in losses] == [0, 1]
    np.testing.assert_allclose([e.value for e in losses], [r["loss"] for r in records],
                               rtol=1e-6)


def test_tensorboard_missing_package_exits_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(SystemExit, match="--tensorboard needs the 'tensorboard' package"):
        train.main(TINY + ["--optimiser", "sgd", "--max_steps", "1", "--tensorboard",
                           "--out", str(tmp_path)])


def test_layer_host_precision_guard_and_check(tmp_path, capsys):
    """--refresh_precision auto installs the guard on the layer-wise host
    trainer (its summary in the run directory); --precision_check probes
    its refresh HVP."""
    argv = TINY + ["--optimiser", "lanczos-layer-host", "--k", "3", "--delta", "10",
                   "--max_steps", "2", "--out", str(tmp_path)]
    train.main(argv + ["--refresh_precision", "auto", "--precision_recheck", "1"])
    out = capsys.readouterr().out
    assert "[precision-guard] refresh tier resolved:" in out
    (path,) = glob.glob(str(tmp_path / "**" / "precision_guard.json"), recursive=True)
    assert os.path.getsize(path) > 0
    train.main(argv + ["--precision_check"])
    assert "extreme-Ritz" in capsys.readouterr().out


@pytest.mark.parametrize("optimiser", ["gn", "lanczos"])
def test_save_and_resume_continue_the_run(tmp_path, optimiser):
    """gn keeps its params as its state; the fused lanczos its whole
    LanczosSGDState (step, eigenvalues, basis).  One epoch saved and one
    resumed give the losses of two epochs in one run, bit for bit."""
    argv = TINY + ["--optimiser", optimiser, "--num_batches", "1", "--k", "3", "--delta", "10",
                   "--refresh_every", "2", "--lanczos_momentum", "0.5", "--damping", "1",
                   "--lr", "0.5" if optimiser == "gn" else "0.01", "--out", str(tmp_path)]
    whole, part = [], []
    train.main(argv + ["--epochs", "2"], on_step=lambda s, r: whole.append(r["loss"]))
    state = str(tmp_path / "state.pt")
    train.main(argv + ["--save_state", state], on_step=lambda s, r: part.append(r["loss"]))
    saved = load_checkpoint(state)
    if optimiser == "lanczos":
        assert saved["step"] == 1 and saved["basis"].shape[0] == 3
    else:  # the params dict itself
        assert "step" not in saved and all(isinstance(t, torch.Tensor) for t in saved.values())
    train.main(argv + ["--resume_state", state], on_step=lambda s, r: part.append(r["loss"]))
    assert len(whole) == 2 and part == whole


def test_new_modules_import_without_jax():
    """The optimizers, Krylov solvers, loggers and trace summary import with
    JAX and the JAX package blocked."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['hessian_llm_vision_tpu'] = None\n"
            "import hessian_llm_vision_tpu_torch.optim, hessian_llm_vision_tpu_torch.krylov\n"
            "import hessian_llm_vision_tpu_torch.obs, hessian_llm_vision_tpu_torch.cli.train_optimizers\n"
            "import hessian_llm_vision_tpu_torch.optim.second_order\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'hessian_llm_vision_tpu.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
