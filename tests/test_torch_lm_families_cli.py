"""Both port CLIs on the other language-model families against the JAX
package on the CPU: ``llama-tiny`` (grouped-query attention),
``pythia-70m`` at bs1 and seq16, and ``gpt2-tiny --experts 4`` with dense
and top-2 routing, from the JAX CLI's own init params (spectrum extremes
against the JAX host loop from the same start vector, LanczosSGD losses
and Ritz values against the JAX train CLI); the JAX refusals of the MoE
and LM-only flags; the refusal of an unknown model; the top-k curvature
warning; the precision ladder on a non-GPT-2 config."""

import contextlib
import glob
import io
import os

import jax
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.cli import spectrum as jspectrum
from hessian_llm_vision_tpu.cli import train as jtrain
from hessian_llm_vision_tpu.cli.workloads import build_workload as jbuild_workload
from hessian_llm_vision_tpu.io import save_checkpoint as jsave_checkpoint
from hessian_llm_vision_tpu.krylov import driver as jdriver
from hessian_llm_vision_tpu.krylov import slq as jslq
from hessian_llm_vision_tpu.models import LLAMA_CONFIGS as JLLAMA_CONFIGS
from hessian_llm_vision_tpu.models import PYTHIA_CONFIGS as JPYTHIA_CONFIGS
from hessian_llm_vision_tpu_torch.cli import spectrum, train, workloads
from hessian_llm_vision_tpu_torch.io.checkpoints import save_checkpoint
from hessian_llm_vision_tpu_torch.models import GPT2LMHead, LlamaLMHead, NeoXLMHead
from hessian_llm_vision_tpu_torch.models.convert import params_from_jax
from hessian_llm_vision_tpu_torch.models.moe import TopKCurvatureWarning
from hessian_llm_vision_tpu_torch.obs.loggers import PickleStatsLogger

RITZ_RTOL = 1e-3  # extreme Ritz values against the JAX package
LOSS_RTOL = 1e-5  # per-step training losses

SPEC = ["--batch_size", "1", "--max_length", "16", "--num_batches", "1", "--lanczos_iters", "3",
        "--host_loop", "--cpu", "--hvp_precision", "high"]
MODELS = {
    "llama_tiny": ["--model", "llama-tiny"],
    "pythia_70m": ["--model", "pythia-70m"],
    "moe_dense": ["--model", "gpt2-tiny", "--experts", "4"],
    "moe_top2": ["--model", "gpt2-tiny", "--experts", "4", "--moe_top_k", "2"],
}
TRAIN = ["--max_length", "16", "--num_batches", "2", "--cpu",
         "--log_every", "1", "--optimiser", "lanczos-host", "--k", "3", "--delta", "10",
         "--lr", "0.01", "--refresh_every", "2", "--lanczos_momentum", "0.5", "--max_steps", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checkpoints(tmp_path, jcli, argv):
    """The JAX CLI's init params for ``argv``, saved for both CLIs."""
    jparams = jbuild_workload(jcli.build_parser().parse_args(argv)).params
    jck, ck = str(tmp_path / "jck"), str(tmp_path / "ck.pt")
    jsave_checkpoint(jck, jparams)
    save_checkpoint(ck, params_from_jax(jparams))
    return jparams, jck, ck


def _warned(extra):
    """A top-k run must warn; any other must not."""
    if "--moe_top_k" in extra:
        return pytest.warns(TopKCurvatureWarning, match="curvature over TOP-K MoE routing")
    return contextlib.nullcontext()


@pytest.mark.parametrize("case", list(MODELS))
def test_spectrum_cli_matches_the_jax_host_loop(tmp_path, case):
    argv = MODELS[case] + SPEC
    jparams, _, ck = _checkpoints(tmp_path, jspectrum, argv)
    with _warned(argv):
        spec, _ = spectrum.main(argv + ["--checkpoint", ck])
    jwl = jbuild_workload(jspectrum.build_parser().parse_args(argv))
    dim = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(jparams))
    v0 = torch.randn(dim, generator=torch.Generator().manual_seed(997))
    jres = jdriver.dataset_spectrum_host(jwl.loss_fn, jparams, jwl.batches, 3,
                                         v0=jax.numpy.asarray(v0.numpy()), batch_size=1,
                                         precision="high")
    jev = np.asarray(jslq.ritz_decomposition(jres).eigvals)
    scale = np.abs(jev).max()
    assert abs(float(spec.eigvals.max()) - jev.max()) <= RITZ_RTOL * scale
    assert abs(float(spec.eigvals.min()) - jev.min()) <= RITZ_RTOL * scale


def _stats(root):
    (path,) = glob.glob(os.path.join(root, "**", "training_stats.pkl"), recursive=True)
    return PickleStatsLogger.read(path)


@pytest.mark.parametrize("case", list(MODELS))
def test_train_cli_matches_the_jax_cli(tmp_path, capsys, case):
    """LanczosSGD (host trainer) from the same params: per-step losses and
    the refresh's Ritz extremes."""
    argv = MODELS[case] + TRAIN + ["--batch_size", "1" if case == "pythia_70m" else "2"]
    _, jck, ck = _checkpoints(tmp_path, jtrain, argv)
    jtrain.main(argv + ["--checkpoint", jck, "--out", str(tmp_path / "jruns")])
    with _warned(argv):
        train.main(argv + ["--checkpoint", ck, "--out", str(tmp_path / "runs")])
    capsys.readouterr()
    jstats, stats = _stats(str(tmp_path / "jruns")), _stats(str(tmp_path / "runs"))
    assert [r["step"] for r in stats] == [r["step"] for r in jstats] == [0, 1]
    np.testing.assert_allclose([r["loss"] for r in stats], [r["loss"] for r in jstats],
                               rtol=LOSS_RTOL)
    for key in ("eig_max", "eig_min"):
        np.testing.assert_allclose([r[key] for r in stats], [r[key] for r in jstats],
                                   rtol=RITZ_RTOL, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("argv,message", [
    (["--model", "pythia-70m", "--experts", "4"], "--experts applies to the gpt2 family only"),
    (["--model", "llama-tiny", "--experts", "2"], "--experts applies to the gpt2 family only"),
    (["--model", "gpt2-tiny", "--moe_top_k", "2"], "--moe_top_k requires --experts N"),
    (["--model", "vgg16", "--loss_chunk", "8"], "--loss_chunk apply to LM models only"),
    (["--model", "spiral", "--attn_block_q", "8"], "--attn_block_q apply to LM models only"),
], ids=["experts_pythia", "experts_llama", "top_k_alone", "vision_loss_chunk",
        "spiral_block_q"])
@pytest.mark.parametrize("cli", ["spectrum", "train"])
def test_refusals_are_the_jax_clis(tmp_path, cli, argv, message):
    ours, ref = (spectrum, jspectrum) if cli == "spectrum" else (train, jtrain)
    full = argv + ["--cpu", "--out", str(tmp_path)] if cli == "train" else argv + ["--cpu"]
    with pytest.raises(SystemExit) as got:
        ours.main(full)
    assert message in str(got.value)
    with pytest.raises(SystemExit) as jgot:
        ref.main(full)
    assert message in str(jgot.value)


def test_unknown_model_is_refused(tmp_path):
    for main in (spectrum.main, lambda a: train.main(a + ["--out", str(tmp_path)])):
        with pytest.raises(ValueError, match="unknown model 'gpt3'"):
            main(["--model", "gpt3", "--cpu"])


@pytest.mark.parametrize("name", list(workloads._MODELS))
def test_every_lm_name_resolves_to_the_jax_config(name):
    """Every LM name of the JAX CLI's help (and pythia-410m) resolves to
    the JAX package's named config, with the CLI's overrides."""
    args = spectrum.build_parser().parse_args(["--model", name, "--max_length", "128", "--bf16",
                                               "--block_precision", "default"])
    cls, cfg = workloads.lm_config(args)
    assert cfg.dtype == torch.bfloat16 and cfg.block_matmul_precision == "default"
    if name.startswith("pythia"):
        assert cls is NeoXLMHead
        assert (cfg.hidden_size, cfg.num_layers) == (JPYTHIA_CONFIGS[name].hidden_size,
                                                    JPYTHIA_CONFIGS[name].num_layers)
    elif name.startswith("llama"):
        assert cls is LlamaLMHead
        assert (cfg.hidden_size, cfg.kv_heads) == (JLLAMA_CONFIGS[name].hidden_size,
                                                  JLLAMA_CONFIGS[name].kv_heads)
    else:
        assert cls is GPT2LMHead and cfg.n_positions == 128
        assert cfg.n_experts == (8 if name == "gpt2-moe" else 0)
    jhelp = next(a.help for a in jspectrum.build_parser()._actions if "--model" in a.option_strings)
    assert name in jhelp or name == "pythia-410m"


def test_moe_flags_are_the_jax_clis():
    for ours, ref in ((spectrum, jspectrum), (train, jtrain)):
        mine = {a.option_strings[0]: a for a in ours.build_parser()._actions if a.option_strings}
        theirs = {a.option_strings[0]: a for a in ref.build_parser()._actions if a.option_strings}
        for flag in ("--experts", "--moe_top_k", "--moe_capacity_factor"):
            for attr in ("default", "type"):
                assert getattr(mine[flag], attr) == getattr(theirs[flag], attr), (flag, attr)
        # the port has no expert-parallel mesh (A13), which the JAX help names
        for flag in ("--moe_top_k", "--moe_capacity_factor"):
            assert mine[flag].help == theirs[flag].help
    args = train.build_parser().parse_args(["--experts", "4", "--moe_top_k", "2",
                                            "--moe_capacity_factor", "2.0"])
    _, cfg = workloads.lm_config(args)
    assert (cfg.n_experts, cfg.moe_top_k, cfg.moe_capacity_factor) == (4, 2, 2.0)


def test_topk_warning_only_on_curvature_jobs(tmp_path, recwarn):
    top = ["--model", "gpt2-tiny", "--experts", "4", "--moe_top_k", "2", "--cpu",
           "--batch_size", "2", "--max_length", "16", "--num_batches", "1", "--max_steps", "1"]
    train.main(top + ["--optimiser", "adam", "--out", str(tmp_path / "a")])
    assert not [w for w in recwarn if issubclass(w.category, TopKCurvatureWarning)]
    with pytest.warns(TopKCurvatureWarning, match=r"\[train --optimiser lanczos-host\]"):
        train.main(top + ["--optimiser", "lanczos-host", "--k", "2", "--out", str(tmp_path / "b")])


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        spectrum.main(argv)
    return out.getvalue()


def test_precision_ladder_on_llama():
    """The default auto probes its rungs on a LLaMA config, under
    --linearized too (the blocks-TF32 rung, once dropped, is kept); TF32
    blocks under an fp32 head run traced (once refused), with the same
    Ritz values as the eager HVPs."""
    base = ["--model", "llama-tiny"] + SPEC[:-2] + ["--lanczos_iters", "4"]
    out = _run(base)
    assert "[auto-precision] referee (highest)" in out and "auto precision plan:" in out
    assert "probed mixed (all blocks 1-pass bf16): err" in out
    out = _run(base + ["--linearized"])
    assert "dropped under --linearized" not in out
    assert "probed blocks-TF32 + head high: err" in out and "auto precision plan:" in out
    tf32 = base + ["--hvp_precision", "high", "--block_precision", "TF32_TF32_F32"]
    eager, traced = _run(tf32), _run(tf32 + ["--linearized"])
    assert "linearized residual pass" in traced
    assert _top5(traced) == pytest.approx(_top5(eager), rel=1e-4, abs=1e-4)


def _top5(out: str) -> list:
    line = next(ln for ln in out.splitlines() if ln.startswith("top-5 Ritz"))
    return [float(x) for x in line.split("[", 1)[1].rstrip("]").split(",")]


def test_refresh_guard_on_llama(tmp_path, capsys):
    """The train CLI's auto refresh precision with its guard on a LLaMA
    model: the plan and the guard file."""
    train.main(["--model", "llama-tiny", "--cpu", "--batch_size", "2", "--max_length", "16",
                "--num_batches", "2", "--optimiser", "lanczos-host", "--k", "2",
                "--max_steps", "2", "--refresh_every", "1", "--refresh_precision", "auto",
                "--precision_recheck", "1", "--out", str(tmp_path)])
    assert "[precision-guard] step 0 refresh 0 (initial)" in capsys.readouterr().out
    assert glob.glob(str(tmp_path / "**" / "precision_guard.json"), recursive=True)
