"""Port spectrum CLI on the CPU: its artifacts equal the library calls from
the same start vector, the JAX package reads them, T checkpoints resume, and
every flag of a path not ported yet exits with "not ported yet"."""

import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.io import spectra as jspectra
from hessian_llm_vision_tpu_torch.cli import spectrum
from hessian_llm_vision_tpu_torch.cli.spectrum import build_parser
from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
from hessian_llm_vision_tpu_torch.curvature.operators import DatasetHessianOperator
from hessian_llm_vision_tpu_torch.io import spectra
from hessian_llm_vision_tpu_torch.krylov import driver
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 HVPs pinned: the CLI default "auto" may pick a bf16 or TF32 arm
TINY = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "16",
        "--hvp_precision", "high", "--num_batches", "3", "--lanczos_iters", "6", "--cpu"]
CPU = torch.device("cpu")


def _workload_and_v0(argv):
    """The workload the CLI builds for ``argv`` and its first probe vector."""
    args = build_parser().parse_args(argv)
    wl = build_workload(args, CPU)
    dim = sum(p.numel() for p in wl.params.values())
    return wl, torch.randn(dim, generator=torch.Generator().manual_seed(args.vector_seed))


@pytest.mark.parametrize("mode", [[], ["--fused_iter"]], ids=["host_loop", "fused_iter"])
def test_host_loop_artifact_equals_library_call(tmp_path, mode, capsys):
    out = str(tmp_path / "s")
    spec, res = spectrum.main(TINY + ["--host_loop", "--out_spectrum", out] + mode)
    wl, v0 = _workload_and_v0(TINY)
    # --fused_iter is accepted for the JAX CLI's flags: the same one iteration
    ref = driver.dataset_spectrum_host(wl.loss_fn, wl.params, wl.batches, 6, v0=v0,
                                       batch_size=4)
    saved = spectra.load_spectrum(out)
    assert torch.equal(saved.eigvals, ritz_decomposition(ref).eigvals)
    assert torch.equal(res.alphas, ref.alphas)
    # the JAX package reads the port's artifact, meta keys included
    jspec = jspectra.load_spectrum(out + ".npz")
    np.testing.assert_array_equal(jspec.eigvals, saved.eigvals.numpy())
    with np.load(out + ".npz") as z:
        assert int(z["meta_iters"]) == 6 and int(z["meta_vector_seed"]) == 997
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("wall-clock:") and "HVPs/s" in lines[-2]
    assert lines[-1] == f"spectrum -> {out}.npz"


def test_incore_basis_artifact_equals_library_call(tmp_path):
    out = str(tmp_path / "s.npz")
    spectrum.main(TINY + ["--basis", "--out_spectrum", out])
    wl, v0 = _workload_and_v0(TINY)
    op = DatasetHessianOperator(wl.loss_fn, wl.params, wl.batches)
    ref = ritz_decomposition(lanczos(op.matvec, op.dim, 6, v0=v0), with_vectors=True)
    saved = spectra.load_spectrum(out)
    assert torch.equal(saved.eigvals, ref.eigvals)
    assert torch.equal(saved.ritz_vectors, ref.ritz_vectors)
    assert saved.ritz_vectors.shape == (6, op.dim)


def test_t_checkpoint_then_resume_equals_uninterrupted(tmp_path, capsys):
    whole = str(tmp_path / "whole")
    part = str(tmp_path / "part")
    spectrum.main(TINY + ["--t_checkpoint", whole, "--out_spectrum", whole + "_spec"])
    spectrum.main(TINY[:-3] + ["--lanczos_iters", "3", "--cpu", "--t_checkpoint", part])
    assert "step 3  T checkpointed" in capsys.readouterr().out
    spectrum.main(TINY + ["--resume_spectrum", part + ".state.npz", "--out_spectrum", part + "_spec"])
    assert "resuming at iteration 3" in capsys.readouterr().out
    for a, b in zip(spectra.load_spectrum(part + "_spec"), spectra.load_spectrum(whole + "_spec")):
        assert (a is None and b is None) or torch.equal(a, b)
    np.testing.assert_array_equal(spectra.load_tridiag(part)[0], spectra.load_tridiag(whole)[0])


@pytest.mark.parametrize("extra", [
    ["--host_loop", "--probes", "2", "--t_checkpoint", "{tmp}/t"],
    ["--probes", "2", "--no_reorth"],
    ["--host_loop", "--num_batches", "1", "--fused_step", "--qprev_bf16", "--normalization", "sum"],
    ["--layer", "h_0/attn", "--out_spectrum", "{tmp}/ref.ckpt", "--plot", "{tmp}/p.png"],
], ids=["host_probes", "incore_probes", "fused_step", "layer_ckpt"])
def test_other_ported_paths_run(tmp_path, extra, capsys):
    argv = TINY + [a.replace("{tmp}", str(tmp_path)) for a in extra]
    spec, _ = spectrum.main(argv)
    n_probes = 2 if "--probes" in extra else 1
    assert spec.eigvals.shape == (6 * n_probes,) and torch.isfinite(spec.eigvals).all()
    np.testing.assert_allclose(float(spec.gammas.sum()), 1.0, atol=1e-4)
    if "--layer" in extra:
        assert "[layer] restricting to 4 parameter leaves" in capsys.readouterr().out
        back = spectra.load_reference_spectrum(str(tmp_path / "ref.ckpt"))
        assert torch.equal(back.eigvals, spec.eigvals)
        assert (tmp_path / "p.png").stat().st_size > 0
        # --compare_to against the file just written: identical spectra
        spectrum.main(argv + ["--compare_to", str(tmp_path / "ref.ckpt")])
        out = capsys.readouterr().out
        assert "top-5 Ritz max relative error" in out and "0.00e+00" in out


# the precision flags (--precision_check, --hvp_precision auto|mixed|default,
# --bf16, --block_precision) are ported: tests/test_torch_precision_cli.py;
# --probe_parallel too: below and tests/test_torch_parallel.py
@pytest.mark.parametrize("extra,message", [
    # the port reads no hub dataset: only the JAX CLI's offline fallback
    (["--dataset", "wikipedia"], "pass --allow_fallback"),
], ids=["dataset_wikipedia"])
def test_unported_flags_exit(extra, message):
    with pytest.raises(SystemExit, match=message):
        spectrum.main(TINY + extra)


@pytest.mark.parametrize("extra", [
    ["--probes", "2", "--probe_parallel"],
    ["--host_loop", "--probe_parallel"],
    ["--host_loop", "--probes", "2", "--probe_parallel", "--num_batches", "1", "--fused_step"],
    ["--host_loop", "--probes", "2", "--probe_parallel", "--num_batches", "1", "--bigmodel"],
    ["--host_loop", "--probes", "2", "--probe_parallel", "--t_checkpoint", "t"],
], ids=["no_host_loop", "one_probe", "fused_step", "bigmodel", "t_checkpoint"])
def test_probe_parallel_flag_checks(extra):
    # the JAX CLI's combinations and message (cli/spectrum_flags.py)
    with pytest.raises(SystemExit, match="^--probe_parallel needs --host_loop and --probes >= 2"):
        spectrum.main(TINY + extra)


def test_probe_parallel_without_a_group_runs_the_probes_in_turn(tmp_path, capsys):
    argv = TINY + ["--host_loop", "--lanczos_iters", "5", "--probes", "2"]
    par, res = spectrum.main(argv + ["--probe_parallel", "--out_spectrum", str(tmp_path / "p")])
    out = capsys.readouterr().out
    seq, _ = spectrum.main(argv)
    assert torch.equal(par.eigvals, seq.eigvals) and torch.equal(par.gammas, seq.gammas)
    assert out.count("probe-parallel lanczos: probe") == 2 and "on rank 0 of 1" in out
    assert res.alphas.shape == (5,) and (tmp_path / "p.npz").exists()


def test_flag_checks_and_no_card_exit():
    with pytest.raises(SystemExit, match="requires --fused_step"):
        spectrum.main(TINY + ["--host_loop", "--qprev_bf16"])
    with pytest.raises(SystemExit, match="T-only"):
        spectrum.main(TINY + ["--host_loop", "--basis"])
    with pytest.raises(SystemExit, match="matches no parameters"):
        spectrum.main(TINY + ["--layer", "nothing/here"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot occur")
    with pytest.raises(SystemExit, match="no CUDA device"):
        spectrum.main([a for a in TINY if a != "--cpu"])


def test_local_corpus_dataset(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(bytes(np.random.RandomState(0).randint(32, 127, size=4000).astype(np.uint8)))
    argv = TINY + ["--dataset", f"local:{corpus}", "--host_loop"]
    spec, _ = spectrum.main(argv)
    assert "capping" in capsys.readouterr().out
    wl, _ = _workload_and_v0(argv)
    assert len(wl.batches) == 3 and wl.batches[0]["input_ids"].shape == (4, 16)
    assert int(wl.batches[0]["input_ids"].max()) < 256 and torch.isfinite(spec.eigvals).all()
