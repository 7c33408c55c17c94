"""Port spectrum CLI's thick-restart, KPM (plain and deflated), Hutch++ and
host-basis paths on the CPU: each artifact equals the library call from
the same draws, its meta keys land in the npz and the JAX package reads
it, and the new flags and their refusals are the JAX CLI's."""

import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.cli.spectrum import build_parser as jax_build_parser
from hessian_llm_vision_tpu.cli.spectrum_flags import validate_flags as jax_validate_flags
from hessian_llm_vision_tpu.io import spectra as jspectra
from hessian_llm_vision_tpu.krylov.slq import Spectrum as JSpectrum
from hessian_llm_vision_tpu_torch.cli import spectrum
from hessian_llm_vision_tpu_torch.cli.spectrum import build_parser
from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
from hessian_llm_vision_tpu_torch.curvature.operators import (
    DatasetHessianOperator,
    LayerHessianOperator,
)
from hessian_llm_vision_tpu_torch.io import spectra
from hessian_llm_vision_tpu_torch.krylov import deflate, driver, kpm, trace
from hessian_llm_vision_tpu_torch.krylov.host_lanczos import lanczos_host_basis
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.krylov.slq import Spectrum, ritz_decomposition
from hessian_llm_vision_tpu_torch.krylov.thick_restart import lanczos_thick_restart
from hessian_llm_vision_tpu_torch.utils import trees
from hessian_llm_vision_tpu_torch.utils.norms import norm


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
        "--hvp_precision", "high", "--num_batches", "2", "--lanczos_iters", "6", "--cpu"]
CPU = torch.device("cpu")
NEW_FLAGS = ["--thick_restart", "--tr_which", "--tr_dtype", "--tr_tol", "--kpm", "--kpm_probes",
             "--kpm_deflate", "--hutchpp", "--host_basis"]


def _workload(argv):
    args = build_parser().parse_args(argv)
    wl = build_workload(args, CPU)
    return args, wl, sum(p.numel() for p in wl.params.values())


def _meta(path):
    with np.load(path) as z:
        return {k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")}


@pytest.mark.parametrize("flag", NEW_FLAGS)
def test_new_flag_is_the_jax_clis(flag):
    ours = {a.option_strings[0]: a for a in build_parser()._actions if a.option_strings}
    ref = {a.option_strings[0]: a for a in jax_build_parser()._actions if a.option_strings}
    for attr in ("default", "choices", "type", "metavar", "help", "nargs", "const"):
        assert getattr(ours[flag], attr) == getattr(ref[flag], attr), attr


@pytest.mark.parametrize("extra", [
    ["--kpm", "8", "--thick_restart", "3"], ["--kpm", "8", "--layerwise"],
    ["--kpm_probes", "2"], ["--kpm_deflate", "2"], ["--hutchpp", "6", "--host_loop"],
    ["--thick_restart", "3", "--host_loop"], ["--tr_which", "la"], ["--tr_dtype", "bfloat16"],
    ["--tr_tol", "1e-3"], ["--host_loop", "--host_basis"], ["--host_loop", "--basis"],
], ids=lambda e: "_".join(e).replace("-", ""))
def test_refusal_is_the_jax_clis(extra):
    with pytest.raises(SystemExit) as jax_exit:
        jax_validate_flags(jax_build_parser().parse_args(TINY + extra))
    with pytest.raises(SystemExit) as ours:
        spectrum.main(TINY + extra)
    assert str(ours.value) == str(jax_exit.value)


@pytest.mark.parametrize("extra,dropped", [
    (["--probes", "2"], "--probes"), (["--host_basis"], "--host_basis"),
    (["--no_reorth", "--hutchpp", "6"], "--no_reorth, --hutchpp"),
], ids=["probes", "host_basis", "no_reorth_hutchpp"])
def test_thick_restart_refuses_what_it_drops(extra, dropped):
    with pytest.raises(SystemExit, match=f"^--thick_restart does not support {dropped}$"):
        spectrum.main(TINY + ["--thick_restart", "2", "--lanczos_iters", "8"] + extra)


# A11's --precision_check (tests/test_torch_precision_cli.py) and A10g's
# --probe_parallel (tests/test_torch_parallel.py) are ported: no flag of the
# JAX CLI refuses as "not ported yet" any more
def test_no_flag_refuses_as_not_ported(capsys):
    spectrum.build_parser().print_help()
    assert "not ported" not in capsys.readouterr().out
    assert not hasattr(spectrum, "_UNPORTED_FLAGS")


def test_thick_restart_artifact_equals_library_call(tmp_path, capsys):
    out = str(tmp_path / "tr")
    argv = TINY + ["--thick_restart", "2", "--lanczos_iters", "8", "--basis", "--out_spectrum", out]
    spec, res = spectrum.main(argv)
    lines = capsys.readouterr().out.splitlines()
    args, wl, dim = _workload(argv)
    v0 = torch.randn(dim, generator=torch.Generator().manual_seed(997))
    v0 = v0 / norm(v0)  # as the CLI normalises its start
    ref = driver.dataset_thick_restart_host(wl.loss_fn, wl.params, wl.batches, 2, v0=v0, inner=8,
                                            batch_size=4)
    np.testing.assert_array_equal(res.eigvals, ref.eigvals)
    assert torch.equal(res.vectors, ref.vectors) and res.matvecs == ref.matvecs
    saved = spectra.load_spectrum(out)
    assert torch.equal(saved.eigvals, torch.as_tensor(ref.eigvals, dtype=torch.float32))
    torch.testing.assert_close(saved.gammas, (ref.vectors @ v0) ** 2)
    assert torch.equal(saved.ritz_vectors, ref.vectors)
    meta = _meta(out + ".npz")
    assert int(meta["tr_matvecs"]) == res.matvecs and int(meta["tr_restarts"]) == res.restarts
    assert int(meta["tr_converged"]) == int(res.converged)
    assert float(meta["tr_max_residual"]) == float(res.residuals.max())
    jspec = jspectra.load_spectrum(out + ".npz")
    np.testing.assert_array_equal(jspec.eigvals, saved.eigvals.numpy())
    # the partial measure's report; HVPs counted from the matvecs
    assert any(line.startswith("partial E[lambda] over the 2 converged pairs") for line in lines)
    wall = next(line for line in lines if line.startswith("wall-clock:"))
    seconds, rate = float(wall.split()[1][:-1]), float(wall.split("(")[1].split()[0])
    assert rate == pytest.approx(res.matvecs * 2 / seconds, rel=0.02, abs=0.02)
    assert not any("LOST ORTHOGONALITY" in line for line in lines)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_thick_restart_layer_operator(dtype):
    argv = TINY + ["--thick_restart", "2", "--lanczos_iters", "8", "--layer", "h_0/attn",
                   "--tr_dtype", dtype, "--tr_which", "la", "--tr_tol", "1e-4"]
    spec, res = spectrum.main(argv)
    args, wl, dim = _workload(argv)
    op = LayerHessianOperator(wl.loss_fn, wl.params, wl.batches[0],
                              trees.subtree_mask(wl.params, lambda n: "h_0/attn" in n))
    v0 = torch.randn(dim, generator=torch.Generator().manual_seed(997))
    ref = lanczos_thick_restart(op.matvec, dim, 2, v0=v0 / norm(v0), inner=8,
                                which="la", tol=1e-4,
                                store_dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(res.eigvals, ref.eigvals)
    assert spec.ritz_vectors is None and spec.eigvals.shape == (2,)


def test_kpm_incore_and_host_loop_equal_library_call(tmp_path):
    argv = TINY + ["--kpm", "12", "--kpm_probes", "2"]
    spectrum.main(argv + ["--out_spectrum", str(tmp_path / "a")])
    spectrum.main(argv + ["--host_loop", "--out_spectrum", str(tmp_path / "b")])
    args, wl, dim = _workload(argv)
    op = DatasetHessianOperator(wl.loss_fn, wl.params, wl.batches)
    ref = kpm.kpm_density(op.matvec, dim, 12, torch.Generator().manual_seed(999), num_probes=2)
    for name in ("a", "b"):
        meta = _meta(tmp_path / f"{name}.npz")
        np.testing.assert_array_equal(meta["kpm_moments"], ref.moments)
        np.testing.assert_array_equal(meta["kpm_raw_moments"], ref.raw_moments)
        assert float(meta["kpm_center"]) == ref.center and float(meta["kpm_radius"]) == ref.radius
        assert int(meta["kpm_probes"]) == 2 and meta["kpm_moments"].shape == (12,)
        np.testing.assert_allclose(ref.raw_moments[0], 1.0, atol=1e-6)


def test_kpm_deflate_and_hutchpp_equal_library_calls(tmp_path, capsys):
    out = tmp_path / "d"
    argv = TINY + ["--kpm", "10", "--kpm_probes", "1", "--kpm_deflate", "2", "--hutchpp", "6"]
    spectrum.main(argv + ["--out_spectrum", str(out)])
    printed = capsys.readouterr().out
    args, wl, dim = _workload(argv)
    op = DatasetHessianOperator(wl.loss_fn, wl.params, wl.batches)
    ref = deflate.deflated_density(op.matvec, dim, 2, 10, torch.Generator().manual_seed(999))
    meta = _meta(str(out) + ".npz")
    np.testing.assert_array_equal(meta["kpm_deflate_eigvals"], ref.eigvals)
    np.testing.assert_array_equal(meta["kpm_deflate_residuals"], ref.residuals)
    assert int(meta["kpm_deflate_converged"]) == 1 == int(ref.converged)
    assert int(meta["kpm_deflate_matvecs"]) == ref.matvecs > 12 + 9  # range + moments + TR
    np.testing.assert_array_equal(meta["kpm_moments"], ref.bulk.moments)
    tr = trace.hutchpp_trace(op.matvec, dim, 6, torch.Generator().manual_seed(998))
    assert float(meta["hutchpp_trace"]) == float(tr) and int(meta["hutchpp_matvecs"]) == 6
    assert f"trace (hutch++ 6 matvecs) = {float(tr):.6e}" in printed
    assert "deflated 2 extremal pairs (converged" in printed
    # the bulk range lies inside the whole spectrum's
    lo, hi = kpm.estimate_spectral_range(op.matvec, dim, torch.Generator().manual_seed(3))
    assert lo <= float(meta["kpm_center"]) - float(meta["kpm_radius"])
    assert float(meta["kpm_center"]) + float(meta["kpm_radius"]) <= hi
    # the JAX package reads the artifact, array-valued meta included
    jspec = jspectra.load_spectrum(str(out) + ".npz")
    assert jspec.eigvals.shape == (6,)


def test_host_basis_equals_library_call(tmp_path):
    out = str(tmp_path / "hb")
    spec, res = spectrum.main(TINY + ["--host_basis", "--basis", "--t_checkpoint", out + "_t",
                                      "--out_spectrum", out])
    args, wl, dim = _workload(TINY)
    op = DatasetHessianOperator(wl.loss_fn, wl.params, wl.batches)
    v0 = torch.randn(dim, generator=torch.Generator().manual_seed(997))
    ref = lanczos_host_basis(op.matvec, dim, 6, v0=v0)
    assert torch.equal(res.alphas, ref.alphas) and torch.equal(res.basis, ref.basis)
    # the float64 host recurrence against the in-core f32 one
    incore = ritz_decomposition(lanczos(op.matvec, dim, 6, v0=v0), with_vectors=True)
    scale = float(incore.eigvals.abs().max())
    torch.testing.assert_close(spec.eigvals, incore.eigvals, rtol=0, atol=1e-4 * scale)
    saved = spectra.load_spectrum(out)
    assert saved.ritz_vectors.shape == (6, dim) and saved.ritz_vectors.dtype == torch.float32
    np.testing.assert_array_equal(spectra.load_tridiag(out + "_t")[0].astype(np.float32),
                                  res.alphas.numpy())


def test_array_meta_round_trips_between_packages(tmp_path):
    spec = Spectrum(eigvals=torch.tensor([-1.0, 0.5, 2.0]), gammas=torch.tensor([0.2, 0.5, 0.3]))
    meta = {"kpm_moments": np.linspace(1, 0, 7), "kpm_center": 0.25, "kpm_probes": 2,
            "kpm_deflate_eigvals": np.array([-3.0, 4.0]), "tr_converged": 1}
    spectra.save_spectrum(str(tmp_path / "ours"), spec, iters=6, vector_seed=997,
                          **{**meta, "kpm_deflate_residuals": torch.tensor([1e-7, 2e-7])})
    jspectra.save_spectrum(str(tmp_path / "ref"), JSpectrum(eigvals=spec.eigvals.numpy(),
                                                            gammas=spec.gammas.numpy()),
                           iters=6, vector_seed=997,
                           **{**meta, "kpm_deflate_residuals": np.float32([1e-7, 2e-7])})
    with np.load(tmp_path / "ours.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert a.files == b.files
        for k in b.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    back = spectra.load_spectrum(str(tmp_path / "ref.npz"))
    assert torch.equal(back.eigvals, spec.eigvals)
    np.testing.assert_array_equal(jspectra.load_spectrum(str(tmp_path / "ours")).gammas,
                                  spec.gammas.numpy())
