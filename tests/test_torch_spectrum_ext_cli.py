"""Port spectrum CLI's layerwise, GGN / Fisher, linearized and bigmodel
paths on the CPU: each artifact equals the library call from the same
draws, the new flags and their refusals are the JAX CLI's, and the
in-core --operator ggn --thick_restart gives the GGN's eigenpairs."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.cli.spectrum import build_parser as jax_build_parser
from hessian_llm_vision_tpu.cli.spectrum_flags import validate_flags as jax_validate_flags
from hessian_llm_vision_tpu.io import spectra as jspectra
from hessian_llm_vision_tpu_torch.cli import spectrum
from hessian_llm_vision_tpu_torch.cli.spectrum import build_parser
from hessian_llm_vision_tpu_torch.cli.spectrum_paths import host_loop_main
from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
from hessian_llm_vision_tpu_torch.curvature.ggn import FisherOperator, GGNOperator
from hessian_llm_vision_tpu_torch.curvature.operators import LayerHessianOperator
from hessian_llm_vision_tpu_torch.io import spectra
from hessian_llm_vision_tpu_torch.krylov import driver
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition
from hessian_llm_vision_tpu_torch.utils import trees
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


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
ONE = TINY + ["--num_batches", "1", "--host_loop"]
CPU = torch.device("cpu")
EIG_RTOL = 1e-5  # card-free paths against their library calls / the plain loop
BF16_RTOL = 2e-3  # bf16-stored Krylov vectors, extreme Ritz values


def _workload(argv):
    args = build_parser().parse_args(argv)
    wl = build_workload(args, CPU)
    return args, wl, Flattener(wl.params)


def _extremes_close(a, b, rtol):
    scale = float(b.abs().max())
    assert abs(float(a.max() - b.max())) <= rtol * scale
    assert abs(float(a.min() - b.min())) <= rtol * scale


@pytest.mark.parametrize("flag,same_help", [
    ("--layerwise", True), ("--layerwise_group", True), ("--group_regex", True),
    ("--bigmodel_q", True), ("--operator", True), ("--linearized", False), ("--bigmodel", False),
])
def test_new_flag_is_the_jax_clis(flag, same_help):
    """Defaults, choices and types are the JAX CLI's; the help too, except
    where the JAX text quotes its own chip's measurements."""
    ours = {a.option_strings[0]: a for a in build_parser()._actions if a.option_strings}
    ref = {a.option_strings[0]: a for a in jax_build_parser()._actions if a.option_strings}
    for attr in ("default", "choices", "type", "metavar", "nargs", "const") + (
            ("help",) if same_help else ()):
        assert getattr(ours[flag], attr) == getattr(ref[flag], attr), attr


@pytest.mark.parametrize("extra", [
    ["--linearized"], ["--host_loop", "--num_batches", "1", "--linearized", "--fused_step"],
    ["--host_loop", "--linearized", "--operator", "ggn"], ["--host_loop", "--linearized",
                                                           "--layerwise"],
    ["--host_loop", "--fused_iter", "--bigmodel"], ["--bigmodel"], ["--layerwise_group", "block"],
    ["--group_regex", "h_0"], ["--host_loop", "--operator", "fisher", "--kpm", "8"],
    ["--bigmodel", "--host_loop", "--kpm", "8"],
], ids=lambda e: "_".join(e).replace("-", ""))
def test_refusal_is_the_jax_clis(extra):
    with pytest.raises(SystemExit) as jax_exit:
        jax_validate_flags(jax_build_parser().parse_args(TINY + extra))
    with pytest.raises(SystemExit) as ours:
        spectrum.main(TINY + extra)
    assert str(ours.value) == str(jax_exit.value)


@pytest.mark.parametrize("extra,dropped", [
    (["--probes", "2"], "--probes"), (["--basis", "--compare_to", "x.npz"], "--basis, --compare_to"),
    (["--operator", "fisher"], "--operator fisher"),
    (["--host_loop", "--num_batches", "1", "--fused_step"], "--fused_step"),
    (["--host_loop", "--num_batches", "1", "--bigmodel"], "--bigmodel"),
], ids=["probes", "basis_compare_to", "operator", "fused_step", "bigmodel"])
def test_layerwise_refuses_what_it_drops(extra, dropped):
    """The JAX CLI's message (``cli/spectrum.py``, the --layerwise branch)."""
    with pytest.raises(SystemExit) as ours:
        spectrum.main(TINY + ["--layerwise"] + extra)
    assert str(ours.value) == (f"--layerwise does not support {dropped}; each block runs a "
                               "plain T-only (or in-core) Hessian Lanczos")


def _grouping(wl, group):
    labels, spans = trees.partition_labels(wl.params)
    regex = trees.BLOCK_GROUP_REGEX if group == "block" else None
    return (trees.group_spans(labels, spans, regex) if regex else (labels, spans)), regex


@pytest.mark.parametrize("group", ["leaf", "block"])
def test_layerwise_host_loop_artifacts_equal_library_call(tmp_path, group, capsys):
    out, plot = str(tmp_path / "lw"), str(tmp_path / "grid.png")
    iters = 2 if group == "leaf" else 4  # 28 leaves, 2 blocks
    argv = TINY + ["--layerwise", "--layerwise_group", group, "--host_loop", "--lanczos_iters",
                   str(iters), "--out_spectrum", out, "--plot", plot]
    results, res = spectrum.main(argv)
    assert res is None
    args, wl, fl = _workload(argv)
    (labels, spans), regex = _grouping(wl, group)
    ref = driver.layerwise_spectrum_host(wl.loss_fn, wl.params, wl.batches[0], iters,
                                         generator=torch.Generator().manual_seed(997),
                                         batch_size=4, group_regex=regex)
    assert list(results) == list(ref) == labels
    for label in labels:
        saved = spectra.load_spectrum(f"{out}_{label.replace('/', '.')}")
        assert torch.equal(saved.eigvals, ritz_decomposition(ref[label]).eigvals)
        np.testing.assert_allclose(float(saved.gammas.sum()), 1.0, atol=1e-5)
    if group == "block":
        assert labels == ["h_0", "h_1"]
        assert os.path.getsize(plot) > 0
        # the JAX package reads a block artifact
        jspec = jspectra.load_spectrum(out + "_h_0.npz")
        np.testing.assert_array_equal(jspec.eigvals, results["h_0"].eigvals.numpy())
    text = capsys.readouterr().out
    assert f"P={spans[0][1]:9d} max=" in text
    assert f"{len(labels)} block spectra -> {out}_*.npz" in text


@pytest.mark.parametrize("group", ["leaf", "block"])
def test_layerwise_incore_artifacts_equal_library_call(tmp_path, group):
    """In core: one LayerHessianOperator and a CGS2 Lanczos per block, each
    from a full P-vector drawn in label order."""
    out = str(tmp_path / "lw")
    argv = TINY + ["--layerwise", "--layerwise_group", group, "--lanczos_iters", "3",
                   "--out_spectrum", out]
    if group == "leaf":
        argv += ["--group_regex", r"(h_1/mlp/c_\w+/kernel)"]
    results, _ = spectrum.main(argv)
    args, wl, fl = _workload(argv)
    gen = torch.Generator().manual_seed(997)
    expected = ["h_1/mlp/c_fc/kernel", "h_1/mlp/c_proj/kernel"] if group == "leaf" else [
        "h_0", "h_1"]
    assert list(results) == expected
    for label in expected:
        prefix = label + ("" if group == "leaf" else "/")
        mask = trees.subtree_mask(wl.params, lambda n, p=prefix: n.startswith(p))
        op = LayerHessianOperator(wl.loss_fn, wl.params, wl.batches[0], mask)
        v0 = torch.randn(fl.size, generator=gen)
        ref = ritz_decomposition(lanczos(op.matvec, op.dim, 3, v0=v0))
        saved = spectra.load_spectrum(f"{out}_{label.replace('/', '.')}")
        assert torch.equal(saved.eigvals, ref.eigvals)


@pytest.mark.parametrize("extra", [["--host_loop"], []], ids=["host_loop", "incore"])
def test_layerwise_grouping_matching_nothing_exits(extra):
    with pytest.raises(SystemExit, match="matches no parameter leaves|matched no parameter"):
        spectrum.main(TINY + ["--layerwise", "--group_regex", r"(nothing_\d+)"] + extra)


@pytest.mark.parametrize("operator", ["ggn", "fisher"])
@pytest.mark.parametrize("mode", ["incore", "host_loop"])
def test_operator_paths_equal_library_calls(tmp_path, operator, mode, capsys, monkeypatch):
    """In core: the single-batch GGN / Fisher operator (batch 1 of 3) and
    CGS2 Lanczos, one batch per matvec in the report; host loop: the
    dataset GGN loop.  Ritz values ≥ 0."""
    from hessian_llm_vision_tpu_torch.cli import spectrum_paths

    out = str(tmp_path / "g")
    argv = TINY + ["--operator", operator, "--out_spectrum", out] + (
        ["--host_loop"] if mode == "host_loop" else [])
    report = spectrum_paths.report_and_outputs
    seen = []
    monkeypatch.setattr(spectrum_paths, "report_and_outputs",
                        lambda *a, **kw: seen.append(a[4]) or report(*a, **kw))
    spec, _ = spectrum.main(argv)
    assert seen == [1 if mode == "incore" else 3]  # HVP batches per matvec
    args, wl, fl = _workload(argv)
    v0 = torch.randn(fl.size, generator=torch.Generator().manual_seed(997))
    if mode == "incore":
        assert f"[{operator}] single-batch operator: using batch 1 of 3" in capsys.readouterr().out
        maker = GGNOperator if operator == "ggn" else FisherOperator
        op = maker(wl.model_fn, wl.out_loss_fn, wl.params, wl.batches[0])
        ref = ritz_decomposition(lanczos(op.matvec, op.dim, 6, v0=v0))
    else:
        ref = ritz_decomposition(driver.dataset_spectrum_host(
            wl.loss_fn, wl.params, wl.batches, 6, v0=v0, batch_size=4, operator=operator,
            model_fn=wl.model_fn, out_loss_fn=wl.out_loss_fn))
    saved = spectra.load_spectrum(out)
    assert torch.equal(saved.eigvals, ref.eigvals)
    assert float(spec.eigvals.min()) >= -1e-5 * float(spec.eigvals.max())


def test_ggn_thick_restart_gives_the_ggns_eigenpairs():
    """--operator ggn --thick_restart runs on the GGN, not the dataset
    Hessian: each pair's residual against the GGN is small, its
    eigenvalues are ≥ 0, and the Hessian's run gives other ones."""
    argv = TINY + ["--thick_restart", "2", "--lanczos_iters", "10", "--basis"]
    spec, res = spectrum.main(argv + ["--operator", "ggn"])
    _, hres = spectrum.main(argv)
    args, wl, fl = _workload(argv)
    op = GGNOperator(wl.model_fn, wl.out_loss_fn, wl.params, wl.batches[0])
    scale = float(np.abs(res.eigvals).max())
    for u, lam in zip(res.vectors, res.eigvals):
        assert float(torch.linalg.vector_norm(op(u) - float(lam) * u)) <= 1e-3 * scale
    assert float(np.min(res.eigvals)) >= -1e-5 * scale
    assert not np.allclose(np.sort(res.eigvals), np.sort(hres.eigvals), rtol=1e-2)


def test_linearized_equals_the_plain_host_loop(tmp_path, capsys):
    """JAX ``test_linearized.py::test_spectrum_cli_linearized_matches_plain``:
    the same probe, the same operator."""
    lin, _ = spectrum.main(ONE + ["--linearized", "--vector_seed", "11",
                                  "--out_spectrum", str(tmp_path / "lin")])
    assert "linearized residual pass:" in capsys.readouterr().out
    plain, _ = spectrum.main(ONE + ["--vector_seed", "11"])
    np.testing.assert_allclose(np.sort(lin.eigvals.numpy()), np.sort(plain.eigvals.numpy()),
                               rtol=EIG_RTOL, atol=EIG_RTOL * float(plain.eigvals.abs().max()))
    assert spectra.load_spectrum(str(tmp_path / "lin")).eigvals.shape == (6,)
    with pytest.raises(SystemExit, match="--linearized needs a single batch"):
        spectrum.main(TINY + ["--host_loop", "--linearized"])


def test_bigmodel_equals_library_call_and_plain_loop(tmp_path):
    """--bigmodel: the artifact is bigmodel_spectrum_host's from the CLI's
    flat draw split into leaves; float32 q equals the plain host loop
    within 1e-5, bfloat16 within 2e-3 on the extremes."""
    out = str(tmp_path / "big")
    b16, _ = spectrum.main(ONE + ["--bigmodel", "--out_spectrum", out])
    f32, _ = spectrum.main(ONE + ["--bigmodel", "--bigmodel_q", "float32"])
    plain, _ = spectrum.main(ONE)
    args, wl, fl = _workload(ONE)
    v0 = torch.randn(fl.size, generator=torch.Generator().manual_seed(997))
    ref = driver.bigmodel_spectrum_host(wl.loss_fn, wl.params, wl.batches[0], 6,
                                        v0=fl.unflatten(v0), batch_size=4)
    assert torch.equal(spectra.load_spectrum(out).eigvals, ritz_decomposition(ref).eigvals)
    _extremes_close(f32.eigvals, plain.eigvals, EIG_RTOL)
    _extremes_close(b16.eigvals, plain.eigvals, BF16_RTOL)
    with pytest.raises(SystemExit, match="--bigmodel needs a single batch"):
        spectrum.main(TINY + ["--host_loop", "--bigmodel"])


def test_operator_needs_a_model_fn():
    """A workload without model_fn exits on both paths (the JAX message)."""
    argv = TINY + ["--operator", "ggn", "--host_loop"]
    args, wl, _ = _workload(argv)
    wl = dataclasses.replace(wl, model_fn=None)
    with pytest.raises(SystemExit, match="^--operator ggn unsupported for model 'gpt2-tiny' "
                                         r"\(no model_fn\)$"):
        host_loop_main(args, wl, CPU)
    with pytest.raises(SystemExit, match="no model_fn"):
        spectrum._make_operator(args, wl)


def test_layer_grid_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is missing, the grid is a valid grey PNG of two
    panels a row, with the block labels in its Title text."""
    import struct
    import sys
    import zlib

    from hessian_llm_vision_tpu_torch.cli.spectrum_layerwise import plot_layer_grid
    from hessian_llm_vision_tpu_torch.krylov.slq import Spectrum

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    specs = {f"h_{i}": Spectrum(eigvals=torch.tensor([-1.0, 0.5, 2.0 + i]),
                                gammas=torch.tensor([0.2, 0.5, 0.3])) for i in range(3)}
    path = tmp_path / "grid.png"
    plot_layer_grid(specs, str(path))
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, pos = {}, 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body)
        chunks[tag] = body
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    assert (w, h) == (800, 280)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, w + 1)
    assert (rows[:, 0] == 0).all() and (rows[:, 1:] == 0).any()
    assert chunks[b"tEXt"] == b"Title\x00h_0 | h_1 | h_2"
