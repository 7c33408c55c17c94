"""The port's classifier workloads and both CLIs on them against the JAX
package on the CPU: every branch's batches from the same seeds and files
(spiral, SimpleNet on MNIST idx files the tests write, VGG-16/ResNet-50 on
CIFAR-10 pickles, on MNIST padded to 32x32x3 and on random images, with
the JAX CLI's messages), ``--classes``, ``--augment --noise`` redrawn per
epoch, ``--allow_fallback`` tokens; the spectrum CLI (Hessian and GGN) and
LanczosSGD training on spiral from the JAX CLI's init params; the
refusals; ``--hvp_precision auto`` resolving to fp32 on VGG-16; and
``--epochs 2 --augment`` through ``EpochResampledBatches``."""

import glob
import os

import jax
import numpy as np
import pytest
import torch

import hessian_llm_vision_tpu_torch.models as port_models
from hessian_llm_vision_tpu.cli import spectrum as jspectrum
from hessian_llm_vision_tpu.cli import train as jtrain
from hessian_llm_vision_tpu.cli.workloads import build_workload as jbuild_workload
from hessian_llm_vision_tpu.data import synthetic as jsynthetic
from hessian_llm_vision_tpu.krylov import driver as jdriver
from hessian_llm_vision_tpu.krylov import slq as jslq
from hessian_llm_vision_tpu_torch.cli import precision as cli_precision
from hessian_llm_vision_tpu_torch.cli import spectrum, train
from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
from hessian_llm_vision_tpu_torch.models.convert import params_from_jax
from hessian_llm_vision_tpu_torch.obs.loggers import PickleStatsLogger
from hessian_llm_vision_tpu_torch.train.evaluation import evaluate_accuracy
from test_torch_vision_data import write_cifar, write_mnist

RITZ_RTOL = 1e-3
LOSS_RTOL = 1e-5
CPU = torch.device("cpu")
SPIRAL = ["--model", "spiral", "--num_points", "120", "--batch_size", "30", "--cpu"]
RANDOM_IMAGES = "[data] CIFAR-10 and MNIST unavailable; falling back to random images"
MNIST_AS_CIFAR = "[data] CIFAR-10 unavailable; using real MNIST upscaled to 32x32x3"


@pytest.fixture(autouse=True)
def _setting(tmp_path, monkeypatch):
    """One torch thread; both data directories empty unless a test fills
    them; run directories under the test's directory."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("HLV_MNIST_DIR", str(empty))
    monkeypatch.setenv("HLV_CIFAR_DIR", str(empty))
    monkeypatch.chdir(tmp_path)
    yield
    torch.set_num_threads(n)


def _workloads(argv, jcli=jspectrum, cli=spectrum):
    return (build_workload(cli.build_parser().parse_args(argv), CPU),
            jbuild_workload(jcli.build_parser().parse_args(argv)))


def _same_batches(ours, ref):
    """Port dict batches against the JAX package's (x, y) tuples."""
    assert len(ours) == len(ref) > 0
    for b, (x, y) in zip(ours, ref):
        np.testing.assert_array_equal(b["image"].numpy(), np.asarray(x))
        np.testing.assert_array_equal(b["label"].numpy(), np.asarray(y))
        assert b["label"].dtype == torch.int64


def test_spiral_batches_equal_jax():
    wl, jwl = _workloads(SPIRAL)
    _same_batches(wl.batches, jwl.batches)
    assert wl.model_fn is not None and wl.apply_fn is not None and wl.make_batches is None
    assert sum(p.numel() for p in wl.params.values()) == 8707  # width 64, depth 3


def test_simplenet_needs_mnist_then_runs_on_idx_files(tmp_path, monkeypatch):
    argv = ["--model", "simplenet", "--batch_size", "8", "--cpu"]
    with pytest.raises(FileNotFoundError, match="MNIST test idx files not found"):
        build_workload(spectrum.build_parser().parse_args(argv), CPU)
    with pytest.raises(FileNotFoundError, match="MNIST test idx files not found"):
        jbuild_workload(jspectrum.build_parser().parse_args(argv))
    write_mnist(tmp_path, "test", 36, seed=4, gz=True)
    monkeypatch.setenv("HLV_MNIST_DIR", str(tmp_path))
    wl, jwl = _workloads(argv + ["--subsample", "0.5"])
    _same_batches(wl.batches, jwl.batches)  # 18 images -> 2 batches of 8
    assert len(wl.batches) == 2
    records = []
    train.main(argv + ["--optimiser", "lanczos-host", "--k", "3", "--max_steps", "2"],
               on_step=lambda s, r: records.append(r))
    assert len(records) == 2 and all(np.isfinite(r["loss"]) for r in records)


@pytest.mark.parametrize("model", ["vgg16", "resnet50"])
def test_random_image_fallback_equals_jax(capsys, model):
    wl, jwl = _workloads(["--model", model, "--batch_size", "3", "--num_batches", "2", "--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out.count(RANDOM_IMAGES) == 2  # both packages
    _same_batches(wl.batches, jwl.batches)
    assert wl.batches[0]["image"].shape == (3, 32, 32, 3)
    assert wl.model_fn is None and wl.make_batches is None


def test_mnist_as_cifar_fallback_equals_jax(tmp_path, monkeypatch, capsys):
    write_mnist(tmp_path, "test", 10, seed=1)  # no train split: the test split is read
    monkeypatch.setenv("HLV_MNIST_DIR", str(tmp_path))
    wl, jwl = _workloads(["--model", "vgg16", "--batch_size", "4", "--cpu"])
    assert capsys.readouterr().out.splitlines().count(MNIST_AS_CIFAR) == 2
    _same_batches(wl.batches, jwl.batches)
    assert len(wl.batches) == 2


def test_cifar_classes_remap_equals_jax(tmp_path, monkeypatch):
    write_cifar(tmp_path, 12, seed=3)
    monkeypatch.setenv("HLV_CIFAR_DIR", str(tmp_path))
    argv = ["--model", "resnet50", "--batch_size", "4", "--classes", "3", "7", "--num_batches",
            "2", "--cpu"]
    wl, jwl = _workloads(argv)
    _same_batches(wl.batches, jwl.batches)
    assert set(torch.cat([b["label"] for b in wl.batches]).tolist()) <= {0, 1}
    assert wl.params["Dense_0.kernel"].shape == (2048, 2)


def test_augment_noise_make_batches_equal_jax(tmp_path, monkeypatch):
    write_cifar(tmp_path, 4, seed=5)
    monkeypatch.setenv("HLV_CIFAR_DIR", str(tmp_path))
    argv = ["--model", "vgg16", "--batch_size", "4", "--augment", "--noise", "0.1",
            "--num_batches", "3", "--cpu"]
    wl, jwl = _workloads(argv)
    _same_batches(wl.batches, jwl.batches)
    for epoch in (0, 1):
        _same_batches(wl.make_batches(epoch), jwl.make_batches(epoch))
    _same_batches(wl.make_batches(0), [(b["image"], b["label"]) for b in wl.batches])
    assert not torch.equal(wl.make_batches(1)[0]["image"], wl.batches[0]["image"])


def test_allow_fallback_tokens_equal_jax_generator(capsys):
    argv = ["--model", "gpt2-tiny", "--dataset", "wikipedia", "--batch_size", "2",
            "--max_length", "16", "--num_batches", "3", "--cpu"]
    with pytest.raises(SystemExit, match="pass --allow_fallback to proceed on seeded random"):
        build_workload(spectrum.build_parser().parse_args(argv), CPU)
    wl = build_workload(spectrum.build_parser().parse_args(argv + ["--allow_fallback"]), CPU)
    assert "falling back to seeded random tokens (--allow_fallback)" in capsys.readouterr().out
    ref = jsynthetic.random_token_batches(3, 2, 16, 256, seed=42)
    assert len(wl.batches) == 3
    for i, b in enumerate(wl.batches):
        np.testing.assert_array_equal(b["input_ids"].numpy(), ref["input_ids"][i])


def _with_jax_init(monkeypatch, cli, jcli, argv):
    """The JAX CLI's init params for ``argv`` swapped into the workload the
    port's ``cli`` builds (neither CLI loads a checkpoint for a classifier)."""
    jparams = jbuild_workload(jcli.build_parser().parse_args(argv)).params
    params = params_from_jax(jparams)
    build = cli.build_workload

    def with_jax_params(args, device):
        wl = build(args, device)
        wl.params = {n: params[n].to(device) for n in wl.params}
        return wl

    monkeypatch.setattr(cli, "build_workload", with_jax_params)
    return jparams


@pytest.mark.parametrize("operator", ["hessian", "ggn"])
def test_spiral_spectrum_matches_the_jax_host_loop(monkeypatch, operator):
    argv = SPIRAL + ["--host_loop", "--lanczos_iters", "6", "--hvp_precision", "high",
                     "--operator", operator]
    jparams = _with_jax_init(monkeypatch, spectrum, jspectrum, argv)
    spec, _ = spectrum.main(argv)
    jwl = jbuild_workload(jspectrum.build_parser().parse_args(argv))
    v0 = torch.randn(8707, generator=torch.Generator().manual_seed(997))
    jres = jdriver.dataset_spectrum_host(
        jwl.loss_fn, jparams, jwl.batches, 6, v0=jax.numpy.asarray(v0.numpy()), batch_size=30,
        precision="high", operator=operator, model_fn=jwl.model_fn, out_loss_fn=jwl.out_loss_fn)
    jev = np.asarray(jslq.ritz_decomposition(jres).eigvals)
    scale = np.abs(jev).max()
    assert abs(float(spec.eigvals.max()) - jev.max()) <= RITZ_RTOL * scale
    assert abs(float(spec.eigvals.min()) - jev.min()) <= RITZ_RTOL * scale
    if operator == "ggn":
        assert float(spec.eigvals.min()) >= -1e-4 * scale


def test_ggn_and_fisher_refused_without_model_fn():
    for operator in ("ggn", "fisher"):
        for extra in (["--host_loop"], []):
            with pytest.raises(SystemExit, match=f"--operator {operator} unsupported for model "
                                                 "'vgg16' \\(no model_fn\\)"):
                spectrum.main(["--model", "vgg16", "--batch_size", "2", "--num_batches", "1",
                               "--cpu", "--operator", operator, "--hvp_precision", "high"]
                              + extra)


def test_hvp_precision_auto_resolves_to_high_on_vgg16(capsys, monkeypatch):
    def no_probe(batch):
        raise AssertionError("the precision probe must not run on a vision model")

    monkeypatch.setattr(cli_precision, "_probe_batch", no_probe)
    spec, _ = spectrum.main(["--model", "vgg16", "--batch_size", "2", "--num_batches", "1",
                             "--host_loop", "--lanczos_iters", "2", "--cpu"])
    assert ("[auto-precision] non-LM model: no transformer-block precision surface; "
            "resolving to 'high'") in capsys.readouterr().out
    assert bool(torch.isfinite(spec.eigvals).all())


def _stats(root):
    (path,) = glob.glob(os.path.join(root, "**", "training_stats.pkl"), recursive=True)
    return PickleStatsLogger.read(path)


def test_spiral_lanczos_host_training_matches_the_jax_cli(tmp_path, capsys, monkeypatch):
    argv = SPIRAL + ["--optimiser", "lanczos-host", "--k", "4", "--delta", "10", "--lr", "0.05",
                     "--refresh_every", "2", "--lanczos_momentum", "0.5", "--max_steps", "4",
                     "--log_every", "1"]
    _with_jax_init(monkeypatch, train, jtrain, argv)
    jtrain.main(argv + ["--out", str(tmp_path / "jruns")])
    train.main(argv + ["--out", str(tmp_path / "runs")])
    capsys.readouterr()
    jstats, stats = _stats(str(tmp_path / "jruns")), _stats(str(tmp_path / "runs"))
    assert [r["step"] for r in stats] == [r["step"] for r in jstats] == [0, 1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in stats], [r["loss"] for r in jstats],
                               rtol=LOSS_RTOL)
    for key in ("eig_max", "eig_min"):
        np.testing.assert_allclose([r[key] for r in stats], [r[key] for r in jstats],
                                   rtol=RITZ_RTOL, atol=1e-4, err_msg=key)


def test_epochs_augment_redraw_through_epoch_resampled_batches(tmp_path, monkeypatch):
    """--epochs 2 --augment on VGG-16 (classifier width 16): the train CLI
    asks make_batches for epoch 0 and epoch 1, and trains on both."""
    write_cifar(tmp_path, 4, seed=6)
    monkeypatch.setenv("HLV_CIFAR_DIR", str(tmp_path))
    vgg = port_models.VGG16
    monkeypatch.setattr(port_models, "VGG16",
                        lambda **kw: vgg(classifier_width=16, **kw))
    epochs, build = [], train.build_workload

    def recording(args, device):
        wl = build(args, device)
        make = wl.make_batches
        wl.make_batches = lambda e: epochs.append(e) or make(e)
        return wl

    monkeypatch.setattr(train, "build_workload", recording)
    records = []
    train.main(["--model", "vgg16", "--batch_size", "4", "--num_batches", "2", "--augment",
                "--epochs", "2", "--optimiser", "sgd", "--lr", "0.01", "--cpu"],
               on_step=lambda s, r: records.append(r))
    assert epochs == [0, 1] and len(records) == 4
    assert all(np.isfinite(r["loss"]) for r in records)


def test_evaluate_accuracy_takes_dict_batches():
    wl = build_workload(spectrum.build_parser().parse_args(SPIRAL), CPU)
    acc = evaluate_accuracy(wl.apply_fn, wl.params, wl.batches)
    tuples = evaluate_accuracy(wl.apply_fn, wl.params,
                               [(b["image"], b["label"]) for b in wl.batches])
    assert acc == tuples and 0.0 <= acc <= 1.0
