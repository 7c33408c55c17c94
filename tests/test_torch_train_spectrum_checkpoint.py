"""``cli.spectrum --checkpoint`` on a trained checkpoint: the JAX train CLI
trains gpt2-tiny a few Adam steps and saves its params (Orbax), the
port's converted copy goes through the port's spectrum CLI, and its Lanczos
T and Ritz values match JAX's host loop on the Orbax checkpoint from the
same start vector within 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.cli import spectrum as jspectrum
from hessian_llm_vision_tpu.cli import train as jtrain
from hessian_llm_vision_tpu.cli.workloads import build_workload as jbuild_workload
from hessian_llm_vision_tpu.io import load_checkpoint as jload_checkpoint
from hessian_llm_vision_tpu.krylov import driver as jdriver
from hessian_llm_vision_tpu.krylov import slq as jslq
from hessian_llm_vision_tpu_torch.cli import spectrum
from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
from hessian_llm_vision_tpu_torch.io.checkpoints import save_checkpoint
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ITERS = 8
BASE = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "16", "--num_batches", "2",
        "--cpu"]


def test_spectrum_of_a_trained_checkpoint_matches_jax(tmp_path):
    jck, ck = str(tmp_path / "jck"), str(tmp_path / "ck.pt")
    jtrain.main(BASE + ["--optimiser", "adam", "--lr", "1e-2", "--epochs", "3",
                        "--dataset", "markov", "--out", str(tmp_path / "runs"),
                        "--save_checkpoint", jck])
    save_checkpoint(ck, gpt2_params_from_jax(jload_checkpoint(jck)))
    # fp32 HVPs pinned: the CLI default "auto" may pick a bf16 or TF32 arm
    argv = BASE + ["--host_loop", "--lanczos_iters", str(ITERS), "--dataset", "markov",
                   "--hvp_precision", "high"]
    spec, res = spectrum.main(argv + ["--checkpoint", ck])
    init, _ = spectrum.main(argv)
    jwl = jbuild_workload(jspectrum.build_parser().parse_args(argv + ["--checkpoint", jck]))
    dim = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(jwl.params))
    v0 = torch.randn(dim, generator=torch.Generator().manual_seed(997))
    jres = jdriver.dataset_spectrum_host(jwl.loss_fn, jwl.params, jwl.batches, ITERS,
                                         v0=jnp.asarray(v0.numpy()), batch_size=4)
    np.testing.assert_allclose(res.alphas.numpy(), np.asarray(jres.alphas), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(res.betas.numpy(), np.asarray(jres.betas), rtol=1e-3, atol=1e-4)
    jev = np.asarray(jslq.ritz_decomposition(jres).eigvals)
    np.testing.assert_allclose(spec.eigvals.numpy(), jev, rtol=1e-3, atol=1e-3 * np.abs(jev).max())
    # the trained landscape is not the init's
    assert abs(float(spec.eigvals.max()) / float(init.eigvals.max()) - 1) > 1e-2


def test_checkpoint_of_another_shape_is_refused(tmp_path):
    """A gpt2-tiny checkpoint at n_positions 64 does not load into a
    workload at --max_length 128 (wpe of 128 rows)."""
    ck = str(tmp_path / "ck.pt")
    args = spectrum.build_parser().parse_args(BASE)
    save_checkpoint(ck, build_workload(args, torch.device("cpu")).params)
    with pytest.raises(ValueError, match=r"/wpe: \(64, 32\) torch.float32 where the template "
                                         r"has \(128, 32\)"):
        spectrum.main(BASE + ["--max_length", "128", "--checkpoint", ck, "--host_loop"])
