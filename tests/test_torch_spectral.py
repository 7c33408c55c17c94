"""Port rank-k ops (plain versions, the CPU path) against the JAX package,
including its Pallas kernel pair in interpret mode.  The CUDA kernels are
held against these plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.ops import spectral as jspectral
from hessian_llm_vision_tpu_torch.ops import kernels, spectral


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(k, p, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(p).astype(np.float32)
    V = (rng.randn(k, p) / np.sqrt(p)).astype(np.float32)
    c = rng.randn(k).astype(np.float32)
    return g, V, c


@pytest.mark.parametrize("k,p", [(10, 8192), (3, 20000), (35, 16384)])
def test_plain_rank_k_matches_jax_reference_and_pallas(k, p):
    g, V, c = _inputs(k, p)
    out = spectral.rank_k_apply(torch.as_tensor(g), torch.as_tensor(V), torch.as_tensor(c))
    ref = jspectral.rank_k_apply_reference(jnp.asarray(g), jnp.asarray(V), jnp.asarray(c))
    pallas = jspectral._rank_k_apply_pallas(
        jnp.asarray(g), jnp.asarray(V), jnp.asarray(c), interpret=True
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-5)
    # the two passes compose to the whole
    tg, tV, tc = map(torch.as_tensor, (g, V, c))
    w = spectral.rank_k_dots_reference(tg, tV, tc)
    torch.testing.assert_close(spectral.rank_k_axpy_reference(tg, tV, w), out, rtol=0, atol=0)


def test_bf16_plain_matches_jax_bf16():
    k, p = 10, 5000
    g, V, c = _inputs(k, p, seed=1)
    c = np.linspace(0.5, 3.0, k).astype(np.float32)
    Vb = torch.as_tensor(V).to(torch.bfloat16)
    out = spectral.rank_k_apply_bf16(torch.as_tensor(g), Vb, torch.as_tensor(c)).numpy()
    jout = np.asarray(jspectral.rank_k_apply_bf16(
        jnp.asarray(g), jnp.asarray(V).astype(jnp.bfloat16), jnp.asarray(c)
    ))
    assert np.linalg.norm(out - jout) / np.linalg.norm(jout) <= 2e-3
    ref = np.asarray(jspectral.rank_k_apply_reference(jnp.asarray(g), jnp.asarray(V), jnp.asarray(c)))
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 2e-3
    # the CPU dispatcher routes a bf16 basis to the bf16 plain version
    auto = spectral.rank_k_apply(torch.as_tensor(g), Vb, torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(auto, out)


def test_adjust_coeffs_matches_jax_with_zero_mode_and_pole():
    delta = 1e-2
    ev = np.array([-3.0, -delta * (1 + 1e-9), -0.5, 0.0, 1e-9, 0.3, 2.0, 40.0], np.float32)
    c = spectral.adjust_coeffs(torch.as_tensor(ev), delta).numpy()
    jc = np.asarray(jspectral.adjust_coeffs(jnp.asarray(ev), delta))
    np.testing.assert_allclose(c, jc, rtol=1e-6)
    assert np.all(np.isfinite(c))
    assert c[1] == 0 and c[3] == 0 and c[4] == 0  # pole, exact zero, below the floor
    assert c[0] != 0 and c[-1] != 0


def test_spectral_adjust_and_project_out_match_jax():
    k, p = 6, 700
    g, V, _ = _inputs(k, p, seed=2)
    Q, _ = np.linalg.qr(np.random.RandomState(3).randn(p, k))
    V = Q.T.astype(np.float32)
    ev = np.array([-2.0, -0.5, 0.3, 1.0, 5.0, 40.0], np.float32)
    delta = 1e-2
    tg, tV = torch.as_tensor(g), torch.as_tensor(V)
    adj = spectral.spectral_adjust(tg, tV, torch.as_tensor(ev), delta).numpy()
    jadj = np.asarray(jspectral.spectral_adjust(jnp.asarray(g), jnp.asarray(V), jnp.asarray(ev), delta))
    np.testing.assert_allclose(adj, jadj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        spectral.spectral_adjust_reference(tg, tV, torch.as_tensor(ev), delta).numpy(), jadj,
        rtol=1e-5, atol=1e-5,
    )
    proj = spectral.project_out(tg, tV).numpy()
    np.testing.assert_allclose(proj, np.asarray(jspectral.project_out(jnp.asarray(g), jnp.asarray(V))),
                               atol=1e-5)
    np.testing.assert_allclose(V @ proj, np.zeros(k), atol=1e-5)
    np.testing.assert_allclose(spectral.project_out_reference(tg, tV).numpy(), proj, atol=1e-6)


def test_kernel_wrappers_run_plain_versions_on_cpu():
    """CPU tensors take the plain versions: nothing is built or launched."""
    g, V, c = map(torch.as_tensor, _inputs(3, 64))
    before = dict(kernels.LAUNCHES)
    w = kernels.rank_k_dots(g, V, c)
    torch.testing.assert_close(w, spectral.rank_k_dots_reference(g, V, c), rtol=0, atol=0)
    torch.testing.assert_close(kernels.rank_k_axpy(g, V, w),
                               spectral.rank_k_axpy_reference(g, V, w), rtol=0, atol=0)
    torch.testing.assert_close(kernels.rank_k_apply(g, V, c),
                               spectral.rank_k_apply_reference(g, V, c), rtol=0, atol=0)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.rank_k_dots(g.to("meta"), V.to("meta"), c.to("meta"))
    with pytest.raises(ValueError, match="no path"):
        spectral.rank_k_apply(g.to("meta"), V.to("meta"), c)


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    with pytest.raises(FileNotFoundError, match="no CUDA source"):
        kernels.build(["no_such_kernel"])
