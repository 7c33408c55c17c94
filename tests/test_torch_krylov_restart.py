"""Port estimators beyond plain SLQ -- thick-restart Lanczos, KPM, the
deflated density, Hutchinson/Hutch++ and the host-basis Lanczos --
against the JAX package on small dense operators and tiny GPT-2, with the
same numpy inputs.  Where the JAX function draws from a key, the test
makes the same draw in JAX and hands the array to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.curvature.operators import MatrixOperator as JMatrixOperator
from hessian_llm_vision_tpu.krylov import deflate as jdeflate
from hessian_llm_vision_tpu.krylov import driver as jdriver
from hessian_llm_vision_tpu.krylov import host_lanczos as jhost
from hessian_llm_vision_tpu.krylov import kpm as jkpm
from hessian_llm_vision_tpu.krylov import thick_restart as jtr
from hessian_llm_vision_tpu.krylov import trace as jtrace
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.curvature.operators import MatrixOperator
from hessian_llm_vision_tpu_torch.krylov import deflate, driver, host_lanczos, kpm
from hessian_llm_vision_tpu_torch.krylov import thick_restart as tr
from hessian_llm_vision_tpu_torch.krylov import trace
from hessian_llm_vision_tpu_torch.krylov.compare import subspace_overlap
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_to_jax
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.ops import kernels
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P_124M = 124_046_592


def _spd_like(seed, d=200):
    """A symmetric random matrix with planted outliers at both ends (the
    JAX package's thick-restart fixture)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(d, d).astype(np.float32) / np.sqrt(d)
    M = (A + A.T) / 2
    u, _ = np.linalg.qr(rng.randn(d, 2).astype(np.float32))
    return (M + 4.0 * np.outer(u[:, 0], u[:, 0]) - 3.0 * np.outer(u[:, 1], u[:, 1])).astype(np.float32)


def _vector(n, seed):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _ops(M):
    return JMatrixOperator(jnp.asarray(M)), MatrixOperator(torch.as_tensor(M))


# ------------------------------------------------------------ thick restart

@pytest.mark.parametrize("which", ["lm", "la", "sa", "both"])
def test_thick_restart_f32_matches_jax(which):
    M = _spd_like(0)
    jop, op = _ops(M)
    v0 = _vector(200, 1)
    kw = dict(inner=16, tol=1e-6, which=which)
    jres = jtr.lanczos_thick_restart(jop.matvec, 200, 4, v0=jnp.asarray(v0), **kw)
    res = tr.lanczos_thick_restart(op.matvec, 200, 4, v0=torch.as_tensor(v0), **kw)
    assert res.converged and jres.converged
    assert (res.restarts, res.matvecs) == (jres.restarts, jres.matvecs)
    scale = np.abs(jres.eigvals).max()
    np.testing.assert_allclose(res.eigvals, jres.eigvals, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(res.residuals, jres.residuals, rtol=0, atol=1e-5 * scale)
    assert res.vectors.dtype == torch.float32 and res.vectors.shape == (4, 200)
    assert subspace_overlap(res.vectors, np.asarray(jres.vectors)) >= 1 - 1e-5
    # against the dense answer: true residuals, orthonormal rows
    V = res.vectors.double().numpy()
    r = M.astype(np.float64) @ V.T - V.T * res.eigvals
    assert np.linalg.norm(r, axis=0).max() <= 1e-4 * scale
    np.testing.assert_allclose(V @ V.T, np.eye(4), atol=1e-5)


def test_thick_restart_bf16_buffer_matches_jax():
    M = _spd_like(2)
    jop, op = _ops(M)
    v0 = _vector(200, 3)
    kw = dict(inner=16, tol=5e-3)
    jres = jtr.lanczos_thick_restart(jop.matvec, 200, 4, v0=jnp.asarray(v0),
                                     store_dtype=jnp.bfloat16, **kw)
    res = tr.lanczos_thick_restart(op.matvec, 200, 4, v0=torch.as_tensor(v0),
                                   store_dtype=torch.bfloat16, **kw)
    scale = np.abs(jres.eigvals).max()
    np.testing.assert_allclose(res.eigvals, jres.eigvals, rtol=2e-3, atol=2e-3 * scale)
    assert subspace_overlap(res.vectors, np.asarray(jres.vectors)) >= 1 - 2e-3
    dense = np.linalg.eigvalsh(M.astype(np.float64))
    want = np.sort(dense[np.argsort(np.abs(dense))[-4:]])
    np.testing.assert_allclose(res.eigvals, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_orth_body_matches_jax(dtype):
    """The CGS2 pass through ops.spectral.project_out (the plain version on
    the CPU) against JAX's masked full-buffer _orth_body: the bf16 plain
    version rounds w and the coefficients to bf16 exactly as JAX does."""
    rng = np.random.RandomState(4)
    Q = np.zeros((9, 300), np.float32)
    Q[:5] = np.linalg.qr(rng.randn(300, 5))[0].T
    Q[5:] = rng.randn(4, 300)  # rows past n_filled must not count
    w = rng.randn(300).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jQ = jnp.asarray(Q).astype(jdt)
    jw, jn, jn0 = jtr._orth_body(jQ, jnp.asarray(w), 5)
    tQ = torch.as_tensor(np.asarray(jQ.astype(jnp.float32))).to(dtype)
    out, n, n0 = tr._orth_body(tQ, torch.as_tensor(w), 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose([float(n), float(n0)], [float(jn), float(jn0)], rtol=1e-6)
    if dtype == torch.float32:
        assert np.abs(Q[:5] @ out.numpy()).max() <= 1e-6


def test_thick_restart_breakdown_rotation_and_checks():
    d = 30
    jop, op = _ops(np.eye(d, dtype=np.float32))
    # identity: an invariant subspace at once, the redirect fires, finish
    res = tr.lanczos_thick_restart(op.matvec, d, 3, generator=torch.Generator().manual_seed(4),
                                   inner=8, max_restarts=5)
    np.testing.assert_allclose(res.eigvals, np.ones(3), atol=1e-5)
    with pytest.raises(ValueError, match="exactly one"):
        tr.lanczos_thick_restart(op.matvec, d, 3)
    with pytest.raises(ValueError, match="inner >= k\\+4"):
        tr.lanczos_thick_restart(op.matvec, d, 8, v0=torch.ones(d), inner=8)
    # the in-place restart: rows 0..kk-1 <- S^T Q, row kk <- old row m, rest 0
    rng = np.random.RandomState(5)
    Q = torch.as_tensor(rng.randn(7, 50).astype(np.float32))
    S = torch.as_tensor(rng.randn(7, 3).astype(np.float32))
    S[-1] = 0
    want = S.T @ Q
    last = Q[-1].clone()
    tr._restart_rotate(Q, S)
    torch.testing.assert_close(Q[:3], want)
    assert torch.equal(Q[3], last) and not Q[4:].any()
    # bf16 rows: the chunked f32 rotation equals the whole upcast product
    Qb = torch.as_tensor(rng.randn(7, 50).astype(np.float32)).bfloat16()
    old = tr._ROTATE_CHUNK
    try:
        tr._ROTATE_CHUNK = 16
        torch.testing.assert_close(tr._rotate(Qb, S), S.T @ Qb.float())
        # the in-place restart of bf16 rows: f32 coefficients and sums, one
        # rounding to bf16
        want_b, last_b = (S.T @ Qb.float()).bfloat16(), Qb[-1].clone()
        tr._restart_rotate(Qb, S)
        assert torch.equal(Qb[:3], want_b) and torch.equal(Qb[3], last_b) and not Qb[4:].any()
    finally:
        tr._ROTATE_CHUNK = old
    assert (list(tr._select(np.array([-5.0, -1, 0.5, 2, 6]), 3, "both"))
            == list(jtr._select(np.array([-5.0, -1, 0.5, 2, 6]), 3, "both")))


# ------------------------------------------------- dataset thick restart

@pytest.fixture(scope="module")
def tiny():
    """Tiny GPT-2 with shared weights and 2 batches of shared tokens, in
    both packages."""
    model = GPT2LMHead(GPT2Config.tiny(), generator=torch.Generator().manual_seed(5))
    params = {n: p.detach() for n, p in model.named_parameters()}
    jparams = jax.tree_util.tree_map(jnp.asarray, gpt2_params_to_jax(params))
    ids = np.random.RandomState(11).randint(0, 256, size=(2, 2, 16))
    mask = np.ones((2, 16), np.int32)
    return {
        "jloss": jlosses.lm_loss_fn(JGPT2LMHead(JGPT2Config.tiny())), "jparams": jparams,
        "jbatches": [{"input_ids": jnp.asarray(i), "attention_mask": jnp.asarray(mask)}
                     for i in ids],
        "loss": losses.lm_loss_fn(model), "params": params,
        "batches": [{"input_ids": torch.as_tensor(i), "attention_mask": torch.as_tensor(mask)}
                    for i in ids],
        "dim": Flattener(params).size,
    }


def test_dataset_thick_restart_host_matches_jax(tiny):
    p = tiny
    v0 = _vector(p["dim"], 6)
    kw = dict(inner=10, tol=1e-4, normalization="mean", precision="highest")
    jres = jdriver.dataset_thick_restart_host(p["jloss"], p["jparams"], p["jbatches"], 2,
                                              v0=jnp.asarray(v0), flattener=JFlattener(p["jparams"]),
                                              **kw)
    res = driver.dataset_thick_restart_host(p["loss"], p["params"], p["batches"], 2,
                                            v0=torch.as_tensor(v0), **kw)
    assert res.converged and jres.converged
    scale = np.abs(jres.eigvals).max()
    np.testing.assert_allclose(res.eigvals, jres.eigvals, rtol=1e-4, atol=1e-4 * scale)
    assert subspace_overlap(res.vectors, np.asarray(jres.vectors)) >= 1 - 1e-4
    assert res.matvecs == jres.matvecs


# ------------------------------------------------------------------- KPM

def _jax_probes(key, n, dim):
    """kpm_density's probe draws, as the JAX package makes them."""
    out = []
    for _ in range(n):
        key, kp = jax.random.split(key)
        out.append(np.asarray(jax.random.rademacher(kp, (dim,), jnp.float32)
                              / jnp.sqrt(jnp.float32(dim))))
    return np.stack(out)


def test_kpm_density_and_range_match_jax():
    M = _spd_like(7, d=150)
    jop, op = _ops(M)
    key = jax.random.PRNGKey(8)
    jlo, jhi = jkpm.estimate_spectral_range(jop.matvec, 150, key)
    v0 = np.asarray(jax.random.normal(key, (150,), dtype=jnp.float32))
    lo, hi = kpm.estimate_spectral_range(op.matvec, 150, v0=torch.as_tensor(v0))
    np.testing.assert_allclose([lo, hi], [jlo, jhi], rtol=1e-5)
    jres = jkpm.kpm_density(jop.matvec, 150, 30, key, num_probes=2, lmin=jlo, lmax=jhi)
    res = kpm.kpm_density(op.matvec, 150, 30, probes=torch.as_tensor(_jax_probes(key, 2, 150)),
                          lmin=jlo, lmax=jhi)
    assert res.num_probes == jres.num_probes == 2
    np.testing.assert_allclose(res.raw_moments, jres.raw_moments, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.moments, jres.moments, rtol=0, atol=1e-5)
    assert (res.center, res.radius) == (jres.center, jres.radius)
    grid = np.linspace(jlo, jhi, 41)[1:-1]  # the ends amplify by 1/sqrt(1 - x^2)
    np.testing.assert_allclose(res.density(grid), jres.density(grid), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res.trace_estimate(150), jres.trace_estimate(150),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kpm._jackson(30), jkpm._jackson(30), rtol=1e-12)


def test_kpm_draws_and_checks():
    _, op = _ops(_spd_like(9, d=64))
    gen = torch.Generator().manual_seed(3)
    res = kpm.kpm_density(op.matvec, 64, 20, gen, num_probes=3)
    np.testing.assert_allclose(res.raw_moments[0], 1.0, atol=1e-6)  # unit probes
    # the draws, in order: the range's start vector, then the probes
    gen = torch.Generator().manual_seed(3)
    v0 = torch.randn(64, generator=gen)
    lo, hi = kpm.estimate_spectral_range(op.matvec, 64, v0=v0)
    probes = torch.stack([kpm.rademacher(gen, 64) / 8.0 for _ in range(3)])
    again = kpm.kpm_density(op.matvec, 64, 20, probes=probes, lmin=lo, lmax=hi)
    np.testing.assert_array_equal(again.raw_moments, res.raw_moments)
    # 8 signs per random byte, the low bit first; n need not divide by 8
    signs = kpm.rademacher(torch.Generator().manual_seed(9), 1003)
    byte = torch.randint(0, 256, (126,), generator=torch.Generator().manual_seed(9),
                         dtype=torch.uint8)
    assert signs.shape == (1003,) and signs.dtype == torch.float32
    assert torch.equal(signs[:8], torch.tensor([1.0 if int(byte[0]) >> b & 1 else -1.0
                                                for b in range(8)]))
    assert set(np.unique(signs.numpy())) == {-1.0, 1.0} and abs(float(signs.mean())) < 0.1
    with pytest.raises(ValueError, match="num_moments"):
        kpm.kpm_density(op.matvec, 64, 1, gen)
    with pytest.raises(ValueError, match="both lmin and lmax"):
        kpm.kpm_density(op.matvec, 64, 5, gen, lmin=0.0)
    with pytest.raises(ValueError, match="generator"):
        kpm.kpm_density(op.matvec, 64, 5, lmin=0.0, lmax=1.0)


def test_deflated_density_matches_jax():
    d, k = 200, 2
    M = _spd_like(10, d)
    jop, op = _ops(M)
    dense = np.linalg.eigvalsh(M.astype(np.float64))
    bulk = np.sort(dense[np.argsort(np.abs(dense))[:-k]])
    lmin, lmax = float(bulk[0] * 1.05), float(bulk[-1] * 1.05)
    key = jax.random.PRNGKey(11)
    key_tr, key_kpm = jax.random.split(key)
    kw = dict(inner=14, tol=1e-6, lmin=lmin, lmax=lmax, num_probes=2)
    jres = jdeflate.deflated_density(jop.matvec, d, k, 40, key, **kw)
    res = deflate.deflated_density(
        op.matvec, d, k, 40,
        v0=torch.as_tensor(np.asarray(jax.random.normal(key_tr, (d,), jnp.float32))),
        probes=torch.as_tensor(_jax_probes(key_kpm, 2, d)), **kw)
    assert res.converged and jres.converged and res.matvecs == jres.matvecs
    np.testing.assert_allclose(res.eigvals, jres.eigvals, rtol=1e-5)
    np.testing.assert_allclose(res.eigvals, np.sort(dense[np.argsort(np.abs(dense))[-k:]]),
                               rtol=1e-5)
    np.testing.assert_allclose(res.bulk.raw_moments, jres.bulk.raw_moments, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.bulk.moments, jres.bulk.moments, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.trace_estimate(d), jres.trace_estimate(d), rtol=1e-3, atol=1e-3)
    grid = np.linspace(lmin, lmax, 21)[1:-1]
    np.testing.assert_allclose(res.density(grid), jres.density(grid), rtol=1e-3, atol=1e-4)


def test_deflated_matvec_projects_out_and_bf16_basis():
    d = 120
    M = _spd_like(12, d)
    _, op = _ops(M)
    res = deflate.deflated_density(op.matvec, d, 2, 10, torch.Generator().manual_seed(0),
                                   deflate_dtype=torch.bfloat16, store_dtype=torch.bfloat16,
                                   tol=2e-3)
    assert res.converged and res.matvecs > 12 + 9
    U = torch.as_tensor(np.linalg.eigh(M.astype(np.float64))[1][:, [0, -1]].T.copy()).float()
    mv = deflate.deflated_matvec(op.matvec, U)
    for u in U:  # the spike directions go to 0 ...
        assert float(torch.linalg.vector_norm(mv(u))) <= 1e-5 * np.abs(res.eigvals).max()
    x = torch.as_tensor(_vector(d, 13))
    px = x - U.T @ (U @ x)  # ... and the rest keeps A's action
    want = op.matvec(px)
    torch.testing.assert_close(mv(px), want - U.T @ (U @ want))


# ----------------------------------------------------------- trace estimators

def test_hutchpp_and_hutchinson_match_jax():
    d = 160
    M = _spd_like(14, d)
    jop, op = _ops(M)
    key = jax.random.PRNGKey(15)
    k_sketch, k_hutch = jax.random.split(key)
    m = 12
    s, g = 4, 4
    S = np.asarray(jax.random.rademacher(k_sketch, (d, s), jnp.float32))
    G = np.asarray(jax.random.rademacher(k_hutch, (d, g), jnp.float32))
    jt = float(jtrace.hutchpp_trace(jop.matvec, d, m, key, vmapped=False))
    t = float(trace.hutchpp_trace(op.matvec, d, m, sketch=torch.as_tensor(S.T),
                                  probes=torch.as_tensor(G.T)))
    np.testing.assert_allclose(t, jt, rtol=1e-5)
    V = np.asarray(jax.random.rademacher(key, (d, 7), jnp.float32))
    np.testing.assert_allclose(
        float(trace.hutchinson_trace(op.matvec, d, 7, probes=torch.as_tensor(V.T))),
        float(jtrace.hutchinson_trace(jop.matvec, d, 7, key)), rtol=1e-5)
    # Hutch++ is exact on a matrix of rank <= s
    u = np.linalg.qr(np.random.RandomState(16).randn(d, 3))[0]
    low = (u * np.array([5.0, -2.0, 0.5])) @ u.T
    _, lop = _ops(low.astype(np.float32))
    exact = float(trace.hutchpp_trace(lop.matvec, d, 9, torch.Generator().manual_seed(1)))
    np.testing.assert_allclose(exact, 3.5, rtol=1e-5)
    with pytest.raises(ValueError, match="num_probes >= 3"):
        trace.hutchpp_trace(op.matvec, d, 2, torch.Generator())
    with pytest.raises(ValueError, match=">= 1"):
        trace.hutchinson_trace(op.matvec, d, 0, torch.Generator())


# ---------------------------------------------------------- host-basis Lanczos

@pytest.mark.parametrize("reorth", [True, False], ids=["cgs2", "plain"])
def test_lanczos_host_basis_matches_jax(reorth, monkeypatch):
    """With CGS2 against the JAX package.  Without it, against the port's
    own T-only ``lanczos``: the JAX package's host-basis loop never updates
    beta_prev, so its three-term recurrence drops the beta term, which only
    the CGS2 pass repairs (ROADMAP Queue C).  The float64 and float32
    recurrences part once orthogonality is lost, so that case runs 8
    iterations."""
    d, n = 180, (25 if reorth else 8)
    M = _spd_like(17, d)
    jop, op = _ops(M)
    v0 = _vector(d, 18)
    if reorth:
        jres = jhost.lanczos_host_basis(jop.matvec, d, n, v0=v0, reorth=True)
    else:
        ref = lanczos(op.matvec, d, n, v0=torch.as_tensor(v0), reorth=False)
        jres = ref._replace(alphas=ref.alphas.numpy(), betas=ref.betas.numpy(),
                            basis=ref.basis.numpy())
    monkeypatch.setattr(host_lanczos, "_CHUNK", 64)  # several P-chunks in the CGS2
    seen = []
    res = host_lanczos.lanczos_host_basis(op.matvec, d, n, v0=torch.as_tensor(v0), reorth=reorth,
                                          callback=lambda i, a, b: seen.append((i, len(a), len(b))))
    scale = np.abs(np.asarray(jres.alphas)).max()
    np.testing.assert_allclose(res.alphas.numpy(), np.asarray(jres.alphas), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(res.betas.numpy(), np.asarray(jres.betas), rtol=1e-5,
                               atol=1e-5 * scale)
    assert res.basis.dtype == torch.float32 and res.basis.device.type == "cpu"
    np.testing.assert_allclose(res.basis.numpy(), jres.basis, rtol=0, atol=1e-5)
    assert seen[0] == (0, 1, 0) and seen[-1] == (n - 1, n, n - 1)
    with pytest.raises(ValueError, match="exactly one"):
        host_lanczos.lanczos_host_basis(op.matvec, d, 3)


# ------------------------------------------------------ rank-k kernel limits

@pytest.mark.parametrize("k", list(range(1, 18)))
def test_rank_k_plan_holds_thick_restart_rows_at_124m(k):
    """The CGS2 pass of thick restart applies k = 1 .. inner+1 filled rows
    (17 at inner 16), the deflation projector k = --kpm_deflate: every one
    within the wrapper's limit and the pass-1 plan's arithmetic at GPT-2
    124M's P, in both dtypes (an H100's 132 SMs, 2 resident ring blocks)."""
    assert 1 <= k <= kernels._MAX_K
    for dtype in (torch.float32, torch.bfloat16):
        plan = kernels.dots_plan(k, P_124M, dtype, ptrs=(0, 1 << 20), sms=132,
                                 blocks_per_sm=lambda aligned, smem: 2)
        assert plan.aligned and plan.rows == -(-k // -(-k // 16))
        assert plan.smem_bytes <= 232_448 - 1024 and plan.nblocks == 264
        assert plan.chunk * plan.nblocks <= P_124M and k * P_124M < 2**63
