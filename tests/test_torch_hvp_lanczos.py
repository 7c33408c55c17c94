"""Port HVP engine and Lanczos against the JAX package on tiny GPT-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.curvature.hvp import hvp as jhvp
from hessian_llm_vision_tpu.krylov.lanczos import host_recurrence_step as jrecurrence
from hessian_llm_vision_tpu.krylov.lanczos import lanczos as jlanczos
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp, hvp_fn
from hessian_llm_vision_tpu_torch.krylov.lanczos import host_recurrence_step, lanczos
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_from_jax
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, T = 4, 16
NORM_KW = {
    "mean": {},
    "sum": {"batch_size": B},
    "dataset": {"batch_size": B, "dataset_size": 3 * B},
}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def pair():
    """(jax loss, jax params, jax batch, jax Flattener, port ...) on one
    tiny GPT-2 with shared weights and tokens."""
    jmodel = JGPT2LMHead(JGPT2Config.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(5), seq_len=T)
    ids = np.random.RandomState(11).randint(0, 256, size=(B, T))
    jbatch = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.ones((B, T), jnp.int32)}
    model = GPT2LMHead(GPT2Config.tiny())
    params = gpt2_params_from_jax(jparams)
    batch = {"input_ids": torch.as_tensor(ids), "attention_mask": torch.ones(B, T, dtype=torch.long)}
    return {
        "jloss": jlosses.lm_loss_fn(jmodel), "jparams": jparams, "jbatch": jbatch,
        "jfl": JFlattener(jparams),
        "loss": losses.lm_loss_fn(model), "params": params, "batch": batch,
        "fl": Flattener(params),
    }


def _vector(n, seed):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def test_grad_matches_jax(pair):
    jl, jg = jax.value_and_grad(pair["jloss"])(pair["jparams"], pair["jbatch"])
    loss, grad = grad_and_loss(pair["loss"], pair["params"], pair["batch"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    assert rel_l2(pair["fl"].flatten(grad).numpy(), pair["jfl"].flatten(jg)) <= 1e-5


@pytest.mark.parametrize("normalization", ["mean", "sum", "dataset"])
def test_hvp_matches_jax_highest(pair, normalization):
    v = _vector(pair["fl"].size, 2)
    jout = jhvp(
        pair["jloss"], pair["jparams"], pair["jbatch"], pair["jfl"].unflatten(jnp.asarray(v)),
        normalization=normalization, precision="highest", **NORM_KW[normalization],
    )
    out = hvp(
        pair["loss"], pair["params"], pair["batch"], pair["fl"].unflatten(torch.as_tensor(v)),
        normalization=normalization, precision="highest", **NORM_KW[normalization],
    )
    assert rel_l2(pair["fl"].flatten(out).numpy(), pair["jfl"].flatten(jout)) <= 1e-5


def test_hvp_fn_rejects_unported_options(pair):
    # every tier of the JAX names is ported; a preset the card has no
    # counterpart for is refused, naming the ones it runs
    with pytest.raises(ValueError, match="TF32_TF32_F32"):
        hvp_fn(pair["loss"], precision="BF16_BF16_F32_X3")
    with pytest.raises(ValueError, match="batch_size"):
        hvp(pair["loss"], pair["params"], pair["batch"], pair["params"], normalization="sum")


@pytest.mark.parametrize("normalization", ["mean", "sum"])
def test_hvp_fn_remat_matches_jax_and_the_plain_hvp(pair, normalization):
    """``remat=True`` (once refused) recomputes the loss in its backward:
    the JAX package's ``jax.checkpoint``-ed HVP within 1e-5, the port's
    plain HVP within 1e-6 (the same products, in the same order)."""
    v = _vector(pair["fl"].size, 2)
    jout = jhvp(pair["jloss"], pair["jparams"], pair["jbatch"],
                pair["jfl"].unflatten(jnp.asarray(v)), normalization=normalization,
                precision="highest", **NORM_KW[normalization])
    vt = pair["fl"].unflatten(torch.as_tensor(v))
    kw = dict(normalization=normalization, precision="highest", **NORM_KW[normalization])
    out = pair["fl"].flatten(hvp_fn(pair["loss"], remat=True, **kw)(
        pair["params"], pair["batch"], vt)).numpy()
    plain = pair["fl"].flatten(hvp_fn(pair["loss"], **kw)(pair["params"], pair["batch"], vt))
    assert rel_l2(out, pair["jfl"].flatten(jout)) <= 1e-5
    assert rel_l2(out, plain.numpy()) <= 1e-6


@pytest.mark.parametrize("reorth", [True, False], ids=["cgs2", "t_only"])
def test_lanczos_tridiag_matches_jax(pair, reorth):
    jfl, fl = pair["jfl"], pair["fl"]
    v0 = _vector(fl.size, 4)

    def jmatvec(v):
        return jfl.flatten(jhvp(
            pair["jloss"], pair["jparams"], pair["jbatch"], jfl.unflatten(v),
            precision="highest",
        ))

    hvp_port = hvp_fn(pair["loss"], precision="highest")

    def matvec(v):
        return fl.flatten(hvp_port(pair["params"], pair["batch"], fl.unflatten(v)))

    jres = jlanczos(jmatvec, jfl.size, 10, v0=jnp.asarray(v0), reorth=reorth,
                    store_basis=reorth)
    res = lanczos(matvec, fl.size, 10, v0=torch.as_tensor(v0), reorth=reorth,
                  store_basis=reorth)
    np.testing.assert_allclose(res.alphas.numpy(), np.asarray(jres.alphas), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(res.betas.numpy(), np.asarray(jres.betas), rtol=1e-3, atol=1e-4)
    assert (res.basis is None) == (not reorth)
    np.testing.assert_allclose(
        np.linalg.eigvalsh(res.tridiag().numpy()),
        np.linalg.eigvalsh(np.asarray(jres.tridiag())), rtol=1e-3, atol=1e-4,
    )


def test_host_recurrence_step_matches_jax():
    rng = np.random.RandomState(8)
    w, q_cur, q_prev = (rng.randn(5000).astype(np.float32) for _ in range(3))
    q_cur /= np.linalg.norm(q_cur)
    beta_prev = np.float32(0.7)
    ja, jb, jq = jrecurrence(jnp.asarray(w), jnp.asarray(q_cur), jnp.asarray(q_prev),
                             jnp.float32(beta_prev))
    a, b, q = host_recurrence_step(torch.as_tensor(w), torch.as_tensor(q_cur),
                                   torch.as_tensor(q_prev), torch.tensor(beta_prev))
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(b), float(jb), rtol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)


def test_lanczos_full_rank_recovers_dense_spectrum():
    """CGS2 Lanczos at full rank reproduces eigvalsh of a dense matrix."""
    rng = np.random.RandomState(0)
    a = rng.randn(24, 24)
    A = torch.as_tensor((a + a.T) / 2, dtype=torch.float32)
    res = lanczos(lambda v: A @ v, 24, 24, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(
        np.linalg.eigvalsh(res.tridiag().double().numpy()),
        np.linalg.eigvalsh(A.double().numpy()), rtol=1e-4, atol=1e-4,
    )
    with pytest.raises(ValueError, match="exactly one"):
        lanczos(lambda v: v, 24, 3)
    with pytest.raises(ValueError, match="store_basis"):
        lanczos(lambda v: v, 24, 3, v0=torch.ones(24), store_basis=False)
