"""Port HostLanczosSGDTrainer against the JAX HostLanczosSGDTrainer on tiny
GPT-2: 4 steps covering a refresh, a frozen step, an EMA refresh and another
frozen step, with the JAX package's own host-vs-fused bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.optim import LanczosSGDConfig as JLanczosSGDConfig
from hessian_llm_vision_tpu.optim.lanczos_sgd_host import (
    HostLanczosSGDTrainer as JHostLanczosSGDTrainer,
)
from hessian_llm_vision_tpu.optim.manual import sgd_momentum as jsgd_momentum
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.convert import (
    gpt2_params_from_jax,
    gpt2_params_to_jax,
)
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import LanczosSGDConfig
from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import (
    HostLanczosSGDTrainer,
    HostLayerwiseLanczosSGDTrainer,
)
from hessian_llm_vision_tpu_torch.optim.manual import sgd_momentum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, T, STEPS = 4, 16, 4
# "mean" HVPs with delta=3 put the Ritz values (about -50..30 here) where the
# adjustment moves the gradient by ~5%, far from the pole at λ = -δ
CFG = dict(k=4, delta=3.0, lr=0.05, momentum=0.9, weight_decay=1e-4,
           refresh_every=2, lanczos_momentum=0.5, normalization="mean")


def _batches(accum):
    ids = np.random.RandomState(21).randint(0, 256, size=(STEPS, B, T))
    shape = (accum, B // accum, T) if accum > 1 else (B, T)
    return [ids[i].reshape(shape) for i in range(STEPS)]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("basis", ["f32", "bf16"])
def test_trainer_matches_jax_host_trainer(accum, basis):
    jmodel = JGPT2LMHead(JGPT2Config.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(9), seq_len=T)
    jtrainer = JHostLanczosSGDTrainer(
        jlosses.lm_loss_fn(jmodel), jparams, JLanczosSGDConfig(accum_steps=accum, **CFG),
        batch_size=B // accum,
        basis_dtype=jnp.bfloat16 if basis == "bf16" else jnp.float32,
    )
    model = GPT2LMHead(GPT2Config.tiny())
    params = gpt2_params_from_jax(jparams)
    trainer = HostLanczosSGDTrainer(
        losses.lm_loss_fn(model), params, LanczosSGDConfig(accum_steps=accum, **CFG),
        batch_size=B // accum,
        basis_dtype=torch.bfloat16 if basis == "bf16" else torch.float32,
    )
    jstate, state = jtrainer.init(jparams), trainer.init(params)
    for step, ids in enumerate(_batches(accum)):
        jstate, jm = jtrainer.step(jstate, {"input_ids": jnp.asarray(ids)})
        state, m = trainer.step(state, {"input_ids": torch.as_tensor(ids)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["eig_max"]), float(jm["eig_max"]), rtol=1e-3)
        got = gpt2_params_to_jax(state.params)
        for path, leaf in jax.tree_util.tree_leaves_with_path(jstate.params):
            node = got
            for key in path:
                node = node[key.key]
            np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-3, atol=2e-5,
                                       err_msg=f"step {step} {jax.tree_util.keystr(path)}")
    assert state.step == STEPS and state.basis.dtype == trainer.basis_dtype
    # refresh_every=2: the frozen steps keep the refreshed spectrum
    assert state.eigvals.shape == (CFG["k"],)


def test_refresh_batch_size_and_unported_options():
    model = GPT2LMHead(GPT2Config.tiny(), generator=torch.Generator().manual_seed(0))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss_fn = losses.lm_loss_fn(model)
    cfg = LanczosSGDConfig(k=3, delta=1e-2, lr=0.01, normalization="mean")
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 256, size=(B, T)))
    trainer = HostLanczosSGDTrainer(loss_fn, params, cfg, refresh_batch_size=2)
    full = HostLanczosSGDTrainer(loss_fn, params, cfg)
    g = trainer._grad(params, {"input_ids": ids})[1]
    ev_sub, _ = trainer.refresh_spectrum(params, {"input_ids": ids[:2]}, g)
    state, m = trainer.step(trainer.init({n: p.clone() for n, p in params.items()}),
                            {"input_ids": ids})
    torch.testing.assert_close(state.eigvals, ev_sub)
    ev_full, _ = full.refresh_spectrum(params, {"input_ids": ids}, g)
    assert not torch.allclose(ev_sub, ev_full)
    with pytest.raises(NotImplementedError, match="refresh_linearized"):
        HostLanczosSGDTrainer(loss_fn, params, cfg, refresh_linearized=True)
    with pytest.raises(NotImplementedError, match="precision guard"):
        trainer.precision_guard = object()
    with pytest.raises(NotImplementedError, match="not ported"):
        HostLayerwiseLanczosSGDTrainer(loss_fn, params, cfg)


def test_sgd_momentum_matches_jax():
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    jtx = jsgd_momentum(0.1, momentum=0.9, weight_decay=0.01)
    tx = sgd_momentum(0.1, momentum=0.9, weight_decay=0.01)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.as_tensor(v) for n, v in params.items()}
    jst, st = jtx.init(jp), tx.init(tp)
    for _ in range(3):
        grads = {n: rng.randn(*v.shape).astype(np.float32) for n, v in params.items()}
        jup, jst = jtx.update({n: jnp.asarray(v) for n, v in grads.items()}, jst, jp)
        up, st = tx.update({n: torch.as_tensor(v) for n, v in grads.items()}, st, tp)
        jp = {n: jp[n] + jup[n] for n in jp}
        tp = {n: tp[n] + up[n] for n in tp}
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-7)
