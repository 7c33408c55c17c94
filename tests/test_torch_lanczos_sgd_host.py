"""Port HostLanczosSGDTrainer against the JAX HostLanczosSGDTrainer on tiny
GPT-2: 4 steps covering a refresh, a frozen step, an EMA refresh and another
frozen step, with the JAX package's own host-vs-fused bars."""

import dataclasses

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
    # the linearized refresh gives the same spectrum from one residual pass
    lin = HostLanczosSGDTrainer(loss_fn, params, cfg, refresh_batch_size=2,
                                refresh_linearized=True)
    ev_lin, V_lin = lin.refresh_spectrum(params, {"input_ids": ids[:2]}, g)
    torch.testing.assert_close(ev_lin, ev_sub, rtol=1e-5, atol=1e-6)
    # the precision guard is ported: the attribute takes a guard
    trainer.precision_guard = guard = object()
    assert trainer.precision_guard is guard
    # the layer-wise trainer is ported; like the JAX CLI it takes no accumulation
    with pytest.raises(ValueError, match="accum_steps > 1 is not supported"):
        HostLayerwiseLanczosSGDTrainer(loss_fn, params, dataclasses.replace(cfg, accum_steps=2))


def test_linearized_refresh_matches_jax_and_the_standard_trainer():
    """refresh_linearized=True: 4 steps against the JAX package's linearized
    trainer at the bars of the test above, and against the port's standard
    trainer (JAX ``test_linearized.py``: eigvals and params rtol 1e-4)."""
    jmodel = JGPT2LMHead(JGPT2Config.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(9), seq_len=T)
    jtrainer = JHostLanczosSGDTrainer(jlosses.lm_loss_fn(jmodel), jparams,
                                      JLanczosSGDConfig(**CFG), batch_size=B,
                                      refresh_linearized=True)
    model = GPT2LMHead(GPT2Config.tiny())
    trainers = [HostLanczosSGDTrainer(losses.lm_loss_fn(model), gpt2_params_from_jax(jparams),
                                      LanczosSGDConfig(**CFG), batch_size=B,
                                      refresh_linearized=lin) for lin in (True, False)]
    jstate = jtrainer.init(jparams)
    states = [t.init(gpt2_params_from_jax(jparams)) for t in trainers]
    for ids in _batches(1):
        jstate, jm = jtrainer.step(jstate, {"input_ids": jnp.asarray(ids)})
        (state, m), (std, m_std) = (t.step(st, {"input_ids": torch.as_tensor(ids)})
                                    for t, st in zip(trainers, states))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["eig_max"]), float(jm["eig_max"]), rtol=1e-3)
        torch.testing.assert_close(state.eigvals, std.eigvals, rtol=1e-4, atol=1e-6)
    for name, p in state.params.items():
        torch.testing.assert_close(p, std.params[name], rtol=1e-4, atol=1e-6)
    got = gpt2_params_to_jax(state.params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jstate.params):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-3, atol=2e-5)


def test_train_cli_refresh_linearized(capsys, tmp_path):
    """The train CLI with --refresh_linearized walks the standard CLI's
    steps (JAX ``test_linearized.py::test_train_cli_refresh_linearized``),
    and refuses other optimisers with the JAX message."""
    from hessian_llm_vision_tpu_torch.cli import train

    argv = ["--model", "gpt2-tiny", "--optimiser", "lanczos-host", "--batch_size", "2",
            "--max_length", "16", "--num_batches", "2", "--max_steps", "2", "--k", "3", "--cpu",
            "--out", str(tmp_path)]
    runs = []
    for extra in (["--refresh_linearized"], []):
        recs = []
        train.main(argv + extra, on_step=lambda step, rec: recs.append(rec))
        runs.append(recs)
    assert "loss" in capsys.readouterr().out
    for lin, std in zip(*runs, strict=True):
        np.testing.assert_allclose(lin["loss"], std["loss"], rtol=1e-6)
        np.testing.assert_allclose(lin["eig_max"], std["eig_max"], rtol=1e-4)
    with pytest.raises(SystemExit, match="^--refresh_linearized applies to --optimiser "
                                         "lanczos-host$"):
        train.main(argv + ["--optimiser", "adam", "--refresh_linearized"])


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
