"""Port train loop against the JAX loop on gpt2-tiny with the JAX params
carried across: Adam, SGD and raw SGD, and accumulation over 2
micro-batches, over 5 steps in 2 epochs; the per-step losses and the logged
EMAs within 1e-5, the logged step indices equal.  Also the epoch and state
hooks, the evaluation helpers, the spans and the profiler's trace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.optim import manual as jmanual
from hessian_llm_vision_tpu.train import evaluation as jevaluation
from hessian_llm_vision_tpu.train import loop as jloop
from hessian_llm_vision_tpu.train.accumulate import to_microbatches as jto_microbatches
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_from_jax, gpt2_params_to_jax
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.obs.timing import profile_trace, recording, span
from hessian_llm_vision_tpu_torch.optim import manual
from hessian_llm_vision_tpu_torch.train import evaluation, loop
from hessian_llm_vision_tpu_torch.train.accumulate import to_microbatches


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, T, N_BATCHES, EPOCHS, MAX_STEPS, LOG_EVERY = 4, 16, 3, 2, 5, 3
RULES = {
    "adam": lambda m: m.manual_adam(1e-3),
    "sgd": lambda m: m.sgd_momentum(0.1, momentum=0.9, weight_decay=1e-3),
    "raw": lambda m: m.raw_sgd(0.1),
}


def _models():
    jmodel = JGPT2LMHead(JGPT2Config.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(3), seq_len=T)
    return jmodel, jparams, GPT2LMHead(GPT2Config.tiny()), gpt2_params_from_jax(jparams)


def _ids():
    return np.random.RandomState(5).randint(0, 256, size=(N_BATCHES, B, T))


def _recording(step_fn, losses_out, to_float):
    def step(state, batch):
        state, metrics = step_fn(state, batch)
        losses_out.append(to_float(metrics["loss"]))
        return state, metrics
    return step


@pytest.mark.parametrize("rule,accum", [("adam", 1), ("sgd", 1), ("raw", 1), ("adam", 2)],
                         ids=["adam", "sgd", "raw", "adam_accum2"])
def test_train_matches_jax_train(rule, accum):
    jmodel, jparams, model, params = _models()
    ids = _ids()
    jinit, jstep = jloop.make_train_step(jlosses.lm_loss_fn(jmodel), RULES[rule](jmanual),
                                         accum_steps=accum)
    init, step = loop.make_train_step(losses.lm_loss_fn(model), RULES[rule](manual),
                                      accum_steps=accum)
    jbatches = [{"input_ids": jnp.asarray(b)} for b in ids]
    batches = [{"input_ids": torch.as_tensor(b)} for b in ids]
    if accum > 1:
        jbatches = [jto_microbatches(b, accum) for b in jbatches]
        batches = [to_microbatches(b, accum) for b in batches]
    jlosses_seen, losses_seen, jlogs, logs = [], [], [], []
    jstate = jloop.train(_recording(jax.jit(jstep), jlosses_seen, float), jinit(jparams),
                         jbatches, num_epochs=EPOCHS, max_steps=MAX_STEPS, log_every=LOG_EVERY,
                         on_log=lambda s, m: jlogs.append((s, m)), jit=False)
    state = loop.train(_recording(step, losses_seen, float), init(params), batches,
                       num_epochs=EPOCHS, max_steps=MAX_STEPS, log_every=LOG_EVERY,
                       on_log=lambda s, m: logs.append((s, m)))
    assert len(losses_seen) == len(jlosses_seen) == MAX_STEPS
    np.testing.assert_allclose(losses_seen, jlosses_seen, rtol=1e-5)
    assert [s for s, _ in logs] == [s for s, _ in jlogs] == [0, 3, 4]
    for (_, m), (_, jm) in zip(logs, jlogs):
        for key in ("loss", "ema_loss", "grad_norm"):
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-5, err_msg=key)
        assert m["step_time"] > 0 and isinstance(m["loss"], float)
    assert state.step == int(jstate.step) == MAX_STEPS
    if rule == "adam":
        # Adam scales rounding noise to steps of size lr where the gradient
        # is zero in exact arithmetic (the attention key bias); the losses
        # above hold it to JAX
        return
    got = gpt2_params_to_jax(state.params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jstate.params):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-4, atol=1e-6)


def _scalar_steps(framework):
    """A step that records its batch and reports it as the loss."""
    seen = []

    def step(state, batch):
        seen.append(batch)
        loss = jnp.asarray(float(batch)) if framework == "jax" else torch.tensor(float(batch))
        return state + 1, {"loss": loss}

    return step, seen


def test_epochs_hooks_and_resampled_batches_as_jax():
    runs = []
    for framework, mod in (("jax", jloop), ("torch", loop)):
        step, seen = _scalar_steps(framework)
        ends, states, logs = [], [], []
        kw = {"jit": False} if framework == "jax" else {}
        final = mod.train(
            step, 0, mod.EpochResampledBatches(lambda e: [10 * e, 10 * e + 1],
                                               transform=lambda bs: bs[::-1]),
            num_epochs=3, max_steps=4, log_every=3,
            on_log=lambda s, m: logs.append((s, m["loss"], m["ema_loss"])),
            on_epoch_end=lambda e, s: ends.append((e, s)),
            on_state=lambda s, st, b: states.append((s, st, b)), on_state_every=2, **kw)
        runs.append((final, seen, ends, states, logs))
    assert runs[0] == runs[1]
    final, seen, ends, states, _ = runs[1]
    # max_steps trips on epoch 2's first batch: no hook for that epoch
    assert final == 4 and seen == [1, 0, 11, 10] and ends == [(0, 2), (1, 4)]
    assert states == [(0, 1, 1), (2, 3, 11)]


def test_evaluation_helpers_match_jax():
    jmodel, jparams, model, params = _models()
    ids = _ids()
    jloss_fn, loss_fn = jlosses.lm_loss_fn(jmodel), losses.lm_loss_fn(model)
    jb = [{"input_ids": jnp.asarray(b)} for b in ids]
    tb = [{"input_ids": torch.as_tensor(b)} for b in ids]
    per = evaluation.per_batch_losses(loss_fn, params, tb)
    np.testing.assert_allclose(per, jevaluation.per_batch_losses(jloss_fn, jparams, jb), rtol=1e-5)
    np.testing.assert_allclose(evaluation.evaluate_loss(loss_fn, params, tb),
                               jevaluation.evaluate_loss(jloss_fn, jparams, jb), rtol=1e-5)
    rng = np.random.RandomState(1)
    W = rng.randn(6, 4).astype(np.float32)
    data = [(rng.randn(10, 6).astype(np.float32), rng.randint(0, 4, size=10)) for _ in range(3)]
    acc = evaluation.evaluate_accuracy(lambda p, x: x @ p["W"], {"W": torch.as_tensor(W)}, data)
    jacc = jevaluation.evaluate_accuracy(lambda p, x: x @ p["W"], {"W": jnp.asarray(W)}, data)
    assert acc == jacc and 0 < acc < 1


def test_timer_meter_and_profile_trace(tmp_path):
    """The port's spans (its timers) around products, recorded inside the
    profiler's trace of them."""
    mm = span("mm")
    with mm:  # not recording: nothing kept
        torch.ones(8, 8) @ torch.ones(8, 8)
    with profile_trace(str(tmp_path / "prof")) as prof, recording() as rec:
        for _ in range(2):
            with mm:
                torch.ones(32, 32) @ torch.ones(32, 32)
    assert [r[0] for r in rec] == ["mm", "mm"]
    assert rec[0][1] <= rec[0][2] <= rec[1][1] <= rec[1][2]
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
