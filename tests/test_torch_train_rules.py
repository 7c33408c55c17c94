"""Port update rules, schedules and micro-batching against the JAX
package's on the same numpy inputs: Adam, raw SGD and SGD with momentum
over 5 steps, with and without linear decay, within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hessian_llm_vision_tpu.optim import manual as jmanual
from hessian_llm_vision_tpu.optim import schedules as jschedules
from hessian_llm_vision_tpu.train.accumulate import to_microbatches as jto_microbatches
from hessian_llm_vision_tpu_torch.optim import manual, schedules
from hessian_llm_vision_tpu_torch.train.accumulate import to_microbatches

STEPS = 5
RULES = {
    "adam": lambda m, lr: m.manual_adam(lr, b1=0.9, b2=0.999, eps=1e-8),
    "adam_b2_0.95_eps_1e-6": lambda m, lr: m.manual_adam(lr, b1=0.8, b2=0.95, eps=1e-6),
    "raw": lambda m, lr: m.raw_sgd(lr),
    "sgd": lambda m, lr: m.sgd_momentum(lr, momentum=0.9, weight_decay=0.01),
}


def _tree(rng):
    return {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32),
            "c": rng.randn(2, 2, 4).astype(np.float32)}


@pytest.mark.parametrize("decay", [0, 4], ids=["constant_lr", "linear_decay_4"])
@pytest.mark.parametrize("rule", list(RULES))
def test_update_rule_matches_jax(rule, decay):
    rng = np.random.RandomState(11)
    params = _tree(rng)
    lr = 0.05
    jlr = jschedules.linear_decay(lr, decay) if decay else lr
    tlr = schedules.linear_decay(lr, decay) if decay else lr
    jtx, tx = RULES[rule](jmanual, jlr), RULES[rule](manual, tlr)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.as_tensor(v) for n, v in params.items()}
    jst, st = jtx.init(jp), tx.init(tp)
    for _ in range(STEPS):
        grads = {n: rng.randn(*v.shape).astype(np.float32) for n, v in params.items()}
        jup, jst = jtx.update({n: jnp.asarray(v) for n, v in grads.items()}, jst, jp)
        up, st = tx.update({n: torch.as_tensor(v) for n, v in grads.items()}, st, tp)
        jp = optax.apply_updates(jp, jup)
        tp = manual.apply_updates(tp, up)
        for n in params:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-7)
    assert st["step"] == int(jst.step) == STEPS
    if rule.startswith("adam"):
        for n in params:
            np.testing.assert_allclose(st["m"][n].numpy(), np.asarray(jst.m[n]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(st["v"][n].numpy(), np.asarray(jst.v[n]), rtol=1e-6,
                                       atol=1e-9)


def test_updates_leave_inputs_alone():
    rng = np.random.RandomState(2)
    tp = {n: torch.as_tensor(v) for n, v in _tree(rng).items()}
    grads = {n: torch.ones_like(p) for n, p in tp.items()}
    for rule in RULES.values():
        tx = rule(manual, 0.1)
        st = tx.init(tp)
        before = {n: p.clone() for n, p in tp.items()}
        _, new = tx.update(grads, st, tp)
        assert all(torch.equal(tp[n], before[n]) for n in tp)
        assert st["step"] == 0 and new["step"] == 1


@pytest.mark.parametrize("total", [1, 4, 7])
def test_schedules_equal_jax_float32(total):
    jdecay, decay = jschedules.linear_decay(3e-3, total), schedules.linear_decay(3e-3, total)
    for step in range(total + 3):
        assert decay(step) == float(jdecay(jnp.asarray(step, jnp.int32)))
    assert schedules.constant(1e-3)(5) == float(jschedules.constant(1e-3)(jnp.asarray(5)))
    assert decay(total) == 0.0 and decay(total + 2) == 0.0


def test_to_microbatches_equals_jax():
    ids = np.random.RandomState(0).randint(0, 256, size=(8, 5)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
    ref = jto_microbatches({k: jnp.asarray(v) for k, v in batch.items()}, 4)
    got = to_microbatches({k: torch.as_tensor(v) for k, v in batch.items()}, 4)
    for k in batch:
        assert got[k].shape == (4, 2, 5)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    with pytest.raises(ValueError, match="not divisible"):
        to_microbatches({"input_ids": torch.zeros(6, 3)}, 4)
