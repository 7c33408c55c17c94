"""Port of the rest of training against the JAX package on the same numpy
inputs: CG and power iteration, the frozen-spectrum transforms chained in
front of momentum SGD, the Gauss-Newton and natural-gradient steps, the
fused and layer-wise LanczosSGD steps, the host layer-wise trainer (also
against the port's own fused layer-wise step, and under the precision
guard), and the trace summary."""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hessian_llm_vision_tpu.krylov.cg import cg_solve as jcg_solve
from hessian_llm_vision_tpu.krylov.power import power_iteration as jpower_iteration
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.obs.trace_summary import summarize_trace as jsummarize_trace
from hessian_llm_vision_tpu.optim import LanczosSGDConfig as JLanczosSGDConfig
from hessian_llm_vision_tpu.optim import lanczos_sgd as jlanczos_sgd
from hessian_llm_vision_tpu.optim import projection as jprojection
from hessian_llm_vision_tpu.optim import second_order as jsecond_order
from hessian_llm_vision_tpu.optim.lanczos_sgd_host import (
    HostLayerwiseLanczosSGDTrainer as JHostLayerwiseLanczosSGDTrainer,
)
from hessian_llm_vision_tpu.optim.manual import sgd_momentum as jsgd_momentum
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.krylov import cg_solve, power_iteration
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_from_jax
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.obs import find_trace_file, profile_trace, summarize_trace
from hessian_llm_vision_tpu_torch.optim import (
    LanczosSGDConfig,
    chain,
    frozen_spectral_adjust,
    make_gauss_newton_step,
    make_lanczos_sgd_step,
    make_layerwise_lanczos_sgd_step,
    make_natural_gradient_step,
    project_gradients,
    sgd_momentum,
)
from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import HostLayerwiseLanczosSGDTrainer
from hessian_llm_vision_tpu_torch.optim.precision_guard import GuardTier, RefreshPrecisionGuard
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
PARAMS_RTOL = 1e-5  # rel-L2 of the flat params against the JAX package's
RITZ_RTOL = 1e-3  # eig_max / eig_min / layer_eig_* against the JAX package's
# "mean" HVPs with delta=3 put the Ritz values (about -50..30 on gpt2-tiny)
# where the adjustment moves the gradient by a few percent, far from the
# pole at λ = -δ (as tests/test_torch_lanczos_sgd_host.py)
CFG = dict(k=4, delta=3.0, lr=0.05, momentum=0.9, weight_decay=1e-4, normalization="mean")


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _tiny():
    jmodel = JGPT2LMHead(JGPT2Config.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(9), seq_len=T)
    return jmodel, jparams, GPT2LMHead(GPT2Config.tiny()), gpt2_params_from_jax(jparams)


def _ids(steps, accum=1, seed=21):
    ids = np.random.RandomState(seed).randint(0, 256, size=(steps, B, T))
    shape = (accum, B // accum, T) if accum > 1 else (B, T)
    return [ids[i].reshape(shape) for i in range(steps)]


def _assert_params(params, jparams, what=""):
    got = Flattener(params).flatten(params).numpy()
    want = np.asarray(JFlattener(jparams).flatten(jparams))
    assert rel_l2(got, want) <= PARAMS_RTOL, (what, rel_l2(got, want))


# --- krylov: CG and power iteration ---------------------------------------

def _spd(n=64, seed=3):
    """A seeded SPD matrix with eigenvalues in about [0.5, 5]: CG converges
    in tens of iterations without the f32 rounding of its dot products
    steering the two packages' iterates apart."""
    rng = np.random.RandomState(seed)
    m = rng.randn(n, n).astype(np.float32)
    return (m @ m.T / n + 0.5 * np.eye(n)).astype(np.float32), rng.randn(n).astype(np.float32)


@pytest.mark.parametrize("tol,max_iters", [(1e-3, 200), (1e-6, 200), (1e-12, 7)],
                         ids=["tol1e-3", "tol1e-6", "max_iters"])
def test_cg_solve_matches_jax(tol, max_iters):
    A, b = _spd()
    jres = jcg_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=tol, max_iters=max_iters)
    res = cg_solve(lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b), tol=tol,
                   max_iters=max_iters)
    assert res.num_iters == int(jres.num_iters)
    assert (res.num_iters == max_iters) == (tol == 1e-12)
    assert rel_l2(res.x, jres.x) <= 1e-5
    np.testing.assert_allclose(float(res.residual_norm), float(jres.residual_norm), rtol=1e-3)
    if tol > 1e-12:  # converged: the recurrence's residual is the true one
        true = np.linalg.norm(A.astype(np.float64) @ res.x.double().numpy() - b)
        assert true <= 1.01 * tol * np.linalg.norm(b)


def test_power_iteration_matches_jax():
    A, _ = _spd(seed=4)
    key = jax.random.PRNGKey(5)
    jlam, jv = jpower_iteration(lambda v: jnp.asarray(A) @ v, 64, 60, key=key)
    v0 = torch.as_tensor(np.asarray(jax.random.normal(key, (64,), dtype=jnp.float32)))
    lam, v = power_iteration(lambda v: torch.as_tensor(A) @ v, 64, 60, v0=v0)
    np.testing.assert_allclose(float(lam), float(jlam), rtol=1e-5)
    assert abs(float(torch.dot(v, torch.as_tensor(np.asarray(jv))))) > 1 - 1e-5
    with pytest.raises(ValueError, match="exactly one"):
        power_iteration(lambda v: v, 64, 1)


# --- frozen-spectrum transforms -------------------------------------------

@pytest.mark.parametrize("basis_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("transform", ["project", "frozen_adjust"])
def test_frozen_transforms_chained_match_jax(transform, basis_dtype):
    rng = np.random.RandomState(11)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    p_dim = sum(int(np.prod(s)) for s in shapes.values())
    V = np.linalg.qr(rng.randn(p_dim, 4))[0].T.astype(np.float32)
    eigvals = np.asarray([-2.0, 0.5, 1.0, 4.0], np.float32)
    jV, tV = jnp.asarray(V), torch.as_tensor(V)
    if basis_dtype == "bf16":
        jV, tV = jV.astype(jnp.bfloat16), tV.to(torch.bfloat16)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.as_tensor(v) for n, v in params.items()}
    jfl, fl = JFlattener(jp), Flattener(tp)
    if transform == "project":
        jt, t = jprojection.project_gradients(jV, jfl), project_gradients(tV, fl)
    else:
        jt = jprojection.frozen_spectral_adjust(jV, jnp.asarray(eigvals), 0.3, jfl)
        t = frozen_spectral_adjust(tV, torch.as_tensor(eigvals), 0.3, fl)
    jtx = optax.chain(jt, jsgd_momentum(0.1, momentum=0.9, weight_decay=0.01))
    tx = chain(t, sgd_momentum(0.1, momentum=0.9, weight_decay=0.01))
    jst, st = jtx.init(jp), tx.init(tp)
    for _ in range(3):
        grads = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
        jup, jst = jtx.update({n: jnp.asarray(v) for n, v in grads.items()}, jst, jp)
        up, st = tx.update({n: torch.as_tensor(v) for n, v in grads.items()}, st, tp)
        jp = optax.apply_updates(jp, jup)
        tp = {n: tp[n] + up[n] for n in tp}
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-6)
    if transform == "project" and basis_dtype == "f32":
        # a projected gradient has no component along the basis
        g = fl.flatten({n: torch.as_tensor(v) for n, v in grads.items()})
        out = fl.flatten(project_gradients(tV, fl).update(fl.unflatten(g), ())[0])
        assert float(torch.linalg.vector_norm(tV @ out)) <= 1e-5 * float(
            torch.linalg.vector_norm(g))


# --- Gauss-Newton and natural gradient ------------------------------------

def test_gauss_newton_least_squares_matches_jax():
    """GN with an exact CG solve ends linear least squares in one step
    (JAX ``tests/unit/test_optim.py``), in both packages alike."""
    rng = np.random.RandomState(2)
    X = rng.randn(30, 5).astype(np.float32)
    w_true = rng.randn(5).astype(np.float32)
    y = X @ w_true
    kw = dict(damping=1e-6, cg_tol=1e-8, cg_iters=100)
    jstep = jsecond_order.make_gauss_newton_step(
        lambda p, b: b[0] @ p["w"], lambda o, b: 0.5 * jnp.mean((o - b[1]) ** 2),
        lambda p, b: 0.5 * jnp.mean((b[0] @ p["w"] - b[1]) ** 2), {"w": jnp.zeros(5)}, **kw)
    step = make_gauss_newton_step(
        lambda p, b: b[0] @ p["w"], lambda o, b: 0.5 * torch.mean((o - b[1]) ** 2),
        lambda p, b: 0.5 * torch.mean((b[0] @ p["w"] - b[1]) ** 2), {"w": torch.zeros(5)},
        **kw)
    jnew, jm = jstep({"w": jnp.zeros(5)}, (jnp.asarray(X), jnp.asarray(y)))
    new, m = step({"w": torch.zeros(5)}, (torch.as_tensor(X), torch.as_tensor(y)))
    np.testing.assert_allclose(new["w"].numpy(), w_true, atol=1e-3)
    assert rel_l2(new["w"], jnew["w"]) <= 1e-5 and m["cg_iters"] == int(jm["cg_iters"])


def _lm_fns(jmodel, model):
    def jmodel_fn(p, b):
        return jmodel.apply({"params": p}, b["input_ids"])

    def jout(logits, b):
        return jlosses.causal_lm_loss(logits, b["input_ids"], b.get("attention_mask"))

    def model_fn(p, b):
        return torch.func.functional_call(model, p, (b["input_ids"],))

    def out(logits, b):
        return losses.causal_lm_loss(logits, b["input_ids"], b.get("attention_mask"))

    return (jmodel_fn, jout), (model_fn, out)


@pytest.mark.parametrize("kind", ["gn", "ngd"])
def test_second_order_steps_match_jax_on_gpt2_tiny(kind):
    """Damping 1 keeps the solve well conditioned: at small damping a
    truncated CG on gpt2-tiny's GGN amplifies the f32 rounding of the
    gradient into the step, so two packages' second steps part.  The CG
    exit here is the tolerance's."""
    jmodel, jparams, model, params = _tiny()
    (jmf, jout), (mf, out) = _lm_fns(jmodel, model)
    jmaker, maker = {"gn": (jsecond_order.make_gauss_newton_step, make_gauss_newton_step),
                     "ngd": (jsecond_order.make_natural_gradient_step,
                             make_natural_gradient_step)}[kind]
    kw = dict(lr=0.5, damping=1.0, cg_iters=8)
    jstep = jax.jit(jmaker(jmf, jout, jlosses.lm_loss_fn(jmodel), jparams, **kw))
    step = maker(mf, out, losses.lm_loss_fn(model), params, **kw)
    iters = []
    for ids in _ids(3):
        jparams, jm = jstep(jparams, {"input_ids": jnp.asarray(ids)})
        params, m = step(params, {"input_ids": torch.as_tensor(ids)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        assert m["cg_iters"] == int(jm["cg_iters"])
        iters.append(m["cg_iters"])
        np.testing.assert_allclose(float(m["cg_residual"]), float(jm["cg_residual"]), rtol=1e-3)
        _assert_params(params, jparams, kind)
    assert min(iters) < 8  # a tolerance exit


# --- fused and layer-wise LanczosSGD --------------------------------------

@pytest.mark.parametrize("refresh_every,lanczos_momentum,accum",
                         [(1, 0.0, 1), (2, 0.5, 1), (1, 0.5, 2), (2, 0.0, 2)],
                         ids=["every1", "every2_ema", "every1_ema_accum2", "every2_accum2"])
def test_lanczos_sgd_step_matches_jax(refresh_every, lanczos_momentum, accum):
    jmodel, jparams, model, params = _tiny()
    knobs = dict(CFG, refresh_every=refresh_every, lanczos_momentum=lanczos_momentum,
                 accum_steps=accum)
    jinit, jstep = jlanczos_sgd.make_lanczos_sgd_step(
        jlosses.lm_loss_fn(jmodel), jparams, JLanczosSGDConfig(**knobs), batch_size=B // accum)
    init, step = make_lanczos_sgd_step(losses.lm_loss_fn(model), params,
                                       LanczosSGDConfig(**knobs), batch_size=B // accum)
    jstate, state = jinit(jparams), init(params)
    jstep = jax.jit(jstep)
    for i, ids in enumerate(_ids(3, accum)):
        jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)})
        state, m = step(state, {"input_ids": torch.as_tensor(ids)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        for key in ("eig_max", "eig_min"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=RITZ_RTOL,
                                       err_msg=f"step {i} {key}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        assert m["lr"] == pytest.approx(float(jm["lr"]))
        _assert_params(state.params, jstate.params, f"step {i}")
    assert state.step == 3 and state.basis.shape == (4, Flattener(params).size)


def test_layerwise_lanczos_sgd_step_matches_jax():
    jmodel, jparams, model, params = _tiny()
    jinit, jstep = jlanczos_sgd.make_layerwise_lanczos_sgd_step(
        jlosses.lm_loss_fn(jmodel), jparams, JLanczosSGDConfig(**CFG), batch_size=B,
        min_leaf_size=64)
    init, step = make_layerwise_lanczos_sgd_step(
        losses.lm_loss_fn(model), params, LanczosSGDConfig(**CFG), batch_size=B,
        min_leaf_size=64)
    jstate, state = jinit(jparams), init(params)
    jstep = jax.jit(jstep)
    for i, ids in enumerate(_ids(2)):
        jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(ids)})
        state, m = step(state, {"input_ids": torch.as_tensor(ids)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        for key in ("layer_eig_max", "layer_eig_min"):
            assert m[key].shape == jm[key].shape and m[key].shape[0] > 4
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), rtol=RITZ_RTOL,
                                       atol=1e-4, err_msg=f"step {i} {key}")
        _assert_params(state.params, jstate.params, f"step {i}")


def _host_cfg(**kw):
    return dict(CFG, refresh_every=2, lanczos_momentum=0.5, **kw)


@pytest.mark.parametrize("basis", ["f32", "bf16"])
def test_host_layerwise_trainer_matches_jax(basis):
    jmodel, jparams, model, params = _tiny()
    jtrainer = JHostLayerwiseLanczosSGDTrainer(
        jlosses.lm_loss_fn(jmodel), jparams, JLanczosSGDConfig(**_host_cfg()), batch_size=B,
        basis_dtype=jnp.bfloat16 if basis == "bf16" else jnp.float32, min_leaf_size=64)
    trainer = HostLayerwiseLanczosSGDTrainer(
        losses.lm_loss_fn(model), params, LanczosSGDConfig(**_host_cfg()), batch_size=B,
        basis_dtype=torch.bfloat16 if basis == "bf16" else torch.float32, min_leaf_size=64)
    assert [a[:3] for a in trainer.active] == [a[:3] for a in jtrainer.active]
    assert len(trainer.active) < len(params)  # min_leaf_size drops the small leaves
    jstate, state = jtrainer.init(jparams), trainer.init(params)
    seen = []
    for i, ids in enumerate(_ids(3)):
        jstate, jm = jtrainer.step(jstate, {"input_ids": jnp.asarray(ids)})
        state, m = trainer.step(state, {"input_ids": torch.as_tensor(ids)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        for key in ("layer_eig_max", "layer_eig_min"):
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), rtol=RITZ_RTOL,
                                       atol=1e-4, err_msg=f"step {i} {key}")
        _assert_params(state.params, jstate.params, f"step {i}")
        seen.append(m["layer_eig_max"].clone())
    # refresh_every=2: step 1 reuses step 0's spectrum, step 2 blends a new one
    assert torch.equal(seen[0], seen[1]) and not torch.equal(seen[1], seen[2])
    assert all(V.dtype == trainer.basis_dtype and V.shape == (k, size)
               for V, (_, _, size, k) in zip(state.bases, trainer.active))


def test_host_layerwise_trainer_matches_port_fused_layerwise():
    """The port's host layer-wise trainer against its own fused layer-wise
    step (JAX ``test_host_layerwise_matches_fused_layerwise``): the
    recurrence without reorthogonalization on a masked HVP against the
    reorthogonalised one on a leaf jvp.  An L2 term keeps every block's
    spectrum away from 0, as the JAX test does."""
    _, _, model, params = _tiny()
    lm = losses.lm_loss_fn(model)

    def loss_fn(p, b):
        return lm(p, b) + 0.05 * sum(torch.sum(w ** 2) for w in p.values())

    cfg = LanczosSGDConfig(k=3, delta=1e-2, lr=0.02, momentum=0.9, normalization="sum")
    init, step = make_layerwise_lanczos_sgd_step(loss_fn, params, cfg, batch_size=B,
                                                 min_leaf_size=64)
    trainer = HostLayerwiseLanczosSGDTrainer(loss_fn, params, cfg, batch_size=B,
                                             min_leaf_size=64)
    fused, host = init(params), trainer.init({n: p.clone() for n, p in params.items()})
    for ids in _ids(2):
        batch = {"input_ids": torch.as_tensor(ids)}
        fused, mf = step(fused, batch)
        host, mh = trainer.step(host, batch)
        torch.testing.assert_close(mh["loss"], mf["loss"], rtol=1e-5, atol=0)
        torch.testing.assert_close(mh["layer_eig_max"], mf["layer_eig_max"], rtol=1e-3,
                                   atol=1e-4)
    for n, p in host.params.items():
        torch.testing.assert_close(p, fused.params[n], rtol=1e-3, atol=2e-5)


def test_precision_guard_attaches_to_host_layerwise():
    """The guard drives the layer-wise trainer's refresh tier as it does the
    host trainer's: a scripted probe fails the first rung, the trainer
    takes the next tier's loss and precision, and the refresh runs there."""
    _, _, model, params = _tiny()
    loss_fn = losses.lm_loss_fn(model)
    trainer = HostLayerwiseLanczosSGDTrainer(
        loss_fn, params, LanczosSGDConfig(**_host_cfg()), batch_size=B, min_leaf_size=64)
    tiers = [GuardTier("low", losses.lm_loss_fn(model), "default"),
             GuardTier("fp32", losses.lm_loss_fn(model), "high")]
    errs = iter([5e-3, 1e-5])
    guard = RefreshPrecisionGuard(tiers, referee_loss_fn=loss_fn, log=lambda msg: None,
                                  probe_fn=lambda tier, p, b: next(errs))
    trainer.precision_guard = guard
    state = trainer.init({n: p.clone() for n, p in params.items()})
    batch = {"input_ids": torch.as_tensor(_ids(1)[0])}
    guard.resolve_initial(trainer, state.params, batch)
    assert guard.index == 1 and trainer.refresh_precision == tiers[1].precision
    assert trainer.refresh_loss_fn is tiers[1].loss_fn
    state, m = trainer.step(state, batch)
    assert torch.isfinite(m["layer_eig_max"]).all() and len(guard.events) == 2


# --- trace summary ---------------------------------------------------------

def _chrome_fixture():
    """A kineto-style trace: a GPU row (by process name and by category), a
    CPU row, and a metadata row."""
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "python3"}},
        {"ph": "X", "pid": 0, "tid": 7, "cat": "kernel", "name": "gemm", "dur": 300.0},
        {"ph": "X", "pid": 0, "tid": 7, "cat": "kernel", "name": "gemm", "dur": 100.0},
        {"ph": "X", "pid": 0, "tid": 8, "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "dur": 100.0},
        {"ph": "X", "pid": 7, "tid": 1, "cat": "cpu_op", "name": "aten::mm", "dur": 900.0},
        {"ph": "i", "pid": 7, "tid": 1, "name": "marker"},
    ]}


def test_summarize_trace_matches_jax_on_a_fixture(tmp_path):
    gz = tmp_path / "jax_style" / "host.trace.json.gz"
    gz.parent.mkdir()
    with gzip.open(gz, "wt") as f:
        json.dump(_chrome_fixture(), f)
    for device_only in (True, False):
        ours = summarize_trace(str(gz.parent), device_only=device_only)
        ref = jsummarize_trace(str(gz.parent), device_only=device_only)
        assert [r[0] for r in ours] == [r[0] for r in ref]
        np.testing.assert_allclose([r[1:] for r in ours], [r[1:] for r in ref])
    assert summarize_trace(str(gz)) == [("gemm", 0.4, 80.0), ("Memcpy DtoH", 0.1, 20.0)]
    # profile_trace's uncompressed trace.json, rows found by category alone
    plain = tmp_path / "torch_style"
    plain.mkdir()
    events = [e for e in _chrome_fixture()["traceEvents"] if e.get("ph") != "M"]
    (plain / "trace.json").write_text(json.dumps({"traceEvents": events}))
    assert find_trace_file(str(plain)) == str(plain / "trace.json")
    assert summarize_trace(str(plain)) == [("gemm", 0.4, 80.0), ("Memcpy DtoH", 0.1, 20.0)]
    with pytest.raises(FileNotFoundError, match="no trace"):
        summarize_trace(str(tmp_path / "empty"))


def test_summarize_a_real_cpu_profile(tmp_path):
    a = torch.randn(64, 64)
    with profile_trace(str(tmp_path)):
        for _ in range(3):
            a = torch.tanh(a @ a)
    assert find_trace_file(str(tmp_path)) == os.path.join(str(tmp_path), "trace.json")
    rows = summarize_trace(str(tmp_path), top=50, device_only=False)
    names = [r[0] for r in rows]
    assert "aten::mm" in names and "aten::tanh" in names
    assert sum(r[2] for r in rows) <= 100.0 + 1e-6 and all(r[1] > 0 for r in rows)
    if not torch.cuda.is_available():  # no device rows in a CPU-only trace
        assert summarize_trace(str(tmp_path)) == []
