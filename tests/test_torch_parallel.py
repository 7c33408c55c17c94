"""The port's data axis (``hessian_llm_vision_tpu_torch/parallel/``) on 2 gloo
ranks on the CPU, against the JAX package on its 8-device CPU mesh, both
held to their unsharded runs on the same numpy inputs.

The ranks are new interpreters that import torch and the port only
(``tests/torch_parallel_ranks.py`` through ``parallel.spawn.run_ranks``);
the JAX side runs here.  Each group of rank checks is one spawn, with its
own timeout, whose results every test worker shares through a file in
pytest's base temporary directory, so a group spawns once per run.

Bars: gradient and HVP within 1e-5 relative, T within 1e-4, Ritz values
within 1e-3 relative (the JAX package's own mesh tests use the same or
tighter bars, quoted where they are).
"""

import fcntl
import os
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.curvature import HessianOperator as JHessianOperator
from hessian_llm_vision_tpu.data import make_spirals
from hessian_llm_vision_tpu.krylov import deflated_density as jdeflated_density
from hessian_llm_vision_tpu.krylov import lanczos as jlanczos
from hessian_llm_vision_tpu.krylov import lanczos_thick_restart as jthick_restart
from hessian_llm_vision_tpu.krylov import ritz_decomposition as jritz
from hessian_llm_vision_tpu.krylov.driver import dataset_spectrum_host as jdataset_spectrum_host
from hessian_llm_vision_tpu.krylov.driver import (
    dataset_thick_restart_host as jdataset_thick_restart_host,
)
from hessian_llm_vision_tpu.models import SpiralMLP as JSpiralMLP
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.ops import spectral as jspectral
from hessian_llm_vision_tpu.optim import LanczosSGDConfig as JLanczosSGDConfig
from hessian_llm_vision_tpu.optim.lanczos_sgd import (
    make_lanczos_sgd_step as jmake_lanczos_sgd_step,
)
from hessian_llm_vision_tpu.optim.lanczos_sgd_host import (
    HostLanczosSGDTrainer as JHostLanczosSGDTrainer,
)
from hessian_llm_vision_tpu.parallel import make_mesh as jmake_mesh
from hessian_llm_vision_tpu.parallel import probe_parallel_spectrum_host as jprobe_parallel
from hessian_llm_vision_tpu.parallel import shard_batch as jshard_batch
from hessian_llm_vision_tpu.parallel.hvp_sharded import (
    ShardedHessianOperator as JShardedHessianOperator,
)
from hessian_llm_vision_tpu.parallel.hvp_sharded import sharded_grad_fn as jsharded_grad_fn
from hessian_llm_vision_tpu.parallel.mesh import basis_sharding as jbasis_sharding
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.cli import spectrum
from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator, MatrixOperator
from hessian_llm_vision_tpu_torch.krylov import deflate, driver
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.krylov.sharded import PShard
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.convert import params_from_jax
from hessian_llm_vision_tpu_torch.models.mlp import SpiralMLP
from hessian_llm_vision_tpu_torch.ops import native
from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import LanczosSGDConfig, make_lanczos_sgd_step
from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import HostLanczosSGDTrainer
from hessian_llm_vision_tpu_torch.parallel import (
    Mesh,
    basis_sharding,
    data_sharding,
    dist_init,
    make_mesh,
    make_sharded_loss,
    replicated_sharding,
    shard_batch,
    to_device,
    to_host,
)
from hessian_llm_vision_tpu_torch.parallel.spawn import run_ranks
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py"))
N_RANKS = 2
SPAWN_TIMEOUT = 240.0
B, NB = 32, 3  # rows of a global batch (8 devices x 4, 2 ranks x 16), batches
TRAINER_CFG = dict(k=3, delta=1e-3, lr=1e-2, momentum=0.9, refresh_every=2, normalization="mean")
STEP_CFG = dict(k=4, delta=3.0, lr=0.05, momentum=0.9, weight_decay=1e-4, refresh_every=1,
                lanczos_momentum=0.5, normalization="mean")
SPIRAL_CLI = ["--model", "spiral", "--cpu", "--num_points", "96", "--batch_size", "32",
              "--lanczos_iters", "6", "--probes", "2", "--host_loop", "--hvp_precision", "high"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU when
    several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _shared(factory, name: str, produce):
    """``produce(workdir)`` once per test run, its result shared by every
    test worker through a locked file (a failure is shared too)."""
    root = factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, above every worker's
    out, lock = root / f"torch_parallel_{name}.pt", root / f"torch_parallel_{name}.lock"
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        if not out.exists():
            try:
                saved = {"ranks": produce(root / f"torch_parallel_{name}")}
            except Exception:  # every test of the group reports the spawn's failure
                saved = {"error": traceback.format_exc()}
            torch.save(saved, out)
        saved = torch.load(out, weights_only=False)
    if "error" in saved:
        pytest.fail(saved["error"])
    return saved["ranks"]


def _no_jax(ranks) -> None:
    for r in ranks:
        assert "jax" not in r["modules"] and "hessian_llm_vision_tpu" not in r["modules"]


# --------------------------------------------------------------- data axis

def _spiral_problem(seed=0):
    """The JAX mesh tests' spiral MLP on 96 points, three batches of 32."""
    x, y = make_spirals(96, noise=0.15, seed=7)
    jmodel = JSpiralMLP(width=16, depth=2)
    jparams = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x[:4]))["params"]

    def jmodel_fn(p, b):
        return jmodel.apply({"params": p}, b[0])

    def jout_loss(logits, b):
        return jlosses.softmax_cross_entropy(logits, b[1])

    def jloss(p, b):
        return jout_loss(jmodel_fn(p, b), b)

    def jbatches(xs, ys):
        return [(jnp.asarray(xs[i * 32:(i + 1) * 32]), jnp.asarray(ys[i * 32:(i + 1) * 32]))
                for i in range(3)]

    params = params_from_jax(jparams)
    P = Flattener(params).size
    per_probe = [make_spirals(96, noise=0.15, seed=997 + i) for i in range(2)]
    return dict(x=x, y=y, jparams=jparams, jloss=jloss, jmodel_fn=jmodel_fn,
                jout_loss=jout_loss, jbatches=jbatches, per_probe=per_probe, params=params,
                fl=Flattener(params), loss=losses.classification_loss_fn(SpiralMLP(width=16, depth=2)),
                batches=[{"image": torch.as_tensor(x[i * 32:(i + 1) * 32]),
                          "label": torch.as_tensor(y[i * 32:(i + 1) * 32])} for i in range(3)],
                v=np.asarray(jax.random.normal(jax.random.PRNGKey(3), (P,), jnp.float32)),
                v0=np.asarray(jax.random.normal(jax.random.PRNGKey(9), (P,), jnp.float32)))


@pytest.fixture(scope="module")
def sp():
    return _spiral_problem()


@pytest.fixture(scope="session")
def dp(tmp_path_factory):
    def produce(workdir):
        sp = _spiral_problem()
        return run_ranks(f"{RANKS}:data_parallel", N_RANKS, workdir, threads=1,
                         timeout=SPAWN_TIMEOUT,
                         kwargs=dict(params=sp["params"], x=sp["x"], y=sp["y"], v=sp["v"],
                                     v0=sp["v0"], trainer_cfg=TRAINER_CFG, step_cfg=STEP_CFG))

    return _shared(tmp_path_factory, "dp", produce)


def test_dp_loss_and_grad_match_jax_mesh_and_one_process(dp, sp):
    _no_jax(dp)
    assert [r["result"]["rows"] for r in dp] == [B // N_RANKS] * N_RANKS
    mesh = jmake_mesh()
    jbatch = sp["jbatches"](sp["x"], sp["y"])[0]
    jl_mesh, jg_mesh = jax.jit(jsharded_grad_fn(sp["jloss"], mesh))(
        sp["jparams"], jshard_batch(jbatch, mesh))
    jl_1, jg_1 = jax.value_and_grad(sp["jloss"])(sp["jparams"], jbatch)
    jfl = JFlattener(sp["jparams"])
    assert _rel(jfl.flatten(jg_mesh), jfl.flatten(jg_1)) <= 1e-5
    loss_1, grad_1 = grad_and_loss(sp["loss"], sp["params"], sp["batches"][0])
    g_1 = sp["fl"].flatten(grad_1).numpy()
    for r in dp:
        res = r["result"]
        for loss in (res["loss"], res["loss_call"]):
            np.testing.assert_allclose(loss, float(loss_1), rtol=1e-6)
            np.testing.assert_allclose(loss, float(jl_mesh), rtol=1e-6)
        assert _rel(res["grad"], g_1) <= 1e-5
        assert _rel(res["grad"], np.asarray(jfl.flatten(jg_mesh))) <= 1e-5
    np.testing.assert_array_equal(dp[0]["result"]["grad"], dp[1]["result"]["grad"])


@pytest.mark.parametrize("norm", ["mean", "sum", "dataset"])
def test_dp_hvp_normalizations_match_jax_mesh_and_one_process(dp, sp, norm):
    mesh = jmake_mesh()
    jbatch = sp["jbatches"](sp["x"], sp["y"])[0]
    kw = dict(normalization=norm, batch_size=B, dataset_size=NB * B)
    v = jnp.asarray(sp["v"])
    jmesh = np.asarray(JShardedHessianOperator(sp["jloss"], sp["jparams"],
                                               jshard_batch(jbatch, mesh), mesh, **kw)(v))
    j1 = np.asarray(JHessianOperator(sp["jloss"], sp["jparams"], jbatch, **kw)(v))
    assert _rel(jmesh, j1) <= 1e-5
    one = HessianOperator(sp["loss"], sp["params"], sp["batches"][0], **kw)(
        torch.as_tensor(sp["v"])).numpy()
    for r in dp:
        got = r["result"][f"hvp_{norm}"]
        assert _rel(got, one) <= 1e-5
        assert _rel(got, jmesh) <= 1e-5
    if norm == "sum":  # the global batch size, not a rank's rows
        assert _rel(dp[0]["result"]["hvp_sum"], B * dp[0]["result"]["hvp_mean"]) <= 1e-5


def test_dataset_spectrum_host_over_sharded_loss(dp, sp):
    # the JAX package's own mesh run of this is
    # tests/distributed/test_hostloop_mesh.py (mesh == one device within 1e-4)
    jb = sp["jbatches"](sp["x"], sp["y"])
    j_1 = jdataset_spectrum_host(sp["jloss"], sp["jparams"], jb, 6, v0=jnp.asarray(sp["v0"]))
    one = driver.dataset_spectrum_host(sp["loss"], sp["params"], sp["batches"], 6,
                                       v0=torch.as_tensor(sp["v0"]), flattener=sp["fl"])
    for want_a, want_b in ((np.asarray(j_1.alphas), np.asarray(j_1.betas)),
                           (one.alphas.numpy(), one.betas.numpy())):
        for r in dp:
            a, b = r["result"]["T"]
            np.testing.assert_allclose(a, want_a, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(b, want_b, rtol=1e-4, atol=1e-4)
    a, b = dp[0]["result"]["T"]
    T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    np.testing.assert_allclose(np.linalg.eigvalsh(T.astype(np.float64)),
                               np.sort(np.asarray(jritz(j_1).eigvals)), rtol=1e-3, atol=1e-4)


def test_host_trainer_over_sharded_loss(dp, sp):
    jtrainer = JHostLanczosSGDTrainer(sp["jloss"], sp["jparams"],
                                      JLanczosSGDConfig(**TRAINER_CFG))
    jstate = jtrainer.init(sp["jparams"])
    trainer = HostLanczosSGDTrainer(sp["loss"], sp["params"], LanczosSGDConfig(**TRAINER_CFG))
    state = trainer.init({k: p.clone() for k, p in sp["params"].items()})
    jb = sp["jbatches"](sp["x"], sp["y"])
    for i in range(4):
        jstate, jm = jtrainer.step(jstate, jb[i % NB])
        state, m = trainer.step(state, sp["batches"][i % NB])
    p_1 = sp["fl"].flatten(state.params).numpy()
    p_j = np.asarray(JFlattener(sp["jparams"]).flatten(jstate.params))
    for r in dp:
        got = r["result"]["trainer"]
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=1e-5, atol=1e-6)
        for want in (p_1, p_j):  # the JAX mesh test's bars
            np.testing.assert_allclose(got["params"], want, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got["eigvals"], state.eigvals.numpy(), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["eigvals"], np.asarray(jstate.eigvals), rtol=1e-3,
                                   atol=1e-4)


def _jax_fused_steps(sp, basis_sharding=None):
    """Two of the JAX package's fused LanczosSGD steps on the spiral batches:
    ``(losses, flat params, eigvals, basis)``."""
    init_fn, step_fn = jmake_lanczos_sgd_step(sp["jloss"], sp["jparams"],
                                              JLanczosSGDConfig(**STEP_CFG),
                                              basis_sharding=basis_sharding)
    state, step_fn = init_fn(sp["jparams"]), jax.jit(step_fn)
    jb, step_losses = sp["jbatches"](sp["x"], sp["y"]), []
    for i in range(2):
        state, m = step_fn(state, jb[i])
        step_losses.append(float(m["loss"]))
    return (step_losses, np.asarray(JFlattener(sp["jparams"]).flatten(state.params)),
            np.asarray(state.eigvals), np.asarray(state.basis))


def test_fused_step_with_sharded_basis(dp, sp):
    init_fn, step_fn = make_lanczos_sgd_step(sp["loss"], sp["params"],
                                             LanczosSGDConfig(**STEP_CFG))
    state = init_fn({k: p.clone() for k, p in sp["params"].items()})
    step_losses = []
    for i in range(2):
        state, m = step_fn(state, sp["batches"][i])
        step_losses.append(float(m["loss"]))
    one = (step_losses, sp["fl"].flatten(state.params).numpy(), state.eigvals.numpy(),
           state.basis.numpy())
    j_mesh = _jax_fused_steps(sp, jbasis_sharding(jmake_mesh()))
    j_1 = _jax_fused_steps(sp)
    np.testing.assert_allclose(j_mesh[1], j_1[1], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(j_mesh[2], j_1[2], rtol=1e-3, atol=1e-4)
    P = sp["fl"].size
    widths = [r["result"]["fused"]["basis_columns"] for r in dp]
    assert widths == [P - P // 2, P // 2]
    for r in dp:
        got = r["result"]["fused"]
        for want in (one, j_mesh):
            np.testing.assert_allclose(got["losses"], want[0], rtol=1e-5)
            np.testing.assert_allclose(got["params"], want[1], atol=1e-5, rtol=1e-4)
            np.testing.assert_allclose(got["eigvals"], want[2], rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(got["basis"], want[3], atol=1e-4)


# ------------------------------------------------------- P-sharded basis

def _dense_op(dim, seed=0):
    """The JAX thick-restart mesh tests' symmetric Gaussian matrix."""
    rng = np.random.RandomState(seed)
    a = rng.randn(dim, dim).astype(np.float32)
    return (a + a.T) / 2.0


def _outlier_op(dim, seed=0, outliers=(40.0, -35.0, 30.0)):
    """The JAX deflation mesh test's bulk plus detached outliers."""
    rng = np.random.RandomState(seed)
    a = rng.randn(dim, dim).astype(np.float32) / np.sqrt(dim)
    mat = (a + a.T) / 2.0
    q, _ = np.linalg.qr(rng.randn(dim, len(outliers)))
    return (mat + (q * np.asarray(outliers)) @ q.T).astype(np.float32)


def _normal(seed, dim):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (dim,), jnp.float32))


def _kpm_probes(key, n, dim):
    out = []
    for _ in range(n):
        key, kp = jax.random.split(key)
        out.append(np.asarray(jax.random.rademacher(kp, (dim,), jnp.float32)
                              / jnp.sqrt(jnp.float32(dim))))
    return np.stack(out)


def _basis_inputs():
    lanczos_cases = {"64": (_dense_op(64), _normal(5, 64), 12),
                     "61": (_dense_op(61, 3), _normal(6, 61), 12)}
    tr_cases = {"64": (_dense_op(64), _normal(1, 64), 4, 16),
                "61": (_dense_op(61, 3), _normal(2, 61), 3, 16)}
    quad = (_dense_op(61, 3), _normal(2, 61), 3, 16)
    M = _outlier_op(64)
    key_tr, key_kpm = jax.random.split(jax.random.PRNGKey(7))
    defl = (M, dict(k=3, moments=24, inner=12, lmin=-2.5, lmax=2.5,
                    v0=np.asarray(jax.random.normal(key_tr, (64,), jnp.float32)),
                    probes=_kpm_probes(key_kpm, 2, 64)))
    return lanczos_cases, tr_cases, quad, defl


@pytest.fixture(scope="session")
def basis(tmp_path_factory):
    def produce(workdir):
        lanczos_cases, tr_cases, quad, defl = _basis_inputs()
        return run_ranks(f"{RANKS}:sharded_basis", N_RANKS, workdir, threads=1,
                         timeout=SPAWN_TIMEOUT,
                         kwargs=dict(lanczos_cases=lanczos_cases, tr_cases=tr_cases, quad=quad,
                                     defl=defl))

    return _shared(tmp_path_factory, "basis", produce)


@pytest.mark.parametrize("dim", ["64", "61"])
def test_sharded_lanczos_matches_jax_mesh_and_unsharded(basis, dim):
    _no_jax(basis)
    M, v0, iters = _basis_inputs()[0][dim]
    jop = jax.jit(lambda v: jnp.asarray(M) @ v)
    j_mesh = jlanczos(jop, M.shape[0], iters, v0=jnp.asarray(v0), reorth=True,
                      basis_sharding=jbasis_sharding(jmake_mesh()))
    j_1 = jlanczos(jop, M.shape[0], iters, v0=jnp.asarray(v0), reorth=True)
    one = lanczos(MatrixOperator(torch.as_tensor(M)).matvec, M.shape[0], iters,
                  v0=torch.as_tensor(v0))
    size = -(-M.shape[0] // N_RANKS)
    assert [r["result"]["lanczos"][dim]["block"] for r in basis] == [
        (iters, size), (iters, M.shape[0] - size)]
    for r in basis:
        got = r["result"]["lanczos"][dim]
        for a, b in ((j_mesh.alphas, j_mesh.betas), (j_1.alphas, j_1.betas),
                     (one.alphas, one.betas)):
            np.testing.assert_allclose(got["alphas"], np.asarray(a), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got["betas"], np.asarray(b), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["basis"], one.basis.numpy(), atol=1e-4)
        np.testing.assert_allclose(got["basis"], np.asarray(j_mesh.basis), atol=1e-4)


@pytest.mark.parametrize("dim", ["64", "61"])
def test_sharded_thick_restart_matches_jax_mesh_and_unsharded(basis, dim):
    M, v0, k, inner = _basis_inputs()[1][dim]
    jop = jax.jit(lambda v: jnp.asarray(M) @ v)
    j_mesh = jthick_restart(jop, M.shape[0], k, v0=jnp.asarray(v0), inner=inner,
                            basis_sharding=jbasis_sharding(jmake_mesh()))
    j_1 = jthick_restart(jop, M.shape[0], k, v0=jnp.asarray(v0), inner=inner)
    from hessian_llm_vision_tpu_torch.krylov.thick_restart import lanczos_thick_restart

    one = lanczos_thick_restart(MatrixOperator(torch.as_tensor(M)).matvec, M.shape[0], k,
                                v0=torch.as_tensor(v0), inner=inner)
    dense = np.linalg.eigvalsh(M.astype(np.float64))
    for r in basis:
        got = r["result"]["thick_restart"][dim]
        assert got["converged"] and got["matvecs"] == one.matvecs
        for want in (j_mesh.eigvals, j_1.eigvals, one.eigvals):
            np.testing.assert_allclose(got["eigvals"], np.asarray(want), rtol=1e-5)
        np.testing.assert_allclose(np.sort(np.abs(got["eigvals"])),
                                   np.sort(np.abs(dense))[-k:], rtol=1e-4)
        for lam, vec in zip(got["eigvals"], got["vectors"]):  # the pairs solve A v = λ v
            np.testing.assert_allclose(M @ vec, lam * vec, rtol=1e-3, atol=1e-3)
        assert got["vectors"].shape == (k, M.shape[0])
    assert [r["result"]["thick_restart"][dim]["block"][1] for r in basis] == [
        -(-M.shape[0] // N_RANKS), M.shape[0] // N_RANKS]


def test_dataset_thick_restart_host_sharded_pads_indivisible_dim(basis):
    M, v0, k, inner = _basis_inputs()[2]
    dense = np.linalg.eigvalsh(M.astype(np.float64))

    def quad_loss(params, batch):
        return 0.5 * params["w"] @ (batch["A"] @ params["w"])

    one = driver.dataset_thick_restart_host(
        quad_loss, {"w": torch.zeros(61)}, [{"A": torch.as_tensor(M)}], k,
        v0=torch.as_tensor(v0), inner=inner, normalization="mean", precision=None)
    j_mesh = jdataset_thick_restart_host(
        quad_loss, {"w": jnp.zeros(61)}, [{"A": jnp.asarray(M)}], k, v0=jnp.asarray(v0),
        inner=inner, normalization="mean", precision=None,
        basis_sharding=jbasis_sharding(jmake_mesh()))  # 61 padded to 64 over 8 devices
    assert j_mesh.converged
    for r in basis:
        got = r["result"]["quad"]
        assert got["converged"] and got["block"][0] == k
        np.testing.assert_allclose(np.sort(np.abs(got["eigvals"])), np.sort(np.abs(dense))[-k:],
                                   rtol=1e-4)
        for want in (one.eigvals, np.asarray(j_mesh.eigvals)):
            np.testing.assert_allclose(got["eigvals"], want, rtol=1e-5)


def test_deflated_density_sharded_matches_unsharded_and_jax(basis):
    M, kw = _basis_inputs()[3]
    common = dict(inner=kw["inner"], lmin=kw["lmin"], lmax=kw["lmax"])
    # the JAX package's own draws, handed over (its plain density; its mesh
    # run is tests/distributed/test_deflate_sharded.py)
    jres = jdeflated_density(lambda v: jnp.asarray(M) @ v, 64, kw["k"], kw["moments"],
                             jax.random.PRNGKey(7), num_probes=2, **common)
    one = deflate.deflated_density(MatrixOperator(torch.as_tensor(M)).matvec, 64, kw["k"],
                                   kw["moments"], v0=torch.as_tensor(kw["v0"]),
                                   probes=torch.as_tensor(kw["probes"]), **common)
    for r in basis:
        got = r["result"]["deflated"]
        assert got["converged"] and got["matvecs"] == one.matvecs
        for want in (one, jres):
            np.testing.assert_allclose(got["eigvals"], want.eigvals, rtol=1e-5)
            np.testing.assert_allclose(got["moments"], want.bulk.moments, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(got["center"], want.bulk.center, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.sort(np.abs(got["eigvals"])), [30.0, 35.0, 40.0],
                                   rtol=0.05)
        np.testing.assert_allclose(got["trace"], one.trace_estimate(), rtol=1e-4, atol=1e-6)


def test_sharded_projection_is_pass1_allreduce_pass2(basis):
    for r in basis:
        res = r["result"]
        assert res["events"] == ["rank_k_dots", "all_reduce (3,)", "rank_k_axpy"]
        want = np.arange(64, dtype=np.float32)
        want[:3] = 0.0
        np.testing.assert_array_equal(res["projection"], want)


# ---------------------------------------------------------- probe parallel

def _fold_in_draws(key, n, dim):
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, i), (dim,), jnp.float32))
            for i in range(n)]


@pytest.fixture(scope="session")
def probes(tmp_path_factory):
    def produce(workdir):
        sp = _spiral_problem()
        P = sp["fl"].size
        return run_ranks(
            f"{RANKS}:probes", N_RANKS, workdir, threads=1, timeout=SPAWN_TIMEOUT,
            kwargs=dict(params=sp["params"], x=sp["x"], y=sp["y"], per_probe=sp["per_probe"],
                        v0s=_fold_in_draws(jax.random.PRNGKey(3), 4, P),
                        ggn_v0s=_fold_in_draws(jax.random.PRNGKey(1), 2, P),
                        cli_argv=SPIRAL_CLI + ["--probe_parallel", "--out_spectrum",
                                               str(workdir / "spec")]))

    return _shared(tmp_path_factory, "probes", produce)


def test_probe_parallel_matches_jax_mesh_and_sequential(probes, sp):
    _no_jax(probes)
    jb = sp["jbatches"](sp["x"], sp["y"])
    key = jax.random.PRNGKey(3)
    j_mesh = jprobe_parallel(sp["jloss"], sp["jparams"], jb, 7, key=key, n_probes=4,
                             mesh=jmake_mesh(4), precision="highest")
    for pi, v0 in enumerate(_fold_in_draws(key, 4, sp["fl"].size)):
        seq = driver.dataset_spectrum_host(sp["loss"], sp["params"], sp["batches"], 7,
                                           v0=torch.as_tensor(v0), precision="highest")
        for r in probes:
            a, b = r["result"]["hessian"][pi]
            np.testing.assert_array_equal(a, seq.alphas.numpy())  # the same probe, in turn
            np.testing.assert_array_equal(b, seq.betas.numpy())
            np.testing.assert_allclose(a, np.asarray(j_mesh[pi].alphas), rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(b, np.asarray(j_mesh[pi].betas), rtol=1e-4, atol=1e-6)


def test_probe_parallel_ggn_operator(probes, sp):
    key = jax.random.PRNGKey(1)
    seq = jdataset_spectrum_host(sp["jloss"], sp["jparams"], sp["jbatches"](sp["x"], sp["y"]),
                                 6, key=jax.random.fold_in(key, 0), fused=True, operator="ggn",
                                 model_fn=sp["jmodel_fn"], out_loss_fn=sp["jout_loss"],
                                 precision="highest")
    for r in probes:
        res = r["result"]["ggn"]
        np.testing.assert_allclose(res[0][0], np.asarray(seq.alphas), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(res[0][1], np.asarray(seq.betas), rtol=1e-4, atol=1e-6)
        for a, b in res:  # the GGN is PSD: every probe's Ritz values are nonnegative
            T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
            assert np.linalg.eigvalsh(T.astype(np.float64)).min() > -1e-5


def test_probe_parallel_per_probe_data(probes, sp):
    key = jax.random.PRNGKey(3)
    for pi, (xs, ys) in enumerate(sp["per_probe"]):
        seq = jdataset_spectrum_host(sp["jloss"], sp["jparams"], sp["jbatches"](xs, ys), 6,
                                     key=jax.random.fold_in(key, pi), fused=True,
                                     precision="highest")
        for r in probes:
            a, b = r["result"]["per_probe"][pi]
            np.testing.assert_allclose(a, np.asarray(seq.alphas), rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(b, np.asarray(seq.betas), rtol=1e-4, atol=1e-6)


def test_probe_parallel_loud_on_indivisible_probes(probes):
    for r in probes:
        assert "multiple of the mesh" in r["result"]["indivisible"]


def test_probe_parallel_cli_matches_sequential_probes(probes, tmp_path):
    seq, _ = spectrum.main(SPIRAL_CLI + ["--out_spectrum", str(tmp_path / "seq")])
    for r in probes:  # the JAX CLI test's bar
        np.testing.assert_allclose(np.sort(r["result"]["cli_eigvals"]),
                                   np.sort(seq.eigvals.numpy()), rtol=1e-4, atol=1e-6)
    assert "probe-parallel" in probes[0]["log"] and "probe-parallel" not in probes[1]["log"]
    assert "lambda_max" in probes[0]["log"] and "lambda_max" not in probes[1]["log"]


def test_dryrun_multichip_two_ranks(basis, capsys):
    from hessian_llm_vision_tpu_torch.parallel import dryrun

    summary = dryrun.report(basis[0]["result"]["dryrun"])
    assert '{"dryrun_multichip":' in capsys.readouterr().out
    assert summary["ranks"] == N_RANKS
    assert summary["loss_rel"] <= 1e-6
    assert summary["grad_rel"] <= 1e-5 and summary["hvp_rel"] <= 1e-5
    assert summary["thick_restart_converged"] and summary["thick_restart_rel"] <= 1e-4
    assert summary["probe_parallel_T_diff"] == 0.0
    assert np.isfinite(summary["lanczos_sgd_step_loss"])


# ------------------------------------------------------ in this process

@pytest.mark.parametrize("op", ["rank_k_apply", "spectral_adjust", "project_out"])
def test_native_host_op_matches_jax_rank_k_apply(op):
    rng = np.random.RandomState(4)
    k, P = 5, 3001
    V = np.linalg.qr(rng.randn(P, k))[0].T.astype(np.float32)
    g = rng.randn(P).astype(np.float32)
    c = rng.randn(k).astype(np.float32)
    eig = np.array([-3.0, 0.5, 1.5, 4.0, 9.0], np.float32)
    if op == "rank_k_apply":
        got = native.rank_k_apply_native(g, V, c)
        want = jspectral.rank_k_apply_reference(jnp.asarray(g), jnp.asarray(V), jnp.asarray(c))
    elif op == "spectral_adjust":
        got = native.spectral_adjust_native(torch.as_tensor(g), torch.as_tensor(V), eig, 2.0)
        want = jspectral.spectral_adjust_reference(jnp.asarray(g), jnp.asarray(V),
                                                   jnp.asarray(eig), 2.0)
        assert isinstance(got, torch.Tensor)
        got = got.numpy()
    else:
        got = native.project_out_native(g, V)
        want = jspectral.project_out_reference(jnp.asarray(g), jnp.asarray(V))
        assert np.abs(V @ got).max() <= 1e-5
    assert got.dtype == np.float32 and got.shape == (P,)
    assert _rel(got, np.asarray(want)) <= 1e-6
    assert native.num_threads() >= 1


def test_native_host_op_refuses_device_tensors():
    g, V = torch.zeros(4), torch.zeros(2, 4)
    with pytest.raises(ValueError, match="host memory"):
        native.project_out_native(g.to("meta"), V)
    with pytest.raises(ValueError, match="host memory"):
        native.rank_k_apply_native(g, V.to("meta"), torch.ones(2))


def test_sharded_loss_refuses_direct_differentiation(sp):
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import make_layerwise_lanczos_sgd_step

    sharded = make_sharded_loss(sp["loss"], make_mesh())
    batch = sp["batches"][0]
    np.testing.assert_allclose(float(sharded(sp["params"], batch)),
                               float(sp["loss"](sp["params"], batch)), rtol=1e-6)
    with pytest.raises(TypeError, match="no gradient of its own"):
        torch.func.grad(lambda p: sharded(p, batch))(dict(sp["params"]))
    with pytest.raises(TypeError, match="no gradient of its own"):
        sharded({k: p.clone().requires_grad_() for k, p in sp["params"].items()}, batch)
    init_fn, step_fn = make_layerwise_lanczos_sgd_step(sharded, sp["params"],
                                                       LanczosSGDConfig(k=2, normalization="mean"))
    with pytest.raises(TypeError, match="no gradient of its own"):  # its per-tensor HVP
        step_fn(init_fn(dict(sp["params"])), batch)


def test_offload_to_host_and_to_device():
    x = torch.arange(6.0).reshape(2, 3)
    assert to_host(x) is x  # a CPU tensor is already on the host
    y = to_device(x, torch.device("cpu"))
    assert y.device.type == "cpu" and torch.equal(y, x)


def test_mesh_vocabulary_without_a_group():
    assert not torch.distributed.is_initialized()
    assert dist_init.initialize() is False and not dist_init.is_multihost()
    mesh = make_mesh()
    assert (mesh.shape, mesh.size, mesh.index) == ({"data": 1, "model": 1}, 1, 0)
    with pytest.raises(ValueError, match="requested 2 ranks, have 1"):
        make_mesh(num_data=1, num_model=2)
    with pytest.raises(ValueError, match="requested 2 ranks, have 1"):
        make_mesh(num_data=2)
    batch = {"input_ids": torch.arange(8).reshape(4, 2), "n": torch.tensor(4)}
    assert shard_batch(batch, mesh) is not None and torch.equal(
        shard_batch(batch, mesh)["input_ids"], batch["input_ids"])
    two = Mesh(2, index=1)  # the rows rank 1 of two would keep
    assert torch.equal(shard_batch(batch, two)["input_ids"], batch["input_ids"][2:])
    assert shard_batch(batch, two)["n"] is batch["n"]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": torch.zeros(3)}, two)
    assert data_sharding(two).parts(0) == 2 and replicated_sharding(two).parts(0) == 1
    assert basis_sharding(two).parts(0) == 1 and basis_sharding(two).parts(1) == 2
    sh = PShard(basis_sharding(two), 61)
    assert (sh.size, sh.lo, sh.width) == (31, 31, 30)  # P padded to 62, its pad not stored
    assert sh.local(torch.arange(61.0)).tolist() == list(range(31, 61)) + [0.0]


def test_initialize_with_an_in_process_store():
    try:
        assert dist_init.initialize(num_processes=1, process_id=0, backend="gloo",
                                    store=torch.distributed.HashStore())
        assert dist_init.initialize()  # a no-op once the group is up
        assert torch.distributed.get_world_size() == 1 and not dist_init.is_multihost()
        assert make_mesh().num_data == 1
    finally:
        torch.distributed.destroy_process_group()


def test_sharded_basis_on_one_rank_matches_jax_mesh():
    M, v0, iters = _basis_inputs()[0]["61"]
    j_mesh = jlanczos(jax.jit(lambda v: jnp.asarray(M) @ v), 61, iters, v0=jnp.asarray(v0),
                      reorth=True, basis_sharding=jbasis_sharding(jmake_mesh()))
    res = lanczos(MatrixOperator(torch.as_tensor(M)).matvec, 61, iters, v0=torch.as_tensor(v0),
                  basis_sharding=basis_sharding(make_mesh()))
    assert res.basis.shape == (iters, 61)
    np.testing.assert_allclose(res.alphas.numpy(), np.asarray(j_mesh.alphas), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(res.basis.numpy(), np.asarray(j_mesh.basis), atol=1e-4)
