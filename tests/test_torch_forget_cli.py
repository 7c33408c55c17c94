"""The port's forgetting experiment (``cli/forget.py``) against the JAX
CLI's, part by part on the same inputs: the tasks and minibatches bit for
bit, task A's Adam phase and the projected task-B phase from the JAX
package's params within 1e-5 (rel-L2), task A's basis from JAX's start
vectors (Ritz values within 1e-3, the same span), and the whole CLI on
spirals with the JAX init and draws handed over (curves within 1/60)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hessian_llm_vision_tpu.cli import forget as jforget
from hessian_llm_vision_tpu.curvature import HessianOperator as JHessianOperator
from hessian_llm_vision_tpu.krylov import lanczos as jlanczos
from hessian_llm_vision_tpu.krylov import lanczos_thick_restart as jthick_restart
from hessian_llm_vision_tpu.krylov import ritz_decomposition as jritz
from hessian_llm_vision_tpu.optim import linear_decay as jlinear_decay
from hessian_llm_vision_tpu.optim import project_gradients as jproject_gradients
from hessian_llm_vision_tpu.optim import sgd_momentum as jsgd_momentum
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.cli import forget
from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
from hessian_llm_vision_tpu_torch.krylov import subspace_overlap
from hessian_llm_vision_tpu_torch.models.convert import params_from_jax
from hessian_llm_vision_tpu_torch.optim.manual import chain, manual_adam, sgd_momentum
from hessian_llm_vision_tpu_torch.optim.projection import project_gradients
from hessian_llm_vision_tpu_torch.optim.schedules import linear_decay
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener
from test_torch_vision_data import write_cifar, write_mnist

CPU = torch.device("cpu")
# the JAX package's thick-restart CLI test, at its size
SPIRAL = ["--model", "spiral", "--epochs_a", "30", "--epochs_b", "5", "--k", "3",
          "--thick_restart", "--tr_inner", "10", "--lr", "0.5", "--width", "12", "--depth", "1",
          "--num_points", "60"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(ours: dict, ref: dict) -> float:
    """rel-L2 over every tensor of two param dicts, in float64."""
    num = sum(float(torch.sum((ours[n].double() - ref[n].double()) ** 2)) for n in ref)
    den = sum(float(torch.sum(ref[n].double() ** 2)) for n in ref)
    return (num / den) ** 0.5


def _both_tasks(argv):
    jargs, args = jforget.build_parser().parse_args(argv), forget.build_parser().parse_args(argv)
    key = jax.random.PRNGKey(jargs.seed)
    return (jforget._tasks(jargs, key),
            forget._tasks(args, CPU, torch.Generator().manual_seed(args.seed)), jargs, key)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _check_tasks(argv):
    ref, ours, _, _ = _both_tasks(argv)
    for i in (4, 5, 6):  # (xa, ya), (xb, yb), eval_a
        for a, b in zip(ours[i], ref[i]):
            _equal(np.asarray(a), np.asarray(b))
    assert (ours[6][0] is ours[4][0]) == (ref[6][0] is ref[4][0])  # held-out or not
    jshapes = {n: tuple(t.shape) for n, t in params_from_jax(ref[1]).items()}
    assert {n: tuple(t.shape) for n, t in ours[1].items()} == jshapes
    return ours


def test_tasks_spirals_equal_jax():
    _check_tasks(["--model", "spiral", "--num_points", "90", "--data_seed", "3"])


@pytest.mark.parametrize("task_b", ["classes", "noisy", "permuted"])
def test_tasks_mnist_equal_jax(tmp_path, monkeypatch, task_b):
    write_mnist(tmp_path, "test", 200, seed=4)
    monkeypatch.setenv("HLV_MNIST_DIR", str(tmp_path))
    ours = _check_tasks(["--model", "simplenet", "--task_b", task_b, "--noise", "0.5",
                         "--dataset_a", "0", "1", "2", "--dataset_b", "7", "8"])
    assert ours[6][0] is not ours[4][0]  # the held-out 20%
    if task_b == "classes":  # the unremapped 10-class head
        assert set(ours[5][1].tolist()) <= {7, 8}


@pytest.mark.parametrize("model", ["vgg16", "resnet50"])
def test_tasks_cifar_build_the_same_vgg16(tmp_path, monkeypatch, model):
    write_cifar(tmp_path, 40, seed=6)
    monkeypatch.setenv("HLV_CIFAR_DIR", str(tmp_path))
    ours = _check_tasks(["--model", model, "--subsample", "0.5"])
    assert type(ours[0]).__name__ == "VGG16"
    assert ours[1]["Dense_0.kernel"].shape[1] == 256 and ours[1]["Dense_2.bias"].shape == (5,)
    assert set(ours[4][1].tolist()) <= set(range(5)) and set(ours[5][1].tolist()) <= set(range(5))


@pytest.mark.parametrize("batch_size", [0, 7, 16, 40], ids=["full", "smaller", "equal", "larger"])
def test_minibatches_equal_jax(batch_size):
    rng = np.random.RandomState(0)
    x, y = rng.randn(16, 2).astype(np.float32), rng.randint(0, 3, 16).astype(np.int32)
    ours = forget._minibatches(x, y, batch_size, 42, CPU)
    ref = jforget._minibatches(x, y, batch_size, 42)
    assert len(ours) == len(ref) == (2 if batch_size == 7 else 1)
    for b, (xr, yr) in zip(ours, ref):
        _equal(b["image"].numpy(), np.asarray(xr))
        np.testing.assert_array_equal(b["label"].numpy(), np.asarray(yr))
        assert b["label"].dtype == torch.int64


@pytest.fixture(scope="module")
def spiral_phases():
    """Both packages' tasks at the JAX test's size, task A trained by the
    JAX CLI's Adam phase, and the port's params from the JAX init."""
    ref, ours, jargs, key = _both_tasks(SPIRAL)
    xa, ya = ref[4]
    jparams_a, _ = jforget._train_phase(ref[2], optax.adam(jargs.lr_a), ref[1],
                                        [(jnp.asarray(xa), jnp.asarray(ya))], jargs.epochs_a,
                                        lambda p: 0.0)
    return SimpleNamespace(ref=ref, ours=ours, args=jargs, key=key, jparams_a=jparams_a,
                           params0=params_from_jax(ref[1]))


def test_task_a_adam_phase_matches_jax(spiral_phases):
    s = spiral_phases
    xa, ya = s.ours[4]
    params_a, curve = forget._train_phase(s.ours[2], manual_adam(s.args.lr_a), s.params0,
                                          [forget._batch(xa, ya, CPU)], s.args.epochs_a,
                                          lambda p: 0.0)
    assert len(curve) == s.args.epochs_a
    assert _rel(params_a, params_from_jax(s.jparams_a)) <= 1e-5
    # task A has learned: the tracked accuracy is the port's acc_fn
    assert s.ours[3](params_a, xa, ya) == float(s.ref[3](s.jparams_a, xa, ya))


def _jax_basis(s, thick: bool):
    xa, ya = s.ref[4]
    fl = JFlattener(s.jparams_a)
    op = JHessianOperator(s.ref[2], s.jparams_a, (jnp.asarray(xa), jnp.asarray(ya)), flattener=fl)
    key = jax.random.fold_in(s.key, 1)
    if thick:
        tres = jthick_restart(op.matvec, op.dim, s.args.k, key=key, inner=s.args.tr_inner,
                              which="lm")
        assert tres.converged
        return np.asarray(tres.vectors), np.asarray(tres.eigvals), fl
    spec = jritz(jlanczos(op.matvec, op.dim, s.args.k, key=key, reorth=True), with_vectors=True)
    return np.asarray(spec.ritz_vectors), np.asarray(spec.eigvals), fl


@pytest.mark.parametrize("thick", [False, True], ids=["lanczos", "thick_restart"])
def test_task_a_basis_matches_jax(spiral_phases, thick, capsys):
    s = spiral_phases
    jbasis, jeig, jfl = _jax_basis(s, thick)
    args = forget.build_parser().parse_args(SPIRAL if thick else SPIRAL[:8] + SPIRAL[11:])
    xa, ya = s.ours[4]
    params_a = params_from_jax(s.jparams_a)
    op = HessianOperator(s.ours[2], params_a, forget._batch(xa, ya, CPU),
                         flattener=Flattener(params_a))
    v0 = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(s.key, 1), (jfl.size,))))
    basis, eigvals, _, _ = forget._task_a_basis(args, op, v0)
    assert ("CONVERGED" in capsys.readouterr().out) == thick
    assert basis.shape == jbasis.shape == (3, jfl.size)
    np.testing.assert_allclose(eigvals, jeig, rtol=1e-3)
    assert subspace_overlap(basis, jbasis) >= 1 - 1e-3


def test_projected_phase_matches_jax(spiral_phases):
    """The projected task-B phase from the same params and basis, with a
    linearly decaying lr and weight decay, minibatches of 16."""
    s = spiral_phases
    jbasis, _, jfl = _jax_basis(s, thick=False)
    lr, mom, wd, epochs = 0.5, 0.9, 1e-3, 3
    (xb, yb), (xe, ye) = s.ref[5], s.ref[6]
    jbatches = jforget._minibatches(xb, yb, 16, 42)
    total = epochs * len(jbatches)
    jtx = optax.chain(jproject_gradients(jnp.asarray(jbasis), jfl, use_pallas=None),
                      jsgd_momentum(jlinear_decay(lr, total), mom, wd))
    jparams, jcurve = jforget._train_phase(s.ref[2], jtx, s.jparams_a, jbatches, epochs,
                                           lambda p: s.ref[3](p, xe, ye))
    params_a = params_from_jax(s.jparams_a)
    batches = forget._minibatches(xb, yb, 16, 42, CPU)
    tx = chain(project_gradients(torch.from_numpy(jbasis), Flattener(params_a)),
               sgd_momentum(linear_decay(lr, total), mom, wd))
    params, curve = forget._train_phase(s.ours[2], tx, params_a, batches, epochs,
                                        lambda p: s.ours[3](p, xe, ye))
    assert len(curve) == len(jcurve) == total
    assert _rel(params, params_from_jax(jparams)) <= 1e-5
    assert curve == jcurve


@pytest.fixture(scope="module")
def whole_runs(tmp_path_factory):
    """The JAX CLI once, and the port's with the JAX init and start vectors."""
    tmp = tmp_path_factory.mktemp("forget")
    jbase, jproj = jforget.main(SPIRAL + ["--out_curves", str(tmp / "jax.npz")])
    args = jforget.build_parser().parse_args(SPIRAL)
    key = jax.random.PRNGKey(args.seed)
    jparams0 = jforget._tasks(args, key)[1]
    dim = sum(int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(jparams0))
    draws = tuple(torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i),
                                                                (dim,), jnp.float32)))
                  for i in (1, 2))
    base, proj = forget.main(SPIRAL + ["--cpu", "--out_curves", str(tmp / "port.npz")],
                             init_params=params_from_jax(jparams0), start_vectors=draws)
    with np.load(tmp / "jax.npz") as z:
        jz = {k: z[k] for k in z.files}
    with np.load(tmp / "port.npz") as z:
        ours = {k: z[k] for k in z.files}
    return SimpleNamespace(jax=(jbase, jproj, jz), port=(base, proj, ours))


def test_whole_cli_matches_jax(whole_runs):
    jbase, jproj, jz = whole_runs.jax
    base, proj, z = whole_runs.port
    assert sorted(z) == sorted(jz) == sorted(["baseline_drop", "method_results", "acc_a0",
                                              "acc_b_base", "acc_b_proj", "ab_overlap"])
    assert all(z[k].shape == jz[k].shape for k in z)
    assert float(z["acc_a0"]) == float(jz["acc_a0"])
    assert len(base) == len(jbase) == 5 and len(proj) == len(jproj) == 5
    np.testing.assert_allclose(base, jbase, atol=1 / 60 + 1e-9, rtol=0)
    np.testing.assert_allclose(proj, jproj, atol=1 / 60 + 1e-9, rtol=0)
    np.testing.assert_array_equal(z["baseline_drop"], np.asarray(base))
    assert 0.0 <= float(z["ab_overlap"]) <= 1.0
    np.testing.assert_allclose(float(z["ab_overlap"]), float(jz["ab_overlap"]), atol=1e-3)


def test_unconverged_thick_restart_exits_naming_tr_inner(monkeypatch):
    inner = forget.lanczos_thick_restart

    def one_cycle(*a, **kw):
        return inner(*a, **{**kw, "max_restarts": 1, "tol": 0.0})

    monkeypatch.setattr(forget, "lanczos_thick_restart", one_cycle)
    with pytest.raises(SystemExit, match="--tr_inner"):
        forget.main(SPIRAL[:6] + ["--epochs_b", "1", "--cpu"] + SPIRAL[6:])


def test_without_cpu_and_without_a_card_it_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        forget.main(SPIRAL)


def test_run_returns_its_records_and_reports_every_step(tmp_path):
    """``run`` is ``main``'s body: its Result holds what the npz holds, each
    phase's params in and out, and ``on_step`` sees every step (with its
    raw gradient) and the basis once; the steps replayed through the
    public functions give the same params."""
    argv = SPIRAL[:2] + ["--epochs_a", "20", "--epochs_b", "2", "--k", "3", "--width", "8",
                         "--depth", "1", "--num_points", "40", "--batch_size_b", "16", "--cpu",
                         "--out_curves", str(tmp_path / "c.npz")]
    seen = []
    res = forget.run(argv, on_step=lambda ph, p, g, q: seen.append((ph, g is None, p, q)))
    phases = [ph for ph, *_ in seen]
    assert phases == ["task_a"] * 20 + ["basis"] + ["baseline"] * 4 + ["projected"] * 4
    assert [none for ph, none, *_ in seen if ph == "basis"] == [True]
    assert res.task_a.params_in is res.experiment.params0
    assert res.baseline.params_in is res.projected.params_in is res.task_a.params_out
    assert seen[-1][3] is res.projected.params_out and seen[-5][3] is res.baseline.params_out
    with np.load(tmp_path / "c.npz") as z:
        np.testing.assert_array_equal(z["method_results"], res.curves[1])
        assert float(z["acc_a0"]) == res.acc_a0 and float(z["ab_overlap"]) == res.ab_overlap
    assert res.basis.vectors.shape == (3, res.experiment.flattener.size)
    assert np.all(np.diff(res.basis.eigvals) >= 0) and res.basis.seconds >= 0
    exp = forget.setup(forget.build_parser().parse_args(argv), CPU)
    again = forget.train_task_a(exp)
    assert _rel(again.params_out, res.task_a.params_out) == 0.0
    base, proj = forget.task_b_phases(exp, again.params_out, res.basis.vectors)
    assert (base.curve, proj.curve) == res.curves
    assert _rel(proj.params_out, res.projected.params_out) == 0.0
    assert forget.main(argv) == res.curves
