"""Catastrophic-forgetting (eigenvector-projection) experiment (port of
``cli/forget.py``).

Train on task A, take its Hessian eigenbasis, then train on task B twice:
plain SGD (the baseline) and SGD with the gradient projected off task A's
basis, ``g <- g - sum_i (v_i.g) v_i``, tracking task A's accuracy after
every step of both.  The curves go to an npz.  Flag names and defaults are
the JAX CLI's.

Tasks: spirals (task B is the next seed's spirals, negated); SimpleNet on
MNIST's test split cut 80/20 (task B: other digits, ``noisy`` or
``permuted``; the files must be on disk); ``vgg16`` and ``resnet50`` both
train a VGG-16 with a 256-wide classifier on CIFAR-10 class subsets, as the
JAX CLI does.  Weights and the Lanczos start vectors are drawn from one CPU
generator seeded with ``--seed`` (weights first), so a card run and a CPU
run start alike; the JAX package draws them with its own keys.

Runs on the first CUDA device unless ``--cpu`` is given; without ``--cpu``
and without a card it exits with an error.  The projection is the rank-k
apply of ``ops/spectral.py``: on the card, the CUDA kernel pair, once per
projected step.

:func:`main` is :func:`run`, which returns every record of the run (each
phase's params and seconds, the basis with its eigenvalues and solver
result); its steps are functions of their own (:func:`setup`,
:func:`train_task_a`, :func:`task_a_basis`, :func:`ab_overlap`,
:func:`task_b_phases`), and ``on_step`` sees every training step's params
and raw gradient.

Example:
  python -m hessian_llm_vision_tpu_torch.cli.forget --model spiral \\
      --epochs_a 30 --epochs_b 30 --k 10 --out_curves /tmp/forget.npz --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from hessian_llm_vision_tpu_torch.cli.common import add_common_args, device_for
from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
from hessian_llm_vision_tpu_torch.krylov import (
    lanczos,
    lanczos_thick_restart,
    ritz_decomposition,
    subspace_overlap,
)
from hessian_llm_vision_tpu_torch.optim.manual import (
    GradientTransformation,
    apply_updates,
    chain,
    manual_adam,
    sgd_momentum,
)
from hessian_llm_vision_tpu_torch.optim.projection import project_gradients
from hessian_llm_vision_tpu_torch.optim.schedules import linear_decay
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lr_a", type=float, default=5e-3,
                   help="Adam LR for the task-A pre-training phase")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--epochs_a", type=int, default=600)
    p.add_argument("--epochs_b", type=int, default=30)
    p.add_argument("--k", type=int, default=10, help="eigenbasis size")
    p.add_argument("--thick_restart", action="store_true",
                   help="compute the task-A basis as --k CONVERGED top-|λ| "
                   "eigenpairs by thick-restart Lanczos, instead of one "
                   "unrestarted k-iter pass (spectrum CLI's --thick_restart "
                   "K plays the --k role there)")
    p.add_argument("--tr_inner", type=int, default=None, metavar="M",
                   help="thick-restart inner buffer size (default "
                   "max(2k+2, k+12))")
    p.add_argument("--dataset_a", type=int, nargs="*", default=[0, 1, 2, 3, 4])
    p.add_argument("--dataset_b", type=int, nargs="*", default=[5, 6, 7, 8, 9])
    p.add_argument("--batch_size_b", type=int, default=0,
                   help="minibatch size for the task-B phases (0 = full "
                   "batch); per-step task-A accuracy is tracked either way")
    p.add_argument("--task_b", default="classes",
                   choices=["classes", "noisy", "permuted"],
                   help="MNIST task-B construction: 'classes' = the digit "
                   "subset --dataset_b (projection gives no sustained "
                   "protection for fully disjoint classes in the JAX "
                   "package's measurements); 'noisy' = task-A classes + "
                   "Gaussian noise (--noise std, default 1.0); 'permuted' = "
                   "a fixed pixel permutation (the shared-label domain "
                   "shift where curvature-subspace protection applies)")
    p.add_argument("--linear_decay_b", action="store_true",
                   help="linearly decay the task-B lr to zero over the phase")
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--out_curves", default=None)
    return p


def _tasks(args, device: torch.device, generator: torch.Generator):
    """Two tasks with a shared head: ``(model, params, loss_fn, acc_fn,
    (xa, ya), (xb, yb), eval_a)``, the arrays as numpy (labels int32), the
    weights drawn from ``generator`` and moved to ``device``.  ``eval_a``
    is task A's held-out split where there is one, else ``(xa, ya)``
    itself."""
    from hessian_llm_vision_tpu_torch.data import (
        add_gaussian_noise,
        get_class_subset,
        load_cifar10,
        load_mnist,
        make_spirals,
    )
    from hessian_llm_vision_tpu_torch.models import VGG16, SimpleNet, SpiralMLP
    from hessian_llm_vision_tpu_torch.models.losses import classification_loss_fn

    eval_a = None
    if args.model in ("simplenet", "mnist"):
        # MNIST digit subsets with a shared unremapped 10-class head; the
        # test split is cut 80/20 into the tasks and task A's held-out eval
        x, y = load_mnist("test")
        cut = int(0.8 * len(x))
        (x, y), (xt, yt) = (x[:cut], y[:cut]), (x[cut:], y[cut:])
        xa, ya = get_class_subset(x, y, args.dataset_a, remap=False)
        eval_a = get_class_subset(xt, yt, args.dataset_a, remap=False)
        if args.task_b == "classes":
            xb, yb = get_class_subset(x, y, args.dataset_b, remap=False)
        elif args.task_b == "noisy":  # the same classes, a noisy view
            xb, yb = add_gaussian_noise(xa, std=args.noise or 1.0, seed=args.data_seed), ya.copy()
        else:  # permuted: the same classes under one fixed pixel permutation
            perm = np.random.RandomState(args.data_seed).permutation(28 * 28)
            xb, yb = xa.reshape(len(xa), -1)[:, perm].reshape(xa.shape), ya.copy()
        n = int(len(xa) * args.subsample) or 256
        xa, ya, xb, yb = xa[:n], ya[:n], xb[:n], yb[:n]
        model = SimpleNet(generator=generator)
    elif args.model in ("vgg16", "resnet50"):
        # both build the JAX CLI's VGG-16 with a 256-wide classifier on
        # remapped CIFAR-10 class subsets
        x, y = load_cifar10("train")
        xa, ya = get_class_subset(x, y, args.dataset_a)
        xb, yb = get_class_subset(x, y, args.dataset_b)
        n = int(len(xa) * args.subsample) or 256
        xa, ya, xb, yb = xa[:n], ya[:n], xb[:n], yb[:n]
        model = VGG16(num_classes=len(args.dataset_a), classifier_width=256,
                      generator=generator)
    else:
        # spirals: task B is the next seed's spirals, negated (same labels)
        xa, ya = make_spirals(args.num_points, seed=args.data_seed)
        xb, yb = make_spirals(args.num_points, seed=args.data_seed + 1)
        xb = -xb
        model = SpiralMLP(width=args.width, depth=args.depth, generator=generator)
    model = model.to(device)
    params = {n: p.detach() for n, p in model.named_parameters()}

    @torch.no_grad()
    def acc_fn(p, x, y) -> float:
        """Accuracy of one forward over all of (x, y), rounded as the JAX
        package's f32 mean: the count times the f32 reciprocal of n."""
        logits = functional_call(model, p, (torch.as_tensor(x, device=device),))
        y = torch.as_tensor(y, device=device).long()
        correct = int((logits.argmax(-1) == y).sum())
        return float(np.float32(correct) * (np.float32(1.0) / np.float32(len(y))))

    if eval_a is None:
        eval_a = (xa, ya)
    return model, params, classification_loss_fn(model), acc_fn, (xa, ya), (xb, yb), eval_a


def _batch(x, y, device: torch.device) -> dict:
    return {"image": torch.as_tensor(np.ascontiguousarray(x), device=device),
            "label": torch.as_tensor(np.asarray(y, np.int64), device=device)}


def _minibatches(x, y, batch_size: int, seed: int, device: torch.device) -> list:
    """Seeded shuffle -> equal-size minibatches (the tail dropped), or the
    whole shuffled set as one batch when ``batch_size`` is 0 or at least
    its size."""
    order = np.random.RandomState(seed).permutation(len(x))
    x, y = np.asarray(x)[order], np.asarray(y)[order]
    if batch_size <= 0 or batch_size >= len(x):
        return [_batch(x, y, device)]
    n = (len(x) // batch_size) * batch_size
    return [_batch(x[i:i + batch_size], y[i:i + batch_size], device)
            for i in range(0, n, batch_size)]


@dataclasses.dataclass
class Experiment:
    """The two tasks on ``device``, ready to train: the loss and accuracy
    functions, the initial params and their flattener, task A's batch and
    its eval batch (held out or not), task B's minibatches, all of task B
    (for its learned accuracy) and its probe batch (for the A/B overlap),
    and the Lanczos start vectors of task A's and task B's bases."""

    args: argparse.Namespace
    device: torch.device
    loss_fn: Callable
    acc_fn: Callable
    params0: dict
    flattener: Flattener
    batch_a: dict
    eval_a: dict
    held_out: bool
    batches_b: list
    task_b: dict
    probe_b: dict
    v0_a: torch.Tensor
    v0_b: torch.Tensor


@dataclasses.dataclass
class Phase:
    """One training phase: its params in and out, task A's accuracy after
    every step (empty for task A itself) and its wall seconds (the device
    synchronised at both ends)."""

    params_in: dict
    params_out: dict
    curve: list
    seconds: float


class Basis(NamedTuple):
    """Task A's eigenbasis: (k, P) f32 rows, the eigenvalues (ascending),
    the solver's own result and the seconds it took."""

    vectors: torch.Tensor
    eigvals: np.ndarray
    result: object
    seconds: float


@dataclasses.dataclass
class Result:
    """Everything one run computed; ``curves`` is what ``main`` returns."""

    experiment: Experiment
    task_a: Phase
    acc_a0: float
    basis: Basis
    ab_overlap: float
    baseline: Phase
    projected: Phase
    acc_b_base: float
    acc_b_proj: float

    @property
    def curves(self) -> tuple[list, list]:
        return self.baseline.curve, self.projected.curve


# on_step(phase, params_in, grads, params_out), called after every
# training step of every phase ("task_a", "baseline", "projected") with
# the raw gradient of that step, and once as phase "basis" (grads None,
# params_in and params_out task A's) when task A's basis is done
OnStep = Callable[[str, dict, dict, dict], None]


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def setup(args, device: torch.device, init_params: Optional[dict] = None,
          start_vectors: Optional[tuple] = None) -> Experiment:
    """The tasks and the seeded draws: weights, then the two start vectors,
    from one CPU generator seeded with ``--seed``.  ``init_params`` (a dict
    of tensors by the model's parameter names) replaces the initial
    weights and ``start_vectors`` (two (P,) tensors) the start vectors."""
    gen = torch.Generator().manual_seed(args.seed)
    _, params0, loss_fn, acc_fn, (xa, ya), (xb, yb), (xe, ye) = _tasks(args, device, gen)
    if init_params is not None:
        params0 = {n: init_params[n].to(device, torch.float32) for n in params0}
    fl = Flattener(params0)
    if start_vectors is None:
        start_vectors = tuple(torch.randn(fl.size, generator=gen) for _ in range(2))
    v0_a, v0_b = (v.to(device, torch.float32) for v in start_vectors)
    n_probe = min(len(xb), len(xa))
    return Experiment(
        args=args, device=device, loss_fn=loss_fn, acc_fn=acc_fn, params0=params0,
        flattener=fl, batch_a=_batch(xa, ya, device), eval_a=_batch(xe, ye, device),
        held_out=xe is not xa,
        batches_b=_minibatches(xb, yb, args.batch_size_b, args.data_seed, device),
        task_b=_batch(xb, yb, device), probe_b=_batch(xb[:n_probe], yb[:n_probe], device),
        v0_a=v0_a, v0_b=v0_b)


def _train_phase(loss_fn, tx: GradientTransformation, params: dict, batches: Sequence,
                 epochs: int, track: Callable[[dict], float],
                 on_step: Optional[Callable[[dict, dict, dict], None]] = None):
    """``epochs`` passes over ``batches``, one step per batch; ``track``
    is read after every step, and ``on_step(params_in, grads, params_out)``
    called.  Returns ``(params, curve)``."""
    state = tx.init(params)
    curve = []
    for _ in range(epochs):
        for b in batches:
            _, g = grad_and_loss(loss_fn, params, b)
            updates, state = tx.update(g, state, params)
            new = apply_updates(params, updates)
            curve.append(track(new))
            if on_step is not None:
                on_step(params, g, new)
            params = new
    return params, curve


def _phase(exp: Experiment, name: str, tx: GradientTransformation, params: dict,
           batches: Sequence, epochs: int, track, on_step: Optional[OnStep]) -> Phase:
    hook = None if on_step is None else (lambda p, g, q: on_step(name, p, g, q))
    t0 = _clock(exp.device)
    params_out, curve = _train_phase(exp.loss_fn, tx, params, batches, epochs, track, hook)
    return Phase(params, params_out, curve, _clock(exp.device) - t0)


def train_task_a(exp: Experiment, on_step: Optional[OnStep] = None) -> Phase:
    """Task A by full-batch Adam at ``--lr_a`` (the comparison is baseline
    against projected SGD on task B, not how A was trained)."""
    phase = _phase(exp, "task_a", manual_adam(exp.args.lr_a), exp.params0, [exp.batch_a],
                   exp.args.epochs_a, lambda p: 0.0, on_step)
    phase.curve = []
    return phase


def _task_a_basis(args, op, v0: torch.Tensor) -> Basis:
    """Task A's eigenbasis: ``--k`` converged top-|λ| pairs by thick
    restart, or the Ritz pairs of one reorthogonalised k-step Lanczos pass."""
    t0 = _clock(v0.device)
    if args.thick_restart:
        tres = lanczos_thick_restart(op.matvec, op.dim, args.k, v0=v0, inner=args.tr_inner,
                                     which="lm")
        if not tres.converged:
            raise SystemExit(
                f"--thick_restart: basis NOT converged after {tres.restarts} restarts (max "
                f"resid {tres.residuals.max():.1e}); raise --tr_inner (or drop the flag for a "
                "plain one-pass basis) rather than projecting onto an unconverged basis"
            )
        print(f"task A eigenbasis: k={args.k} CONVERGED ({tres.restarts} restarts, max resid "
              f"{tres.residuals.max():.1e}), lambda_max={float(tres.eigvals.max()):.3f}")
        return Basis(tres.vectors, np.asarray(tres.eigvals), tres, _clock(v0.device) - t0)
    spec = ritz_decomposition(lanczos(op.matvec, op.dim, args.k, v0=v0, reorth=True),
                              with_vectors=True)
    print(f"task A eigenbasis: k={args.k}, lambda_max={float(spec.eigvals[-1]):.3f}")
    return Basis(spec.ritz_vectors, spec.eigvals.numpy(), spec, _clock(v0.device) - t0)


def task_a_basis(exp: Experiment, params_a: dict) -> Basis:
    """Task A's eigenbasis at ``params_a``, from the start vector ``v0_a``."""
    op = HessianOperator(exp.loss_fn, params_a, exp.batch_a, flattener=exp.flattener)
    return _task_a_basis(exp.args, op, exp.v0_a)


def ab_overlap(exp: Experiment, params_a: dict, basis: torch.Tensor) -> float:
    """Task similarity: the mean cos^2 of the principal angles between task
    A's and task B's curvature eigenbases at task A's solution."""
    op_b = HessianOperator(exp.loss_fn, params_a, exp.probe_b, flattener=exp.flattener)
    basis_b = ritz_decomposition(lanczos(op_b.matvec, op_b.dim, exp.args.k, v0=exp.v0_b,
                                         reorth=True), with_vectors=True).ritz_vectors
    return subspace_overlap(basis, basis_b)


def task_b_phases(exp: Experiment, params_a: dict, basis: torch.Tensor,
                  on_step: Optional[OnStep] = None) -> tuple[Phase, Phase]:
    """Task B from ``params_a`` twice: SGD with momentum (the baseline), then
    the same with every gradient projected off ``basis``; task A's
    accuracy tracked after every step.  ``--linear_decay_b`` decays the lr
    to 0 across each phase."""
    args = exp.args
    total_b = args.epochs_b * len(exp.batches_b)
    lr_b = linear_decay(args.lr, total_b) if args.linear_decay_b else args.lr

    def track(p):
        return exp.acc_fn(p, exp.eval_a["image"], exp.eval_a["label"])

    base = _phase(exp, "baseline", sgd_momentum(lr_b, args.momentum, args.wd), params_a,
                  exp.batches_b, args.epochs_b, track, on_step)
    tx_proj = chain(project_gradients(basis, exp.flattener),
                    sgd_momentum(lr_b, args.momentum, args.wd))
    proj = _phase(exp, "projected", tx_proj, params_a, exp.batches_b, args.epochs_b, track,
                  on_step)
    return base, proj


def run(argv=None, *, init_params: Optional[dict] = None,
        start_vectors: Optional[tuple] = None, on_step: Optional[OnStep] = None) -> Result:
    """The whole experiment, printed and (with ``--out_curves``) saved, as
    :func:`main` runs it; returns every record of it.  ``init_params`` and
    ``start_vectors`` replace the seeded draws (:func:`setup`);
    ``on_step`` sees every training step."""
    args = build_parser().parse_args(argv)
    device = device_for(args.cpu)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    exp = setup(args, device, init_params, start_vectors)
    task_a = train_task_a(exp, on_step)
    params_a = task_a.params_out
    acc_a0 = exp.acc_fn(params_a, exp.eval_a["image"], exp.eval_a["label"])
    print(f"task A trained: acc_A = {acc_a0:.3f} "
          f"({'held-out' if exp.held_out else 'train'} eval)")
    basis = task_a_basis(exp, params_a)
    if on_step is not None:
        on_step("basis", params_a, None, params_a)
    overlap = ab_overlap(exp, params_a, basis.vectors)
    print(f"task A/B eigenbasis overlap (mean cos^2 principal angles): {overlap:.4f} "
          f"(~{args.k}/P={args.k / exp.flattener.size:.1e} if unrelated)")
    base, proj = task_b_phases(exp, params_a, basis.vectors, on_step)

    acc_b = [exp.acc_fn(ph.params_out, exp.task_b["image"], exp.task_b["label"])
             for ph in (base, proj)]
    res = Result(exp, task_a, acc_a0, basis, overlap, base, proj, *acc_b)
    curve_base, curve_proj = res.curves
    print(f"task-A acc after task B:  baseline {curve_base[-1]:.3f} "
          f"(drop {acc_a0 - curve_base[-1]:.3f})  projected {curve_proj[-1]:.3f} "
          f"(drop {acc_a0 - curve_proj[-1]:.3f})")
    print(f"task-B acc learned:       baseline {acc_b[0]:.3f}  projected {acc_b[1]:.3f}")
    if args.out_curves:
        np.savez(args.out_curves, baseline_drop=np.asarray(curve_base),
                 method_results=np.asarray(curve_proj), acc_a0=acc_a0, acc_b_base=acc_b[0],
                 acc_b_proj=acc_b[1], ab_overlap=overlap)
        print(f"curves -> {args.out_curves}")
    return res


def main(argv=None, **kw):
    """Run the experiment (:func:`run`); returns ``(curve_base,
    curve_proj)``, task A's accuracy after each task-B step of both phases."""
    return run(argv, **kw).curves


if __name__ == "__main__":
    main()
