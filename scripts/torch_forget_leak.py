"""How far the forget CLI's projected task-B phase drifts into task A's
basis on VGG-16, and why: the card's kernel projection against the plain
one, a float64 replay and a CPU replay of the same phase.

    python3 scripts/torch_forget_leak.py [--lrs 0.1 0.01] [--lr_a LR]
        [--nondeterministic N] [--out FILE]

The configuration is ``chip_smoke.py``'s 15b (``FORGET_VGG_ARGV``, the
seeded random CIFAR-10 pickles) with cuDNN's deterministic algorithms; the
first of ``--lrs`` runs the whole CLI (``cli.forget.run``), the others
rerun its two task-B phases from the same task-A params and basis.  For
each lr, per projected step: the gradient's share in the basis
``||V g|| / ||g||``, the projected gradient's leak ``||V g'|| / ||g'||``
from the kernel pair and from the plain version (recomputed from the
step's gradient), the applied update's leak ``||V u|| / ||u||`` and the
drift's ``||V (θ_t − θ_A)|| / ||θ_t − θ_A||`` after it, all float64 with
the plain product, and the leak of the gradient projected in float64
arithmetic on the same f32 rows.  Then the same phase replayed from the
same params, basis and batches: in f32 on the card through the kernel
pair (the run again) and through the plain projection, in f32 on the CPU,
and in float64 on the card onto the f32 rows as they are and onto those
rows made orthonormal in float64; each replay's drift leak (against the
rows and against the orthonormal ones) and its distance from the float64
replay onto the rows.  ``--nondeterministic N`` adds N whole CLI runs at the
first lr with cuDNN's default algorithms (task A's lambda_max and the
drift leak of each).  Needs a card.  Prints one JSON line per reading and
writes them to ``--out`` (default ``runs/forget_leak.jsonl``, git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from hessian_llm_vision_tpu_torch.cli import forget  # noqa: E402
from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss  # noqa: E402
from hessian_llm_vision_tpu_torch.ops import spectral  # noqa: E402
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener  # noqa: E402

CARD = torch.device("cuda")


def _argv(lr: float, lr_a: float | None) -> list[str]:
    argv = list(chip_smoke.FORGET_VGG_ARGV) + ["--lr", repr(lr)]
    if lr_a is not None:
        argv += ["--lr_a", repr(lr_a)]
    return argv


def _leak(V64: torch.Tensor, x: torch.Tensor) -> float:
    x = x.to(V64.device, torch.float64)
    return float(torch.linalg.vector_norm(V64 @ x) / torch.linalg.vector_norm(x))


def per_step(V: torch.Tensor, steps: list, p_a: torch.Tensor) -> list:
    """The readings of each recorded projected step ``(g, p_in, p_out)``."""
    V64, p_a64 = V.double(), p_a.double()
    out = []
    for g, p_in, p_out in steps:
        g64 = g.double()
        kern, plain = spectral.project_out(g, V), spectral.project_out_reference(g, V)
        exact = g64 - V64.T @ (V64 @ g64)  # float64 arithmetic on the f32 rows
        u = p_out.double() - p_in.double()
        out.append({
            "g_norm": float(torch.linalg.vector_norm(g64)),
            "g_share_in_basis": _leak(V64, g64),
            "leak_kernel": _leak(V64, kern), "leak_plain": _leak(V64, plain),
            "leak_float64_arithmetic": _leak(V64, exact),
            "kernel_vs_plain_rel": chip_smoke.rel_l2(kern, plain),
            "u_norm": float(torch.linalg.vector_norm(u)), "leak_update": _leak(V64, u),
            "drift_leak": _leak(V64, p_out.double() - p_a64),
            "max_abs_param": float(p_out.abs().max()),
        })
    return out


def _project64(g: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    return g - V.T @ (V @ g)


def replay(exp, params_a: dict, V: torch.Tensor, lr: float, dtype: torch.dtype,
           device: torch.device, project) -> torch.Tensor:
    """The projected phase again, from ``params_a`` on ``device`` in
    ``dtype``: the trainer's momentum step on the flat vector, the gradient
    projected by ``project(g, V)``.  Returns the drift ``θ_end − θ_A``
    (float64)."""
    args = exp.args
    params = {n: t.to(device, dtype) for n, t in params_a.items()}
    fl = Flattener(params)
    Vd = V.to(device, dtype)
    batches = [{"image": b["image"].to(device, dtype), "label": b["label"].to(device)}
               for b in exp.batches_b]
    def flat(d):  # in dtype (the Flattener's vector is f32)
        return torch.cat([d[n].reshape(-1) for n in fl.names])

    p0 = flat(params)
    p, buf = p0.clone(), torch.zeros_like(p0)
    for _ in range(args.epochs_b):
        for b in batches:
            _, g = grad_and_loss(exp.loss_fn, fl.unflatten(p), b)
            buf = buf * args.momentum + project(flat(g), Vd)
            p = p + buf * (-lr)
    return p.double() - p0.double()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lrs", type=float, nargs="+", default=[0.1, 0.01])
    ap.add_argument("--nondeterministic", type=int, default=2)
    ap.add_argument("--lr_a", type=float, default=None,
                    help="task A's Adam lr in place of FORGET_VGG_ARGV's")
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "forget_leak.jsonl"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_forget_leak.py needs a card")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    lines = []

    def emit(obj):
        print(json.dumps(obj), flush=True)
        lines.append(json.dumps(obj))

    emit({"card": chip_smoke.card_line(), "torch": torch.__version__, "argv": _argv(a.lrs[0], a.lr_a)})
    with tempfile.TemporaryDirectory() as tmp:
        mnist, cifar = os.path.join(tmp, "mnist"), os.path.join(tmp, "cifar")
        os.makedirs(mnist)
        chip_smoke.write_cifar_batches(cifar, chip_smoke.CIFAR_PER_BATCH)
        with chip_smoke.vision_data(mnist, cifar):
            steps: list = []

            def on_step(phase, p_in, g, p_out):
                if phase == "projected":
                    fl = Flattener(p_in)
                    steps.append(tuple(fl.flatten(t).clone() for t in (g, p_in, p_out)))

            torch.backends.cudnn.deterministic = True
            t0 = time.perf_counter()
            res = forget.run(_argv(a.lrs[0], a.lr_a), on_step=on_step)
            exp, V = res.experiment, res.basis.vectors
            params_a = res.task_a.params_out
            p_a = exp.flattener.flatten(params_a)
            emit({"run": "cli", "lr": a.lrs[0], "seconds": time.perf_counter() - t0,
                  "eigvals": res.basis.eigvals.tolist(), "acc_a0": res.acc_a0,
                  "curves": list(res.curves)})
            for i, lr in enumerate(a.lrs):
                if i:
                    steps.clear()
                    exp.args.lr = lr
                    base, proj = forget.task_b_phases(exp, params_a, V, on_step)
                    curves = [base.curve, proj.curve]
                else:
                    proj, curves = res.projected, list(res.curves)
                drift = exp.flattener.flatten(proj.params_out).double() - p_a.double()
                V64 = V.double()
                emit({"lr": lr, "curves": curves, "drift_leak": _leak(V64, drift),
                      "per_step": per_step(V, steps, p_a)})
                del V64
                # the float64 references: the f32 rows as they are, and the
                # rows made orthonormal in float64 (a QR of their transpose)
                Q = torch.linalg.qr(V.double().T).Q.T.contiguous()
                ref = replay(exp, params_a, V.double(), lr, torch.float64, CARD, _project64)
                readings = {}
                for name, dtype, dev, project, basis in (
                        ("card_f32_kernel", torch.float32, CARD, spectral.project_out, V),
                        ("card_f32_plain", torch.float32, CARD, spectral.project_out_reference, V),
                        ("cpu_f32_plain", torch.float32, torch.device("cpu"),
                         spectral.project_out, V),
                        ("card_f64_rows", torch.float64, CARD, _project64, V.double()),
                        ("card_f64_orthonormal", torch.float64, CARD, _project64, Q)):
                    t0 = time.perf_counter()
                    d = (ref if name == "card_f64_rows"
                         else replay(exp, params_a, basis, lr, dtype, dev, project))
                    d = d.to(CARD)
                    readings[name] = {
                        "drift_leak": _leak(V.double(), d), "leak_vs_Q": _leak(Q, d),
                        "rel_to_f64_rows": chip_smoke.rel_l2(d, ref),
                        "equals_run": bool(torch.equal(d, drift)),
                        "seconds": time.perf_counter() - t0}
                del Q, ref
                emit({"lr": lr, "replays": readings})
            torch.backends.cudnn.deterministic = False
            for r in range(a.nondeterministic):
                res = forget.run(_argv(a.lrs[0], a.lr_a))
                exp = res.experiment
                drift = (exp.flattener.flatten(res.projected.params_out).double()
                         - exp.flattener.flatten(res.task_a.params_out).double())
                emit({"run": f"nondeterministic_{r}", "lr": a.lrs[0],
                      "lambda_max": float(abs(res.basis.eigvals).max()),
                      "acc_a0": res.acc_a0,
                      "drift_leak": _leak(res.basis.vectors.double(), drift)})
    with open(a.out, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
