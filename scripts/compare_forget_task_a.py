"""The forget CLI's task-A phase in the JAX package and in the PyTorch port,
both on the CPU from the same initial params: how far their params drift
apart through the Adam steps, and what that does to task A's basis.

    JAX_PLATFORMS=cpu python3 scripts/compare_forget_task_a.py [--steps 30 100 300 600]
        [--out FILE] [FORGET FLAGS ...]

The configuration is the forget CLI's spiral at its defaults (width 64,
depth 3, 600 points, 600 full-batch Adam steps at lr 5e-3), or the forget
flags given after the script's own.  The JAX package draws the initial
params (``cli/forget.py::_tasks``), the port takes them over
(``models/convert.py::params_from_jax``), and each package runs its own
``_train_phase``.  Printed and written to ``--out`` (default
``runs/forget_task_a_witness.json``, git-ignored): the rel-L2 distance of
the two packages' params after each of ``--steps`` steps, and the port's
k-step Ritz values (the CLI's plain Lanczos basis, one start vector) at the
two final params, their distance over max |lambda|.  Like the tests, this
script imports both packages; it needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from hessian_llm_vision_tpu.cli import forget as jforget  # noqa: E402
from hessian_llm_vision_tpu_torch.cli import forget  # noqa: E402
from hessian_llm_vision_tpu_torch.models.convert import params_from_jax  # noqa: E402
from hessian_llm_vision_tpu_torch.optim.manual import manual_adam  # noqa: E402

CPU = torch.device("cpu")


def _rel(ours: dict, ref: dict) -> float:
    num = sum(float(torch.sum((ours[n].double() - ref[n].double()) ** 2)) for n in ref)
    den = sum(float(torch.sum(ref[n].double() ** 2)) for n in ref)
    return (num / den) ** 0.5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, nargs="+", default=[30, 100, 300, 600])
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "forget_task_a_witness.json"))
    a, rest = ap.parse_known_args(argv)
    fargv = ["--model", "spiral"] + rest + ["--epochs_a", str(max(a.steps)), "--cpu"]
    jargs, args = jforget.build_parser().parse_args(fargv), forget.build_parser().parse_args(fargv)
    key = jax.random.PRNGKey(jargs.seed)
    ref = jforget._tasks(jargs, key)
    exp = forget.setup(args, CPU, init_params=params_from_jax(ref[1]))
    xa, ya = ref[4]

    jsnap, snap = {}, {}

    def jtrack(p):
        jtrack.n += 1
        if jtrack.n in a.steps:
            jsnap[jtrack.n] = params_from_jax(p)
        return 0.0

    def track(p):
        track.n += 1
        if track.n in a.steps:
            snap[track.n] = {n: t.clone() for n, t in p.items()}
        return 0.0

    jtrack.n = track.n = 0
    jforget._train_phase(ref[2], optax.adam(jargs.lr_a), ref[1],
                         [(jnp.asarray(xa), jnp.asarray(ya))], jargs.epochs_a, jtrack)
    forget._train_phase(exp.loss_fn, manual_adam(args.lr_a), exp.params0, [exp.batch_a],
                        args.epochs_a, track)
    last = max(a.steps)
    eig = [np.asarray(forget.task_a_basis(exp, p).eigvals, np.float64)
           for p in (snap[last], jsnap[last])]
    out = {"argv": fargv, "torch": torch.__version__, "jax": jax.__version__,
           "params_rel": {s: _rel(snap[s], jsnap[s]) for s in a.steps},
           "ritz_port_at_jax_params": eig[1].tolist(), "ritz_port_at_port_params": eig[0].tolist(),
           "ritz_rel": float(np.abs(eig[0] - eig[1]).max() / np.abs(eig[1]).max())}
    print(json.dumps(out))
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
