"""Hyperparameter optimisation for LanczosSGD and Adam (port of
``cli/hpo.py``).

Each trial suggests (k, lr, delta, lanczos_momentum) for ``--optimiser
lanczos`` or (beta2, lr, delta) for ``adam`` and runs the port's train CLI
in-process with them after the passthrough flags; its final loss is the
trial's score, and a trial that raises or ends on a non-finite loss scores
``inf``.  Samplers: optuna when installed, else the port's TPE
(``utils/tpe.py``), or the seeded random search.  The study (best point,
its loss, the backend and every trial) is printed and written as JSON.

Example:
  python -m hessian_llm_vision_tpu_torch.cli.hpo --trials 10 -- --model spiral \\
      --cpu --optimiser lanczos --epochs 2
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random

SPACE = {
    "lanczos": {
        "k": ("int", 5, 50),
        "lr": ("log", 1e-4, 1e-1),
        "delta": ("log", 1e-6, 1e-2),
        "lanczos_momentum": ("float", 0.0, 0.99),
    },
    "adam": {
        "beta2": ("log", 0.9, 0.9999),
        "lr": ("log", 1e-6, 1e-3),
        "delta": ("log", 1e-9, 1.0),
    },
}


def _suggest(space, trial=None, rng=None):
    """One point of ``space``: from an optuna ``trial``, or uniform (log
    dimensions uniform in the log) from the ``random.Random`` ``rng``."""
    point = {}
    for name, (kind, lo, hi) in space.items():
        if trial is not None:
            if kind == "int":
                point[name] = trial.suggest_int(name, lo, hi)
            else:
                point[name] = trial.suggest_float(name, lo, hi, log=kind == "log")
        elif kind == "int":
            point[name] = rng.randint(lo, hi)
        elif kind == "log":
            point[name] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
        else:
            point[name] = rng.uniform(lo, hi)
    return point


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--trials", type=int, default=50)
    p.add_argument("--optimiser", default="lanczos")
    p.add_argument("--hpo_seed", type=int, default=0)
    p.add_argument("--space", default="reference", choices=["reference", "wide"],
                   help="'reference' = the JAX package's ranges; 'wide' lifts "
                   "the lr upper bound to 1e-1 (the Adam space caps lr at 1e-3)")
    p.add_argument("--sampler", default="auto", choices=["auto", "optuna", "tpe", "random"],
                   help="'auto' = optuna when installed, else the TPE sampler "
                   "(utils/tpe.py); 'random' = the seeded random search")
    p.add_argument("--out_json", default="best_params.json")
    args, passthrough = p.parse_known_args(argv)
    passthrough = [a for a in passthrough if a != "--"]

    from hessian_llm_vision_tpu_torch.cli import train as train_cli

    space = dict(SPACE.get(args.optimiser, SPACE["lanczos"]))
    if args.space == "wide":
        kind, lo, _ = space["lr"]
        space["lr"] = (kind, lo, 1e-1)

    def run_point(point) -> float:
        cli_args = list(passthrough) + ["--optimiser", args.optimiser]
        for k, v in point.items():
            cli_args += [f"--{k}", str(v)]
        try:
            loss = float(train_cli.main(cli_args))
            return loss if math.isfinite(loss) else float("inf")
        except Exception as e:  # a failed trial scores inf
            print(f"trial failed: {type(e).__name__}: {e}")
            return float("inf")

    trials = []  # the whole study, written beside the best point
    sampler = args.sampler
    if sampler in ("auto", "optuna"):
        try:
            import optuna  # noqa: F401
            sampler = "optuna"
        except ImportError:
            if sampler == "optuna":
                raise SystemExit("--sampler optuna: optuna is not installed")
            sampler = "tpe"
            print("[hpo] optuna not installed; using the native TPE sampler")

    if sampler == "optuna":
        import optuna

        def objective(trial):
            point = _suggest(space, trial=trial)
            loss = run_point(point)
            trials.append({"params": point, "loss": loss})
            return loss

        study = optuna.create_study(direction="minimize")
        study.optimize(objective, n_trials=args.trials)
        best = {"params": study.best_params, "loss": study.best_value, "backend": "optuna"}
    else:
        if sampler == "tpe":
            from hessian_llm_vision_tpu_torch.utils.tpe import TPESampler

            tpe = TPESampler(space, seed=args.hpo_seed)
            suggest, backend = tpe.suggest, "tpe"
        else:
            print("[hpo] seeded random search")
            rng = random.Random(args.hpo_seed)
            suggest, backend = (lambda _trials: _suggest(space, rng=rng)), "random-search"
        best = {"params": None, "loss": float("inf"), "backend": backend}
        for i in range(args.trials):
            point = suggest(trials)
            loss = run_point(point)
            trials.append({"params": point, "loss": loss})
            print(f"trial {i}: {point} -> {loss:.5f}", flush=True)
            if loss < best["loss"]:
                best = {"params": point, "loss": loss, "backend": backend}
    best["trials"] = trials

    print(json.dumps(best, indent=2))
    # a long study must not lose its result to a missing directory
    os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
    with open(args.out_json, "w") as f:
        json.dump(best, f, indent=2)
    print(f"best -> {args.out_json}")
    return best


if __name__ == "__main__":
    main()
