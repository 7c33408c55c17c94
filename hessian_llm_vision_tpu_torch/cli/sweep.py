"""Grid sweeps over training hyperparameters (port of ``cli/sweep.py``).

One in-process driver: each point of the grid runs the port's train CLI
(``cli/train.py::main``) with the point's flags after the passthrough
flags, and the table of final losses, best first, is printed and
optionally written as JSON.  A point that raises or ends on a non-finite
loss scores ``inf``; a ``SystemExit`` (a bad flag, no card) stops the
sweep.

Example:
  python -m hessian_llm_vision_tpu_torch.cli.sweep --grid lr=0.01,0.1 k=5,10 \\
      -- --model spiral --cpu --epochs 2 --optimiser lanczos
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os


def parse_grid(items):
    """``["key=v1,v2", ...]`` -> ``{key: ["v1", "v2"]}``."""
    grid = {}
    for item in items:
        key, _, vals = item.partition("=")
        if not vals:
            raise SystemExit(f"bad --grid entry {item!r}; want key=v1,v2,...")
        grid[key] = vals.split(",")
    return grid


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grid", nargs="+", required=True,
                   help="key=v1,v2 ... (flags of cli.train, no leading --)")
    p.add_argument("--out_json", default=None)
    args, passthrough = p.parse_known_args(argv)
    passthrough = [a for a in passthrough if a != "--"]

    from hessian_llm_vision_tpu_torch.cli import train as train_cli

    grid = parse_grid(args.grid)
    keys = list(grid)
    results = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        point = dict(zip(keys, combo))
        cli_args = list(passthrough)
        for k, v in point.items():
            cli_args += [f"--{k}", v]
        print(f"=== sweep point {point} ===")
        try:
            loss = float(train_cli.main(cli_args))
            if not math.isfinite(loss):  # a diverged point counts as failed
                loss = float("inf")
        except SystemExit:
            raise
        except Exception as e:  # a failed point must not end the sweep
            print(f"point failed: {type(e).__name__}: {e}")
            loss = float("inf")
        results.append({"point": point, "final_loss": loss})

    results.sort(key=lambda r: r["final_loss"])
    print(json.dumps(results, indent=2, default=str))
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump(results, f, indent=2, default=str)
    return results


if __name__ == "__main__":
    main()
