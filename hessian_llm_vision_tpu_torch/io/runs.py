"""Run-directory naming (port of ``io/runs.py``).

Hyperparameters live in the path:
``{root}/{optim}/{subsample}/lr=..._delta=..._batchsize=..._k=..._accum=..._lanczosmomentum=...``,
the same strings as the JAX package, with a parser for the leaf.
"""

from __future__ import annotations

import os
from typing import Any, Dict


def run_dir_name(root: str, optim: str, subsample, **hparams) -> str:
    parts = [f"{k}={v}" for k, v in hparams.items()]
    return os.path.join(root, optim, str(subsample), "_".join(parts))


def parse_run_dir(path: str) -> Dict[str, Any]:
    """Inverse of run_dir_name on the leaf component."""
    leaf = os.path.basename(os.path.normpath(path))
    out: Dict[str, Any] = {}
    for part in leaf.split("_"):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out
