"""Persisted auto-precision plans (port of ``krylov/precplan.py``): probe a
checkpoint once, reuse the verdict.

Precision fidelity is a property of the checkpoint (operand scales) and
the model/batch configuration, not of the run, so the winning
:class:`~hessian_llm_vision_tpu_torch.krylov.autoprec.AutoPrecisionPlan`
(with every probed arm as evidence) is saved as JSON, in the JAX
package's schema and ``PLAN_VERSION``, keyed by

* a **fingerprint** -- of the checkpoint file on disk
  (:func:`checkpoint_fingerprint`, no device work), or of the params
  (:func:`params_fingerprint`, one reduction per leaf on the device);
* a **context** -- the model config with the precision field the plan
  decides neutralised, the probe batch's shapes, the tolerance, the probe
  depth and the candidate labels.

A later run on the same checkpoint loads the plan and spends no probe
HVPs; ``--reprobe`` probes again and overwrites the file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Optional, Tuple

import torch

from hessian_llm_vision_tpu_torch.krylov.autoprec import AutoPrecisionPlan, PrecisionArm
from hessian_llm_vision_tpu_torch.utils.flatten import flat_order

PLAN_VERSION = 1


def params_fingerprint(params: dict) -> str:
    """Content hash of a ``{name: tensor}`` params dict: names, shapes,
    dtypes and per-leaf (sum, abs-sum) in f32, reduced on the params'
    device and hashed bit for bit.  Identical params on the same device
    kind collide; another step, architecture or reduction order does
    not."""
    names = flat_order(params)
    with torch.no_grad():
        stats = torch.stack([
            torch.stack([params[n].float().sum(), params[n].float().abs().sum()])
            for n in names
        ]).cpu().numpy()
    h = hashlib.sha256()
    h.update(repr(names).encode())
    h.update(repr([(tuple(params[n].shape), str(params[n].dtype)) for n in names]).encode())
    h.update(stats.tobytes())
    return "sha256:" + h.hexdigest()


def _hash_file(h, fp: str, rel: str) -> None:
    size = os.path.getsize(fp)
    h.update(rel.encode())
    h.update(str(size).encode())
    with open(fp, "rb") as f:
        if size <= 1 << 20:
            h.update(f.read())
        else:
            h.update(f.read(65536))
            f.seek(-65536, os.SEEK_END)
            h.update(f.read(65536))


def checkpoint_fingerprint(path: str) -> Optional[str]:
    """Content hash of an on-disk checkpoint, with no device work.

    The port's checkpoint is one ``torch.save`` file (``io/checkpoints.py``);
    it is hashed as the JAX package hashes each file of an Orbax
    directory: its name and size, and its whole bytes up to 1 MiB, else
    the first and last 64 KiB.  A directory is walked the same way.
    Returns None when the path is unusable (the caller then fingerprints
    the params)."""
    h = hashlib.sha256()
    try:
        if os.path.isfile(path):
            _hash_file(h, path, os.path.basename(path))
            return "sha256-ckpt:" + h.hexdigest()
        if not os.path.isdir(path):
            return None
        n_files = 0
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for name in sorted(files):
                fp = os.path.join(root, name)
                _hash_file(h, fp, os.path.relpath(fp, path))
                n_files += 1
    except OSError:
        return None
    return "sha256-ckpt:" + h.hexdigest() if n_files else None


def _encode_spec(spec: Any) -> dict:
    """JSON-safe encoding of a block-precision spec (None | str | per-layer
    tuple | dict), the JAX package's."""
    if spec is None:
        return {"kind": "none"}
    if isinstance(spec, str):
        return {"kind": "str", "value": spec}
    if isinstance(spec, dict):
        return {"kind": "dict", "value": dict(spec)}
    return {"kind": "tuple", "value": list(spec)}


def _decode_spec(d: dict) -> Any:
    kind = d["kind"]
    if kind == "none":
        return None
    if kind == "str":
        return d["value"]
    if kind == "dict":
        return dict(d["value"])
    return tuple(d["value"])


def plan_context(
    *,
    model_config: Any = None,
    probe_batch: Optional[dict] = None,
    tol: float,
    ritz_iters: int,
    candidate_labels: Tuple[str, ...] = (),
) -> dict:
    """The non-params half of the cache key.  The config's
    ``block_matmul_precision`` is neutralised (the plan decides it); the
    probe batch contributes its tensors' shapes and dtypes, in key order."""
    cfg_repr = None
    if model_config is not None:
        cfg = model_config
        if dataclasses.is_dataclass(cfg) and hasattr(cfg, "block_matmul_precision"):
            cfg = dataclasses.replace(cfg, block_matmul_precision=None)
        cfg_repr = repr(cfg)
    batch_shapes = None
    if probe_batch is not None:
        batch_shapes = [[list(probe_batch[k].shape), str(probe_batch[k].dtype)]
                        for k in sorted(probe_batch)]
    return {
        "model_config": cfg_repr,
        "batch_shapes": batch_shapes,
        "tol": tol,
        "ritz_iters": ritz_iters,
        "candidate_labels": list(candidate_labels),
    }


def default_plan_path(checkpoint: str) -> str:
    """A sibling of the checkpoint, never inside a checkpoint directory."""
    return checkpoint.rstrip("/") + ".autoprec.json"


def save_plan(
    path: str,
    plan: AutoPrecisionPlan,
    *,
    fingerprint: str,
    context: dict,
    provenance: Optional[dict] = None,
) -> None:
    """Write the plan atomically (a temporary file, then a rename)."""
    doc = {
        "version": PLAN_VERSION,
        "fingerprint": fingerprint,
        "context": context,
        "plan": {
            "label": plan.label,
            "hvp_precision": plan.hvp_precision,
            "block_precision": _encode_spec(plan.block_precision),
            "ritz_rel_err": plan.ritz_rel_err,
            "referee_extremes": [float(x) for x in plan.referee_extremes],
            "arms": [
                {
                    "label": a.label,
                    "block_precision": _encode_spec(a.block_precision),
                    "hvp_precision": a.hvp_precision,
                    "ritz_rel_err": a.ritz_rel_err,
                    "seconds_per_hvp": a.seconds_per_hvp,
                    "extremes": [float(x) for x in a.extremes],
                }
                for a in plan.arms
            ],
        },
        "provenance": {"created_unix": time.time(), "backend": "torch", **(provenance or {})},
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def load_plan(path: str, *, fingerprint: str, context: dict) -> Optional[AutoPrecisionPlan]:
    """The persisted plan, or None when absent, stale or for another
    checkpoint or context: a mismatch costs a probe, never the job."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("version") != PLAN_VERSION:
        return None
    if doc.get("fingerprint") != fingerprint:
        return None
    if doc.get("context") != context:
        return None
    p = doc["plan"]
    return AutoPrecisionPlan(
        block_precision=_decode_spec(p["block_precision"]),
        hvp_precision=p["hvp_precision"],
        label=p["label"],
        ritz_rel_err=p["ritz_rel_err"],
        referee_extremes=tuple(p["referee_extremes"]),
        arms=tuple(
            PrecisionArm(
                label=a["label"],
                block_precision=_decode_spec(a["block_precision"]),
                hvp_precision=a["hvp_precision"],
                ritz_rel_err=a["ritz_rel_err"],
                seconds_per_hvp=a["seconds_per_hvp"],
                extremes=tuple(a["extremes"]),
            )
            for a in p["arms"]
        ),
    )
