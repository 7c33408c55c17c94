"""Weight carry between the JAX package's params and the port's, for every
LM family (GPT-2 with or without experts, NeoX, LLaMA), LoRA adapters and
the vision and MLP models, with ResNet-50's ``batch_stats``.

The port keeps flax's names and layouts (kernels (in, out), conv kernels
(kh, kw, in, out), the stacked ``(E, ...)`` expert leaves, LayerNorm and
RMSNorm ``scale``, BatchNorm ``scale``/``bias`` and its ``mean``/``var``
statistics), so both directions are name maps -- nested dict keys joined
with ``.`` -- with no transpose.  Arrays cross as numpy; nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Nested dict of arrays (the flax ``params``, or a LoRA adapter tree
    ``{path: {"A", "B"}}`` with ``/`` in its paths) -> port ``state_dict``
    of f32 tensors."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Any) -> None:
        if hasattr(node, "items"):
            for key, child in node.items():
                key = str(key).replace("/", ".")
                walk(f"{prefix}.{key}" if prefix else key, child)
        else:
            out[prefix] = torch.from_numpy(np.array(node, dtype=np.float32))

    walk("", tree)
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """Port ``state_dict`` -> nested dict of numpy f32 arrays (flax layout)."""
    tree: dict[str, Any] = {}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy().copy()
    return tree


def variables_from_jax(variables: Mapping[str, Any]) -> tuple[dict, dict]:
    """flax ``{"params": ..., "batch_stats": ...}`` -> (port params, port
    batch_stats), both ``{dotted name: f32 tensor}`` (batch_stats empty for
    a model without BatchNorm)."""
    return (params_from_jax(variables["params"]),
            params_from_jax(variables.get("batch_stats", {})))


def variables_to_jax(params: Mapping[str, torch.Tensor],
                     batch_stats: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """Port params and batch_stats -> flax variables of numpy f32 arrays."""
    out = {"params": params_to_jax(params)}
    if batch_stats:
        out["batch_stats"] = params_to_jax(batch_stats)
    return out


# the GPT-2 names, kept for their callers
gpt2_params_from_jax = params_from_jax
gpt2_params_to_jax = params_to_jax
