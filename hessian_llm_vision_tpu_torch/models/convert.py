"""Weight carry between the JAX package's params and the port's, for every
LM family (GPT-2 with or without experts, NeoX, LLaMA) and LoRA adapters.

The port keeps flax's names and layouts (kernels (in, out), the stacked
``(E, ...)`` expert leaves, LayerNorm and RMSNorm ``scale``), so both
directions are name maps -- nested dict keys joined with ``.`` -- with no
transpose.  Arrays cross as numpy; nothing here imports JAX.
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


# the GPT-2 names, kept for their callers
gpt2_params_from_jax = params_from_jax
gpt2_params_to_jax = params_to_jax
