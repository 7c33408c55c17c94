"""Weight carry between the JAX package's params and the port's, for every
LM family (GPT-2 with or without experts, NeoX, LLaMA), LoRA adapters and
the vision and MLP models, with ResNet-50's ``batch_stats``.

The port keeps flax's names and layouts (kernels (in, out), conv kernels
(kh, kw, in, out), the stacked ``(E, ...)`` expert leaves, LayerNorm and
RMSNorm ``scale``, BatchNorm ``scale``/``bias`` and its ``mean``/``var``
statistics), so both directions are name maps -- nested dict keys joined
with ``.`` -- with no transpose.  Arrays cross as numpy; nothing here
imports JAX.  On the model axis of a mesh, :func:`shard_for_tp` and
:func:`shard_for_ep` keep a rank's slices of a whole ``state_dict``, and
:func:`gather_model_axis` puts the ranks' slices (or their flat vectors)
back into the flax layout, so the tests compare with the JAX package leaf
by leaf and in its flat order.
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


def shard_for_tp(params: Mapping[str, torch.Tensor], mesh, config) -> dict:
    """This rank's tensor-parallel slices of a whole port ``state_dict`` (for
    example ``params_from_jax(tree)``): ``parallel/param_sharding.py``'s
    layout for ``config`` on ``mesh``'s model axis."""
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params_for_tp

    return shard_params_for_tp(params, mesh, config=config)


def shard_for_ep(params: Mapping[str, torch.Tensor], mesh) -> dict:
    """This rank's experts of a whole MoE GPT-2 ``state_dict``."""
    from hessian_llm_vision_tpu_torch.models.moe import shard_params_for_ep

    return shard_params_for_ep(params, mesh)


def gather_model_axis(local, mesh, layout) -> Any:
    """Every model rank's slices put back together, on every rank.

    ``local``: this rank's ``{name: tensor}`` (its slices of the split
    leaves: params, a gradient, an HVP) -> the whole flax-named dict; or
    its (P_r,) rank vector (``utils/flatten.py::ModelAxisLayout``; get it
    from a Krylov vector's part with ``krylov.sharded.ModelShard.gather``)
    -> the whole flat (P,) vector in the JAX package's flat order.
    ``layout``: a ``ModelAxisLayout``, or for a dict the ``{name: Split or
    None}`` of ``parallel.param_sharding.tp_layout`` / ``models.moe.ep_layout``.
    One all-reduce over the model axis per split leaf."""
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import unshard_leaf
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    splits = getattr(layout, "splits", layout)
    tree = layout.fl.unflatten(local) if isinstance(local, torch.Tensor) else local
    n, m = mesh.num_model, mesh.model_index
    whole = {}
    for name in sorted(tree, key=lambda k: tuple(k.split("."))):  # the same order on every rank
        t, split = tree[name], splits.get(name)
        if split is None:
            whole[name] = t
            continue
        buf = t.new_zeros((n,) + tuple(t.shape))
        buf[m] = t
        mesh.all_reduce_model_(buf)
        whole[name] = unshard_leaf(list(buf), split)
    if isinstance(local, torch.Tensor):
        return Flattener(whole).flatten(whole)
    return whole


# the GPT-2 names, kept for their callers
gpt2_params_from_jax = params_from_jax
gpt2_params_to_jax = params_to_jax
