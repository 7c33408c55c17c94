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

:func:`gpt2_from_torch_state_dict`, :func:`neox_from_torch_state_dict` and
:func:`llama_from_torch_state_dict` read a Hugging Face state dict that is
already in memory (tensors or arrays, HF's names; ``transformers`` is not
imported) into the port's ``state_dict``, as the JAX package's converters
of those names read it into flax params: HF GPT-2's ``Conv1D`` weights are
already (in, out); NeoX's fused ``query_key_value`` is split per head into
[all q | all k | all v]; every ``nn.Linear`` weight (out, in) of NeoX and
LLaMA is transposed.  The ``*_from_pretrained`` wrappers, which need a
download, are not ported.
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
    One all-gather over the model axis per split leaf."""
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import unshard_leaf
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    splits = getattr(layout, "splits", layout)
    tree = layout.fl.unflatten(local) if isinstance(local, torch.Tensor) else local
    whole = {}
    for name in sorted(tree, key=lambda k: tuple(k.split("."))):  # the same order on every rank
        t, split = tree[name], splits.get(name)
        if split is None:
            whole[name] = t
            continue
        buf = mesh.all_gather(t.unsqueeze(0), "model")
        whole[name] = unshard_leaf(list(buf), split)
    if isinstance(local, torch.Tensor):
        return Flattener(whole).flatten(whole)
    return whole


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def _hf_getter(sd: Mapping[str, Any], prefix: str, keep=()):
    """``key -> f32 array`` of ``sd`` with DataParallel's ``module.`` and,
    when any key has it, ``prefix`` stripped (except the keys in ``keep``)."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if any(k.startswith(prefix) for k in sd):
        sd = {(k if k in keep else k.removeprefix(prefix)): v for k, v in sd.items()}
    return sd, lambda key: _np(sd[key])


def gpt2_from_torch_state_dict(sd: Mapping[str, Any], config) -> dict[str, torch.Tensor]:
    """HF ``GPT2LMHeadModel`` state dict (``transformer.``-prefixed or bare
    keys; the tied ``lm_head.weight`` ignored) -> the port's GPT-2
    ``state_dict``."""
    sd, g = _hf_getter(sd, "transformer.")
    params: dict = {"wte": g("wte.weight"), "wpe": g("wpe.weight"),
                    "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")}}
    for i in range(config.n_layer):
        p = f"h.{i}."

        def dense(name, p=p):  # Conv1D weight (in, out) == the port's kernel layout
            return {"kernel": g(p + name + ".weight"), "bias": g(p + name + ".bias")}

        params[f"h_{i}"] = {
            "ln_1": {"scale": g(p + "ln_1.weight"), "bias": g(p + "ln_1.bias")},
            "ln_2": {"scale": g(p + "ln_2.weight"), "bias": g(p + "ln_2.bias")},
            "attn": {"c_attn": dense("attn.c_attn"), "c_proj": dense("attn.c_proj")},
            "mlp": {"c_fc": dense("mlp.c_fc"), "c_proj": dense("mlp.c_proj")},
        }
    return params_from_jax(params)


def neox_from_torch_state_dict(sd: Mapping[str, Any], config) -> dict[str, torch.Tensor]:
    """HF ``GPTNeoXForCausalLM`` state dict -> the port's NeoX
    ``state_dict``."""
    sd, g = _hf_getter(sd, "gpt_neox.")

    def linear(prefix):  # nn.Linear weight (out, in) -> kernel (in, out)
        return {"kernel": g(prefix + ".weight").T, "bias": g(prefix + ".bias")}

    H, D, C = config.num_heads, config.head_dim, config.hidden_size
    params: dict = {
        "embed_in": g("embed_in.weight"),
        "final_layer_norm": {"scale": g("final_layer_norm.weight"),
                             "bias": g("final_layer_norm.bias")},
        "embed_out": {"kernel": g("embed_out.weight").T},
    }
    for i in range(config.num_layers):
        p = f"layers.{i}."
        # HF packs the qkv rows per head, [h0 q, h0 k, h0 v, h1 q, ...]
        w = g(p + "attention.query_key_value.weight").reshape(H, 3, D, C)
        b = g(p + "attention.query_key_value.bias").reshape(H, 3, D)
        qkv = {"kernel": np.concatenate([w[:, j].reshape(H * D, C) for j in range(3)]).T,
               "bias": np.concatenate([b[:, j].reshape(H * D) for j in range(3)])}
        params[f"layer_{i}"] = {
            "input_layernorm": {"scale": g(p + "input_layernorm.weight"),
                                "bias": g(p + "input_layernorm.bias")},
            "post_attention_layernorm": {"scale": g(p + "post_attention_layernorm.weight"),
                                         "bias": g(p + "post_attention_layernorm.bias")},
            "attention": {"query_key_value": qkv, "dense": linear(p + "attention.dense")},
            "mlp": {"dense_h_to_4h": linear(p + "mlp.dense_h_to_4h"),
                    "dense_4h_to_h": linear(p + "mlp.dense_4h_to_h")},
        }
    return params_from_jax(params)


def llama_from_torch_state_dict(sd: Mapping[str, Any], config) -> dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM`` state dict -> the port's LLaMA ``state_dict``
    (bias-free projections transposed; a checkpoint without
    ``lm_head.weight``, saved with tied embeddings, takes the embedding)."""
    sd, g = _hf_getter(sd, "model.", keep=("lm_head.weight",))

    def linear(prefix):
        return {"kernel": g(prefix + ".weight").T}

    head = linear("lm_head") if "lm_head.weight" in sd else {"kernel": g("embed_tokens.weight").T}
    params: dict = {"embed_tokens": g("embed_tokens.weight"),
                    "norm": {"scale": g("norm.weight")}, "lm_head": head}
    for i in range(config.num_layers):
        p = f"layers.{i}."
        params[f"layer_{i}"] = {
            "input_layernorm": {"scale": g(p + "input_layernorm.weight")},
            "post_attention_layernorm": {"scale": g(p + "post_attention_layernorm.weight")},
            "self_attn": {n: linear(p + "self_attn." + n)
                          for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {n: linear(p + "mlp." + n) for n in ("gate_proj", "up_proj", "down_proj")},
        }
    return params_from_jax(params)


# the GPT-2 names, kept for their callers
gpt2_params_from_jax = params_from_jax
gpt2_params_to_jax = params_to_jax
