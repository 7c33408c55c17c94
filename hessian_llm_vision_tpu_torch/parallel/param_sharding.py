"""Tensor parallelism over the mesh's model axis (port of
``parallel/param_sharding.py``).

Megatron-style rules, as regex -> spec over the dotted parameter names
(first match wins): column-parallel for fan-out kernels (qkv, the MLP's
up projections), row-parallel for fan-in kernels (the attention and MLP
output projections), vocab-parallel for embeddings and output heads.  The
JAX package hands the specs to XLA's partitioner.  The port keeps each
rank's slice of every sharded leaf (:func:`shard_params_for_tp`) and the
model, built on :func:`model_parallel_config`, carries the collectives of
``models/collectives.py`` in its forward; each layer finds from its
leaves' shapes whether it is split.

Where the port's layout differs from the JAX package's, on purpose:

* the fused qkv kernel (GPT-2's ``c_attn``, NeoX's ``query_key_value``)
  and its bias split per head: each rank holds the q, k and v columns of
  its own heads (a hand-written forward cannot use the contiguous split
  that XLA makes work, where rank 0 of two holds q and half of k);
* the attention's leaves split only when the head count divides the model
  axis (LLaMA's k and v only when its kv heads do), else they stay
  replicated and their gradient is summed over the model axis where they
  are used.

Either way the function computed is the same, and
``models/convert.py::gather_model_axis`` restores the flax layout exactly.
A leaf whose split dimension does not divide the model axis stays
replicated, as in the JAX package (GPT-2's vocabulary of 50257 keeps
``wte`` whole).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

# (path regex, spec) over dotted names; kernels are (in, out)
DEFAULT_TP_RULES: Sequence[Tuple[str, tuple]] = (
    (r".*(c_attn|query_key_value|c_fc|dense_h_to_4h)\.kernel$", (None, "model")),
    (r".*(c_attn|query_key_value|c_fc|dense_h_to_4h)\.bias$", ("model",)),
    (r".*(attn\.c_proj|attention\.dense|mlp\.c_proj|dense_4h_to_h)\.kernel$", ("model", None)),
    (r".*(q_proj|k_proj|v_proj|gate_proj|up_proj)\.kernel$", (None, "model")),
    (r".*(o_proj|down_proj)\.kernel$", ("model", None)),
    (r".*(wte|embed_in|embed_tokens)$", ("model", None)),  # vocab-parallel
    (r".*(embed_out|lm_head)\.kernel$", (None, "model")),
    (r".*", ()),  # everything else replicated (LNs/RMSNorms, biases, wpe)
)

_FUSED_QKV = re.compile(r".*(c_attn|query_key_value)\.(kernel|bias)$")
_ATTN_HEADS = re.compile(r".*(c_attn|query_key_value|attn\.c_proj|attention\.dense|q_proj|o_proj)"
                         r"\.(kernel|bias)$")
_KV_HEADS = re.compile(r".*(k_proj|v_proj)\.kernel$")


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf split over the model axis along ``dim``; ``groups`` equal
    blocks of that dimension (q, k and v of a fused kernel) are each split
    in turn, and a rank holds its part of every block."""

    dim: int
    groups: int = 1


def tp_spec_tree(params: Mapping[str, Any],
                 rules: Sequence[Tuple[str, tuple]] = DEFAULT_TP_RULES) -> dict:
    """``{name: spec}`` by first-matching rule (the JAX ``PartitionSpec``s
    as tuples; axes past a leaf's rank are dropped)."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    out = {}
    for name, leaf in params.items():
        for pat, spec in compiled:
            if pat.match(name):
                out[name] = tuple(spec[:len(leaf.shape)])
                break
    return out


def _heads(config) -> tuple[int, int]:
    q = getattr(config, "n_head", None) or config.num_heads
    return q, getattr(config, "kv_heads", q)


def tp_layout(params: Mapping[str, torch.Tensor], mesh, config,
              rules: Sequence[Tuple[str, tuple]] = DEFAULT_TP_RULES) -> dict:
    """``{name: Split or None}``: how the port splits each (whole) leaf over
    ``mesh``'s model axis, from the rules and the head counts of
    ``config`` (GPT-2, NeoX or LLaMA)."""
    n = mesh.num_model
    q_heads, kv_heads = _heads(config)
    out = {}
    for name, spec in tp_spec_tree(params, rules).items():
        shape = params[name].shape
        dims = [i for i, ax in enumerate(spec) if ax is not None]
        split = None
        if n > 1 and dims and shape[dims[0]] % n == 0:
            split = Split(dims[0], 3 if _FUSED_QKV.match(name) else 1)
            if shape[dims[0]] % (n * split.groups):
                split = None
            elif _ATTN_HEADS.match(name) and q_heads % n:
                split = None
            elif _KV_HEADS.match(name) and (kv_heads % n or q_heads % n):
                split = None
        out[name] = split
    return out


def shard_leaf(t: torch.Tensor, split: Optional[Split], index: int, n: int) -> torch.Tensor:
    """Rank ``index``'s part of a whole leaf (a contiguous copy; the leaf
    itself when it is not split)."""
    if split is None:
        return t
    blocks = t.chunk(split.groups, dim=split.dim)
    return torch.cat([b.chunk(n, dim=split.dim)[index] for b in blocks],
                     dim=split.dim).contiguous()


def unshard_leaf(parts: Sequence[torch.Tensor], split: Optional[Split]) -> torch.Tensor:
    """The whole leaf from every rank's part, in rank order."""
    if split is None:
        return parts[0]
    per_rank = [p.chunk(split.groups, dim=split.dim) for p in parts]
    return torch.cat([per_rank[r][g] for g in range(split.groups) for r in range(len(parts))],
                     dim=split.dim)


def shard_params(params: Mapping[str, torch.Tensor], layout: Mapping[str, Optional[Split]],
                 mesh) -> dict:
    """This rank's part of every leaf of ``params`` under ``layout``."""
    return {k: shard_leaf(t, layout[k], mesh.model_index, mesh.num_model)
            for k, t in params.items()}


def shard_params_for_tp(params: Mapping[str, torch.Tensor], mesh,
                        rules: Sequence[Tuple[str, tuple]] = DEFAULT_TP_RULES, *,
                        config) -> dict:
    """This rank's slice of each leaf of the whole ``params`` (any dict with
    the model's names: weights, a tangent, a gradient) under
    :func:`tp_layout`.  Every rank passes the same whole dict."""
    return shard_params(params, tp_layout(params, mesh, config, rules), mesh)


def model_parallel_config(cfg: Any, mesh) -> Any:
    """``cfg`` (GPT-2, NeoX or LLaMA) whose layers split over ``mesh``'s
    model axis wherever their leaves are this rank's slices (tensor
    parallelism, and expert parallelism for the MoE GPT-2); beside a
    ``seq_sharding`` of the same mesh, tensor and sequence parallelism on
    one axis."""
    return dataclasses.replace(cfg, model_parallel=mesh)
