"""LLaMA-family decoder with LM head (port of ``models/llama.py``).

As the JAX package builds it: RMSNorm (no bias, no mean subtraction,
computed in at least f32 and cast back), rotary embeddings over the full
head dim (rotate-half layout), grouped-query attention that repeats each
kv head over its group of query heads (``num_kv_heads < num_heads``), a
SwiGLU MLP ``down(silu(gate x) * up x)``, bias-free linears, the
sequential pre-norm residual and an untied ``lm_head``.

Parameter names and layouts are flax's (``layer_{i}.self_attn.q_proj.
kernel`` (in, out), ``embed_tokens`` (vocab, C), RMSNorm ``scale``), so
``models/convert.py`` carries the JAX params by name.  The compute dtype
and the per-block precision scopes are GPT-2's, and so is the model axis:
under ``model_parallel`` q/k/v and gate/up split by columns, o/down by
rows, ``embed_tokens`` / ``lm_head`` the vocabulary, and k/v stay whole
(their gradient summed over the axis where they are used) when the kv
heads do not divide the axis; under ``seq_sharding`` a rank's tokens take
their rotary angles at their own positions (under both, split heads see
every position at its own).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hessian_llm_vision_tpu_torch.models import precision
from hessian_llm_vision_tpu_torch.models.attention import causal_attention
from hessian_llm_vision_tpu_torch.models.collectives import copy_to_model
from hessian_llm_vision_tpu_torch.models.gpt2 import (
    Dense,
    _as,
    check_dtype,
    check_model_axis,
    dense_rows,
    embed,
    gather_kv,
    init_weights,
    split_input,
)
from hessian_llm_vision_tpu_torch.models.losses import at_least_f32
from hessian_llm_vision_tpu_torch.models.pythia import rotary_cos_sin, rotate_half


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_position_embeddings: int = 2048
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None -> multi-head (= num_heads)
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    # compute dtype (float32 or bfloat16); params always f32
    dtype: torch.dtype = torch.float32
    # query-block size of the attention loop (None = dense)
    attn_block_q: Optional[int] = None
    # rematerialise each query block of that loop (utils/remat.py); unroll:
    # the JAX scan's, the same values here (models/attention.py)
    attn_remat: bool = True
    attn_unroll: bool = False
    # matmul precision of the transformer blocks (models/precision.py)
    block_matmul_precision: object = None
    # the model axis, as GPT2Config's (models/gpt2.py)
    model_parallel: object = None
    seq_sharding: object = None

    def __post_init__(self):
        check_dtype(self)
        check_model_axis(self)
        precision.per_layer_precision(self.block_matmul_precision, self.num_layers)
        if self.hidden_size % self.num_heads or self.num_heads % self.kv_heads:
            raise ValueError(f"hidden_size={self.hidden_size}, num_heads={self.num_heads} and "
                             f"num_kv_heads={self.num_kv_heads} do not divide")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def product_scopes(self) -> list:
        """One kind of product per block, under the block's scope."""
        return [(p,) for p in precision.per_layer_precision(self.block_matmul_precision,
                                                             self.num_layers)]

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        base = LlamaConfig(vocab_size=256, max_position_embeddings=64, hidden_size=32,
                           intermediate_size=96, num_layers=2, num_heads=4, num_kv_heads=2)
        return dataclasses.replace(base, **overrides)


#: the JAX package's named scales: tiny and micro for tests and CPU runs,
#: 134m the GPT-2-124M-class single-card spectrum workload (P = 134,105,856),
#: 7b the reference notebook's checkpoints
LLAMA_CONFIGS = {
    "llama-tiny": LlamaConfig.tiny(),
    "llama-micro": LlamaConfig(vocab_size=32000, hidden_size=256, intermediate_size=704,
                               num_layers=4, num_heads=8, num_kv_heads=8,
                               max_position_embeddings=512),
    "llama-134m": LlamaConfig(vocab_size=32000, hidden_size=768, intermediate_size=2048,
                              num_layers=12, num_heads=12, num_kv_heads=12,
                              max_position_embeddings=512),
    "llama-7b": LlamaConfig(),
}


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.eps = eps

    def forward(self, x):
        x32 = at_least_f32(x)
        normed = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + self.eps)
        return (normed * self.scale).to(x.dtype)


def _rope_full(q, k, theta: float, offset: int = 0):
    """Rotary embeddings over the full head dim of q (B, T, Hq, D) and k
    (B, T, Hk, D) at positions ``[offset, offset + T)``."""
    cos, sin = rotary_cos_sin(q.shape[1], q.shape[-1], theta, q.device, offset)
    return rotate_half(q, cos, sin), rotate_half(k, cos, sin)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        C, D = config.hidden_size, config.head_dim
        self.q_proj = Dense(C, config.num_heads * D, use_bias=False)
        self.k_proj = Dense(C, config.kv_heads * D, use_bias=False)
        self.v_proj = Dense(C, config.kv_heads * D, use_bias=False)
        self.o_proj = Dense(config.num_heads * D, C, use_bias=False)

    def forward(self, x):
        cfg = self.config
        D, mesh, sp = cfg.head_dim, cfg.model_parallel, cfg.seq_sharding
        Hq = self.q_proj.kernel.shape[1] // D  # this rank's query heads
        Hk = self.k_proj.kernel.shape[1] // D  # and kv heads (all of them when not split)
        split = Hq < cfg.num_heads
        x = split_input(x, mesh, split, sp)  # every position under TP x SP
        B, T, C = x.shape
        q = self.q_proj(x).reshape(B, T, Hq, D)
        if split and Hk == cfg.kv_heads and sp is None:
            # whole k and v under split queries: their gradient summed over the axis
            # (under seq_sharding the loss closure sums every whole leaf's)
            k = precision.matmul(x, _as(copy_to_model(self.k_proj.kernel, mesh), x))
            v = precision.matmul(x, _as(copy_to_model(self.v_proj.kernel, mesh), x))
        else:
            k, v = self.k_proj(x), self.v_proj(x)
        k, v = k.reshape(B, T, Hk, D), v.reshape(B, T, Hk, D)
        sliced = sp is not None and not split
        offset = sp.mesh.model_index * T if sliced else 0
        q, k = _rope_full(q, k, cfg.rope_theta, offset)
        if sliced:
            k, v = gather_kv(k, v, sp)
        group = cfg.num_heads // cfg.kv_heads
        if group > 1:  # grouped-query: each kv head serves its group of query heads
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        if k.shape[2] != Hq:  # this rank's query heads of the whole kv heads
            first = mesh.model_index * Hq
            k, v = k[:, :, first:first + Hq], v[:, :, first:first + Hq]
        y = causal_attention(q, k, v, block_q=cfg.attn_block_q, remat=cfg.attn_remat,
                             unroll=cfg.attn_unroll, q_offset=offset)
        return dense_rows(self.o_proj, y.reshape(B, T, Hq * D), mesh, C, sp)


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate x) * up x)``."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        C, I = config.hidden_size, config.intermediate_size
        self.gate_proj = Dense(C, I, use_bias=False)
        self.up_proj = Dense(C, I, use_bias=False)
        self.down_proj = Dense(I, C, use_bias=False)

    def forward(self, x):
        cfg = self.config
        mesh, sp, width = cfg.model_parallel, cfg.seq_sharding, cfg.intermediate_size
        x = split_input(x, mesh, self.gate_proj.kernel.shape[1] < width, sp)
        return dense_rows(self.down_proj, F.silu(self.gate_proj(x)) * self.up_proj(x), mesh, width,
                          sp)


class LlamaBlock(nn.Module):
    """Sequential pre-norm residual: ``x += attn(rms1 x); x += mlp(rms2 x)``."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_eps)
        self.self_attn = LlamaAttention(config)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_eps)
        self.mlp = LlamaMLP(config)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaLMHead(nn.Module):
    """LLaMA with an untied LM head; ``forward(input_ids) -> logits (B, T, V)``.

    Parameters are created on the default device and drawn from
    ``generator`` (on that device) with the flax initialisers:
    ``embed_tokens ~ N(0, 0.02)``, kernels LeCun-normal (truncated),
    RMSNorm scales 1.
    """

    def __init__(self, config: LlamaConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Parameter(torch.empty(config.vocab_size, config.hidden_size))
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", LlamaBlock(config))
        self.norm = RMSNorm(config.hidden_size, config.rms_eps)
        self.lm_head = Dense(config.hidden_size, config.vocab_size, use_bias=False)
        with torch.no_grad():
            nn.init.normal_(self.embed_tokens, 0.0, 0.02, generator=generator)
        init_weights(self, generator)

    def forward(self, input_ids: torch.Tensor, return_hidden: bool = False):
        """``input_ids`` (B, T) -> logits (B, T, V), or this rank's slices of
        them under the model axis (``models/gpt2.py``)."""
        cfg = self.config
        sp = cfg.seq_sharding
        x = embed(self.embed_tokens, input_ids, cfg.vocab_size, cfg.model_parallel, sp)
        if cfg.dtype == torch.bfloat16:
            x = x.to(cfg.dtype)
        per_prec = precision.per_layer_precision(cfg.block_matmul_precision, cfg.num_layers)
        for i in range(cfg.num_layers):
            with precision.precision_scope(per_prec[i]):
                x = getattr(self, f"layer_{i}")(x)
        x = self.norm(x)
        if return_hidden:
            return x
        x = split_input(x, cfg.model_parallel, self.lm_head.kernel.shape[1] < cfg.vocab_size, sp)
        return at_least_f32(self.lm_head(x))

    @staticmethod
    def output_kernel(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(C, V) output projection: ``logits = hidden @ kernel``."""
        return params["lm_head.kernel"]
