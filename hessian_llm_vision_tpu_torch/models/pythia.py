"""Pythia (GPT-NeoX) decoder with LM head (port of ``models/pythia.py``).

NeoX specifics, as the JAX package implements them: rotary position
embeddings on the first ``rotary_pct`` of each head's dims (rotate-half
layout, cos and sin computed in f32), the parallel residual ``x +
attn(ln1 x) + mlp(ln2 x)``, a tanh-approximate GELU in the MLP (HF's
Pythia uses the exact GELU; the JAX package is the reference here), and an
untied output head ``embed_out`` without bias.

Parameter names and layouts are flax's (``layer_{i}.attention.
query_key_value.kernel`` of shape (in, 3C) with q, k and v concatenated,
``embed_in`` (vocab, C), LayerNorm ``scale`` and ``bias``), so
``models/convert.py`` carries the JAX params by name and the flat order is
the JAX ``Flattener``'s.  The compute dtype and the per-block precision
scopes are GPT-2's (``models/gpt2.py``, ``models/precision.py``), and so
is the model axis: under ``model_parallel`` ``query_key_value`` splits per
head and ``attention.dense`` by rows, ``dense_h_to_4h`` / ``dense_4h_to_h``
split the MLP's width, and ``embed_in`` / ``embed_out`` the vocabulary;
under ``seq_sharding`` a rank's tokens take their rotary angles at their
own positions (under both, split heads see every position at its own).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hessian_llm_vision_tpu_torch.models import precision
from hessian_llm_vision_tpu_torch.models.attention import causal_attention
from hessian_llm_vision_tpu_torch.models.gpt2 import (
    Dense,
    LayerNorm,
    check_dtype,
    check_model_axis,
    dense_rows,
    embed,
    gather_kv,
    init_weights,
    split_input,
)
from hessian_llm_vision_tpu_torch.models.losses import at_least_f32


@dataclasses.dataclass(frozen=True)
class NeoXConfig:
    vocab_size: int = 50304
    max_position_embeddings: int = 2048
    hidden_size: int = 512
    num_layers: int = 6
    num_heads: int = 8
    rotary_pct: float = 0.25
    rotary_emb_base: int = 10000
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
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size={self.hidden_size} not divisible by "
                             f"num_heads={self.num_heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def product_scopes(self) -> list:
        """One kind of product per block, under the block's scope."""
        return [(p,) for p in precision.per_layer_precision(self.block_matmul_precision,
                                                             self.num_layers)]

    @staticmethod
    def tiny(**overrides) -> "NeoXConfig":
        base = NeoXConfig(vocab_size=256, max_position_embeddings=64, hidden_size=32,
                          num_layers=2, num_heads=2)
        return dataclasses.replace(base, **overrides)


#: the Pythia scales of the JAX package (70m, 160m, 1.4b from the reference
#: scripts, and 410m between them)
PYTHIA_CONFIGS = {
    "pythia-70m": NeoXConfig(hidden_size=512, num_layers=6, num_heads=8),
    "pythia-160m": NeoXConfig(hidden_size=768, num_layers=12, num_heads=12),
    "pythia-410m": NeoXConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "pythia-1.4b": NeoXConfig(hidden_size=2048, num_layers=24, num_heads=16),
}


def rotate_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x cos + rotate_half(x) sin`` over x's last dim (HF's rotate-half
    layout: the second half negated, then the first)."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos.to(x.dtype) + torch.cat([-x2, x1], dim=-1) * sin.to(x.dtype)


def rotary_cos_sin(T: int, dim: int, base: float, device, offset: int = 0) -> tuple:
    """(1, T, 1, dim) cos and sin of the rotary angles of positions
    ``[offset, offset + T)``, computed in f32."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    pos = torch.arange(offset, offset + T, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)[None, :, None, :]
    return emb.cos(), emb.sin()


def _rotary(q, k, base: int, rot_dim: int, offset: int = 0):
    """Rotary embeddings on the first ``rot_dim`` dims of q and k (B, T, H, D)
    at positions ``[offset, offset + T)``."""
    cos, sin = rotary_cos_sin(q.shape[1], rot_dim, base, q.device, offset)

    def rot(x):
        return torch.cat([rotate_half(x[..., :rot_dim], cos, sin), x[..., rot_dim:]], dim=-1)

    return rot(q), rot(k)


class NeoXAttention(nn.Module):
    def __init__(self, config: NeoXConfig):
        super().__init__()
        self.config = config
        C = config.hidden_size
        self.query_key_value = Dense(C, 3 * C)
        self.dense = Dense(C, C)

    def forward(self, x):
        cfg = self.config
        sp, D = cfg.seq_sharding, cfg.head_dim
        H = self.query_key_value.kernel.shape[1] // (3 * D)  # this rank's heads
        split = H < cfg.num_heads
        x = split_input(x, cfg.model_parallel, split, sp)  # every position under TP x SP
        B, T, C = x.shape
        q, k, v = (t.reshape(B, T, H, D) for t in self.query_key_value(x).split(H * D, dim=-1))
        sliced = sp is not None and not split
        offset = sp.mesh.model_index * T if sliced else 0
        rot_dim = int(D * cfg.rotary_pct)
        if rot_dim > 0:
            q, k = _rotary(q, k, cfg.rotary_emb_base, rot_dim, offset)
        if sliced:
            k, v = gather_kv(k, v, sp)
        y = causal_attention(q, k, v, block_q=cfg.attn_block_q, remat=cfg.attn_remat,
                             unroll=cfg.attn_unroll, q_offset=offset)
        return dense_rows(self.dense, y.reshape(B, T, H * D), cfg.model_parallel, C, sp)


class NeoXMLP(nn.Module):
    def __init__(self, config: NeoXConfig):
        super().__init__()
        self.config = config
        self.dense_h_to_4h = Dense(config.hidden_size, 4 * config.hidden_size)
        self.dense_4h_to_h = Dense(4 * config.hidden_size, config.hidden_size)

    def forward(self, x):
        cfg = self.config
        mesh, sp, width = cfg.model_parallel, cfg.seq_sharding, 4 * cfg.hidden_size
        x = split_input(x, mesh, self.dense_h_to_4h.kernel.shape[1] < width, sp)
        h = F.gelu(self.dense_h_to_4h(x), approximate="tanh")
        return dense_rows(self.dense_4h_to_h, h, mesh, width, sp)


class NeoXBlock(nn.Module):
    """Parallel residual: ``x + attn(ln1 x) + mlp(ln2 x)``."""

    def __init__(self, config: NeoXConfig):
        super().__init__()
        self.input_layernorm = LayerNorm(config.hidden_size)
        self.attention = NeoXAttention(config)
        self.post_attention_layernorm = LayerNorm(config.hidden_size)
        self.mlp = NeoXMLP(config)

    def forward(self, x):
        return (x + self.attention(self.input_layernorm(x))
                + self.mlp(self.post_attention_layernorm(x)))


class NeoXLMHead(nn.Module):
    """NeoX with an untied LM head; ``forward(input_ids) -> logits (B, T, V)``.

    Parameters are created on the default device and drawn from
    ``generator`` (on that device) with the flax initialisers: ``embed_in ~
    N(0, 0.02)``, dense kernels LeCun-normal (truncated), biases 0,
    LayerNorm scales 1.
    """

    def __init__(self, config: NeoXConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.embed_in = nn.Parameter(torch.empty(config.vocab_size, config.hidden_size))
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", NeoXBlock(config))
        self.final_layer_norm = LayerNorm(config.hidden_size)
        self.embed_out = Dense(config.hidden_size, config.vocab_size, use_bias=False)
        with torch.no_grad():
            nn.init.normal_(self.embed_in, 0.0, 0.02, generator=generator)
        init_weights(self, generator)

    def forward(self, input_ids: torch.Tensor, return_hidden: bool = False):
        """``input_ids`` (B, T) -> logits (B, T, V), or this rank's slices of
        them under the model axis (``models/gpt2.py``)."""
        cfg = self.config
        sp = cfg.seq_sharding
        x = embed(self.embed_in, input_ids, cfg.vocab_size, cfg.model_parallel, sp)
        if cfg.dtype == torch.bfloat16:
            x = x.to(cfg.dtype)
        per_prec = precision.per_layer_precision(cfg.block_matmul_precision, cfg.num_layers)
        for i in range(cfg.num_layers):
            with precision.precision_scope(per_prec[i]):
                x = getattr(self, f"layer_{i}")(x)
        x = self.final_layer_norm(x)
        if return_hidden:
            return x
        x = split_input(x, cfg.model_parallel, self.embed_out.kernel.shape[1] < cfg.vocab_size, sp)
        return at_least_f32(self.embed_out(x))

    @staticmethod
    def output_kernel(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(C, V) output projection: ``logits = hidden @ kernel``."""
        return params["embed_out.kernel"]
