"""GPT-2 decoder with LM head (port of ``models/gpt2.py``).

Parameter names and layouts are the flax model's, so weights carry across
by name alone (``models/convert.py``):

* blocks are submodules ``h_0 ... h_{L-1}`` holding ``attn.c_attn``,
  ``attn.c_proj``, ``ln_1``, ``ln_2``, ``mlp.c_fc``, ``mlp.c_proj``;
* a dense layer holds ``kernel`` of shape (in, out) and ``bias`` and
  computes ``x @ kernel + bias`` (flax's layout, and HF's Conv1D layout);
* a LayerNorm holds ``scale`` and ``bias`` (eps 1e-5);
* ``wte`` (vocab, C) and ``wpe`` (positions, C) are top-level parameters,
  and ``wte`` is tied to the output projection.

Curvature needs f32 masters and f32 compute: the model runs in float32
only.  Dropout, the MoE MLP, the precision scopes and sequence sharding of
the JAX config are not ported; :class:`GPT2Config` raises on any
non-default value of them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hessian_llm_vision_tpu_torch.models.attention import causal_attention

# JAX config fields the port does not implement, with the only value it takes
_UNPORTED_DEFAULTS = {
    "dropout": 0.0,
    "dtype": torch.float32,
    "tie_word_embeddings": True,
    "block_matmul_precision": None,
    "attn_matmul_precision": None,
    "mlp_matmul_precision": None,
    "attn_scores_precision": None,
    "n_experts": 0,
    "moe_top_k": 0,
    "seq_sharding": None,
}


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    # query-block size of the attention loop (None = dense (B,H,T,T) path)
    attn_block_q: Optional[int] = None
    # not ported: any value other than the default raises
    dropout: float = 0.0
    dtype: torch.dtype = torch.float32
    tie_word_embeddings: bool = True
    block_matmul_precision: object = None
    attn_matmul_precision: Optional[str] = None
    mlp_matmul_precision: Optional[str] = None
    attn_scores_precision: Optional[str] = None
    n_experts: int = 0
    moe_top_k: int = 0
    seq_sharding: object = None

    def __post_init__(self):
        for name, default in _UNPORTED_DEFAULTS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"GPT2Config.{name}={getattr(self, name)!r} is not ported "
                    f"yet (only {default!r})"
                )
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd={self.n_embd} not divisible by n_head={self.n_head}")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @staticmethod
    def gpt2_124m(**overrides) -> "GPT2Config":
        return dataclasses.replace(GPT2Config(), **overrides)

    @staticmethod
    def tiny(**overrides) -> "GPT2Config":
        """Test-scale config (the JAX test suite's)."""
        base = GPT2Config(vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=2)
        return dataclasses.replace(base, **overrides)


class Dense(nn.Module):
    """``x @ kernel + bias`` with ``kernel`` (in, out): flax's Dense layout."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return x @ self.kernel + self.bias


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, self.eps)


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.c_attn = Dense(config.n_embd, 3 * config.n_embd)
        self.c_proj = Dense(config.n_embd, config.n_embd)

    def forward(self, x):
        cfg = self.config
        B, T, C = x.shape
        q, k, v = self.c_attn(x).split(C, dim=-1)
        heads = (B, T, cfg.n_head, cfg.head_dim)
        y = causal_attention(
            q.reshape(heads), k.reshape(heads), v.reshape(heads),
            block_q=cfg.attn_block_q,
        )
        return self.c_proj(y.reshape(B, T, C))


class MLPBlock(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.c_fc = Dense(config.n_embd, 4 * config.n_embd)
        self.c_proj = Dense(4 * config.n_embd, config.n_embd)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.ln_1 = LayerNorm(config.n_embd)
        self.attn = CausalSelfAttention(config)
        self.ln_2 = LayerNorm(config.n_embd)
        self.mlp = MLPBlock(config)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPT2LMHead(nn.Module):
    """GPT-2 with tied LM head; ``forward(input_ids) -> logits (B, T, V)``.

    Parameters are created on the CPU and initialised from ``generator``
    (the global torch RNG when None) with the flax model's initialisers:
    ``wte ~ N(0, 0.02)``, ``wpe ~ N(0, 0.01)``, dense kernels LeCun-normal
    (truncated), biases 0, LayerNorm scales 1.  Move the module with
    ``.to(device)`` afterwards.
    """

    def __init__(self, config: GPT2Config, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.wte = nn.Parameter(torch.empty(config.vocab_size, config.n_embd))
        self.wpe = nn.Parameter(torch.empty(config.n_positions, config.n_embd))
        for i in range(config.n_layer):
            self.add_module(f"h_{i}", Block(config))
        self.ln_f = LayerNorm(config.n_embd)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator):
        nn.init.normal_(self.wte, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.wpe, 0.0, 0.01, generator=generator)
        for m in self.modules():
            if isinstance(m, Dense):
                # flax lecun_normal: truncated at 2 sigma, rescaled to unit variance
                std = math.sqrt(1.0 / m.kernel.shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(
                    m.kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
                )

    def forward(self, input_ids: torch.Tensor, return_hidden: bool = False):
        T = input_ids.shape[1]
        x = self.wte[input_ids] + self.wpe[:T][None]
        for i in range(self.config.n_layer):
            x = getattr(self, f"h_{i}")(x)
        x = self.ln_f(x)
        if return_hidden:
            # final pre-logit states; pair with output_kernel() for the
            # chunked-vocab loss (losses.chunked_causal_lm_loss)
            return x
        return torch.einsum("btc,vc->btv", x, self.wte)

    @staticmethod
    def output_kernel(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(C, V) output projection: ``logits = hidden @ kernel``."""
        return params["wte"].T


def num_params(config: GPT2Config) -> int:
    """Closed-form parameter count (124,439,808 for the 1024-position 124M)."""
    c, v, p, l = config.n_embd, config.vocab_size, config.n_positions, config.n_layer
    attn = (3 * c * c + 3 * c) + (c * c + c)
    mlp = (4 * c * c + 4 * c) + (4 * c * c + c)
    per_block = attn + mlp + 4 * c
    return v * c + p * c + l * per_block + 2 * c
