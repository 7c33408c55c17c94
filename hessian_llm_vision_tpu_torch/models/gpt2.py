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

Curvature needs f32 masters: the params stay float32 (a float64 copy runs
the model in float64, the reference of the on-card HVP checks).  The
compute dtype is ``config.dtype``: float32, or bfloat16 for ``--bf16`` as
flax runs it (dense operands and outputs in bf16, LayerNorm statistics in
f32 with a bf16 result, the logits cast to f32).  The precision scopes are
the JAX model's (``models/precision.py``): block -> attention / MLP
sublayer -> attention scores, the innermost winning; every matmul runs
through :func:`precision.matmul` / :func:`precision.einsum`.  With
``n_experts > 0`` every block's MLP is the mixture of experts of
``models/moe.py`` (``h_{i}.moe``).  Dropout, an untied head and sequence
sharding of the JAX config are not ported; :class:`GPT2Config` raises on
any non-default value of them.

:class:`Dense`, :class:`LayerNorm` and :func:`init_weights` are shared
with the NeoX and LLaMA modules.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hessian_llm_vision_tpu_torch.models import precision
from hessian_llm_vision_tpu_torch.models.attention import causal_attention
from hessian_llm_vision_tpu_torch.models.losses import at_least_f32

# JAX config fields the port does not implement, with the only value it takes
_UNPORTED_DEFAULTS = {
    "dropout": 0.0,
    "tie_word_embeddings": True,
    "seq_sharding": None,
}


def check_dtype(config) -> None:
    """The compute dtypes the port runs: float32, or bfloat16 for ``--bf16``."""
    if config.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{type(config).__name__}.dtype={config.dtype!r} is not "
                                  "ported yet (float32 or bfloat16)")


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    # query-block size of the attention loop (None = dense (B,H,T,T) path)
    attn_block_q: Optional[int] = None
    # compute dtype (float32 or bfloat16); params always f32
    dtype: torch.dtype = torch.float32
    # matmul precision of the transformer blocks (None = the caller's):
    # one name for every block or a per-block sequence (models/precision.py)
    block_matmul_precision: object = None
    # within every block, innermost wins: block -> attn / mlp -> scores
    attn_matmul_precision: Optional[str] = None
    mlp_matmul_precision: Optional[str] = None
    attn_scores_precision: Optional[str] = None
    # mixture of experts (models/moe.py): 0 = the dense MLP; E > 0 replaces
    # every block's MLP by E softmax-gated experts; moe_top_k > 0 routes
    # each token to its top-k experts through buffers of capacity
    # ceil(k N / E * moe_capacity_factor) (piecewise-constant routing)
    n_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    # not ported: any value other than the default raises
    dropout: float = 0.0
    tie_word_embeddings: bool = True
    seq_sharding: object = None

    def __post_init__(self):
        for name, default in _UNPORTED_DEFAULTS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"GPT2Config.{name}={getattr(self, name)!r} is not ported "
                    f"yet (only {default!r})"
                )
        check_dtype(self)
        precision.per_layer_precision(self.block_matmul_precision, self.n_layer)
        for p in (self.attn_matmul_precision, self.mlp_matmul_precision,
                  self.attn_scores_precision):
            precision.tier_of(p)
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd={self.n_embd} not divisible by n_head={self.n_head}")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def product_scopes(self) -> list:
        """Per block, the precision scopes of its attention dense, attention
        score and MLP products, from the block inwards
        (``models/precision.py``)."""
        out = []
        for p in precision.per_layer_precision(self.block_matmul_precision, self.n_layer):
            attn = (p, self.attn_matmul_precision)
            out += [attn, attn + (self.attn_scores_precision,), (p, self.mlp_matmul_precision)]
        return out

    @staticmethod
    def gpt2_124m(**overrides) -> "GPT2Config":
        return dataclasses.replace(GPT2Config(), **overrides)

    @staticmethod
    def moe_80m(**overrides) -> "GPT2Config":
        """The MoE workload: 384 wide, 6 layers, 6 heads, 8 experts per
        block (79,787,184 params at 512 positions)."""
        base = GPT2Config(n_embd=384, n_layer=6, n_head=6, n_positions=512, n_experts=8)
        return dataclasses.replace(base, **overrides)

    @staticmethod
    def tiny(**overrides) -> "GPT2Config":
        """Test-scale config (the JAX test suite's)."""
        base = GPT2Config(vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=2)
        return dataclasses.replace(base, **overrides)


class Dense(nn.Module):
    """``x @ kernel + bias`` with ``kernel`` (in, out): flax's Dense layout
    (``use_bias=False``: no ``bias``)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x):
        y = precision.matmul(x, _as(self.kernel, x))
        return y if self.bias is None else y + _as(self.bias, x)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """flax's default kernel init, LeCun normal: truncated at 2 sigma and
        rescaled to unit variance."""
        std = math.sqrt(1.0 / self.kernel.shape[0]) / 0.87962566103423978
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every submodule with a ``reset_parameters(generator)`` (:class:`Dense`,
    ``moe.MoEMLP``), in module order.  The draws land on the tensors'
    device, so ``generator`` must live there too."""
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


def _as(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A param in the bf16 compute dtype of ``x``; otherwise unchanged (a
    float64 copy of the params stays float64)."""
    return p.to(x.dtype) if x.dtype == torch.bfloat16 else p


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x):
        # flax: statistics and affine in at least f32, result in x's dtype
        y = F.layer_norm(at_least_f32(x), x.shape[-1:], self.scale, self.bias, self.eps)
        return y.to(x.dtype)


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
        with precision.precision_scope(cfg.attn_scores_precision):
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
        self.config = config
        self.ln_1 = LayerNorm(config.n_embd)
        self.attn = CausalSelfAttention(config)
        self.ln_2 = LayerNorm(config.n_embd)
        if config.n_experts:
            from hessian_llm_vision_tpu_torch.models.moe import MoEMLP

            self.moe = MoEMLP(config)
        else:
            self.mlp = MLPBlock(config)

    def forward(self, x):
        cfg = self.config
        with precision.precision_scope(cfg.attn_matmul_precision):
            x = x + self.attn(self.ln_1(x))
        with precision.precision_scope(cfg.mlp_matmul_precision):
            mlp = self.moe if cfg.n_experts else self.mlp
            return x + mlp(self.ln_2(x))


class GPT2LMHead(nn.Module):
    """GPT-2 with tied LM head; ``forward(input_ids) -> logits (B, T, V)``.

    Parameters are created on the default device (the CPU, or the device
    of an enclosing ``with torch.device(...)``) and initialised from
    ``generator`` (the global torch RNG when None), which lives on that
    device, with the flax model's initialisers: ``wte ~ N(0, 0.02)``,
    ``wpe ~ N(0, 0.01)``, dense kernels LeCun-normal (truncated), expert
    kernels ``N(0, 0.02)``, biases 0, LayerNorm scales 1.
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
        init_weights(self, generator)

    def forward(self, input_ids: torch.Tensor, return_hidden: bool = False):
        cfg = self.config
        T = input_ids.shape[1]
        if cfg.dtype == torch.bfloat16:
            x = self.wte[input_ids].to(cfg.dtype) + self.wpe[:T][None].to(cfg.dtype)
        else:
            x = self.wte[input_ids] + self.wpe[:T][None]
        per_prec = precision.per_layer_precision(cfg.block_matmul_precision, cfg.n_layer)
        for i in range(cfg.n_layer):
            with precision.precision_scope(per_prec[i]):
                x = getattr(self, f"h_{i}")(x)
        x = self.ln_f(x)
        if return_hidden:
            # final pre-logit states; pair with output_kernel() for the
            # chunked-vocab loss (losses.chunked_causal_lm_loss)
            return x
        return at_least_f32(precision.einsum("btc,vc->btv", x, _as(self.wte, x)))

    @staticmethod
    def output_kernel(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(C, V) output projection: ``logits = hidden @ kernel``."""
        return params["wte"].T


def num_params(config: GPT2Config) -> int:
    """Closed-form parameter count (124,439,808 for the 1024-position 124M,
    79,787,184 for ``moe_80m``)."""
    c, v, p, l = config.n_embd, config.vocab_size, config.n_positions, config.n_layer
    attn = (3 * c * c + 3 * c) + (c * c + c)
    if config.n_experts:
        e, f = config.n_experts, 4 * c
        mlp = (c * e + e) + e * ((c * f + f) + (f * c + c))  # gate + experts
    else:
        mlp = (4 * c * c + 4 * c) + (4 * c * c + c)
    per_block = attn + mlp + 4 * c
    return v * c + p * c + l * per_block + 2 * c
