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
``models/moe.py`` (``h_{i}.moe``).  ``tie_word_embeddings=False`` gives
the untied head ``lm_head.kernel`` (C, V) without bias, computed in at
least f32 as flax's Dense without a dtype does.  ``dropout`` > 0 drops
after attention's ``c_proj`` and after the MLP's ``c_proj``, as flax does,
when the model runs with ``deterministic=False`` (the MoE MLP has none, as
in JAX); the masks come from a torch ``Generator`` (``generator``, else
torch's global one), so they do not reproduce flax's, as the probe vectors
do not.  Every loss closure runs the model deterministic.

The model axis of a mesh (``parallel/``) splits the model in one of two
ways.  ``model_parallel`` (``parallel.param_sharding.model_parallel_config``):
the layers whose leaves this rank holds in part split their work -- the
attention's heads (``c_attn`` per head, column-parallel, ``attn.c_proj``
row-parallel), the MLP's width (``c_fc`` and ``mlp.c_proj``), the
vocabulary (``wte`` as embedding and as tied head) and the experts (EP,
``models/moe.py``) -- with the collectives of ``models/collectives.py``;
each layer reads from its leaves' shapes whether it is split.
``seq_sharding`` (``parallel.seq_parallel.seq_parallel_config``): rank m of
the model axis runs tokens ``[m·T/n, (m+1)·T/n)`` of the residual stream,
at their positions, and attention gathers keys and values along T; the
loss closure sums the gradient of every leaf a rank holds whole over the
axis.  Both on one axis (Megatron's sequence parallelism): the residual
stream, the norms and the residual adds run on the rank's T-slice; the
slice is gathered along T before each column-parallel layer (its
gradient reduce-scattered back), and a row-parallel layer's partial sums
are summed and sliced back to T (:func:`dense_rows`); attention then sees
every position of its own heads.  A vocab-parallel embedding looks up
every position and keeps its slice, a vocab-parallel head gathers the
positions.  Each is the same function as the whole model.

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
from hessian_llm_vision_tpu_torch.models.collectives import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    reduce_scatter_to_model,
    vocab_parallel_embedding,
)
from hessian_llm_vision_tpu_torch.models.losses import at_least_f32


def check_model_axis(config) -> None:
    """``model_parallel`` and ``seq_sharding`` together must split one
    mesh's model axis."""
    sp, mp = config.seq_sharding, config.model_parallel
    if sp is not None and mp is not None and sp.mesh is not mp:
        raise ValueError(f"{type(config).__name__}: model_parallel and seq_sharding must "
                         "split the model axis of one mesh")


def seq_slice(input_ids: torch.Tensor, seq_sharding) -> tuple[torch.Tensor, int]:
    """This rank's tokens of the whole ``input_ids`` (B, T) under
    ``seq_sharding``, and the position of the first."""
    mesh = seq_sharding.mesh
    T, n = input_ids.shape[1], mesh.num_model
    if T % n:
        raise ValueError(f"seq_len={T} does not split over {n} ranks of the model axis")
    lo = mesh.model_index * (T // n)
    return input_ids[:, lo:lo + T // n], lo


def gather_kv(k: torch.Tensor, v: torch.Tensor, seq_sharding) -> tuple:
    """Every rank's keys and values along T (dim 1) under ``seq_sharding``."""
    mesh = seq_sharding.mesh
    return gather_from_model(k, mesh, 1), gather_from_model(v, mesh, 1)


def dense_rows(layer: "Dense", x: torch.Tensor, mesh, whole: int,
               seq_sharding=None) -> torch.Tensor:
    """``x @ kernel + bias`` of a fan-in layer; when ``kernel`` holds this
    rank's rows of ``whole`` (row-parallel), the product is summed over
    the model axis before the bias, and under ``seq_sharding`` then cut
    back to this rank's T-slice (dim 1)."""
    if layer.kernel.shape[0] == whole:
        return layer(x)
    y = precision.matmul(x, _as(layer.kernel, x))
    y = (reduce_from_model(y, mesh) if seq_sharding is None
         else reduce_scatter_to_model(y, mesh, 1))
    return y if layer.bias is None else y + _as(layer.bias, x)


def split_input(x: torch.Tensor, mesh, split: bool, seq_sharding=None) -> torch.Tensor:
    """The input of a column-parallel layer (``split``): its gradient summed
    over the model axis; under ``seq_sharding`` every rank's T-slice
    gathered along T (dim 1), the gradient reduce-scattered back."""
    if not split:
        return x
    return copy_to_model(x, mesh) if seq_sharding is None else gather_from_model(x, mesh, 1)


def embed(table: torch.Tensor, ids: torch.Tensor, vocab_size: int, mesh,
          seq_sharding=None) -> torch.Tensor:
    """Rows of ``table`` for the whole ``ids`` (B, T), or under
    ``seq_sharding`` for this rank's T-slice of them; vocab-parallel when
    ``table`` holds this rank's rows of ``vocab_size`` (every position
    looked up, then summed over the model axis and, under
    ``seq_sharding``, cut to the T-slice)."""
    mine = ids if seq_sharding is None else seq_slice(ids, seq_sharding)[0]
    if table.shape[0] == vocab_size:
        return table[mine]
    return vocab_parallel_embedding(table, ids, mesh, scatter_dim=None if seq_sharding is None
                                    else 1)


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
    # rematerialise each query block of that loop (utils/remat.py); unroll:
    # the JAX scan's, the same values here (models/attention.py)
    attn_remat: bool = True
    attn_unroll: bool = False
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
    # the model axis (parallel/): a Mesh whose model axis splits the layers
    # this rank holds in part (tensor and expert parallelism), and/or a
    # seq_parallel.seq_sharding whose model axis splits the tokens
    model_parallel: object = None
    seq_sharding: object = None
    # dropout rate after attention's and the MLP's c_proj, applied only
    # when the model runs with deterministic=False
    dropout: float = 0.0
    # False: an untied head lm_head.kernel (C, V), no bias
    tie_word_embeddings: bool = True

    def __post_init__(self):
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"GPT2Config.dropout={self.dropout!r} is not in [0, 1)")
        check_dtype(self)
        check_model_axis(self)
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


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout``: each entry kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, else zeroed; ``x`` itself when
    ``deterministic`` or ``rate`` is 0.  The mask is drawn from
    ``generator`` (on ``x``'s device), else from torch's global RNG."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


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

    def forward(self, x, deterministic: bool = True, generator=None):
        cfg = self.config
        sp, D = cfg.seq_sharding, cfg.head_dim
        H = self.c_attn.kernel.shape[1] // (3 * D)  # this rank's heads
        split = H < cfg.n_head
        x = split_input(x, cfg.model_parallel, split, sp)  # every position under TP x SP
        B, T, C = x.shape
        q, k, v = (t.reshape(B, T, H, D) for t in self.c_attn(x).split(H * D, dim=-1))
        offset = 0
        if sp is not None and not split:
            k, v = gather_kv(k, v, sp)
            offset = sp.mesh.model_index * T
        with precision.precision_scope(cfg.attn_scores_precision):
            y = causal_attention(q, k, v, block_q=cfg.attn_block_q, remat=cfg.attn_remat,
                                 unroll=cfg.attn_unroll, q_offset=offset)
        y = dense_rows(self.c_proj, y.reshape(B, T, H * D), cfg.model_parallel, C, sp)
        return dropout(y, cfg.dropout, deterministic, generator)


class MLPBlock(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.c_fc = Dense(config.n_embd, 4 * config.n_embd)
        self.c_proj = Dense(4 * config.n_embd, config.n_embd)

    def forward(self, x, deterministic: bool = True, generator=None):
        cfg = self.config
        mesh, sp, width = cfg.model_parallel, cfg.seq_sharding, 4 * cfg.n_embd
        x = split_input(x, mesh, self.c_fc.kernel.shape[1] < width, sp)
        h = dense_rows(self.c_proj, F.gelu(self.c_fc(x), approximate="tanh"), mesh, width, sp)
        return dropout(h, cfg.dropout, deterministic, generator)


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

    def forward(self, x, deterministic: bool = True, generator=None):
        cfg = self.config
        with precision.precision_scope(cfg.attn_matmul_precision):
            x = x + self.attn(self.ln_1(x), deterministic, generator)
        with precision.precision_scope(cfg.mlp_matmul_precision):
            if cfg.n_experts:
                return x + self.moe(self.ln_2(x))
            return x + self.mlp(self.ln_2(x), deterministic, generator)


class GPT2LMHead(nn.Module):
    """GPT-2 with LM head (tied to ``wte``, or ``lm_head``);
    ``forward(input_ids) -> logits (B, T, V)``.

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
        if not config.tie_word_embeddings:
            self.lm_head = Dense(config.n_embd, config.vocab_size, use_bias=False)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator):
        nn.init.normal_(self.wte, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.wpe, 0.0, 0.01, generator=generator)
        init_weights(self, generator)

    def forward(self, input_ids: torch.Tensor, return_hidden: bool = False, *,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """``input_ids`` (B, T) -> logits (B, T, V); under ``seq_sharding``
        this rank's T-slice of them, and under a vocab-parallel head its
        slice of V (of every position under both).  ``deterministic=False``
        applies ``config.dropout`` with masks from ``generator``
        (:func:`dropout`; under the model axis each rank draws its own)."""
        cfg = self.config
        sp, mesh = cfg.seq_sharding, cfg.model_parallel
        lo = 0 if sp is None else seq_slice(input_ids, sp)[1]
        tok = embed(self.wte, input_ids, cfg.vocab_size, mesh, sp)
        T = tok.shape[1]
        pos = self.wpe[lo:lo + T][None]
        if cfg.dtype == torch.bfloat16:
            x = tok.to(cfg.dtype) + pos.to(cfg.dtype)
        else:
            x = tok + pos
        per_prec = precision.per_layer_precision(cfg.block_matmul_precision, cfg.n_layer)
        for i in range(cfg.n_layer):
            with precision.precision_scope(per_prec[i]):
                x = getattr(self, f"h_{i}")(x, deterministic, generator)
        x = self.ln_f(x)
        if return_hidden:
            # final pre-logit states; pair with output_kernel() for the
            # chunked-vocab loss (losses.chunked_causal_lm_loss)
            return x
        if not cfg.tie_word_embeddings:
            kernel = self.lm_head.kernel
            x = split_input(x, mesh, kernel.shape[1] < cfg.vocab_size, sp)
            return precision.matmul(at_least_f32(x), kernel)
        x = split_input(x, mesh, self.wte.shape[0] < cfg.vocab_size, sp)
        return at_least_f32(precision.einsum("btc,vc->btv", x, _as(self.wte, x)))

    @staticmethod
    def output_kernel(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """(C, V) output projection: ``logits = hidden @ kernel``."""
        if "lm_head.kernel" in params:
            return params["lm_head.kernel"]
        return params["wte"].T


def num_params(config: GPT2Config) -> int:
    """Closed-form parameter count (124,439,808 for the 1024-position 124M,
    79,787,184 for ``moe_80m``; an untied head adds V·C)."""
    c, v, p, l = config.n_embd, config.vocab_size, config.n_positions, config.n_layer
    attn = (3 * c * c + 3 * c) + (c * c + c)
    if config.n_experts:
        e, f = config.n_experts, 4 * c
        mlp = (c * e + e) + e * ((c * f + f) + (f * c + c))  # gate + experts
    else:
        mlp = (4 * c * c + 4 * c) + (4 * c * c + c)
    per_block = attn + mlp + 4 * c
    head = 0 if config.tie_word_embeddings else v * c
    return v * c + p * c + l * per_block + 2 * c + head
