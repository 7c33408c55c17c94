"""Plain GPT-NeoX in PyTorch: the benchmark's reference for Pythia
configurations.

Written from the published description (Black et al. 2022, "GPT-NeoX-20B",
Biderman et al. 2023, "Pythia", and the `EleutherAI/pythia-*` configs):
token embedding ``embed_in``, blocks with the parallel residual ``x +
attn(ln1(x)) + mlp(ln2(x))``, rotary position embeddings (rotate-half
layout, base ``rotary_emb_base``) on the first ``rotary_pct`` of each
head's dimensions, a 4x MLP, a final LayerNorm and an untied head
``embed_out`` without bias.  The MLP's activation is the configuration's
``hidden_act``: ``gelu`` (exact) or ``gelu_pytorch_tanh``.  Float32, no
kernels, no cache.

Weights are a ``{name: tensor}`` dict in the layout the benchmark hands to
the program (dense kernels ``(in, out)``; ``query_key_value``'s columns
``[q | k | v]``, head ``h`` at columns ``h*D:(h+1)*D`` of each).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.gpt2 import _dense, _ln, causal_self_attention, merge_heads, split_heads

_ACT = {"gelu": "none", "gelu_pytorch_tanh": "tanh"}


def _rotary(x, base: float, rot: int):
    """Rotate the first ``rot`` dims of x (B, H, T, D) by position."""
    T = x.shape[-2]
    inv = 1.0 / base ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot)
    ang = torch.outer(torch.arange(T, dtype=torch.float32, device=x.device), inv)
    ang = torch.cat([ang, ang], dim=-1)
    xr, rest = x[..., :rot], x[..., rot:]
    half = rot // 2
    turned = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    return torch.cat([xr * ang.cos() + turned * ang.sin(), rest], dim=-1)


def logits(w: dict, ids: torch.Tensor, cfg: dict) -> torch.Tensor:
    C, H, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"]
    rot = int((C // H) * cfg["rotary_pct"])
    act = _ACT[cfg["hidden_act"]]
    x = w["embed_in"][ids]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layer_{i}."
        qkv = _dense(_ln(x, w, p + "input_layernorm", eps), w, p + "attention.query_key_value")
        q, k, v = (split_heads(t, H) for t in qkv.split(C, dim=-1))
        if rot:
            q = _rotary(q, cfg["rotary_emb_base"], rot)
            k = _rotary(k, cfg["rotary_emb_base"], rot)
        attn = _dense(merge_heads(causal_self_attention(q, k, v)), w, p + "attention.dense")
        h = _ln(x, w, p + "post_attention_layernorm", eps)
        mlp = _dense(F.gelu(_dense(h, w, p + "mlp.dense_h_to_4h"), approximate=act), w,
                     p + "mlp.dense_4h_to_h")
        x = x + attn + mlp
    return _ln(x, w, "final_layer_norm", eps) @ w["embed_out.kernel"]


def loss(w: dict, ids: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Mean next-token cross-entropy over every (B, T-1) target."""
    z = logits(w, ids, cfg)
    return F.cross_entropy(z[:, :-1].reshape(-1, z.shape[-1]), ids[:, 1:].reshape(-1))


def shapes(cfg: dict) -> dict:
    C, V, I = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    out = {"embed_in": (V, C), "embed_out.kernel": (C, V),
           "final_layer_norm.scale": (C,), "final_layer_norm.bias": (C,)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layer_{i}."
        for ln in ("input_layernorm", "post_attention_layernorm"):
            out[p + ln + ".scale"] = out[p + ln + ".bias"] = (C,)
        for name, (fan_in, fan_out) in {
                "attention.query_key_value": (C, 3 * C), "attention.dense": (C, C),
                "mlp.dense_h_to_4h": (C, I), "mlp.dense_4h_to_h": (I, C)}.items():
            out[p + name + ".kernel"] = (fan_in, fan_out)
            out[p + name + ".bias"] = (fan_out,)
    return out


def check(cfg: dict) -> None:
    if cfg.get("tie_word_embeddings", False):
        raise ValueError("the NeoX reference has an untied embed_out")
    if not cfg.get("use_parallel_residual", True):
        raise ValueError("the NeoX reference computes the parallel residual")
    if cfg["hidden_act"] not in _ACT:
        raise ValueError(f"hidden_act {cfg['hidden_act']!r}: expected one of {sorted(_ACT)}")
