"""Plain GPT-2 in PyTorch: the benchmark's reference for GPT-2 configurations.

Written from the published description (Radford et al. 2019, "Language
Models are Unsupervised Multitask Learners", and the `openai-community/gpt2`
config): learned token and position embeddings, pre-LayerNorm blocks of
causal multi-head self-attention and a 4x MLP with the tanh-approximate
GELU (`gelu_new`), a final LayerNorm, and the output head tied to the token
embedding.  Float32, no kernels, no cache, no batching tricks.

The weights are a ``{name: tensor}`` dict that the benchmark draws; the
names and layouts are the ones the benchmark hands to the program (dense
kernels ``(in, out)`` computing ``x @ kernel + bias``; LayerNorm ``scale``
and ``bias``; ``c_attn``'s columns ``[q | k | v]``, head ``h`` at columns
``h*D:(h+1)*D`` of each).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _ln(x, w, name, eps):
    return F.layer_norm(x, x.shape[-1:], w[name + ".scale"], w[name + ".bias"], eps)


def _dense(x, w, name):
    return x @ w[name + ".kernel"] + w[name + ".bias"]


def causal_self_attention(q, k, v):
    """q, k, v (B, H, T, D) -> (B, H, T, D), softmax over the causal keys."""
    T, D = q.shape[-2], q.shape[-1]
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    return torch.softmax(scores, dim=-1) @ v


def split_heads(x, n_head):
    B, T, C = x.shape
    return x.reshape(B, T, n_head, C // n_head).transpose(1, 2)


def merge_heads(x):
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


def logits(w: dict, ids: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, T) token ids -> (B, T, V) logits."""
    C, eps = cfg["n_embd"], cfg["layer_norm_epsilon"]
    T = ids.shape[1]
    x = w["wte"][ids] + w["wpe"][:T]
    for i in range(cfg["n_layer"]):
        p = f"h_{i}."
        qkv = _dense(_ln(x, w, p + "ln_1", eps), w, p + "attn.c_attn")
        q, k, v = (split_heads(t, cfg["n_head"]) for t in qkv.split(C, dim=-1))
        x = x + _dense(merge_heads(causal_self_attention(q, k, v)), w, p + "attn.c_proj")
        h = F.gelu(_dense(_ln(x, w, p + "ln_2", eps), w, p + "mlp.c_fc"), approximate="tanh")
        x = x + _dense(h, w, p + "mlp.c_proj")
    return _ln(x, w, "ln_f", eps) @ w["wte"].T


def loss(w: dict, ids: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Mean next-token cross-entropy over every (B, T-1) target."""
    z = logits(w, ids, cfg)
    return F.cross_entropy(z[:, :-1].reshape(-1, z.shape[-1]), ids[:, 1:].reshape(-1))


def shapes(cfg: dict) -> dict:
    """Every weight's name and shape."""
    C, V = cfg["n_embd"], cfg["vocab_size"]
    out = {"wte": (V, C), "wpe": (cfg["n_positions"], C), "ln_f.scale": (C,), "ln_f.bias": (C,)}
    for i in range(cfg["n_layer"]):
        p = f"h_{i}."
        for ln in ("ln_1", "ln_2"):
            out[p + ln + ".scale"] = out[p + ln + ".bias"] = (C,)
        for name, (fan_in, fan_out) in {"attn.c_attn": (C, 3 * C), "attn.c_proj": (C, C),
                                        "mlp.c_fc": (C, 4 * C), "mlp.c_proj": (4 * C, C)}.items():
            out[p + name + ".kernel"] = (fan_in, fan_out)
            out[p + name + ".bias"] = (fan_out,)
    return out


def check(cfg: dict) -> None:
    """Refuse a configuration this reference does not describe."""
    if not cfg.get("tie_word_embeddings", True):
        raise ValueError("the GPT-2 reference ties the head to wte")
    if cfg.get("n_inner") not in (None, 4 * cfg["n_embd"]):
        raise ValueError("the GPT-2 reference's MLP is 4 x n_embd wide")
    if cfg.get("activation_function", "gelu_new") != "gelu_new":
        raise ValueError("the GPT-2 reference computes gelu_new")
