"""The HVP operation count against a count by hand at a tiny shape."""

from benchmark.harness import registry
from benchmark.metrics import flop_counts
from benchmark.tests import tiny


def family(name):
    return registry.module(tiny.REPO, "families", name)


def test_gpt2_count_by_hand():
    cfg = dict(n_embd=4, n_layer=2, vocab_size=10)
    B, T = 3, 5
    # per token and layer: qkv 4x12, proj 4x4, fc 4x16, proj 16x4 multiply-adds
    per_token = 2 * (2 * (48 + 16 + 64 + 64) + 4 * 10)
    weight = B * T * per_token
    # causal pairs T(T+1)/2 = 15, D x H = C = 4 multiply-adds a pair, two products
    attention = 2 * (2 * 15 * 4) * 2 * B
    assert family("gpt2").forward_flops(cfg, B, T) == (weight, attention)
    assert flop_counts.hvp_flops(weight, attention) == 8 * weight + 9 * attention


def test_neox_count_by_hand():
    cfg = dict(hidden_size=4, num_hidden_layers=1, vocab_size=6, intermediate_size=8)
    B, T = 1, 2
    per_token = 2 * ((48 + 16 + 32 + 32) + 24)
    attention = 2 * (2 * 3 * 4) * 1 * B
    assert family("neox").forward_flops(cfg, B, T) == (B * T * per_token, attention)


def test_gpt2_124m_headline_count():
    cfg = dict(n_embd=768, n_layer=12, vocab_size=50257)
    w, a = family("gpt2").forward_flops(cfg, 8, 512)
    # 12 x 12 C^2 + C V weights a token, 2 C T (T+1) L a sequence
    assert w == 2 * 8 * 512 * (12 * 12 * 768**2 + 768 * 50257)
    assert a == 2 * 768 * 512 * 513 * 12 * 8
    assert abs(flop_counts.hvp_flops(w, a) - 8.44437e12) / 8.44437e12 < 1e-5
