"""GPT-2 (OpenAI's layout): the program's model and loss for a
configuration of this family, and the operation count of its forward pass."""

from __future__ import annotations

from benchmark.metrics.flop_counts import transformer_forward_flops


def build(cfg: dict):
    """``(model, loss_fn)``: the program's GPT-2 LM head and its LM loss,
    the spectrum CLI's (dense logits, dense attention)."""
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.losses import lm_loss_fn

    if cfg["layer_norm_epsilon"] != 1e-5:
        raise ValueError("the program's LayerNorm has eps 1e-5")
    model = GPT2LMHead(GPT2Config(vocab_size=cfg["vocab_size"], n_positions=cfg["n_positions"],
                                  n_embd=cfg["n_embd"], n_layer=cfg["n_layer"],
                                  n_head=cfg["n_head"]))
    return model, lm_loss_fn(model)


def forward_flops(cfg: dict, batch: int, seq: int) -> tuple[float, float]:
    """``(weight product FLOPs, attention FLOPs)`` of one forward pass."""
    C = cfg["n_embd"]
    return transformer_forward_flops(C, cfg["n_layer"], cfg["vocab_size"],
                                     cfg.get("n_inner") or 4 * C, batch, seq)
