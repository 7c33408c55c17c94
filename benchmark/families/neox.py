"""GPT-NeoX (Pythia's layout): the program's model and loss for a
configuration of this family, and the operation count of its forward pass."""

from __future__ import annotations

from benchmark.metrics.flop_counts import transformer_forward_flops


def build(cfg: dict):
    """``(model, loss_fn)``: the program's NeoX LM head and its LM loss,
    the spectrum CLI's (dense logits, dense attention)."""
    from hessian_llm_vision_tpu_torch.models.losses import lm_loss_fn
    from hessian_llm_vision_tpu_torch.models.pythia import NeoXConfig, NeoXLMHead

    if cfg["layer_norm_eps"] != 1e-5:
        raise ValueError("the program's LayerNorm has eps 1e-5")
    if cfg["intermediate_size"] != 4 * cfg["hidden_size"]:
        raise ValueError("the program's NeoX MLP is 4 x hidden_size wide")
    if cfg["hidden_act"] != "gelu_pytorch_tanh":
        raise ValueError("the program's NeoX computes the tanh-approximate GELU")
    model = NeoXLMHead(NeoXConfig(
        vocab_size=cfg["vocab_size"], max_position_embeddings=cfg["max_position_embeddings"],
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], rotary_pct=cfg["rotary_pct"],
        rotary_emb_base=cfg["rotary_emb_base"]))
    return model, lm_loss_fn(model)


def forward_flops(cfg: dict, batch: int, seq: int) -> tuple[float, float]:
    """``(weight product FLOPs, attention FLOPs)`` of one forward pass."""
    return transformer_forward_flops(cfg["hidden_size"], cfg["num_hidden_layers"],
                                     cfg["vocab_size"], cfg["intermediate_size"], batch, seq)
