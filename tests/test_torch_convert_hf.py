"""The Hugging Face state-dict converters of ``models/convert.py`` against
the JAX package's on the CPU: a seeded state dict under HF's names (torch
tensors, as ``model.state_dict()`` holds them, with HF's prefixes and a
buffer the converters skip) goes through the JAX
``*_from_torch_state_dict`` and the port's ``params_from_jax``, and must
equal the port's own converter bit for bit, leaf by leaf; then the port's
model on those weights gives the JAX model's logits within 1e-5 (rel-L2).
No ``transformers`` is involved on either side."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.models import convert as jconvert
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.models.llama import LlamaConfig as JLlamaConfig
from hessian_llm_vision_tpu.models.llama import LlamaLMHead as JLlamaLMHead
from hessian_llm_vision_tpu.models.pythia import NeoXConfig as JNeoXConfig
from hessian_llm_vision_tpu.models.pythia import NeoXLMHead as JNeoXLMHead
from hessian_llm_vision_tpu_torch.models import (
    GPT2Config,
    GPT2LMHead,
    LlamaConfig,
    LlamaLMHead,
    NeoXConfig,
    NeoXLMHead,
    convert,
)

REL = 1e-5
B, T = 2, 16


def _gpt2_sd(cfg, rng) -> dict:
    C, V, P = cfg.n_embd, cfg.vocab_size, cfg.n_positions
    shapes = {"transformer.wte.weight": (V, C), "transformer.wpe.weight": (P, C),
              "transformer.ln_f.weight": (C,), "transformer.ln_f.bias": (C,),
              "lm_head.weight": (V, C)}
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}."
        shapes.update({p + "ln_1.weight": (C,), p + "ln_1.bias": (C,), p + "ln_2.weight": (C,),
                       p + "ln_2.bias": (C,), p + "attn.c_attn.weight": (C, 3 * C),
                       p + "attn.c_attn.bias": (3 * C,), p + "attn.c_proj.weight": (C, C),
                       p + "attn.c_proj.bias": (C,), p + "mlp.c_fc.weight": (C, 4 * C),
                       p + "mlp.c_fc.bias": (4 * C,), p + "mlp.c_proj.weight": (4 * C, C),
                       p + "mlp.c_proj.bias": (C,), p + "attn.bias": (1, 1, T, T)})
    return shapes


def _neox_sd(cfg, rng) -> dict:
    C, V = cfg.hidden_size, cfg.vocab_size
    shapes = {"gpt_neox.embed_in.weight": (V, C), "gpt_neox.final_layer_norm.weight": (C,),
              "gpt_neox.final_layer_norm.bias": (C,), "embed_out.weight": (V, C)}
    for i in range(cfg.num_layers):
        p = f"gpt_neox.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (C,), p + "input_layernorm.bias": (C,),
            p + "post_attention_layernorm.weight": (C,), p + "post_attention_layernorm.bias": (C,),
            p + "attention.query_key_value.weight": (3 * C, C),
            p + "attention.query_key_value.bias": (3 * C,),
            p + "attention.dense.weight": (C, C), p + "attention.dense.bias": (C,),
            p + "attention.rotary_emb.inv_freq": (4,),
            p + "mlp.dense_h_to_4h.weight": (4 * C, C), p + "mlp.dense_h_to_4h.bias": (4 * C,),
            p + "mlp.dense_4h_to_h.weight": (C, 4 * C), p + "mlp.dense_4h_to_h.bias": (C,)})
    return shapes


def _llama_sd(cfg, rng, tied: bool = False) -> dict:
    C, V, I = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    kv = cfg.kv_heads * cfg.head_dim
    shapes = {"model.embed_tokens.weight": (V, C), "model.norm.weight": (C,)}
    if not tied:
        shapes["lm_head.weight"] = (V, C)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (C,), p + "post_attention_layernorm.weight": (C,),
            p + "self_attn.q_proj.weight": (C, C), p + "self_attn.k_proj.weight": (kv, C),
            p + "self_attn.v_proj.weight": (kv, C), p + "self_attn.o_proj.weight": (C, C),
            p + "self_attn.rotary_emb.inv_freq": (4,),
            p + "mlp.gate_proj.weight": (I, C), p + "mlp.up_proj.weight": (I, C),
            p + "mlp.down_proj.weight": (C, I)})
    return shapes


#: name -> (state-dict shapes, JAX converter and model, port converter and model, configs)
CASES = {
    "gpt2": (_gpt2_sd, jconvert.gpt2_from_torch_state_dict, JGPT2LMHead, JGPT2Config.tiny(),
             convert.gpt2_from_torch_state_dict, GPT2LMHead, GPT2Config.tiny()),
    "neox": (_neox_sd, jconvert.neox_from_torch_state_dict, JNeoXLMHead, JNeoXConfig.tiny(),
             convert.neox_from_torch_state_dict, NeoXLMHead, NeoXConfig.tiny()),
    "llama": (_llama_sd, jconvert.llama_from_torch_state_dict, JLlamaLMHead, JLlamaConfig.tiny(),
              convert.llama_from_torch_state_dict, LlamaLMHead, LlamaConfig.tiny()),
    "llama_tied": (functools.partial(_llama_sd, tied=True), jconvert.llama_from_torch_state_dict,
                   JLlamaLMHead, JLlamaConfig.tiny(), convert.llama_from_torch_state_dict,
                   LlamaLMHead, LlamaConfig.tiny()),
}


@functools.cache
def _converted(name: str) -> tuple:
    make, jconv, jcls, jcfg, conv, cls, cfg = CASES[name]
    rng = np.random.RandomState(17)
    sd = {k: torch.as_tensor(0.1 * rng.standard_normal(s).astype(np.float32))
          for k, s in make(cfg, rng).items()}
    return sd, jconv(sd, jcfg), conv(sd, cfg)


@pytest.mark.parametrize("name", list(CASES))
def test_converter_equals_jax_converter_bit_for_bit(name):
    sd, jtree, got = _converted(name)
    want = convert.params_from_jax(jtree)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    # numpy arrays convert as tensors do, and a ``module.`` prefix is dropped
    conv, cfg = CASES[name][4], CASES[name][6]
    again = conv({"module." + k: v.numpy() for k, v in sd.items()}, cfg)
    assert all(torch.equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("name", list(CASES))
def test_converted_model_matches_jax(name):
    _, jtree, got = _converted(name)
    jcls, jcfg, cls, cfg = CASES[name][2], CASES[name][3], CASES[name][5], CASES[name][6]
    ids = np.random.RandomState(3).randint(0, jcfg.vocab_size, size=(B, T))
    want = np.asarray(jcls(jcfg).apply({"params": jtree}, jnp.asarray(ids)), np.float64)
    model = cls(cfg)
    model.load_state_dict(got)
    with torch.no_grad():
        logits = model(torch.as_tensor(ids)).double().numpy()
    assert np.linalg.norm(logits - want) / np.linalg.norm(want) <= REL
