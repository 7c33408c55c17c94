"""The port's other language-model families against the JAX package on the
CPU, weights carried by ``models/convert.py``: NeoX (rotary on a quarter
of each head), LLaMA with grouped-query attention (4 query heads over 2 kv
heads), and GPT-2 with 4 dense-gated experts and with top-2 routing.
Logits, gradient and HVP within 1e-5 relative, Lanczos T and Ritz values
within 1e-3; LoRA adapters on LLaMA; the convert round trip; the
precision tier map of the NeoX and LLaMA configs."""

import dataclasses
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hessian_llm_vision_tpu.curvature.hvp import hvp as jhvp
from hessian_llm_vision_tpu.krylov.lanczos import lanczos as jlanczos
from hessian_llm_vision_tpu.models import lora as jlora
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models import moe as jmoe
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.models.gpt2 import num_params as jnum_params
from hessian_llm_vision_tpu.models.llama import LLAMA_CONFIGS as JLLAMA_CONFIGS
from hessian_llm_vision_tpu.models.llama import LlamaConfig as JLlamaConfig
from hessian_llm_vision_tpu.models.llama import LlamaLMHead as JLlamaLMHead
from hessian_llm_vision_tpu.models.precision import per_layer_precision as jper_layer_precision
from hessian_llm_vision_tpu.models.pythia import PYTHIA_CONFIGS as JPYTHIA_CONFIGS
from hessian_llm_vision_tpu.models.pythia import NeoXConfig as JNeoXConfig
from hessian_llm_vision_tpu.models.pythia import NeoXLMHead as JNeoXLMHead
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.cli import workloads
from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp_fn
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.models import (
    LLAMA_CONFIGS,
    PYTHIA_CONFIGS,
    GPT2Config,
    GPT2LMHead,
    LlamaConfig,
    LlamaLMHead,
    NeoXConfig,
    NeoXLMHead,
    losses,
    lora,
    moe,
    precision,
)
from hessian_llm_vision_tpu_torch.models.convert import params_from_jax, params_to_jax
from hessian_llm_vision_tpu_torch.models.gpt2 import num_params
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

RTOL = 1e-5  # logits, gradient, HVP (relative L2)
RITZ_RTOL = 1e-3  # Lanczos T and Ritz values (the ROADMAP bar)
B, T = 2, 16

# (JAX config, JAX model, port config, port model) per family
FAMILIES = {
    "neox": (JNeoXConfig.tiny(), JNeoXLMHead, NeoXConfig.tiny(), NeoXLMHead),
    "llama_gqa": (JLlamaConfig.tiny(), JLlamaLMHead, LlamaConfig.tiny(), LlamaLMHead),
    "moe_dense": (JGPT2Config.tiny(n_experts=4), JGPT2LMHead, GPT2Config.tiny(n_experts=4),
                  GPT2LMHead),
    "moe_top2": (JGPT2Config.tiny(n_experts=4, moe_top_k=2), JGPT2LMHead,
                 GPT2Config.tiny(n_experts=4, moe_top_k=2), GPT2LMHead),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@functools.cache
def _pair(family):
    """JAX model, params, batch and Flattener with the port's counterparts
    carrying the same weights and tokens (built once per family)."""
    jcfg, jcls, cfg, cls = FAMILIES[family]
    jmodel = jcls(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(3), seq_len=T)
    model = cls(cfg)
    model.load_state_dict(params_from_jax(jparams))
    params = {n: p.detach() for n, p in model.named_parameters()}
    ids = np.random.RandomState(7).randint(0, jcfg.vocab_size, size=(B, T))
    mask = np.ones_like(ids)
    mask[1, 12:] = 0
    return {
        "jmodel": jmodel, "jparams": jparams, "jloss": jlosses.lm_loss_fn(jmodel),
        "jbatch": {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)},
        "jfl": JFlattener(jparams), "model": model, "params": params,
        "loss": losses.lm_loss_fn(model), "fl": Flattener(params), "ids": ids,
        "batch": {"input_ids": torch.as_tensor(ids), "attention_mask": torch.as_tensor(mask)},
    }


def _vector(n, seed):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_and_loss_match_jax(family):
    p = _pair(family)
    jlogits = np.asarray(p["jmodel"].apply({"params": p["jparams"]}, jnp.asarray(p["ids"])))
    with torch.no_grad():
        logits = p["model"](torch.as_tensor(p["ids"])).numpy()
        loss = float(p["loss"](p["params"], p["batch"]))
    assert rel_l2(logits, jlogits) <= RTOL
    np.testing.assert_allclose(loss, float(p["jloss"](p["jparams"], p["jbatch"])), rtol=RTOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gradient_matches_jax(family):
    p = _pair(family)
    jl, jg = jax.value_and_grad(p["jloss"])(p["jparams"], p["jbatch"])
    loss, grad = grad_and_loss(p["loss"], p["params"], p["batch"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    assert rel_l2(p["fl"].flatten(grad).numpy(), p["jfl"].flatten(jg)) <= RTOL


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hvp_matches_jax(family):
    p = _pair(family)
    v = _vector(p["fl"].size, 2)
    jout = jhvp(p["jloss"], p["jparams"], p["jbatch"], p["jfl"].unflatten(jnp.asarray(v)),
                precision="highest")
    out = hvp_fn(p["loss"], precision="highest")(p["params"], p["batch"],
                                                   p["fl"].unflatten(torch.as_tensor(v)))
    assert rel_l2(p["fl"].flatten(out).numpy(), p["jfl"].flatten(jout)) <= RTOL


@pytest.mark.parametrize("family", list(FAMILIES))
def test_lanczos_and_ritz_match_jax(family):
    p = _pair(family)
    jfl, fl = p["jfl"], p["fl"]
    v0 = _vector(fl.size, 4)
    port_hvp = hvp_fn(p["loss"], precision="highest")
    jres = jlanczos(lambda v: jfl.flatten(jhvp(p["jloss"], p["jparams"], p["jbatch"],
                                               jfl.unflatten(v), precision="highest")),
                    jfl.size, 8, v0=jnp.asarray(v0))
    res = lanczos(lambda v: fl.flatten(port_hvp(p["params"], p["batch"], fl.unflatten(v))),
                  fl.size, 8, v0=torch.as_tensor(v0))
    np.testing.assert_allclose(res.alphas.numpy(), np.asarray(jres.alphas),
                               rtol=RITZ_RTOL, atol=1e-4)
    np.testing.assert_allclose(res.betas.numpy(), np.asarray(jres.betas),
                               rtol=RITZ_RTOL, atol=1e-4)
    ritz, jritz = (np.linalg.eigvalsh(t) for t in (res.tridiag().numpy(),
                                                   np.asarray(jres.tridiag())))
    np.testing.assert_allclose(ritz, jritz, rtol=RITZ_RTOL, atol=RITZ_RTOL * np.abs(jritz).max())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_convert_round_trip_and_flat_order(family):
    p = _pair(family)
    tree = params_to_jax(p["model"].state_dict())
    jleaves = jax.tree_util.tree_leaves_with_path(p["jparams"])
    assert len(jleaves) == len(jax.tree_util.tree_leaves(tree))
    for path, leaf in jleaves:
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    np.testing.assert_array_equal(p["fl"].flatten(p["params"]).numpy(),
                                  np.asarray(p["jfl"].flatten(p["jparams"])))
    if family.startswith("moe"):  # the stacked (E, ...) expert leaves
        assert p["params"]["h_0.moe.w1"].shape == (4, 32, 128)
        assert p["params"]["h_1.moe.b2"].shape == (4, 32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunked_loss_uses_the_family_head(family):
    p = _pair(family)
    with torch.no_grad():
        dense = float(p["loss"](p["params"], p["batch"]))
        for chunk in (4, 5):
            chunked = float(losses.lm_loss_fn(p["model"], loss_chunk=chunk)(p["params"],
                                                                           p["batch"]))
            np.testing.assert_allclose(chunked, dense, rtol=RTOL)
    jchunked = float(jlosses.lm_loss_fn(p["jmodel"], loss_chunk=4)(p["jparams"], p["jbatch"]))
    np.testing.assert_allclose(dense, jchunked, rtol=RTOL)


def test_named_configs_are_the_jax_packages():
    fields = ("vocab_size", "hidden_size", "num_layers", "num_heads", "rotary_pct",
              "rotary_emb_base", "max_position_embeddings")
    assert PYTHIA_CONFIGS.keys() == JPYTHIA_CONFIGS.keys()
    for name, cfg in PYTHIA_CONFIGS.items():
        assert [getattr(cfg, f) for f in fields] == [getattr(JPYTHIA_CONFIGS[name], f)
                                                     for f in fields]
    fields = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
              "kv_heads", "rope_theta", "rms_eps", "max_position_embeddings")
    assert LLAMA_CONFIGS.keys() == JLLAMA_CONFIGS.keys()
    for name, cfg in LLAMA_CONFIGS.items():
        assert [getattr(cfg, f) for f in fields] == [getattr(JLLAMA_CONFIGS[name], f)
                                                     for f in fields]
    with torch.device("meta"):
        assert sum(t.numel() for t in NeoXLMHead(PYTHIA_CONFIGS["pythia-1.4b"]).parameters()) \
            == 1_414_647_808
        assert sum(t.numel() for t in LlamaLMHead(LLAMA_CONFIGS["llama-134m"]).parameters()) \
            == 134_105_856
        moe80 = GPT2LMHead(GPT2Config.moe_80m())
    assert sum(t.numel() for t in moe80.parameters()) == num_params(GPT2Config.moe_80m()) \
        == jnum_params(JGPT2Config.moe_80m()) == 79_787_184


def test_topk_equals_dense_with_every_expert_and_room():
    """top_k = E with capacity for every token is the dense mix (the JAX
    package's own invariant)."""
    dense = _pair("moe_dense")
    model = GPT2LMHead(GPT2Config.tiny(n_experts=4, moe_top_k=4, moe_capacity_factor=4.0))
    model.load_state_dict(dense["model"].state_dict())
    x = torch.as_tensor(dense["ids"])
    with torch.no_grad():
        torch.testing.assert_close(model(x), dense["model"](x), rtol=1e-5, atol=1e-5)


def test_topk_curvature_warning():
    top = GPT2Config.tiny(n_experts=4, moe_top_k=2)
    assert moe.topk_curvature_warning(top) == jmoe.topk_curvature_warning(
        JGPT2Config.tiny(n_experts=4, moe_top_k=2))
    assert moe.topk_curvature_warning(GPT2Config.tiny(n_experts=4)) is None
    assert moe.topk_curvature_warning(LlamaConfig.tiny()) is None
    with pytest.warns(moe.TopKCurvatureWarning, match=r"\[spectrum\] curvature over TOP-K"):
        assert moe.warn_if_topk_curvature(GPT2LMHead(top), what="spectrum") is not None


@pytest.fixture(scope="module")
def lora_pair():
    """LLaMA-tiny base params and rank-2 adapters from the JAX package,
    carried to the port, with B set to small random values so that the
    adapted model differs from the base."""
    p = _pair("llama_gqa")
    jad = jlora.lora_init(p["jparams"], 2, jax.random.PRNGKey(9))
    rng = np.random.RandomState(5)
    jad = {k: {"A": v["A"], "B": jnp.asarray(0.05 * rng.randn(*v["B"].shape), jnp.float32)}
           for k, v in jad.items()}
    return p, jad, params_from_jax(jad)


def test_lora_init_merge_and_targets():
    p = _pair("llama_gqa")
    ad = lora.lora_init(p["params"], 2, torch.Generator().manual_seed(0))
    jad = jlora.lora_init(p["jparams"], 2, jax.random.PRNGKey(0))
    assert sorted(ad) == sorted(params_from_jax(jad))
    assert len(ad) == 2 * 7 * 2  # 7 projections a layer, A and B
    for name, t in ad.items():
        assert t.shape == params_from_jax(jad)[name].shape
        if name.endswith(".B"):
            assert not t.any()
    merged = lora.merge_lora(p["params"], ad)
    for n, t in p["params"].items():
        torch.testing.assert_close(merged[n], t, rtol=1e-6, atol=1e-6)
    gpt2 = {n: t.detach() for n, t in GPT2LMHead(GPT2Config.tiny()).named_parameters()}
    jgpt2 = JGPT2LMHead(JGPT2Config.tiny()).init_params(jax.random.PRNGKey(0), seq_len=T)
    assert sorted(lora.lora_init(gpt2, 2)) == sorted(params_from_jax(
        jlora.lora_init(jgpt2, 2, jax.random.PRNGKey(0))))
    with pytest.raises(ValueError, match="no kernels match"):
        lora.lora_init(gpt2, 2, targets=r"nothing$")


def test_lora_loss_and_adapter_hvp_match_jax(lora_pair):
    p, jad, ad = lora_pair
    jloss = jlora.lora_loss_fn(p["jloss"], p["jparams"])
    loss = lora.lora_loss_fn(p["loss"], p["params"])
    assert loss.model_config is p["model"].config
    with torch.no_grad():
        np.testing.assert_allclose(float(loss(ad, p["batch"])),
                                   float(jloss(jad, p["jbatch"])), rtol=RTOL)
    jfl, fl = JFlattener(jad), Flattener(ad)
    np.testing.assert_array_equal(fl.flatten(ad).numpy(), np.asarray(jfl.flatten(jad)))
    v = _vector(fl.size, 3)
    jout = jhvp(jloss, jad, p["jbatch"], jfl.unflatten(jnp.asarray(v)), precision="highest")
    out = hvp_fn(loss, precision="highest")(ad, p["batch"], fl.unflatten(torch.as_tensor(v)))
    assert rel_l2(fl.flatten(out).numpy(), jfl.flatten(jout)) <= RTOL


SPECS = [None, "default", ("high", "default"), "TF32_TF32_F32", ("TF32_TF32_F32", None)]


@pytest.mark.parametrize("family", ["neox", "llama_gqa"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: str(s))
def test_tier_map_of_neox_and_llama(family, spec):
    """Per block the tier of the JAX per-layer spec under the outer 'high'
    (fp32 on the card), then the head; tf32_switches iff fp32 and TF32
    products mix."""
    jcfg, _, cfg, _ = FAMILIES[family]
    cfg = dataclasses.replace(cfg, block_matmul_precision=spec)
    per = jper_layer_precision(spec, jcfg.num_layers)
    want = [precision.tier_of(q) if q is not None else precision.FP32 for q in per]
    assert precision._product_tiers(cfg, precision.FP32) == want + [precision.FP32]
    assert precision.tf32_switches(cfg, "high") == (precision.TF32 in want)
    assert not precision.tf32_switches(cfg, "TF32_TF32_F32") or precision.FP32 in want


class _Record(TorchDispatchMode):
    """Each aten matmul's operand dtype: bf16, fp32 or other."""

    def __init__(self):
        super().__init__()
        self.kinds = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            dtypes = {a.dtype for a in args if isinstance(a, torch.Tensor)}
            self.kinds[{torch.bfloat16: "bf16", torch.float32: "fp32"}.get(
                dtypes.pop() if len(dtypes) == 1 else None, "mixed")] += 1
        return func(*args, **(kwargs or {}))


# products per block: NeoX qkv, dense, two MLP, two attention core;
# LLaMA q, k, v, o, gate, up, down, two attention core.  An HVP runs 9
# matmuls per forward product (1 forward, 2 tangent, 2 reverse, 4 tangent
# of the reverse)
@pytest.mark.parametrize("family,products", [("neox", 6), ("llama_gqa", 9)])
def test_block_scope_reaches_every_pass(family, products):
    """Block 0 at 'default' (bf16 operands), block 1 and the head fp32:
    exactly block 0's products run in bf16, in all three passes."""
    _, _, cfg, cls = FAMILIES[family]
    cfg = dataclasses.replace(cfg, block_matmul_precision=("default", None))
    model = cls(cfg, generator=torch.Generator().manual_seed(0))
    params = {n: t.detach() for n, t in model.named_parameters()}
    v = {n: torch.randn(t.shape, generator=torch.Generator().manual_seed(1))
         for n, t in params.items()}
    with _Record() as rec:
        hvp_fn(losses.lm_loss_fn(model), precision="high")(params, _pair(family)["batch"], v)
    assert rec.kinds["bf16"] == 9 * products and rec.kinds["mixed"] == 0
    assert rec.kinds["fp32"] > 0


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_cpu_init_is_the_cpu_generators_draw(name):
    """On the CPU the workload's weights are the model drawn from a CPU
    generator seeded with --seed (a card run of a small model draws there
    too, then moves)."""
    model_cls, cfg = workloads.lm_config(_Args(name))
    model = workloads.init_model(model_cls, cfg, 4, torch.device("cpu"))
    ref = model_cls(cfg, generator=torch.Generator().manual_seed(4))
    for (n, a), (m, b) in zip(model.named_parameters(), ref.named_parameters(), strict=True):
        assert n == m and torch.equal(a, b)


class _Args:
    def __init__(self, model):
        self.model, self.max_length, self.attn_block_q = model, 16, None
        self.block_precision, self.bf16, self.experts, self.moe_top_k = None, False, 0, 0
