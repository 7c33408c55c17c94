"""The port's precision scopes on GPT-2 (CPU): each block's tier reaches
every matmul of one HVP in all three passes (forward, reverse and the
forward-mode tangent), the innermost scope wins, ``--bf16`` computes as
flax's bfloat16 dtype, and ``--linearized`` keeps dtype tiers and refuses
a per-block TF32 switch.

A ``TorchDispatchMode`` records each aten matmul with its operand dtype
and the cuBLAS TF32 flag in force when it ran (the flag is a no-op on the
CPU, but it is set and read exactly as on the card)."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu_torch.curvature.hvp import hvp_fn
from hessian_llm_vision_tpu_torch.curvature.linearized import linearized_matvec
from hessian_llm_vision_tpu_torch.models import losses, precision
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_from_jax
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}
# per block: 4 dense layers + the two attention-core products
BLOCK_PRODUCTS = 6
# products per forward product in one HVP: 1 forward, 2 tangent (one per
# operand), 2 reverse, 4 tangent of the reverse
PER_PRODUCT_IN_HVP = 9
BF16_LOSS_RTOL = 5e-6  # port against flax at dtype bfloat16 (reading 3.4e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Record(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.kinds = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.hlv_port.flag_einsum.default:
            # the flag-switched product (one matmul), seen whole by the mode:
            # f32 operands under the flag it carries
            self.kinds.append("tf32" if args[3] else "fp32")
        elif func in MATMULS:
            dtypes = {a.dtype for a in args if isinstance(a, torch.Tensor)}
            if dtypes == {torch.bfloat16}:
                self.kinds.append("bf16")
            elif dtypes == {torch.float32}:
                self.kinds.append("tf32" if torch.backends.cuda.matmul.allow_tf32 else "fp32")
            else:
                self.kinds.append(f"mixed {sorted(map(str, dtypes))}")
        return func(*args, **(kwargs or {}))


def _model(**overrides):
    cfg = GPT2Config.tiny(n_layer=3, **overrides)
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0))
    params = {n: p.detach() for n, p in model.named_parameters()}
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 256, size=(2, 8)))
    return model, params, {"input_ids": ids}


def _hvp_kinds(**overrides) -> Counter:
    model, params, batch = _model(**overrides)
    rng = np.random.default_rng(2)
    v = {n: torch.as_tensor(rng.standard_normal(p.shape).astype(np.float32))
         for n, p in params.items()}
    with _Record() as rec:
        hvp_fn(losses.lm_loss_fn(model), precision="high")(params, batch, v)
    return Counter(rec.kinds)


def _forward_kinds(**overrides) -> Counter:
    model, params, batch = _model(**overrides)
    with _Record() as rec, torch.no_grad():
        losses.lm_loss_fn(model)(params, batch)
    return Counter(rec.kinds)


def test_block_tiers_reach_every_pass_of_the_hvp():
    """Block 0 at 'default', block 1 at TF32, block 2 and the head
    inherit the outer fp32: every product of block 0 (all passes) has bf16
    operands, every product of block 1 runs with TF32 on, the rest in fp32
    with TF32 off, and nothing is lost or added."""
    spec = ("default", "TF32_TF32_F32", None)
    baseline = _hvp_kinds()
    assert set(baseline) == {"fp32"}
    fwd = _forward_kinds(block_matmul_precision=spec)
    assert fwd["bf16"] == fwd["tf32"] == BLOCK_PRODUCTS
    got = _hvp_kinds(block_matmul_precision=spec)
    per_block = BLOCK_PRODUCTS * PER_PRODUCT_IN_HVP
    assert got == Counter({"bf16": per_block, "tf32": per_block,
                           "fp32": baseline["fp32"] - 2 * per_block})
    # all blocks bf16: only the head's products stay fp32
    allb = _hvp_kinds(block_matmul_precision="default")
    assert allb["bf16"] == 3 * per_block and allb["fp32"] == baseline["fp32"] - 3 * per_block
    # all blocks TF32: the outer scope sets the ambient flag to TF32 and the
    # head keeps fp32 through the flag-switching product; the flag is restored
    allt = _hvp_kinds(block_matmul_precision="TF32_TF32_F32")
    assert allt == Counter({"tf32": 3 * per_block, "fp32": baseline["fp32"] - 3 * per_block})
    assert not torch.backends.cuda.matmul.allow_tf32


def test_innermost_scope_wins():
    """attn_scores_precision inside a 'default' block: block 0's two
    attention-core products run TF32, its dense layers bf16; the scores
    scope also reaches the fp32 blocks (TF32 there too)."""
    got = _hvp_kinds(block_matmul_precision=("default", None, None),
                     attn_scores_precision="TF32_TF32_F32")
    dense, scores = 4 * PER_PRODUCT_IN_HVP, 2 * PER_PRODUCT_IN_HVP
    assert got["bf16"] == dense and got["tf32"] == 3 * scores
    # the MLP scope overrides the block: block 0's MLP back at fp32
    got = _hvp_kinds(block_matmul_precision=("default", None, None), mlp_matmul_precision="high")
    assert got["bf16"] == 4 * PER_PRODUCT_IN_HVP  # qkv, proj and the two attention products


def test_outer_precision_tiers():
    """hvp_fn's precision is the outer scope: 'default' runs every product
    bf16, float64 runs every product in float64 and returns f32."""
    model, params, batch = _model()
    fl = Flattener(params)
    v = fl.unflatten(torch.as_tensor(np.random.default_rng(3).standard_normal(fl.size)
                                     .astype(np.float32)))
    loss = losses.lm_loss_fn(model)
    with _Record() as rec:
        bf = fl.flatten(hvp_fn(loss, precision="default")(params, batch, v))
    assert set(rec.kinds) == {"bf16"}
    ref = fl.flatten(hvp_fn(loss, precision="highest")(params, batch, v))
    f64 = fl.flatten(hvp_fn(loss, precision="F64_F64_F64")(params, batch, v))
    assert bf.dtype == f64.dtype == torch.float32
    rel = [float((x - ref).norm() / ref.norm()) for x in (bf, f64)]
    assert 1e-4 < rel[0] < 0.1 and rel[1] < 1e-5, rel
    # the ambient flags are restored
    assert not torch.backends.cuda.matmul.allow_tf32


def test_bf16_loss_equals_flax_bfloat16():
    """GPT2Config.dtype bfloat16 against flax's dtype=bfloat16, same params
    (dense and chunked loss); the bf16 loss is not the f32 one."""
    ids = np.random.default_rng(0).integers(0, 256, size=(4, 16))
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm = JGPT2LMHead(JGPT2Config.tiny(dtype=jdt))
        jp = jm.init_params(jax.random.PRNGKey(3), seq_len=16)
        m = GPT2LMHead(GPT2Config.tiny(dtype=tdt))
        m.load_state_dict(gpt2_params_from_jax(jp))
        params = {n: p.detach() for n, p in m.named_parameters()}
        for chunk in (None, 8):
            ours = float(losses.lm_loss_fn(m, loss_chunk=chunk)(
                params, {"input_ids": torch.as_tensor(ids)}))
            ref = float(jlosses.lm_loss_fn(jm, loss_chunk=chunk)(
                jp, {"input_ids": jnp.asarray(ids)}))
            assert abs(ours / ref - 1) <= BF16_LOSS_RTOL, (name, chunk, ours, ref)
            out[(name, chunk)] = ours
        assert all(p.dtype == torch.float32 for p in params.values())
    assert abs(out[("bf16", None)] / out[("f32", None)] - 1) > BF16_LOSS_RTOL


def test_config_checks():
    with pytest.raises(ValueError, match="TF32_TF32_F32"):
        GPT2Config.tiny(block_matmul_precision="BF16_BF16_F32_X3")
    with pytest.raises(ValueError, match="3 entries for 2 layers"):
        GPT2Config.tiny(block_matmul_precision=("high",) * 3)
    with pytest.raises(ValueError, match="invalid block matmul precision"):
        GPT2Config.tiny(attn_scores_precision="fast")
    with pytest.raises(NotImplementedError, match="not ported"):
        GPT2Config.tiny(dtype=torch.float16)


def test_linearized_keeps_dtype_tiers_and_refuses_a_tf32_switch():
    model, params, batch = _model(block_matmul_precision=("default", None, "F64_F64_F64"))
    loss = losses.lm_loss_fn(model)
    fl = Flattener(params)
    v = torch.as_tensor(np.random.default_rng(4).standard_normal(fl.size).astype(np.float32))
    plain = fl.flatten(hvp_fn(loss, precision="high")(params, batch, fl.unflatten(v)))
    lin = linearized_matvec(loss, params, batch, precision="high")(v)
    assert float((lin - plain).norm() / plain.norm()) <= 1e-6
    # a TF32 block under an fp32 outer scope (once refused) traces: its
    # products are flag_einsum nodes, and the tangent map is the eager HVP's
    model, params, batch = _model(block_matmul_precision=("TF32_TF32_F32", None, None))
    loss = losses.lm_loss_fn(model)
    plain = fl.flatten(hvp_fn(loss, precision="high")(params, batch, fl.unflatten(v)))
    lin = linearized_matvec(loss, params, batch, precision="high")(v)
    assert float((lin - plain).norm() / plain.norm()) <= 1e-6
    # a uniform TF32 outer scope needs no switch: it traces
    model, params, batch = _model()
    linearized_matvec(losses.lm_loss_fn(model), params, batch, precision="TF32_TF32_F32")


@pytest.mark.parametrize("overrides,outer,switches", [
    ({}, "high", False),
    ({"block_matmul_precision": "TF32_TF32_F32"}, "high", True),
    ({}, "TF32_TF32_F32", False),
    ({"block_matmul_precision": "default"}, "high", False),
    ({"block_matmul_precision": ("default", "TF32_TF32_F32", None)}, "high", True),
    ({"block_matmul_precision": ("F64_F64_F64", None, None)}, "high", False),
    ({"block_matmul_precision": "default", "attn_scores_precision": "TF32_TF32_F32"},
     "default", False),
    ({"mlp_matmul_precision": "TF32_TF32_F32"}, "high", True),
], ids=["fp32", "blocks_tf32_head_fp32", "all_tf32", "mixed", "per_block", "f64_block",
        "tf32_scores_in_bf16", "tf32_mlp"])
def test_tf32_switches_predicts_the_flag_switching_products(overrides, outer, switches,
                                                            monkeypatch):
    """``tf32_switches`` says exactly when an HVP inside the outer scope
    that reads the loss's config runs some product through ``_FlagEinsum``
    (a ``flag_einsum`` node in a traced graph)."""
    model, params, batch = _model(**overrides)
    calls = []
    apply = precision._FlagEinsum.apply
    monkeypatch.setattr(precision._FlagEinsum, "apply",
                        lambda *a: calls.append(a[0]) or apply(*a))
    v = {n: torch.ones_like(p) for n, p in params.items()}
    hvp_fn(losses.lm_loss_fn(model), precision=outer)(params, batch, v)
    assert precision.tf32_switches(model.config, outer) is switches
    assert bool(calls) is switches


def test_flag_einsum_gradients_equal_plain_einsum():
    """The TF32 product's backward and jvp are einsum's own derivatives
    (here on the CPU, where the flag changes no number)."""
    rng = np.random.default_rng(5)
    a, b = (torch.as_tensor(rng.standard_normal(s).astype(np.float32)) for s in ((2, 3, 4), (4, 5)))
    ta, tb = (torch.as_tensor(rng.standard_normal(s).astype(np.float32)) for s in ((2, 3, 4), (4, 5)))

    def f(tiered):
        def g(a, b):
            with precision.precision_scope("TF32_TF32_F32" if tiered else None):
                return precision.matmul(a, b).square().sum()
        return g

    for tiered in (True, False):
        grad = torch.func.grad(f(tiered), argnums=(0, 1))
        out = torch.func.jvp(lambda a, b: grad(a, b), (a, b), (ta, tb))
        if tiered:
            first = out
        else:
            for x, y in zip(first[0] + first[1], out[0] + out[1]):
                torch.testing.assert_close(x, y)
    with pytest.raises(ValueError, match="summed alone"):
        precision._grad_equations("ij,jk->k")
