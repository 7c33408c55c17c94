"""Rematerialisation in the port (``utils/remat.py``) against the JAX
package's ``jax.checkpoint`` on the CPU, on the same numpy inputs:

* ``hvp_fn(remat=True)``, ``HessianOperator(remat=True)`` and
  ``DatasetHessianOperator`` (remat by default, as in JAX): the JAX
  operators within 1e-5 rel-L2, the port's plain operators within 1e-6;
* ``causal_attention`` blocked, with and without remat and unroll, with
  and without ``q_offset``: outputs, gradient and HVP within 1e-5 of JAX
  (as ``tests/unit/test_blockwise.py`` holds the JAX paths to each other);
* ``chunked_causal_lm_loss`` with remat, unroll and every
  ``head_precision``: loss, gradient and HVP within 1e-5 of JAX for None,
  "high" and "highest"; "default", "act_high" and "weight_high" round
  operands to bf16 on the card's tiers, which JAX on the CPU ignores, so
  they are held to JAX within the bf16 bound ``BF16_REL`` (and must
  differ from the fp32 product, or the rounding did not happen);
* ``per_example_lm_losses`` within 1e-5;
* JAX configs that set ``attn_remat`` / ``attn_unroll`` build the port's
  GPT-2, NeoX and LLaMA and give the JAX logits within 1e-5;
* ``saved_tensors_hooks`` under plain autograd: a rematerialised query
  block or loss chunk saves its inputs and constants, none of its own
  intermediates.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.curvature import operators as jops
from hessian_llm_vision_tpu.models import causal_attention as jcausal_attention
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.models.llama import LlamaConfig as JLlamaConfig
from hessian_llm_vision_tpu.models.llama import LlamaLMHead as JLlamaLMHead
from hessian_llm_vision_tpu.models.pythia import NeoXConfig as JNeoXConfig
from hessian_llm_vision_tpu.models.pythia import NeoXLMHead as JNeoXLMHead
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.curvature import operators
from hessian_llm_vision_tpu_torch.models import (
    GPT2Config,
    GPT2LMHead,
    LlamaConfig,
    LlamaLMHead,
    NeoXConfig,
    NeoXLMHead,
    causal_attention,
    losses,
)
from hessian_llm_vision_tpu_torch.models.convert import params_from_jax

REL = 1e-5  # rel-L2 against JAX (the parity bar)
PLAIN_REL = 1e-6  # rel-L2 against the port's own plain path: the same products
# the bf16 head tiers against JAX's f32 product: operands rounded to 8
# mantissa bits (2^-9 relative) move the logits by ~1e-3 of their scale;
# the loss, gradient and HVP come out well inside 3e-2 (readings 1e-4 to 1e-2)
BF16_REL = 3e-2
B, T, H, D = 2, 16, 2, 4
C, V, CHUNK = 8, 32, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b) -> float:
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in a])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(ts) -> list:
    return [t.detach().numpy() for t in ts]


def _draw(seed: int, *shapes) -> list:
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ----------------------------------------------------------- the operators

@functools.cache
def _gpt2():
    jmodel = JGPT2LMHead(JGPT2Config.tiny(attn_block_q=8))
    jparams = jmodel.init_params(jax.random.PRNGKey(5), seq_len=T)
    ids = [np.random.RandomState(s).randint(0, 256, size=(B, T)) for s in (11, 12)]
    model = GPT2LMHead(GPT2Config.tiny(attn_block_q=8))
    return {"jloss": jlosses.lm_loss_fn(jmodel, loss_chunk=8), "jparams": jparams,
            "jbatches": [{"input_ids": jnp.asarray(i)} for i in ids],
            "loss": losses.lm_loss_fn(model, loss_chunk=8), "params": params_from_jax(jparams),
            "batches": [{"input_ids": torch.as_tensor(i)} for i in ids],
            "v": _draw(2, (JFlattener(jparams).size,))[0]}


@pytest.mark.parametrize("kind", ["hessian", "dataset"])
def test_operators_with_remat_match_jax_and_the_plain_operator(kind):
    """The JAX package's checkpointed operator within 1e-5 and the port's
    plain one within 1e-6, on GPT-2 tiny with query blocks and loss chunks
    (so the whole-loss region holds the per-block and per-chunk ones)."""
    g = _gpt2()
    if kind == "hessian":
        jop = jops.HessianOperator(g["jloss"], g["jparams"], g["jbatches"][0], remat=True,
                                   precision="highest")
        ops = [operators.HessianOperator(g["loss"], g["params"], g["batches"][0], remat=r,
                                         precision="highest") for r in (True, False)]
    else:
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *g["jbatches"])
        jop = jops.DatasetHessianOperator(g["jloss"], g["jparams"], stacked,
                                          precision="highest")
        ops = [operators.DatasetHessianOperator(g["loss"], g["params"], g["batches"],
                                                precision="highest"),
               operators.DatasetHessianOperator(g["loss"], g["params"], g["batches"],
                                                remat=False, precision="highest")]
    want = np.asarray(jop.matvec(jnp.asarray(g["v"])))
    got, plain = (op.matvec(torch.as_tensor(g["v"])).numpy() for op in ops)
    assert rel_l2([got], [want]) <= REL
    assert rel_l2([got], [plain]) <= PLAIN_REL


# ------------------------------------------------------------- attention

def _attention_derivatives(fn, xs, ts, r):
    """(out, grad of <out, r>, its HVP along ts) of ``fn(*xs)`` in torch."""
    def f(*a):
        return (fn(*a) * r).sum()

    grads = torch.func.grad(f, argnums=(0, 1, 2))(*xs)
    hv = torch.func.jvp(lambda *a: torch.func.grad(f, argnums=(0, 1, 2))(*a), xs, ts)[1]
    return fn(*xs), grads, hv


def _jax_attention_derivatives(fn, xs, ts, r):
    def f(*a):
        return (fn(*a) * r).sum()

    grads = jax.grad(f, argnums=(0, 1, 2))(*xs)
    hv = jax.jvp(lambda *a: jax.grad(f, argnums=(0, 1, 2))(*a), xs, ts)[1]
    return fn(*xs), grads, hv


@pytest.mark.parametrize("block_q,remat,unroll", [
    (None, True, False), (4, True, False), (4, True, True), (4, False, False), (8, False, True),
])
def test_causal_attention_matches_jax(block_q, remat, unroll):
    q, k, v, tq, tk, tv, r = _draw(3, *[(B, T, H, D)] * 7)
    out, grads, hv = _attention_derivatives(
        functools.partial(causal_attention, block_q=block_q, remat=remat, unroll=unroll),
        tuple(map(torch.as_tensor, (q, k, v))), tuple(map(torch.as_tensor, (tq, tk, tv))),
        torch.as_tensor(r))
    jout, jgrads, jhv = _jax_attention_derivatives(
        functools.partial(jcausal_attention, block_q=block_q, remat=remat, unroll=unroll),
        (q, k, v), (tq, tk, tv), r)
    assert rel_l2(_np([out]), [jout]) <= REL
    assert rel_l2(_np(grads), jgrads) <= REL
    assert rel_l2(_np(hv), jhv) <= REL


@pytest.mark.parametrize("block_q,remat", [(None, True), (4, True), (4, False)])
def test_causal_attention_with_q_offset_matches_jax(block_q, remat):
    """The queries of positions [8, 16) against all 16 keys (a rank of a
    sequence-parallel model): the JAX dense attention's rows 8-15, its
    gradient in those queries, K and V, and its HVP."""
    q, k, v, tq, tk, tv, r = _draw(4, *[(B, T, H, D)] * 7)
    off = T // 2
    head = jnp.asarray(q[:, :off])

    def jfn(q_tail, k, v):
        return jcausal_attention(jnp.concatenate([head, q_tail], 1), k, v)[:, off:]

    tail = lambda a: a[:, off:]  # noqa: E731
    out, grads, hv = _attention_derivatives(
        functools.partial(causal_attention, block_q=block_q, remat=remat, q_offset=off),
        tuple(map(torch.as_tensor, (tail(q), k, v))),
        tuple(map(torch.as_tensor, (tail(tq), tk, tv))), torch.as_tensor(tail(r)))
    jout, jgrads, jhv = _jax_attention_derivatives(jfn, (tail(q), k, v), (tail(tq), tk, tv),
                                                   tail(r))
    assert rel_l2(_np([out]), [jout]) <= REL
    assert rel_l2(_np(grads), jgrads) <= REL
    assert rel_l2(_np(hv), jhv) <= REL


# ------------------------------------------------------------ the chunked loss

@functools.cache
def _loss_inputs():
    h, w, th, tw = _draw(6, (B, T, C), (C, V), (B, T, C), (C, V))
    ids = np.random.RandomState(7).randint(0, V, size=(B, T))
    mask = np.ones_like(ids)
    mask[1, 11:] = 0
    return h, w, th, tw, ids, mask


def _loss_derivatives(loss, xs, ts):
    grads = torch.func.grad(loss, argnums=(0, 1))(*xs)
    hv = torch.func.jvp(lambda *a: torch.func.grad(loss, argnums=(0, 1))(*a), xs, ts)[1]
    return loss(*xs), grads, hv


@functools.cache
def _jax_chunked(remat: bool, unroll: bool) -> tuple:
    """The JAX chunked loss, gradient and HVP (one per remat/unroll: JAX's
    CPU ignores ``head_precision``, so every tier shares it)."""
    h, w, th, tw, ids, mask = _loss_inputs()

    def loss(h, w):
        return jlosses.chunked_causal_lm_loss(h, w, jnp.asarray(ids), jnp.asarray(mask),
                                              chunk=CHUNK, remat=remat, unroll=unroll)

    grads = jax.grad(loss, argnums=(0, 1))(h, w)
    hv = jax.jvp(lambda a, b: jax.grad(loss, argnums=(0, 1))(a, b), (h, w), (th, tw))[1]
    return float(loss(h, w)), grads, hv


def _port_chunked(head_precision, remat, unroll) -> tuple:
    h, w, th, tw, ids, mask = _loss_inputs()

    def loss(h, w):
        return losses.chunked_causal_lm_loss(h, w, torch.as_tensor(ids), torch.as_tensor(mask),
                                             chunk=CHUNK, remat=remat, unroll=unroll,
                                             head_precision=head_precision)

    val, grads, hv = _loss_derivatives(loss, (torch.as_tensor(h), torch.as_tensor(w)),
                                       (torch.as_tensor(th), torch.as_tensor(tw)))
    return float(val), _np(grads), _np(hv)


@pytest.mark.parametrize("head_precision", [None, "high", "highest", "default", "act_high",
                                            "weight_high"])
@pytest.mark.parametrize("remat,unroll", [(True, False), (True, True), (False, False)])
def test_chunked_loss_matches_jax(head_precision, remat, unroll):
    want = _jax_chunked(remat, unroll)
    got = _port_chunked(head_precision, remat, unroll)
    fp32 = head_precision in (None, "high", "highest")
    bar = REL if fp32 else BF16_REL
    assert abs(got[0] - want[0]) <= bar * abs(want[0])
    assert rel_l2(got[1], want[1]) <= bar
    assert rel_l2(got[2], want[2]) <= bar
    if fp32:  # the plain loop's numbers
        plain = _port_chunked(None, False, False)
        assert abs(got[0] - plain[0]) <= PLAIN_REL * abs(plain[0])
        assert rel_l2(got[1] + got[2], plain[1] + plain[2]) <= PLAIN_REL
    else:  # the bf16 rounding happened
        assert rel_l2(got[1], _port_chunked("high", remat, unroll)[1]) > 1e-6


def test_head_precision_names():
    with pytest.raises(ValueError, match="head_precision"):
        losses.chunked_causal_lm_loss(torch.zeros(1, 4, 2), torch.zeros(2, 3),
                                      torch.zeros(1, 4, dtype=torch.long), head_precision="x")


@pytest.mark.parametrize("masked", [False, True])
def test_per_example_lm_losses_matches_jax(masked):
    jmodel = JGPT2LMHead(JGPT2Config.tiny())
    jparams = jmodel.init_params(jax.random.PRNGKey(2), seq_len=T)
    ids = np.random.RandomState(8).randint(0, 256, size=(3, T))
    jbatch, batch = {"input_ids": jnp.asarray(ids)}, {"input_ids": torch.as_tensor(ids)}
    if masked:
        mask = np.ones_like(ids)
        mask[0, 5:] = 0
        mask[2, 1:] = 0  # no target left: the JAX clamp to 1
        jbatch["attention_mask"], batch["attention_mask"] = jnp.asarray(mask), torch.as_tensor(mask)
    want = np.asarray(jlosses.per_example_lm_losses(jmodel, jparams, jbatch))
    model = GPT2LMHead(GPT2Config.tiny())
    with torch.no_grad():
        got = losses.per_example_lm_losses(model, params_from_jax(jparams), batch).numpy()
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=REL, atol=1e-7)


# ------------------------------------------------------------- the configs

def _port_config(jcfg, cls):
    """The port config of a JAX config, field by field (every JAX field
    exists in the port; the compute dtype maps by name)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for f in dataclasses.fields(jcfg):
        assert f.name in names, f"{cls.__name__} lacks the JAX field {f.name}"
        value = getattr(jcfg, f.name)
        kw[f.name] = getattr(torch, jnp.dtype(value).name) if f.name == "dtype" else value
    return cls(**kw)


FAMILIES = {
    "gpt2": (JGPT2Config.tiny, JGPT2LMHead, GPT2Config, GPT2LMHead),
    "neox": (JNeoXConfig.tiny, JNeoXLMHead, NeoXConfig, NeoXLMHead),
    "llama": (JLlamaConfig.tiny, JLlamaLMHead, LlamaConfig, LlamaLMHead),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_configs_with_attn_remat_fields_build_and_match(family):
    """Both fields off their defaults (the values do not depend on them)."""
    remat, unroll = False, True
    jtiny, jcls, cls, model_cls = FAMILIES[family]
    jcfg = jtiny(attn_block_q=4, attn_remat=remat, attn_unroll=unroll)
    cfg = _port_config(jcfg, cls)
    assert (cfg.attn_remat, cfg.attn_unroll, cfg.attn_block_q) == (remat, unroll, 4)
    jmodel = jcls(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(4), seq_len=T)
    ids = np.random.RandomState(9).randint(0, jcfg.vocab_size, size=(B, T))
    model = model_cls(cfg)
    model.load_state_dict(params_from_jax(jparams))
    with torch.no_grad():
        got = model(torch.as_tensor(ids)).numpy()
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    assert rel_l2([got], [want]) <= REL


# ------------------------------------------------------- what a region saves

def _saved_storages(fn, *leaves):
    """Run ``fn(*leaves)`` recording every tensor autograd saves: returns
    the output and ``{storage pointer: bytes}`` of the saved tensors."""
    saved = {}

    def pack(t):
        s = t.untyped_storage()
        saved[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*leaves)
    return out, saved


def _second_order(out_fn, leaves, tangents):
    """Gradient and HVP of a scalar by plain autograd (create_graph)."""
    y = out_fn(*leaves)
    grads = torch.autograd.grad(y, leaves, create_graph=True)
    hv = torch.autograd.grad(sum((g * t).sum() for g, t in zip(grads, tangents)), leaves)
    return [g.detach() for g in grads], list(hv)


@pytest.mark.parametrize("region", ["attention", "loss_chunks"])
def test_a_rematerialised_region_saves_only_its_inputs(region):
    """Under ``saved_tensors_hooks``, the blocked attention (4 query blocks)
    and the chunked loss (4 chunks) with remat save tensors whose storages
    are their inputs' (q, k, v; the hidden states and the kernel), their
    constants and a few scalars; without remat they also save every
    block's scores or every full chunk's logits.  Gradient and HVP by plain
    ``autograd.grad(create_graph=True)`` equal the plain path's within 1e-6."""
    if region == "attention":
        arrays = _draw(5, *[(B, T, H, D)] * 3)
        r = torch.as_tensor(_draw(6, (B, T, H, D))[0])

        def fn(remat):
            return lambda q, k, v: (causal_attention(q, k, v, block_q=4, remat=remat) * r).sum()

        big, regions = B * H * 4 * T * 4, T // 4  # one block's f32 scores; the blocks
        consts = {r.untyped_storage().data_ptr()}  # the readout's weights, saved by its product
    else:
        h, w, _, _, ids, mask = _loss_inputs()
        arrays = [h, w]

        def fn(remat):
            return lambda h, w: losses.chunked_causal_lm_loss(
                h, w, torch.as_tensor(ids), torch.as_tensor(mask), chunk=CHUNK, remat=remat)

        big, regions = B * CHUNK * V * 4, (T - 1) // CHUNK  # one full chunk's f32 logits
        consts = set()
    leaves = [torch.as_tensor(a).requires_grad_() for a in arrays]
    inputs = {t.untyped_storage().data_ptr() for t in leaves}
    _, saved = _saved_storages(fn(True), *leaves)
    others = {p: n for p, n in saved.items() if p not in inputs | consts}
    # besides the inputs: the regions' constants (each block's mask, each
    # chunk's token ids and weights) and scalars, none larger than a (B, T)
    # int64 tensor, where one block's scores or one full chunk's logits is 4x that
    assert inputs <= set(saved) and all(n <= B * T * 8 for n in others.values()), others
    _, plain_saved = _saved_storages(fn(False), *leaves)
    assert sum(n >= big for p, n in plain_saved.items() if p not in inputs | consts) >= regions
    tangents = [torch.as_tensor(a) for a in _draw(7, *[a.shape for a in arrays])]
    got, want = _second_order(fn(True), leaves, tangents), _second_order(fn(False), leaves,
                                                                         tangents)
    assert rel_l2(_np(got[0] + got[1]), _np(want[0] + want[1])) <= PLAIN_REL


def test_reverse_over_reverse_through_regions():
    """The recompute runs one transform level down, where an outer reverse
    pass still records it: ``grad`` of ``<grad f, v>`` (reverse over
    reverse) equals the forward-over-reverse HVP within 1e-6, with and
    without remat, on blocked attention and chunked loss regions."""
    h, w, th, tw, ids, mask = _loss_inputs()
    q, k, r = (torch.as_tensor(a) for a in _draw(8, (B, T, C // 2, 2), (B, T, C // 2, 2),
                                                   (B, T, C // 2, 2)))

    def f(h, w, remat):
        att = causal_attention(h.reshape(B, T, C // 2, 2), k, q, block_q=4, remat=remat)
        return losses.chunked_causal_lm_loss(
            att.reshape(B, T, C) + h, w, torch.as_tensor(ids), torch.as_tensor(mask),
            chunk=CHUNK, remat=remat) + (att * r).sum()

    xs = (torch.as_tensor(h), torch.as_tensor(w))
    ts = (torch.as_tensor(th), torch.as_tensor(tw))
    out = {}
    for remat in (False, True):
        fwd = torch.func.jvp(lambda *a: torch.func.grad(f, argnums=(0, 1))(*a, remat), xs, ts)[1]
        rev = torch.func.grad(lambda *a: sum((g * t).sum() for g, t in zip(
            torch.func.grad(f, argnums=(0, 1))(*a, remat), ts)), argnums=(0, 1))(*xs)
        assert rel_l2(_np(rev), _np(fwd)) <= PLAIN_REL
        out[remat] = fwd
    assert rel_l2(_np(out[True]), _np(out[False])) <= PLAIN_REL
