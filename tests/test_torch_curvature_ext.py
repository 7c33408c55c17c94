"""Port curvature beyond the Hessian HVP against the JAX package on the same
numpy inputs: the GGN / Fisher and empirical-Fisher matvecs, the masked
HVP, the linearized tangent map and its residuals, and the host drivers of
layerwise, GGN, linearized and bigmodel spectra (T from JAX's own start
vectors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.curvature import ggn as jggn
from hessian_llm_vision_tpu.curvature.hvp import hvp_fn as jhvp_fn
from hessian_llm_vision_tpu.krylov import driver as jdriver
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.curvature import ggn, linearized
from hessian_llm_vision_tpu_torch.curvature.hvp import hvp_fn
from hessian_llm_vision_tpu_torch.curvature.operators import LayerHessianOperator
from hessian_llm_vision_tpu_torch.krylov import driver
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_to_jax
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.utils import trees
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener, flat_order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, T, NB = 4, 16, 2
MATVEC_TOL = 1e-5  # rel-L2 of a matvec against the JAX package
T_TOL = 1e-5  # T against the JAX package, relative to its largest entry
BF16_EF_TOL = 2e-2  # JAX's own bar for a bf16 G (tests/unit/test_hvp.py)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _vector(n, seed):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _assert_t_close(res, jres):
    """alphas and betas within T_TOL of T's largest entry."""
    ja, jb = np.asarray(jres.alphas), np.asarray(jres.betas)
    scale = max(np.abs(ja).max(), np.abs(jb).max() if jb.size else 0.0)
    np.testing.assert_allclose(res.alphas.numpy(), ja, rtol=T_TOL, atol=T_TOL * scale)
    np.testing.assert_allclose(res.betas.numpy(), jb, rtol=T_TOL, atol=T_TOL * scale)


@pytest.fixture(scope="module")
def pair():
    """One tiny GPT-2 with shared weights and 2 batches of shared tokens, in
    both packages, with the GGN pieces (logits, causal LM loss on them)."""
    model = GPT2LMHead(GPT2Config.tiny(), generator=torch.Generator().manual_seed(5))
    params = {n: p.detach() for n, p in model.named_parameters()}
    jmodel = JGPT2LMHead(JGPT2Config.tiny())
    jparams = jax.tree_util.tree_map(jnp.asarray, gpt2_params_to_jax(params))
    ids = np.random.RandomState(11).randint(0, 256, size=(NB, B, T))
    mask = np.ones((B, T), np.int32)
    return {
        "jloss": jlosses.lm_loss_fn(jmodel), "jparams": jparams, "jfl": JFlattener(jparams),
        "jmodel_fn": lambda p, b: jmodel.apply({"params": p}, b["input_ids"]),
        "jout_loss": lambda o, b: jlosses.causal_lm_loss(o, b["input_ids"], b["attention_mask"]),
        "jbatches": [{"input_ids": jnp.asarray(i), "attention_mask": jnp.asarray(mask)}
                     for i in ids],
        "loss": losses.lm_loss_fn(model), "params": params, "fl": Flattener(params),
        "model_fn": lambda p, b: torch.func.functional_call(model, p, (b["input_ids"],)),
        "out_loss": lambda o, b: losses.causal_lm_loss(o, b["input_ids"], b["attention_mask"]),
        "batches": [{"input_ids": torch.as_tensor(i), "attention_mask": torch.as_tensor(mask)}
                    for i in ids],
    }


# ------------------------------------------------------------- a small MLP

MLP_N = 24


def _mlp():
    """tanh MLP, 5 -> 7 -> 3 classes, the same numpy weights and data in
    both packages; per-example softmax CE."""
    rng = np.random.RandomState(3)
    p = {"b1": rng.randn(7) * 0.1, "w1": rng.randn(5, 7) * 0.5, "w2": rng.randn(7, 3) * 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(MLP_N, 5).astype(np.float32)
    y = rng.randint(0, 3, MLP_N)

    def jmodel(q, b):
        return jnp.tanh(b["x"] @ q["w1"] + q["b1"]) @ q["w2"]

    def jout(o, b):
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(o), b["y"][:, None], 1))

    def model(q, b):
        return torch.tanh(b["x"] @ q["w1"] + q["b1"]) @ q["w2"]

    def out(o, b):
        return losses.softmax_cross_entropy(o, b["y"])

    return {
        "jparams": {k: jnp.asarray(v) for k, v in p.items()},
        "jbatch": {"x": jnp.asarray(x), "y": jnp.asarray(y)},
        "jmodel_fn": jmodel, "jout_loss": jout,
        "params": {k: torch.as_tensor(v) for k, v in p.items()},
        "batch": {"x": torch.as_tensor(x), "y": torch.as_tensor(y)},
        "model_fn": model, "out_loss": out,
    }


# ----------------------------------------------------------- GGN / Fisher

@pytest.mark.parametrize("case", ["gpt2-ggn", "gpt2-fisher", "mlp-ggn"])
def test_ggn_matvec_matches_jax(pair, case):
    """GGNOperator / FisherOperator against JAX ``ggn.py``, rel-L2 1e-5."""
    p = pair if case.startswith("gpt2") else _mlp()
    jb = p["jbatches"][0] if case.startswith("gpt2") else p["jbatch"]
    b = p["batches"][0] if case.startswith("gpt2") else p["batch"]
    jmaker, maker = ((jggn.FisherOperator, ggn.FisherOperator) if case.endswith("fisher")
                     else (jggn.GGNOperator, ggn.GGNOperator))
    jop = jmaker(p["jmodel_fn"], p["jout_loss"], p["jparams"], jb, damping=0.25)
    op = maker(p["model_fn"], p["out_loss"], p["params"], b, damping=0.25)
    assert op.dim == jop.dim
    v = _vector(op.dim, 2)
    assert rel_l2(op.matvec(torch.as_tensor(v)).numpy(), jop.matvec(jnp.asarray(v))) <= MATVEC_TOL


@pytest.mark.parametrize("case", ["gpt2", "mlp"])
def test_ggn_psd_and_symmetric(pair, case):
    """vᵀGv ≥ 0 and uᵀGv = vᵀGu (JAX ``test_hvp.py::test_ggn_psd_and_symmetric``)."""
    p = pair if case == "gpt2" else _mlp()
    b = p["batches"][0] if case == "gpt2" else p["batch"]
    op = ggn.GGNOperator(p["model_fn"], p["out_loss"], p["params"], b)
    v, u = (torch.as_tensor(_vector(op.dim, s)) for s in (4, 5))
    assert float(torch.dot(v, op(v))) >= -1e-5
    np.testing.assert_allclose(float(torch.dot(u, op(v))), float(torch.dot(op(u), v)),
                               rtol=1e-4, atol=1e-6)


def _per_example(p, case):
    """(JAX, port) per-example losses and (JAX, port) batches."""
    if case == "mlp":
        jl = lambda q, e: p["jout_loss"](p["jmodel_fn"](q, {"x": e["x"][None]}),  # noqa: E731
                                         {"y": e["y"][None]})
        tl = lambda q, e: p["out_loss"](p["model_fn"](q, {"x": e["x"][None]}),  # noqa: E731
                                        {"y": e["y"][None]})
        return jl, tl, p["jbatch"], p["batch"]
    jl = lambda q, e: p["jloss"](q, {k: x[None] for k, x in e.items()})  # noqa: E731
    tl = lambda q, e: p["loss"](q, {k: x[None] for k, x in e.items()})  # noqa: E731
    return jl, tl, p["jbatches"][0], p["batches"][0]


@pytest.mark.parametrize("variant", [
    ("mlp", {}), ("mlp", {"chunk_size": 7}), ("mlp", {"chunk_size": 7, "materialize": False}),
    ("gpt2", {}), ("gpt2", {"chunk_size": 3, "materialize": False}),
], ids=["mlp", "mlp-chunked", "mlp-unmaterialized", "gpt2", "gpt2-unmaterialized"])
def test_empirical_fisher_matches_jax(pair, variant):
    """f32 G: the plain CPU apply against JAX's ``EmpiricalFisherOperator``,
    rel-L2 1e-5, materialised, chunked and not materialised."""
    case, kw = variant
    p = pair if case == "gpt2" else _mlp()
    jl, tl, jb, b = _per_example(p, case)
    jop = jggn.EmpiricalFisherOperator(jl, p["jparams"], jb, damping=0.1, **kw)
    op = ggn.EmpiricalFisherOperator(tl, p["params"], b, damping=0.1, **kw)
    v = _vector(op.dim, 6)
    assert rel_l2(op.matvec(torch.as_tensor(v)).numpy(), jop.matvec(jnp.asarray(v))) <= MATVEC_TOL


def test_empirical_fisher_bf16_g_and_dense_reference():
    """bf16 G within JAX's own bar of the float64 dense empirical Fisher
    and of JAX's bf16 operator; f32 G and ``per_example_grads`` against
    the dense reference."""
    p = _mlp()
    jl, tl, jb, b = _per_example(p, "mlp")
    G = ggn.per_example_grads(tl, p["params"], b)
    assert G.shape == (MLP_N, sum(x.numel() for x in p["params"].values()))
    jG = jax.vmap(lambda e: JFlattener(p["jparams"]).flatten(jax.grad(jl)(p["jparams"], e)))(jb)
    assert rel_l2(G.numpy(), jG) <= MATVEC_TOL
    v = _vector(G.shape[1], 8)
    G64 = G.double().numpy()
    dense = G64.T @ (G64 @ v.astype(np.float64)) / MLP_N
    f32 = ggn.EmpiricalFisherOperator(tl, p["params"], b)
    assert rel_l2(f32.matvec(torch.as_tensor(v)).numpy(), dense) <= MATVEC_TOL
    bf16 = ggn.EmpiricalFisherOperator(tl, p["params"], b, grad_dtype=torch.bfloat16)
    out = bf16.matvec(torch.as_tensor(v)).numpy()
    jout = jggn.EmpiricalFisherOperator(jl, p["jparams"], jb, grad_dtype=jnp.bfloat16).matvec(
        jnp.asarray(v))
    assert rel_l2(out, dense) < BF16_EF_TOL
    assert rel_l2(out, jout) < BF16_EF_TOL
    # ef_apply accumulates onto ``out``
    base = torch.as_tensor(_vector(G.shape[1], 9))
    torch.testing.assert_close(ggn.ef_apply(G, torch.as_tensor(v), MLP_N, base),
                               base + ggn.ef_apply(G, torch.as_tensor(v), MLP_N))


@pytest.mark.parametrize("operator", ["ggn", "fisher"])
def test_dataset_spectrum_host_ggn_matches_jax(pair, operator):
    """T of the dataset GGN / Fisher host loop from JAX's start vector,
    1e-5 relative; the matvec equals the mean of the per-batch GGNs."""
    p = pair
    v0 = _vector(p["fl"].size, 4)
    jres = jdriver.dataset_spectrum_host(
        p["jloss"], p["jparams"], p["jbatches"], 6, v0=jnp.asarray(v0), batch_size=B,
        precision="highest", flattener=p["jfl"], operator=operator,
        model_fn=p["jmodel_fn"], out_loss_fn=p["jout_loss"])
    kw = dict(batch_size=B, precision="highest", flattener=p["fl"], operator=operator,
              model_fn=p["model_fn"], out_loss_fn=p["out_loss"])
    res = driver.dataset_spectrum_host(p["loss"], p["params"], p["batches"], 6,
                                       v0=torch.as_tensor(v0), **kw)
    _assert_t_close(res, jres)
    assert float(ritz_decomposition(res).eigvals.min()) >= -1e-5 * float(res.alphas.abs().max())
    mv = driver.dataset_matvec(p["loss"], p["params"], p["batches"], **kw)
    x = torch.as_tensor(v0)
    per_batch = [ggn.GGNOperator(p["model_fn"], p["out_loss"], p["params"], b)(x)
                 for b in p["batches"]]
    torch.testing.assert_close(mv(x), sum(per_batch) / NB, rtol=1e-5, atol=1e-7)


def test_ggn_operator_refusals(pair):
    p = pair
    with pytest.raises(ValueError, match="needs model_fn"):
        driver.dataset_spectrum_host(p["loss"], p["params"], p["batches"], 2,
                                     v0=torch.ones(p["fl"].size), operator="ggn")
    with pytest.raises(ValueError, match="unknown operator"):
        driver.dataset_spectrum_host(p["loss"], p["params"], p["batches"], 2,
                                     v0=torch.ones(p["fl"].size), operator="kfac")


# ------------------------------------------------------------- layerwise

@pytest.mark.parametrize("span", ["leaf", "block"])
def test_masked_hvp_matches_jax(pair, span):
    """m ⊙ H (m ⊙ v) against JAX's masked program, rel-L2 1e-5, zero off
    the block."""
    p = pair
    labels, spans = trees.partition_labels(p["params"])
    if span == "block":
        labels, spans = trees.group_spans(labels, spans, trees.BLOCK_GROUP_REGEX)
    off, size = spans[labels.index("h_1/attn/c_attn/kernel" if span == "leaf" else "h_0")]
    v = _vector(p["fl"].size, 7)
    jm = jdriver._jitted_masked_batch_hvp(p["jloss"], "mean", "highest", p["jfl"])
    ref = np.asarray(jm(jnp.asarray(v), jnp.int32(off), jnp.int32(size), p["jparams"],
                        p["jbatches"][0]))
    mhvp = driver.masked_batch_hvp(p["loss"], "mean", "highest", p["fl"])
    out = mhvp(torch.as_tensor(v), off, size, p["params"], p["batches"][0]).numpy()
    assert rel_l2(out, ref) <= MATVEC_TOL
    assert not out[:off].any() and not out[off + size:].any()


@pytest.mark.parametrize("group", ["leaf", "block"])
def test_layerwise_spectrum_host_matches_jax(pair, group):
    """Per-label T from JAX's masked draws (``fold_in(key, li)``), 1e-5
    relative; the same labels, blocks below min_size skipped."""
    p = pair
    regex = trees.BLOCK_GROUP_REGEX if group == "block" else None
    iters = 6 if group == "block" else 3
    key = jax.random.PRNGKey(3)
    jres = jdriver.layerwise_spectrum_host(
        p["jloss"], p["jparams"], p["jbatches"][0], iters, key=key, precision="highest",
        flattener=p["jfl"], group_regex=regex)
    labels, spans = trees.partition_labels(p["params"])
    if regex:
        labels, spans = trees.group_spans(labels, spans, regex)
    v0s = {label: np.array(jax.random.normal(jax.random.fold_in(key, li), (p["fl"].size,)))
           [off:off + size] for li, (label, (off, size)) in enumerate(zip(labels, spans))}
    res = driver.layerwise_spectrum_host(p["loss"], p["params"], p["batches"][0], iters,
                                         v0s=v0s, precision="highest", flattener=p["fl"],
                                         group_regex=regex)
    assert list(res) == list(jres)
    for label in res:
        assert res[label].num_iters == min(iters, dict(zip(labels, spans))[label][1])
        _assert_t_close(res[label], jres[label])


def test_layerwise_host_equals_incore_layer_operator(pair):
    """The masked host loop is the T-only Lanczos of the in-core
    LayerHessianOperator from the same start vector (exact up to the
    operator's own rounding); the generator draws each block in turn."""
    p = pair
    res = driver.layerwise_spectrum_host(p["loss"], p["params"], p["batches"][0], 5,
                                         generator=torch.Generator().manual_seed(2),
                                         group_regex=trees.BLOCK_GROUP_REGEX)
    labels, spans = trees.group_spans(*trees.partition_labels(p["params"]),
                                      trees.BLOCK_GROUP_REGEX)
    gen = torch.Generator().manual_seed(2)
    for label, (off, size) in zip(labels, spans):
        v0 = torch.zeros(p["fl"].size)
        v0[off:off + size] = torch.randn(size, generator=gen)
        mask = trees.subtree_mask(p["params"], lambda n, b=label: n.startswith(b + "/"))
        op = LayerHessianOperator(p["loss"], p["params"], p["batches"][0], mask)
        ref = lanczos(op.matvec, op.dim, 5, v0=v0, reorth=False, store_basis=False)
        torch.testing.assert_close(res[label].alphas, ref.alphas, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(res[label].betas, ref.betas, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="exactly one"):
        driver.layerwise_spectrum_host(p["loss"], p["params"], p["batches"][0], 2)


# ------------------------------------------------------------- linearized

def _mlp_loss(p):
    """The MLP's batch-mean loss in both packages."""
    return (lambda q, b: p["jout_loss"](p["jmodel_fn"](q, b), b),
            lambda q, b: p["out_loss"](p["model_fn"](q, b), b))


@pytest.mark.parametrize("case", ["gpt2-mean", "mlp-sum"])
def test_linearized_tangent_matches_hvp(pair, case):
    """The tangent map equals the port's HVP and JAX's (rel-L2 1e-5), is
    reusable across vectors, and a new (params, batch) reuses the trace."""
    if case == "gpt2-mean":
        p, normalization, bs = pair, "mean", None
        jloss, loss, jbatches, batches = p["jloss"], p["loss"], p["jbatches"], p["batches"]
    else:
        p, normalization, bs = _mlp(), "sum", MLP_N
        (jloss, loss), jbatches, batches = _mlp_loss(p), [p["jbatch"]] * 2, [p["batch"]] * 2
    fl, jfl = Flattener(p["params"]), JFlattener(p["jparams"])
    resid_p, tangent_p = linearized.linearized_hvp_programs(loss, normalization, "high", fl, bs)
    consts = resid_p(p["params"], batches[0])
    _hvp = hvp_fn(loss, normalization=normalization, batch_size=bs)
    jhv = jax.jit(jhvp_fn(jloss, normalization=normalization, batch_size=bs,
                          precision="highest"))
    for seed in (1, 2):
        v = _vector(fl.size, seed)
        out = tangent_p(torch.as_tensor(v), consts)
        ref = fl.flatten(_hvp(p["params"], batches[0], fl.unflatten(torch.as_tensor(v))))
        assert rel_l2(out.numpy(), ref.numpy()) <= MATVEC_TOL
        jref = jfl.flatten(jhv(p["jparams"], jbatches[0], jfl.unflatten(jnp.asarray(v))))
        assert rel_l2(out.numpy(), jref) <= MATVEC_TOL
        assert torch.equal(out, tangent_p(torch.as_tensor(v), consts))  # residuals untouched
    shifted = {n: t + 0.01 for n, t in p["params"].items()}
    mv = linearized.linearized_matvec(loss, shifted, batches[1], normalization=normalization,
                                      batch_size=bs, precision="high", flattener=fl)
    v = torch.as_tensor(_vector(fl.size, 3))
    ref = fl.flatten(_hvp(shifted, batches[1], fl.unflatten(v)))
    assert rel_l2(mv(v).numpy(), ref.numpy()) <= MATVEC_TOL


def test_linearized_equals_torch_func_linearize():
    """The split trace gives torch.func.linearize's tangent map."""
    p = _mlp()
    _, loss = _mlp_loss(p)
    fl = Flattener(p["params"])
    v = torch.as_tensor(_vector(fl.size, 5))
    _, jvp_fn = torch.func.linearize(torch.func.grad(lambda q: loss(q, p["batch"])),
                                     dict(p["params"]))
    ref = fl.flatten(jvp_fn(fl.unflatten(v)))
    mv = linearized.linearized_matvec(loss, p["params"], p["batch"], flattener=fl)
    assert rel_l2(mv(v).numpy(), ref.numpy()) <= MATVEC_TOL


@pytest.mark.parametrize("case", ["gpt2", "mlp"])
def test_residual_bytes_abstract_concrete_and_positive(pair, case):
    """Positive; the same from meta-device templates as from real tensors
    (MLP), and equal to the distinct storages of the residuals a residual
    pass returns."""
    if case == "gpt2":
        params, batch, loss = pair["params"], pair["batches"][0], pair["loss"]
    else:
        p = _mlp()
        params, batch, loss = p["params"], p["batch"], _mlp_loss(p)[1]
    meta = lambda d: {k: torch.empty_like(t, device="meta") for k, t in d.items()}  # noqa: E731
    n = linearized.residual_bytes(loss, meta(params), meta(batch))
    assert n > 0
    if case == "mlp":
        assert linearized.residual_bytes(loss, params, batch) == n
    resid_p, _ = linearized.linearized_hvp_programs(loss, "mean", "high", Flattener(params))
    assert linearized.concrete_residual_bytes(resid_p(params, batch)) == n


@pytest.mark.parametrize("overrides,switched", [
    ({"block_matmul_precision": "TF32_TF32_F32"}, {False}),
    ({"mlp_matmul_precision": "TF32_TF32_F32"}, {True}),
    ({"attn_block_q": 8, "mlp_matmul_precision": "TF32_TF32_F32"}, {True}),
], ids=["tf32_blocks_fp32_head", "fp32_with_tf32_mlps", "the_same_blocked"])
def test_linearized_keeps_the_flag_switched_products(pair, overrides, switched):
    """Under an fp32 outer scope the traced splits hold each product whose
    TF32 flag differs from the ambient one as a ``flag_einsum`` node with
    that flag (once refused): the fp32 head's with ``tf32=False`` under
    TF32 blocks (the ambient flag on), the MLPs' with ``tf32=True`` under
    an fp32 majority; query blocks (rematerialised in the eager HVP) trace
    plainly.  The tangent map equals the eager HVP within 1e-6 and
    ``tf32_switches`` predicts the nodes.  ``residual_bytes(precision=)``
    counts the residuals of that outer scope."""
    from hessian_llm_vision_tpu_torch.models import precision

    model = GPT2LMHead(GPT2Config.tiny(**overrides), generator=torch.Generator().manual_seed(5))
    params, batch = {n: p.detach() for n, p in model.named_parameters()}, pair["batches"][0]
    loss = losses.lm_loss_fn(model, loss_chunk=8 if "attn_block_q" in overrides else None)
    sp = linearized._trace_split(loss, "mean", None, None, params, batch, "high")
    flags = [n.args[3] for g in (sp.residual, sp.tangent) for n in g.graph.nodes
             if n.target is torch.ops.hlv_port.flag_einsum.default]
    assert set(flags) == switched and precision.tf32_switches(model.config, "high")
    fl = Flattener(params)
    v = torch.as_tensor(_vector(fl.size, 6))
    eager = fl.flatten(hvp_fn(loss, precision="high")(params, batch, fl.unflatten(v)))
    traced = linearized.linearized_matvec(loss, params, batch, precision="high", flattener=fl)(v)
    assert rel_l2(traced.numpy(), eager.numpy()) <= 1e-6
    high = linearized.residual_bytes(loss, params, batch, precision="high")
    resid_p, _ = linearized.linearized_hvp_programs(loss, "mean", "high", fl)
    assert linearized.concrete_residual_bytes(resid_p(params, batch)) == high
    assert linearized.residual_bytes(loss, params, batch, precision="default") != high


def test_linearized_spectrum_host_matches_jax(pair, capsys):
    p = pair
    v0 = _vector(p["fl"].size, 12)
    jres = jdriver.linearized_spectrum_host(
        p["jloss"], p["jparams"], p["jbatches"][0], 6, v0=jnp.asarray(v0),
        precision="highest", flattener=p["jfl"])
    res = driver.linearized_spectrum_host(p["loss"], p["params"], p["batches"][0], 6,
                                          v0=torch.as_tensor(v0), flattener=p["fl"],
                                          progress=True)
    _assert_t_close(res, jres)
    out = capsys.readouterr().out
    assert "linearized residual pass:" in out and "linearized lanczos iter 6/6" in out
    plain = driver.single_batch_spectrum_host_fused(p["loss"], p["params"], p["batches"][0], 6,
                                                    v0=torch.as_tensor(v0), flattener=p["fl"])
    torch.testing.assert_close(res.alphas, plain.alphas, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- bigmodel

def _jax_leaf_draws(p, key):
    """JAX bigmodel's start: one normal per leaf from split(key, n_leaves),
    flax leaf order, as a port dict."""
    leaves = jax.tree_util.tree_leaves(p["jparams"])
    keys = jax.random.split(key, len(leaves))
    draws = [np.array(jax.random.normal(k, leaf.shape, jnp.float32))
             for k, leaf in zip(keys, leaves)]
    return dict(zip(flat_order(p["params"]), map(torch.as_tensor, draws)))


def test_bigmodel_f32_matches_jax_and_bf16_near_f32(pair):
    """f32 q: T against JAX's from its per-leaf draw, 1e-5 relative; bf16
    q: the extreme Ritz values within 2e-3 of the f32 run."""
    p = pair
    key = jax.random.PRNGKey(21)
    jres = jdriver.bigmodel_spectrum_host(p["jloss"], p["jparams"], p["jbatches"][0], 8,
                                          key=key, precision="highest", q_dtype=jnp.float32)
    v0 = _jax_leaf_draws(p, key)
    f32 = driver.bigmodel_spectrum_host(p["loss"], p["params"], p["batches"][0], 8, v0=v0,
                                        q_dtype=torch.float32)
    _assert_t_close(f32, jres)
    b16 = driver.bigmodel_spectrum_host(p["loss"], p["params"], p["batches"][0], 8, v0=v0,
                                        q_dtype=torch.bfloat16)
    ev32 = ritz_decomposition(f32).eigvals
    ev16 = ritz_decomposition(b16).eigvals
    scale = float(ev32.abs().max())
    assert abs(float(ev16.max() - ev32.max())) / scale < 2e-3
    assert abs(float(ev16.min() - ev32.min())) / scale < 2e-3
    # the flat host loop from the same vector: the same operator
    flat = driver.single_batch_spectrum_host_fused(p["loss"], p["params"], p["batches"][0], 8,
                                                   v0=p["fl"].flatten(v0), flattener=p["fl"])
    torch.testing.assert_close(f32.alphas, flat.alphas, rtol=1e-5, atol=1e-5)
