"""Port spectrum stack (operators, host driver, checkpointed Lanczos, SLQ,
comparisons, trees, text data, artifact IO) against the JAX package on
tiny GPT-2 and small dense problems, with the same numpy inputs."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.curvature import operators as jops
from hessian_llm_vision_tpu.data import text as jtext
from hessian_llm_vision_tpu.io import spectra as jspectra
from hessian_llm_vision_tpu.krylov import compare as jcompare
from hessian_llm_vision_tpu.krylov import driver as jdriver
from hessian_llm_vision_tpu.krylov import slq as jslq
from hessian_llm_vision_tpu.krylov.lanczos import LanczosResult as JLanczosResult
from hessian_llm_vision_tpu.krylov.lanczos import lanczos as jlanczos
from hessian_llm_vision_tpu.krylov.lanczos import lanczos_checkpointed as jlanczos_checkpointed
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.utils import trees as jtrees
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.curvature import operators
from hessian_llm_vision_tpu_torch.data import text
from hessian_llm_vision_tpu_torch.io import spectra
from hessian_llm_vision_tpu_torch.krylov import compare, driver, slq
from hessian_llm_vision_tpu_torch.krylov.lanczos import LanczosResult, lanczos, lanczos_checkpointed
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.convert import gpt2_params_to_jax
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.utils import trees
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the CPU
    when several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
B, T, NB = 4, 16, 3
ITERS = 8
NORMS = ("dataset", "mean", "sum")


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _vector(n, seed):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """One tiny GPT-2 with shared weights and 3 batches of shared tokens,
    in both packages."""
    model = GPT2LMHead(GPT2Config.tiny(), generator=torch.Generator().manual_seed(5))
    params = {n: p.detach() for n, p in model.named_parameters()}
    jparams = jax.tree_util.tree_map(jnp.asarray, gpt2_params_to_jax(params))
    ids = np.random.RandomState(11).randint(0, 256, size=(NB, B, T))
    mask = np.ones((B, T), np.int32)
    return {
        "jloss": jlosses.lm_loss_fn(JGPT2LMHead(JGPT2Config.tiny())), "jparams": jparams,
        "jfl": JFlattener(jparams),
        "jbatches": [{"input_ids": jnp.asarray(i), "attention_mask": jnp.asarray(mask)}
                     for i in ids],
        "loss": losses.lm_loss_fn(model), "params": params,
        "fl": Flattener(params),
        "batches": [{"input_ids": torch.as_tensor(i), "attention_mask": torch.as_tensor(mask)}
                    for i in ids],
    }


# ----------------------------------------------------------------- operators

def _operators(p, kind):
    """(JAX operator, port operator) of one kind on the shared model."""
    if kind == "hessian":
        return (jops.HessianOperator(p["jloss"], p["jparams"], p["jbatches"][0],
                                     precision="highest"),
                operators.HessianOperator(p["loss"], p["params"], p["batches"][0],
                                          precision="highest"))
    if kind.startswith("dataset-"):
        norm = kind.split("-")[1]
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *p["jbatches"])
        return (jops.DatasetHessianOperator(p["jloss"], p["jparams"], stacked,
                                            normalization=norm, remat=False,
                                            precision="highest"),
                operators.DatasetHessianOperator(p["loss"], p["params"], p["batches"],
                                                 normalization=norm, precision="highest"))
    if kind == "layer":  # the CLI's --layer h_0/attn
        jmask = jtrees.subtree_mask(p["jparams"], lambda n: "h_0/attn" in n)
        mask = trees.subtree_mask(p["params"], lambda n: "h_0/attn" in n)
        return (jops.LayerHessianOperator(p["jloss"], p["jparams"], p["jbatches"][0], jmask),
                operators.LayerHessianOperator(p["loss"], p["params"], p["batches"][0], mask))
    assert kind == "block"
    preds = [lambda n: n.startswith("h_0/"), lambda n: n.startswith("h_1/mlp"),
             lambda n: n in ("wte", "ln_f/scale")]
    return (jops.BlockDiagonalOperator(p["jloss"], p["jparams"], p["jbatches"][0],
                                       [jtrees.subtree_mask(p["jparams"], f) for f in preds]),
            operators.BlockDiagonalOperator(p["loss"], p["params"], p["batches"][0],
                                            [trees.subtree_mask(p["params"], f) for f in preds]))


@pytest.mark.parametrize("kind", ["hessian", "dataset-dataset", "dataset-mean", "dataset-sum",
                                  "layer", "block"])
def test_operator_matvec_matches_jax(pair, kind):
    jop, op = _operators(pair, kind)
    assert op.dim == jop.dim == pair["fl"].size
    v = _vector(op.dim, 2)
    ref = np.asarray(jop.matvec(jnp.asarray(v)))
    out = op.matvec(torch.as_tensor(v))
    assert rel_l2(out.numpy(), ref) <= 1e-5
    if kind == "layer":  # the block restriction really zeroes the rest
        labels = trees.param_labels(pair["params"])
        _, spans = trees.partition_labels(pair["params"])
        for label, (off, size) in zip(labels, spans):
            if "h_0/attn" not in label:
                assert not out[off:off + size].any()


def test_operator_wrappers_and_default_blocks(pair):
    A = torch.as_tensor(np.random.RandomState(3).randn(6, 6), dtype=torch.float32)
    A = (A + A.T) / 2
    op = operators.MatrixOperator(A)
    v = torch.randn(6, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(op.shifted(0.5)(v), A @ v + 0.5 * v)
    torch.testing.assert_close(op.scaled(-2.0)(v), -2.0 * (A @ v))
    # masks=None: every leaf its own block == the sum of one-leaf layer operators
    p = pair
    v = torch.as_tensor(_vector(p["fl"].size, 9))
    full = operators.BlockDiagonalOperator(p["loss"], p["params"], p["batches"][0])(v)
    parts = sum(operators.LayerHessianOperator(
        p["loss"], p["params"], p["batches"][0], {m: m == n for m in p["params"]})(v)
        for n in p["params"])
    assert rel_l2(full.numpy(), parts.numpy()) <= 1e-6
    # remat=True (once refused, now the default, as in JAX) is the plain operator
    v = torch.as_tensor(_vector(p["fl"].size, 9))
    assert rel_l2(operators.DatasetHessianOperator(p["loss"], p["params"], p["batches"])(v).numpy(),
                  operators.DatasetHessianOperator(p["loss"], p["params"], p["batches"],
                                                   remat=False)(v).numpy()) <= 1e-6


# -------------------------------------------------------------- host driver

def _jax_dataset_spectrum(p, normalization):
    return jdriver.dataset_spectrum_host(
        p["jloss"], p["jparams"], p["jbatches"], ITERS, v0=jnp.asarray(_vector(p["fl"].size, 4)),
        normalization=normalization, batch_size=B, precision="highest", flattener=p["jfl"],
    )


def _port_dataset_spectrum(p, normalization):
    return driver.dataset_spectrum_host(
        p["loss"], p["params"], p["batches"], ITERS, v0=torch.as_tensor(_vector(p["fl"].size, 4)),
        normalization=normalization, batch_size=B, precision="highest", flattener=p["fl"],
    )


def _assert_t_close(res, jres):
    np.testing.assert_allclose(res.alphas.numpy(), np.asarray(jres.alphas), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(res.betas.numpy(), np.asarray(jres.betas), rtol=1e-3, atol=1e-4)
    ev = slq.ritz_decomposition(res).eigvals.numpy()
    jev = np.asarray(jslq.ritz_decomposition(jres).eigvals)
    np.testing.assert_allclose(ev, jev, rtol=1e-3, atol=1e-3 * np.abs(jev).max())


@pytest.mark.parametrize("normalization", NORMS)
def test_dataset_spectrum_host_matches_jax(pair, normalization):
    """The host loop against the JAX package, and against plain Lanczos
    (no reorthogonalisation) on the dataset operator of the same
    normalization."""
    jres = _jax_dataset_spectrum(pair, normalization)
    res = _port_dataset_spectrum(pair, normalization)
    assert res.basis is None and res.num_iters == ITERS and res.betas.shape == (ITERS - 1,)
    _assert_t_close(res, jres)
    op = operators.DatasetHessianOperator(pair["loss"], pair["params"], pair["batches"],
                                          normalization=normalization, precision="highest")
    plain = lanczos(op.matvec, op.dim, ITERS, v0=torch.as_tensor(_vector(op.dim, 4)),
                    reorth=False, store_basis=False)
    torch.testing.assert_close(res.alphas, plain.alphas, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(res.betas, plain.betas, rtol=1e-5, atol=1e-6)


def test_single_batch_fused_matches_jax_and_bf16_qprev(pair):
    p = pair
    v0 = _vector(p["fl"].size, 6)
    jres = jdriver.single_batch_spectrum_host_fused(
        p["jloss"], p["jparams"], p["jbatches"][0], 10, v0=jnp.asarray(v0),
        precision="highest", flattener=p["jfl"],
    )
    kw = dict(v0=torch.as_tensor(v0), precision="highest", flattener=p["fl"])
    f32 = driver.single_batch_spectrum_host_fused(p["loss"], p["params"], p["batches"][0], 10, **kw)
    _assert_t_close(f32, jres)
    # bf16 q_prev: extremes within 2e-3 of the spectrum's scale
    b16 = driver.single_batch_spectrum_host_fused(p["loss"], p["params"], p["batches"][0], 10,
                                                  qprev_bf16=True, **kw)
    ev32 = np.sort(slq.ritz_decomposition(f32).eigvals.numpy())
    ev16 = np.sort(slq.ritz_decomposition(b16).eigvals.numpy())
    scale = max(abs(ev32[0]), abs(ev32[-1]))
    assert abs(ev16[-1] - ev32[-1]) / scale < 2e-3
    assert abs(ev16[0] - ev32[0]) / scale < 2e-3


def test_driver_callback_and_refusals(pair):
    p = pair
    seen = []
    res = driver.dataset_spectrum_host(
        p["loss"], p["params"], p["batches"][:1], 3, generator=torch.Generator().manual_seed(1),
        callback=lambda i, a, b: seen.append((i, a.copy(), b.copy())),
    )
    assert [s[0] for s in seen] == [0, 1, 2]
    np.testing.assert_array_equal(seen[-1][1], res.alphas.numpy())
    np.testing.assert_array_equal(seen[-1][2], res.betas.numpy())
    assert seen[0][2].shape == (0,)
    # operator="ggn" takes the model function and the output loss
    with pytest.raises(ValueError, match="needs model_fn"):
        driver.dataset_spectrum_host(p["loss"], p["params"], p["batches"], 2,
                                     v0=torch.ones(p["fl"].size), operator="ggn")
    with pytest.raises(ValueError, match="exactly one"):
        driver.dataset_spectrum_host(p["loss"], p["params"], p["batches"], 2)
    assert driver.dataset_norm("sum", 3, 4) == ("mean", 4.0)
    assert driver.dataset_norm("mean", 4) == ("mean", 0.25)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("attn_block_q,loss_chunk", [(None, None), (8, 8)],
                         ids=["dense", "blocked_chunked"])
def test_hvp_matches_float64_central_difference(pair, attn_block_q, loss_chunk):
    """The f32 dataset-mean HVP against chip_smoke.py's float64 central
    difference of reverse-mode gradients (its phase 7c reference), on the
    dense and on the query-blocked, chunked-loss paths: rel-L2 <= 1e-5.
    The float64 params keep the loss in float64."""
    cs = _chip_smoke()
    model = GPT2LMHead(GPT2Config.tiny(attn_block_q=attn_block_q),
                       generator=torch.Generator().manual_seed(5))
    params = {n: p.detach() for n, p in model.named_parameters()}
    loss = losses.lm_loss_fn(model, loss_chunk=loss_chunk)
    batches = pair["batches"]
    dim = pair["fl"].size
    q = torch.as_tensor(_vector(dim, 12))
    q = q / torch.linalg.vector_norm(q)
    hv = operators.DatasetHessianOperator(loss, params, batches, normalization="mean").matvec(q)
    ref, ref2 = cs.central_difference_hvp(loss, params, batches, q, cs.FD_EPS)
    assert ref.dtype == torch.float64 and ref.shape == (dim,)
    assert rel_l2(hv.numpy(), ref.numpy()) <= 1e-5
    assert rel_l2(ref2.numpy(), ref.numpy()) <= 1e-6  # the reference's truncation
    l64 = loss({n: p.double() for n, p in params.items()}, batches[0])
    assert l64.dtype == torch.float64
    np.testing.assert_allclose(float(l64), float(loss(params, batches[0])), rtol=1e-6)


# ------------------------------------------------------- checkpointed Lanczos

def test_lanczos_checkpointed_matches_jax_and_resumes_exactly(pair, tmp_path):
    p = pair
    jop = jops.HessianOperator(p["jloss"], p["jparams"], p["jbatches"][1], precision="highest")
    op = operators.HessianOperator(p["loss"], p["params"], p["batches"][1], precision="highest")
    v0 = _vector(op.dim, 7)
    jres = jlanczos_checkpointed(jop.matvec, jop.dim, ITERS, v0=jnp.asarray(v0))
    full = lanczos_checkpointed(op.matvec, op.dim, ITERS, v0=torch.as_tensor(v0))
    _assert_t_close(full, jres)
    # stop at iteration 4 through the state file, resume, and get the same T
    state = tmp_path / "t.state"
    tridiag = []
    lanczos_checkpointed(
        op.matvec, op.dim, 4, v0=torch.as_tensor(v0),
        callback=lambda i, a, b: tridiag.append((a, b)),
        state_callback=lambda i, st: spectra.save_lanczos_state(str(state), **st),
    )
    resumed = lanczos_checkpointed(op.matvec, op.dim, ITERS,
                                   resume_state=spectra.load_lanczos_state(str(state)))
    assert torch.equal(resumed.alphas, full.alphas) and torch.equal(resumed.betas, full.betas)
    np.testing.assert_array_equal(tridiag[-1][0], full.alphas[:4].numpy())
    np.testing.assert_array_equal(tridiag[-1][1], full.betas[:3].numpy())


# ----------------------------------------------------------- SLQ, compare

def _dense(n, seed):
    a = np.random.RandomState(seed).randn(n, n)
    return ((a + a.T) / 2).astype(np.float32)


@pytest.fixture(scope="module")
def tridiags():
    """The same Lanczos T (and basis) in both packages, from a dense
    40x40 matrix and one start vector."""
    A = _dense(40, 1)
    v0 = _vector(40, 2)
    res = lanczos(lambda v: torch.as_tensor(A) @ v, 40, 12, v0=torch.as_tensor(v0))
    jres = JLanczosResult(alphas=jnp.asarray(res.alphas.numpy()),
                          betas=jnp.asarray(res.betas.numpy()),
                          basis=jnp.asarray(res.basis.numpy()))
    return res, jres


def _close(a, b, tol=1e-5):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol, atol=tol * max(np.abs(b).max(), 1.0))


def test_ritz_quadrature_trace_density_match_jax(tridiags):
    res, jres = tridiags
    spec, jspec = slq.ritz_decomposition(res, with_vectors=True), jslq.ritz_decomposition(jres, True)
    _close(spec.eigvals, jspec.eigvals)
    _close(spec.gammas, jspec.gammas)
    np.testing.assert_allclose(float(spec.gammas.sum()), 1.0, atol=1e-5)
    # Ritz vectors up to sign
    V, jV = spec.ritz_vectors.numpy(), np.asarray(jspec.ritz_vectors)
    _close(np.abs(np.sum(V * jV, axis=1)), np.ones(len(V)), 1e-4)
    torch.testing.assert_close(slq.ritz_vectors(res), spec.ritz_vectors)
    _close(slq.quadrature(spec, lambda x: x ** 2), jslq.quadrature(jspec, lambda x: x ** 2))
    _close(slq.trace_estimate(spec), jslq.trace_estimate(jspec))
    _close(slq.trace_estimate(spec, dim=40), jslq.trace_estimate(jspec, dim=40))
    grid = np.linspace(-8, 8, 33).astype(np.float32)
    _close(slq.spectral_density(spec, torch.as_tensor(grid), 0.5),
           jslq.spectral_density(jspec, jnp.asarray(grid), 0.5))
    with pytest.raises(ValueError, match="T-only"):
        slq.ritz_decomposition(res._replace(basis=None), with_vectors=True)


def test_slq_multi_probe_matches_jax_per_probe():
    A = _dense(30, 4)
    gen = torch.Generator().manual_seed(997)
    spec = slq.slq_multi_probe(lambda v: torch.as_tensor(A) @ v, 30, 10, gen, 3)
    # the same probes, drawn from the same generator in probe order
    gen = torch.Generator().manual_seed(997)
    jev, jga = [], []
    for _ in range(3):
        v0 = torch.randn(30, generator=gen).numpy()
        js = jslq.ritz_decomposition(jlanczos(lambda v: jnp.asarray(A) @ v, 30, 10,
                                              v0=jnp.asarray(v0)))
        jev.append(np.asarray(js.eigvals))
        jga.append(np.asarray(js.gammas) / 3)
    _close(spec.eigvals, np.concatenate(jev))
    _close(spec.gammas, np.concatenate(jga))
    np.testing.assert_allclose(float(spec.gammas.sum()), 1.0, atol=1e-5)


def test_compare_functions_match_jax(tridiags):
    res, jres = tridiags
    a = slq.ritz_decomposition(res, with_vectors=True)
    b = slq.slq_multi_probe(lambda v: torch.as_tensor(_dense(40, 1)) @ v, 40, 9,
                            torch.Generator().manual_seed(3), 2)
    ja = jslq.ritz_decomposition(jres, with_vectors=True)
    jb = jslq.Spectrum(eigvals=jnp.asarray(b.eigvals.numpy()), gammas=jnp.asarray(b.gammas.numpy()))
    for top_k in (None, 5):
        _close(compare.ritz_relative_error(a, b, top_k), jcompare.ritz_relative_error(ja, jb, top_k))
    _close(compare.density_overlap(a, b), jcompare.density_overlap(ja, jb))
    _close(compare.wasserstein_distance(a, b), jcompare.wasserstein_distance(ja, jb))
    ours, ref = compare.summarize(b), jcompare.summarize(jb)
    assert ours.keys() == ref.keys() and ours["num_ritz"] == ref["num_ritz"] == 18
    for k in ("lambda_max", "lambda_min", "top5", "trace_estimate", "weight_sum"):
        _close(ours[k], ref[k])
    V = a.ritz_vectors
    _close(compare.subspace_overlap(V[:5], V[2:8]), jcompare.subspace_overlap(ja.ritz_vectors[:5],
                                                                             ja.ritz_vectors[2:8]))


# ------------------------------------------------------------ trees, data

def test_trees_labels_masks_and_spans_match_jax(pair):
    p = pair
    labels = trees.param_labels(p["params"])
    assert labels == jtrees.param_labels(p["jparams"])
    assert "h_0/attn/c_attn/kernel" in labels
    pred = lambda n: "h_0/attn" in n
    jmask = jax.tree_util.tree_leaves(jtrees.subtree_mask(p["jparams"], pred))
    mask = trees.subtree_mask(p["params"], pred)
    assert [mask[n] for n in p["fl"].names] == jmask and sum(jmask) == 4
    jl, jspans = jtrees.partition_labels(p["jparams"])
    assert trees.partition_labels(p["params"]) == (jl, jspans)
    groups = trees.group_spans(jl, jspans, trees.BLOCK_GROUP_REGEX)
    assert groups == jtrees.group_spans(jl, jspans, jtrees.BLOCK_GROUP_REGEX)
    assert groups[0] == ["h_0", "h_1"]
    with pytest.raises(ValueError, match="non-contiguous"):
        trees.group_spans(jl, jspans, r"(bias|kernel)$")
    masked = trees.mask_tree(p["params"], mask)
    for n, x in p["params"].items():
        assert masked[n] is x if mask[n] else not masked[n].any()


def test_text_pipeline_equals_jax(tmp_path):
    (tmp_path / "sub").mkdir()
    rng = np.random.RandomState(0)
    for name, n in (("a.txt", 3000), ("sub/b.md", 2500), ("skip.bin", 400)):
        (tmp_path / name).write_bytes(bytes(rng.randint(32, 127, size=n).astype(np.uint8)))
    for kw in ({"subsample": 1.0}, {"subsample": 0.5, "seed": 3}, {"subsample": 7}):
        ours = text.load_local_corpus(str(tmp_path), max_length=64, batch_size=4, **kw)
        ref = jtext.load_local_corpus(str(tmp_path), max_length=64, batch_size=4, **kw)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])
    toks = [[1, 2, 3], [4] * 9, []]
    for a, b in ((text.collate_tokens(toks, 6, 0), jtext.collate_tokens(toks, 6, 0)),
                 (text.stack_batches({"x": np.arange(10)}, 3), jtext.stack_batches({"x": np.arange(10)}, 3))):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(FileNotFoundError):
        text.load_local_corpus(str(tmp_path / "missing"), max_length=8, batch_size=1)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        text.load_lm_dataset()


# ------------------------------------------------------------------ IO

@pytest.mark.parametrize("path", ["artifacts/slq_multiprobe_r3/spec.npz",
                                  "artifacts/trained124m_r4/spec2000_high.npz"])
def test_port_reads_committed_artifacts_as_jax_does(path):
    ours, ref = spectra.load_spectrum(str(ROOT / path)), jspectra.load_spectrum(str(ROOT / path))
    for a, b in ((ours.eigvals, ref.eigvals), (ours.gammas, ref.gammas)):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    assert ours.ritz_vectors is None and ref.ritz_vectors is None


def test_artifact_round_trips_between_packages(tridiags, tmp_path):
    res, jres = tridiags
    spec = slq.ritz_decomposition(res, with_vectors=True)
    spectra.save_spectrum(str(tmp_path / "ours"), spec, iters=12, subsample=1.0, vector_seed=997)
    jspectra.save_spectrum(str(tmp_path / "ref"), jslq.Spectrum(
        eigvals=jnp.asarray(spec.eigvals.numpy()), gammas=jnp.asarray(spec.gammas.numpy()),
        ritz_vectors=jnp.asarray(spec.ritz_vectors.numpy())), iters=12, subsample=1.0,
        vector_seed=997)
    # same keys, dtypes and bytes whichever package wrote the file
    with np.load(tmp_path / "ours.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert a.files == b.files
        for k in b.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    back = jspectra.load_spectrum(str(tmp_path / "ours.npz"))
    np.testing.assert_array_equal(back.eigvals, spec.eigvals.numpy())
    np.testing.assert_array_equal(back.ritz_vectors, spec.ritz_vectors.numpy())
    # the reference torch format
    spectra.save_reference_spectrum(str(tmp_path / "r.ckpt"), spec)
    ckpt = spectra.load_reference_spectrum(str(tmp_path / "r.ckpt"))
    for a, b in zip(ckpt, spec):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(jspectra.load_reference_spectrum(str(tmp_path / "r.ckpt")).gammas,
                                  spec.gammas.numpy())
    # T checkpoints
    spectra.save_tridiag(str(tmp_path / "t"), res.alphas, res.betas, iter=11)
    a, b = spectra.load_tridiag(str(tmp_path / "t"))
    ja, jb = jspectra.load_tridiag(str(tmp_path / "t"))
    np.testing.assert_array_equal(a, res.alphas.numpy())
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
