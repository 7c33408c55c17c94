"""The port's GPipe pipeline and tensor x sequence parallelism on one model
axis, on gloo ranks on the CPU, against the JAX package on its 8-device
CPU mesh, on the same numpy inputs and the JAX params carried over by
``models/convert.py``.

The pipeline: the JAX pipeline tests' GPT-2 (4 layers; ``tests/
distributed/test_pipeline.py``) pipelined over 2 stages with 2
microbatches (pp2) and, untied and with an attention mask, 4 (both in
the 2-rank spawn of ``tests/test_torch_model_parallel.py``), over data 2 x
pp 2 with 4 microbatches split over the data axis, and over 4 stages with
4 microbatches and a 5-iteration Lanczos with its basis on the pipeline
axis (the JAX (1, 4) case).  The port is held to the JAX package's
pipelined loss on the same mesh.  The JAX pipelined loss itself reads,
from the JAX plain model on these inputs: loss 0 to 1.1e-7 relative,
gradient 2.6e-7 to 1.0e-6 and HVP 4.3e-7 to 1.8e-6 rel-L2 (the untied,
masked case the largest), and its (1, 4) Lanczos T 9.5e-6 on entries to
16.4 (the JAX test's own bars, rtol 1e-3 to 1e-2, are looser); so it
meets the bars below, and the tests hold it to them too.

Tensor and sequence parallelism on one axis: GPT-2, NeoX and LLaMA (the
tiny configs of ``tests/test_torch_model_parallel.py``) tensor-parallel
and sequence-parallel on the model axis of a data 2 x model 2 mesh, the
batch split over the data axis, against the JAX package's
``shard_params_for_tp`` params under ``seq_parallel_config`` on the same
grid; GPT-2's host loop and Lanczos with the basis split over both axes.

One spawn of 4 ranks (dp2 x pp2, pp4, the TP x SP cases,
``parallel/dryrun.py``'s pipeline part and ``pipeline_apply`` alone with
uneven and replicated exits); each spawn and each JAX compile
runs once per test run, shared by the workers through files.  The ranks
import torch and the port only.

Bars: loss 1e-6 relative, gradient and HVP 1e-5 rel-L2, T 1e-4, Ritz
values 1e-3 relative (``tests/test_torch_model_parallel.py``'s).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.curvature import HessianOperator as JHessianOperator
from hessian_llm_vision_tpu.krylov import lanczos as jlanczos
from hessian_llm_vision_tpu.krylov import ritz_decomposition as jritz
from hessian_llm_vision_tpu.krylov.driver import dataset_spectrum_host as jdataset_spectrum_host
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.parallel import make_mesh as jmake_mesh
from hessian_llm_vision_tpu.parallel import seq_parallel_config as jseq_parallel_config
from hessian_llm_vision_tpu.parallel.param_sharding import shard_params_for_tp as jshard_for_tp
from hessian_llm_vision_tpu.parallel.pipeline import make_pipeline_mesh as jmake_pipeline_mesh
from hessian_llm_vision_tpu.parallel.pipeline import make_pipelined_lm_loss as jpipelined_loss
from hessian_llm_vision_tpu.parallel.pipeline import pipeline_param_sharding as jpipe_sharding
from hessian_llm_vision_tpu.parallel.pipeline import stack_pipeline_params as jstack
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.convert import params_from_jax
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.parallel import (
    make_pipeline_mesh,
    make_pipelined_lm_loss,
    pipeline_apply,
    pipeline_param_sharding,
    stack_pipeline_params,
    unstack_pipeline_params,
)
from hessian_llm_vision_tpu_torch.parallel.mesh import Mesh
from hessian_llm_vision_tpu_torch.parallel.param_sharding import Split
from hessian_llm_vision_tpu_torch.parallel.pipeline import exit_parts
from hessian_llm_vision_tpu_torch.parallel.seq_parallel import seq_parallel_config
from hessian_llm_vision_tpu_torch.parallel.spawn import run_ranks
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener
from test_torch_model_parallel import (  # noqa: F401  (the 2-rank spawn is a fixture there)
    GPT2_KW,
    ITERS,
    LLAMA_KW,
    LOSS_RTOL,
    NEOX_KW,
    PIPE_KW,
    PIPELINE,
    PIPELINE_REMAT,
    PIPELINE_TWO,
    RANKS,
    REL,
    RITZ_RTOL,
    SPAWN_TIMEOUT,
    T,
    T_TOL,
    _check,
    _check_lanczos,
    _init,
    _pipeline_inputs,
    _assert_paths_agree,
    _pipeline_rank_case,
    _rank_case,
    _rel,
    _shared,
    two,
)

PIPE_ITERS = 5  # the JAX (1, 4) case's Lanczos
#: the cases run on both collective paths on a model axis of 4 in the
#: 4-rank spawn, one a kind: EP x SP top-2 (gathers and reduce-scatters),
#: then the shifts, the exit and the Lanczos gathers over 4 stages
PATHS_FOUR = (("moe_top2_epsp",), ("pp4",))
#: name -> (family, config); tensor and sequence parallel on one axis
TPSP = {"gpt2_tpsp": ("gpt2", GPT2_KW), "neox_tpsp": ("neox", NEOX_KW),
        "llama_tpsp": ("llama", LLAMA_KW)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _tpsp_inputs(name: str) -> dict:
    family, kw = TPSP[name]
    model, params = _init(family, tuple(sorted(kw.items())))
    ids = np.random.RandomState(3).randint(0, kw["vocab_size"], size=(4, T))
    v = np.random.RandomState(4).standard_normal(JFlattener(params).size).astype(np.float32)
    return {"family": family, "config": kw, "mode": "tpsp", "chunk": None, "model": model,
            "jax_params": params, "ids": ids, "v": v,
            "params": {k: t.numpy() for k, t in params_from_jax(params).items()}}


def _tpsp_rank_case(name: str) -> dict:
    inp = _tpsp_inputs(name)
    return {k: inp[k] for k in ("family", "config", "mode", "chunk", "params", "ids", "v")}


# ------------------------------------------------------------ the JAX side

def _jax_pipeline(name: str) -> dict:
    """The JAX package's pipelined loss of a case on its mesh of the 8-device
    CPU mesh (loss, gradient and HVP in the stacked tree's flat order; the
    (1, 4) case also its 5-iteration Lanczos), and the same of the JAX
    plain model, to read how far the JAX pipeline is from it."""
    inp = _pipeline_inputs(name)
    stages, data, micro = inp["stages"], inp["data"], inp["microbatches"]
    model, params, L = inp["model"], inp["jax_params"], PIPE_KW["n_layer"]
    mesh = jmake_pipeline_mesh(data, stages)
    stacked = jstack(params, L, stages)
    placed = jax.device_put(stacked, jpipe_sharding(stacked, mesh))
    pipe = jpipelined_loss(model, mesh, num_microbatches=micro,
                           data_axis="data" if data > 1 else None)
    plain = jlosses.lm_loss_fn(model)
    batch = {"input_ids": jnp.asarray(inp["ids"])}
    if inp["mask"] is not None:
        batch["attention_mask"] = jnp.asarray(inp["mask"])
    fl, sfl = JFlattener(params), JFlattener(stacked)
    v_tree = fl.unflatten(jnp.asarray(inp["v"]))
    v_stacked = jstack(v_tree, L, stages)

    def everything(loss_fn, to_stacked, p, t):
        loss, grad = jax.value_and_grad(loss_fn)(p, batch)
        hv = jax.jvp(lambda q: jax.grad(loss_fn)(q, batch), (p,), (t,))[1]
        return loss, sfl.flatten(to_stacked(grad)), sfl.flatten(to_stacked(hv))

    out = {}
    for key, fn, p, t, to_stacked in (
            ("pipe", pipe, placed, v_stacked, lambda g: g),
            ("plain", plain, params, v_tree, lambda g: jstack(g, L, stages))):
        loss, grad, hv = jax.jit(functools.partial(everything, fn, to_stacked))(p, t)
        out[key] = {"loss": float(loss), "grad": np.asarray(grad), "hvp": np.asarray(hv)}
    if name == "pp4":
        res = jlanczos(JHessianOperator(pipe, placed, batch).matvec, sfl.size, PIPE_ITERS,
                       v0=sfl.flatten(v_stacked))
        whole = jlanczos(JHessianOperator(plain, params, batch).matvec, fl.size, PIPE_ITERS,
                         v0=jnp.asarray(inp["v"]))
        out["lanczos"] = {"alphas": np.asarray(res.alphas), "betas": np.asarray(res.betas),
                          "ritz": np.sort(np.asarray(jritz(res).eigvals)),
                          "plain_alphas": np.asarray(whole.alphas),
                          "plain_betas": np.asarray(whole.betas)}
    return out


def _jax_tpsp(name: str) -> dict:
    """The JAX package's loss, gradient and HVP of a case, its params
    tensor-parallel and its model sequence-parallel on a data 2 x model 2
    mesh."""
    inp = _tpsp_inputs(name)
    mesh = jmake_mesh(2, 2)
    params = jshard_for_tp(inp["jax_params"], mesh)
    model = type(inp["model"])(jseq_parallel_config(inp["model"].config, mesh, data_axis="data"))
    loss_fn = jlosses.lm_loss_fn(model)
    batch = {"input_ids": jnp.asarray(inp["ids"])}
    fl = JFlattener(params)
    tangent = fl.unflatten(jnp.asarray(inp["v"]))

    def everything(p):
        loss, grad = jax.value_and_grad(loss_fn)(p, batch)
        hv = jax.jvp(lambda q: jax.grad(loss_fn)(q, batch), (p,), (tangent,))[1]
        return loss, fl.flatten(grad), fl.flatten(hv)

    loss, grad, hv = jax.jit(everything)(params)
    return {"loss": float(loss), "grad": np.asarray(grad), "hvp": np.asarray(hv)}


def _jax_tpsp_lanczos() -> dict:
    """gpt2_tpsp's host-loop spectrum (T only) in the JAX package on the
    same mesh, and the Ritz values of its T."""
    inp = _tpsp_inputs("gpt2_tpsp")
    mesh = jmake_mesh(2, 2)
    params = jshard_for_tp(inp["jax_params"], mesh)
    model = type(inp["model"])(jseq_parallel_config(inp["model"].config, mesh, data_axis="data"))
    batch = {"input_ids": jnp.asarray(inp["ids"])}
    host = jdataset_spectrum_host(jlosses.lm_loss_fn(model), params, [batch], ITERS,
                                  v0=jnp.asarray(inp["v"]))
    return {"alphas": np.asarray(host.alphas), "betas": np.asarray(host.betas),
            "ritz": np.sort(np.asarray(jritz(host).eigvals))}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """``ref(name)``: a case's JAX results, computed once per run and shared
    by the test workers."""
    def ref(name: str) -> dict:
        if name in PIPELINE:
            make = functools.partial(_jax_pipeline, name)
        elif name == "tpsp_lanczos":
            make = _jax_tpsp_lanczos
        else:
            make = functools.partial(_jax_tpsp, name)
        return _shared(tmp_path_factory, f"pipe_jax_{name}", lambda _: make())

    return ref


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    def produce(workdir):
        pipeline = {"dp2xpp2": _pipeline_rank_case("dp2xpp2"),
                    "pp4": _pipeline_rank_case("pp4", iters=PIPE_ITERS)}
        tpsp = {name: _tpsp_rank_case(name) for name in TPSP}
        paths = {"models": {name: _rank_case(name) for name in PATHS_FOUR[0]},
                 "pipeline": {name: pipeline[name] for name in PATHS_FOUR[1]}}
        return run_ranks(f"{RANKS}:pipeline_four", 4, workdir, threads=1, timeout=SPAWN_TIMEOUT,
                         kwargs={"pipeline": pipeline, "tpsp": tpsp,
                                 "lanczos_case": "gpt2_tpsp", "iters": ITERS, "paths": paths})

    return _shared(tmp_path_factory, "pipeline_four", produce)


# ------------------------------------------------------------ in process

def _torch_params(name: str) -> dict:
    return {k: torch.as_tensor(v) for k, v in _pipeline_inputs(name)["params"].items()}


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_stack_round_trip_and_the_jax_layout(stages):
    """Stacking is exact both ways, and its leaves and flat order are the
    JAX package's: the two packages' stacked flat vectors compare element
    by element."""
    params = _torch_params("pp2")
    stacked = stack_pipeline_params(params, 4, stages)
    back = unstack_pipeline_params(stacked)
    assert set(back) == set(params)
    assert all(torch.equal(back[k], params[k]) for k in params)
    assert stacked["blocks.attn.c_attn.kernel"].shape == (stages, 4 // stages, 16, 48)
    jstacked = jstack(_pipeline_inputs("pp2")["jax_params"], 4, stages)
    jflat = np.asarray(JFlattener(jstacked).flatten(jstacked))
    np.testing.assert_array_equal(Flattener(stacked).flatten(stacked).numpy(), jflat)
    names = Flattener(stacked).names
    assert names[0].startswith("blocks.") and names[-4:] == ["ln_f.bias", "ln_f.scale", "wpe",
                                                             "wte"]
    with pytest.raises(ValueError, match="not divisible"):
        stack_pipeline_params(params, 4, 3)


def test_pipeline_param_sharding_matches_the_jax_specs():
    params = _torch_params("pp2_untied_mask")
    stacked = stack_pipeline_params(params, 4, 2)
    layout = pipeline_param_sharding(stacked, Mesh(1, 2, axis_names=("data", "pp")))
    jstacked = jstack(_pipeline_inputs("pp2_untied_mask")["jax_params"], 4, 2)
    jspecs = jpipe_sharding(jstacked, jmake_pipeline_mesh(1, 2))
    flat = jax.tree_util.tree_flatten_with_path(jspecs)[0]
    specs = {".".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
             for path, s in flat}
    assert set(specs) == set(layout) and "lm_head.kernel" in layout
    for name, split in layout.items():
        want = Split(0) if specs[name][:1] == ("pp",) else None
        assert split == want, name
    assert layout["blocks.mlp.c_fc.kernel"] == Split(0) and layout["wte"] is None
    with pytest.raises(ValueError, match="second axis"):
        pipeline_param_sharding(stacked, Mesh(1, 2, axis_names=("data", "pp")), pp_axis="model")


def test_exit_parts():
    assert exit_parts(4, 2, True) == ((0, 2), (2, 4))  # psum_scatter's tiles
    assert exit_parts(5, 2, True) == ((0, 3), (3, 5))
    assert exit_parts(2, 4, True) == ((0, 1), (1, 2), (2, 2), (2, 2))
    assert exit_parts(3, 2, False) == ((0, 3), (0, 3))  # psum's replicas


def _one_rank_case(name: str) -> tuple:
    """A pipeline case's model (its config), params and batch, in process."""
    inp = _pipeline_inputs(name)
    batch = {"input_ids": torch.as_tensor(inp["ids"])}
    if inp["mask"] is not None:
        batch["attention_mask"] = torch.as_tensor(inp["mask"])
    return GPT2LMHead(GPT2Config(**inp["config"])), _torch_params(name), batch


@pytest.mark.parametrize("name", PIPELINE_TWO)
def test_one_stage_without_a_group_is_the_whole_model(name):
    """On a mesh of one rank the pipeline is one stage that runs every
    microbatch: the loss, gradient and HVP of the whole model, for the
    tied head and for the untied one with an attention mask."""
    model, params, batch = _one_rank_case(name)
    fl = Flattener(params)
    v = fl.unflatten(torch.as_tensor(_pipeline_inputs(name)["v"]))
    mesh = make_pipeline_mesh(1, 1)
    assert mesh.shape == {"data": 1, "pp": 1} and mesh.group is None
    loss_fn = make_pipelined_lm_loss(model, mesh, num_microbatches=4)
    stacked = stack_pipeline_params(params, 4, 1)
    loss, grad = grad_and_loss(loss_fn, stacked, batch)
    hv = hvp(loss_fn, stacked, batch, stack_pipeline_params(v, 4, 1))
    whole_fn = losses.lm_loss_fn(model)
    want_loss, want_grad = grad_and_loss(whole_fn, params, batch)
    want_hv = hvp(whole_fn, params, batch, v)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    assert _rel(fl.flatten(unstack_pipeline_params(grad)), fl.flatten(want_grad)) <= REL
    assert _rel(fl.flatten(unstack_pipeline_params(hv)), fl.flatten(want_hv)) <= REL


@pytest.mark.parametrize("name", PIPELINE_TWO)
def test_one_stage_remat_ticks_is_the_plain_pipeline(name):
    """``remat_ticks=True`` (once refused) on a mesh of one rank: the loss,
    gradient and HVP of the plain pipeline within 1e-6, the same products
    recomputed in each tick's backward."""
    model, params, batch = _one_rank_case(name)
    fl = Flattener(params)
    mesh = make_pipeline_mesh(1, 1)
    stacked = stack_pipeline_params(params, 4, 1)
    v = stack_pipeline_params(fl.unflatten(torch.as_tensor(_pipeline_inputs(name)["v"])), 4, 1)
    sfl = Flattener(stacked)
    out = {}
    for remat in (False, True):
        loss_fn = make_pipelined_lm_loss(model, mesh, num_microbatches=4, remat_ticks=remat)
        loss, grad = grad_and_loss(loss_fn, stacked, batch)
        out[remat] = (float(loss), sfl.flatten(grad), sfl.flatten(hvp(loss_fn, stacked, batch, v)))
    assert abs(out[True][0] - out[False][0]) <= 1e-6 * abs(out[False][0])
    assert _rel(out[True][1], out[False][1]) <= 1e-6
    assert _rel(out[True][2], out[False][2]) <= 1e-6


def test_pipeline_apply_remat_ticks_alone():
    """``pipeline_apply(remat_ticks=True)`` on one stage of two tanh
    layers, the activations entering as inputs (no ``input_fn``): the
    plain apply's value, gradients (stage and inputs) and HVP within 1e-6."""
    mesh = make_pipeline_mesh(1, 1)
    gen = torch.Generator().manual_seed(2)
    W, V = (torch.randn(1, 2, 5, 5, generator=gen) / 3 for _ in range(2))
    x = torch.randn(3, 2, 5, generator=gen)

    def stage(bp, h):
        for j in range(bp["w"].shape[0]):
            h = torch.tanh(h @ bp["w"][j])
        return h

    def run(remat):
        def f(w, x):
            return (pipeline_apply(stage, {"w": w}, x, mesh, remat_ticks=remat) ** 2).sum()
        grads = torch.func.grad(f, argnums=(0, 1))(W, x)
        hv = torch.func.jvp(lambda w: torch.func.grad(f)(w, x), (W,), (V,))[1]
        return f(W, x), grads, hv

    (v0, g0, h0), (v1, g1, h1) = run(False), run(True)
    assert abs(float(v1) - float(v0)) <= 1e-6 * abs(float(v0))
    for a, b in list(zip(g1, g0)) + [(h1, h0)]:
        assert _rel(a.reshape(-1), b.reshape(-1)) <= 1e-6


def test_refusals():
    model, params, batch = _one_rank_case("pp2")
    mesh = make_pipeline_mesh(1, 1)
    cfg = model.config
    axis = Mesh(1, 2)
    with pytest.raises(ValueError, match="seq_sharding"):
        make_pipelined_lm_loss(GPT2LMHead(seq_parallel_config(cfg, axis)), mesh,
                               num_microbatches=2)
    with pytest.raises(ValueError, match="model_parallel"):
        make_pipelined_lm_loss(GPT2LMHead(GPT2Config(**PIPE_KW, model_parallel=axis)), mesh,
                               num_microbatches=2)
    per_layer = GPT2LMHead(GPT2Config(**PIPE_KW, block_matmul_precision=(
        "high", "default", "high", "high")))
    with pytest.raises(ValueError, match="uniform"):
        make_pipelined_lm_loss(per_layer, mesh, num_microbatches=2)
    loss_fn = make_pipelined_lm_loss(model, mesh, num_microbatches=3)
    with pytest.raises(ValueError, match="not divisible"):
        loss_fn(stack_pipeline_params(params, 4, 1), batch)
    with pytest.raises(ValueError, match="first axis"):
        make_pipelined_lm_loss(model, mesh, num_microbatches=2, data_axis="model")


# ------------------------------------------------------------ two ranks

@pytest.mark.parametrize("name", PIPELINE_TWO)
def test_pipeline_on_two_stages_matches_jax(two, jax_ref, name):
    ref = jax_ref(name)
    for rank in two:
        _check(rank["result"][name], ref["pipe"])
    _check(ref["pipe"], ref["plain"])  # the JAX pipeline is the JAX model (docstring)


def test_pipeline_remat_ticks_on_two_stages_matches_jax(two, jax_ref):
    """``remat_ticks=True`` (once refused) on the untied, masked case: the
    JAX pipelined loss at the bars and the plain pipeline's loss within
    1e-6, gradient and HVP within 1e-5 on both ranks (each tick's
    recompute issues no collective)."""
    ref = jax_ref("pp2_untied_mask")
    for rank in two:
        _check(rank["result"][PIPELINE_REMAT], ref["pipe"])
        _check(rank["result"][PIPELINE_REMAT], rank["result"]["pp2_untied_mask"])


def test_pipeline_holds_half_of_the_blocks_a_stage(two):
    for i, rank in enumerate(two):
        got = rank["result"]["pp2"]
        assert got["mesh"] == {"data": 1, "pp": 2} and got["index"] == (0, i)
        assert got["round_trip"] and got["split_share"] == 0.5


# ----------------------------------------------------------- four ranks

@pytest.mark.parametrize("name", ["dp2xpp2", "pp4"])
def test_pipeline_on_four_ranks_matches_jax(four, jax_ref, name):
    ref = jax_ref(name)
    stages = PIPELINE[name][0]
    for rank in four:
        got = rank["result"][name]
        _check(got, ref["pipe"])
        assert got["round_trip"] and got["split_share"] == 1 / stages
    _check(ref["pipe"], ref["plain"])


def test_pipeline_lanczos_on_the_pp_axis_matches_jax(four, jax_ref):
    """pp4's Lanczos, its basis on the pipeline axis, against the JAX
    (1, 4) case; the gathered basis orthonormal, its first row the start
    vector (stacked)."""
    want = jax_ref("pp4")["lanczos"]
    inp = _pipeline_inputs("pp4")
    params = {k: torch.as_tensor(v) for k, v in inp["params"].items()}
    v = Flattener(stack_pipeline_params(params, 4, 4)).flatten(stack_pipeline_params(
        Flattener(params).unflatten(torch.as_tensor(inp["v"])), 4, 4)).numpy()
    for rank in four:
        got = rank["result"]["pp4"]
        np.testing.assert_allclose(got["alphas"], want["alphas"], rtol=T_TOL, atol=T_TOL)
        np.testing.assert_allclose(got["betas"], want["betas"], rtol=T_TOL, atol=T_TOL)
        T_got = np.diag(got["alphas"]) + np.diag(got["betas"], 1) + np.diag(got["betas"], -1)
        ritz = np.linalg.eigvalsh(T_got.astype(np.float64))
        assert np.abs(ritz - want["ritz"]).max() <= RITZ_RTOL * np.abs(want["ritz"]).max()
        Q = got["basis"].astype(np.float64)
        np.testing.assert_allclose(Q @ Q.T, np.eye(PIPE_ITERS), atol=T_TOL)
        np.testing.assert_allclose(Q[0], v / np.linalg.norm(v), atol=1e-6)
        assert got["basis_block"][0] == PIPE_ITERS and got["basis_block"][1] % 8 == 0
    np.testing.assert_allclose(want["alphas"], want["plain_alphas"], rtol=T_TOL, atol=T_TOL)


@pytest.mark.parametrize("name", list(TPSP))
def test_tensor_and_sequence_parallel_on_one_axis_matches_jax(four, jax_ref, name):
    assert [r["result"]["grid"] for r in four] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for rank in four:
        got = rank["result"][name]
        _check(got, jax_ref(name))
        assert got["round_trip"] and got["split_share"] == 0.5


def test_tensor_and_sequence_parallel_lanczos_matches_jax(four, jax_ref):
    for rank in four:
        _check_lanczos(rank["result"]["lanczos"], jax_ref("tpsp_lanczos"),
                       _tpsp_inputs("gpt2_tpsp")["v"])


def test_dryrun_pipeline(four):
    dry = [r["result"]["dryrun"] for r in four]
    assert all(d.items() <= dry[0].items() for d in dry[1:])  # rank 0 adds the reference
    d = dry[0]
    assert d["mesh"] == {"data": 2, "pp": 2} and d["batch"] == [8, 16]
    assert d["finite"] and np.isfinite(d["alpha0"])
    assert d["T_diff"] <= T_TOL


@pytest.mark.parametrize("case", ["M3_scatter", "M3_replicate", "M4_scatter", "M4_replicate"])
def test_pipeline_apply_alone(four, case):
    """``pipeline_apply`` over 4 stages with a caller's own stage function:
    3 microbatches (uneven shares, the last stage without any) or 4, the
    exit scattered or replicated; value, gradient and HVP of each stage
    equal to one process's."""
    rows = []
    for rank in four:
        got = rank["result"]["apply"][case]
        assert got["value_rel"] <= LOSS_RTOL, got
        assert max(got["grad_rel"], got["hvp_rel"]) <= REL, got
        rows.append(got["rows"])
    assert rows == ([1, 1, 1, 0] if case.startswith("M3") else [1, 1, 1, 1])


@pytest.mark.parametrize("part", ["primitives", *PATHS_FOUR[0], *PATHS_FOUR[1]])
def test_native_collectives_match_the_padded_ones_on_four_ranks(four, part):
    """At four ranks the native collectives sum in another order than an
    all-reduce: the collectives alone, the models' loss, gradient and HVP
    and the pipeline's Lanczos agree within 1e-6."""
    for rank in four:
        paths = rank["result"]["paths"]
        assert paths["path"] == "native"
        _assert_paths_agree(*paths[part], exact=False, what=part)


def test_torch_func_through_the_native_collectives_on_four_ranks(four):
    for rank in four:
        for calc in rank["result"]["paths"]["calculus"]:
            assert max(calc.values()) <= 1e-6, calc


def test_ranks_import_no_jax(four):
    for r in four:
        assert "jax" not in r["modules"] and "hessian_llm_vision_tpu" not in r["modules"]
