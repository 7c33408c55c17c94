"""The port's model axis (tensor, sequence and expert parallelism on
``torch.distributed``) on gloo ranks on the CPU, against the JAX package's
sharded models on its 8-device CPU mesh, on the same numpy inputs and the
JAX params carried over by ``models/convert.py``.

Two spawns: 2 ranks (every TP, SP and EP case on a model axis of 2, and
the Lanczos with its basis on the model axis; the 2-stage pipeline cases
of ``tests/test_torch_pipeline.py`` ride in it) and 4 ranks (a data 2 x
model 2 mesh: the DP x TP case, which catches a data-parallel sum over
every rank, its Lanczos with the basis split over both axes, and
``parallel/dryrun.py``'s model-axis half).  Each spawns once per run with
its own timeout; the test workers share its results through a locked file
in pytest's base temporary directory.  The ranks import torch and the port
only; the JAX side runs here.

Bars: loss 1e-6 relative, gradient and HVP 1e-5 relative, T 1e-4, Ritz
values 1e-3 relative (the JAX package's own bars in
``tests/distributed/test_seq_parallel.py:97-111`` are loss 1e-6, HVP
1e-6 of its norm).
"""

import fcntl
import functools
import os
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hessian_llm_vision_tpu.krylov import ritz_decomposition as jritz
from hessian_llm_vision_tpu.krylov.driver import dataset_spectrum_host as jdataset_spectrum_host
from hessian_llm_vision_tpu.models import losses as jlosses
from hessian_llm_vision_tpu.models.gpt2 import GPT2Config as JGPT2Config
from hessian_llm_vision_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from hessian_llm_vision_tpu.models.llama import LlamaConfig as JLlamaConfig
from hessian_llm_vision_tpu.models.llama import LlamaLMHead as JLlamaLMHead
from hessian_llm_vision_tpu.models.moe import make_ep_mesh as jmake_ep_mesh
from hessian_llm_vision_tpu.models.moe import shard_params_for_ep as jshard_params_for_ep
from hessian_llm_vision_tpu.models.pythia import NeoXConfig as JNeoXConfig
from hessian_llm_vision_tpu.models.pythia import NeoXLMHead as JNeoXLMHead
from hessian_llm_vision_tpu.parallel import make_mesh as jmake_mesh
from hessian_llm_vision_tpu.parallel import seq_parallel_config as jseq_parallel_config
from hessian_llm_vision_tpu.parallel.param_sharding import shard_params_for_tp as jshard_for_tp
from hessian_llm_vision_tpu.parallel.param_sharding import tp_spec_tree as jtp_spec_tree
from hessian_llm_vision_tpu.utils.flatten import Flattener as JFlattener
from hessian_llm_vision_tpu_torch.models.convert import params_from_jax, shard_for_tp
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.models.llama import LlamaConfig
from hessian_llm_vision_tpu_torch.models.moe import make_ep_mesh, moe_param_sharding
from hessian_llm_vision_tpu_torch.models.moe import shard_params_for_ep as shard_params_ep
from hessian_llm_vision_tpu_torch.models.pythia import NeoXConfig
from hessian_llm_vision_tpu_torch.models import collectives
from hessian_llm_vision_tpu_torch.parallel.mesh import Mesh
from hessian_llm_vision_tpu_torch.parallel.param_sharding import (
    Split,
    model_parallel_config,
    shard_leaf,
    tp_layout,
    tp_spec_tree,
    unshard_leaf,
)
from hessian_llm_vision_tpu_torch.parallel.seq_parallel import seq_parallel_config
from hessian_llm_vision_tpu_torch.parallel.spawn import run_ranks

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py"))
SPAWN_TIMEOUT = 300.0
T, ITERS = 16, 6
LOSS_RTOL, REL, T_TOL, RITZ_RTOL = 1e-6, 1e-5, 1e-4, 1e-3

GPT2_KW = dict(vocab_size=256, n_positions=32, n_embd=32, n_layer=2, n_head=2)
NEOX_KW = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
               max_position_embeddings=32)
LLAMA_KW = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_layers=2,
                num_heads=4, num_kv_heads=2, max_position_embeddings=32)
MOE_KW = dict(vocab_size=64, n_positions=T, n_embd=16, n_layer=2, n_head=2, n_experts=4)
#: name -> (family, config, mode, loss chunk); the JAX tests' tiny configs
CASES = {
    "gpt2_tp": ("gpt2", GPT2_KW, "tp", None),
    "neox_tp": ("neox", NEOX_KW, "tp", None),
    "llama_tp": ("llama", LLAMA_KW, "tp", 8),
    "llama_kv1_tp": ("llama", dict(LLAMA_KW, num_kv_heads=1), "tp", None),
    "gpt2_untied_tp": ("gpt2", dict(GPT2_KW, tie_word_embeddings=False), "tp", None),
    "gpt2_sp": ("gpt2", GPT2_KW, "sp", 8),
    "neox_sp": ("neox", NEOX_KW, "sp", None),
    "llama_sp": ("llama", LLAMA_KW, "sp", None),
    "moe_dense_ep": ("gpt2", MOE_KW, "ep", None),
    "moe_top2_ep": ("gpt2", dict(MOE_KW, moe_top_k=2, moe_capacity_factor=2.0), "ep", None),
    "moe_top2_sp": ("gpt2", dict(MOE_KW, moe_top_k=2, moe_capacity_factor=2.0), "sp", None),
    # expert and sequence parallelism on one axis, held to the unsharded JAX model
    "moe_dense_epsp": ("gpt2", MOE_KW, "epsp", None),
    "moe_top2_epsp": ("gpt2", dict(MOE_KW, moe_top_k=2, moe_capacity_factor=2.0), "epsp", None),
    # query blocks and loss chunks, both rematerialised, on a vocab-split head
    "gpt2_tp_remat": ("gpt2", dict(GPT2_KW, attn_block_q=8), "tp", 8),
}
#: the JAX pipeline tests' GPT-2 (``tests/distributed/test_pipeline.py:31``)
PIPE_KW = dict(vocab_size=64, n_positions=T, n_embd=16, n_layer=4, n_head=2)
#: name -> (stages, data ranks, microbatches, config overrides, attention
#: mask); the JAX fast suite's pp2 and dp2 x pp2 cases and its (1, 4) mesh
PIPELINE = {
    "pp2": (2, 1, 2, {}, False),
    "pp2_untied_mask": (2, 1, 4, {"tie_word_embeddings": False}, True),
    "dp2xpp2": (2, 2, 4, {}, False),
    "pp4": (4, 1, 4, {}, False),
}
PIPELINE_TWO = ("pp2", "pp2_untied_mask")  # in the 2-rank spawn
PIPELINE_REMAT = "pp2_untied_mask_remat_ticks"  # the second, remat_ticks=True, in it too
#: the cases run on both collective paths in the 2-rank spawn, one a kind:
#: EP x SP top-2 (the T-slices' gathers, the combine's reduce-scatter) and
#: the pipeline (the shifts and the exit)
PATHS_TWO = (("moe_top2_epsp",), ("pp2",))
_JAX = {"gpt2": (JGPT2Config, JGPT2LMHead), "neox": (JNeoXConfig, JNeoXLMHead),
        "llama": (JLlamaConfig, JLlamaLMHead)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _init(family: str, kw: tuple) -> tuple:
    """The JAX model of a config and params in its tree (cases of one config
    share them), drawn with numpy: LayerNorm and RMSNorm scales near 1,
    embeddings and biases N(0, 0.02), kernels N(0, 1/fan_in).  Only the
    tree's shapes come from the JAX model (``jax.eval_shape``: no compile)."""
    config_cls, model_cls = _JAX[family]
    model = model_cls(config_cls(**dict(kw)))
    shapes = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0), seq_len=T))
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return jnp.asarray(1.0 + 0.1 * z)
        if name == "bias" or len(leaf.shape) == 1 or name in ("wte", "wpe", "embed_in",
                                                              "embed_tokens"):
            return jnp.asarray(0.02 * z)
        return jnp.asarray(z / np.sqrt(leaf.shape[-2]))

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _inputs(name: str) -> dict:
    """A case's JAX model and params, and the numpy inputs that the ranks
    get: the params under the port's names, 4 sequences of T tokens and a
    tangent in the JAX flat order."""
    family, kw, mode, chunk = CASES[name]
    model, params = _init(family, tuple(sorted(kw.items())))
    size = JFlattener(params).size
    ids = np.random.RandomState(3).randint(0, kw["vocab_size"], size=(4, T))
    v = np.random.RandomState(4).standard_normal(size).astype(np.float32)
    return {"family": family, "config": kw, "mode": mode, "chunk": chunk, "model": model,
            "jax_params": params, "ids": ids, "v": v,
            "params": {k: t.numpy() for k, t in params_from_jax(params).items()}}


def _rank_case(name: str, **extra) -> dict:
    inp = _inputs(name)
    return {k: inp[k] for k in ("family", "config", "mode", "chunk", "params", "ids", "v")} | extra


@functools.lru_cache(maxsize=None)
def _pipeline_inputs(name: str) -> dict:
    """A pipeline case's JAX model and params and the numpy inputs that the
    ranks get: 8 sequences of T tokens (an attention mask with two padded
    tails where the case has one) and a tangent in the plain model's JAX
    flat order."""
    stages, data, micro, over, masked = PIPELINE[name]
    kw = dict(PIPE_KW, **over)
    model, params = _init("gpt2", tuple(sorted(kw.items())))
    ids = np.random.RandomState(5).randint(0, kw["vocab_size"], size=(8, T))
    mask = None
    if masked:
        mask = np.ones_like(ids)
        mask[1, 10:] = 0
        mask[6, 4:] = 0
    v = np.random.RandomState(6).standard_normal(JFlattener(params).size).astype(np.float32)
    return {"config": kw, "stages": stages, "data": data, "microbatches": micro, "ids": ids,
            "mask": mask, "v": v, "model": model, "jax_params": params,
            "params": {k: t.numpy() for k, t in params_from_jax(params).items()}}


def _pipeline_rank_case(name: str, **extra) -> dict:
    inp = _pipeline_inputs(name)
    keys = ("config", "stages", "data", "microbatches", "ids", "mask", "v", "params")
    return {k: inp[k] for k in keys} | extra


#: the NeoX and LLaMA sequence-parallel cases are held to the JAX package's
#: tensor-parallel run of the same params and inputs, and the top-2 MoE's to
#: its expert-parallel run (each of its compiles costs about 10 s here; its
#: own tests pin SP, TP and unsharded together, and the JAX package computes
#: the same function whatever the sharding)
_SAME_FUNCTION = {"neox_sp": "neox_tp", "llama_sp": "llama_tp", "moe_top2_sp": "moe_top2_ep",
                  "gpt2_tp_remat": "gpt2_tp"}


def _jax_sharded(name: str) -> dict:
    """The JAX package's loss, gradient and HVP of a case, its model and
    params sharded as the case says on the 8-device mesh (data 4 x model 2,
    or data 4 x ep 2); "epsp" cases unsharded."""
    inp = _inputs(name)
    model, params, mode = inp["model"], inp["jax_params"], inp["mode"]
    if mode == "tp":
        params = jshard_for_tp(params, jmake_mesh(4, 2))
    elif mode == "ep":
        params = jshard_params_for_ep(params, jmake_ep_mesh(4, 2))
    elif mode != "epsp":
        model = type(model)(jseq_parallel_config(model.config, jmake_mesh(4, 2),
                                                 data_axis="data"))
    loss_fn = jlosses.lm_loss_fn(model, loss_chunk=inp["chunk"])
    batch = {"input_ids": jnp.asarray(inp["ids"])}
    fl = JFlattener(params)
    tangent = fl.unflatten(jnp.asarray(inp["v"]))

    def everything(p):
        loss, grad = jax.value_and_grad(loss_fn)(p, batch)
        hv = jax.jvp(lambda q: jax.grad(loss_fn)(q, batch), (p,), (tangent,))[1]
        return loss, fl.flatten(grad), fl.flatten(hv)

    loss, grad, hv = jax.jit(everything)(params)
    return {"loss": float(loss), "grad": np.asarray(grad), "hvp": np.asarray(hv)}


def _jax_lanczos() -> dict:
    """gpt2_tp's host-loop spectrum (T only) in the JAX package, its params
    tensor-parallel on the 8-device mesh, and the Ritz values of its T."""
    inp = _inputs("gpt2_tp")
    params = jshard_for_tp(inp["jax_params"], jmake_mesh(4, 2))
    loss_fn = jlosses.lm_loss_fn(inp["model"])
    batch = {"input_ids": jnp.asarray(inp["ids"])}
    host = jdataset_spectrum_host(loss_fn, params, [batch], ITERS, v0=jnp.asarray(inp["v"]))
    return {"alphas": np.asarray(host.alphas), "betas": np.asarray(host.betas),
            "ritz": np.sort(np.asarray(jritz(host).eigvals))}


def _shared(factory, name: str, produce):
    """``produce(workdir)`` once per test run, its result shared by every
    test worker through a locked file (a failure is shared too)."""
    root = factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, above every worker's
    out, lock = root / f"torch_model_axis_{name}.pt", root / f"torch_model_axis_{name}.lock"
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        if not out.exists():
            try:
                saved = {"ranks": produce(root / f"torch_model_axis_{name}")}
            except Exception:  # every test of the group reports the spawn's failure
                saved = {"error": traceback.format_exc()}
            torch.save(saved, out)
        saved = torch.load(out, weights_only=False)
    if "error" in saved:
        pytest.fail(saved["error"])
    return saved["ranks"]


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """``ref(name)``: a case's JAX results ("lanczos": the host loop's),
    computed once per run and shared by the test workers."""
    def ref(name: str) -> dict:
        name = _SAME_FUNCTION.get(name, name)
        make = _jax_lanczos if name == "lanczos" else functools.partial(_jax_sharded, name)
        return _shared(tmp_path_factory, f"jax_{name}", lambda _: make())

    return ref


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    def produce(workdir):
        cases = {name: _rank_case(name) for name in CASES}
        pipeline = {name: _pipeline_rank_case(name) for name in PIPELINE_TWO}
        pipeline[PIPELINE_REMAT] = _pipeline_rank_case("pp2_untied_mask", remat_ticks=True)
        return run_ranks(f"{RANKS}:model_axis_two", 2, workdir, threads=1,
                         timeout=SPAWN_TIMEOUT, kwargs={"cases": cases, "lanczos_case": "gpt2_tp",
                                                        "iters": ITERS, "pipeline": pipeline,
                                                        "paths": PATHS_TWO})

    return _shared(tmp_path_factory, "two", produce)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    def produce(workdir):
        return run_ranks(f"{RANKS}:model_axis_four", 4, workdir, threads=1,
                         timeout=SPAWN_TIMEOUT, kwargs={"case": _rank_case("gpt2_tp"),
                                                        "iters": ITERS})

    return _shared(tmp_path_factory, "four", produce)


def _check(got: dict, want: dict) -> None:
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert _rel(got["grad"], want["grad"]) <= REL
    assert _rel(got["hvp"], want["hvp"]) <= REL


def _check_lanczos(got: dict, want: dict, v: np.ndarray) -> None:
    """The port's host loop and its reorthogonalised Lanczos with the basis
    on the model axis against the JAX host loop; the gathered basis
    orthonormal, its first row the start vector."""
    for a in ("host_alphas", "alphas"):
        np.testing.assert_allclose(got[a], want["alphas"], rtol=T_TOL, atol=T_TOL)
    for b in ("host_betas", "betas"):
        np.testing.assert_allclose(got[b], want["betas"], rtol=T_TOL, atol=T_TOL)
    T_got = np.diag(got["alphas"]) + np.diag(got["betas"], 1) + np.diag(got["betas"], -1)
    ritz = np.linalg.eigvalsh(T_got.astype(np.float64))
    assert np.abs(ritz - want["ritz"]).max() <= RITZ_RTOL * np.abs(want["ritz"]).max()
    Q = got["basis"].astype(np.float64)
    np.testing.assert_allclose(Q @ Q.T, np.eye(ITERS), atol=T_TOL)
    np.testing.assert_allclose(Q[0], v / np.linalg.norm(v), atol=1e-6)
    assert got["basis_aligned"]


# ------------------------------------------------------------ in process

def _spec_map(jspecs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", k)) for k in path): tuple(s) for path, s in flat}


@pytest.mark.parametrize("name", ["gpt2_tp", "llama_tp"])
def test_tp_specs_hit_the_jax_leaves(name):
    """Every leaf's spec is the JAX package's (``tests/distributed/
    test_tensor_parallel.py:24-34,89-104`` pin the same leaves)."""
    inp = _inputs(name)
    specs = tp_spec_tree(inp["params"])
    assert specs == _spec_map(jtp_spec_tree(inp["jax_params"]))
    if name == "gpt2_tp":
        assert specs["h_0.attn.c_attn.kernel"] == (None, "model")
        assert specs["h_0.attn.c_proj.kernel"] == ("model", None)
        assert specs["wte"] == ("model", None) and specs["ln_f.scale"] == ()
    else:
        for leaf, spec in (("q_proj", (None, "model")), ("k_proj", (None, "model")),
                           ("o_proj", ("model", None))):
            assert specs[f"layer_0.self_attn.{leaf}.kernel"] == spec
        assert specs["layer_0.mlp.gate_proj.kernel"] == (None, "model")
        assert specs["layer_0.mlp.down_proj.kernel"] == ("model", None)
        assert specs["embed_tokens"] == ("model", None)
        assert specs["lm_head.kernel"] == (None, "model")
        assert specs["layer_0.input_layernorm.scale"] == ()


@pytest.mark.parametrize("n", [2, 4])
def test_per_head_split_round_trips(n):
    """Each rank holds the q, k and v columns of its own heads; the ranks'
    slices give back the flax layout bit for bit."""
    cfg = GPT2Config.tiny(n_head=4)
    params = {k: p.detach() for k, p in GPT2LMHead(cfg).named_parameters()}
    layout = tp_layout(params, Mesh(1, n), cfg)
    assert layout["h_0.attn.c_attn.kernel"] == Split(1, 3)
    assert layout["h_0.attn.c_attn.bias"] == Split(0, 3)
    assert layout["h_0.attn.c_proj.bias"] is None
    C, per = cfg.n_embd, cfg.n_embd // n
    for name, split in layout.items():
        parts = [shard_leaf(params[name], split, m, n) for m in range(n)]
        assert torch.equal(unshard_leaf(parts, split), params[name])
    kernel = params["h_1.attn.c_attn.kernel"]
    for m in range(n):
        mine = shard_leaf(kernel, layout["h_1.attn.c_attn.kernel"], m, n)
        want = torch.cat([kernel[:, j * C + m * per:j * C + (m + 1) * per] for j in range(3)], 1)
        assert torch.equal(mine, want)


def test_leaves_stay_whole_where_they_do_not_divide():
    with torch.device("meta"):
        gpt2 = {k: p for k, p in GPT2LMHead(GPT2Config()).named_parameters()}
    layout = tp_layout(gpt2, Mesh(1, 2), GPT2Config())
    assert layout["wte"] is None  # a vocabulary of 50257
    assert layout["h_0.attn.c_attn.kernel"] == Split(1, 3)
    assert layout["h_0.mlp.c_proj.kernel"] == Split(0)
    tiny = {k: p.detach() for k, p in GPT2LMHead(GPT2Config.tiny()).named_parameters()}
    by_four = tp_layout(tiny, Mesh(1, 4), GPT2Config.tiny())  # 2 heads over 4 ranks
    assert by_four["h_0.attn.c_attn.kernel"] is None and by_four["h_0.attn.c_proj.kernel"] is None
    assert by_four["h_0.mlp.c_fc.kernel"] == Split(1) and by_four["wte"] == Split(0)
    llama = {k: torch.empty(t.shape) for k, t in _inputs("llama_kv1_tp")["params"].items()}
    kv1 = tp_layout(llama, Mesh(1, 2), LlamaConfig(**CASES["llama_kv1_tp"][1]))
    assert kv1["layer_0.self_attn.q_proj.kernel"] == Split(1)
    assert kv1["layer_0.self_attn.k_proj.kernel"] is None
    assert kv1["layer_0.self_attn.v_proj.kernel"] is None
    whole = shard_for_tp({k: torch.as_tensor(v) for k, v in _inputs("gpt2_tp")["params"].items()},
                         Mesh(1), GPT2Config(**GPT2_KW))
    assert all(torch.equal(whole[k], torch.as_tensor(v))
               for k, v in _inputs("gpt2_tp")["params"].items())


def test_tensor_and_sequence_parallel_on_one_axis_are_refused():
    """What stays refused on the model axis: the sequence on the data axis,
    and tensor and sequence parallelism over two different meshes (tensor
    and sequence parallelism on one axis run: ``tests/test_torch_pipeline.py``;
    expert and sequence parallelism on one axis run too, and give this
    rank's T-slice of the logits)."""
    axis = Mesh(1, 2)
    with pytest.raises(ValueError, match="model axis"):
        seq_parallel_config(GPT2Config.tiny(), axis, seq_axis="data")
    for cfg in (GPT2Config.tiny(), NeoXConfig.tiny(), LlamaConfig.tiny()):
        both = seq_parallel_config(model_parallel_config(cfg, axis), axis)
        assert both.model_parallel is axis and both.seq_sharding.mesh is axis
        with pytest.raises(ValueError, match="one mesh"):
            seq_parallel_config(model_parallel_config(cfg, axis), Mesh(1, 2))
    inp = _inputs("moe_top2_ep")
    ep = Mesh(1, 2, axis_names=("data", "ep"))
    cfg = seq_parallel_config(model_parallel_config(GPT2Config(**inp["config"]), ep), ep,
                              seq_axis="ep")
    params = {k: torch.as_tensor(v) for k, v in inp["params"].items()}
    with torch.device("meta"):
        model = GPT2LMHead(cfg)
    experts = shard_params_ep(params, ep)
    logits = torch.func.functional_call(model, experts, (torch.as_tensor(inp["ids"]),))
    assert logits.shape == (4, T // 2, inp["config"]["vocab_size"])
    assert torch.isfinite(logits).all()


def test_expert_specs_and_the_ep_mesh_without_a_group():
    inp = _inputs("moe_dense_ep")
    mesh = make_ep_mesh(1, 1)
    assert mesh.shape == {"data": 1, "ep": 1} and mesh.model_group is None
    specs = moe_param_sharding(inp["params"], Mesh(1, 2, axis_names=("data", "ep")))
    assert specs["h_0.moe.w1"] == ("ep", None, None) and specs["h_1.moe.b2"] == ("ep", None)
    assert specs["h_0.moe.gate.kernel"] == () and specs["wte"] == ()


def test_collectives_on_one_rank_are_identities_twice_differentiated():
    """On a mesh without a group every collective is the identity (a
    gather of one part), and jvp(grad(.)) passes through all three."""
    mesh = Mesh(1)
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))

    def f(z):
        y = collectives.copy_to_model(z, mesh) * z
        y = collectives.gather_from_model(collectives.reduce_from_model(y, mesh), mesh, 1)
        return (y ** 2).sum()

    t = torch.ones_like(x)
    hv = torch.func.jvp(torch.func.grad(f), (x,), (t,))[1]
    assert torch.allclose(hv, 12 * x * x * t)
    ll = collectives.vocab_parallel_log_likelihood(x, torch.tensor([0, 1, 2]), mesh)
    assert torch.allclose(ll, torch.log_softmax(x, -1)[torch.arange(3), torch.tensor([0, 1, 2])])


# ------------------------------------------------------------ two ranks

@pytest.mark.parametrize("name", list(CASES))
def test_model_axis_matches_jax(two, jax_ref, name):
    for rank in two:
        _check(rank["result"][name], jax_ref(name))


def test_model_axis_round_trips_and_halves(two):
    for rank in two:
        for name, mode in ((n, c[2]) for n, c in CASES.items()):
            got = rank["result"][name]
            assert got["round_trip"], name
            if mode == "sp":
                assert got["split"] == [] and got["split_share"] == 0.0
            else:
                assert got["split"] and got["split_share"] == 0.5, name
    kv1 = two[0]["result"]["llama_kv1_tp"]["split"]
    assert "layer_0.self_attn.q_proj.kernel" in kv1
    assert "layer_0.self_attn.k_proj.kernel" not in kv1


def test_model_axis_remat_is_the_plain_model_axis(two):
    """Rematerialised query blocks and loss chunks on the model axis, the
    chunks' log-softmax sums over a vocab-split head issued again in each
    recompute: the plain tensor-parallel model's loss within 1e-6 and its
    gradient and HVP within 1e-5 on every rank (and the JAX package's,
    through ``test_model_axis_matches_jax``)."""
    for rank in two:
        _check(rank["result"]["gpt2_tp_remat"], rank["result"]["gpt2_tp"])


def test_model_axis_lanczos_matches_jax(two, jax_ref):
    for rank in two:
        _check_lanczos(rank["result"]["lanczos"], jax_ref("lanczos"), _inputs("gpt2_tp")["v"])


def test_expert_and_sequence_parallel_on_one_axis_hold_half_the_experts(two):
    for rank in two:
        for name in ("moe_dense_epsp", "moe_top2_epsp"):
            got = rank["result"][name]
            assert got["split_share"] == 0.5 and got["round_trip"], name
            assert all(".moe." in k for k in got["split"]), name


def _assert_paths_agree(native, padded, exact: bool, what: str) -> None:
    if isinstance(native, dict):
        assert native.keys() == padded.keys(), what
        for k in native:
            _assert_paths_agree(native[k], padded[k], exact, f"{what}.{k}")
    elif isinstance(native, np.ndarray):
        if exact:
            np.testing.assert_array_equal(native, padded, err_msg=what)
        else:
            np.testing.assert_allclose(native, padded, rtol=1e-6, atol=1e-6, err_msg=what)
    elif isinstance(native, float):
        assert native == padded if exact else abs(native - padded) <= 1e-6 * max(1.0, abs(
            padded)), what
    else:
        assert native == padded, what


@pytest.mark.parametrize("part", ["primitives", *PATHS_TWO[0], *PATHS_TWO[1]])
def test_native_collectives_equal_the_padded_ones_on_two_ranks(two, part):
    """On gloo CPU ranks the native all-gather, reduce-scatter and paired
    send/receive give what the all-reduces of zero-padded blocks and the
    broadcasts give (the path gloo takes on CUDA tensors), bit for bit:
    the collectives alone and the models' loss, gradient and HVP."""
    for rank in two:
        paths = rank["result"]["paths"]
        assert paths["path"] == "native"
        _assert_paths_agree(*paths[part], exact=True, what=part)


def test_torch_func_through_the_native_collectives_on_two_ranks(two):
    """grad, jvp and jvp(grad) through a gather, a reduce-scatter, a stage
    shift and a sum, on each path, against the whole function."""
    for rank in two:
        for calc in rank["result"]["paths"]["calculus"]:
            assert max(calc.values()) <= 1e-6, calc


def test_ranks_import_no_jax(two, four):
    for r in two + four:
        assert "jax" not in r["modules"] and "hessian_llm_vision_tpu" not in r["modules"]
    assert [r["result"]["model_index"] for r in two] == [0, 1]


# ----------------------------------------------------------- four ranks

def test_data_by_tensor_parallel_matches_jax(four, jax_ref):
    assert [(r["result"]["data_index"], r["result"]["model_index"]) for r in four] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for rank in four:
        assert rank["result"]["shape"] == {"data": 2, "model": 2}
        _check(rank["result"]["case"], jax_ref("gpt2_tp"))


def test_data_by_tensor_parallel_lanczos_matches_jax(four, jax_ref):
    for rank in four:
        _check_lanczos(rank["result"]["lanczos"], jax_ref("lanczos"), _inputs("gpt2_tp")["v"])


def test_dryrun_model_axis(four):
    dry = [r["result"]["dryrun"] for r in four]
    assert all(d.items() <= dry[0].items() for d in dry[1:])  # rank 0 adds the references
    d = dry[0]
    assert d["mesh"] == {"data": 2, "model": 2} and d["ep_mesh"] == {"data": 2, "ep": 2}
    assert d["split_leaves"] > 0 and d["step_basis_columns"] % 8 == 0
    assert d["step_eig_max_rel"] <= RITZ_RTOL and d["step_params_rel"] <= REL
    assert d["trainer_params_rel"] <= REL and np.isfinite(d["trainer_loss"])
    for key in ("host_loop_T_diff", "seq_parallel_T_diff", "ep_T_diff"):
        assert d[key] <= T_TOL, key  # of the largest entry of T
    assert d["ep_ritz_rel"] <= RITZ_RTOL
