"""Rank functions of ``tests/test_torch_parallel.py`` and
``tests/test_torch_model_parallel.py``.

Each runs on every rank of a gloo group that
``hessian_llm_vision_tpu_torch.parallel.spawn.run_ranks`` starts on the CPU,
and returns numpy arrays and numbers.  This module imports torch, numpy and
the port only (the test reads the ranks' module lists), so the ranks run
without JAX; the test process computes the JAX side.
"""

from __future__ import annotations

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.curvature.operators import MatrixOperator
from hessian_llm_vision_tpu_torch.krylov import deflate, driver
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
from hessian_llm_vision_tpu_torch.krylov.sharded import PShard, p_shard
from hessian_llm_vision_tpu_torch.krylov.thick_restart import lanczos_thick_restart
from hessian_llm_vision_tpu_torch.models import losses
from hessian_llm_vision_tpu_torch.models.mlp import SpiralMLP
from hessian_llm_vision_tpu_torch.ops import kernels
from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import LanczosSGDConfig, make_lanczos_sgd_step
from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import HostLanczosSGDTrainer
from hessian_llm_vision_tpu_torch.parallel import (
    ShardedHessianOperator,
    basis_sharding,
    make_sharded_loss,
    probe_parallel_spectrum_host,
    shard_batch,
    sharded_grad_fn,
)
from hessian_llm_vision_tpu_torch.parallel.dryrun import dryrun_rank
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _gather_rows(rows: torch.Tensor, sh: PShard) -> np.ndarray:
    return np.stack([_np(sh.gather(r.contiguous())) for r in rows])


def _spiral():
    model = SpiralMLP(width=16, depth=2)

    def model_fn(p, b):
        return torch.func.functional_call(model, p, (b["image"],))

    def out_loss(logits, b):
        return losses.softmax_cross_entropy(logits, b["label"])

    return losses.classification_loss_fn(model), model_fn, out_loss


def _spiral_batches(x, y, n=3, rows=32):
    return [{"image": torch.as_tensor(x[i * rows:(i + 1) * rows]),
             "label": torch.as_tensor(y[i * rows:(i + 1) * rows])} for i in range(n)]


def data_parallel(mesh, *, params, x, y, v, v0, trainer_cfg, step_cfg):
    """The data-parallel gradient, HVP (three normalizations), host-loop
    spectrum, host trainer and fused step with a P-sharded basis on the
    spiral MLP, each global batch of ``x, y`` split over the ranks."""
    loss_fn = _spiral()[0]
    fl = Flattener(params)
    batches = _spiral_batches(x, y)
    batch_size = batches[0]["label"].shape[0]
    local = [shard_batch(b, mesh) for b in batches]
    sharded = make_sharded_loss(loss_fn, mesh)
    out = {"rows": int(local[0]["label"].shape[0])}
    loss, grad = sharded_grad_fn(loss_fn, mesh)(params, local[0])
    out["loss"], out["grad"] = float(loss), _np(fl.flatten(grad))
    out["loss_call"] = float(sharded(params, local[0]))
    vt = torch.as_tensor(v)
    n_total = len(batches) * batch_size
    for norm in ("mean", "sum", "dataset"):
        op = ShardedHessianOperator(loss_fn, params, local[0], mesh, normalization=norm,
                                    batch_size=batch_size, dataset_size=n_total)
        out[f"hvp_{norm}"] = _np(op(vt))
    res = driver.dataset_spectrum_host(sharded, params, local, 6, v0=torch.as_tensor(v0),
                                       flattener=fl)
    out["T"] = (_np(res.alphas), _np(res.betas))

    trainer = HostLanczosSGDTrainer(sharded, params, LanczosSGDConfig(**trainer_cfg))
    state = trainer.init({k: p.clone() for k, p in params.items()})
    for i in range(4):
        state, m = trainer.step(state, local[i % len(local)])
    out["trainer"] = {"params": _np(fl.flatten(state.params)), "eigvals": _np(state.eigvals),
                      "loss": float(m["loss"])}

    sh = PShard(basis_sharding(mesh), fl.size)
    init_fn, step_fn = make_lanczos_sgd_step(sharded, params, LanczosSGDConfig(**step_cfg),
                                             basis_sharding=basis_sharding(mesh))
    state = init_fn({k: p.clone() for k, p in params.items()})
    losses_ = []
    for i in range(2):
        state, m = step_fn(state, local[i])
        losses_.append(float(m["loss"]))
    out["fused"] = {"params": _np(fl.flatten(state.params)), "eigvals": _np(state.eigvals),
                    "losses": losses_, "basis": _gather_rows(state.basis, sh),
                    "basis_columns": int(state.basis.shape[1])}
    return out


def _dense(M: np.ndarray) -> MatrixOperator:
    return MatrixOperator(torch.as_tensor(M))


def sharded_basis(mesh, *, lanczos_cases, tr_cases, quad, defl):
    """Lanczos, thick restart (plain and over a dataset loss) and the
    deflated density with the basis split along P; the order of one
    sharded projection's kernel calls and all-reduces; the rank's share of
    ``parallel/dryrun.py::dryrun_multichip``."""
    sb = basis_sharding(mesh)
    out = {"lanczos": {}, "thick_restart": {}}
    for name, (M, v0, iters) in lanczos_cases.items():
        op = _dense(M)
        res = lanczos(op.matvec, op.dim, iters, v0=torch.as_tensor(v0), basis_sharding=sb)
        sh = PShard(sb, op.dim)
        out["lanczos"][name] = {"alphas": _np(res.alphas), "betas": _np(res.betas),
                                "basis": _gather_rows(res.basis, sh),
                                "block": tuple(res.basis.shape)}
    for name, (M, v0, k, inner) in tr_cases.items():
        op = _dense(M)
        res = lanczos_thick_restart(op.matvec, op.dim, k, v0=torch.as_tensor(v0), inner=inner,
                                    basis_sharding=sb)
        sh = PShard(sb, op.dim)
        out["thick_restart"][name] = {
            "eigvals": res.eigvals, "vectors": _gather_rows(res.vectors, sh),
            "block": tuple(res.vectors.shape), "lo": sh.lo, "converged": res.converged,
            "matvecs": res.matvecs, "restarts": res.restarts}

    M, v0, k, inner = quad
    A = torch.as_tensor(M)

    def quad_loss(params, batch):
        p = params["w"]
        return 0.5 * p @ (batch["A"] @ p)

    res = driver.dataset_thick_restart_host(
        quad_loss, {"w": torch.zeros(A.shape[0])}, [{"A": A}], k, v0=torch.as_tensor(v0),
        inner=inner, normalization="mean", precision=None, basis_sharding=sb)
    out["quad"] = {"eigvals": res.eigvals, "converged": res.converged,
                   "block": tuple(res.vectors.shape)}

    M, kw = defl
    op = _dense(M)
    res = deflate.deflated_density(op.matvec, op.dim, kw["k"], kw["moments"],
                                   v0=torch.as_tensor(kw["v0"]),
                                   probes=torch.as_tensor(kw["probes"]), inner=kw["inner"],
                                   lmin=kw["lmin"], lmax=kw["lmax"], basis_sharding=sb)
    out["deflated"] = {"eigvals": res.eigvals, "converged": res.converged,
                       "moments": res.bulk.moments, "center": res.bulk.center,
                       "trace": res.trace_estimate(), "matvecs": res.matvecs}

    # one sharded projection: pass 1, the all-reduce of w, pass 2
    events = []
    dots, axpy, reduce_ = kernels.rank_k_dots, kernels.rank_k_axpy, mesh.sum_
    sh = PShard(sb, 64)
    try:
        kernels.rank_k_dots = lambda *a: events.append("rank_k_dots") or dots(*a)
        kernels.rank_k_axpy = lambda *a, **k: events.append("rank_k_axpy") or axpy(*a, **k)
        object.__setattr__(mesh, "sum_", lambda t, axis: events.append(
            f"all_reduce {tuple(t.shape)}") or reduce_(t, axis))
        rows = torch.eye(64)[:3, sh.lo:sh.lo + sh.width].contiguous()
        g = torch.arange(64, dtype=torch.float32)
        out["projection"] = _np(sh.gather(sh.project_out(sh.part(g), rows)))
    finally:
        kernels.rank_k_dots, kernels.rank_k_axpy = dots, axpy
        object.__delattr__(mesh, "sum_")
    out["events"] = events
    out["dryrun"] = dryrun_rank(mesh)  # parallel/dryrun.py's checks, in this spawn
    return out


def probes(mesh, *, params, x, y, per_probe, v0s, ggn_v0s, cli_argv):
    """Probe-parallel SLQ on the spiral MLP: Hessian and GGN probes from the
    given start vectors, per-probe data, the indivisible-probe error and
    the spectrum CLI's ``--probe_parallel``."""
    loss_fn, model_fn, out_loss = _spiral()
    data = _spiral_batches(x, y)
    as_t = [torch.as_tensor(v) for v in v0s]
    out = {}
    res = probe_parallel_spectrum_host(loss_fn, params, data, 7, n_probes=len(as_t), v0s=as_t,
                                       mesh=mesh, precision="highest")
    out["hessian"] = [(_np(r.alphas), _np(r.betas)) for r in res]
    res = probe_parallel_spectrum_host(
        loss_fn, params, data, 6, n_probes=len(ggn_v0s), mesh=mesh, operator="ggn",
        model_fn=model_fn, out_loss_fn=out_loss, precision="highest",
        v0s=[torch.as_tensor(v) for v in ggn_v0s])
    out["ggn"] = [(_np(r.alphas), _np(r.betas)) for r in res]
    lists = [_spiral_batches(xs, ys) for xs, ys in per_probe]
    res = probe_parallel_spectrum_host(loss_fn, params, data, 6, n_probes=len(lists),
                                       v0s=as_t[:len(lists)], mesh=mesh,
                                       per_probe_batch_lists=lists, precision="highest")
    out["per_probe"] = [(_np(r.alphas), _np(r.betas)) for r in res]
    try:
        probe_parallel_spectrum_host(loss_fn, params, data, 3, n_probes=3,
                                     generator=torch.Generator().manual_seed(0), mesh=mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)

    from hessian_llm_vision_tpu_torch.cli import spectrum

    spec, _ = spectrum.main(cli_argv)
    out["cli_eigvals"] = _np(spec.eigvals)
    return out


# ------------------------------------------------------- the model axis
# (tests/test_torch_model_parallel.py)

def _lm(family: str, cfg_kw: dict, axis=None, mode: str = "tp"):
    """The port's model of ``family`` at ``cfg_kw``, on the model axis of
    ``axis`` by ``mode`` ("tp" and "ep": split leaves; "sp": split tokens;
    "tpsp" and "epsp": both)."""
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.llama import LlamaConfig, LlamaLMHead
    from hessian_llm_vision_tpu_torch.models.pythia import NeoXConfig, NeoXLMHead
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import model_parallel_config
    from hessian_llm_vision_tpu_torch.parallel.seq_parallel import seq_parallel_config

    config_cls, model_cls = {"gpt2": (GPT2Config, GPT2LMHead), "neox": (NeoXConfig, NeoXLMHead),
                             "llama": (LlamaConfig, LlamaLMHead)}[family]
    cfg = config_cls(**cfg_kw)
    if axis is not None:
        if mode != "sp":
            cfg = model_parallel_config(cfg, axis)
        if mode in ("sp", "tpsp", "epsp"):
            cfg = seq_parallel_config(cfg, axis, seq_axis=axis.axis_names[1], data_axis=None)
    return cfg, model_cls(cfg)


def _splits(mode: str, params: dict, axis, cfg) -> dict:
    from hessian_llm_vision_tpu_torch.models.moe import ep_layout
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import tp_layout

    if mode in ("tp", "tpsp"):
        return tp_layout(params, axis, cfg)
    if mode in ("ep", "epsp"):
        return ep_layout(params, axis, ep_axis=axis.axis_names[1])
    return {k: None for k in params}


def _model_axis_case(case: dict, axis, data_mesh=None) -> dict:
    """One case's loss, gradient and HVP on the model axis of ``axis``,
    the gradient and HVP gathered into the JAX package's flat order; with
    ``data_mesh`` (= ``axis``) the batch split over its data axis too."""
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp
    from hessian_llm_vision_tpu_torch.models.convert import gather_model_axis
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params

    params = {k: torch.as_tensor(v) for k, v in case["params"].items()}
    fl = Flattener(params)
    cfg, model = _lm(case["family"], case["config"], axis, case["mode"])
    splits = _splits(case["mode"], params, axis, cfg)
    local = shard_params(params, splits, axis)
    tangent = shard_params(fl.unflatten(torch.as_tensor(case["v"])), splits, axis)
    loss_fn = losses.lm_loss_fn(model, loss_chunk=case.get("chunk"))
    batch = {"input_ids": torch.as_tensor(case["ids"])}
    if data_mesh is not None:
        loss_fn, batch = make_sharded_loss(loss_fn, data_mesh), shard_batch(batch, data_mesh)
    loss, grad = grad_and_loss(loss_fn, local, batch)
    hv = hvp(loss_fn, local, batch, tangent)
    whole = gather_model_axis(local, axis, splits)
    split_bytes = sum(local[k].numel() for k, s in splits.items() if s is not None)
    return {
        "loss": float(loss),
        "grad": _np(fl.flatten(gather_model_axis(grad, axis, splits))),
        "hvp": _np(fl.flatten(gather_model_axis(hv, axis, splits))),
        "round_trip": all(torch.equal(whole[k], params[k]) for k in params),
        "split": sorted(k for k, s in splits.items() if s is not None),
        "split_share": split_bytes / sum(params[k].numel() for k, s in splits.items()
                                         if s is not None) if split_bytes else 0.0,
    }


def _model_axis_lanczos(case: dict, axis, iters: int, data_mesh=None) -> dict:
    """The host-loop T-only spectrum and the reorthogonalised Lanczos with
    the basis on the model axis (split over both axes with ``data_mesh``)
    of a tensor-parallel case, from the JAX start vector ``case["v"]``."""
    from hessian_llm_vision_tpu_torch.models.convert import gather_model_axis
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params
    from hessian_llm_vision_tpu_torch.utils.flatten import ModelAxisLayout

    params = {k: torch.as_tensor(v) for k, v in case["params"].items()}
    fl = Flattener(params)
    cfg, model = _lm(case["family"], case["config"], axis, case["mode"])
    splits = _splits(case["mode"], params, axis, cfg)
    local = shard_params(params, splits, axis)
    layout = ModelAxisLayout(local, splits, axis.num_model, axis.model_index)
    both = basis_sharding(axis, layout)
    v0 = Flattener(local).flatten(shard_params(fl.unflatten(torch.as_tensor(case["v"])), splits,
                                               axis))
    loss_fn = losses.lm_loss_fn(model)
    batches = [{"input_ids": torch.as_tensor(case["ids"])}]
    if data_mesh is not None:
        loss_fn = make_sharded_loss(loss_fn, data_mesh)
        batches = [shard_batch(b, data_mesh) for b in batches]
    host = driver.dataset_spectrum_host(loss_fn, local, batches, iters, v0=v0,
                                        basis_sharding=both)
    res = lanczos(driver.dataset_matvec(loss_fn, local, batches), layout.size, iters, v0=v0,
                  basis_sharding=both)
    sh = p_shard(both, layout.size)
    return {
        "host_alphas": _np(host.alphas), "host_betas": _np(host.betas),
        "alphas": _np(res.alphas), "betas": _np(res.betas),
        "basis_block": list(res.basis.shape), "basis_aligned": res.basis.shape[1] % 8 == 0,
        "basis": np.stack([_np(gather_model_axis(sh.gather(r.contiguous()), axis, layout))
                           for r in res.basis]),
    }


def model_axis_two(mesh, *, cases: dict, lanczos_case: str, iters: int,
                   pipeline: dict, paths: tuple = ((), ())) -> dict:
    """Every case on the model axis of 2 ranks (a 1 x 2 mesh, the EP and
    EP x SP cases on a 1 x 2 ``ep`` mesh), the model-axis Lanczos of
    ``lanczos_case``, the ``pipeline`` cases on a 1 x 2 ``('data', 'pp')``
    mesh (``tests/test_torch_pipeline.py``), and the native collectives
    against the padded ones (``collective_paths``) with the cases and
    pipeline cases that ``paths`` names."""
    from hessian_llm_vision_tpu_torch.models.moe import make_ep_mesh
    from hessian_llm_vision_tpu_torch.parallel.mesh import make_mesh

    axis, ep_axis = make_mesh(1, 2), make_ep_mesh(1, 2)
    out = {"model_index": axis.model_index, "ep_shape": ep_axis.shape}
    for name, case in cases.items():
        out[name] = _model_axis_case(case, ep_axis if case["mode"] in ("ep", "epsp") else axis)
    out["lanczos"] = _model_axis_lanczos(cases[lanczos_case], axis, iters)
    for name, case in pipeline.items():
        out[name] = _pipeline_case(case)
    out["paths"] = collective_paths(2, {k: cases[k] for k in paths[0]},
                                    {k: pipeline[k] for k in paths[1]})
    return out


def model_axis_four(mesh, *, case: dict, iters: int) -> dict:
    """A data 2 x model 2 mesh: the DP x TP loss, gradient and HVP of
    ``case`` (each data rank its half of the batch), the Lanczos with the
    basis split over both axes, and ``parallel/dryrun.py``'s model-axis
    half."""
    from hessian_llm_vision_tpu_torch.parallel.dryrun import dryrun_model_rank
    from hessian_llm_vision_tpu_torch.parallel.mesh import make_mesh

    grid = make_mesh(2, 2)
    return {"shape": grid.shape, "data_index": grid.data_index, "model_index": grid.model_index,
            "case": _model_axis_case(case, grid, data_mesh=grid),
            "lanczos": _model_axis_lanczos(case, grid, iters, data_mesh=grid),
            "dryrun": dryrun_model_rank(mesh)}


# ------------------------------------------------------- the pipeline
# (tests/test_torch_pipeline.py)

def _pipeline_case(case: dict) -> dict:
    """GPT-2 pipelined over ``case["stages"]`` stages of a ``(data,
    stages)`` mesh, ``case["microbatches"]`` microbatches (each split over
    the data axis when it has more than one rank): the loss, the gathered
    gradient and HVP in the stacked tree's flat order (the JAX package's),
    and with ``case["iters"]`` the Lanczos with its basis on the pipeline
    axis, from the plain model's flat vector ``case["v"]``."""
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp
    from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
    from hessian_llm_vision_tpu_torch.models.convert import gather_model_axis
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params
    from hessian_llm_vision_tpu_torch.parallel.pipeline import (
        make_pipeline_mesh,
        make_pipelined_lm_loss,
        pipeline_param_sharding,
        stack_pipeline_params,
    )
    from hessian_llm_vision_tpu_torch.utils.flatten import ModelAxisLayout

    params = {k: torch.as_tensor(v) for k, v in case["params"].items()}
    cfg = GPT2Config(**case["config"])
    S, L = case["stages"], cfg.n_layer
    with torch.device("meta"):
        model = GPT2LMHead(cfg)
    pm = make_pipeline_mesh(case["data"], S)
    stacked = stack_pipeline_params(params, L, S)
    splits = pipeline_param_sharding(stacked, pm)
    local = shard_params(stacked, splits, pm)
    fl, sfl = Flattener(params), Flattener(stacked)
    tangent = shard_params(stack_pipeline_params(fl.unflatten(torch.as_tensor(case["v"])), L, S),
                           splits, pm)
    loss_fn = make_pipelined_lm_loss(model, pm, num_microbatches=case["microbatches"],
                                     data_axis="data" if case["data"] > 1 else None,
                                     remat_ticks=case.get("remat_ticks", False))
    batch = {"input_ids": torch.as_tensor(case["ids"])}
    if case.get("mask") is not None:
        batch["attention_mask"] = torch.as_tensor(case["mask"])
    loss, grad = grad_and_loss(loss_fn, local, batch)
    hv = hvp(loss_fn, local, batch, tangent)
    whole = gather_model_axis(local, pm, splits)
    split_numel = sum(local[k].numel() for k, s in splits.items() if s is not None)
    out = {"mesh": pm.shape, "index": (pm.data_index, pm.model_index), "loss": float(loss),
           "grad": _np(sfl.flatten(gather_model_axis(grad, pm, splits))),
           "hvp": _np(sfl.flatten(gather_model_axis(hv, pm, splits))),
           "round_trip": all(torch.equal(whole[k], stacked[k]) for k in stacked),
           "split_share": split_numel / sum(stacked[k].numel() for k, s in splits.items()
                                            if s is not None)}
    if case.get("iters"):
        layout = ModelAxisLayout(local, splits, pm.num_model, pm.model_index)
        both = basis_sharding(pm, layout)
        op = HessianOperator(loss_fn, local, batch)
        res = lanczos(op.matvec, layout.size, case["iters"], v0=Flattener(local).flatten(tangent),
                      basis_sharding=both)
        sh = p_shard(both, layout.size)
        out.update({
            "alphas": _np(res.alphas), "betas": _np(res.betas),
            "basis_block": list(res.basis.shape),
            "basis": np.stack([_np(gather_model_axis(sh.gather(r.contiguous()), pm, layout))
                               for r in res.basis])})
    return out


def _pipeline_apply_check(M: int, scatter: bool) -> dict:
    """``pipeline_apply`` alone over 4 stages of a tanh layer each, M
    microbatches (3: uneven shares, one stage without any), the exit
    scattered or replicated: a readout of each rank's share of the
    microbatches summed over the axis, its gradient and HVP in this rank's
    stage against the same computation in one process."""
    from hessian_llm_vision_tpu_torch.models.collectives import reduce_from_axis
    from hessian_llm_vision_tpu_torch.parallel.pipeline import (
        exit_parts,
        make_pipeline_mesh,
        pipeline_apply,
    )

    pm = make_pipeline_mesh(1, 4)
    s = pm.model_index
    gen = torch.Generator().manual_seed(M)
    W, V = (torch.randn(4, 1, 3, 3, generator=gen) for _ in range(2))
    x, c = (torch.randn(M, 2, 3, generator=gen) for _ in range(2))
    lo, hi = exit_parts(M, 4, True)[s]  # this rank's share of the readout

    def stage(bp, h):
        return torch.tanh(h @ bp["w"][0])

    def pipelined(w):
        out = pipeline_apply(stage, {"w": w}, x, pm, scatter_outputs=scatter)
        mine = out if scatter else out[lo:hi]
        return reduce_from_axis((mine * c[lo:hi]).sum(), pm, "model")

    def whole(w):
        h = x
        for r in range(4):
            h = torch.tanh(h @ w[r, 0])
        return (h * c).sum()

    grad = torch.func.grad(pipelined)(W[s:s + 1])
    hv = torch.func.jvp(torch.func.grad(pipelined), (W[s:s + 1],), (V[s:s + 1],))[1]
    want_grad = torch.func.grad(whole)(W)
    want_hv = torch.func.jvp(torch.func.grad(whole), (W,), (V,))[1]
    return {"value_rel": abs(float(pipelined(W[s:s + 1])) - float(whole(W)))
            / abs(float(whole(W))),
            "grad_rel": float((grad[0] - want_grad[s]).norm() / want_grad[s].norm()),
            "hvp_rel": float((hv[0] - want_hv[s]).norm() / want_hv[s].norm()),
            "rows": int(hi - lo)}


def pipeline_four(mesh, *, pipeline: dict, tpsp: dict, lanczos_case: str, iters: int,
                  paths: dict = None) -> dict:
    """Four ranks: the ``pipeline`` cases (dp2 x pp2, pp4 with its Lanczos),
    the ``tpsp`` cases (tensor and sequence parallelism on the model axis
    of a data 2 x model 2 mesh, the batch split over the data axis), the
    Lanczos of ``lanczos_case`` with its basis over both axes,
    ``parallel/dryrun.py``'s pipeline part, ``pipeline_apply`` alone, and
    the native collectives against the padded ones on a model axis of 4
    (``collective_paths``, with the model and pipeline cases of ``paths``)."""
    from hessian_llm_vision_tpu_torch.parallel.dryrun import dryrun_pipeline_rank
    from hessian_llm_vision_tpu_torch.parallel.mesh import make_mesh

    out = {name: _pipeline_case(case) for name, case in pipeline.items()}
    grid = make_mesh(2, 2)
    out["grid"] = (grid.data_index, grid.model_index)
    for name, case in tpsp.items():
        out[name] = _model_axis_case(case, grid, data_mesh=grid)
    out["lanczos"] = _model_axis_lanczos(tpsp[lanczos_case], grid, iters, data_mesh=grid)
    out["dryrun"] = dryrun_pipeline_rank(mesh)
    out["apply"] = {f"M{M}_{'scatter' if scatter else 'replicate'}": _pipeline_apply_check(
        M, scatter) for M in (3, 4) for scatter in (True, False)}
    paths = paths or {}
    out["paths"] = collective_paths(4, paths.get("models", {}), paths.get("pipeline", {}))
    return out


# ------------------------------------------- the native and padded paths
# (tests/test_torch_model_parallel.py, tests/test_torch_pipeline.py)

def _padded_too(fn) -> tuple:
    """``(fn(), fn())``: first on the native collectives that gloo runs on
    CPU tensors, then with ``parallel.mesh.native`` answering no, as it does
    on gloo with CUDA tensors (zero-padded all-reduces and broadcasts)."""
    from hessian_llm_vision_tpu_torch.parallel import mesh as mesh_module

    native = fn()
    chooser = mesh_module.native
    mesh_module.native = lambda group, t: False
    try:
        padded = fn()
    finally:
        mesh_module.native = chooser
    return native, padded


def _primitives(axis) -> dict:
    """Each collective of ``models/collectives.py`` and the Krylov gathers
    on the model axis of ``axis``: a gather along every dimension, its
    reduce-scatter, the stage shift, the exit to uneven and equal parts
    and back, ``PShard.gather`` of an uneven P; returns numpy arrays."""
    from hessian_llm_vision_tpu_torch.models import collectives as c
    from hessian_llm_vision_tpu_torch.parallel.mesh import Mesh, Sharding

    n, m = axis.num_model, axis.model_index
    gen = torch.Generator().manual_seed(100 + m)  # each rank its own values
    x = torch.randn(2, 3, 4, generator=gen)
    wide = torch.randn(2 * n, 3, 2 * n, generator=gen)
    out = {}
    for dim in range(3):
        out[f"gather_{dim}"] = _np(c._gather_over_model(x, axis, dim))
        out[f"reduce_scatter_{dim}"] = _np(c._reduce_scatter(
            wide if dim != 1 else torch.randn(2, 3 * n, 4, generator=gen), axis, dim))
    out["shift"] = _np(c._shift(x, axis, tuple((r, r + 1) for r in range(n - 1))))
    stacked = torch.randn(n + 1, 2, 3, generator=gen)
    for name, parts in (("uneven", _uneven(n + 1, n)), ("equal", ((0, n + 1),) * n)):
        out[f"from_last_{name}"] = _np(c._from_last(stacked, axis, parts))
        lo, hi = parts[m]
        out[f"to_last_{name}"] = _np(c._to_last(stacked[lo:hi] + m, axis, parts))
    flat = Mesh(n, 1, m, axis.model_group, data_group=axis.model_group)  # P over these ranks
    sh = PShard(Sharding(flat, (None, "data")), 4 * n - 1)
    out["pshard_gather"] = _np(sh.gather(torch.arange(sh.width, dtype=torch.float32) + 10 * m))
    return out


def _uneven(M: int, S: int) -> tuple:
    from hessian_llm_vision_tpu_torch.parallel.pipeline import exit_parts

    return exit_parts(M, S, True)


def _calculus(axis) -> dict:
    """``torch.func`` grad, jvp and jvp(grad) of a function built from a
    gather along T, a reduce-scatter back to the T-slice, a stage shift and
    a sum over the axis, on each rank's T-slice of ``X``, against the same
    function of the whole ``X`` in one process (rel-L2 of this rank's
    slice)."""
    from hessian_llm_vision_tpu_torch.models import collectives as c

    n, m = axis.num_model, axis.model_index
    gen = torch.Generator().manual_seed(7)  # the same on every rank
    X, V = (torch.randn(2, 2 * n, 3, generator=gen) for _ in range(2))
    W, C = torch.randn(3, 3, generator=gen), torch.randn(2, 2 * n, 3, generator=gen)
    D = torch.randn(n, 2, 2, 3, generator=gen)
    moves = tuple((r, r + 1) for r in range(n - 1))
    mine = slice(2 * m, 2 * m + 2)

    def on_rank(x):
        g = c.gather_from_model(x, axis, 1)
        y = c.reduce_scatter_to_model(torch.tanh(g @ W) * C, axis, 1)
        s = c.shift_stages(y, x.reshape(-1)[0], axis, moves)
        return c.reduce_from_axis((s ** 2 * D[m]).sum(), axis, "model")

    def whole(x):
        y = n * torch.tanh(x @ W) * C  # every rank's copy summed
        return sum((y[:, 2 * (r - 1):2 * r] ** 2 * D[r]).sum() for r in range(1, n))

    grad_fn = torch.func.grad
    got = (grad_fn(on_rank)(X[:, mine]),
           torch.func.jvp(on_rank, (X[:, mine],), (V[:, mine],))[1],
           torch.func.jvp(grad_fn(on_rank), (X[:, mine],), (V[:, mine],))[1])
    want = (grad_fn(whole)(X)[:, mine], torch.func.jvp(whole, (X,), (V,))[1],
            torch.func.jvp(grad_fn(whole), (X,), (V,))[1][:, mine])
    return {name: float((a - b).norm() / b.norm().clamp(min=1e-30))
            for name, a, b in zip(("grad", "jvp", "hvp"), got, want)}


def collective_paths(n: int, model_cases: dict, pipeline_cases: dict) -> dict:
    """The native collectives against the padded ones on a model axis of
    ``n`` ranks: the primitives, ``torch.func`` through them against the
    whole function, and the models of ``model_cases`` (on the mesh each
    names: "ep"/"epsp" on an ``ep`` mesh) and ``pipeline_cases`` (loss,
    gradient and HVP), each run on both paths."""
    from hessian_llm_vision_tpu_torch.models.moe import make_ep_mesh
    from hessian_llm_vision_tpu_torch.parallel.mesh import make_mesh

    axis = make_mesh(1, n)
    ep_axis = make_ep_mesh(1, n)
    out = {"path": axis.collective_path(torch.zeros(1), "model")}
    out["primitives"] = _padded_too(lambda: _primitives(axis))
    out["calculus"] = _padded_too(lambda: _calculus(axis))
    for name, case in model_cases.items():
        on = ep_axis if case["mode"] in ("ep", "epsp") else axis
        out[name] = _padded_too(lambda case=case, on=on: _model_axis_case(case, on))
    for name, case in pipeline_cases.items():
        out[name] = _padded_too(lambda case=case: _pipeline_case(case))
    return out

