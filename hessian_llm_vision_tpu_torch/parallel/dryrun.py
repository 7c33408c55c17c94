"""The parallel axes on n CPU ranks, one line of summary (the JAX package's
``__graft_entry__.py::dryrun_multichip``).

``dryrun_multichip(n)`` spawns n gloo ranks on the CPU (``parallel/spawn.py``),
or with ``backend="nccl"`` one NCCL rank per card, each rank's models and
batches on its card; :func:`multichip_line` prints the JAX package's line
(its keys: loss, eig_max, hostloop, seqparallel, probe_parallel, pipeline,
moe_ep).
The data axis (:func:`dryrun_rank`): on a tiny GPT-2 with one global batch
of 2n sequences, the data-parallel loss, gradient and HVP (held to one
process on the whole batch), thick restart with the basis split along P,
probe-parallel SLQ (held to the probes run in turn) and one fused
LanczosSGD step with a P-sharded basis.  The model axis
(:func:`dryrun_model_rank`, on n >= 4 even ranks, as the JAX function
takes a model axis of 2 there): on a data n/2 x model 2 mesh, tensor-
parallel params with a data-parallel loss and the basis split over both
axes (a fused LanczosSGD step, the host-loop spectrum, two steps of the
host trainer), the sequence-parallel host-loop spectrum at batch size 1,
and Lanczos through the expert-parallel MoE GPT-2, each held to one
process on the whole model.  The pipeline (:func:`dryrun_pipeline_rank`,
on every n): 2 stages when n is even, else 1, the rest of the ranks on the
data axis; a 3-iteration Lanczos on the Hessian of the pipelined loss
(2 microbatches, each split over the data axis), its basis on the
pipeline axis, held to one process on the whole model.

    python -c "from hessian_llm_vision_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import dataclasses
import json
import tempfile

import numpy as np
import torch

SEQ, VOCAB = 16, 256


def _device() -> torch.device:
    """This rank's card on a NCCL group (``parallel/dist_init.py`` made it
    current), else the CPU."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.clamp(torch.linalg.vector_norm(b),
                                                                min=1e-30))


def dryrun_rank(mesh) -> dict:
    """One rank's share of :func:`dryrun_multichip`; the same numbers on
    every rank."""
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
    from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
    from hessian_llm_vision_tpu_torch.krylov.driver import (
        dataset_spectrum_host,
        dataset_thick_restart_host,
    )
    from hessian_llm_vision_tpu_torch.models import losses
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import (
        LanczosSGDConfig,
        make_lanczos_sgd_step,
    )
    from hessian_llm_vision_tpu_torch.parallel.hvp_sharded import (
        ShardedHessianOperator,
        make_sharded_loss,
    )
    from hessian_llm_vision_tpu_torch.parallel.mesh import basis_sharding, shard_batch
    from hessian_llm_vision_tpu_torch.parallel.probe_parallel import (
        probe_parallel_spectrum_host,
    )
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    n = mesh.num_data
    cfg = GPT2Config(vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    dev = _device()
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0))
    params = {k: p.detach().to(dev) for k, p in model.named_parameters()}
    loss_fn = losses.lm_loss_fn(model)
    fl = Flattener(params)
    ids = np.random.RandomState(1).randint(0, VOCAB, size=(2 * n, SEQ))
    batches = [{"input_ids": torch.as_tensor(ids, device=dev)}]
    local = [shard_batch(b, mesh) for b in batches]
    sharded = make_sharded_loss(loss_fn, mesh)

    loss_1, grad_1 = grad_and_loss(loss_fn, params, batches[0])
    loss_n, grad_n = grad_and_loss(sharded, params, local[0])
    v = torch.randn(fl.size, generator=torch.Generator().manual_seed(2)).to(dev)
    hv_1 = HessianOperator(loss_fn, params, batches[0])(v)
    hv_n = ShardedHessianOperator(loss_fn, params, local[0], mesh)(v)

    tr_kw = dict(v0=v, inner=8, normalization="mean", precision="high", flattener=fl)
    tr_1 = dataset_thick_restart_host(loss_fn, params, batches, 2, **tr_kw)
    tr_n = dataset_thick_restart_host(sharded, params, local, 2,
                                      basis_sharding=basis_sharding(mesh), **tr_kw)

    probes = probe_parallel_spectrum_host(
        loss_fn, params, batches, 4, n_probes=n, mesh=mesh,
        generator=torch.Generator().manual_seed(3))
    draws = torch.Generator().manual_seed(3)
    seq = [dataset_spectrum_host(loss_fn, params, batches, 4,
                                 v0=torch.randn(fl.size, generator=draws).to(dev))
           for _ in range(n)]

    step_cfg = LanczosSGDConfig(k=2, delta=1.0, lr=1e-2, normalization="mean")
    init_fn, step_fn = make_lanczos_sgd_step(sharded, params, step_cfg,
                                             basis_sharding=basis_sharding(mesh))
    state, metrics = step_fn(init_fn({k: p.clone() for k, p in params.items()}), local[0])
    return {
        "ranks": n,
        "params": fl.size,
        "probe_parallel": f"{n}x4iters",
        "loss_rel": abs(float(loss_n) - float(loss_1)) / abs(float(loss_1)),
        "grad_rel": _rel(fl.flatten(grad_n), fl.flatten(grad_1)),
        "hvp_rel": _rel(hv_n, hv_1),
        "thick_restart_eigvals": [float(e) for e in tr_n.eigvals],
        "thick_restart_rel": float(np.max(np.abs(tr_n.eigvals - tr_1.eigvals)
                                          / np.abs(tr_1.eigvals))),
        "thick_restart_converged": bool(tr_n.converged),
        "probe_parallel_T_diff": max(float((p.alphas - s.alphas).abs().max())
                                     for p, s in zip(probes, seq)),
        "lanczos_sgd_step_loss": float(metrics["loss"]),
        "lanczos_sgd_step_eig_max": float(metrics["eig_max"]),
        "lanczos_sgd_basis_columns": int(state.basis.shape[1]),
    }


def _t_diff(a, b) -> float:
    """The largest difference of two tridiagonals' entries, relative to the
    largest entry of ``b``."""
    scale = max(float(b.alphas.abs().max()), float(b.betas.abs().max()))
    return max(float((a.alphas - b.alphas).abs().max()),
               float((a.betas - b.betas).abs().max())) / scale


def _ritz_rel(a, b) -> float:
    from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition

    ea, eb = (np.sort(ritz_decomposition(r).eigvals.numpy()) for r in (a, b))
    return float(np.abs(ea - eb).max() / np.abs(eb).max())


def dryrun_model_rank(mesh) -> dict:
    """One rank's share of the model-axis half of :func:`dryrun_multichip`
    on the ranks of ``mesh`` (an even number, at least 4).  Rank 0 alone
    runs the one-process references and reports the differences; every
    rank reports the sharded runs' numbers."""
    from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
    from hessian_llm_vision_tpu_torch.krylov.driver import dataset_spectrum_host
    from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
    from hessian_llm_vision_tpu_torch.models import losses
    from hessian_llm_vision_tpu_torch.models.convert import gather_model_axis
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.moe import ep_layout, make_ep_mesh
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import (
        LanczosSGDConfig,
        make_lanczos_sgd_step,
    )
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import HostLanczosSGDTrainer
    from hessian_llm_vision_tpu_torch.parallel.hvp_sharded import make_sharded_loss
    from hessian_llm_vision_tpu_torch.parallel.mesh import basis_sharding, make_mesh, shard_batch
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import (
        model_parallel_config,
        shard_params,
        tp_layout,
    )
    from hessian_llm_vision_tpu_torch.parallel.seq_parallel import seq_parallel_config
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener, ModelAxisLayout

    n, lead = mesh.size, mesh.index == 0
    mm = make_mesh(n // 2, 2)
    ep_mesh = make_ep_mesh(n // 2, 2)
    cfg = GPT2Config(vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    dev = _device()
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0))
    params = {k: p.detach().to(dev) for k, p in model.named_parameters()}
    loss_fn, fl = losses.lm_loss_fn(model), Flattener(params)
    splits = tp_layout(params, mm, cfg)
    tp_params = shard_params(params, splits, mm)
    tp_model = GPT2LMHead(model_parallel_config(cfg, mm))
    layout = ModelAxisLayout(tp_params, splits, mm.num_model, mm.model_index)
    sharded = make_sharded_loss(losses.lm_loss_fn(tp_model), mm)
    both = basis_sharding(mm, layout)  # P split over data and model
    ids = np.random.RandomState(1).randint(0, VOCAB, size=(4, 2 * mm.num_data, SEQ))
    batches = [{"input_ids": torch.as_tensor(i, device=dev)} for i in ids]
    local = [shard_batch(b, mm) for b in batches]
    out = {"mesh": mm.shape, "params": fl.size, "rank_vector": layout.size,
           "split_leaves": sum(1 for s in splits.values() if s is not None)}

    step_cfg = LanczosSGDConfig(k=4, delta=1e-4, lr=1e-3, momentum=0.9, weight_decay=1e-4,
                                normalization="mean")
    init_n, step_n = make_lanczos_sgd_step(sharded, tp_params, step_cfg, basis_sharding=both)
    state_n, m_n = step_n(init_n({k: p.clone() for k, p in tp_params.items()}), local[0])
    stepped = Flattener(params).flatten(gather_model_axis(state_n.params, mm, splits))
    out.update({"step_loss": float(m_n["loss"]), "step_eig_max": float(m_n["eig_max"]),
                "step_basis_columns": int(state_n.basis.shape[1])})
    if lead:
        init_1, step_1 = make_lanczos_sgd_step(loss_fn, params, step_cfg)
        state_1, m_1 = step_1(init_1({k: p.clone() for k, p in params.items()}), batches[0])
        out.update({"step_eig_max_rel": abs(float(m_n["eig_max"]) / float(m_1["eig_max"]) - 1),
                    "step_params_rel": _rel(stepped, fl.flatten(state_1.params))})

    v = torch.randn(fl.size, generator=torch.Generator().manual_seed(2)).to(dev)
    v_rank = Flattener(tp_params).flatten(shard_params(fl.unflatten(v), splits, mm))
    host_n = dataset_spectrum_host(sharded, tp_params, local[:2], 3, v0=v_rank,
                                   basis_sharding=both)
    out["host_loop_alpha0"] = float(host_n.alphas[0])
    if lead:
        host_1 = dataset_spectrum_host(loss_fn, params, batches[:2], 3, v0=v)
        out["host_loop_T_diff"] = _t_diff(host_n, host_1)

    trainer_cfg = LanczosSGDConfig(k=3, delta=1e-3, lr=1e-3, momentum=0.9, refresh_every=2,
                                   normalization="mean")
    t_n = HostLanczosSGDTrainer(sharded, tp_params, trainer_cfg, basis_sharding=both)
    s_n = t_n.init({k: p.clone() for k, p in tp_params.items()})
    for part in local[:2]:
        s_n, hm_n = t_n.step(s_n, part)
    trained = Flattener(params).flatten(gather_model_axis(s_n.params, mm, splits))
    out["trainer_loss"] = float(hm_n["loss"])
    if lead:
        t_1 = HostLanczosSGDTrainer(loss_fn, params, trainer_cfg)
        s_1 = t_1.init({k: p.clone() for k, p in params.items()})
        for whole in batches[:2]:
            s_1, _ = t_1.step(s_1, whole)
        out["trainer_params_rel"] = _rel(trained, fl.flatten(s_1.params))

    # sequence parallelism at batch size 1 (nothing for the data axis)
    sp_model = GPT2LMHead(seq_parallel_config(cfg, mm, data_axis=None))
    sp_batches = [{"input_ids": torch.as_tensor(i[:1], device=dev)} for i in ids[2:]]
    sp_n = dataset_spectrum_host(losses.lm_loss_fn(sp_model), params, sp_batches, 3, v0=v)
    out["seq_parallel_alpha0"] = float(sp_n.alphas[0])
    if lead:
        sp_1 = dataset_spectrum_host(loss_fn, params, sp_batches, 3, v0=v)
        out["seq_parallel_T_diff"] = _t_diff(sp_n, sp_1)

    # expert parallelism: Lanczos through the EP MoE GPT-2, its basis on the axis
    moe_cfg = dataclasses.replace(cfg, n_experts=4)
    moe = GPT2LMHead(moe_cfg, generator=torch.Generator().manual_seed(8))
    moe_params = {k: p.detach().to(dev) for k, p in moe.named_parameters()}
    ep_splits = ep_layout(moe_params, ep_mesh)
    ep_params = shard_params(moe_params, ep_splits, ep_mesh)
    ep_model = GPT2LMHead(model_parallel_config(moe_cfg, ep_mesh))
    moe_fl = Flattener(moe_params)
    w = torch.randn(moe_fl.size, generator=torch.Generator().manual_seed(9)).to(dev)
    w_rank = Flattener(ep_params).flatten(shard_params(moe_fl.unflatten(w), ep_splits, ep_mesh))
    ep_op = HessianOperator(losses.lm_loss_fn(ep_model), ep_params, batches[0])
    ep_n = lanczos(ep_op.matvec, ep_op.dim, 4, v0=w_rank, basis_sharding=basis_sharding(
        ep_mesh, ModelAxisLayout(ep_params, ep_splits, ep_mesh.num_model,
                                 ep_mesh.model_index)))
    out.update({"ep_mesh": ep_mesh.shape, "ep_alpha0": float(ep_n.alphas[0])})
    if lead:
        ep_1 = lanczos(HessianOperator(losses.lm_loss_fn(moe), moe_params, batches[0]).matvec,
                       moe_fl.size, 4, v0=w)
        out.update({"ep_T_diff": _t_diff(ep_n, ep_1), "ep_ritz_rel": _ritz_rel(ep_n, ep_1)})
    return out


def dryrun_pipeline_rank(mesh) -> dict:
    """One rank's share of the pipeline part of :func:`dryrun_multichip`
    on the ranks of ``mesh``: GPT-2's blocks over 2 stages (1 on an odd
    number of ranks), a batch of ``2·2·n_data`` sequences in 2 microbatches
    split over the data axis, and a 3-iteration Lanczos on the pipelined
    Hessian with the basis on the pipeline axis.  Rank 0 alone runs the
    whole model's and reports the difference of the two T."""
    from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
    from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
    from hessian_llm_vision_tpu_torch.models import losses
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.parallel.mesh import basis_sharding
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params
    from hessian_llm_vision_tpu_torch.parallel.pipeline import (
        make_pipeline_mesh,
        make_pipelined_lm_loss,
        pipeline_param_sharding,
        stack_pipeline_params,
    )
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener, ModelAxisLayout

    n, lead = mesh.size, mesh.index == 0
    stages = 2 if n % 2 == 0 else 1
    pm = make_pipeline_mesh(n // stages, stages)
    cfg = GPT2Config(vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    dev = _device()
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0))
    params = {k: p.detach().to(dev) for k, p in model.named_parameters()}
    fl = Flattener(params)
    stacked = stack_pipeline_params(params, cfg.n_layer, stages)
    splits = pipeline_param_sharding(stacked, pm)
    local = shard_params(stacked, splits, pm)
    loss = make_pipelined_lm_loss(model, pm, num_microbatches=2, data_axis="data")
    ids = np.random.RandomState(4).randint(0, VOCAB, size=(2 * 2 * pm.num_data, SEQ))
    batch = {"input_ids": torch.as_tensor(ids, device=dev)}
    v = torch.randn(fl.size, generator=torch.Generator().manual_seed(5)).to(dev)
    v_rank = Flattener(local).flatten(shard_params(
        stack_pipeline_params(fl.unflatten(v), cfg.n_layer, stages), splits, pm))
    layout = ModelAxisLayout(local, splits, pm.num_model, pm.model_index)
    op = HessianOperator(loss, local, batch)
    res = lanczos(op.matvec, op.dim, 3, v0=v_rank, basis_sharding=basis_sharding(pm, layout))
    out = {"mesh": pm.shape, "microbatches": 2, "batch": list(ids.shape),
           "alpha0": float(res.alphas[0]), "finite": bool(torch.isfinite(res.alphas).all())}
    if lead:
        whole = HessianOperator(losses.lm_loss_fn(model), params, batch)
        out["T_diff"] = _t_diff(res, lanczos(whole.matvec, fl.size, 3, v0=v))
    return out


def dryrun_all(mesh) -> dict:
    """:func:`dryrun_rank`, :func:`dryrun_model_rank` on an even mesh of at
    least 4 ranks, and :func:`dryrun_pipeline_rank`."""
    out = dryrun_rank(mesh)
    n = mesh.size
    out["model_axis"] = dryrun_model_rank(mesh) if n >= 4 and n % 2 == 0 else (
        "needs an even number of ranks, at least 4")
    out["pipeline"] = dryrun_pipeline_rank(mesh)
    return out


def dryrun_multichip(n_devices: int = 2, *, timeout: float = 600.0,
                     backend: str = "gloo") -> dict:
    """The parallel axes on ``n_devices`` ranks: gloo ranks on the CPU, or
    with ``backend="nccl"`` one NCCL rank per card; prints the JSON line
    and the JAX package's line, and returns the summary (rank 0's
    numbers).  Raises if the ranks' lines differ."""
    from hessian_llm_vision_tpu_torch.parallel import spawn

    with tempfile.TemporaryDirectory() as workdir:
        ranks = spawn.run_ranks(f"{__name__}:dryrun_all", n_devices, workdir, backend=backend,
                                threads=1 if backend == "gloo" else None, timeout=timeout)
    lines = [multichip_line(r["result"]) for r in ranks]
    if len(set(lines)) != 1:
        raise RuntimeError("the ranks' dry runs differ:\n" + "\n".join(lines))
    summary = report(ranks[0]["result"])
    print(lines[0], flush=True)
    return summary


def multichip_line(summary: dict) -> str:
    """The JAX package's one-line summary (``MULTICHIP_r*.json``'s tail) from
    :func:`dryrun_all`'s: the mesh, the fused LanczosSGD step's loss and
    eig_max on data x model, the host loop's first alpha and the host
    trainer's loss, sequence parallelism's and expert parallelism's first
    alphas, the probes, and the pipeline's first alpha."""
    ma, pp = summary.get("model_axis"), summary["pipeline"]
    if not isinstance(ma, dict):
        ma = {"mesh": {"data": summary["ranks"], "model": 1}}
    keys = [f"mesh={ma['mesh']}"]
    for name, key in (("loss", "step_loss"), ("eig_max", "step_eig_max"),
                      ("hostloop_alpha0", "host_loop_alpha0"),
                      ("hostloop_trainer_loss", "trainer_loss"),
                      ("seqparallel_alpha0", "seq_parallel_alpha0")):
        if key in ma:
            keys.append(f"{name}={ma[key]:.4f}")
    keys.append(f"probe_parallel={summary['probe_parallel']}")
    keys.append(f"pipeline_alpha0={pp['alpha0']:.4f}")
    if "ep_alpha0" in ma:
        keys.append(f"moe_ep_alpha0={ma['ep_alpha0']:.4f}")
    return "dryrun_multichip ok: " + " ".join(keys)


def report(summary: dict) -> dict:
    """Print rank 0's summary as the one ``{"dryrun_multichip": ...}`` line."""
    print(json.dumps({"dryrun_multichip": summary}), flush=True)
    return summary
