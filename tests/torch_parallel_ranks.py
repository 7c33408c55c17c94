"""Rank functions of ``tests/test_torch_parallel.py``.

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
from hessian_llm_vision_tpu_torch.krylov.sharded import PShard
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
    dots, axpy, reduce_ = kernels.rank_k_dots, kernels.rank_k_axpy, mesh.all_reduce_
    sh = PShard(sb, 64)
    try:
        kernels.rank_k_dots = lambda *a: events.append("rank_k_dots") or dots(*a)
        kernels.rank_k_axpy = lambda *a, **k: events.append("rank_k_axpy") or axpy(*a, **k)
        object.__setattr__(mesh, "all_reduce_",
                           lambda t: events.append(f"all_reduce {tuple(t.shape)}") or reduce_(t))
        rows = torch.eye(64)[:3, sh.lo:sh.lo + sh.width].contiguous()
        g = torch.arange(64, dtype=torch.float32)
        out["projection"] = _np(sh.gather(sh.project_out(sh.part(g), rows)))
    finally:
        kernels.rank_k_dots, kernels.rank_k_axpy = dots, axpy
        object.__delattr__(mesh, "all_reduce_")
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
