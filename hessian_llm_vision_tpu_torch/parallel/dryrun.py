"""The data axis on n CPU ranks, one line of summary (the data-axis half of
the JAX package's ``__graft_entry__.py::dryrun_multichip``).

``dryrun_multichip(n)`` spawns n gloo ranks on the CPU (``parallel/spawn.py``)
and, on a tiny GPT-2 with one global batch of 2n sequences, runs the
data-parallel loss, gradient and HVP (held to one process on the whole
batch), thick restart with the basis split along P, probe-parallel SLQ
(held to the probes run in turn) and one fused LanczosSGD step with a
P-sharded basis.  The model axis (tensor, sequence, pipeline and expert
parallelism) joins it with ROADMAP A13b.

    python -c "from hessian_llm_vision_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2)"
"""

from __future__ import annotations

import json
import tempfile

import numpy as np
import torch

SEQ, VOCAB = 16, 256


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
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in model.named_parameters()}
    loss_fn = losses.lm_loss_fn(model)
    fl = Flattener(params)
    ids = np.random.RandomState(1).randint(0, VOCAB, size=(2 * n, SEQ))
    batches = [{"input_ids": torch.as_tensor(ids)}]
    local = [shard_batch(b, mesh) for b in batches]
    sharded = make_sharded_loss(loss_fn, mesh)

    loss_1, grad_1 = grad_and_loss(loss_fn, params, batches[0])
    loss_n, grad_n = grad_and_loss(sharded, params, local[0])
    v = torch.randn(fl.size, generator=torch.Generator().manual_seed(2))
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
                                 v0=torch.randn(fl.size, generator=draws))
           for _ in range(n)]

    step_cfg = LanczosSGDConfig(k=2, delta=1.0, lr=1e-2, normalization="mean")
    init_fn, step_fn = make_lanczos_sgd_step(sharded, params, step_cfg,
                                             basis_sharding=basis_sharding(mesh))
    state, metrics = step_fn(init_fn({k: p.clone() for k, p in params.items()}), local[0])
    return {
        "ranks": n,
        "params": fl.size,
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


def dryrun_multichip(n_devices: int = 2, *, timeout: float = 600.0) -> dict:
    """The data axis on ``n_devices`` gloo ranks on the CPU; prints one
    JSON line and returns its summary (rank 0's numbers)."""
    from hessian_llm_vision_tpu_torch.parallel.spawn import run_ranks

    with tempfile.TemporaryDirectory() as workdir:
        ranks = run_ranks(f"{__name__}:dryrun_rank", n_devices, workdir, threads=1,
                          timeout=timeout)
    return report(ranks[0]["result"])


def report(summary: dict) -> dict:
    """Print rank 0's summary as the one ``{"dryrun_multichip": ...}`` line."""
    print(json.dumps({"dryrun_multichip": summary}), flush=True)
    return summary
