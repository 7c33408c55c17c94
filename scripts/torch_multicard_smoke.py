"""Four-card smoke test of the port's mesh: one NCCL rank per H100, NCCL's
own all-reduce, all-gather, reduce-scatter and paired send/receive, held
to the same jobs on one card.

    python3 scripts/torch_multicard_smoke.py     # a host with 4 CUDA cards

Exits non-zero on a host with fewer than 4 cards, and after any failed gate
or failed phase (the phases after it still run: each of M1-M4 is a spawn
of its own, ``parallel/spawn.py`` with ``backend="nccl"``, rank r on card
r).  GPT-2 124M at full width and depth, fp32 products ("high"), random
weights from seed 0, unless a phase says otherwise:

  M0. each card's name and power limit (``nvidia-smi``), the topology
      between the cards (``nvidia-smi topo -m``), NCCL's version; the
      rank-k kernels built once here for every rank.
  M1. the data axis over 4 ranks: ``ShardedLoss`` at bs8 x seq512, 2 rows
      a rank, its gradient and HVP within 1e-5 of the whole batch's on one
      card (computed here on card 0 before the ranks start); the headline
      job (4 batches x bs8 x seq512, the dataset Hessian) as a 35-iteration
      reorthogonalised Lanczos with its f32 basis split along P, (35,
      31,011,648) a rank, T within 1e-4 and Ritz values within 1e-3 of the
      same job unsharded on card 0; thick restart (k 3, inner 40, one
      batch) with its (41, P/4) f32 buffer a rank, its converged Ritz
      values within 1e-3 of the unsharded run's on card 1; the rank-k pair
      on each rank's blocks within 1e-5 of its plain version, repeated bit
      for bit, and timed at both shapes on rank 0 (``chip_smoke.
      check_rank_k``); the all-reduce of a 496 MB P-vector timed apart.
  M2. the model axis over 4 ranks (``chip_smoke._vs_whole``, each held to
      the whole model, the last rank running it): TP (3 heads a rank) at
      bs2 x seq512 with a 10-iteration Lanczos on the axis, SP at bs1 x
      seq1024, TP x SP on one axis, gpt2-moe EP (2 of 8 experts a rank)
      dense and top-2 at bs4 x seq256, and EP x SP on one axis; loss within
      1e-6, gathered gradient and HVP within 1e-5, T within 1e-4.  Then
      Pythia-1.4B TP over 4 (4 of 16 heads a rank, embed_in and embed_out
      vocab-parallel at 12,576 rows), held by phase 17c's seeded inner
      products to a reference that card 0 makes here before the ranks
      start; its refresh's (4, P_local) bf16 block through the rank-k pair
      (each kernel once) and against its plain version, timed on rank 0.
  M3. ``parallel/dryrun.py::dryrun_multichip`` on 4 NCCL ranks (its model
      axis and pipeline on a data 2 x model 2 mesh), its JAX-style line,
      the same on every rank.
  M4. the pipeline: 4 stages of 3 blocks, one a card, M = 4 and M = 8
      microbatches of bs8 x seq512: loss within 1e-6, gradient and HVP
      within 1e-5 of the whole model, a 10-iteration Lanczos T within
      1e-4; the HVP seconds against the whole model's on one card, and each
      stage's idle share of a forward (1 - M x one tick of its blocks / the
      pipelined forward) against the bubble (S-1)/(M+S-1).
  M5. the spectrum CLI launched plainly, ``python -m
      hessian_llm_vision_tpu_torch spectrum --probe_parallel --probes 4
      --host_loop ...``: it starts 4 NCCL ranks, one probe a card; each
      probe's T (rebuilt from its Ritz values and weights in the artifact)
      within 1e-4 of the same command with ``--probes 4`` in turn on one
      card from the same ``--vector_seed``; the seconds per probe of each.

Every HVP and Lanczos of M1, M2 and M4 prints its collectives by kind
(calls, bytes, seconds; ``parallel.mesh.collective_clock``).  Every line
goes to stdout and to ``chiprun_out/torch_multicard_smoke.log``, the
ranks' logs to ``chiprun_out/multicard/``; the JSON summary is the last
line but one, the card line the last.
"""

from __future__ import annotations

import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CARDS = 4
OUT = os.path.join(ROOT, "chiprun_out")
LOG = os.path.join(OUT, "torch_multicard_smoke.log")
SPAWN_TIMEOUT = 240.0
SEED = 0
#: GPT-2 124M (512 positions) on random tokens, the headline job's batches
DP_ARGV = ["--model", "gpt2", "--dataset", "random", "--num_batches", "4", "--batch_size", "8",
           "--max_length", "512", "--attn_block_q", "512", "--loss_chunk", "512",
           "--hvp_precision", "high", "--seed", str(SEED)]
DP_ITERS = 35  # bench.py's headline job
TR_K, TR_INNER, TR_TOL, TR_RESTARTS = 3, 40, 2e-3, 6
HVP_RTOL, T_TOL, RITZ_RTOL, LOSS_RTOL = 1e-5, 1e-4, 1e-3, 1e-6
#: the model axis (1024 positions): chip_smoke's 17a/17b/17d shapes
MA_ITERS = 10
PP_SHAPE, PP_MICRO = (8, 512), (4, 8)
PYTHIA_ARGV = cs.PYTHIA_TRAIN_ARGV + ["--max_length", "512"]
PYTHIA_SEQ = 512
#: M5: the CLI over every card against the same probes in turn on one card
CLI_ARGV = ["spectrum", "--model", "gpt2", "--dataset", "random", "--num_batches", "1",
            "--batch_size", "8", "--max_length", "512", "--attn_block_q", "512",
            "--loss_chunk", "512", "--host_loop", "--lanczos_iters", "10", "--probes",
            str(CARDS), "--hvp_precision", "high", "--vector_seed", "997"]
#: the function each spawned rank runs (a rehearsal points it elsewhere)
RANK_TARGET = f"{os.path.abspath(__file__)}:rank_main"
BACKEND = "nccl"
CARD = cs.CARD
FAILED: list = []


class Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
            st.flush()
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def gate(what: str, gates: dict) -> None:
    """Print a phase's gates; a failed one fails the run at its end."""
    for name, ok in gates.items():
        print(f"  [{'ok' if ok else 'FAILED'}] {what}: {name}", flush=True)
        if not ok:
            FAILED.append(f"{what}: {name}")


def smi(query: str) -> list:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()


def clock_lines(what: str, clock: dict, per: int = 1) -> None:
    """One line per collective kind of ``clock`` (``per``: divide by it)."""
    for kind, c in clock["by"].items():
        if c["calls"]:
            print(f"    {what}: {kind} {c['calls'] / per:g} calls, {c['bytes'] / per:.0f} "
                  f"bytes, {c['s'] / per:.6f} s", flush=True)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t_close(T, T_ref) -> bool:
    return bool(np.allclose(np.asarray(T[0]), np.asarray(T_ref[0]), rtol=T_TOL, atol=T_TOL)
                and np.allclose(np.asarray(T[1]), np.asarray(T_ref[1]), rtol=T_TOL, atol=T_TOL))


# --------------------------------------------------------------------- M1

def m1_reference(path: str) -> dict:
    """M1's whole-batch gradient and HVP on card 0, before the ranks start."""
    from hessian_llm_vision_tpu_torch.cli import spectrum as spectrum_cli
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
    from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    wl = build_workload(spectrum_cli.build_parser().parse_args(DP_ARGV), CARD)
    fl = Flattener(wl.params)
    v = _start(fl.size)
    (loss, g), grad_s = cs._synced(lambda: grad_and_loss(wl.loss_fn, wl.params, wl.batches[0]))
    op = HessianOperator(wl.loss_fn, wl.params, wl.batches[0], precision="high")
    op(v)
    hv, hvp_s = cs._synced(lambda: op(v))
    torch.save({"loss": float(loss), "grad": fl.flatten(g).cpu(), "hvp": hv.cpu()}, path)
    del wl, g, hv, op
    cs._free()
    return {"grad_s": grad_s, "hvp_s": hvp_s}


def _start(P: int) -> torch.Tensor:
    v = torch.randn(P, generator=torch.Generator(device=CARD).manual_seed(16), device=CARD)
    return v / torch.linalg.vector_norm(v)


def m1_rank(mesh, *, ref_path: str) -> dict:
    """M1 on one of the 4 ranks."""
    import torch.distributed as dist

    from hessian_llm_vision_tpu_torch.cli import spectrum as spectrum_cli
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
    from hessian_llm_vision_tpu_torch.krylov import driver
    from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
    from hessian_llm_vision_tpu_torch.krylov.sharded import PShard
    from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition
    from hessian_llm_vision_tpu_torch.ops import kernels, spectral
    from hessian_llm_vision_tpu_torch.parallel import (
        ShardedHessianOperator,
        basis_sharding,
        make_sharded_loss,
        shard_batch,
    )
    from hessian_llm_vision_tpu_torch.parallel.mesh import collective_clock
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    torch.backends.cuda.matmul.allow_tf32 = False
    r = mesh.index
    res = {"rank": r, "card": torch.cuda.current_device(), "backend": dist.get_backend(),
           "collective_path": mesh.collective_path(torch.zeros(1, device=CARD), "data")}
    wl = build_workload(spectrum_cli.build_parser().parse_args(DP_ARGV), CARD)
    fl = Flattener(wl.params)
    P = fl.size
    v = _start(P)
    local = [shard_batch(b, mesh) for b in wl.batches]
    res["local_rows"], res["P"] = int(local[0]["input_ids"].shape[0]), P
    sharded = make_sharded_loss(wl.loss_fn, mesh)
    norm = dict(normalization="dataset", batch_size=8, precision="high", flattener=fl)

    # the references on one card, two ranks at once while the others wait
    if r == 0:
        ref, res["unsharded_lanczos_s"] = cs._synced(lambda: lanczos(driver.dataset_matvec(
            wl.loss_fn, wl.params, wl.batches, **norm), P, DP_ITERS, v0=v))
        res["T_ref"] = [ref.alphas.tolist(), ref.betas.tolist()]
        res["ritz_ref"] = sorted(ritz_decomposition(ref).eigvals.tolist())
        del ref
    if r == 1:
        tr, res["unsharded_tr_s"] = cs._synced(lambda: driver.dataset_thick_restart_host(
            wl.loss_fn, wl.params, wl.batches[:1], TR_K, v0=v, inner=TR_INNER, tol=TR_TOL,
            max_restarts=TR_RESTARTS, **norm))
        res["tr_ref"] = {"eigvals": np.asarray(tr.eigvals).tolist(), "converged": tr.converged,
                         "matvecs": tr.matvecs}
        del tr
    cs._free()
    dist.barrier()

    (loss, g), res["dp_grad_s"] = cs._synced(lambda: grad_and_loss(sharded, wl.params, local[0]))
    op = ShardedHessianOperator(wl.loss_fn, wl.params, local[0], mesh, precision="high")
    op(v)
    dist.barrier()
    hv, res["dp_hvp_s"] = cs._synced(lambda: op(v))
    dist.barrier()
    with collective_clock() as clock:
        op(v)
    res["hvp_collectives"] = clock
    if r == 0:
        want = torch.load(ref_path)
        res["loss_rel"] = abs(float(loss) - want["loss"]) / abs(want["loss"])
        res["grad_rel"] = cs.rel_l2(fl.flatten(g).cpu(), want["grad"])
        res["hvp_rel"] = cs.rel_l2(hv.cpu(), want["hvp"])
        del want
    del g, hv, op

    buf = torch.randn(P, device=CARD)
    times = []
    for _ in range(6):
        dist.barrier()
        times.append(cs._synced(lambda: mesh.sum_(buf, "data"))[1])
    res["all_reduce_P_s"] = {"median": statistics.median(times[1:]), "all": times,
                             "bytes": P * 4}
    sh = PShard(basis_sharding(mesh), P)
    dist.barrier()
    res["all_gather_P_s"] = cs._synced(lambda: sh.gather(sh.part(buf)))[1]
    del buf

    # the headline job, its basis split along P
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    with collective_clock() as clock:
        lres, res["sharded_lanczos_s"] = cs._synced(lambda: lanczos(driver.dataset_matvec(
            sharded, wl.params, local, **norm), P, DP_ITERS, v0=v,
            basis_sharding=basis_sharding(mesh)))
    res["lanczos_collectives"] = clock
    res["launches"] = dict(kernels.LAUNCHES)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["basis_block"] = list(lres.basis.shape)
    res["T"] = [lres.alphas.tolist(), lres.betas.tolist()]
    res["ritz"] = sorted(ritz_decomposition(lres).eigvals.tolist())
    gv = sh.part(v).contiguous()
    c = torch.randn(DP_ITERS, generator=torch.Generator(device=CARD).manual_seed(17),
                    device=CARD)
    res["pair"] = cs._pair_check(kernels, lres.basis, gv, c)
    del lres

    kernels.reset_launch_counts()
    dist.barrier()
    tr, res["sharded_tr_s"] = cs._synced(lambda: driver.dataset_thick_restart_host(
        sharded, wl.params, local[:1], TR_K, v0=v, inner=TR_INNER, tol=TR_TOL,
        max_restarts=TR_RESTARTS, basis_sharding=basis_sharding(mesh), **norm))
    res["tr"] = {"eigvals": np.asarray(tr.eigvals).tolist(), "converged": tr.converged,
                 "matvecs": tr.matvecs, "restarts": tr.restarts,
                 "block": list(tr.vectors.shape), "launches": dict(kernels.LAUNCHES)}
    del tr, wl
    cs._free()
    # the pair at the buffer's block, the (41, P/4) rows every inner step works on
    rows = torch.randn(TR_INNER + 1, sh.size, generator=torch.Generator(device=CARD)
                       .manual_seed(18), device=CARD).mul_(1.0 / math.sqrt(P))
    res["pair_tr"] = cs._pair_check(kernels, rows, gv, torch.randn(
        TR_INNER + 1, generator=torch.Generator(device=CARD).manual_seed(19), device=CARD))
    del rows
    cs._free()
    if r == 0:  # timed in turns with torch.mv / torch.addmv, alone on the card
        gen = torch.Generator(device=CARD).manual_seed(20)
        res["timed"] = {f"{k}x{sh.size}": cs.check_rank_k(
            kernels, spectral, torch.float32, k, sh.size, gen, True)
            for k in (DP_ITERS, TR_INNER + 1)}
    dist.barrier()
    return res


def m1_gates(res: list) -> dict:
    lead, second = res[0], res[1]
    T, T_ref = lead["T"], lead["T_ref"]
    ritz, ritz_ref = np.asarray(lead["ritz"]), np.asarray(lead["ritz_ref"])
    tr, tr_ref = np.sort(lead["tr"]["eigvals"]), np.sort(second["tr_ref"]["eigvals"])
    per_iter = 2  # CGS2: two projections an iteration
    out = {
        "cards": [r["card"] for r in res], "backend": lead["backend"],
        "collective_path": [r["collective_path"] for r in res],
        "loss_rel": lead["loss_rel"], "grad_rel": lead["grad_rel"], "hvp_rel": lead["hvp_rel"],
        "dp_grad_s": [r["dp_grad_s"] for r in res], "dp_hvp_s": [r["dp_hvp_s"] for r in res],
        "all_reduce_P_s": [r["all_reduce_P_s"]["median"] for r in res],
        "all_gather_P_s": [r["all_gather_P_s"] for r in res],
        "T_max_abs_diff": float(max(np.abs(np.subtract(T[0], T_ref[0])).max(),
                                    np.abs(np.subtract(T[1], T_ref[1])).max())),
        "ritz_max_rel": float(np.abs(ritz - ritz_ref).max() / np.abs(ritz_ref).max()),
        "ritz_extremes": [float(ritz[0]), float(ritz[-1])],
        "sharded_lanczos_s": [r["sharded_lanczos_s"] for r in res],
        "unsharded_lanczos_s": lead["unsharded_lanczos_s"],
        "basis_blocks": [r["basis_block"] for r in res],
        "peak_bytes": [r["peak_bytes"] for r in res],
        "launches": [r["launches"] for r in res],
        "tr_eigvals": tr.tolist(), "tr_ref_eigvals": tr_ref.tolist(),
        "tr_max_rel": float(np.abs(tr - tr_ref).max() / np.abs(tr_ref).max()),
        "tr": [{k: r["tr"][k] for k in ("converged", "matvecs", "restarts", "block",
                                        "launches")} for r in res],
        "sharded_tr_s": [r["sharded_tr_s"] for r in res],
        "unsharded_tr_s": second["unsharded_tr_s"], "tr_ref_converged":
            second["tr_ref"]["converged"], "tr_ref_matvecs": second["tr_ref"]["matvecs"],
        "pair": [r["pair"] for r in res], "pair_tr": [r["pair_tr"] for r in res],
        "timed": {k: {n: cs.without_smi(t[n]) for n in ("rank_k_dots", "rank_k_axpy")}
                  for k, t in lead["timed"].items()},
    }
    print(json.dumps({"M1_data_axis": out}), flush=True)
    for r in res:
        print(f"M1 rank {r['rank']} on card {r['card']} ({r['collective_path']} path): DP HVP "
              f"{r['dp_hvp_s']:.4f} s; NCCL all-reduce of the P-vector "
              f"({r['all_reduce_P_s']['bytes']} bytes) "
              f"{r['all_reduce_P_s']['median']:.6f} s, its all-gather from quarters "
              f"{r['all_gather_P_s']:.6f} s; the sharded Lanczos {r['sharded_lanczos_s']:.2f} s "
              f"({DP_ITERS} iterations), thick restart {r['sharded_tr_s']:.2f} s", flush=True)
        clock_lines(f"M1 rank {r['rank']} DP HVP", r["hvp_collectives"])
        clock_lines(f"M1 rank {r['rank']} Lanczos iteration", r["lanczos_collectives"], DP_ITERS)
    print(f"M1 unsharded on card 0: Lanczos {lead['unsharded_lanczos_s']:.2f} s; thick "
          f"restart on card 1 {second['unsharded_tr_s']:.2f} s", flush=True)
    for name, t in out["timed"].items():
        for k in ("rank_k_dots", "rank_k_axpy"):
            print(f"M1 {k} at ({name.replace('x', ', ')}) f32: {t[k]['ms']:.4f} ms "
                  f"{t[k]['ms_spread']}, bound {t[k]['bound_ms']:.4f}, plain "
                  f"{t[k]['plain_ms']:.4f}, library {t[k]['library_ms']:.4f}; device / host "
                  f"{t[k]['device_us']:.1f} / {t[k]['host_us']:.1f} us", flush=True)
    quarter = -(-lead["P"] // CARDS)
    gate("M1 data axis", {
        "four NCCL ranks, one a card": lead["backend"] == "nccl"
        and sorted(out["cards"]) == list(range(CARDS)),
        "NCCL takes the native path": all(p == "native" for p in out["collective_path"]),
        "2 rows a rank": [r["local_rows"] for r in res] == [2] * CARDS,
        "DP gradient and HVP within 1e-5 of the whole batch's": max(
            out["grad_rel"], out["hvp_rel"]) <= HVP_RTOL and out["loss_rel"] <= LOSS_RTOL,
        f"each rank's basis ({DP_ITERS}, {quarter})": out["basis_blocks"] == [
            [DP_ITERS, quarter]] * CARDS,
        "T within 1e-4 of the unsharded run": _t_close(T, T_ref),
        "every rank's T the same": all(r["T"] == T for r in res),
        "Ritz values within 1e-3": out["ritz_max_rel"] <= RITZ_RTOL,
        "the pair on each rank, pass 1 then pass 2 per projection": all(
            r["launches"] == {"rank_k_dots": per_iter * DP_ITERS,
                              "rank_k_axpy": per_iter * DP_ITERS} for r in res),
        "thick restart converged, on both sides": all(t["converged"] for t in out["tr"])
        and out["tr_ref_converged"],
        f"thick restart's vectors ({TR_K}, {quarter}) a rank, from its "
        f"({TR_INNER + 1}, {quarter}) buffer": all(
            t["block"] == [TR_K, quarter] for t in out["tr"]),
        "thick restart's Ritz values within 1e-3": out["tr_max_rel"] <= RITZ_RTOL,
        "the pair against its plain version on every block, bit for bit repeated": all(
            p["rel_l2_dots"] <= 1e-5 and p["rel_l2_apply"] <= 1e-5 and p["bitwise_repeatable"]
            for p in out["pair"] + out["pair_tr"]),
        "the timed shapes pass check_rank_k": all(t["ok"] for t in lead["timed"].values()),
    })
    return out


# --------------------------------------------------------------------- M2

def pythia_reference(path: str) -> dict:
    """17c's reference for Pythia-1.4B on card 0, before the ranks start:
    the loss, the seeded inner products of the gradient and two HVPs, and
    the first refresh's T, on one random batch of ``PYTHIA_SEQ`` tokens."""
    from hessian_llm_vision_tpu_torch.cli import train as train_cli
    from hessian_llm_vision_tpu_torch.models import losses
    from hessian_llm_vision_tpu_torch.optim import lanczos_sgd_host as lsh

    args, model, params, init_s = cs.pythia_model(train_cli, PYTHIA_ARGV)
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    ids = np.random.RandomState(SEED).randint(0, model.config.vocab_size, size=(1, PYTHIA_SEQ))
    batch = {"input_ids": torch.as_tensor(ids, device=CARD)}
    trainer = cs.pythia_trainer(args, losses.lm_loss_fn(model, loss_chunk=args.loss_chunk),
                                params)
    torch.cuda.reset_peak_memory_stats()
    (loss, g), grad_s = cs._synced(lambda: trainer._grad(params, batch))
    products, products_s = cs._synced(lambda: cs.seeded_products(
        trainer.fl.unflatten(g), lambda u: trainer._hvp(params, batch, u), shapes))
    T, step = {"alphas": [], "betas": []}, lsh.host_recurrence_step

    def recorded(*a, **kw):
        out = step(*a, **kw)
        T["alphas"].append(float(out[0]))
        T["betas"].append(float(out[1]))
        return out

    lsh.host_recurrence_step = recorded
    try:
        _, host_s = cs._synced(lambda: trainer.refresh_spectrum(params, batch, g))
    finally:
        lsh.host_recurrence_step = step
    ref = {"loss": float(loss), "input_ids": batch["input_ids"].cpu(), "grad_s": grad_s,
           "products_s": products_s, "host_loop_s": host_s, "init_s": init_s,
           "peak_bytes": torch.cuda.max_memory_allocated(), **T, **products}
    torch.save(ref, path)
    del model, params, trainer, g
    cs._free()
    return {k: v for k, v in ref.items() if k != "input_ids"}


def m2_rank(mesh, *, pythia_path: str) -> dict:
    """M2 on one of the 4 ranks: GPT-2 124M on the model axis by every mode,
    then Pythia-1.4B tensor-parallel."""
    import torch.distributed as dist

    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.moe import make_ep_mesh
    from hessian_llm_vision_tpu_torch.ops import kernels, spectral
    from hessian_llm_vision_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    axis, ep_axis = make_mesh(1, CARDS), make_ep_mesh(1, CARDS)
    res = {"rank": axis.model_index, "card": torch.cuda.current_device()}
    cfg = GPT2Config.gpt2_124m()
    with torch.device(CARD):
        model = GPT2LMHead(cfg, generator=torch.Generator(CARD).manual_seed(SEED))
    params = {n: p.detach() for n, p in model.named_parameters()}
    tp_batches = cs._token_batches(cfg.vocab_size, cs.MA_TP_SHAPE, 1, SEED)
    sp_batches = cs._token_batches(cfg.vocab_size, cs.MA_SP_SHAPE, 1, SEED + 1)
    res["tp"], _ = cs._vs_whole("tp", model, params, tp_batches, axis, iters=MA_ITERS,
                                timed=True, clock_lanczos=True)
    cs._free()
    res["sp"], ref_sp = cs._vs_whole("sp", model, params, sp_batches, axis, timed=True)
    cs._free()
    res["tpsp"] = cs._vs_whole("tpsp", model, params, sp_batches, axis, timed=True,
                               ref=ref_sp)[0]
    del model, params, ref_sp
    cs._free()
    for gating, top_k in (("dense", 0), ("top2", 2)):
        mcfg = GPT2Config.moe_80m(moe_top_k=top_k)
        with torch.device(CARD):
            model = GPT2LMHead(mcfg, generator=torch.Generator(CARD).manual_seed(SEED))
        params = {n: p.detach() for n, p in model.named_parameters()}
        batches = cs._token_batches(mcfg.vocab_size, cs.MA_MOE_SHAPE, 1, SEED + 2)
        res[f"ep_{gating}"], ref = cs._vs_whole("ep", model, params, batches, ep_axis,
                                                 timed=True)
        res[f"epsp_{gating}"] = cs._vs_whole("epsp", model, params, batches, ep_axis,
                                             timed=True, ref=ref)[0]
        del model, params, ref
        cs._free()
    # Pythia-1.4B tensor-parallel over the 4 cards, held to card 0's reference
    ref = torch.load(pythia_path)
    keep = {}
    dist.barrier()
    res["pythia"] = cs.pythia_on_axis(axis, ref, PYTHIA_ARGV, keep)
    sh, basis, g = keep["shard"], keep["basis"], keep["grad"]
    g_part = sh.local(g)
    coeffs = torch.randn(basis.shape[0], generator=torch.Generator(device=CARD).manual_seed(21),
                         device=CARD)
    kernels.reset_launch_counts()
    dist.barrier()
    adjusted = sh.rank_k(g_part, basis, coeffs)  # pass 1, the all-reduce of w, pass 2
    res["pythia"]["pair_launches"] = dict(kernels.LAUNCHES)
    res["pythia"]["adjusted_finite"] = bool(torch.isfinite(adjusted).all())
    res["pythia"]["pair"] = cs._pair_check(kernels, basis, g_part, coeffs)
    del adjusted, keep, g
    cs._free()
    if axis.model_index == 0:
        res["pythia"]["timed"] = cs.check_rank_k(
            kernels, spectral, torch.bfloat16, basis.shape[0], basis.shape[1],
            torch.Generator(device=CARD).manual_seed(22), True)
    del basis
    dist.barrier()
    return res


def m2_gates(res: list, q: dict) -> dict:
    lead, last = res[0], res[-1]
    a = {**lead["tp"], **last["tp"]}
    a["T"] = lead["tp"]["T"]
    out = {"cards": [r["card"] for r in res]}
    for mode in ("tp", "sp", "tpsp", "ep_dense", "ep_top2", "epsp_dense", "epsp_top2"):
        m = last[mode]
        out[mode] = {k: m[k] for k in ("loss_rel", "grad_rel", "hvp_rel", "hvp_s", "grad_s",
                                       "whole_hvp_s", "collective_path")} | {
            "split_share": [r[mode]["split_share"] for r in res],
            "param_bytes": [r[mode]["param_bytes"] for r in res],
            "peak_bytes": [r[mode]["peak_bytes"] for r in res],
            "hvp_s_per_rank": [r[mode]["hvp_s"] for r in res]}
    out["tp"].update({"T_max_abs_diff": _rel(np.concatenate(a["T"]), np.concatenate(a["T_ref"])),
                      "ritz_max_rel": float(np.abs(np.subtract(a["ritz"], a["ritz_ref"])).max()
                                            / np.abs(a["ritz_ref"]).max()),
                      "basis_block": [r["tp"]["basis_block"] for r in res],
                      "lanczos_s": [r["tp"]["lanczos_s"] for r in res],
                      "pair": [r["tp"]["pair"] for r in res]})
    c = [r["pythia"] for r in res]
    p, root_P = c[0]["products"], math.sqrt(c[0]["P"])
    g_dot = max(abs(x - y) * root_P / (q["g_norm"] * u)
                for x, y, u in zip(p["g_dot_u"], q["g_dot_u"], p["u_norm"]))
    hu_dot = max(abs(x - y) * root_P / (q["hu_norm"][i] * u) for i in range(cs.MA_PROBES)
                 for x, y, u in zip(p["u_dot_hu"][i], q["u_dot_hu"][i], p["u_norm"]))
    pT = np.asarray([c[0]["T"]["alphas"], c[0]["T"]["betas"]])
    qT = np.asarray([q["alphas"], q["betas"]])
    out["pythia_tp"] = {
        "loss": c[0]["loss"], "loss_ref": q["loss"],
        "loss_rel": abs(c[0]["loss"] - q["loss"]) / abs(q["loss"]), "g_dot_rel": g_dot,
        "hu_dot_rel": hu_dot, "P": c[0]["P"], "T": pT.tolist(), "T_ref": qT.tolist(),
        "vocab_parallel": c[0]["vocab_parallel"], "param_bytes": [r["param_bytes"] for r in c],
        "peak_bytes": [r["peak_bytes"] for r in c], "grad_s": c[0]["grad_s"],
        "hvp_s": c[0]["hvp_s"], "host_loop_s": c[0]["host_loop_s"],
        "reference_grad_s": q["grad_s"], "reference_products_s": q["products_s"],
        "reference_host_loop_s": q["host_loop_s"], "reference_peak_bytes": q["peak_bytes"],
        "block": [r["pair"]["shape"] for r in c], "pair_launches": [r["pair_launches"] for r in c],
        "pair": [r["pair"] for r in c],
        "timed": {n: cs.without_smi(c[0]["timed"][n]) for n in ("rank_k_dots", "rank_k_axpy")}}
    print(json.dumps({"M2_model_axis": out}), flush=True)
    for r in res:
        for mode in ("tp", "sp", "tpsp", "ep_dense", "ep_top2", "epsp_dense", "epsp_top2"):
            m = r[mode]
            print(f"M2 rank {r['rank']} {mode}: HVP {m['hvp_s']:.4f} s ({m['collective_path']} "
                  f"path), peak {m['peak_bytes']} bytes", flush=True)
            clock_lines(f"M2 rank {r['rank']} {mode} HVP", m["collectives"])
        clock_lines(f"M2 rank {r['rank']} tp Lanczos iteration", r["tp"]["lanczos_collectives"],
                    MA_ITERS)
    print(f"M2 whole model on one card: TP's batch HVP {out['tp']['whole_hvp_s']:.4f} s, SP's "
          f"{out['sp']['whole_hvp_s']:.4f} s; Pythia-1.4B over 4: grad {c[0]['grad_s']:.3f} s, "
          f"HVPs {c[0]['hvp_s']} s, refresh {c[0]['host_loop_s']:.3f} s; on card 0 alone "
          f"{q['grad_s']:.3f} s, products {q['products_s']:.3f} s, refresh "
          f"{q['host_loop_s']:.3f} s", flush=True)
    t = out["pythia_tp"]["timed"]
    for k in ("rank_k_dots", "rank_k_axpy"):
        print(f"M2 {k} at {c[0]['pair']['shape']} bf16: {t[k]['ms']:.4f} ms, bound "
              f"{t[k]['bound_ms']:.4f}, plain {t[k]['plain_ms']:.4f}, library "
              f"{t[k]['library_ms']:.4f}", flush=True)
    per_iter = 2
    gates = {f"{mode} loss within 1e-6, gathered grad and HVP within 1e-5": out[mode][
        "loss_rel"] <= LOSS_RTOL and max(out[mode]["grad_rel"], out[mode]["hvp_rel"]) <= HVP_RTOL
        for mode in ("tp", "sp", "tpsp", "ep_dense", "ep_top2", "epsp_dense", "epsp_top2")}
    gates.update({
        "the native path on every rank": all(r[m]["collective_path"] == "native" for r in res
                                             for m in ("tp", "sp", "ep_dense", "epsp_top2")),
        "a quarter of the split leaves a rank": all(
            abs(s - 1 / CARDS) < 1e-9 for m in ("tp", "tpsp", "ep_dense", "epsp_dense")
            for s in out[m]["split_share"]),
        "TP T within 1e-4": _t_close(a["T"], a["T_ref"]),
        "TP Ritz values within 1e-3": out["tp"]["ritz_max_rel"] <= RITZ_RTOL,
        "TP the pair on each rank": all(r["tp"]["launches"] == {
            "rank_k_dots": per_iter * MA_ITERS, "rank_k_axpy": per_iter * MA_ITERS}
            for r in res),
        "TP the pair against its plain version": all(
            pp["rel_l2_dots"] <= 1e-5 and pp["rel_l2_apply"] <= 1e-5 and pp["bitwise_repeatable"]
            for pp in out["tp"]["pair"]),
        "Pythia loss within 1e-6 of card 0's": out["pythia_tp"]["loss_rel"] <= LOSS_RTOL,
        "Pythia gradient within 1e-5 (seeded inner products)": g_dot <= HVP_RTOL,
        "Pythia two HVPs within 1e-5 (seeded inner products)": hu_dot <= HVP_RTOL,
        "Pythia refresh T within 1e-4": bool(np.allclose(pT, qT, rtol=T_TOL, atol=T_TOL)),
        "Pythia embed_in and embed_out vocab-parallel":
            c[0]["vocab_parallel"] == ["embed_in", "embed_out.kernel"],
        "Pythia the pair once a kernel at its (4, P_local) bf16 block": all(
            r["pair_launches"] == {"rank_k_dots": 1, "rank_k_axpy": 1}
            and r["pair"]["shape"][0] == 4 and r["pair"]["dtype"] == "torch.bfloat16"
            and r["adjusted_finite"] for r in c),
        "Pythia the pair against its plain version": all(
            r["pair"]["rel_l2_dots"] <= 1e-5 and r["pair"]["rel_l2_apply"] <= 1e-5
            and r["pair"]["bitwise_repeatable"] for r in c),
        "Pythia's timed shape passes check_rank_k": c[0]["timed"]["ok"],
    })
    gate("M2 model axis", gates)
    return out


# --------------------------------------------------------------------- M3

def m3() -> dict:
    """``parallel/dryrun.py::dryrun_multichip`` on one NCCL rank per card
    (it prints the summary and the JAX-style line, and raises if the ranks'
    lines differ)."""
    from hessian_llm_vision_tpu_torch.parallel.dryrun import dryrun_multichip, multichip_line

    d = dryrun_multichip(CARDS, backend="nccl", timeout=SPAWN_TIMEOUT)
    ma, pp = d["model_axis"], d["pipeline"]
    gate("M3 dry run", {
        "data axis loss, grad and HVP": d["loss_rel"] <= LOSS_RTOL
        and max(d["grad_rel"], d["hvp_rel"]) <= HVP_RTOL,
        "thick restart converged, within 1e-4": d["thick_restart_converged"]
        and d["thick_restart_rel"] <= 1e-4,
        "probe-parallel T": d["probe_parallel_T_diff"] <= T_TOL,
        "a data 2 x model 2 mesh": ma["mesh"] == {"data": 2, "model": 2},
        "model axis T (host loop, SP, EP)": all(ma[k] <= T_TOL for k in (
            "host_loop_T_diff", "seq_parallel_T_diff", "ep_T_diff")),
        "fused step and trainer": ma["step_eig_max_rel"] <= RITZ_RTOL
        and ma["step_params_rel"] <= HVP_RTOL and ma["trainer_params_rel"] <= HVP_RTOL,
        "pipeline T": pp["T_diff"] <= T_TOL,
    })
    return {"line": multichip_line(d), "summary": d}


# --------------------------------------------------------------------- M4

def m4_rank(mesh) -> dict:
    """M4 on one of the 4 ranks: the pipeline over 4 stages, M = 4 and 8."""
    import torch.distributed as dist
    from torch.func import functional_call

    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params
    from hessian_llm_vision_tpu_torch.parallel.pipeline import (
        make_pipeline_mesh,
        make_pipelined_lm_loss,
        pipeline_param_sharding,
        stack_pipeline_params,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    pm = make_pipeline_mesh(1, CARDS)
    res = {"rank": pm.model_index, "card": torch.cuda.current_device()}
    cfg = GPT2Config.gpt2_124m()
    with torch.device(CARD):
        model = GPT2LMHead(cfg, generator=torch.Generator(CARD).manual_seed(SEED))
    params = {n: p.detach() for n, p in model.named_parameters()}
    batches = cs._token_batches(cfg.vocab_size, PP_SHAPE, 1, SEED + 3)
    ref = None
    stacked = stack_pipeline_params(params, cfg.n_layer, CARDS)
    local = shard_params(stacked, pipeline_param_sharding(stacked, pm), pm)
    blocks = {k[len("blocks."):]: v[0] for k, v in local.items() if k.startswith("blocks.")}
    nb = next(iter(blocks.values())).shape[0]
    for micro in PP_MICRO:
        out, ref = cs._vs_whole("pp", model, params, batches, pm, iters=MA_ITERS, timed=True,
                                ref=ref, micro=micro, clock_lanczos=True)
        # the idle share of this stage in a forward: its M ticks alone against
        # the pipelined forward
        loss = make_pipelined_lm_loss(model, pm, num_microbatches=micro)
        x = torch.randn(PP_SHAPE[0] // micro, PP_SHAPE[1], cfg.n_embd, device=CARD)

        def tick():
            h = x
            for j in range(nb):
                h = functional_call(model.h_0, {k: v[j] for k, v in blocks.items()}, (h,))
            return h

        with torch.no_grad():
            tick(), loss(local, batches[0])
            ticks, fwd = [], []
            for _ in range(3):
                ticks.append(cs._synced(tick)[1])
                dist.barrier()
                fwd.append(cs._synced(lambda: loss(local, batches[0]))[1])
        out["tick_s"], out["forward_s"] = statistics.median(ticks), statistics.median(fwd)
        out["idle_share"] = 1 - micro * out["tick_s"] / out["forward_s"]
        out["bubble"] = (CARDS - 1) / (micro + CARDS - 1)
        res[f"M{micro}"] = out
        cs._free()
    del model, params
    dist.barrier()
    return res


def m4_gates(res: list) -> dict:
    out = {}
    gates = {}
    for micro in PP_MICRO:
        key = f"M{micro}"
        lead, last = res[0][key], res[-1][key]
        T, T_ref = lead["T"], lead["T_ref"]
        out[key] = {k: last[k] for k in ("loss_rel", "grad_rel", "hvp_rel", "whole_hvp_s",
                                         "collective_path")} | {
            "hvp_s": [r[key]["hvp_s"] for r in res], "bubble": lead["bubble"],
            "idle_share": [r[key]["idle_share"] for r in res],
            "tick_s": [r[key]["tick_s"] for r in res],
            "forward_s": [r[key]["forward_s"] for r in res],
            "lanczos_s": [r[key]["lanczos_s"] for r in res],
            "basis_block": [r[key]["basis_block"] for r in res],
            "peak_bytes": [r[key]["peak_bytes"] for r in res],
            "T_max_abs_diff": _rel(np.concatenate(T), np.concatenate(T_ref)),
            "pair": [r[key]["pair"] for r in res]}
        for r in res:
            m = r[key]
            print(f"M4 {key} stage {r['rank']} on card {r['card']}: pipelined HVP "
                  f"{m['hvp_s']:.4f} s (the whole model on one card {last['whole_hvp_s']:.4f} s); "
                  f"idle share of a forward {m['idle_share']:.4f} (bubble {m['bubble']:.4f}: "
                  f"{micro} ticks of {m['tick_s']:.5f} s in {m['forward_s']:.5f} s)", flush=True)
            clock_lines(f"M4 {key} stage {r['rank']} HVP", m["collectives"])
            clock_lines(f"M4 {key} stage {r['rank']} Lanczos iteration",
                        m["lanczos_collectives"], MA_ITERS)
        gates.update({
            f"{key} loss within 1e-6 of the whole model": last["loss_rel"] <= LOSS_RTOL,
            f"{key} gathered grad and HVP within 1e-5": max(last["grad_rel"],
                                                            last["hvp_rel"]) <= HVP_RTOL,
            f"{key} T within 1e-4": _t_close(T, T_ref),
            f"{key} the native path": last["collective_path"] == "native",
            f"{key} the pair against its plain version": all(
                p["rel_l2_dots"] <= 1e-5 and p["rel_l2_apply"] <= 1e-5
                and p["bitwise_repeatable"] for p in out[key]["pair"]),
        })
    print(json.dumps({"M4_pipeline": out}), flush=True)
    gate("M4 pipeline", gates)
    return out


# --------------------------------------------------------------------- M5

def rebuilt_T(eigvals: np.ndarray, weights: np.ndarray) -> tuple:
    """The tridiagonal (alphas, betas) whose Ritz values are ``eigvals`` and
    whose eigenvectors' first components squared are ``weights``: a
    Lanczos run on diag(eigvals) from sqrt(weights), in float64 (the
    spectral data fix a Jacobi matrix)."""
    lam = np.asarray(eigvals, np.float64)
    q = np.sqrt(np.maximum(np.asarray(weights, np.float64), 0.0))
    q /= np.linalg.norm(q)
    k = lam.size
    Q = np.zeros((k, k))
    alphas, betas = np.zeros(k), np.zeros(k - 1)
    Q[0] = q
    for i in range(k):
        w = lam * Q[i]
        alphas[i] = Q[i] @ w
        w -= Q[:i + 1].T @ (Q[:i + 1] @ w)
        w -= Q[:i + 1].T @ (Q[:i + 1] @ w)
        if i + 1 < k:
            betas[i] = np.linalg.norm(w)
            Q[i + 1] = w / betas[i]
    return alphas, betas


def m5_cli(tmp: str) -> dict:
    """The spectrum CLI with --probe_parallel launched plainly, then the same
    probes in turn on one card."""
    runs = {}
    for name, extra in (("parallel", ["--probe_parallel"]), ("in_turn", [])):
        path = os.path.join(tmp, name)
        cmd = [sys.executable, "-m", "hessian_llm_vision_tpu_torch", *CLI_ARGV, *extra,
               "--out_spectrum", path]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        print(f"M5 {name}: exit {proc.returncode} in {wall:.2f} s\n{proc.stdout[-6000:]}"
              f"{proc.stderr[-3000:] if proc.returncode else ''}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"M5 {name}: the CLI exited {proc.returncode}")
        with np.load(path + ".npz") as z:
            runs[name] = {"eigvals": z["eigvals"], "gammas": z["gammas"], "wall_s": wall,
                          "stdout": proc.stdout}
    iters = int(CLI_ARGV[CLI_ARGV.index("--lanczos_iters") + 1])
    par, seq = runs["parallel"], runs["in_turn"]
    probes = []
    for i in range(CARDS):
        cut = slice(i * iters, (i + 1) * iters)
        Tp = rebuilt_T(par["eigvals"][cut], par["gammas"][cut] * CARDS)
        Ts = rebuilt_T(seq["eigvals"][cut], seq["gammas"][cut] * CARDS)
        probes.append({"T_close": _t_close(Tp, Ts),
                       "T_max_rel": max(_rel(Tp[0], Ts[0]), _rel(Tp[1], Ts[1])),
                       "ritz_max_rel": _rel(np.sort(par["eigvals"][cut]),
                                            np.sort(seq["eigvals"][cut]))})
    probe_s = [float(s) for s in re.findall(r"probe-parallel lanczos: probe \d+/\d+ on rank 0 "
                                            r"of \d+, \d+ iterations\s+([\d.]+)s", par["stdout"])]
    on_cards = re.search(r"ranks on cards (\[[\d, ]+\])", par["stdout"])
    out = {"probes": probes, "parallel_wall_s": par["wall_s"], "in_turn_wall_s": seq["wall_s"],
           "parallel_probe_s_rank0": probe_s,
           "in_turn_probe_s": _in_turn_probe_s(seq["stdout"]),
           "cards": json.loads(on_cards.group(1)) if on_cards else None}
    print(json.dumps({"M5_cli": out}), flush=True)
    print(f"M5: a probe on rank 0 of {CARDS} took {probe_s} s; in turn on one card "
          f"{out['in_turn_probe_s']} s a probe; walls {par['wall_s']:.2f} s (4 ranks started) "
          f"and {seq['wall_s']:.2f} s", flush=True)
    gate("M5 the CLI over every card", {
        "four NCCL ranks started, one a card": f"starting {CARDS} NCCL ranks" in par["stdout"]
        and out["cards"] == list(range(CARDS)),
        "one probe a rank": f"probe 1/{CARDS} on rank 0 of {CARDS}" in par["stdout"]
        and len(probe_s) == 1,
        "each probe's T within 1e-4 of the same probe in turn": all(p["T_close"]
                                                                   for p in probes),
    })
    return out


def _in_turn_probe_s(stdout: str):
    """The in-turn run's seconds a probe: its report's wall over the probes."""
    m = re.search(r"wall-clock: ([\d.]+)s", stdout)
    return float(m.group(1)) / CARDS if m else None


# ------------------------------------------------------------------- main

def rank_main(mesh, *, phase: str, **kw):
    """What each spawned rank runs: one phase's rank function."""
    return {"M1": m1_rank, "M2": m2_rank, "M4": m4_rank}[phase](mesh, **kw)


def spawn(phase: str, **kw) -> list:
    from hessian_llm_vision_tpu_torch.parallel.spawn import run_ranks

    workdir = os.path.join(OUT, "multicard", phase)
    ranks, wall = cs._synced(lambda: run_ranks(RANK_TARGET, CARDS, workdir, backend=BACKEND,
                                               kwargs={"phase": phase, **kw},
                                               timeout=SPAWN_TIMEOUT))
    print(f"{phase}: {CARDS} {BACKEND} ranks in {wall:.1f} s", flush=True)
    transports = sorted({m.group(0) for m in re.finditer(
        r"(via \S+(?: \S+)?|NVLS \S+|Using network \S+)", ranks[0]["log"])})
    if transports:
        print(f"{phase}: NCCL on rank 0: {transports[:12]}", flush=True)
    for r in ranks:
        assert "jax" not in r["modules"] and "hessian_llm_vision_tpu" not in r["modules"]
    return [r["result"] for r in ranks]


def run_phase(name: str, fn, summary: dict) -> None:
    t0 = time.perf_counter()
    print(f"\n[{name}]", flush=True)
    try:
        summary[name] = fn()
    except Exception:  # the next phases still run; the run fails at its end
        print(traceback.format_exc(), flush=True)
        FAILED.append(f"{name} raised")
    summary.setdefault("seconds", {})[name] = time.perf_counter() - t0


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print(f"needs {CARDS} CUDA cards, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    log = open(LOG, "w")
    sys.stdout = Tee(sys.__stdout__, log)
    from hessian_llm_vision_tpu_torch.ops import kernels

    summary = {}
    print("[M0] the cards", flush=True)
    for i, line in enumerate(smi("name,power.limit")):
        print(f"card {i}: {line}", flush=True)
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60)
    print(f"nvidia-smi topo -m (exit {topo.returncode}):\n{topo.stdout}{topo.stderr}",
          flush=True)
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(CARDS)]
            for i in range(CARDS)]
    print(f"peer access between the cards: {peer}", flush=True)
    summary["M0"] = {"cards": smi("name,power.limit"), "nccl": ".".join(
        map(str, torch.cuda.nccl.version())), "torch": torch.__version__,
        "topo": topo.stdout.strip() or None, "peer_access": peer}
    print(f"NCCL {summary['M0']['nccl']}, torch {torch.__version__}", flush=True)
    built = kernels.build()
    print(f"kernels built: {sorted(built)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        m1_ref, py_ref = os.path.join(tmp, "m1.pt"), os.path.join(tmp, "pythia.pt")
        run_phase("M1 reference", lambda: m1_reference(m1_ref), summary)
        run_phase("M2 reference", lambda: pythia_reference(py_ref), summary)
        os.environ["NCCL_DEBUG"] = "INFO"  # M1's rank logs name NCCL's transports
        run_phase("M1", lambda: m1_gates(spawn("M1", ref_path=m1_ref)), summary)
        os.environ.pop("NCCL_DEBUG")
        if "M2 reference" in summary:
            q = torch.load(py_ref)
            run_phase("M2", lambda: m2_gates(spawn("M2", pythia_path=py_ref), q), summary)
        run_phase("M3", m3, summary)
        run_phase("M4", lambda: m4_gates(spawn("M4")), summary)
        run_phase("M5", lambda: m5_cli(tmp), summary)
    summary["failed"] = FAILED
    summary["wall_s"] = time.perf_counter() - t_start
    print(json.dumps({"multicard": summary}, default=str), flush=True)
    print(cs.card_line(), flush=True)
    if FAILED:
        print(f"FAILED: {FAILED}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
