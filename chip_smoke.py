"""On-card smoke test of the PyTorch port: builds the CUDA kernels, holds
each against its plain PyTorch version, drives LanczosSGD training of GPT-2
124M through the train CLI, and checks the result.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero and prints no result line):
  1. require a CUDA device; print the card's name and power limit;
  2. build every kernel from ops/csrc (nvcc; registers and spills printed
     by kernel name) and print pass 1's launch plan at the timed shapes,
     with the resident blocks per SM the wrapper got from the occupancy API;
  3. rank-k kernels vs their plain versions at (10, 124,046,592) -- the
     trainer's shape -- and (35, 124,046,592), (35, 16384), (3, 20000),
     (5, 20001), f32 and bf16 bases, each also rerun for bitwise equality;
     at the two 124M shapes, kernel and a one-call library yardstick timed
     in turns (median and min-max, nvidia-smi sampled beside), then the
     plain version;
  4. main path: 4 LanczosSGD steps of GPT-2 124M (bs8, seq512, k=10, bf16
     basis) via cli.train.main, with every launch count zeroed just before
     and read just after; each rank-k kernel must run once per step;
  5. the same trainer on gpt2-tiny, card against CPU, must agree;
  6. device time of a 124M step's pieces (forward, gradient, HVP, update);
  7. spectrum: (a) cli.spectrum.main on gpt2-tiny, card against CPU, host
     loop and in-core CGS2: lambda_max and lambda_min within 1e-5
     relative, the first 3 alphas within 1e-5 of the spectrum's scale;
     (b) the headline job through cli.spectrum.main -- GPT-2 124M, 4
     batches x bs8 x seq512, 35 T-only iterations of the dataset-mean
     Hessian -- with its gates (finite Ritz values, lambda_max > 0 >
     lambda_min, weights summing to 1, |trace| <= 1e-2 lambda_max, the
     artifact read back, no rank-k launch) and one {"spectrum": ...} JSON
     line of its times and memory; (c) at that shape, the f32 HVP on (b)'s
     start vector against a float64 central difference of reverse-mode
     gradients on the card, and (b)'s alpha_1 against it; a TF32 HVP must
     miss the same limit.
Then it prints one JSON line of kernels, the card line, and finally
{"ok": true, "device": {...}}.

Imports torch, numpy and the port only (no JAX: the card machine has none).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

P_124M = 124_046_592  # GPT-2 124M parameters at n_positions 512
TIMED_DTYPES = (torch.bfloat16, torch.float32)
TIMED_KS = (10, 35)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
KERNEL_SRC = "hessian_llm_vision_tpu_torch/ops/csrc/rank_k.cu"
TPU_KERNELS = {
    "rank_k_dots": "hessian_llm_vision_tpu/ops/spectral.py:130",  # _dots_kernel
    "rank_k_axpy": "hessian_llm_vision_tpu/ops/spectral.py:155",  # _axpy_kernel
}
TRAIN_ARGV = [
    "--model", "gpt2", "--optimiser", "lanczos-host", "--dataset", "random",
    "--batch_size", "8", "--max_length", "512", "--num_batches", "4",
    "--k", "10", "--delta", "1e-4", "--lr", "1e-3", "--momentum", "0.9",
    "--refresh_every", "2", "--lanczos_momentum", "0.9", "--max_steps", "4",
    "--seed", "0",
]
# bench.py's headline job (4 batches x bs8 x seq512, 35 iterations, T-only
# dataset-mean host loop; --fused_iter is bench.py's flag, one path here), in fp32
SPECTRUM_ARGV = [
    "--model", "gpt2", "--dataset", "random", "--num_batches", "4", "--batch_size", "8",
    "--max_length", "512", "--attn_block_q", "512", "--loss_chunk", "512",
    "--lanczos_iters", "35", "--host_loop", "--fused_iter", "--vector_seed", "997",
]
TINY_SPECTRUM_ARGV = [
    "--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "32", "--num_batches", "2",
    "--lanczos_iters", "12", "--vector_seed", "5",
]
# the JAX package's committed 124M spectrum (3 probes, mixed precision, its own weights)
JAX_SPECTRUM = "artifacts/slq_multiprobe_r3/spec.npz"
# 7a: card against CPU on gpt2-tiny (readings 3.4e-7 and 2.6e-7 for the
# extremes, PERF.md); the alphas only before late steps amplify rounding
CARD_CPU_LAMBDA_RTOL = 1e-5
CARD_CPU_EARLY_ALPHAS = 3
CARD_CPU_ALPHA_TOL = 1e-5  # of max |lambda|
# 7c: step along the unit start vector of the float64 central difference,
# and the rel-L2 limit of the f32 HVP (and of alpha_1) against it: about
# 10x the f32 reading 2.1e-6, 75x below the TF32 reading 1.5e-3 (PERF.md)
FD_EPS = 1e-4
HVP_FD_LIMIT = 2e-5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def timings(kernel, plain, library, *, nbytes: float, flops: float) -> dict:
    """Kernel and library call timed in turns on one card: 10 warm-up
    launches each, then 5 rounds of (kernel, library, library, kernel), 20
    launches a timing, nvidia-smi sampled beside; median and min-max of the
    10 timings of each.  Then the plain version, and the bound."""
    from hessian_llm_vision_tpu_torch.utils.cuda_timing import in_turns, smi_samples, time_ms

    with smi_samples() as smi:
        t = in_turns({"kernel": kernel, "library": library}, rounds=5, iters=20, warmup=10)
    plain_ms = time_ms(plain, iters=5, warmup=1)
    bound, bound_by = bound_ms(nbytes, flops)
    return {"ms": t["kernel"]["ms"], "ms_spread": [t["kernel"]["min"], t["kernel"]["max"]],
            "plain_ms": plain_ms, "library_ms": t["library"]["ms"],
            "library_spread": [t["library"]["min"], t["library"]["max"]],
            "bound_ms": bound, "bound_by": bound_by, "smi": smi}


def without_smi(t: dict) -> dict:
    return {key: v for key, v in t.items() if key != "smi"}


def phase(n: int, title: str):
    print(f"\n[phase {n}] {title}", flush=True)
    return time.perf_counter()


def check_rank_k(kernels, spectral, dtype, k, p, gen, timed: bool) -> dict:
    """Kernel vs plain versions on one shape; timings when ``timed``."""
    dev = torch.device("cuda")
    V = torch.randn((k, p), generator=gen, device=dev, dtype=dtype).mul_(1.0 / math.sqrt(p))
    g = torch.randn(p, generator=gen, device=dev)
    c = torch.randn(k, generator=gen, device=dev)
    w = kernels.rank_k_dots(g, V, c)
    out = kernels.rank_k_axpy(g, V, w)
    repeatable = torch.equal(w, kernels.rank_k_dots(g, V, c)) and torch.equal(
        out, kernels.rank_k_axpy(g, V, w)
    )
    torch.cuda.synchronize()
    w_ref = spectral.rank_k_dots_reference(g, V, c)
    ref = spectral.rank_k_apply_reference(g, V, c)
    axpy_ref = spectral.rank_k_axpy_reference(g, V, w_ref)
    out_same_w = kernels.rank_k_axpy(g, V, w_ref)
    res = {
        "dtype": str(dtype).removeprefix("torch."), "k": k, "P": p,
        "rel_l2_vs_reference": rel_l2(out, ref),
        "rel_l2_dots": rel_l2(w, w_ref),
        "dots_max_abs_err": float((w - w_ref).abs().max()),
        "axpy_max_abs_err": float((out_same_w - axpy_ref).abs().max()),
        "bitwise_repeatable": repeatable,
    }
    ok = repeatable and res["rel_l2_vs_reference"] <= 1e-5 and res["rel_l2_dots"] <= 1e-5
    if dtype == torch.bfloat16:
        res["rel_l2_vs_bf16_plain"] = rel_l2(out, spectral.rank_k_apply_bf16(g, V, c))
        ok = ok and res["rel_l2_vs_bf16_plain"] <= 2e-3
    del out_same_w, axpy_ref, ref
    if timed:
        es = V.element_size()
        # library yardstick: torch.mv / torch.addmv take one dtype, so with a
        # bf16 basis g and w are rounded to bf16 (as rank_k_apply_bf16 does)
        gl, wl = g.to(dtype), w_ref.to(dtype)
        res["rank_k_dots"] = timings(
            lambda: kernels.rank_k_dots(g, V, c),
            lambda: spectral.rank_k_dots_reference(g, V, c),
            lambda: torch.mv(V, gl),
            nbytes=k * p * es + 4 * p + 8 * k, flops=2 * k * p,
        )
        res["rank_k_axpy"] = timings(
            lambda: kernels.rank_k_axpy(g, V, w_ref),
            lambda: spectral.rank_k_axpy_reference(g, V, w_ref),
            lambda: torch.addmv(gl, V.t(), wl),
            nbytes=k * p * es + 8 * p + 4 * k, flops=2 * k * p + p,
        )
        for name in ("rank_k_dots", "rank_k_axpy"):
            res[name]["max_abs_err"] = res[f"{name.split('_')[-1]}_max_abs_err"]
    res["ok"] = bool(ok)
    print(json.dumps(res), flush=True)
    return res


def step_breakdown() -> dict:
    """Device time of the pieces of a GPT-2 124M LanczosSGD step at the
    main path's shapes (bs8, seq512, "sum" HVPs, fp32 matmuls), by CUDA
    events: the loss forward, one gradient, one HVP (a refresh runs k of
    them), and the flatten/update work around them."""
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp_fn
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.losses import lm_loss_fn
    from hessian_llm_vision_tpu_torch.utils.cuda_timing import time_ms
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    dev = torch.device("cuda")
    B, T = 8, 512
    cfg = GPT2Config.gpt2_124m(n_positions=T)
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    params = {n: p.detach() for n, p in model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev)
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids)}
    loss_fn = lm_loss_fn(model)
    fl = Flattener(params)
    v = fl.unflatten(torch.randn(fl.size, generator=gen, device=dev) / math.sqrt(fl.size))
    hvp = hvp_fn(loss_fn, normalization="sum", batch_size=B)
    momentum = {n: torch.zeros_like(p) for n, p in params.items()}
    g_flat = fl.flatten(grad_and_loss(loss_fn, params, batch)[1])

    def update(lr=0.0):  # the trainer's unflatten + momentum/SGD arithmetic; lr 0 keeps the weights
        for name, a in fl.unflatten(g_flat).items():
            momentum[name].mul_(0.9).add_(a)
            params[name].sub_(lr * momentum[name])

    with torch.no_grad():
        forward_ms = time_ms(lambda: loss_fn(params, batch), iters=5, warmup=1)
    C, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    return {
        "forward_ms": forward_ms,
        "grad_ms": time_ms(lambda: fl.flatten(grad_and_loss(loss_fn, params, batch)[1]),
                           iters=5, warmup=1),
        "hvp_ms": time_ms(lambda: fl.flatten(hvp(params, batch, v)), iters=5, warmup=1),
        "update_ms": time_ms(update, iters=5, warmup=1),
        # matmul operations of one forward, from the shapes
        "forward_flops": B * T * (L * (24 * C * C + 4 * T * C) + 2 * C * V),
        "P": fl.size,
    }


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def spectrum_card_vs_cpu(spectrum_cli) -> dict:
    """Phase 7a: the spectrum CLI on gpt2-tiny on the card and on the CPU,
    same flags and probe vector, host loop and in-core CGS2.  The extreme
    Ritz values are held to the card; the alphas only over the first
    iterations, as late Lanczos steps amplify the two BLAS libraries'
    rounding in the unconverged interior of T."""
    out = {}
    for name, mode in (("host_loop", ["--host_loop"]), ("incore_cgs2", [])):
        (card, res_card), (cpu, res_cpu) = (spectrum_cli.main(TINY_SPECTRUM_ARGV + mode + extra)
                                            for extra in ([], ["--cpu"]))
        rel = {"lambda_max": abs(float(card.eigvals.max()) / float(cpu.eigvals.max()) - 1),
               "lambda_min": abs(float(card.eigvals.min()) / float(cpu.eigvals.min()) - 1)}
        a_card, a_cpu = res_card.alphas.cpu().numpy(), res_cpu.alphas.numpy()
        scale = max(abs(float(cpu.eigvals.max())), abs(float(cpu.eigvals.min())))
        n = CARD_CPU_EARLY_ALPHAS
        early = np.abs(a_card[:n] - a_cpu[:n]) / scale
        worst = int(np.argmax(np.abs(a_card - a_cpu) / np.abs(a_cpu)))
        out[name] = {**rel, "early_alphas_err_over_scale": early.tolist(),
                     "alphas_max_rel": max_rel(res_card.alphas, res_cpu.alphas),
                     "alphas_worst": {"index": worst, "card": float(a_card[worst]),
                                      "cpu": float(a_cpu[worst])}}
        if max(rel.values()) > CARD_CPU_LAMBDA_RTOL or early.max() > CARD_CPU_ALPHA_TOL:
            raise SystemExit(f"spectrum CLI on card and CPU disagree ({name}): {out[name]}")
    return out


def headline_spectrum(spectrum_cli, spectra, kernels, hvp_ms: float) -> dict:
    """Phase 7b: the headline job through cli.spectrum.main, its gates and
    its numbers."""
    iter_s = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec")
        t0 = time.perf_counter()
        spec, lres = spectrum_cli.main(SPECTRUM_ARGV + ["--out_spectrum", path],
                                       on_iter=lambda i, sec: iter_s.append(sec))
        main_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        back = spectra.load_spectrum(path)
    launches = dict(kernels.LAUNCHES)
    ev = spec.eigvals
    lam_max, lam_min = float(ev.max()), float(ev.min())
    trace = float(torch.dot(spec.eigvals, spec.gammas))
    gamma_sum = float(spec.gammas.sum())
    loop_s, hvps = sum(iter_s), 35 * 4
    with np.load(JAX_SPECTRUM) as z:
        jax_lam_max = float(z["eigvals"].max())
    res = {
        "hvps": hvps, "lanczos_loop_s": loop_s, "hvps_per_s": hvps / loop_s,
        "s_per_hvp": loop_s / hvps, "phase6_hvp_s": hvp_ms / 1e3,
        "loop_over_140_phase6_hvps": loop_s / (hvps * hvp_ms / 1e3),
        "iter_s": {"median": statistics.median(iter_s), "min": min(iter_s),
                   "max": max(iter_s), "first": iter_s[0],
                   "max_after_first": max(iter_s[1:]), "n": len(iter_s)},
        "main_s": main_s, "max_memory_allocated_bytes": peak,
        "lambda_max": lam_max, "lambda_min": lam_min, "trace_estimate": trace,
        "gamma_sum": gamma_sum, "alpha_1": float(lres.alphas[0]), "rank_k_launches": launches,
        "jax_artifact_lambda_max": {
            "value": jax_lam_max, "source": JAX_SPECTRUM,
            "note": "reference point, other weights and precision, not a gate"},
    }
    print(json.dumps({"spectrum": res}))
    gates = {
        "35 iterations timed": len(iter_s) == 35,
        "finite Ritz values": bool(torch.isfinite(ev).all()),
        "lambda_max > 0 > lambda_min": lam_max > 0 > lam_min,
        "gammas sum to 1 within 1e-3": abs(gamma_sum - 1) <= 1e-3,
        "|trace| <= 1e-2 lambda_max": abs(trace) <= 1e-2 * lam_max,
        "artifact reads back": all(torch.equal(a, b) for a, b in
                                   ((back.eigvals, spec.eigvals), (back.gammas, spec.gammas))),
        "no rank-k launch": all(n == 0 for n in launches.values()),
    }
    failed = [g for g, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"headline spectrum failed its gates: {failed}")
    return res


def central_difference_hvp(loss_fn, params, batches, v: torch.Tensor, eps: float):
    """float64 reference for the dataset-mean Hessian times ``v``: a
    central difference of the batch-mean gradient, by reverse mode in
    float64 (not the forward-over-reverse HVP).  Returns the fourth-order
    difference (8 (g(+e) - g(-e)) - (g(+2e) - g(-2e))) / 12e and the
    second-order (g(+e) - g(-e)) / 2e; their distance bounds the
    truncation error of the reference."""
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    fl = Flattener(params)
    p64 = {n: t.double() for n, t in params.items()}
    v64 = {n: t.double() for n, t in fl.unflatten(v).items()}

    def mean_grad(step):
        shifted = {n: p64[n] + step * v64[n] for n in p64}
        g = torch.zeros(fl.size, dtype=torch.float64, device=v.device)
        for batch in batches:
            grads = grad_and_loss(loss_fn, shifted, batch)[1]
            g += torch.cat([grads[n].reshape(-1) for n in fl.names])
            del grads
        return g / len(batches)

    d1 = mean_grad(eps) - mean_grad(-eps)
    d2 = mean_grad(2 * eps) - mean_grad(-2 * eps)
    return (8 * d1 - d2) / (12 * eps), d1 / (2 * eps)


def hvp_vs_central_difference(spectrum_cli, alpha_1: float) -> dict:
    """Phase 7c: at the headline shape, the port's f32 dataset-mean HVP
    (per-batch HVPs summed and scaled, as the host loop does) on 7b's start
    vector against a float64 central difference of gradients on the card;
    7b's alpha_1 against the difference's q1.Hq1.  A TF32 HVP must miss the
    limit, which shows that the check can see reduced precision."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.operators import DatasetHessianOperator
    from hessian_llm_vision_tpu_torch.krylov.lanczos import start_vector

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    args = spectrum_cli.build_parser().parse_args(SPECTRUM_ARGV)
    wl = build_workload(args, dev)
    dim = sum(p.numel() for p in wl.params.values())
    # the CLI's first probe: drawn on the CPU, copied, normalised on the card
    v0 = torch.randn(dim, generator=torch.Generator().manual_seed(args.vector_seed)).to(dev)
    q1 = start_vector(v0, None, dim)

    def port_hvp(precision):
        return DatasetHessianOperator(wl.loss_fn, wl.params, wl.batches, normalization="mean",
                                      precision=precision).matvec(q1)

    hv = port_hvp("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        hv_tf32 = port_hvp(None)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref, ref2 = central_difference_hvp(wl.loss_fn, wl.params, wl.batches, q1, FD_EPS)
    torch.cuda.synchronize()
    ref_norm = float(torch.linalg.vector_norm(ref))
    alpha_fd = float(torch.dot(q1.double(), ref))
    res = {"eps": FD_EPS, "limit": HVP_FD_LIMIT, "hv_norm": ref_norm,
           "rel_l2_hvp_vs_fd": rel_l2(hv, ref),
           "rel_l2_tf32_hvp_vs_fd": rel_l2(hv_tf32, ref),
           "rel_l2_fd2_vs_fd4": rel_l2(ref2, ref),
           "alpha_1": alpha_1, "alpha_1_fd": alpha_fd,
           "alpha_1_err_over_hv_norm": abs(alpha_1 - alpha_fd) / ref_norm,
           "build_and_hvps_s": t1 - t0, "fd_s": time.perf_counter() - t1,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps({"hvp_vs_central_difference": res}))
    gates = {
        "f32 HVP within the limit": res["rel_l2_hvp_vs_fd"] <= HVP_FD_LIMIT,
        "7b alpha_1 within the limit": res["alpha_1_err_over_hv_norm"] <= HVP_FD_LIMIT,
        "reference's truncation within the limit": res["rel_l2_fd2_vs_fd4"] <= HVP_FD_LIMIT,
        "TF32 HVP misses the limit": res["rel_l2_tf32_hvp_vs_fd"] > HVP_FD_LIMIT,
    }
    failed = [g for g, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"HVP against the float64 central difference failed: {failed}")
    return res


def main() -> int:
    phase(1, "device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from hessian_llm_vision_tpu_torch.cli import spectrum as spectrum_cli
    from hessian_llm_vision_tpu_torch.cli import train as train_cli
    from hessian_llm_vision_tpu_torch.io import spectra
    from hessian_llm_vision_tpu_torch.ops import kernels, spectral

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  python {sys.version.split()[0]}")

    t0 = phase(2, "build kernels")
    for res in kernels.build().values():
        print(f"built {res.path.name} in {res.seconds:.2f} s")
        for name, use in kernels.ptxas_usage(res.log).items():
            print(f"  {name}: {use['registers']} registers, {use['spill_bytes']} bytes spilled")
    for dtype in TIMED_DTYPES:
        for k in TIMED_KS:
            plan = kernels.dots_launch_plan(k, P_124M, dtype, "cuda")
            print(json.dumps({"rank_k_dots_plan": {"dtype": str(dtype).removeprefix("torch."),
                                                   "k": k, "P": P_124M,
                                                   **dataclasses.asdict(plan)}}))
    print(f"phase 2 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(3, "rank-k kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    checks = {}
    for dtype in TIMED_DTYPES:
        # (35, P): k*P > 2**31 needs 64-bit offsets; P = 20001 takes the
        # scalar-load path (P not a multiple of the 16-byte vector)
        for k, p in ((10, P_124M), (35, P_124M), (35, 16384), (3, 20000), (5, 20001)):
            checks[(dtype, k, p)] = check_rank_k(
                kernels, spectral, dtype, k, p, gen, timed=(p == P_124M)
            )
            torch.cuda.empty_cache()
    failed = [key for key, r in checks.items() if not r["ok"]]
    if failed:
        raise SystemExit(f"rank-k kernel disagrees with its plain version at {failed}")
    for dtype in TIMED_DTYPES:  # pass 1 and the pair, per timed shape
        for k in TIMED_KS:
            d, a = (checks[(dtype, k, P_124M)][n] for n in TPU_KERNELS)
            print(f"{str(dtype).removeprefix('torch.'):8s} k={k:2d}: rank_k_dots "
                  f"{d['ms']:.3f} ms [{d['ms_spread'][0]:.3f}-{d['ms_spread'][1]:.3f}] "
                  f"library {d['library_ms']:.3f} bound {d['bound_ms']:.3f}; rank_k_axpy "
                  f"{a['ms']:.3f} ms; pair {d['ms'] + a['ms']:.3f} ms")
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(4, "main path: LanczosSGD on GPT-2 124M through cli.train.main")
    records = []
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    train_cli.main(TRAIN_ARGV, on_step=lambda step, rec: records.append(rec))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"train_steps": records, "launches": launches,
                      "max_memory_allocated_bytes": peak}))
    if len(records) != 4:
        raise SystemExit(f"expected 4 steps, got {len(records)}")
    if not all(math.isfinite(v) for r in records for v in r.values()):
        raise SystemExit("non-finite loss or eigenvalue in the main path")
    if abs(records[0]["loss"] - math.log(50257)) > 0.25:
        raise SystemExit(f"step-0 loss {records[0]['loss']} far from ln(50257) at init")
    for name in TPU_KERNELS:
        if launches[name] != 4:
            raise SystemExit(f"{name} launched {launches[name]} times in 4 steps, expected 4")
    print(f"phase 4 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(5, "gpt2-tiny trainer: card vs CPU")
    tiny = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "32", "--k", "4",
            "--delta", "1e-2", "--refresh_every", "2", "--lanczos_momentum", "0.5",
            "--max_steps", "3", "--no-basis_bf16"]
    on_card, on_cpu = [], []
    train_cli.main(tiny, on_step=lambda s, r: on_card.append(r))
    train_cli.main(tiny + ["--cpu"], on_step=lambda s, r: on_cpu.append(r))
    for a, b in zip(on_card, on_cpu, strict=True):
        if not (math.isclose(a["loss"], b["loss"], rel_tol=1e-5)
                and math.isclose(a["eig_max"], b["eig_max"], rel_tol=1e-3)):
            raise SystemExit(f"card and CPU trainers disagree: {a} vs {b}")
    print(f"phase 5 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(6, "where a 124M training step's time goes")
    breakdown = step_breakdown()
    print(json.dumps({"step_breakdown": breakdown}))
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(7, "spectrum: gpt2-tiny card vs CPU, the GPT-2 124M headline job, "
                  "its HVP against a float64 central difference")
    print(json.dumps({"spectrum_card_vs_cpu": spectrum_card_vs_cpu(spectrum_cli)}))
    print(f"phase 7a took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    headline = headline_spectrum(spectrum_cli, spectra, kernels, breakdown["hvp_ms"])
    print(f"phase 7b took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    hvp_vs_central_difference(spectrum_cli, headline["alpha_1"])
    print(f"phase 7c took {time.perf_counter() - t0:.1f} s")

    entries = []
    for name, replaces in TPU_KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": KERNEL_SRC, "replaces": replaces,
                 "launches": launches[name]}
        entry.update(without_smi(checks[(torch.bfloat16, 10, P_124M)][name]))
        entry.update({"dtype": "bfloat16", "shape": [10, P_124M],
                      "f32": without_smi(checks[(torch.float32, 10, P_124M)][name]),
                      "k35": {str(dt).removeprefix("torch."): without_smi(checks[(dt, 35, P_124M)][name])
                              for dt in TIMED_DTYPES},
                      "checks_passed": len(checks)})
        entries.append(entry)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
