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
  6. device time of a 124M step's pieces (forward, gradient, HVP, update).
Then it prints one JSON line of kernels, the card line, and finally
{"ok": true, "device": {...}}.

Imports torch and the port only (no JAX: the card machine has none).
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

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


def main() -> int:
    phase(1, "device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from hessian_llm_vision_tpu_torch.cli import train as train_cli
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
    print(json.dumps({"step_breakdown": step_breakdown()}))
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s")

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
