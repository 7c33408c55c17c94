"""Post-hoc curvature spectrum of a model (port of ``cli/spectrum.py``).

Dataset-averaged (or single-batch, or layer-restricted) Hessian, or the
single-batch Gauss-Newton / Fisher matrix, seeded probe Lanczos with an
optional Ritz basis (on the device or in host memory), multi-probe SLQ
averaging, per-iteration resumable T checkpoints, converged eigenpairs by
thick restart, the KPM density (optionally deflated), the Hutch++ trace,
per-leaf or per-block spectra, the linearized and the parameter-shaped
low-precision host loops, and the spectrum artifact with an optional stem
plot.  Flag names and defaults are the JAX CLI's.  ``--probe_parallel``
splits the probes of ``--probes N`` over the ranks of a
``torch.distributed`` group (``parallel/probe_parallel.py``), one rank per
card: under ``torchrun`` it joins torchrun's group; launched plainly on a
host with more than one card it starts one NCCL rank per card itself
(``parallel/spawn.py``), as the JAX CLI uses every local chip; on one card
or the CPU the probes run in turn.  Rank 0 prints and writes the artifact.

Runs on the first CUDA device (under ``torchrun``, the rank's own) unless
``--cpu`` is given; without ``--cpu`` and without a card it exits with an
error.  Ambient matmuls are true fp32
(TF32 off for cuBLAS and cuDNN).  ``--hvp_precision auto`` (the default)
probes the checkpoint and may run the blocks in bf16 or TF32 where their
extreme Ritz values stay within 1e-3 of fp32; ``--hvp_precision high``
pins fp32 (``krylov/autoprec.py``, ``models/precision.py``).

Examples:
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model gpt2-tiny --cpu \\
      --host_loop --lanczos_iters 8 --num_batches 2 --batch_size 4 \\
      --max_length 32 --out_spectrum /tmp/s
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model resnet50 \\
      --bn_train_mode --batch_size 128 --num_batches 4 --host_loop \\
      --lanczos_iters 20 --hvp_precision high --out_spectrum resnet
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model gpt2-tiny --cpu \\
      --host_loop --checkpoint ck --precision_check --hvp_precision default
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model gpt2-tiny --cpu \\
      --thick_restart 4 --lanczos_iters 12 --out_spectrum /tmp/tr
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model gpt2-tiny --cpu \\
      --kpm 40 --kpm_deflate 3 --hutchpp 9 --out_spectrum /tmp/kpm
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model gpt2-tiny --cpu \\
      --layerwise --layerwise_group block --host_loop --lanczos_iters 8 \\
      --out_spectrum /tmp/lw --plot /tmp/lw.png
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model gpt2-tiny --cpu \\
      --operator ggn --host_loop --lanczos_iters 8 --out_spectrum /tmp/ggn
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model gpt2-tiny --cpu \\
      --num_batches 1 --host_loop --linearized --lanczos_iters 8
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model gpt2-tiny --cpu \\
      --num_batches 1 --host_loop --bigmodel --bigmodel_q bfloat16
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model gpt2 \\
      --dataset random --num_batches 4 --batch_size 8 --max_length 512 \\
      --attn_block_q 512 --loss_chunk 512 --lanczos_iters 35 --host_loop \\
      --fused_iter --vector_seed 997 --out_spectrum spec
  python -m hessian_llm_vision_tpu_torch.cli.spectrum --model gpt2 \\
      --host_loop --probes 8 --probe_parallel --out_spectrum spec  # every card
  torchrun --standalone --nproc_per_node 4 -m hessian_llm_vision_tpu_torch.cli.spectrum \\
      --model gpt2 --host_loop --probes 8 --probe_parallel --out_spectrum spec
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from typing import Callable, Optional

import torch

from hessian_llm_vision_tpu_torch.cli.common import add_common_args, device_for
from hessian_llm_vision_tpu_torch.cli.precision import (
    referee_loss_fn_for,
    report_precision_probe,
    resolve_auto_precision,
    resolve_mixed_precision,
)
from hessian_llm_vision_tpu_torch.cli.spectrum_flags import validate_flags
from hessian_llm_vision_tpu_torch.cli.spectrum_layerwise import layerwise_main
from hessian_llm_vision_tpu_torch.cli.spectrum_paths import host_loop_main, incore_main
from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
from hessian_llm_vision_tpu_torch.curvature.ggn import FisherOperator, GGNOperator
from hessian_llm_vision_tpu_torch.curvature.operators import (
    DatasetHessianOperator,
    HessianOperator,
    LayerHessianOperator,
)
from hessian_llm_vision_tpu_torch.models.moe import warn_if_topk_curvature
from hessian_llm_vision_tpu_torch.utils import trees

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--lanczos_iters", type=int, default=35)
    p.add_argument("--basis", action="store_true",
                   help="store the Krylov basis / save Ritz vectors")
    p.add_argument("--normalization", default="dataset",
                   help="mean | sum | dataset (artifact scaling convention)")
    p.add_argument("--vector_seed", type=int, default=997,
                   help="seed of the CPU generator every probe vector is drawn from")
    p.add_argument("--probes", type=int, default=1,
                   help=">1: multi-probe SLQ averaging, probes one after another")
    p.add_argument("--hutchpp", type=int, default=0, metavar="M",
                   help="also estimate tr(H) with Hutch++ using M matvecs "
                   "(krylov/trace.py; O(1/M) error vs SLQ's per-probe "
                   "variance). In-core operator paths only")
    p.add_argument("--kpm", type=int, default=0, metavar="M",
                   help="also estimate the spectral DENSITY by the kernel "
                   "polynomial method with M Jackson-damped Chebyshev "
                   "moments (krylov/kpm.py; smooth whole-support density "
                   "at 2 P-vectors of memory; range auto-estimated by a "
                   "12-iter Lanczos probe). Moments land in the npz as "
                   "meta_kpm_*. In-core operator paths only")
    p.add_argument("--kpm_probes", type=int, default=4,
                   help="Rademacher probes averaged per --kpm estimate")
    p.add_argument("--kpm_deflate", type=int, default=0, metavar="K",
                   help="with --kpm M: thick-restart the K largest-|lambda| "
                   "eigenpairs to convergence first (EXACT spikes with "
                   "residual certificates), then run KPM on the deflated "
                   "operator (I-UU^T)A(I-UU^T) — the Chebyshev support "
                   "shrinks to the bulk, improving bulk resolution by "
                   "~(full range / bulk range) at the same moment count "
                   "(krylov/deflate.py)")
    p.add_argument("--layer", default=None,
                   help="restrict to the parameters whose '/'-joined path "
                   "contains this (e.g. h_0/attn)")
    p.add_argument("--layerwise", action="store_true",
                   help="block-diagonal spectrum: one spectrum per leaf")
    p.add_argument("--layerwise_group", default="leaf",
                   choices=["leaf", "block"],
                   help="'leaf': one spectrum per parameter leaf "
                   "(gpt2_savehessian_layer.py); 'block': one per repeated "
                   "transformer block h_i/blocks_i/layers_i, skipping "
                   "embeddings/head (the visual-eigen.ipynb cell-12 sweep)")
    p.add_argument("--group_regex", default=None,
                   help="custom grouping regex for --layerwise (capture "
                   "group 1 = block label); overrides --layerwise_group")
    p.add_argument("--t_checkpoint", default=None,
                   help="save T (and, in-core, the full Lanczos state) every "
                   "iteration (resumable)")
    p.add_argument("--state_every", type=int, default=None,
                   help="write the FULL resume state (2xP f32) only every N "
                   "iterations; the tiny T stays per-iteration. Default: 1 "
                   "below 1e8 params, 5 above")
    p.add_argument("--resume_spectrum", default=None,
                   help="resume an interrupted --t_checkpoint run from its "
                   ".state.npz file")
    p.add_argument("--host_basis", action="store_true",
                   help="keep the Krylov basis in host RAM (basis > HBM; "
                   "the reference's CPU-offload mode)")
    p.add_argument("--host_loop", action="store_true",
                   help="host-driven T-only spectrum over per-batch HVPs "
                   "(LLM scale: no (k,P) basis on the device)")
    p.add_argument("--fused_step", action="store_true",
                   help="with --host_loop + a single batch: HVP and recurrence "
                   "in one step function, in place (two live P-vectors)")
    p.add_argument("--fused_iter", action="store_true",
                   help="accepted for the JAX CLI's flags; the port has one "
                   "host-loop iteration (the per-batch HVPs summed in place, "
                   "the scale, the recurrence), with or without this flag")
    p.add_argument("--probe_parallel", action="store_true",
                   help="with --host_loop --probes N: split the N probes over the "
                   "ranks of a torch.distributed group (N a multiple of the ranks), "
                   "each running its probes in turn; rank 0 writes the artifact. "
                   "Under torchrun it joins its group; launched plainly on a host "
                   "with several cards it starts one NCCL rank per card; on one "
                   "card or --cpu the probes run one after another")
    p.add_argument("--linearized", action="store_true",
                   help="with --host_loop + a single batch: pay the primal "
                   "forward+backward ONCE and run every Lanczos iteration "
                   "on the cached linearization (curvature/linearized.py); "
                   "the residuals stay on the device for the whole run "
                   "(curvature.linearized.residual_bytes counts them)")
    p.add_argument("--qprev_bf16", action="store_true",
                   help="with --fused_step: store the lagged Lanczos vector in "
                   "bf16 (~1e-3 extreme-Ritz perturbation)")
    p.add_argument("--bigmodel", action="store_true",
                   help="with --host_loop + a single batch: parameter-shaped "
                   "Krylov vectors stored in --bigmodel_q, f32 arithmetic "
                   "(no flat P-vector; the memory plan for models near the "
                   "card's memory)")
    p.add_argument("--bigmodel_q", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="Krylov vector storage dtype for --bigmodel")
    p.add_argument("--operator", default="hessian",
                   help="hessian | ggn | fisher (GGN = J^T H_out J, Fisher = "
                   "GGN of the NLL — colaexp.py parity; single-batch)")
    p.add_argument("--thick_restart", type=int, default=0, metavar="K",
                   help="compute K CONVERGED extremal eigenpairs by "
                   "thick-restart Lanczos (Wu & Simon) inside a fixed "
                   "--lanczos_iters-vector basis buffer — converged "
                   "eigenbases at bounded memory, beyond the reference's "
                   "one-pass bases. In-core operator paths only")
    p.add_argument("--tr_which", default="lm",
                   choices=["lm", "la", "sa", "both"],
                   help="which end of the spectrum --thick_restart targets "
                   "(largest magnitude / algebraic ends / both)")
    p.add_argument("--tr_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="basis-buffer storage dtype for --thick_restart "
                   "(bfloat16 halves the (inner+1, P) buffer; recurrence "
                   "arithmetic stays f32 — the --bigmodel_q convention)")
    p.add_argument("--tr_tol", type=float, default=1e-6,
                   help="relative residual tolerance for --thick_restart "
                   "(scale = max|theta|; raise to ~2e-3 with bf16 storage)")
    p.add_argument("--no_reorth", action="store_true")
    p.add_argument("--precision_check", action="store_true",
                   help="before the spectrum, run a short T-only Lanczos on "
                   "batch 1 in BOTH the requested precision and an fp32 "
                   "referee (2x--precision_check_iters HVPs) and warn when "
                   "the extreme Ritz values disagree beyond the 2e-3 parity "
                   "bar: low-precision curvature error depends on the "
                   "checkpoint (--operator hessian only)")
    p.add_argument("--precision_check_iters", type=int, default=10,
                   help="Lanczos iterations per arm of --precision_check, and "
                   "of each probe arm of --hvp_precision auto")
    p.add_argument("--hvp_precision", default="auto",
                   choices=["auto", "high", "highest", "default", "mixed"],
                   help="matmul precision of the curvature products. 'auto' "
                   "(default) probes THIS checkpoint: short reorthogonalised "
                   "Lanczos arms on one batch against the fp32 referee, "
                   "mixed (blocks bf16) then blocks TF32, the first within the "
                   "1e-3 extreme-Ritz bar wins, else fp32 (krylov/autoprec.py; "
                   "a plan file next to --checkpoint is reused). 'high' and "
                   "'highest' are true fp32; 'default' runs every product "
                   "with bf16 operands; 'mixed' pins blocks 'default' + vocab "
                   "head 'high' (LM models only; safe at init only)")
    p.add_argument("--out_spectrum", default=None)
    p.add_argument("--plot", default=None, help="save stem plot PNG")
    p.add_argument("--compare_to", default=None,
                   help="npz or reference torch .ckpt spectrum to compare "
                   "against (prints max relative Ritz error)")
    return p


def _refuse_unknown_operator(args) -> None:
    if args.operator not in ("hessian", "ggn", "fisher"):
        raise SystemExit(f"unknown --operator {args.operator!r}")


def _precision_check(args, wl) -> None:
    """--precision_check: the requested-precision HVP against the fp32
    referee on batch 1, reported by ``cli.precision.report_precision_probe``."""
    if args.operator != "hessian":
        # the probe gates the Hessian matvec; a GGN/Fisher job runs another
        # program with its own precision sensitivity
        raise SystemExit(
            f"--precision_check supports --operator hessian only "
            f"(the {args.operator} matvec is a different program; "
            "probe it via krylov.matvec_precision_probe on a GGN "
            "closure if needed)"
        )
    from hessian_llm_vision_tpu_torch.krylov.driver import matvec_precision_probe

    stats = matvec_precision_probe(
        wl.loss_fn, wl.params, wl.batches[0],
        generator=torch.Generator().manual_seed(args.vector_seed),
        precision=args.hvp_precision,
        referee_loss_fn=referee_loss_fn_for(args, wl),
        ritz_iters=args.precision_check_iters,
    )
    report_precision_probe(
        stats, args.precision_check_iters, what="HVP",
        hint="the spectrum's extreme eigenvalues will be unreliable; "
             "rerun with --hvp_precision high (or highest) and without "
             "--block_precision",
    )


def _refuse_layerwise_drops(args) -> None:
    """--layerwise runs one plain Hessian Lanczos per block: the flags it
    would drop exit, with the JAX CLI's message."""
    dropped = [flag for flag, set_ in [
        ("--probes", args.probes > 1),
        ("--basis", args.basis),
        ("--t_checkpoint", bool(args.t_checkpoint)),
        ("--resume_spectrum", bool(args.resume_spectrum)),
        ("--compare_to", bool(args.compare_to)),
        ("--operator " + args.operator, args.operator != "hessian"),
        ("--fused_step", args.fused_step),
        ("--bigmodel", args.bigmodel),
        ("--host_basis", args.host_basis),
    ] if set_]
    if dropped:
        raise SystemExit(f"--layerwise does not support {', '.join(dropped)}; "
                         "each block runs a plain T-only (or in-core) Hessian Lanczos")


def _make_operator(args, wl):
    batches = wl.batches
    n_total = len(batches) * wl.batch_size
    single_norm = "mean" if args.normalization == "dataset" else args.normalization
    if args.operator in ("ggn", "fisher"):
        if wl.model_fn is None:
            raise SystemExit(f"--operator {args.operator} unsupported for "
                             f"model {wl.name!r} (no model_fn)")
        if len(batches) > 1:
            print(f"[{args.operator}] single-batch operator: using batch 1 of {len(batches)}")
        maker = GGNOperator if args.operator == "ggn" else FisherOperator
        return maker(wl.model_fn, wl.out_loss_fn, wl.params, batches[0], damping=0.0,
                     precision=args.hvp_precision)
    if args.layer:
        mask = trees.subtree_mask(wl.params, lambda label: args.layer in label)
        n_sel = sum(mask.values())
        if n_sel == 0:
            raise SystemExit(f"--layer {args.layer!r} matches no parameters")
        print(f"[layer] restricting to {n_sel} parameter leaves")
        if len(batches) > 1:
            print(f"[layer] single-batch operator: using batch 1 of {len(batches)} "
                  "(combine with --num_batches 1 to silence)")
        return LayerHessianOperator(wl.loss_fn, wl.params, batches[0], mask,
                                    normalization=single_norm, batch_size=wl.batch_size)
    if len(batches) == 1:
        return HessianOperator(wl.loss_fn, wl.params, batches[0], normalization=single_norm,
                               batch_size=wl.batch_size, dataset_size=n_total)
    return DatasetHessianOperator(wl.loss_fn, wl.params, batches,
                                  normalization=args.normalization,
                                  batch_size=wl.batch_size, dataset_size=n_total,
                                  remat=False)  # as the JAX CLI: the memory is not needed here


def main(argv=None, on_iter: Optional[Callable[[int, float], None]] = None):
    """Run the spectrum job; returns ``(spectrum, result)``: the last
    probe's ``LanczosResult`` (None for multi-probe SLQ), or the
    ``ThickRestartResult`` of ``--thick_restart``; for ``--layerwise``,
    ``({label: Spectrum}, None)``.  ``on_iter(i, seconds)``
    receives each host-loop iteration's seconds, synchronised with the
    device."""
    args = build_parser().parse_args(argv)
    validate_flags(args)
    _refuse_unknown_operator(args)
    if args.layerwise:
        _refuse_layerwise_drops(args)
    if args.probe_parallel:
        from hessian_llm_vision_tpu_torch.parallel import dist_init
        from hessian_llm_vision_tpu_torch.parallel.probe_parallel import rank_plan

        ranks = rank_plan(torch.cuda.device_count(), args.probes, cpu=args.cpu,
                          launched=dist_init.launched())
        if ranks:
            return over_cards(list(sys.argv[1:] if argv is None else argv), ranks)
        # torchrun's group (a no-op when one is up, or without torchrun);
        # a NCCL rank makes its own card current before device_for reads it
        dist_init.initialize(cpu=args.cpu)
    device = device_for(args.cpu)
    # ambient matmuls are true fp32: TF32 and bf16 come only through the
    # precision ladder (--hvp_precision, --block_precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resolve_mixed_precision(args, "hvp_precision")
    wl = build_workload(args, device)
    # curvature over top-k MoE routing is region-conditional: a loud warning
    warn_if_topk_curvature(wl.model, what="spectrum")
    # --hvp_precision auto (the default): probe this checkpoint and resolve
    # a concrete plan, after the flag checks
    wl = resolve_auto_precision(args, wl)
    if args.precision_check:
        _precision_check(args, wl)
    if args.layerwise:
        return layerwise_main(args, wl, device), None
    if args.host_loop:
        return host_loop_main(args, wl, device, on_iter)
    return incore_main(args, wl, _make_operator, device)


def over_cards(argv: list, ranks: int):
    """``main(argv)`` on ``ranks`` NCCL ranks, one per card of this host,
    started here (``parallel/spawn.py``) in this working directory; rank 0's
    output is printed and its ``(spectrum, results)`` returned."""
    from hessian_llm_vision_tpu_torch.parallel.spawn import run_ranks

    print(f"probe-parallel: starting {ranks} NCCL ranks, one per card", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        out = run_ranks(f"{__name__}:rank_main", ranks, workdir, backend="nccl",
                        kwargs={"argv": argv}, timeout=None, cwd=os.getcwd())
    print(out[0]["log"], end="", flush=True)
    print(f"probe-parallel: ranks on cards {[r['result']['card'] for r in out]}", flush=True)
    return out[0]["result"]["out"]


def rank_main(mesh, *, argv: list) -> dict:
    """One rank of :func:`over_cards`: the CLI in the group; its results on
    the host and its card."""
    card = torch.cuda.current_device() if torch.cuda.is_available() else None
    return {"out": _on_host(main(argv)), "card": card}


def _on_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _on_host(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a NamedTuple (Spectrum)
        return type(obj)(*(_on_host(x) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_host(x) for x in obj)
    return obj


if __name__ == "__main__":
    main()
