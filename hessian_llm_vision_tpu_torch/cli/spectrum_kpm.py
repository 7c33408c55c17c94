"""--kpm runner of the spectrum CLI (port of ``cli/spectrum_kpm.py``): the
KPM density, or with ``--kpm_deflate K`` the two-scale density (exact
spikes by thick restart + the KPM bulk of the deflated operator), with its
numbers written into ``args._extra_meta`` and from there into the npz."""

from __future__ import annotations

import time

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.krylov.deflate import deflated_density
from hessian_llm_vision_tpu_torch.krylov.kpm import kpm_density


def run_kpm(args, matvec, dim: int, device: torch.device) -> None:
    """The shared --kpm runner.  Its draws come from a CPU generator seeded
    ``--vector_seed + 2``.  With --kpm_deflate K the kpm_* meta keys
    describe the bulk density, and kpm_deflate_* the spikes."""
    gen = torch.Generator().manual_seed(args.vector_seed + 2)
    t1 = time.time()
    if args.kpm_deflate:
        bf16 = args.tr_dtype == "bfloat16"
        dres = deflated_density(
            matvec, dim, args.kpm_deflate, args.kpm, gen,
            num_probes=args.kpm_probes, progress=True,
            # the --thick_restart memory plan: bf16 restart buffer and bf16
            # deflation basis, with a looser residual bar
            tol=args.tr_tol,
            store_dtype=torch.bfloat16 if bf16 else torch.float32,
            deflate_dtype=torch.bfloat16 if bf16 else None,
            device=device,
        )
        kres = dres.bulk
        status = "converged" if dres.converged else "NOT converged"
        print(f"deflated {args.kpm_deflate} extremal pairs ({status}, max "
              f"residual {dres.residuals.max():.2e}): "
              f"{np.round(np.sort(dres.eigvals), 4).tolist()}")
        print(f"KPM bulk density ({args.kpm} moments x {args.kpm_probes} "
              f"probes on the deflated operator): bulk range "
              f"[{kres.center - kres.radius:.4f}, {kres.center + kres.radius:.4f}], "
              f"combined E[lambda] = {dres.trace_estimate():.6e} "
              f"({time.time() - t1:.2f}s, {dres.matvecs} matvecs)")
        args._extra_meta = {
            **getattr(args, "_extra_meta", {}),
            "kpm_deflate_eigvals": np.asarray(dres.eigvals),
            "kpm_deflate_residuals": np.asarray(dres.residuals),
            "kpm_deflate_converged": int(dres.converged),
            "kpm_deflate_matvecs": dres.matvecs,
        }
    else:
        kres = kpm_density(matvec, dim, args.kpm, gen, num_probes=args.kpm_probes,
                           device=device)
        print(f"KPM density ({args.kpm} moments x {args.kpm_probes} probes): "
              f"range [{kres.center - kres.radius:.4f}, {kres.center + kres.radius:.4f}], "
              f"E[lambda] = {kres.trace_estimate():.6e} ({time.time() - t1:.2f}s)")
    args._extra_meta = {
        **getattr(args, "_extra_meta", {}),
        "kpm_moments": kres.moments,
        "kpm_raw_moments": kres.raw_moments,
        "kpm_center": kres.center,
        "kpm_radius": kres.radius,
        "kpm_probes": kres.num_probes,
    }
