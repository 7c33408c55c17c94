"""Spectrum CLI report and artifacts (port of ``cli/spectrum_report.py``):
the console report with the ghost-cluster warning, the npz or torch
artifact, the stem plot and the ``--compare_to`` metrics.  The last stdout
lines are the JAX CLI's, so a user reads the same numbers in the same
place."""

from __future__ import annotations

from typing import Optional

import numpy as np

from hessian_llm_vision_tpu_torch.io import spectra
from hessian_llm_vision_tpu_torch.krylov import compare
from hessian_llm_vision_tpu_torch.krylov.slq import trace_estimate


def report_and_outputs(args, spec, wall: float, dim: int, num_batches: int,
                       n_matvecs: Optional[int] = None, partial_measure: bool = False) -> None:
    """Print the report; write ``--out_spectrum`` (with the producers'
    ``args._extra_meta`` as ``meta_<key>``) / ``--plot``; compare with
    ``--compare_to``.  ``num_batches`` counts the HVPs of one matvec (times
    the probes), so HVPs/s compares across paths; ``n_matvecs`` replaces
    ``--lanczos_iters`` as the matvec count (thick restart).
    ``partial_measure``: the gammas cover only converged pairs, so no
    ghost-cluster warning and no trace estimate is printed."""
    ev = np.sort(spec.eigvals.numpy())
    print(f"P = {dim}")
    print(f"lambda_max = {ev[-1]:.6f}  lambda_min = {ev[0]:.6f}")
    print(f"top-5 Ritz: {np.round(ev[-5:], 4).tolist()}")
    # ghost-cluster detector: a T-only (unreorthogonalized) Lanczos at ill
    # conditioning replicates a converged extreme into a cluster of
    # near-identical Ritz values while the estimate itself drifts; a
    # genuine SLQ top-5 has spread
    if not partial_measure and len(ev) >= 3:
        top = ev[-3:]
        scale = max(abs(float(top[-1])), 1e-30)
        if float(top[-1] - top[0]) / scale < 1e-4:
            print(
                "WARNING: the top 3 Ritz values agree to <1e-4 relative — "
                "the signature of LOST ORTHOGONALITY (ghost copies of one "
                "eigenpair), typical for T-only Lanczos on trained/ill-"
                "conditioned checkpoints; lambda_max may be off by tens of "
                "percent. Use --thick_restart K for converged, residual-"
                "certified extremes."
            )
    if partial_measure:
        # the gammas cover only the converged pairs, not the full SLQ measure
        print(f"partial E[lambda] over the {len(ev)} converged pairs = "
              f"{float(trace_estimate(spec)):.6e} "
              f"(weight sum {float(spec.gammas.sum()):.3e}; not a trace estimate)")
    else:
        print(f"trace estimate (E[lambda]) = {float(trace_estimate(spec)):.6e}")
    # count HVPs, not matvecs, so HVPs/s compares across paths
    hvps = (n_matvecs if n_matvecs is not None else args.lanczos_iters) * num_batches
    print(f"wall-clock: {wall:.2f}s ({hvps / wall:.2f} HVPs/s)")

    if args.out_spectrum:
        if args.out_spectrum.endswith((".ckpt", ".pt")):
            spectra.save_reference_spectrum(args.out_spectrum, spec)
            print(f"spectrum (torch format) -> {args.out_spectrum}")
        else:
            spectra.save_spectrum(args.out_spectrum, spec, iters=args.lanczos_iters,
                                  subsample=args.subsample, vector_seed=args.vector_seed,
                                  **getattr(args, "_extra_meta", {}))
            print(f"spectrum -> {args.out_spectrum}.npz"
                  if not args.out_spectrum.endswith(".npz")
                  else f"spectrum -> {args.out_spectrum}")
    if args.plot:
        plot_spectrum(spec, args.plot)
    if args.compare_to:
        other = (
            spectra.load_reference_spectrum(args.compare_to)
            if args.compare_to.endswith((".ckpt", ".pt"))
            else spectra.load_spectrum(args.compare_to)
        )
        err = compare.ritz_relative_error(spec, other, top_k=5)
        print(f"top-5 Ritz max relative error vs {args.compare_to}: {err:.2e}")
        print(f"density overlap: {compare.density_overlap(spec, other):.4f}")
        print(f"spectral W1 distance: {compare.wasserstein_distance(spec, other):.4e}")
        if spec.ritz_vectors is not None and other.ritz_vectors is not None:
            ov = compare.subspace_overlap(spec.ritz_vectors, other.ritz_vectors)
            print(f"Ritz subspace overlap (mean cos^2 principal angles): {ov:.4f}")


def plot_spectrum(spec, path: str) -> None:
    """Stem plot of (eigvals, gammas), log-y."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.stem(spec.eigvals.numpy(), np.maximum(spec.gammas.numpy(), 1e-12))
    ax.set_yscale("log")
    ax.set_xlabel("Ritz value")
    ax.set_ylabel("SLQ weight")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"plot -> {path}")
