"""Flag-combination checks of the spectrum CLI (port of
``cli/spectrum_flags.py``): a combination that would silently drop a flag
exits with an error instead of running a job that never produces the
asked-for output.  The messages are the JAX CLI's (``--precision_check``
refuses a non-Hessian operator where it runs).  ``cli/spectrum.py`` runs
these checks first."""

from __future__ import annotations


def validate_flags(args) -> None:
    if args.kpm and (
        args.layerwise or args.thick_restart
        or (args.host_loop and args.operator != "hessian")
        or args.bigmodel
    ):
        raise SystemExit(
            "--kpm works on the in-core operator paths and on "
            "--host_loop with --operator hessian (drop --layerwise/"
            "--thick_restart/--bigmodel, or call krylov.kpm_density "
            "directly on a program-backed matvec)"
        )
    if not args.kpm and args.kpm_probes != 4:
        raise SystemExit("--kpm_probes has no effect without --kpm M")
    if args.kpm_deflate and not args.kpm:
        raise SystemExit("--kpm_deflate has no effect without --kpm M")
    if args.hutchpp and (args.host_loop or args.layerwise):
        raise SystemExit(
            "--hutchpp applies to the in-core operator paths only "
            "(drop --host_loop/--layerwise, or use krylov.trace directly "
            "with a host-loop matvec)"
        )
    if args.linearized and (
        not args.host_loop or args.fused_step or args.fused_iter
        or args.bigmodel or args.probe_parallel or args.layerwise
        or args.operator != "hessian"
    ):
        raise SystemExit(
            "--linearized needs --host_loop with --operator hessian and is "
            "exclusive with --fused_step/--fused_iter/--bigmodel/"
            "--probe_parallel/--layerwise (the cached linearization "
            "replaces the per-iteration HVP program)"
        )
    if args.qprev_bf16 and not args.fused_step:
        raise SystemExit("--qprev_bf16 requires --fused_step (the plain "
                         "host loop keeps all flat vectors f32)")
    if args.fused_iter and (
        not args.host_loop or args.fused_step or args.bigmodel
    ):
        raise SystemExit(
            "--fused_iter needs --host_loop "
            "(and is exclusive with --fused_step/--bigmodel)"
        )
    if args.probe_parallel and (
        not args.host_loop or args.probes < 2 or args.fused_step
        or args.bigmodel or bool(args.t_checkpoint)
    ):
        raise SystemExit(
            "--probe_parallel needs --host_loop and --probes >= 2; it does "
            "not support --fused_step/--bigmodel (single-probe memory "
            "plans) or --t_checkpoint (no per-probe resume state)"
        )
    if args.host_loop and (args.basis or args.host_basis):
        # the host-loop branch is the T-only memory plan: no stored Krylov
        # basis, Spectrum(ritz_vectors=None) -- silently dropping the flag
        # would hand --compare_to nothing to overlap against
        raise SystemExit(
            "--host_loop is T-only (no Ritz vectors / stored basis); drop "
            "--basis/--host_basis, or use the in-core path (--basis / "
            "--host_basis) or --thick_restart K for converged eigenpairs"
        )
    if (args.bigmodel or args.fused_step) and not args.host_loop:
        # without --host_loop these would silently fall through to the flat
        # in-core paths and their P-vector copies
        raise SystemExit(
            "--bigmodel/--fused_step are --host_loop modes; add --host_loop"
        )
    if args.thick_restart and (
        args.host_loop or args.layerwise or args.fused_step or args.bigmodel
    ):
        raise SystemExit(
            "--thick_restart applies to the in-core operator paths only "
            "(drop --host_loop/--layerwise/--fused_step/--bigmodel)"
        )
    if not args.thick_restart and args.tr_which != "lm":
        raise SystemExit(
            "--tr_which has no effect without --thick_restart K "
            "(--kpm_deflate always deflates largest-|lambda|)"
        )
    if (
        not args.thick_restart
        and not args.kpm_deflate
        and (args.tr_dtype != "float32" or args.tr_tol != 1e-6)
    ):
        raise SystemExit(
            "--tr_dtype/--tr_tol have no effect without --thick_restart K "
            "or --kpm_deflate K"
        )
    if not args.layerwise and (
        args.layerwise_group != "leaf" or args.group_regex
    ):
        raise SystemExit(
            "--layerwise_group/--group_regex have no effect without "
            "--layerwise"
        )
