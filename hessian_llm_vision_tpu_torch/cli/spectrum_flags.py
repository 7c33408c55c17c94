"""Flag-combination checks of the spectrum CLI (port of
``cli/spectrum_flags.py``): a combination that would silently drop a flag
exits with an error instead of running a job that never produces the
asked-for output.  Only the ported flags are checked here; the sub-options
and checks of each refused path come with the slice that ports it.
``cli/spectrum.py`` runs these checks first, then refuses the flags that
the port does not have yet ("not ported yet")."""

from __future__ import annotations


def validate_flags(args) -> None:
    if args.qprev_bf16 and not args.fused_step:
        raise SystemExit("--qprev_bf16 requires --fused_step (the plain "
                         "host loop keeps all flat vectors f32)")
    if args.fused_iter and (not args.host_loop or args.fused_step):
        raise SystemExit(
            "--fused_iter needs --host_loop (and is exclusive with --fused_step)"
        )
    if args.host_loop and args.basis:
        # the host-loop branch is the T-only memory plan: no stored Krylov
        # basis, Spectrum(ritz_vectors=None) -- silently dropping the flag
        # would hand --compare_to nothing to overlap against
        raise SystemExit(
            "--host_loop is T-only (no Ritz vectors / stored basis); drop "
            "--basis, or use the in-core path (--basis)"
        )
    if args.fused_step and not args.host_loop:
        # without --host_loop it would silently fall through to the flat
        # in-core paths and their P-vector copies
        raise SystemExit("--fused_step is a --host_loop mode; add --host_loop")
