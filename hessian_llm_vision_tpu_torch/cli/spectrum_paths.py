"""The spectrum CLI's two computation paths (port of
``cli/spectrum_paths.py``):

* :func:`host_loop_main` -- T-only host-driven spectra (the dataset loop
  of the Hessian, GGN or Fisher, ``--fused_step`` with ``--qprev_bf16``,
  ``--linearized``, ``--bigmodel``, ``--probe_parallel``), LLM scale, and
  ``--kpm`` on the dataset operator;
* :func:`incore_main` -- the in-core operator paths (CGS2 Lanczos with an
  optional Ritz basis, the basis in host memory, multi-probe SLQ,
  resumable checkpointing, thick restart, Hutch++, KPM).

Every probe's start vector is drawn from one CPU ``torch.Generator`` seeded
with ``--vector_seed``, in probe order, and then copied to the device, so a
card run and a CPU run start from the same vector; the Hutch++ probes come
from one seeded ``--vector_seed + 1``, the KPM draws from one seeded
``--vector_seed + 2``.  Both paths end in ``report_and_outputs`` and return
``(spectrum, result)``: the last probe's ``LanczosResult`` (None for
multi-probe SLQ) or the ``ThickRestartResult``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from hessian_llm_vision_tpu_torch.cli.spectrum_kpm import run_kpm
from hessian_llm_vision_tpu_torch.cli.spectrum_report import report_and_outputs
from hessian_llm_vision_tpu_torch.curvature.operators import DatasetHessianOperator
from hessian_llm_vision_tpu_torch.io import spectra
from hessian_llm_vision_tpu_torch.krylov import driver
from hessian_llm_vision_tpu_torch.krylov.host_lanczos import lanczos_host_basis
from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos, lanczos_checkpointed
from hessian_llm_vision_tpu_torch.krylov.slq import Spectrum, ritz_decomposition, slq_multi_probe
from hessian_llm_vision_tpu_torch.krylov.thick_restart import lanczos_thick_restart
from hessian_llm_vision_tpu_torch.krylov.trace import hutchpp_trace
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener
from hessian_llm_vision_tpu_torch.utils.norms import norm


def _single_batch_norm(normalization: str) -> str:
    return "mean" if normalization == "dataset" else normalization


def host_loop_main(args, wl, device: torch.device,
                   on_iter: Optional[Callable[[int, float], None]] = None):
    """--host_loop: T-only spectrum, sequential probes SLQ-averaged.

    ``on_iter(i, seconds)`` receives each iteration's host-clock seconds,
    taken after T is copied to the host, so they include the device work.
    """
    if args.operator in ("ggn", "fisher") and wl.model_fn is None:
        raise SystemExit(f"--operator {args.operator} unsupported for "
                         f"model {wl.name!r} (no model_fn)")
    fl = Flattener(wl.params)
    last = 0.0  # host clock at the end of the previous iteration

    def cb(i, alphas, betas):
        nonlocal last
        if args.t_checkpoint:
            spectra.save_tridiag(args.t_checkpoint, alphas, betas,
                                 vector_seed=args.vector_seed, iter=i)
        if on_iter is not None:
            now = time.perf_counter()
            on_iter(i, now - last)
            last = now

    # no callback without --t_checkpoint / on_iter: T stays on the device
    # until the loop ends
    callback = cb if (args.t_checkpoint or on_iter is not None) else None
    gen = torch.Generator().manual_seed(args.vector_seed)
    t0 = time.time()
    all_ev, all_ga = [], []
    lead = True  # this process prints the report and writes the artifact
    if args.probe_parallel:
        from hessian_llm_vision_tpu_torch.parallel import make_mesh, probe_parallel_spectrum_host

        mesh = make_mesh()
        lead = mesh.index == 0
        results = probe_parallel_spectrum_host(
            wl.loss_fn, wl.params, wl.batches, args.lanczos_iters, n_probes=args.probes,
            generator=gen, mesh=mesh, normalization=args.normalization,
            batch_size=wl.batch_size, precision=args.hvp_precision, flattener=fl,
            operator=args.operator, model_fn=wl.model_fn, out_loss_fn=wl.out_loss_fn,
            progress=True)
        for pi, res in enumerate(results):
            s = ritz_decomposition(res)
            all_ev.append(s.eigvals)
            all_ga.append(s.gammas)
            if lead:
                print(f"probe {pi + 1}/{args.probes}: lambda_max {float(s.eigvals.max()):.4f}")
    for pi in range(0 if args.probe_parallel else max(args.probes, 1)):
        v0 = torch.randn(fl.size, generator=gen).to(device)
        last = time.perf_counter()
        single = dict(normalization=_single_batch_norm(args.normalization),
                      batch_size=wl.batch_size, precision=args.hvp_precision,
                      callback=callback, progress=args.probes == 1)
        if args.linearized:
            if len(wl.batches) != 1:
                raise SystemExit("--linearized needs a single batch (--num_batches 1): "
                                 "the cached residuals are per-batch (see "
                                 "curvature.linearized.residual_bytes)")
            res = driver.linearized_spectrum_host(wl.loss_fn, wl.params, wl.batches[0],
                                                  args.lanczos_iters, v0=v0, flattener=fl,
                                                  **single)
        elif args.bigmodel:
            if len(wl.batches) != 1 or args.operator != "hessian":
                raise SystemExit("--bigmodel needs a single batch (--num_batches 1) "
                                 "and --operator hessian")
            q_dtype = torch.bfloat16 if args.bigmodel_q == "bfloat16" else torch.float32
            res = driver.bigmodel_spectrum_host(wl.loss_fn, wl.params, wl.batches[0],
                                                args.lanczos_iters, v0=fl.unflatten(v0),
                                                q_dtype=q_dtype, **single)
        elif args.fused_step:
            if len(wl.batches) != 1 or args.operator != "hessian":
                raise SystemExit("--fused_step needs a single batch (--num_batches 1) "
                                 "and --operator hessian")
            res = driver.single_batch_spectrum_host_fused(
                wl.loss_fn, wl.params, wl.batches[0], args.lanczos_iters, v0=v0, flattener=fl,
                qprev_bf16=args.qprev_bf16, **single,
            )
        else:
            res = driver.dataset_spectrum_host(
                wl.loss_fn, wl.params, wl.batches, args.lanczos_iters, v0=v0,
                normalization=args.normalization, batch_size=wl.batch_size,
                precision=args.hvp_precision, flattener=fl, callback=callback,
                progress=args.probes == 1, operator=args.operator,
                model_fn=wl.model_fn, out_loss_fn=wl.out_loss_fn,
            )
        s = ritz_decomposition(res)
        all_ev.append(s.eigvals)
        all_ga.append(s.gammas)
        if args.probes > 1:
            print(f"probe {pi + 1}/{args.probes}: lambda_max {float(s.eigvals.max()):.4f}")
    spec = Spectrum(eigvals=torch.cat(all_ev), gammas=torch.cat(all_ga) / len(all_ga))
    wall = time.time() - t0
    if args.kpm:
        # the dataset operator's matvec: the per-batch HVPs summed, at any
        # model size the host loop itself handles
        op_kpm = DatasetHessianOperator(wl.loss_fn, wl.params, wl.batches,
                                        normalization=args.normalization,
                                        batch_size=wl.batch_size, precision=args.hvp_precision,
                                        flattener=fl)
        run_kpm(args, op_kpm.matvec, op_kpm.dim, device)
    if lead:
        report_and_outputs(args, spec, wall, fl.size, len(wl.batches) * max(args.probes, 1))
    return spec, res


def _thick_restart(args, wl, op, v0: torch.Tensor):
    """--thick_restart K: converged eigenpairs; the gammas are the start
    vector's weights (u_i . v0)^2 on them, a partial measure."""
    dropped = [flag for flag, set_ in [
        ("--probes", args.probes > 1),
        ("--host_basis", args.host_basis),
        ("--t_checkpoint", bool(args.t_checkpoint)),
        ("--resume_spectrum", bool(args.resume_spectrum)),
        ("--no_reorth", args.no_reorth),
        ("--hutchpp", bool(args.hutchpp)),
    ] if set_]
    if dropped:
        raise SystemExit(f"--thick_restart does not support {', '.join(dropped)}")
    v0 = v0 / norm(v0)
    tr_dtype = torch.bfloat16 if args.tr_dtype == "bfloat16" else torch.float32
    kw = dict(v0=v0, inner=args.lanczos_iters, which=args.tr_which, tol=args.tr_tol,
              store_dtype=tr_dtype, progress=True)
    if args.operator == "hessian" and not args.layer:
        # the dataset HVP, CGS2 (the rank-k kernel pair on CUDA) and the row
        # write per inner iteration, scalars fetched once per restart cycle;
        # the GGN / Fisher and --layer operators run through op.matvec
        res = driver.dataset_thick_restart_host(
            wl.loss_fn, wl.params, wl.batches, args.thick_restart,
            normalization=args.normalization, batch_size=wl.batch_size,
            precision=args.hvp_precision, **kw)
    else:
        res = lanczos_thick_restart(op.matvec, op.dim, args.thick_restart, **kw)
    spec = Spectrum(eigvals=torch.as_tensor(res.eigvals, dtype=torch.float32),
                    gammas=((res.vectors @ v0) ** 2).cpu(),
                    ritz_vectors=res.vectors if args.basis else None)
    status = "converged" if res.converged else "NOT converged"
    print(f"thick-restart: {status} after {res.restarts} restarts / "
          f"{res.matvecs} matvecs; max residual {res.residuals.max():.2e}")
    args._extra_meta = {
        **getattr(args, "_extra_meta", {}),
        "tr_matvecs": res.matvecs,
        "tr_restarts": res.restarts,
        "tr_converged": int(res.converged),
        "tr_max_residual": float(res.residuals.max()),
    }
    return spec, res


def incore_main(args, wl, make_operator, device: torch.device):
    """In-core operator paths: stored-basis Lanczos (on the device or in
    host memory), probes, checkpoints, thick restart, Hutch++, KPM."""
    op = make_operator(args, wl)
    single = args.layer or args.operator != "hessian" or len(wl.batches) == 1
    hvp_batches = 1 if single else len(wl.batches)
    gen = torch.Generator().manual_seed(args.vector_seed)

    def v0():
        return torch.randn(op.dim, generator=gen).to(device)

    t0 = time.time()
    if args.thick_restart:
        spec, res = _thick_restart(args, wl, op, v0())
        report_and_outputs(args, spec, time.time() - t0, op.dim, hvp_batches,
                           n_matvecs=res.matvecs, partial_measure=True)
        return spec, res
    res = None
    if args.probes > 1:
        spec = slq_multi_probe(op.matvec, op.dim, args.lanczos_iters, gen, args.probes,
                               reorth=not args.no_reorth, device=device)
    elif args.host_basis:
        def cb(i, alphas, betas):
            if args.t_checkpoint:
                spectra.save_tridiag(args.t_checkpoint, alphas, betas,
                                     vector_seed=args.vector_seed, iter=i)

        res = lanczos_host_basis(op.matvec, op.dim, args.lanczos_iters, v0=v0(),
                                 reorth=not args.no_reorth, callback=cb)
        spec = ritz_decomposition(res, with_vectors=args.basis)
    elif args.t_checkpoint or args.resume_spectrum:
        t_path = args.t_checkpoint or (
            args.resume_spectrum.replace(".state.npz", "").replace(".state", "")
        )

        def cb(i, alphas, betas):
            spectra.save_tridiag(t_path, alphas, betas, vector_seed=args.vector_seed, iter=i)
            print(f"step {i + 1}  T checkpointed")

        # the full state is 2xP f32 (~1 GB at 124M), so it is written only
        # every state_every iterations while T (KBs) is written every one
        state_every = args.state_every
        if state_every is None:
            state_every = 5 if op.dim >= 10**8 else 1

        def scb(i, st):
            if (i + 1) % max(state_every, 1) == 0 or (i + 1) == args.lanczos_iters:
                spectra.save_lanczos_state(t_path + ".state", **st)

        resume = None
        if args.resume_spectrum:
            resume = spectra.load_lanczos_state(args.resume_spectrum)
            print(f"resuming at iteration {len(resume['alphas'])} <- {args.resume_spectrum}")
        res = lanczos_checkpointed(
            op.matvec, op.dim, args.lanczos_iters, v0=None if resume else v0(),
            callback=cb, state_callback=scb, resume_state=resume, device=device,
        )
        spec = ritz_decomposition(res)
    else:
        res = lanczos(op.matvec, op.dim, args.lanczos_iters, v0=v0(),
                      reorth=not args.no_reorth, store_basis=args.basis or not args.no_reorth)
        spec = ritz_decomposition(res, with_vectors=args.basis)
    wall = time.time() - t0
    if args.hutchpp:
        t1 = time.time()
        tr = float(hutchpp_trace(op.matvec, op.dim, args.hutchpp,
                                 torch.Generator().manual_seed(args.vector_seed + 1),
                                 vmapped=False, device=device))
        print(f"trace (hutch++ {args.hutchpp} matvecs) = {tr:.6e} "
              f"({time.time() - t1:.2f}s)")
        # merged, as run_kpm and thick restart do: no producer's keys are lost
        args._extra_meta = {**getattr(args, "_extra_meta", {}),
                            "hutchpp_trace": tr, "hutchpp_matvecs": args.hutchpp}
    if args.kpm:
        run_kpm(args, op.matvec, op.dim, device)
    report_and_outputs(args, spec, wall, op.dim, hvp_batches)
    return spec, res
