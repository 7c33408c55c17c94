"""Driver: the spectrum CLI's ``--bigmodel`` path, spectra back to back.

Each job is ``krylov/driver.py::bigmodel_spectrum_host``: T-only Lanczos
on one batch, the Krylov vectors parameter-shaped and stored in
``vector_dtype`` (the CLI's ``--bigmodel_q``), every dot, AXPY and norm f32,
fp32 products, the batch-mean loss.  The window's boundaries are the ends
of its iterations (its per-iteration callback, which reads T on the host).

Check, once the window has closed and the program's state is freed:
``t_gap``, the first ``check_iters`` alphas and betas of every finished
job against the reference's T-only Lanczos from the same start with its
vectors stored in the same dtype (``spectra.t_gap``).  The program hands
out no Lanczos vector, only T, so no step is checked from the program's
own state, and the steps after ``check_iters`` are compared in no way:
later entries of a T-only recurrence with bf16 vectors depart from a
second implementation's by the roundings alone, as far as a TF32 one does.

Traffic parameters: ``batch_size``, ``seq_len``, ``lanczos_iters``,
``vector_dtype``, ``check_iters``, ``trace_iters``, ``limits``, and
``reference_rows``: the rows of each block in which the reference computes
its HVP (the whole batch by default), so that it fits on the card.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.harness import family, inputs, spectra
from benchmark.metrics.flop_counts import hvp_flops
from benchmark.reference import lanczos as ref


class Port:
    def __init__(self, loss_fn, weights, batch, q_dtype):
        self.loss_fn, self.weights, self.batch, self.q_dtype = loss_fn, weights, batch, q_dtype

    def spectrum(self, v0: dict, iters: int, on_iteration):
        driver = importlib.import_module("hessian_llm_vision_tpu_torch.krylov.driver")
        res = driver.bigmodel_spectrum_host(
            self.loss_fn, self.weights, {"input_ids": self.batch}, iters, v0=v0,
            normalization="mean", batch_size=self.batch.shape[0], precision="high",
            q_dtype=self.q_dtype, callback=lambda i, a, b: on_iteration())
        return res.alphas, res.betas, None


def reference_matvec(cfg, refmod, weights, batch, rows: int, layout):
    """The reference's HVP of the batch-mean loss, in blocks of ``rows``
    rows: every row has as many targets, so the mean of the blocks' HVPs is
    the batch's."""
    blocks = [batch[i:i + rows] for i in range(0, batch.shape[0], rows)]
    return ref.dataset_matvec(lambda w, b: refmod.loss(w, b, cfg), weights, blocks, layout)


class Control:
    """The reference in the program's place, its products in TF32."""

    def __init__(self, cfg, shapes, weights, batch, q_dtype, refmod, rows):
        self.layout = ref.flat_layout(shapes)
        self.mv = reference_matvec(cfg, refmod, weights, batch, rows, self.layout)
        self.q_dtype = q_dtype

    def spectrum(self, v0: dict, iters: int, on_iteration):
        with ref.matmul_precision(True):
            a, b = ref.lanczos_stored(self.mv, ref.flatten(v0, self.layout), iters, self.q_dtype,
                                      on_iteration=lambda i: on_iteration())
        return a, b, None


def run(run) -> None:
    cfg, mix, dev = run.config, run.mix, run.device
    refmod = family.reference(run.root, cfg)
    shapes = refmod.shapes(cfg)
    B, T, iters = mix["batch_size"], mix["seq_len"], mix["lanczos_iters"]
    m = min(mix["check_iters"], iters)
    q_dtype = getattr(torch, mix["vector_dtype"])
    run.log(f"{run.setup_clock():.2f} s: torch and the harness imported")
    weights = inputs.weights(run.seed, shapes, cfg["initializer_range"], dev)
    batch = inputs.token_batches(run.seed, 1, B, T, cfg["vocab_size"], dev)[0]
    run.log(f"{run.setup_clock():.2f} s: inputs drawn")
    run.tokens_per_iteration = B * T
    run.flops_per_iteration = hvp_flops(*family.load(run.root, cfg).forward_flops(cfg, B, T))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = mix.get("reference_rows", B)
    prog = (Control(cfg, shapes, weights, batch, q_dtype, refmod, rows) if run.control
            else Port(family.build(run.root, cfg, shapes)[1], weights, batch, q_dtype))
    run.log(f"{run.setup_clock():.2f} s: program built")
    prog.spectrum(inputs.start_vector(run.seed, -1, shapes, dev), 1, lambda: None)
    run.window.sync()
    run.log(f"{run.setup_clock():.2f} s: warmed up")
    jobs, _ = spectra.loop(run, shapes, lambda v0, marks: prog.spectrum(v0, iters, marks.end))
    spectra.tally(run, jobs, iters)
    run.log(f"{run.setup_clock():.2f} s: {len(jobs)} job(s) done; reference check")
    del prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    layout = ref.flat_layout(shapes)
    mv = reference_matvec(cfg, refmod, weights, batch, rows, layout)
    gaps = []
    with ref.matmul_precision(False):
        for j, a, b in jobs:
            v0 = ref.flatten(inputs.start_vector(run.seed, j, shapes, dev), layout)
            ra, rb = ref.lanczos_stored(mv, v0, m, q_dtype)
            del v0
            gaps.append(spectra.t_gap(a, b, ra, rb, m))
    run.checks = [("t_gap", max(gaps), mix["limits"]["t_gap"])]
    run.log(f"t_gap of each job {gaps}")
