"""Driver: the spectrum CLI's in-core path, spectra back to back.

Each job is ``krylov/lanczos.py::lanczos`` with CGS2 reorthogonalisation
and a stored f32 ``(iters, P)`` basis over ``curvature/operators.py::
DatasetHessianOperator``: the dataset-mean Hessian over the traffic's
batches, fp32 products, operator built as ``cli/spectrum.py::
_make_operator`` builds it for several batches (no whole-loss remat).  The
window's boundaries are the starts of the operator's matvecs (one a
Lanczos iteration).

Checks, once the window has closed and the program's state is freed but
for the last job's basis:

* ``t_gap``: the first ``check_iters`` alphas and betas of every finished
  job against the reference's CGS2 Lanczos from the same start
  (``spectra.t_gap``);
* ``step_gap`` and ``q_gap``: step ``k`` (drawn from the seed) of the last
  job, worked out by the reference from the program's stored rows ``q_0 ..
  q_k`` and ``beta_{k-1}``: its alpha and beta (as ``t_gap``) and the
  distance of the program's ``q_{k+1}`` from the reference's;

Traffic parameters: ``num_batches``, ``batch_size``, ``seq_len``,
``lanczos_iters``, ``check_iters``, ``trace_iters``, ``limits``, and
``reference_rows``: the rows of each block in which the reference computes
its HVPs (a whole batch by default), so that it fits beside the basis.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.harness import family, inputs, spectra
from benchmark.metrics.flop_counts import hvp_flops
from benchmark.reference import lanczos as ref


class Port:
    """The program: its operator, its Lanczos, its flat layout."""

    def __init__(self, loss_fn, weights, ids, batch_size):
        from hessian_llm_vision_tpu_torch.curvature import operators
        from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

        batches = [{"input_ids": ids[i]} for i in range(ids.shape[0])]
        self.op = operators.DatasetHessianOperator(
            loss_fn, weights, batches, normalization="dataset", batch_size=batch_size,
            dataset_size=len(batches) * batch_size, remat=False, precision="high")
        self.fl = Flattener(weights)
        self.dim = self.op.dim

    def spectrum(self, v0: dict, iters: int, matvec_hook):
        krylov_lanczos = importlib.import_module("hessian_llm_vision_tpu_torch.krylov.lanczos")
        res = krylov_lanczos.lanczos(lambda q: matvec_hook(self.op.matvec, q), self.dim, iters,
                                     v0=self.fl.flatten(v0), reorth=True, store_basis=True)
        return res.alphas, res.betas, res.basis

    def tree(self, row):
        return self.fl.unflatten(row)

    def flat(self, tree):
        return self.fl.flatten(tree)


def reference_matvec(cfg, refmod, weights, ids, rows: int, layout):
    """The reference's HVP of the mean loss over every batch, each batch in
    blocks of ``rows`` rows: the blocks hold as many targets each, so the
    mean of their HVPs is the dataset's."""
    blocks = [b[i:i + rows] for b in ids for i in range(0, b.shape[0], rows)]
    return ref.dataset_matvec(lambda w, b: refmod.loss(w, b, cfg), weights, blocks, layout)


class Control:
    """The reference in the program's place, its products in TF32."""

    def __init__(self, cfg, shapes, weights, ids, refmod, rows):
        self.layout = ref.flat_layout(shapes)
        self.mv = reference_matvec(cfg, refmod, weights, ids, rows, self.layout)
        self.dim = self.layout[-1][1] + self.layout[-1][2]

    def spectrum(self, v0: dict, iters: int, matvec_hook):
        with ref.matmul_precision(True):
            return ref.lanczos_cgs2(lambda q: matvec_hook(self.mv, q), ref.flatten(v0, self.layout),
                                    iters)

    def tree(self, row):
        return ref.unflatten(row, self.layout)

    def flat(self, tree):
        return ref.flatten(tree, self.layout)


def _warm_up(prog, run, shapes, iters: int) -> None:
    """One iteration, then the CGS2 products at every row count the jobs use."""
    prog.spectrum(inputs.start_vector(run.seed, -1, shapes, run.device), 1, lambda mv, q: mv(q))
    q = torch.zeros(iters, prog.dim, device=run.device)
    w = torch.zeros(prog.dim, device=run.device)
    for i in range(iters):
        rows = q[:i + 1]
        w = w - rows.T @ (rows @ w)
    del q, w
    run.window.sync()


def run(run) -> None:
    cfg, mix, dev = run.config, run.mix, run.device
    refmod = family.reference(run.root, cfg)
    shapes = refmod.shapes(cfg)
    nb, B, T = mix["num_batches"], mix["batch_size"], mix["seq_len"]
    iters = mix["lanczos_iters"]
    m = min(mix["check_iters"], iters)
    run.log(f"{run.setup_clock():.2f} s: torch and the harness imported")
    weights = inputs.weights(run.seed, shapes, cfg["initializer_range"], dev)
    ids = inputs.token_batches(run.seed, nb, B, T, cfg["vocab_size"], dev)
    run.log(f"{run.setup_clock():.2f} s: inputs drawn")
    run.tokens_per_iteration = nb * B * T
    run.flops_per_iteration = nb * hvp_flops(*family.load(run.root, cfg).forward_flops(cfg, B, T))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = (Control(cfg, shapes, weights, ids, refmod, mix.get("reference_rows", B))
            if run.control
            else Port(family.build(run.root, cfg, shapes)[1], weights, ids, B))
    run.log(f"{run.setup_clock():.2f} s: program built")
    _warm_up(prog, run, shapes, iters)
    run.log(f"{run.setup_clock():.2f} s: warmed up")
    w = run.window
    marks = None

    def hooked(mv, q):
        marks.start()
        w.mark_iteration()
        return w.matvec_span(mv, q)

    def job(v0, boundaries):
        nonlocal marks
        marks = boundaries
        return prog.spectrum(v0, iters, hooked)

    jobs, basis = spectra.loop(run, shapes, job)
    spectra.tally(run, jobs, iters)
    run.log(f"{run.setup_clock():.2f} s: {len(jobs)} job(s) done; reference check")
    _, a_last, b_last = jobs[-1]
    # the program's state goes; the reference runs in f32 with TF32 off
    tree, flat = prog.tree, prog.flat
    del prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    layout = ref.flat_layout(shapes)
    mv = reference_matvec(cfg, refmod, weights, ids, mix.get("reference_rows", B), layout)
    with ref.matmul_precision(False):
        gaps = []
        for j, a, b in jobs:
            ra, rb, _ = ref.lanczos_cgs2(mv, ref.flatten(inputs.start_vector(run.seed, j, shapes,
                                                                              dev), layout), m)
            gaps.append(spectra.t_gap(a, b, ra, rb, m))
        k = 1 + inputs.derive(run.seed, "step") % (iters - 2)

        def mv_prog(q):  # the reference's matvec on the program's flat layout
            return flat(ref.unflatten(mv(ref.flatten(tree(q), layout)), layout))

        alpha, beta, q_next = ref.cgs2_step(mv_prog, basis[:k + 1], float(b_last[k - 1]))
        step_gap = spectra.t_gap(a_last[k:k + 1], b_last[k:k + 1], alpha.reshape(1),
                                 beta.reshape(1), 1)
        q_gap = float(torch.linalg.vector_norm(q_next - basis[k + 1]))
    lim = mix["limits"]
    run.checks = [("t_gap", max(gaps), lim["t_gap"]), ("step_gap", step_gap, lim["step_gap"]),
                  ("q_gap", q_gap, lim["q_gap"])]
    run.log(f"t_gap of each job {gaps}; step {k}")
