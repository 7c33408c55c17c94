"""Probe-parallel SLQ: independent Lanczos probes split over the ranks
(port of ``parallel/probe_parallel.py``).

The probes of a multi-probe SLQ are independent T-only Lanczos runs.  Each
rank of the mesh's data axis runs its share of them, one after another,
through ``krylov/driver.py::dataset_spectrum_host``, on replicated params
and batches; there is no collective until the end, when one all-reduce
puts every probe's T on every rank.  The JAX package vmaps the probes of
a device into one program; eagerly that program would be n_probes HVPs
large at once (the JAX note on a single chip), so here a rank with
several probes runs them in turn, as the sequential ``--probes`` loop of
the spectrum CLI does.

Every rank draws all ``n_probes`` start vectors in probe order from the
same CPU generator and keeps its own, so probe i starts from the vector
the sequential loop gives probe i, and the two paths agree probe for
probe.

:func:`rank_plan` is how many ranks the spectrum CLI starts itself for
``--probe_parallel``: one NCCL rank per card of the host when it was
launched plainly on several cards (the JAX CLI spreads its probes over
every local chip from one process), none under ``torchrun``, on one card
or on the CPU.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

import torch

from hessian_llm_vision_tpu_torch.krylov.driver import dataset_spectrum_host
from hessian_llm_vision_tpu_torch.krylov.lanczos import LanczosResult
from hessian_llm_vision_tpu_torch.parallel.mesh import Mesh, make_mesh
from hessian_llm_vision_tpu_torch.utils.flatten import Flattener


def _check_divides(n_probes: int, n: int) -> None:
    if n_probes % n:
        raise ValueError(
            f"n_probes={n_probes} must be a multiple of the mesh's data axis ({n} ranks): "
            "pad the probe count or shrink the mesh; a silent remainder would skew "
            "the SLQ average")


def rank_plan(cards: int, n_probes: int, *, cpu: bool, launched: bool) -> int:
    """The NCCL ranks to start for ``--probe_parallel`` with ``n_probes``
    probes on a host with ``cards`` cards: 0 (run in this process: under a
    launcher's group, ``launched``; on the CPU; on one card or none), else
    one per card.  Raises ``ValueError`` when the cards do not divide the
    probes."""
    if launched or cpu or cards <= 1:
        return 0
    _check_divides(n_probes, cards)
    return cards


def probe_parallel_spectrum_host(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    params,
    batch_list: Sequence[Any],
    num_iters: int,
    *,
    n_probes: int,
    generator: Optional[torch.Generator] = None,
    v0s: Optional[Sequence[torch.Tensor]] = None,
    mesh: Optional[Mesh] = None,
    normalization: str = "dataset",
    batch_size: Optional[int] = None,
    precision: Optional[str] = "high",
    flattener: Optional[Flattener] = None,
    operator: str = "hessian",
    model_fn: Optional[Callable] = None,
    out_loss_fn: Optional[Callable] = None,
    per_probe_batch_lists: Optional[Sequence[Sequence[Any]]] = None,
    progress: bool = False,
) -> List[LanczosResult]:
    """``n_probes`` T-only dataset-operator Lanczos runs split over the
    ranks of ``mesh`` (default: every rank of the group); one
    :class:`LanczosResult` per probe, in probe order, on every rank.

    Start vectors: exactly one of ``generator`` (a CPU generator; probe i
    gets the i-th ``randn(P)`` draw) and ``v0s`` (one vector per probe).
    ``n_probes`` must be a multiple of the mesh's data axis.
    ``per_probe_batch_lists``: n_probes equal-length batch lists, probe i
    running on its own data; default: every probe on ``batch_list``.
    ``operator``, ``model_fn``, ``out_loss_fn``, ``normalization``,
    ``batch_size`` and ``precision`` are ``dataset_spectrum_host``'s.
    ``progress``: rank 0 prints a "probe-parallel" line per probe it ran.
    """
    fl = flattener or Flattener(params)
    if per_probe_batch_lists is not None:
        if len(per_probe_batch_lists) != n_probes:
            raise ValueError(f"per_probe_batch_lists has {len(per_probe_batch_lists)} "
                             f"entries for n_probes={n_probes}")
        lens = {len(bl) for bl in per_probe_batch_lists}
        if len(lens) != 1:
            raise ValueError(f"per-probe batch lists must be equal length, got {lens}")
    if operator in ("ggn", "fisher"):
        if model_fn is None or out_loss_fn is None:
            raise ValueError(f"operator={operator!r} needs model_fn+out_loss_fn")
    elif operator != "hessian":
        raise ValueError(f"unknown operator {operator!r}")
    if (generator is None) == (v0s is None):
        raise ValueError("pass exactly one of generator / v0s")
    mesh = mesh or make_mesh()
    n = mesh.num_data
    _check_divides(n_probes, n)
    per_rank = n_probes // n
    mine = range(mesh.data_index * per_rank, (mesh.data_index + 1) * per_rank)
    device = next(iter(params.values())).device
    starts = {}
    for i in range(n_probes):  # every draw, in probe order, on every rank
        v = v0s[i] if v0s is not None else torch.randn(fl.size, generator=generator)
        if i in mine:
            starts[i] = v.to(device)
    # (alphas, betas) of every probe; a rank fills its probes' rows
    T = torch.zeros((2, n_probes, num_iters), dtype=torch.float32, device=device)
    for i in mine:
        t0 = time.perf_counter()
        res = dataset_spectrum_host(
            loss_fn, params,
            per_probe_batch_lists[i] if per_probe_batch_lists is not None else batch_list,
            num_iters, v0=starts.pop(i), normalization=normalization, batch_size=batch_size,
            precision=precision, flattener=fl, operator=operator, model_fn=model_fn,
            out_loss_fn=out_loss_fn,
        )
        T[0, i] = res.alphas
        T[1, i, :num_iters - 1] = res.betas
        if progress and mesh.data_index == 0:
            if T.is_cuda:
                torch.cuda.synchronize(T.device)
            print(f"probe-parallel lanczos: probe {i + 1}/{n_probes} on rank 0 of {n}, "
                  f"{num_iters} iterations  {time.perf_counter() - t0:.2f}s", flush=True)
    mesh.sum_(T, "data")  # the one collective: each probe's rows come from one rank
    return [LanczosResult(alphas=T[0, i].clone(), betas=T[1, i, :num_iters - 1].clone(),
                          basis=None)
            for i in range(n_probes)]
