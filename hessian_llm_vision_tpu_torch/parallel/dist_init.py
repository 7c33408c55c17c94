"""Process-group set-up (port of ``parallel/dist_init.py``).

One call joins this process to a ``torch.distributed`` group: NCCL for
ranks on CUDA cards, gloo on the CPU or when the caller names it.  The
arguments default to what ``torchrun`` puts in the environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``); a process
started without ``torchrun`` and without arguments is world size 1 and
needs no group, so the call then does nothing.  It does nothing either
when a group is already up, as the JAX function does.

One card admits one NCCL rank: NCCL refuses two ranks on one GPU
("Duplicate GPU detected"), so a NCCL rank takes the card ``LOCAL_RANK``
names, and a host with fewer cards than ranks is refused before the group
starts.  A NCCL group that cannot start raises: nothing falls back to
gloo.  Ranks that share a card run on gloo, which stages CUDA tensors
through host memory and runs only ``all_reduce`` and ``broadcast`` on them
(``parallel/mesh.py::native`` then pads and broadcasts).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def _init_method(address: Optional[str]) -> str:
    """A torch ``init_method`` URL from a JAX-style ``host:port`` address or
    a URL; ``env://`` (torchrun's variables) when none is given."""
    if address is None:
        return "env://"
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    cpu: bool = False,
    store: Optional[dist.Store] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the process group; returns whether one is up after the call.

    ``coordinator_address``: ``host:port`` or an ``init_method`` URL
    (``tcp://``, ``file://``, ``env://``); ``store``: a ready
    ``torch.distributed.Store`` instead (for example an in-process
    ``HashStore`` for one rank).  ``backend`` defaults to NCCL on a card
    and gloo with ``cpu=True`` or without one.  A NCCL rank makes its
    card (``LOCAL_RANK``, else the rank modulo the card count) the current
    device and binds the group to it; fewer cards on the host than its
    ranks (``LOCAL_WORLD_SIZE``, else ``num_processes``) raise
    ``RuntimeError`` naming both counts.  ``timeout_s`` bounds every
    collective."""
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if store is None and coordinator_address is None and "MASTER_ADDR" not in env:
        if num_processes not in (None, 1):
            raise ValueError(f"num_processes={num_processes} needs a coordinator_address "
                             "or torchrun's MASTER_ADDR")
        return False  # launched without torchrun: world size 1, no group
    num_processes = num_processes or 1
    process_id = process_id or 0
    if backend is None:
        backend = "gloo" if cpu or not torch.cuda.is_available() else "nccl"
    kwargs = {"backend": backend, "rank": process_id, "world_size": num_processes}
    if backend == "nccl":
        cards = torch.cuda.device_count()
        on_host = int(env.get("LOCAL_WORLD_SIZE", num_processes))
        local = int(env.get("LOCAL_RANK", process_id % max(cards, 1)))
        if cards < on_host or local >= cards:
            raise RuntimeError(f"{on_host} NCCL ranks on this host but {cards} CUDA cards: "
                               "NCCL needs one card a rank")
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = _init_method(coordinator_address)
    dist.init_process_group(**kwargs)
    return True


def launched() -> bool:
    """A group is up, or this process was started by ``torchrun`` (its
    ``MASTER_ADDR`` or a ``WORLD_SIZE`` in the environment)."""
    return dist.is_initialized() or "MASTER_ADDR" in os.environ or "WORLD_SIZE" in os.environ


def is_multihost() -> bool:
    """More than one rank in the group (the JAX function counts processes)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_device_count() -> int:
    return torch.cuda.device_count()
