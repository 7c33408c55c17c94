"""Cells on more than one card: one process a card, rank 0 the one started
by the command.

Rank 0 picks a free port on localhost, starts ranks 1..n-1 as new
interpreters running the same command with ``BENCH_RANK_OF`` =
``"<rank>/<world>/<port>/<device kind>"`` in their environment, and joins
them in a ``torch.distributed`` group at ``tcp://localhost:<port>``: NCCL
on cards (rank r on card r), gloo on the CPU (the tests).  Only rank 0
prints the result line; the other ranks' output goes to standard error.
Rank 0 waits for every rank and ends any that is still running.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Optional

ENV = "BENCH_RANK_OF"
JOIN_TIMEOUT_S = 120.0


def rank_from_env() -> Optional[tuple]:
    """``(rank, world, port, device kind)`` of a started rank, else None."""
    spec = os.environ.get(ENV)
    if not spec:
        return None
    rank, world, port, kind = spec.split("/")
    return int(rank), int(world), int(port), kind


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(command: list, world: int, port: int, kind: str) -> list:
    """Ranks 1..world-1 of ``command`` (an argv), started now."""
    procs = []
    for r in range(1, world):
        env = dict(os.environ)
        env[ENV] = f"{r}/{world}/{port}/{kind}"
        procs.append(subprocess.Popen(command, env=env, stdout=sys.stderr, stderr=sys.stderr))
    return procs


def wait_ranks(procs: list, timeout: float = JOIN_TIMEOUT_S) -> list:
    """Exit codes of the started ranks; any still running after ``timeout``
    is ended and counts as failed."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(-9)
    return codes


def end_ranks(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def init_group(rank: int, world: int, port: int, kind: str):
    """Join the run's process group; returns the ``torch.distributed`` module."""
    import datetime

    import torch
    import torch.distributed as dist

    if kind == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    return dist
