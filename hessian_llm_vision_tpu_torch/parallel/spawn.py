"""Run one function on n ranks of a fresh process group, each rank a new
interpreter (the CPU tests, ``parallel/dryrun.py``, two ranks sharing one
card, one NCCL rank per card of a host, and the spectrum CLI's
``--probe_parallel`` over every card of a host use it; ``torchrun`` is the
other launcher).

``run_ranks("module:function", n, workdir)`` starts n processes of this
module.  Each joins a group through a ``file://`` store in ``workdir`` (no
TCP port, so concurrent callers cannot collide), calls ``function(mesh,
**kwargs)`` with the data-axis mesh of every rank, saves what it returns
and leaves the group.  ``target`` may also be ``path/to/file.py:function``.
A run that outlasts ``timeout`` seconds is killed and raises, so a hang
fails rather than waits.  With ``backend="nccl"`` rank r runs on card r
(``LOCAL_RANK``), one rank per card: more ranks than the host's cards
raise before any starts.

    python -m hessian_llm_vision_tpu_torch.parallel.spawn SPEC RANK
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Optional

import torch

_ROOT = Path(__file__).resolve().parents[2]


def _resolve(target: str):
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem, where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _tail(path: Path, nbytes: int = 4000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-nbytes:]


def run_ranks(target: str, world_size: int, workdir, *, backend: str = "gloo",
              kwargs: Optional[dict] = None, timeout: Optional[float] = 300.0,
              threads: Optional[int] = None, cwd=None) -> list[dict]:
    """Run ``target(mesh, **kwargs)`` on ``world_size`` new ranks; returns
    one dict per rank: ``result`` (what the function returned, loaded with
    ``torch.load``), ``modules`` (the top-level modules the rank had
    imported) and ``log`` (its stdout and stderr).  ``threads`` sets each
    rank's intra-op threads; ``cwd`` the ranks' working directory
    (``workdir`` by default).  Raises ``TimeoutError`` after ``timeout``
    seconds (None: no limit but the group's own collective timeout) and
    ``RuntimeError`` when a rank fails, with the logs' tails."""
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} NCCL ranks but {torch.cuda.device_count()} CUDA "
                           "cards: NCCL needs one card a rank")
    workdir = Path(workdir).resolve()
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    if store.exists():
        store.unlink()
    spec = workdir / "spec.pt"
    torch.save({"target": target, "world_size": world_size, "backend": backend,
                "init": store.as_uri(), "kwargs": kwargs or {}, "threads": threads,
                "timeout": timeout}, spec)
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs, logs = [], []
    for r in range(world_size):
        logs.append(workdir / f"rank{r}.log")
        env = dict(child_env, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world_size))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, str(spec), str(r)], stdout=log,
                stderr=subprocess.STDOUT, env=env, cwd=str(cwd or workdir)))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=None if deadline is None else max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise TimeoutError(f"{target} on {world_size} ranks outlasted {timeout} s:\n"
                           + "\n".join(f"--- rank {r}\n{_tail(f)}" for r, f in enumerate(logs)))
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"{target}: ranks {failed} failed:\n"
                           + "\n".join(f"--- rank {r}\n{_tail(logs[r])}" for r in failed))
    out = []
    for r in range(world_size):
        saved = torch.load(workdir / f"rank{r}.pt", weights_only=False)
        saved["log"] = logs[r].read_text(errors="replace")
        out.append(saved)
    return out


def _rank_main(spec_path: str, rank: int) -> None:
    spec = torch.load(spec_path, weights_only=False)
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    import torch.distributed as dist

    from hessian_llm_vision_tpu_torch.parallel import dist_init
    from hessian_llm_vision_tpu_torch.parallel.mesh import make_mesh

    dist_init.initialize(spec["init"], spec["world_size"], rank, backend=spec["backend"],
                         timeout_s=spec["timeout"])
    try:
        result: Any = _resolve(spec["target"])(make_mesh(), **spec["kwargs"])
        modules = sorted({name.split(".")[0] for name in sys.modules})
        torch.save({"result": result, "modules": modules},
                   Path(spec_path).parent / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
