"""Hand-written CUDA kernels of the port: built at first use, bound with ctypes.

Build: ``nvcc`` compiles each ``ops/csrc/*.cu`` into a shared library with
a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), all sources
in parallel, into ``hessian_llm_vision_tpu_torch/_build/`` (git-ignored).
A library is named by a hash of its source and the flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing is built when the
module is imported.

Kernels (plain versions: ``ops/spectral.py::rank_k_dots_reference`` and
``rank_k_axpy_reference``):

* ``rank_k_dots``  -- ``w = c ⊙ (V g)``, replaces the TPU ``_dots_kernel``;
* ``rank_k_axpy``  -- ``out = g + Vᵀ w``, replaces the TPU ``_axpy_kernel``.

Each wrapper runs the plain version when its tensors lie on the CPU.  On
CUDA tensors it checks its operands, allocates outputs with
``torch.empty``, launches on the current stream, raises when the launch
reports a CUDA error, and adds one to ``LAUNCHES[name]`` -- there and
nowhere else -- so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable, Optional

import torch

from hessian_llm_vision_tpu_torch.ops.spectral import (
    rank_k_axpy_reference,
    rank_k_dots_reference,
)

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: launches per kernel since the last reset_launch_counts()
LAUNCHES = {"rank_k_dots": 0, "rank_k_axpy": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc's output, including -Xptxas -v registers and spills


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin: "
        "the CUDA kernels cannot be built"
    )


def build(names: Optional[Iterable[str]] = None) -> dict[str, BuildResult]:
    """Compile ``csrc/<name>.cu`` (every source when ``names`` is None),
    one ``nvcc`` per source, all started together.  Raises on any failure
    with the compiler's output."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if names is not None:
        wanted = set(names)
        sources = [s for s in sources if s.stem in wanted]
        missing = wanted - {s.stem for s in sources}
        if missing:
            raise FileNotFoundError(f"no CUDA source for {sorted(missing)} in {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: dict[str, BuildResult] = {}
    jobs = []
    try:
        for src in sources:
            digest = hashlib.sha256(
                src.read_bytes() + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
            out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
            if out.exists():
                results[src.stem] = BuildResult(src.stem, out, 0.0, "")
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((src.stem, proc, tmp, out, time.perf_counter()))
        for name, proc, tmp, out, t0 in jobs:
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
            results[name] = BuildResult(name, out, seconds, log)
    finally:
        for _, proc, tmp, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return results


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _rank_k_lib() -> ctypes.CDLL:
    """Build (once per process) and bind ``csrc/rank_k.cu``."""
    with _lock:
        lib = _libs.get("rank_k")
        if lib is None:
            lib = ctypes.CDLL(str(build(["rank_k"])["rank_k"].path))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            for dt in _SUFFIX.values():
                dots = getattr(lib, f"rank_k_dots_{dt}")
                dots.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32, ptr]
                dots.restype = i32
                axpy = getattr(lib, f"rank_k_axpy_{dt}")
                axpy.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, i32, ptr]
                axpy.restype = i32
            _libs["rank_k"] = lib
        return lib


# ----------------------------------------------------------------------------
# rank-k apply
# ----------------------------------------------------------------------------

_THREADS = 256  # kThreads in rank_k.cu
_MAX_K = 12288  # pass 2 keeps w in 48 KB of shared memory
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_operands(g: torch.Tensor, basis: torch.Tensor) -> None:
    if not (g.is_cuda and basis.is_cuda and g.device == basis.device):
        raise ValueError(f"rank-k kernel: g ({g.device}) and basis ({basis.device}) must share one CUDA device")
    if basis.dtype not in _SUFFIX:
        raise TypeError(f"rank-k kernel: basis dtype {basis.dtype} not supported (float32 or bfloat16)")
    if g.dtype != torch.float32:
        raise TypeError(f"rank-k kernel: g must be float32, got {g.dtype}")
    if basis.dim() != 2 or g.dim() != 1 or g.shape[0] != basis.shape[1]:
        raise ValueError(f"rank-k kernel: shapes g {tuple(g.shape)}, basis {tuple(basis.shape)} do not match (P,), (k, P)")
    if not (g.is_contiguous() and basis.is_contiguous()):
        raise ValueError("rank-k kernel: g and basis must be contiguous")
    k, p = basis.shape
    if not (1 <= k <= _MAX_K and p >= 1):
        raise ValueError(f"rank-k kernel: need 1 <= k <= {_MAX_K} and P >= 1, got k={k}, P={p}")


def _launch_shape(basis: torch.Tensor, blocks_per_sm: int, *tensors: torch.Tensor):
    """(vectorized, nblocks) for a grid-stride launch over P."""
    vec = _VEC[basis.dtype]
    p = basis.shape[1]
    vectorized = p % vec == 0 and all(t.data_ptr() % 16 == 0 for t in (basis, *tensors))
    nvec = p // vec if vectorized else p
    sms = torch.cuda.get_device_properties(basis.device).multi_processor_count
    return vectorized, max(1, min(blocks_per_sm * sms, -(-nvec // _THREADS)))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def rank_k_dots(g: torch.Tensor, basis: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """``w = coeffs ⊙ (basis @ g)``, (k,) f32: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if _on_cpu(g, basis, coeffs):
        return rank_k_dots_reference(g, basis, coeffs)
    _check_operands(g, basis)
    k, p = basis.shape
    if coeffs.numel() != k:
        raise ValueError(f"rank_k_dots: {coeffs.numel()} coeffs for k={k}")
    c = coeffs.to(device=g.device, dtype=torch.float32).contiguous()
    vectorized, nblocks = _launch_shape(basis, 4, g)
    partials = torch.empty((k, nblocks), dtype=torch.float32, device=g.device)
    w = torch.empty(k, dtype=torch.float32, device=g.device)
    fn = getattr(_rank_k_lib(), f"rank_k_dots_{_SUFFIX[basis.dtype]}")
    with torch.cuda.device(g.device):
        err = fn(basis.data_ptr(), g.data_ptr(), c.data_ptr(), partials.data_ptr(),
                 w.data_ptr(), k, p, nblocks, int(vectorized),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "rank_k_dots")
    LAUNCHES["rank_k_dots"] += 1
    return w


def rank_k_axpy(g: torch.Tensor, basis: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out = g + basisᵀ @ w``, (P,) f32: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if _on_cpu(g, basis, w):
        return rank_k_axpy_reference(g, basis, w)
    _check_operands(g, basis)
    k, p = basis.shape
    if w.numel() != k:
        raise ValueError(f"rank_k_axpy: {w.numel()} weights for k={k}")
    w = w.to(device=g.device, dtype=torch.float32).contiguous()
    out = torch.empty(p, dtype=torch.float32, device=g.device)
    vectorized, nblocks = _launch_shape(basis, 8, g, out)
    fn = getattr(_rank_k_lib(), f"rank_k_axpy_{_SUFFIX[basis.dtype]}")
    with torch.cuda.device(g.device):
        err = fn(basis.data_ptr(), g.data_ptr(), w.data_ptr(), out.data_ptr(),
                 k, p, nblocks, int(vectorized),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "rank_k_axpy")
    LAUNCHES["rank_k_axpy"] += 1
    return out


def rank_k_apply(g: torch.Tensor, basis: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """``g + basisᵀ · (coeffs ⊙ (basis @ g))`` by the kernel pair."""
    return rank_k_axpy(g, basis, rank_k_dots(g, basis, coeffs))
