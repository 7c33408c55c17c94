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
  its launch (grid, chunks, ring of stages, aligned or shifted) is
  :func:`dots_plan`, plain Python that the CPU tests check;
* ``rank_k_axpy``  -- ``out = g + Vᵀ w``, replaces the TPU ``_axpy_kernel``;
  its launch (ring or direct kernel, grid, rows per stage, stages) is
  :func:`axpy_plan`.

Each plan is made once per (device, dtype, k, P, address mod 16 of V and
g) and cached with the SM count and the occupancy, so a call does its
checks, allocates its output and makes one ctypes call.  Pass 1 also keeps,
per device and stream, a scratch buffer of its blocks' partial sums and
the count by which its last block finds itself (the kernel leaves it 0).

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
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

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


def ptxas_usage(log: str) -> dict[str, dict]:
    """Registers and spilled bytes of each kernel in an ``nvcc -Xptxas -v``
    log, by kernel name (demangled with ``c++filt`` where it is installed)."""
    usage: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1)
            usage[name] = {"registers": None, "spill_bytes": 0}
        elif name and (spill := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[name]["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        elif name and (regs := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(regs.group(1))
    if usage and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(usage), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        short = [n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
                 for n in names]
        if len(short) == len(usage):
            usage = dict(zip(short, usage.values()))
    return usage


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
                dots.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, ctypes.POINTER(i32), ptr]
                dots.restype = i32
                occupancy = getattr(lib, f"rank_k_dots_blocks_per_sm_{dt}")
                occupancy.argtypes = [i32, i32, ctypes.POINTER(i32)]
                occupancy.restype = i32
                axpy = getattr(lib, f"rank_k_axpy_{dt}")
                axpy.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, i32, i32, i32, i32,
                                 i32, ptr]
                axpy.restype = i32
                occupancy = getattr(lib, f"rank_k_axpy_blocks_per_sm_{dt}")
                occupancy.argtypes = [i32, i32, ctypes.POINTER(i32)]
                occupancy.restype = i32
            _libs["rank_k"] = lib
        return lib


# ----------------------------------------------------------------------------
# rank-k apply
# ----------------------------------------------------------------------------

_THREADS = 256  # kThreads in rank_k.cu
_MAX_K = 12288  # pass 2 keeps w in 48 KB of shared memory
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load
_MAX_ROWS = 16  # kMaxRows: rows of V per sweep of pass 1
_BLOCK_SMEM = 232_448  # 227 KB: the shared memory one block may use on Hopper
# the rings' static shared memory, rounded up: pass 1's 16 mbarriers, its
# warps' double sums and its last-block flag (1156 bytes), pass 2's 16
# mbarriers (128 bytes)
_DOTS_STATIC_SMEM = 2048
_STATIC_SMEM = 1024
# the ring: two stages of 2048 elements of P, the fastest shape measured
# (PERF.md); fewer elements per stage where two such stages would not fit
_CHUNK = 2048
_STAGES = 2
_SHIFT_PAD = 128  # kShiftPad: slack of each slot of the shifted ring (128-byte slots)


@dataclasses.dataclass(frozen=True)
class DotsPlan:
    """How ``rank_k_dots`` launches pass 1 for one (k, P, basis dtype) and
    alignment of V and g.

    ``aligned``: V and g start 16-byte aligned and P is whole 16-byte
    vectors of V, so every row and chunk is bulk-copied whole; else the
    shifted ring, whose slots carry ``_SHIFT_PAD`` bytes of slack and whose
    producer warp loads the ends of each operand's chunk that no aligned
    copy covers.  ``vec``: elements of V per 16 bytes.  ``rows``: rows of V
    per sweep; each sweep streams g again.  ``chunk``: elements of P per
    stage; ``stages``: stages in the ring; ``smem_bytes``: the ring's
    dynamic shared memory, which the kernel is launched with.  ``nblocks``:
    the grid, at most ``blocks_per_sm`` x the SM count, so every block is
    resident at once.  Block b streams chunks b, b + nblocks, ... of P, so
    at any time the grid reads one window of each row.
    """

    aligned: bool
    vec: int
    rows: int
    chunk: int
    stages: int
    smem_bytes: int
    nblocks: int
    blocks_per_sm: int


def dots_stage_bytes(chunk: int, rows: int, es: int, aligned: bool) -> int:
    """One stage of pass 1's ring: g's slot (f32), then ``rows`` slots of V
    of ``es``-byte elements, each with ``_SHIFT_PAD`` bytes of slack on the
    shifted ring."""
    pad = 0 if aligned else _SHIFT_PAD
    return 4 * chunk + pad + rows * (chunk * es + pad)


def dots_plan(
    k: int, p: int, dtype: torch.dtype, *, ptrs: Iterable[int], sms: int,
    blocks_per_sm: Callable[[bool, int], int],
) -> DotsPlan:
    """Pass 1's launch for a (k, P) basis of ``dtype`` whose V and g start at
    ``ptrs``, on a card of ``sms`` SMs.  ``blocks_per_sm(aligned,
    smem_bytes)`` says how many blocks of the chosen ring fit on one SM."""
    vec = _VEC[dtype]
    es = 16 // vec
    rows = -(-k // -(-k // _MAX_ROWS))  # balanced sweeps of at most 16 rows
    aligned = p % vec == 0 and all(ptr % 16 == 0 for ptr in ptrs)
    chunk = _CHUNK  # halved at most once (16 f32 rows): stays whole vectors
    while _STAGES * dots_stage_bytes(chunk, rows, es, aligned) > _BLOCK_SMEM - _DOTS_STATIC_SMEM:
        chunk //= 2
    smem_bytes = _STAGES * dots_stage_bytes(chunk, rows, es, aligned)
    resident = blocks_per_sm(aligned, smem_bytes)
    if resident < 1:
        raise RuntimeError(f"rank_k_dots: no block of {smem_bytes} bytes fits an SM")
    nblocks = max(1, min(resident * sms, -(-p // chunk)))
    return DotsPlan(aligned, vec, rows, chunk, _STAGES, smem_bytes, nblocks, resident)


# pass 2 (rank_k.cu: kAxpyUnroll; kRingVecs bounds _RING_GROUPS, kMaxStages _RING_STAGES)
_AXPY_UNROLL = 2  # 16-byte groups per thread per tile of the direct path
_CONSUMERS = 256  # ring consumer threads (eight warps)
# the ring: two 16-byte groups of each stage row per consumer (8 KB bulk
# copies), up to four stages; from 2**23 elements of P on, where it beat the
# direct kernel (PERF.md), which below takes P with a grid sized to P
_RING_GROUPS = 2
_RING_STAGES = 4
_RING_MIN_P = 1 << 23
_DIRECT_SMEM_MAX = 48 * 1024  # w of the direct path, static limit


@dataclasses.dataclass(frozen=True)
class AxpyPlan:
    """How ``rank_k_axpy`` launches pass 2 for one (k, P, basis dtype) and
    alignment of V and g.

    ``ring``: the bulk-copy ring (V's rows 16-byte aligned, P at least
    ``_RING_MIN_P``); else the direct kernel.  ``vec_v`` / ``vec_g``: V's
    rows / g read in 16-byte vectors (on the ring, ``vec_g`` means g comes in
    bulk copies too); the other operand still may.  ``vec``: elements per
    16-byte group.  ``chunk``: elements of P per stage (ring) or per tile of
    a block (direct: ``_AXPY_UNROLL`` groups per thread); ``rows``: rows of
    V per stage, ``ceil(k / rows)`` stages per chunk (direct: k);
    ``stages``: stages in the ring; ``smem_bytes``: the dynamic shared memory
    (w, then the ring).  ``nblocks``: at most ``blocks_per_sm`` x the SM
    count, and no more than there are chunks or tiles.
    """

    ring: bool
    vec_v: bool
    vec_g: bool
    vec: int
    rows: int
    chunk: int
    stages: int
    smem_bytes: int
    nblocks: int
    blocks_per_sm: int


def axpy_plan(
    k: int, p: int, dtype: torch.dtype, *, ptrs: Iterable[int], sms: int,
    blocks_per_sm: Callable[[bool, int], int], ring: Optional[bool] = None,
) -> AxpyPlan:
    """Pass 2's launch for a (k, P) basis of ``dtype`` whose V and g start at
    ``ptrs`` (V first), on a card of ``sms`` SMs.  ``blocks_per_sm(ring,
    smem_bytes)`` says how many blocks of the chosen kernel fit on one SM.
    ``ring`` forces a path (the ring only where V's rows are aligned)."""
    vec = _VEC[dtype]
    es = 16 // vec
    v_ptr, g_ptr = ptrs
    vec_v = v_ptr % 16 == 0 and (k == 1 or p % vec == 0)
    vec_g = g_ptr % 16 == 0
    w_bytes = -(-4 * k // 128) * 128
    can_ring = vec_v and p % vec == 0
    if ring is None:
        ring = can_ring and p >= _RING_MIN_P
    elif ring and not can_ring:
        raise ValueError(f"rank_k_axpy: no ring for V's rows at k={k}, P={p}, V at {v_ptr:#x}")
    if not ring:
        chunk = _AXPY_UNROLL * _THREADS * vec
        smem_bytes = 4 * k
        if smem_bytes > _DIRECT_SMEM_MAX:
            raise ValueError(f"rank_k_axpy: w of k={k} rows does not fit {_DIRECT_SMEM_MAX} bytes")
        resident = blocks_per_sm(False, smem_bytes)
        if resident < 1:
            raise RuntimeError(f"rank_k_axpy: no block of {smem_bytes} bytes fits an SM")
        nblocks = max(1, min(resident * sms, -(-(p // vec) // (_AXPY_UNROLL * _THREADS))))
        return AxpyPlan(False, vec_v, vec_g, vec, k, chunk, 1, smem_bytes, nblocks, resident)
    chunk = _RING_GROUPS * _CONSUMERS * vec
    room = _BLOCK_SMEM - _STATIC_SMEM - w_bytes
    g_bytes = 4 * chunk if vec_g else 0
    fit = (room // 2 - g_bytes) // (chunk * es)  # rows of two stages that fit
    if fit < 1:
        raise RuntimeError(f"rank_k_axpy: two ring stages of one row do not fit at k={k}")
    rows = -(-k // -(-k // fit))  # balanced sweeps of at most `fit` rows
    stage = g_bytes + rows * chunk * es
    stages = min(_RING_STAGES, room // stage)
    smem_bytes = w_bytes + stages * stage
    resident = blocks_per_sm(True, smem_bytes)
    if resident < 1:
        raise RuntimeError(f"rank_k_axpy: no block of {smem_bytes} bytes fits an SM")
    nblocks = max(1, min(resident * sms, -(-p // chunk)))
    return AxpyPlan(True, vec_v, vec_g, vec, rows, chunk, stages, smem_bytes, nblocks, resident)


# ----------------------------------------------------------------------------
# launch path: per call, the checks, the outputs and one ctypes call; the SM
# count, the occupancy, each plan and pass 1's scratch are made once
# ----------------------------------------------------------------------------

_sm_counts: dict[int, int] = {}
_resident: dict[tuple, int] = {}
_plans: dict[tuple, object] = {}
_fns: dict[tuple, object] = {}
_scratch: dict[tuple, tuple] = {}  # (device, stream) -> (tensor, its partials' floats, pointer)
_dots_args: dict[int, tuple] = {}  # id(plan) -> (plan, its launch ints as a C array)


def _device_index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def _sms(index: int) -> int:
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def _occupancy(kernel: str, index: int, dtype: torch.dtype, flag: bool, smem_bytes: int) -> int:
    """The occupancy API's count of resident blocks of a kernel, once per kind."""
    key = (kernel, index, dtype, flag, smem_bytes)
    if key not in _resident:
        blocks = ctypes.c_int(0)
        fn = _fn(f"{kernel}_blocks_per_sm", dtype)
        with torch.cuda.device(index):
            _raise_on(fn(int(flag), smem_bytes, ctypes.byref(blocks)), f"{kernel} occupancy")
        _resident[key] = blocks.value
    return _resident[key]


def _plan(kind: str, index: int, dtype: torch.dtype, k: int, p: int, ptrs: tuple[int, ...],
          **force):
    """The plan of ``kind`` ("dots" or "axpy"), made once per (device, dtype,
    k, P, address mod 16 of each pointer, forced path)."""
    key = (kind, index, dtype, k, p, tuple([ptr & 15 for ptr in ptrs]), *force.values())
    plan = _plans.get(key)
    if plan is None:
        make = dots_plan if kind == "dots" else axpy_plan
        kernel = f"rank_k_{kind}"
        plan = _plans[key] = make(
            k, p, dtype, ptrs=ptrs, sms=_sms(index),
            blocks_per_sm=lambda flag, smem: _occupancy(kernel, index, dtype, flag, smem),
            **force,
        )
    return plan


def _fn(name: str, dtype: torch.dtype):
    """The bound C entry point ``<name>_<f32|bf16>``, looked up once."""
    fn = _fns.get((name, dtype))
    if fn is None:
        fn = _fns[(name, dtype)] = getattr(_rank_k_lib(), f"{name}_{_SUFFIX[dtype]}")
    return fn


def _dots_scratch(index: int, stream: int, floats: int) -> int:
    """The address of pass 1's scratch on device ``index`` for ``stream``:
    16 bytes whose first 4 count the blocks that have finished (0 between
    launches), then room for ``floats`` partial sums.  One buffer per
    stream, so launches that use it run in order; it grows (zeroed) when a
    call needs more."""
    held = _scratch.get((index, stream))
    if held is None or held[1] < floats:
        floats = max(floats, 2 * held[1]) if held else floats
        buf = torch.zeros(4 + floats, dtype=torch.float32, device=torch.device("cuda", index))
        held = _scratch[(index, stream)] = (buf, floats, buf.data_ptr())
    return held[2]


def _dots_launch_ints(plan: DotsPlan, k: int):
    """``plan``'s ints as the C array ``rank_k_dots_*`` takes: k, nblocks,
    aligned, chunk, stages, rows, smem_bytes (made once per plan)."""
    held = _dots_args.get(id(plan))
    if held is None or held[0] is not plan:
        ints = (ctypes.c_int * 7)(k, plan.nblocks, int(plan.aligned), plan.chunk, plan.stages,
                                  plan.rows, plan.smem_bytes)
        held = _dots_args[id(plan)] = (plan, ints)
    return held[1]


def dots_launch_plan(
    k: int, p: int, dtype: torch.dtype, device, ptrs: Iterable[int] = (),
) -> DotsPlan:
    """:func:`dots_plan` on this CUDA card (its SMs, the occupancy API)."""
    return _plan("dots", _device_index(device), dtype, k, p, tuple(ptrs))


def axpy_launch_plan(
    k: int, p: int, dtype: torch.dtype, device, ptrs: Iterable[int] = (0, 0),
    ring: Optional[bool] = None,
) -> AxpyPlan:
    """:func:`axpy_plan` on this CUDA card (its SMs, the occupancy API)."""
    return _plan("axpy", _device_index(device), dtype, k, p, tuple(ptrs), ring=ring)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    for t in tensors:  # a loop, not all(): this runs on every call
        if not t.is_cpu:
            return False
    return True


def _check_operands(g: torch.Tensor, basis: torch.Tensor) -> None:
    if not (g.is_cuda and basis.is_cuda and g.get_device() == basis.get_device()):
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


def _f32_on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` as a contiguous f32 tensor on ``device``, copied only if it is not one."""
    if t.dtype == torch.float32 and t.device == device and t.is_contiguous():
        return t
    return t.to(device=device, dtype=torch.float32).contiguous()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _launch(fn, index: int, stream: int, *args) -> int:
    """``fn(*args, stream)`` on device ``index``, entering the device only
    when it is not the current one."""
    if index == torch._C._cuda_getDevice():  # torch.cuda.current_device() without its checks
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def rank_k_dots(g: torch.Tensor, basis: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """``w = coeffs ⊙ (basis @ g)``, (k,) f32: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if _on_cpu(g, basis, coeffs):
        return rank_k_dots_reference(g, basis, coeffs)
    _check_operands(g, basis)
    k, p = basis.shape
    if coeffs.numel() != k:
        raise ValueError(f"rank_k_dots: {coeffs.numel()} coeffs for k={k}")
    index = g.get_device()
    c = coeffs  # the common case, checked without making device objects
    if not (c.dtype is torch.float32 and c.is_cuda and c.get_device() == index
            and c.is_contiguous()):
        c = _f32_on(coeffs, g.device)
    v_ptr, g_ptr = basis.data_ptr(), g.data_ptr()
    # _plan's key, looked up here first: this runs on every call
    plan = _plans.get(("dots", index, basis.dtype, k, p, (v_ptr & 15, g_ptr & 15)))
    if plan is None:
        plan = _plan("dots", index, basis.dtype, k, p, (v_ptr, g_ptr))
    stream = torch._C._cuda_getCurrentRawStream(index)
    scratch = _dots_scratch(index, stream, k * plan.nblocks)
    w = g.new_empty(k)  # f32 on g's device
    err = _launch(_fn("rank_k_dots", basis.dtype), index, stream,
                  v_ptr, g_ptr, c.data_ptr(), scratch, w.data_ptr(), p,
                  _dots_launch_ints(plan, k))
    _raise_on(err, "rank_k_dots")
    LAUNCHES["rank_k_dots"] += 1
    return w


def rank_k_axpy(
    g: torch.Tensor, basis: torch.Tensor, w: torch.Tensor, *, ring: Optional[bool] = None,
) -> torch.Tensor:
    """``out = g + basisᵀ @ w``, (P,) f32: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors.  ``ring`` forces the ring (True) or
    the direct kernel (False) where :func:`axpy_plan` would choose."""
    if _on_cpu(g, basis, w):
        return rank_k_axpy_reference(g, basis, w)
    _check_operands(g, basis)
    k, p = basis.shape
    if w.numel() != k:
        raise ValueError(f"rank_k_axpy: {w.numel()} weights for k={k}")
    device, index = g.device, g.get_device()
    w = _f32_on(w, device)
    v_ptr, g_ptr = basis.data_ptr(), g.data_ptr()
    plan = _plan("axpy", index, basis.dtype, k, p, (v_ptr, g_ptr), ring=ring)
    out = torch.empty(p, dtype=torch.float32, device=device)
    err = _launch(_fn("rank_k_axpy", basis.dtype), index,
                  torch._C._cuda_getCurrentRawStream(index),
                  v_ptr, g_ptr, w.data_ptr(), out.data_ptr(), k, p, plan.nblocks,
                  int(plan.ring), int(plan.vec_v), int(plan.vec_g), plan.chunk, plan.stages,
                  plan.rows, plan.smem_bytes)
    _raise_on(err, "rank_k_axpy")
    LAUNCHES["rank_k_axpy"] += 1
    return out


def rank_k_apply(g: torch.Tensor, basis: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """``g + basisᵀ · (coeffs ⊙ (basis @ g))`` by the kernel pair."""
    return rank_k_axpy(g, basis, rank_k_dots(g, basis, coeffs))
