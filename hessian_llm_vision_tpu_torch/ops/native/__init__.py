"""The host rank-k op (port of ``ops/native``): ``vector_adjust.cpp`` bound
with ctypes.

``g++ -O3 -fopenmp`` builds it at first use into the git-ignored
``hessian_llm_vision_tpu_torch/_build/``, named by a hash of the source and
the flags (an edited source rebuilds); nothing is built at import.  It is
a host op for a basis kept in host memory (``parallel/offload.py``), not
a port of a TPU kernel: the card's rank-k pair is ``ops/kernels.py``.

Each function takes f32 numpy arrays or CPU tensors (a tensor on the card
raises) and returns ``g``'s kind: a numpy array for a numpy ``g``, a CPU
tensor for a tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "vector_adjust.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libvector_adjust_{digest}.so"


def build() -> Path:
    """Compile the library unless this source's build exists; its path."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fp, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            lib.rank_k_apply.argtypes = [fp, fp, fp, fp, i64, i64]
            lib.spectral_adjust.argtypes = [fp, fp, fp, fp, i64, i64, ctypes.c_float]
            lib.project_out.argtypes = [fp, fp, fp, i64, i64]
            for fn in (lib.rank_k_apply, lib.spectral_adjust, lib.project_out):
                fn.restype = None
            lib.num_threads.restype = ctypes.c_int
            _lib = lib
        return _lib


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":  # a host op: the caller moves its operands (to_host)
            raise ValueError(f"the host rank-k op takes host memory, got a tensor on {x.device}")
        x = x.detach().numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _operands(g, basis, coeffs=None):
    g32, V = _f32(g), _f32(basis)
    if V.ndim != 2 or g32.shape != (V.shape[1],):
        raise ValueError(f"shapes g {g32.shape}, basis {V.shape} do not match (P,), (k, P)")
    c = None
    if coeffs is not None:
        c = _f32(coeffs)
        if c.shape != (V.shape[0],):
            raise ValueError(f"{c.shape} coefficients for k={V.shape[0]}")
    return g32, V, c


def _like(g, out: np.ndarray):
    return torch.from_numpy(out) if isinstance(g, torch.Tensor) else out


def rank_k_apply_native(g, basis, coeffs):
    """``g + basisᵀ (coeffs ⊙ (basis @ g))`` on the host, f32 out."""
    g32, V, c = _operands(g, basis, coeffs)
    out = np.empty_like(g32)
    load_library().rank_k_apply(_ptr(g32), _ptr(V), _ptr(c), _ptr(out), *V.shape)
    return _like(g, out)


def spectral_adjust_native(g, basis, eigvals, delta: float):
    """LanczosSGD's ``g + Σᵢ (1/λᵢ − 1/(λᵢ+δ))(vᵢ·g)vᵢ`` on the host."""
    g32, V, e = _operands(g, basis, eigvals)
    out = np.empty_like(g32)
    load_library().spectral_adjust(_ptr(g32), _ptr(V), _ptr(e), _ptr(out), *V.shape,
                                   ctypes.c_float(delta))
    return _like(g, out)


def project_out_native(g, basis):
    """``g − Σᵢ (vᵢ·g)vᵢ`` on the host."""
    g32, V, _ = _operands(g, basis)
    out = np.empty_like(g32)
    load_library().project_out(_ptr(g32), _ptr(V), _ptr(out), *V.shape)
    return _like(g, out)


def num_threads() -> int:
    """OpenMP threads the library runs with."""
    return load_library().num_threads()
