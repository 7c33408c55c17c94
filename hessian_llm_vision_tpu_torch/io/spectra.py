"""Spectrum artifact IO (port of ``io/spectra.py``).

The native format is ``.npz`` with the JAX package's layout (``eigvals``,
``gammas``, optional ``V``, ``meta_*``), so either package reads the
other's files.  The reference's torch format, ``torch.save({'eigvals',
'gammas'[, 'V']})`` in a ``.ckpt``/``.pt`` file, is read and written too.
Per-iteration T checkpoints and the full Lanczos state make long spectra
resumable (``krylov.lanczos.lanczos_checkpointed``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hessian_llm_vision_tpu_torch.krylov.slq import Spectrum


def _host(x) -> np.ndarray:
    """Tensor, list of 0-d tensors, or array-like -> numpy on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return np.asarray([_host(e) for e in x])
    return np.asarray(x)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _makedirs_for(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)


def save_spectrum(path: str, spectrum: Spectrum, **metadata) -> None:
    _makedirs_for(path)
    arrays = {"eigvals": _host(spectrum.eigvals), "gammas": _host(spectrum.gammas)}
    if spectrum.ritz_vectors is not None:
        arrays["V"] = _host(spectrum.ritz_vectors)
    for k, v in metadata.items():
        arrays[f"meta_{k}"] = _host(v)
    np.savez(path, **arrays)


def load_spectrum(path: str) -> Spectrum:
    with np.load(_npz(path)) as z:
        return Spectrum(
            eigvals=torch.from_numpy(z["eigvals"]),
            gammas=torch.from_numpy(z["gammas"]),
            ritz_vectors=torch.from_numpy(z["V"]) if "V" in z else None,
        )


def save_reference_spectrum(path: str, spectrum: Spectrum) -> None:
    """Write the reference's torch format (``torch.save`` of a dict of CPU
    tensors)."""
    _makedirs_for(path)
    d = {"eigvals": torch.from_numpy(_host(spectrum.eigvals).copy()),
         "gammas": torch.from_numpy(_host(spectrum.gammas).copy())}
    if spectrum.ritz_vectors is not None:
        d["V"] = torch.from_numpy(_host(spectrum.ritz_vectors).copy())
    torch.save(d, path)


def load_reference_spectrum(path: str) -> Spectrum:
    """Read a reference ``results.ckpt`` ({'eigvals', 'gammas'[, 'V']}).
    Only tensors and containers are unpickled (``weights_only=True``)."""
    d = torch.load(path, map_location="cpu", weights_only=True)
    V = torch.as_tensor(d["V"]) if "V" in d else None
    return Spectrum(eigvals=torch.as_tensor(d["eigvals"]).reshape(-1),
                    gammas=torch.as_tensor(d["gammas"]).reshape(-1), ritz_vectors=V)


def save_tridiag(path: str, alphas, betas, **metadata) -> None:
    """Per-iteration T checkpoint."""
    _makedirs_for(path)
    np.savez(path, alphas=_host(alphas), betas=_host(betas),
             **{f"meta_{k}": np.asarray(v) for k, v in metadata.items()})


def load_tridiag(path: str):
    with np.load(_npz(path)) as z:
        return z["alphas"], z["betas"]


def save_lanczos_state(path: str, q_prev, q_cur, beta_prev, alphas, betas) -> None:
    """Full resumable Lanczos state for ``lanczos_checkpointed``."""
    _makedirs_for(path)
    np.savez(path, q_prev=_host(q_prev), q_cur=_host(q_cur), beta_prev=_host(beta_prev),
             alphas=_host(alphas), betas=_host(betas))


def load_lanczos_state(path: str) -> dict:
    with np.load(_npz(path)) as z:
        return {
            "q_prev": z["q_prev"],
            "q_cur": z["q_cur"],
            "beta_prev": float(z["beta_prev"]),
            "alphas": list(z["alphas"]),
            "betas": list(z["betas"]),
        }
