"""Vision data (port of ``data/vision.py``): MNIST from idx files, CIFAR-10
from its python pickles, and the seeded numpy transforms.

The loaders read the raw formats with numpy and return host arrays in
NHWC layout, equal to the JAX package's for the same files; the
transforms (random crop with reflect padding and horizontal flip, additive
Gaussian noise) are seeded numpy ops over a whole batch.  The data
directories are read from ``HLV_MNIST_DIR`` and ``HLV_CIFAR_DIR`` when a
loader is called, not when this module is imported; unset, both are the
working directory (the JAX package's MNIST default is a mount of the
upstream repository's data, which the port does not assume).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def _mnist_dir() -> str:
    return os.environ.get("HLV_MNIST_DIR", "")


def _cifar_dir() -> str:
    return os.environ.get("HLV_CIFAR_DIR", "")


def _read_idx(path: str) -> np.ndarray:
    """An idx file (plain, or gzip by its ``.gz`` suffix) as uint8."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find_idx(base: str, stem: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(base, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def load_mnist(split: str = "test", data_dir: Optional[str] = None,
               normalize: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N, 28, 28, 1) f32, labels (N,) i32) from the raw idx files
    under ``data_dir`` (default ``$HLV_MNIST_DIR``)."""
    data_dir = data_dir or _mnist_dir()
    prefix = "train" if split == "train" else "t10k"
    img_p = _find_idx(data_dir, f"{prefix}-images-idx3-ubyte")
    lbl_p = _find_idx(data_dir, f"{prefix}-labels-idx1-ubyte")
    if img_p is None or lbl_p is None:
        raise FileNotFoundError(
            f"MNIST {split} idx files not found under {data_dir} (set HLV_MNIST_DIR)"
        )
    x = _read_idx(img_p).astype(np.float32)[..., None] / 255.0
    y = _read_idx(lbl_p).astype(np.int32)
    if normalize:
        x = (x - MNIST_MEAN) / MNIST_STD
    return x, y


def load_mnist_as_cifar(split: str = "train", data_dir: Optional[str] = None,
                        normalize: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST in the CIFAR input shape, (N, 32, 32, 3) f32: each 28x28 digit
    centred on a 32x32 canvas of the (normalised) black background, the
    channel repeated to RGB; the true digit labels."""
    x, y = load_mnist(split, data_dir=data_dir, normalize=normalize)
    bg = float((0.0 - MNIST_MEAN) / MNIST_STD) if normalize else 0.0
    out = np.full((x.shape[0], 32, 32, 1), bg, np.float32)
    out[:, 2:30, 2:30, :] = x
    return np.repeat(out, 3, axis=3), y


def load_cifar10(split: str = "train", data_dir: Optional[str] = None,
                 normalize: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N, 32, 32, 3) f32 NHWC, labels (N,) i32) from the python
    pickles (``cifar-10-batches-py``) under ``data_dir`` (default
    ``$HLV_CIFAR_DIR``)."""
    data_dir = data_dir or _cifar_dir()
    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        raise FileNotFoundError(
            f"CIFAR-10 python batches not found under {data_dir} "
            "(set HLV_CIFAR_DIR; no network egress to download)"
        )
    files = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    xs, ys = [], []
    for fn in files:
        with open(os.path.join(base, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.append(np.asarray(d[b"labels"]))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    x = x.astype(np.float32) / 255.0
    y = np.concatenate(ys).astype(np.int32)
    if normalize:
        x = (x - CIFAR_MEAN) / CIFAR_STD
    return x, y


def get_class_subset(x: np.ndarray, y: np.ndarray, classes: Sequence[int],
                     remap: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """The examples of ``classes``; ``remap`` relabels them 0..len(classes)-1
    in the order given."""
    classes = list(classes)
    sel = np.isin(y, classes)
    xs, ys = x[sel], y[sel]
    if remap:
        lut = {c: i for i, c in enumerate(classes)}
        ys = np.vectorize(lut.get)(ys).astype(np.int32)
    return xs, ys


def add_gaussian_noise(x: np.ndarray, std: float, seed: int = 0) -> np.ndarray:
    """``x`` plus seeded N(0, std^2) noise."""
    rng = np.random.RandomState(seed)
    return x + rng.randn(*x.shape).astype(np.float32) * std


def augment_batch(x: np.ndarray, seed: int, crop_pad: int = 4, flip: bool = True) -> np.ndarray:
    """Random crop of a reflect-padded image and a random horizontal flip,
    per image of an NHWC batch, from one seeded draw for the batch."""
    rng = np.random.RandomState(seed)
    n, h, w, _ = x.shape
    padded = np.pad(x, ((0, 0), (crop_pad, crop_pad), (crop_pad, crop_pad), (0, 0)), "reflect")
    out = np.empty_like(x)
    offs = rng.randint(0, 2 * crop_pad + 1, size=(n, 2))
    flips = rng.rand(n) < 0.5 if flip else np.zeros(n, bool)
    for i in range(n):
        oy, ox = offs[i]
        img = padded[i, oy:oy + h, ox:ox + w]
        out[i] = img[:, ::-1] if flips[i] else img
    return out
