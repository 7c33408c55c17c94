"""The port's vision and synthetic data against the JAX package's, bit for
bit: the spiral and random-image generators, the seeded transforms, the
class subset, and the MNIST idx (plain and gzip) and CIFAR-10 pickle
readers on files the tests write, with the data directories read from
``HLV_MNIST_DIR`` / ``HLV_CIFAR_DIR`` when a loader is called."""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest

import hessian_llm_vision_tpu_torch.data as data
from hessian_llm_vision_tpu.data import synthetic as jsynthetic
from hessian_llm_vision_tpu.data import vision as jvision
from hessian_llm_vision_tpu_torch.data import synthetic, vision


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(num_points=120, noise=0.5, seed=3),
                                dict(num_points=91, num_classes=4, turns=2.0, seed=7)],
                         ids=["default", "noisy", "four_classes"])
def test_make_spirals_equals_jax(kw):
    for ours, ref in zip(synthetic.make_spirals(**kw), jsynthetic.make_spirals(**kw)):
        _equal(ours, ref)


@pytest.mark.parametrize("kw", [dict(), dict(shape=(28, 28, 1), num_classes=3, seed=11)],
                         ids=["cifar", "mnist"])
def test_random_image_batches_equal_jax(kw):
    for ours, ref in zip(synthetic.random_image_batches(3, 5, **kw),
                         jsynthetic.random_image_batches(3, 5, **kw)):
        _equal(ours, ref)


def _images(n=9, h=8, w=8, c=3, seed=0):
    return np.random.RandomState(seed).randn(n, h, w, c).astype(np.float32)


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("seed", [0, 100045])
def test_augment_batch_equals_jax(flip, seed):
    x = _images()
    _equal(vision.augment_batch(x, seed=seed, flip=flip),
           jvision.augment_batch(x, seed=seed, flip=flip))
    _equal(vision.augment_batch(x, seed=seed, crop_pad=2),
           jvision.augment_batch(x, seed=seed, crop_pad=2))


def test_add_gaussian_noise_equals_jax():
    x = _images()
    for seed in (0, 5):
        _equal(vision.add_gaussian_noise(x, 0.3, seed=seed),
               jvision.add_gaussian_noise(x, 0.3, seed=seed))


@pytest.mark.parametrize("remap", [True, False])
def test_get_class_subset_equals_jax(remap):
    x = _images(n=30)
    y = np.random.RandomState(1).randint(0, 10, 30).astype(np.int32)
    ours = vision.get_class_subset(x, y, [7, 2, 5], remap=remap)
    ref = jvision.get_class_subset(x, y, [7, 2, 5], remap=remap)
    for a, b in zip(ours, ref):
        _equal(a, b)
    if remap:
        assert set(ours[1].tolist()) <= {0, 1, 2}


def write_idx(path: str, a: np.ndarray) -> None:
    """An idx file of uint8 ``a`` (gzip when ``path`` ends in .gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | a.ndim) + struct.pack(f">{a.ndim}I", *a.shape))
        f.write(a.astype(np.uint8).tobytes())


def write_mnist(directory, split: str, n: int, seed: int, gz: bool = False) -> None:
    rng = np.random.RandomState(seed)
    prefix = "train" if split == "train" else "t10k"
    suffix = ".gz" if gz else ""
    write_idx(os.path.join(directory, f"{prefix}-images-idx3-ubyte{suffix}"),
              rng.randint(0, 256, (n, 28, 28)))
    write_idx(os.path.join(directory, f"{prefix}-labels-idx1-ubyte{suffix}"),
              rng.randint(0, 10, n))


def write_cifar(directory, n_per_batch: int, seed: int) -> None:
    """cifar-10-batches-py with five train batches and a test batch."""
    base = os.path.join(directory, "cifar-10-batches-py")
    os.makedirs(base)
    rng = np.random.RandomState(seed)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.randint(0, 256, (n_per_batch, 3072)).astype(np.uint8),
             b"labels": rng.randint(0, 10, n_per_batch).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_idx_readers_equal_jax(tmp_path, monkeypatch, gz, split):
    write_mnist(tmp_path, split, 7, seed=3, gz=gz)
    # set after import: the loaders read the variable when called
    monkeypatch.setenv("HLV_MNIST_DIR", str(tmp_path))
    for normalize in (True, False):
        for ours, ref in zip(vision.load_mnist(split, normalize=normalize),
                             jvision.load_mnist(split, normalize=normalize)):
            _equal(ours, ref)
        for ours, ref in zip(vision.load_mnist_as_cifar(split, normalize=normalize),
                             jvision.load_mnist_as_cifar(split, normalize=normalize)):
            _equal(ours, ref)
    x, _ = vision.load_mnist_as_cifar(split)
    assert x.shape == (7, 32, 32, 3)
    # the pad is the normalised black background
    np.testing.assert_allclose(x[:, 0, 0, :], -vision.MNIST_MEAN / vision.MNIST_STD, rtol=1e-6)


@pytest.mark.parametrize("split", ["train", "test"])
def test_cifar_pickle_reader_equals_jax(tmp_path, monkeypatch, split):
    write_cifar(tmp_path, 4, seed=2)
    monkeypatch.setenv("HLV_CIFAR_DIR", str(tmp_path))
    for normalize in (True, False):
        ours = vision.load_cifar10(split, normalize=normalize)
        ref = jvision.load_cifar10(split, normalize=normalize)
        for a, b in zip(ours, ref):
            _equal(a, b)
    assert ours[0].shape == ((20 if split == "train" else 4), 32, 32, 3)


def test_data_dirs_are_read_at_call_time(tmp_path, monkeypatch):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("HLV_MNIST_DIR", str(empty))
    monkeypatch.setenv("HLV_CIFAR_DIR", str(empty))
    for ours, ref in ((vision.load_mnist, jvision.load_mnist),
                      (vision.load_cifar10, jvision.load_cifar10)):
        with pytest.raises(FileNotFoundError) as got:
            ours("test")
        with pytest.raises(FileNotFoundError) as jgot:
            ref("test")
        assert str(got.value) == str(jgot.value)
    write_mnist(tmp_path, "test", 3, seed=0)
    monkeypatch.setenv("HLV_MNIST_DIR", str(tmp_path))
    assert vision.load_mnist("test")[0].shape == (3, 28, 28, 1)
    # an explicit directory wins over the variable
    assert vision.load_mnist("test", data_dir=str(tmp_path))[1].shape == (3,)


def test_data_package_exports_the_jax_names():
    for name in ("make_spirals", "random_image_batches", "random_token_batches",
                 "markov_token_batches", "load_mnist", "load_mnist_as_cifar", "load_cifar10",
                 "get_class_subset", "add_gaussian_noise", "augment_batch"):
        assert callable(getattr(data, name)), name
