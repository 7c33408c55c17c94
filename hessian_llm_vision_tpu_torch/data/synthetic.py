"""Synthetic data (port of ``data/synthetic.py``).

Seeded numpy generators returning host arrays, identical to the JAX
package's for the same arguments: the k-spirals classification set, the
Hessian-of-noise random-token set, random-input / random-label image
batches and a learnable first-order Markov chain of tokens.
"""

from __future__ import annotations

import numpy as np


def make_spirals(
    num_points: int = 600,
    num_classes: int = 3,
    noise: float = 0.2,
    seed: int = 0,
    turns: float = 1.5,
):
    """k interleaved spirals; returns (x (N, 2) f32, y (N,) i32)."""
    rng = np.random.RandomState(seed)
    n = num_points // num_classes
    xs, ys = [], []
    for c in range(num_classes):
        r = np.linspace(0.1, 1.0, n)
        theta = (np.linspace(0, turns * 2 * np.pi, n) + c * (2 * np.pi / num_classes)
                 + rng.randn(n) * noise)
        xs.append(np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1))
        ys.append(np.full(n, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def random_token_batches(
    num_batches: int,
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    random_mask: bool = False,
):
    """Random token-id LM batches.

    Returns a dict of stacked arrays: ``input_ids`` (num_batches, B, T) i32
    and ``attention_mask`` (same shape), all ones unless ``random_mask``
    (random masks with at least the first token visible).
    """
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab_size, size=(num_batches, batch_size, seq_len)).astype(np.int32)
    if random_mask:
        mask = (rng.rand(num_batches, batch_size, seq_len) > 0.5).astype(np.int32)
        mask[..., 0] = 1
    else:
        mask = np.ones_like(ids)
    return {"input_ids": ids, "attention_mask": mask}


def random_image_batches(
    num_batches: int,
    batch_size: int,
    shape=(32, 32, 3),
    num_classes: int = 10,
    seed: int = 0,
):
    """Random-input / random-label image batches: (x (num_batches, B,
    *shape) f32 NHWC, y (num_batches, B) i32)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(num_batches, batch_size, *shape).astype(np.float32)
    y = rng.randint(0, num_classes, size=(num_batches, batch_size)).astype(np.int32)
    return x, y


def markov_token_batches(
    num_batches: int,
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    concentration: float = 0.1,
):
    """Learnable synthetic LM data: tokens from a fixed sparse first-order
    Markov chain (Dirichlet transition rows).  Same stacked dict as
    :func:`random_token_batches`."""
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.full(vocab_size, concentration), size=vocab_size)
    ids = np.empty((num_batches * batch_size, seq_len), np.int32)
    state = rng.randint(0, vocab_size, size=num_batches * batch_size)
    for t in range(seq_len):
        ids[:, t] = state
        u = rng.rand(len(state), 1)
        state = (T[state].cumsum(axis=1) > u).argmax(axis=1)
    ids = ids.reshape(num_batches, batch_size, seq_len)
    return {"input_ids": ids, "attention_mask": np.ones_like(ids)}
