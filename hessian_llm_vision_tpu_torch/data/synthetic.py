"""Synthetic LM token batches (port of ``data/synthetic.py``).

Seeded numpy generators returning host arrays, identical to the JAX
package's for the same arguments: the Hessian-of-noise random-token set
and a learnable first-order Markov chain.
"""

from __future__ import annotations

import numpy as np


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
