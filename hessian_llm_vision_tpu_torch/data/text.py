"""Text / LM data (port of ``data/text.py``): numpy code that gives the
JAX package's arrays for the same inputs.

Batches are stacked host arrays with a leading ``num_batches`` axis; the
CLI splits them into a list of per-batch tensor dicts on the device.
The HF-dataset pipeline (``load_lm_dataset``) is not ported yet: it needs
the ``datasets`` package, the dataset files and a GPT-2 tokenizer.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable

import numpy as np


def stack_batches(
    arrays: Dict[str, np.ndarray], batch_size: int, drop_remainder: bool = True
) -> Dict[str, np.ndarray]:
    """(N, ...) arrays -> (num_batches, batch_size, ...) stacked batches."""
    out = {}
    for k, v in arrays.items():
        n = (len(v) // batch_size) * batch_size
        if n == 0:
            raise ValueError(f"not enough rows ({len(v)}) for one batch of {batch_size}")
        out[k] = v[:n].reshape(-1, batch_size, *v.shape[1:])
    return out


def collate_tokens(
    token_lists: Iterable[Iterable[int]],
    max_length: int,
    pad_id: int,
    *,
    truncate: bool = True,
) -> Dict[str, np.ndarray]:
    """Pad/truncate ragged token lists to (N, max_length) ``input_ids`` +
    ``attention_mask``."""
    rows, masks = [], []
    for toks in token_lists:
        toks = list(toks)[: max_length if truncate else None]
        if len(toks) > max_length:
            raise ValueError(f"sequence length {len(toks)} > max_length {max_length}")
        pad = max_length - len(toks)
        rows.append(toks + [pad_id] * pad)
        masks.append([1] * len(toks) + [0] * pad)
    return {
        "input_ids": np.asarray(rows, np.int32),
        "attention_mask": np.asarray(masks, np.int32),
    }


def load_lm_dataset(*args, **kwargs):
    raise NotImplementedError(
        "load_lm_dataset (HF datasets + GPT-2 tokenizer) is not ported yet "
        "(ROADMAP A15); use --dataset local:<path>"
    )


_TEXT_EXTENSIONS = (
    ".txt", ".md", ".rst", ".py", ".tex", ".cfg", ".toml", ".yaml", ".json",
)


def load_local_corpus(
    path: str,
    *,
    max_length: int,
    batch_size: int,
    subsample: float | int = 1.0,
    seed: int = 42,
    extensions: tuple = _TEXT_EXTENSIONS,
    max_bytes: int = 64 * 1024 * 1024,
) -> Dict[str, np.ndarray]:
    """Deterministic byte-level LM corpus from text already on disk.

    Files under ``path`` (a file or a directory, filtered by
    ``extensions``) are read in sorted order, joined with double newlines,
    encoded as raw bytes (vocab 256), chunked into non-overlapping
    ``max_length`` sequences, seed-shuffled, subsampled (fraction <= 1.0 or
    absolute count), and stacked into ``(num_batches, batch_size,
    max_length)`` batches with all-ones attention masks.
    """
    if os.path.isfile(path):
        files = [path]
    elif os.path.isdir(path):
        files = []
        for root, dirs, names in os.walk(path):
            dirs.sort()
            for n in sorted(names):
                if n.endswith(extensions):
                    files.append(os.path.join(root, n))
    else:
        raise FileNotFoundError(f"local corpus path {path!r} does not exist")
    if not files:
        raise FileNotFoundError(f"no text files ({'/'.join(extensions)}) under {path!r}")

    pieces, total = [], 0
    for f in files:
        try:
            with open(f, "rb") as fh:
                data = fh.read(max_bytes - total)
        except OSError:
            continue
        pieces.append(data)
        total += len(data) + 2
        if total >= max_bytes:
            break
    ids = np.frombuffer(b"\n\n".join(pieces), dtype=np.uint8)
    n_chunks = len(ids) // max_length
    if n_chunks < batch_size:
        raise ValueError(
            f"corpus too small: {len(ids)} bytes -> {n_chunks} chunks of "
            f"{max_length} < batch_size {batch_size}"
        )
    chunks = ids[: n_chunks * max_length].reshape(n_chunks, max_length)
    chunks = chunks[np.random.RandomState(seed).permutation(n_chunks)]
    take = (
        int(n_chunks * subsample)
        if isinstance(subsample, float) and subsample <= 1.0
        else int(subsample)
    )
    take = max(batch_size, min(take, n_chunks))
    chunks = chunks[:take].astype(np.int32)
    return stack_batches(
        {"input_ids": chunks, "attention_mask": np.ones_like(chunks)}, batch_size
    )
