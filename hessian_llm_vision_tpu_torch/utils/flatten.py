"""Named-parameter dict <-> flat-vector bridge.

All Krylov linear algebra works on one contiguous f32 ``(P,)`` vector;
models and curvature engines work on ``{dotted_name: tensor}`` dicts.
:class:`Flattener` is the only place the two meet.

The flat order is the JAX package's: flax flattens a params tree by
recursively sorted keys, which is the order of the dotted names sorted by
``tuple(name.split("."))`` -- ``h_10`` precedes ``h_2`` and a GPT-2 vector
ends ``ln_f.bias, ln_f.scale, wpe, wte``.  Flat vectors of the two packages
therefore compare element by element, with no name map.

On the model axis of a mesh a rank holds its slices of the split leaves
and the whole replicated ones; :class:`ModelAxisLayout` is the flat layout
of its Krylov vectors there, in which every parameter is counted once.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping

import torch


def flat_order(names: Iterable[str]) -> list[str]:
    """Dotted parameter names in the JAX ``Flattener``'s order."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def tree_size(params: Mapping[str, torch.Tensor]) -> int:
    """Total number of scalar entries (the Hessian dimension P)."""
    return sum(t.numel() for t in params.values())


class Flattener:
    """Bidirectional map between a ``{name: tensor}`` dict and a flat vector.

    Built once from a template (only names, shapes and dtypes are read).
    The flat vector is f32 (Lanczos recurrences need f32).  ``unflatten``
    returns views into it for f32 parameters, so it allocates nothing there.
    """

    def __init__(self, template: Mapping[str, torch.Tensor]):
        self.names = flat_order(template)
        self._shapes = [tuple(template[n].shape) for n in self.names]
        self._dtypes = [template[n].dtype for n in self.names]
        self._sizes = [math.prod(s) for s in self._shapes]
        self._offsets = [0]
        for s in self._sizes:
            self._offsets.append(self._offsets[-1] + s)
        self.size = self._offsets[-1]

    def flatten(self, params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Dict -> flat ``(P,)`` f32 vector."""
        return torch.cat([params[n].reshape(-1).float() for n in self.names])

    def unflatten(self, vec: torch.Tensor) -> dict[str, torch.Tensor]:
        """Flat ``(P,)`` vector -> dict with the template's shapes/dtypes."""
        return {
            n: vec[off : off + size].view(shape).to(dtype)
            for n, off, size, shape, dtype in zip(
                self.names, self._offsets, self._sizes, self._shapes, self._dtypes
            )
        }

    def __repr__(self) -> str:  # pragma: no cover
        return f"Flattener(P={self.size}, leaves={len(self._sizes)})"


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


class ModelAxisLayout:
    """The flat layout of a model-parallel rank's Krylov vectors.

    ``template`` holds this rank's leaves (its slices of the split ones,
    the replicated ones whole); ``splits`` names the split leaves (``{name:
    Split or None}``, ``parallel/param_sharding.py``).  The rank's *rank
    vector* is ``Flattener(template)``'s (what its curvature products take
    and give); its *owned* vector holds, in flax order, its slices of the
    split leaves, then its contiguous share ``[m·s, (m+1)·s)`` of the
    replicated leaves' concatenation R (s = ceil(|R| / n)), zero-padded to
    ``length``, a multiple of 8 entries (16-byte rows for the rank-k
    kernels at f32 and bf16).  The owned vectors of the n model ranks hold
    every parameter once.  Pure bookkeeping: the collectives that put the
    pieces together are ``krylov/sharded.py::ModelShard``'s."""

    def __init__(self, template: Mapping[str, torch.Tensor], splits: Mapping[str, object],
                 num_model: int, model_index: int):
        self.fl = Flattener(template)
        self.splits = dict(splits)
        self.num_model, self.model_index = num_model, model_index
        segs = list(zip(self.fl.names, self.fl._offsets, self.fl._sizes))
        self.split_segments = [(off, size) for n, off, size in segs if self.splits.get(n)]
        self.replicated_segments = [(off, size) for n, off, size in segs
                                    if not self.splits.get(n)]
        self.split_size = sum(size for _, size in self.split_segments)
        self.replicated_size = sum(size for _, size in self.replicated_segments)
        self.share = -(-self.replicated_size // num_model)
        self.share_lo = model_index * self.share
        self.share_width = max(0, min(self.share, self.replicated_size - self.share_lo))
        self.length = _round_up(self.split_size + self.share, 8)
        # this rank's share of R as (rank-vector offset, size) pieces
        self.share_pieces, r_off = [], 0
        lo, hi = self.share_lo, self.share_lo + self.share_width
        for off, size in self.replicated_segments:
            a, b = max(lo, r_off), min(hi, r_off + size)
            if a < b:
                self.share_pieces.append((off + a - r_off, b - a))
            r_off += size

    @property
    def size(self) -> int:
        """Entries of the rank vector."""
        return self.fl.size

    def owned(self, rank_vec: torch.Tensor) -> torch.Tensor:
        """The owned vector (``length``) of a rank vector."""
        pieces = [rank_vec[off:off + size] for off, size in self.split_segments + self.share_pieces]
        pad = self.length - self.split_size - self.share_width
        pieces.append(rank_vec.new_zeros(pad))
        return torch.cat(pieces)

    def replicated_share(self, owned: torch.Tensor) -> torch.Tensor:
        """This rank's share of R in an owned vector."""
        return owned[self.split_size:self.split_size + self.share_width]

    def rank_vector(self, owned: torch.Tensor, replicated: torch.Tensor) -> torch.Tensor:
        """The rank vector from an owned vector and the whole R."""
        out = owned.new_empty(self.fl.size)
        pos = 0
        for off, size in self.split_segments:
            out[off:off + size] = owned[pos:pos + size]
            pos += size
        pos = 0
        for off, size in self.replicated_segments:
            out[off:off + size] = replicated[pos:pos + size]
            pos += size
        return out
