"""Named-parameter dict <-> flat-vector bridge.

All Krylov linear algebra works on one contiguous f32 ``(P,)`` vector;
models and curvature engines work on ``{dotted_name: tensor}`` dicts.
:class:`Flattener` is the only place the two meet.

The flat order is the JAX package's: flax flattens a params tree by
recursively sorted keys, which is the order of the dotted names sorted by
``tuple(name.split("."))`` -- ``h_10`` precedes ``h_2`` and a GPT-2 vector
ends ``ln_f.bias, ln_f.scale, wpe, wte``.  Flat vectors of the two packages
therefore compare element by element, with no name map.
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
