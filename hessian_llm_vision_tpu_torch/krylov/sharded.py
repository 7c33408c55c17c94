"""A P-sharded Krylov basis: each rank holds a contiguous range of P.

Under ``basis_sharding`` (``parallel/mesh.py``) the n ranks of the data
axis split the parameter axis: P is padded to ``P_pad``, a multiple of n,
and rank r stores columns ``[r·P_pad/n, (r+1)·P_pad/n)`` of every basis
row and Lanczos vector.  The pad columns of the last rank are zero and
stay zero.  The curvature product still takes the whole vector, so:

* before each product the vector is put back together from the slices
  (:meth:`PShard.gather`: one broadcast per rank);
* the product's result (replicated on every rank, for a data-parallel
  loss after its all-reduce) goes back to slices by keeping this rank's
  range (:meth:`PShard.local`);
* every Vᵀ-type contraction is pass 1 of the rank-k pair on the slice
  (``ops/kernels.py::rank_k_dots``), one all-reduce of its k-vector ``w``,
  then pass 2 on the slice (``rank_k_axpy``) (:meth:`PShard.rank_k`);
* dot products and norms are local sums followed by an all-reduce; on the
  CPU the squares of a norm are summed in float64, as ``utils/norms.py``
  does.

Only ``all_reduce`` and ``broadcast`` are used: gloo runs just those two on
CUDA tensors, and two ranks sharing one card can only use gloo.
"""

from __future__ import annotations

from typing import Optional

import torch

from hessian_llm_vision_tpu_torch.ops import kernels
from hessian_llm_vision_tpu_torch.utils.norms import norm as _norm


class PShard:
    """This rank's range of a P-axis of length ``dim`` under ``sharding``
    (a ``parallel.mesh.Sharding`` whose last axis is split over 'data').

    ``size`` = P_pad / n columns are stored per rank; ``width`` of them
    (``size`` but on the last rank) lie inside P."""

    def __init__(self, sharding, dim: int):
        mesh = sharding.mesh
        n = sharding.parts(len(sharding.spec) - 1) if sharding.spec else 1
        if dim < n:
            raise ValueError(f"P={dim} is smaller than the {n} ranks that split it")
        self.mesh, self.n, self.dim = mesh, n, dim
        self.size = -(-dim // n)
        self.lo = mesh.index * self.size if n > 1 else 0
        self.width = min(self.size, dim - self.lo)

    def part(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's ``width`` columns of a whole (P,) vector (a view)."""
        return full[self.lo:self.lo + self.width]

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's ``size`` columns of a whole (P,) vector, zero-padded."""
        part = self.part(full)
        if self.width == self.size:
            return part
        out = full.new_zeros(self.size)
        out[:self.width] = part
        return out

    def trim(self, rows: torch.Tensor) -> torch.Tensor:
        """The columns of a (..., size) block that lie inside P."""
        return rows if self.width == self.size else rows[..., :self.width].contiguous()

    def gather(self, loc: torch.Tensor) -> torch.Tensor:
        """The whole (P,) vector from every rank's slice (``size`` or
        ``width`` long): rank r broadcasts its slice into its range."""
        if self.n == 1:
            return loc[:self.dim]
        buf = loc.new_empty(self.size * self.n)
        for r in range(self.n):
            view = buf[r * self.size:(r + 1) * self.size]
            if r == self.mesh.index:
                view[:loc.shape[0]].copy_(loc)
                view[loc.shape[0]:].zero_()
            self.mesh.broadcast_(view, r)
        return buf[:self.dim]

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks that split P, in place."""
        return self.mesh.all_reduce_(t) if self.n > 1 else t

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The whole vectors' dot product from two slices, 0-d."""
        return self.sum_(torch.dot(a, b).reshape(1))[0]

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        """The whole vector's 2-norm from its slice, 0-d in ``v``'s dtype."""
        if self.n == 1:
            return _norm(v)
        wide = torch.float64 if v.device.type == "cpu" else None
        sq = torch.linalg.vector_norm(v, dtype=wide).square().reshape(1)
        return self.sum_(sq).sqrt()[0].to(v.dtype)

    def rank_k(self, g: torch.Tensor, rows: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
        """``g + Vᵀ(c ⊙ (V g))`` of the whole vectors, on this rank's slice:
        pass 1 on the slice, the all-reduce of ``w``, pass 2 on the slice.
        ``rows`` is a contiguous (k, columns) block of the basis."""
        w = self.sum_(kernels.rank_k_dots(g, rows, coeffs))
        return kernels.rank_k_axpy(g, rows, w)

    def project_out(self, g: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """``g − Vᵀ(V g)`` on this rank's slice (c = −1)."""
        minus = -torch.ones(rows.shape[0], dtype=torch.float32, device=rows.device)
        return self.rank_k(g, rows, minus)


def p_shard(basis_sharding, dim: int) -> Optional[PShard]:
    """The :class:`PShard` of ``basis_sharding`` for a P of ``dim``; None
    when no sharding is given."""
    return None if basis_sharding is None else PShard(basis_sharding, dim)
