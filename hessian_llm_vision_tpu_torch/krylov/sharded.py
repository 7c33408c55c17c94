"""A P-sharded Krylov basis: each rank holds a contiguous range of P.

Under ``basis_sharding`` (``parallel/mesh.py``) the n ranks of the data
axis split the parameter axis: P is padded to ``P_pad``, a multiple of n,
and rank r stores columns ``[r·P_pad/n, (r+1)·P_pad/n)`` of every basis
row and Lanczos vector.  The pad columns of the last rank are zero and
stay zero.  The curvature product still takes the whole vector, so:

* before each product the vector is put back together from the slices
  (:meth:`PShard.gather`: one all-gather of equal, padded blocks);
* the product's result (replicated on every rank, for a data-parallel
  loss after its all-reduce) goes back to slices by keeping this rank's
  range (:meth:`PShard.local`);
* every Vᵀ-type contraction is pass 1 of the rank-k pair on the slice
  (``ops/kernels.py::rank_k_dots``), one all-reduce of its k-vector ``w``,
  then pass 2 on the slice (``rank_k_axpy``) (:meth:`PShard.rank_k`);
* dot products and norms are local sums followed by an all-reduce; on the
  CPU the squares of a norm are summed in float64, as ``utils/norms.py``
  does.

On the model axis (:class:`ModelShard`, a ``basis_sharding`` given the
model-parallel layout of ``utils/flatten.py::ModelAxisLayout``) a rank's
curvature product takes and gives its *rank vector* (its slices of the
split leaves, the replicated leaves whole), and its Krylov vectors hold its
*owned* part (those slices and its share of the replicated leaves, so
that every parameter is counted once, padded to a multiple of 8 entries),
split further over the data axis.  Before each product the replicated part
is put back together over the model axis (one all-gather of equal,
padded shares); the product's replicated part comes out equal on every model
rank, and each keeps its share.  Dot products, norms and the rank-k pair's
``w`` sum over the whole mesh.

The collectives are the mesh's (``parallel/mesh.py``): NCCL's (or gloo's,
on CPU tensors) all-gather and all-reduce; on gloo with CUDA tensors (two
ranks sharing one card) the all-gather is one broadcast per rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from hessian_llm_vision_tpu_torch.ops import kernels
from hessian_llm_vision_tpu_torch.utils.norms import norm as _norm


def normalize(v: torch.Tensor) -> torch.Tensor:
    """``v`` over its 2-norm (``utils/norms.py``), floored at 1e-30."""
    return v / torch.clamp(_norm(v), min=1e-30)


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
        self.lo = mesh.data_index * self.size if n > 1 else 0
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
        ``width`` long): one all-gather of the ranks' ``size`` blocks."""
        if self.n == 1:
            return loc[:self.dim]
        if loc.shape[0] < self.size:
            loc = torch.cat([loc, loc.new_zeros(self.size - loc.shape[0])])
        return self.mesh.all_gather(loc, "data")[:self.dim]

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks that split P, in place."""
        return self.mesh.sum_(t, "data") if self.n > 1 else t

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

    def start(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the start vector ``full`` (the same on every
        rank), normalised."""
        return self.local(normalize(full))


class ModelShard(PShard):
    """This rank's part of a model-parallel rank vector (``dim`` entries)
    under a ``basis_sharding`` that carries its ``ModelAxisLayout``: the
    owned vector (``layout.length``) split over the data axis into
    ``size`` columns, a multiple of 8, the pad stored as zeros (``width ==
    size``)."""

    def __init__(self, sharding, dim: int):
        layout, mesh = sharding.layout, sharding.mesh
        if dim != layout.size:
            raise ValueError(f"a rank vector of {dim} entries under a layout of {layout.size}")
        self.mesh, self.layout, self.dim = mesh, layout, dim
        self.n = mesh.size
        self.size = layout.length if mesh.num_data == 1 else (
            -(-layout.length // (8 * mesh.num_data)) * 8)
        self.lo = mesh.data_index * self.size
        self.width = self.size

    def local(self, full: torch.Tensor) -> torch.Tensor:
        owned = self.layout.owned(full)
        if self.mesh.num_data == 1:
            return owned
        part = owned[self.lo:self.lo + self.size]
        if part.shape[0] == self.size:
            return part.clone()
        out = owned.new_zeros(self.size)
        out[:part.shape[0]] = part
        return out

    part = local

    def trim(self, rows: torch.Tensor) -> torch.Tensor:
        return rows

    def gather(self, loc: torch.Tensor) -> torch.Tensor:
        """The rank vector from every rank's part: the owned vector over the
        data axis, then the replicated leaves over the model axis, each one
        all-gather of equal blocks (the shares zero-padded to ``share``)."""
        lay, mesh = self.layout, self.mesh
        owned = mesh.all_gather(loc, "data") if mesh.num_data > 1 else loc
        share = owned[lay.split_size:lay.split_size + lay.share]
        if mesh.num_model > 1:
            share = mesh.all_gather(share, "model")
        return lay.rank_vector(owned, share[:lay.replicated_size])

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.sum_(t, "mesh")

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        wide = torch.float64 if v.device.type == "cpu" else None
        sq = torch.linalg.vector_norm(v, dtype=wide).square().reshape(1)
        return self.sum_(sq).sqrt()[0].to(v.dtype)

    def start(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the rank vector ``full``, normalised over the
        whole mesh (each rank's rank vector has a norm of its own)."""
        loc = self.local(full)
        return loc / self.norm(loc)


def p_shard(basis_sharding, dim: int) -> Optional[PShard]:
    """The :class:`PShard` (or :class:`ModelShard`, given a model-axis
    layout) of ``basis_sharding`` for a P of ``dim``; None when no sharding
    is given."""
    if basis_sharding is None:
        return None
    if getattr(basis_sharding, "layout", None) is not None:
        return ModelShard(basis_sharding, dim)
    return PShard(basis_sharding, dim)
