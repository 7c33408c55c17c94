"""The rank mesh and its sharding vocabulary (port of ``parallel/mesh.py``).

The JAX package lays its devices out as ``Mesh(('data', 'model'))`` and
lets XLA's partitioner insert the collectives.  Here a :class:`Mesh` is the
ranks of the default ``torch.distributed`` group on the ``data`` axis and
the two collectives the port needs (``all_reduce_``, ``broadcast_``); each
rank runs its own Python and calls them itself.  The ``model`` axis
(tensor, sequence, pipeline and expert parallelism) is ROADMAP A13b.

A :class:`Sharding` says which part of an axis a rank holds:

* ``data_sharding``: the leading (batch) axis, rows
  ``[r·B/n, (r+1)·B/n)`` (:func:`shard_batch` takes them);
* ``replicated_sharding``: everything;
* ``basis_sharding``: the P axis of a (k, P) Krylov basis, and
  ``flat_vector_sharding`` that of a (P,) vector: P is padded to a
  multiple of n, and rank r holds the contiguous range
  ``[r·P_pad/n, (r+1)·P_pad/n)`` (``krylov/sharded.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``num_data`` ranks on the data axis; this process is the one at
    ``index``.  ``group`` is the process group, whose collectives run even
    for one rank; None: no group, and every collective is a no-op."""

    num_data: int
    num_model: int = 1
    index: int = 0
    group: Optional[Any] = None

    @property
    def shape(self) -> dict:
        return {"data": self.num_data, "model": self.num_model}

    @property
    def size(self) -> int:
        return self.num_data * self.num_model

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data axis, in place; returns ``t``."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src_index: int) -> torch.Tensor:
        """``t`` of the rank at ``src_index`` on every rank, in place."""
        if self.group is not None:
            dist.broadcast(t, src=src_index, group=self.group)
        return t


def make_mesh(num_data: Optional[int] = None, num_model: int = 1) -> Mesh:
    """Mesh('data', 'model') over the ranks of the default group.

    ``num_data`` defaults to every rank (1 without a group).  A data axis
    of 1 on a larger group makes each rank a mesh of its own (its results
    computed alone, no collective); any other size must be the group's,
    and then the collectives run on it, even for a group of one rank."""
    if num_model != 1:
        raise NotImplementedError(
            f"num_model={num_model}: the model axis (tensor, sequence, pipeline and "
            "expert parallelism) is not ported yet (ROADMAP A13b)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_data is None:
        num_data = world
    if num_data > world:
        raise ValueError(f"requested {num_data} ranks, have {world}")
    if not dist.is_initialized() or (num_data == 1 and world > 1):
        return Mesh(1)  # no group, or each rank of one a mesh of its own
    if num_data != world:
        raise ValueError(f"a data axis of {num_data} ranks on a group of {world}: "
                         "use 1 or the whole group")
    return Mesh(num_data, 1, dist.get_rank(), dist.group.WORLD)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """Which part of each axis a rank holds: ``spec`` has one entry per
    leading axis, ``"data"`` (split over the data axis) or None (whole),
    like a ``PartitionSpec``."""

    mesh: Mesh
    spec: tuple

    def parts(self, axis: int) -> int:
        """Ranks that split ``axis`` (1: every rank holds all of it)."""
        if axis < len(self.spec) and self.spec[axis] == "data":
            return self.mesh.num_data
        return 1


def data_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis batch sharding over the data axis."""
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def basis_sharding(mesh: Mesh) -> Sharding:
    """(k, P) Krylov basis: the P axis split over 'data'.  Every contraction
    with the basis is then local partial sums plus one all-reduce of k
    floats."""
    return Sharding(mesh, (None, "data"))


def flat_vector_sharding(mesh: Mesh) -> Sharding:
    """(P,) flat curvature vectors split over 'data'."""
    return Sharding(mesh, ("data",))


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (any pytree of tensors): rows
    ``[r·B/n, (r+1)·B/n)`` of every leaf with a leading axis; 0-d leaves
    stay whole.  Every rank passes the same global batch, so the sharded
    result compares with a single process on the whole batch."""
    n, r = mesh.num_data, mesh.index

    def rows(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0 or n == 1:
            return x
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} rows does not split over {n} ranks")
        return x[r * b // n:(r + 1) * b // n]

    return pytree.tree_map(rows, batch)
