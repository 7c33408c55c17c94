"""The rank mesh and its sharding vocabulary (port of ``parallel/mesh.py``).

The JAX package lays its devices out as ``Mesh(('data', 'model'))`` and
lets XLA's partitioner insert the collectives.  Here a :class:`Mesh` is the
ranks of the default ``torch.distributed`` group on the same grid: rank r
sits at data index ``r // num_model`` and model index ``r % num_model``
(the JAX grid ``reshape(num_data, num_model)``).  Each rank runs its own
Python and calls the collectives itself: ``all_reduce_`` and ``broadcast_``
on its data group (the ranks of its model index), the differentiable
collectives of ``models/collectives.py`` on its model group (the ranks of
its data index), and ``all_reduce_mesh_`` on every rank.  What the model
axis splits -- a model's heads, MLP width and vocabulary (tensor
parallelism, ``parallel/param_sharding.py``), its tokens (sequence
parallelism, ``parallel/seq_parallel.py``) or its experts
(``models/moe.py``) -- is set in the model's config.

A :class:`Sharding` says which part of an axis a rank holds:

* ``data_sharding``: the leading (batch) axis, rows
  ``[d·B/n, (d+1)·B/n)`` for data index d (:func:`shard_batch` takes them);
* ``replicated_sharding``: everything;
* ``basis_sharding``: the P axis of a (k, P) Krylov basis, and
  ``flat_vector_sharding`` that of a (P,) vector: P is padded to a
  multiple of n, and rank r holds the contiguous range
  ``[r·P_pad/n, (r+1)·P_pad/n)`` (``krylov/sharded.py``).  Given the
  model-axis layout of a model-parallel model (``utils/flatten.py``), the
  basis splits over both axes instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``num_data`` x ``num_model`` ranks; this process is the one at
    ``index`` (data index ``index // num_model``, model index
    ``index % num_model``).  ``group`` holds every rank of the mesh,
    ``data_group`` the ranks of this model index and ``model_group`` those
    of this data index; their collectives run even for one rank.  None: no
    group, and every collective is a no-op.  ``axis_names`` name the two
    axes (``("data", "ep")`` for an expert-parallel mesh)."""

    num_data: int
    num_model: int = 1
    index: int = 0
    group: Optional[Any] = None
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (self.num_data, self.num_model)))

    @property
    def size(self) -> int:
        return self.num_data * self.num_model

    @property
    def data_index(self) -> int:
        return self.index // self.num_model

    @property
    def model_index(self) -> int:
        return self.index % self.num_model

    def rank_at(self, data_index: int, model_index: int) -> int:
        """The global rank at a grid position."""
        return data_index * self.num_model + model_index

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data axis, in place; returns ``t``."""
        if self.data_group is not None:
            dist.all_reduce(t, group=self.data_group)
        return t

    def all_reduce_model_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model axis, in place (no gradient: the model's
        own collectives are ``models/collectives.py``'s); returns ``t``."""
        if self.model_group is not None:
            dist.all_reduce(t, group=self.model_group)
        return t

    def all_reduce_mesh_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over every rank of the mesh, in place; returns ``t``."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src_index: int) -> torch.Tensor:
        """``t`` of the rank at data index ``src_index`` (of this model
        index) on every rank of the data axis, in place."""
        if self.data_group is not None:
            dist.broadcast(t, src=self.rank_at(src_index, self.model_index),
                           group=self.data_group)
        return t


def make_mesh(num_data: Optional[int] = None, num_model: int = 1, *,
              axis_names: tuple = ("data", "model")) -> Mesh:
    """Mesh('data', 'model') over the ranks of the default group, on the JAX
    grid ``reshape(num_data, num_model)``.

    ``num_data`` defaults to every rank over ``num_model`` (1 without a
    group).  A mesh of one rank on a larger group makes each rank a mesh
    of its own (its results computed alone, no collective); any other size
    must be the group's, and then the collectives run on it, even for a
    group of one rank.  Every rank must call this in the same order: the
    data and model groups are made with ``dist.new_group`` on all of them."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_data is None:
        num_data = max(world // num_model, 1)
    n = num_data * num_model
    if n > world:
        raise ValueError(f"requested {n} ranks, have {world}")
    if not dist.is_initialized() or (n == 1 and world > 1):
        return Mesh(1, axis_names=axis_names)  # no group, or each rank a mesh of its own
    if n != world:
        raise ValueError(f"a mesh of {num_data} x {num_model} ranks on a group of {world}: "
                         "use 1 or the whole group")
    world_group, rank = dist.group.WORLD, dist.get_rank()
    data_group = model_group = world_group
    if num_model > 1 and num_data > 1:
        for m in range(num_model):  # every rank makes every group, in this order
            g = dist.new_group([d * num_model + m for d in range(num_data)])
            if rank % num_model == m:
                data_group = g
        for d in range(num_data):
            g = dist.new_group([d * num_model + m for m in range(num_model)])
            if rank // num_model == d:
                model_group = g
    return Mesh(num_data, num_model, rank, world_group,
                data_group=data_group if num_data > 1 or num_model == 1 else None,
                model_group=model_group if num_model > 1 else None, axis_names=axis_names)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """Which part of each axis a rank holds: ``spec`` has one entry per
    leading axis, an axis name (split over that axis), a tuple of names
    (split over their product) or None (whole), like a ``PartitionSpec``.
    ``layout``: the model-axis layout of a basis split over both axes."""

    mesh: Mesh
    spec: tuple

    layout: Optional[Any] = None

    def parts(self, axis: int) -> int:
        """Ranks that split ``axis`` (1: every rank holds all of it)."""
        if axis >= len(self.spec) or self.spec[axis] is None:
            return 1
        names = self.spec[axis] if isinstance(self.spec[axis], tuple) else (self.spec[axis],)
        shape = self.mesh.shape
        return math.prod(shape[a] for a in names)


def data_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis batch sharding over the data axis."""
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def basis_sharding(mesh: Mesh, layout=None) -> Sharding:
    """(k, P) Krylov basis: the P axis split over 'data'.  Every contraction
    with the basis is then local partial sums plus one all-reduce of k
    floats.  With ``layout`` (``utils.flatten.ModelAxisLayout``, the flat
    layout of a model-parallel model's parameters) P splits over both axes,
    as the JAX package's ``P(None, ("data", "model"))``."""
    if layout is None:
        return Sharding(mesh, (None, "data"))
    return Sharding(mesh, (None, ("data", "model")), layout)


def flat_vector_sharding(mesh: Mesh) -> Sharding:
    """(P,) flat curvature vectors split over 'data'."""
    return Sharding(mesh, ("data",))


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (any pytree of tensors): rows
    ``[r·B/n, (r+1)·B/n)`` of every leaf with a leading axis; 0-d leaves
    stay whole.  Every rank passes the same global batch, so the sharded
    result compares with a single process on the whole batch."""
    n, r = mesh.num_data, mesh.data_index

    def rows(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0 or n == 1:
            return x
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} rows does not split over {n} ranks")
        return x[r * b // n:(r + 1) * b // n]

    return pytree.tree_map(rows, batch)
