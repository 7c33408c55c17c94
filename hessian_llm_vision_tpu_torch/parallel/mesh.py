"""The rank mesh and its sharding vocabulary (port of ``parallel/mesh.py``).

The JAX package lays its devices out as ``Mesh(('data', 'model'))`` and
lets XLA's partitioner insert the collectives.  Here a :class:`Mesh` is the
ranks of the default ``torch.distributed`` group on the same grid: rank r
sits at data index ``r // num_model`` and model index ``r % num_model``
(the JAX grid ``reshape(num_data, num_model)``).  Each rank runs its own
Python and calls the collectives itself: ``sum_(t, "data")`` on its data
group (the ranks of its model index), the differentiable collectives of
``models/collectives.py`` on its model group (the ranks of its data
index), and ``sum_(t, "mesh")`` on every rank.  Every collective
of the port goes through a :class:`Mesh` method (``sum_``, ``all_gather``,
``reduce_scatter``, ``send_recv``, ``broadcast_on``), and :func:`native`
picks, in this one place, how it runs from the group's backend and the
tensor's device: NCCL's own all-gather, reduce-scatter and paired
send/receive on NCCL, and on gloo with CPU tensors (the CPU tests); on gloo
with CUDA tensors (ranks that share one card: gloo stages them through
host memory and runs only ``all_reduce`` and ``broadcast`` on them) a
gather is one broadcast per rank into its block, a reduce-scatter an
all-reduce then this rank's block, and a send/receive one broadcast per
move.  Both give the same numbers (a gather moves values unchanged; at
two ranks a sum of two is the same either way).  :func:`collective_clock`
counts the calls, bytes and seconds of each kind inside a block.  What the model
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

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Optional, Sequence

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

    def axis(self, axis: str) -> tuple:
        """``(group, ranks, this rank's index)`` of ``axis``: "data" (the
        first), "model" (the second) or "mesh" (every rank)."""
        if axis == "model":
            return self.model_group, self.num_model, self.model_index
        if axis == "data":
            return self.data_group, self.num_data, self.data_index
        if axis == "mesh":
            return self.group, self.size, self.index
        raise ValueError(f"no axis {axis!r} (model, data or mesh)")

    def rank_on(self, axis: str, i: int) -> int:
        """The global rank at index ``i`` of ``axis`` (this rank's other
        index kept; the grid is ``data_index * num_model + model_index``)."""
        if axis == "model":
            return self.data_index * self.num_model + i
        if axis == "data":
            return i * self.num_model + self.model_index
        return i

    def collective_path(self, t: torch.Tensor, axis: str = "mesh") -> str:
        """"native" or "padded/broadcast": how the collectives of ``axis``
        run on tensors like ``t`` (:func:`native`); "none" without a group."""
        group = self.axis(axis)[0]
        if group is None:
            return "none"
        return "native" if native(group, t) else "padded/broadcast"

    def sum_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` (contiguous: NCCL takes nothing else) summed over ``axis``
        ("data", "model" or "mesh"), in place, without a gradient (the
        model's own collectives are ``models/collectives.py``'s); returns
        ``t``."""
        group = self.axis(axis)[0]
        _contiguous(t)
        if group is not None:
            _issue("all_reduce", t, lambda: dist.all_reduce(t, group=group))
        return t

    def broadcast_on(self, t: torch.Tensor, src: int, axis: str) -> torch.Tensor:
        """``t`` of index ``src`` of ``axis`` on every rank of it, in place
        (``t`` contiguous, of one shape on every rank); returns ``t``."""
        group, n, _ = self.axis(axis)
        _contiguous(t)
        if group is not None and n > 1:
            _issue("broadcast", t, lambda: dist.broadcast(t, src=self.rank_on(axis, src),
                                                          group=group))
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``t`` (of one shape) concatenated along dim 0 in index
        order, a new tensor: NCCL's all-gather, or (gloo on CUDA tensors)
        one broadcast per rank.  Without a group, the other ranks' blocks
        are zeros."""
        group, n, me = self.axis(axis)
        t = t.contiguous()
        out_shape = (n * t.shape[0],) + tuple(t.shape[1:])
        if n == 1:
            return t.clone()
        if group is not None and native(group, t):
            out = t.new_empty(out_shape)
            _issue("all_gather", out,
                   lambda: dist.all_gather_into_tensor(out, t, group=group))
            return out
        if group is None:
            out = t.new_zeros(out_shape)
            out.narrow(0, me * t.shape[0], t.shape[0]).copy_(t)
            return out
        out = t.new_empty(out_shape)
        for i in range(n):  # rank i broadcasts its block into its place
            block = out.narrow(0, i * t.shape[0], t.shape[0])
            if i == me:
                block.copy_(t)
            _issue("all_gather", block, lambda block=block, i=i: dist.broadcast(
                block, src=self.rank_on(axis, i), group=group))
        return out

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` (dim 0 a multiple of the axis's ranks) summed over ``axis``,
        then this rank's block of dim 0, a new tensor."""
        group, n, me = self.axis(axis)
        size = t.shape[0] // n
        whole = t.contiguous()
        if group is not None and n > 1 and native(group, whole):
            out = whole.new_empty((size,) + tuple(whole.shape[1:]))
            _issue("reduce_scatter", whole,
                   lambda: dist.reduce_scatter_tensor(out, whole, group=group))
            return out
        if whole is t:  # summed in place: never the caller's tensor
            whole = t.clone()
        if group is not None and n > 1:
            _issue("reduce_scatter", whole, lambda: dist.all_reduce(whole, group=group))
        return whole.narrow(0, me * size, size)

    def send_recv(self, moves: Sequence[tuple], send: Callable[[int], torch.Tensor],
                  like: torch.Tensor, axis: str = "model") -> dict:
        """Point-to-point moves on ``axis``: ``moves`` holds ``(src, dst,
        shape)`` index pairs, the same on every rank (``src != dst``); a
        source sends ``send(dst)`` (contiguous, of ``shape``).  Returns
        ``{src: tensor}`` of what this rank received (``like``'s dtype and
        device).  Natively one batch of paired sends and receives (only
        the ranks of a move take part); else one broadcast per move, in
        order, over the axis."""
        group, n, me = self.axis(axis)
        got = {}
        if group is None or n == 1 or not moves:
            return got
        if native(group, like):
            ops, probe = [], None
            for src, dst, shape in moves:
                if src == me:
                    probe = send(dst)
                    ops.append(dist.P2POp(dist.isend, probe, self.rank_on(axis, dst), group))
                elif dst == me:
                    got[src] = probe = like.new_empty(shape)
                    ops.append(dist.P2POp(dist.irecv, got[src], self.rank_on(axis, src), group))
            if ops:
                _issue("send_recv", probe, lambda: [w.wait() for w in
                                                    dist.batch_isend_irecv(ops)],
                       nbytes=sum(op.tensor.numel() * op.tensor.element_size() for op in ops))
            return got
        for src, dst, shape in moves:
            buf = send(dst) if src == me else like.new_empty(shape)
            _issue("send_recv", buf, lambda buf=buf, src=src: dist.broadcast(
                buf, src=self.rank_on(axis, src), group=group))
            if dst == me:
                got[src] = buf
        return got


def _contiguous(t: torch.Tensor) -> None:
    """In-place collectives take contiguous tensors only (NCCL refuses others;
    gloo on the CPU would take them, so the CPU tests check here)."""
    if not t.is_contiguous():
        raise ValueError(f"a collective in place on a tensor that is not contiguous "
                         f"(shape {tuple(t.shape)}, strides {t.stride()})")


def native(group, t: torch.Tensor) -> bool:
    """Whether the collectives of ``group`` run NCCL's or gloo's own
    all-gather, reduce-scatter and send/receive on ``t``: on NCCL, and on
    gloo with a CPU tensor; not on gloo with a CUDA tensor, which gloo
    stages through host memory and only all-reduces or broadcasts.  The one
    place that chooses; no flag or variable does."""
    return not t.is_cuda or dist.get_backend(group) == "nccl"


#: the running :func:`collective_clock`'s counts, or None
_CLOCK: Optional[dict] = None
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "send_recv", "broadcast")


def _issue(kind: str, t: Optional[torch.Tensor], run: Callable[[], Any],
           nbytes: Optional[int] = None) -> None:
    """Run one collective, outside ``torch.func``'s transforms (its tensors
    are plain: a Function's forward or jvp issues it, and gloo's own copies
    into its output would read as mutations of a captured tensor); under
    :func:`collective_clock` synchronised before and after, and counted
    under ``kind`` with ``nbytes``, by default ``t``'s (the buffer that
    crosses the axis)."""
    if _CLOCK is None:
        with torch._C._DisableFuncTorch():
            run()
        return
    cuda = t is not None and t.is_cuda
    if cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    with torch._C._DisableFuncTorch():
        run()
    if cuda:
        torch.cuda.synchronize(t.device)
    s = time.perf_counter() - t0
    if nbytes is None:
        nbytes = 0 if t is None else t.numel() * t.element_size()
    for c in (_CLOCK, _CLOCK["by"][kind]):
        c["s"] += s
        c["calls"] += 1
        c["bytes"] += nbytes


@contextlib.contextmanager
def collective_clock():
    """Counts of every collective issued inside the block, each synchronised
    (which serialises them with the compute): ``{"s", "calls", "bytes",
    "by": {kind: {"s", "calls", "bytes"}}}`` over :data:`KINDS` (the
    logical kind: a padded gather counts as "all_gather" with its padded
    bytes).  Off (no synchronisation, no cost) outside one."""
    global _CLOCK
    outer = _CLOCK
    _CLOCK = {"s": 0.0, "calls": 0, "bytes": 0,
              "by": {k: {"s": 0.0, "calls": 0, "bytes": 0} for k in KINDS}}
    try:
        yield _CLOCK
    finally:
        _CLOCK = outer


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
    mesh = Mesh(num_data, num_model, rank, world_group,
                data_group=data_group if num_data > 1 or num_model == 1 else None,
                model_group=model_group if num_model > 1 else None, axis_names=axis_names)
    if dist.get_backend() == "nccl":  # each communicator up before its first send/receive
        one = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
        for axis in ("mesh", "data", "model"):
            mesh.sum_(one, axis)
    return mesh


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
