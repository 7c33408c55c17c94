"""Collectives on a mesh's axes that ``torch.func`` can differentiate.

The JAX package shards a model with annotations and lets XLA's partitioner
put the collectives into the program, where ``jvp(grad(loss))`` sees them
as ordinary primitives.  PyTorch has no partitioner, so a tensor-, sequence-
or expert-parallel model, and the GPipe pipeline, carry their collectives
in their own forward, and the curvature transforms must differentiate
through them twice.  Each collective here is a ``torch.autograd.Function``
in the functorch style (``forward`` without ``ctx``, ``setup_context``,
``backward`` and a ``jvp`` staticmethod), so ``torch.func.grad``,
``torch.func.jvp`` and their composition all see it.  On the model axis:

* :func:`copy_to_model` (Megatron's *f*): identity forward and jvp, sum
  over the axis backward.  It sits where a replicated tensor enters work
  that each rank does only part of.
* :func:`reduce_from_model` (Megatron's *g*): sum over the axis forward and
  jvp, identity backward.  It sits where each rank's partial result
  becomes the replicated whole.
* :func:`gather_from_model`: the ranks' slices concatenated along a
  dimension; backward the reduce-scatter (a sum, then this rank's slice),
  for a gathered tensor that each rank consumes only in part (the keys and
  values of sequence-parallel attention, a T-slice entering a column-
  parallel layer), and :func:`reduce_scatter_to_model`, its transpose (the
  partial sums of a row-parallel layer back to this rank's T-slice).

For the pipeline (``parallel/pipeline.py``), whose model axis is its
stage axis: :func:`copy_params` (parameters entering the loss, each
gradient summed over the axes it names, all in one backward),
:func:`reduce_from_axis` (a rank's share of the loss summed over an axis),
:func:`shift_stages` (the residual stream to the next stage) and
:func:`scatter_from_last_stage` (the last stage's outputs to their ranks).

Under ``jvp(grad(f))`` a ``backward`` is itself differentiated by the outer
``jvp``, and a c10d call cannot take a functorch-wrapped tensor; so every
``backward`` calls the conjugate Function's ``apply``, and only a
``forward`` or a ``jvp`` (which see plain tensors) calls c10d.  A forward
sums a copy, never its input in place.  The c10d calls are the mesh's
(``parallel/mesh.py``): a gather is NCCL's or gloo's all-gather, its
transpose a reduce-scatter, and the pipeline's shifts and exit paired
sends and receives, except on gloo with CUDA tensors (ranks sharing a
card), where ``parallel.mesh.native`` makes them broadcasts (a gather
one per rank) and all-reduces (a reduce-scatter).  Every rank must issue
the same collectives in the same order, or the group hangs.  The
pipeline's ranks run different graphs, so its Functions take a ``link``: a tensor derived
from the parameters on every rank, saved and handed to the conjugate in
``backward``.  A Function's ``jvp`` runs only where one of its inputs
carries a tangent, and a cotangent can be a fresh zero on one rank and
not on another; the link carries a tangent on every rank, so every rank
runs every ``jvp``.
"""

from __future__ import annotations

import torch


def _sum_over(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    _, n, _ = mesh.axis(axis)
    if n > 1:
        mesh.sum_(out, axis)
    return out


def _gather_over_model(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The model ranks' ``t`` concatenated along ``dim``: one all-gather
    along dim 0 of ``t`` with ``dim`` moved first."""
    if mesh.num_model == 1:
        return t
    out = mesh.all_gather(t.movedim(dim, 0), "model")
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """``x`` summed over the model axis, this rank's block of ``dim``: one
    reduce-scatter along dim 0 of ``x`` with ``dim`` moved first."""
    if mesh.num_model == 1:
        return x.clone()
    out = mesh.reduce_scatter(x.movedim(dim, 0), "model")
    return out.movedim(0, dim).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFrom.apply(grad, ctx.mesh, ctx.axis), None, None

    @staticmethod
    def jvp(ctx, x_t, _mesh_t, _axis_t):
        return x_t.view_as(x_t)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axis):
        return _sum_over(x, mesh, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _CopyTo.apply(grad, ctx.mesh, ctx.axis), None, None

    @staticmethod
    def jvp(ctx, x_t, _mesh_t, _axis_t):
        return _sum_over(x_t, ctx.mesh, ctx.axis)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, dim):
        return _gather_over_model(x, mesh, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.dim = inputs

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatterModel.apply(grad, ctx.mesh, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, x_t, _mesh_t, _dim_t):
        return _gather_over_model(x_t, ctx.mesh, ctx.dim)


class _ReduceScatterModel(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, dim):
        return _reduce_scatter(x, mesh, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.dim = inputs

    @staticmethod
    def backward(ctx, grad):
        return _GatherFromModel.apply(grad, ctx.mesh, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, x_t, _mesh_t, _dim_t):
        return _reduce_scatter(x_t, ctx.mesh, ctx.dim)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the model axis."""
    return _CopyTo.apply(x, mesh, "model")


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the model axis; its gradient passed through."""
    return _ReduceFrom.apply(x, mesh, "model")


def reduce_from_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` summed over ``mesh``'s ``axis`` ("model", "data" or "mesh");
    its gradient passed through."""
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim`` in rank order (all
    of equal shape); the gradient reduce-scattered back."""
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


def reduce_scatter_to_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """``x`` summed over the model axis, then this rank's slice of ``dim``
    (``dim`` divides by the axis); the gradient gathered back."""
    return _ReduceScatterModel.apply(x, mesh, dim % x.dim())


# ------------------------------------------------------------ the pipeline

def _sum_params(mesh, axes: tuple, ts) -> tuple:
    """Each tensor of ``ts`` summed over its axis of ``axes`` (None: kept),
    one all-reduce of their concatenation per axis, in a fixed order."""
    out = list(ts)
    for axis in ("data", "model", "mesh"):
        idx = [i for i, a in enumerate(axes) if a == axis]
        if not idx:
            continue
        flat = _sum_over(torch.cat([ts[i].reshape(-1) for i in idx]), mesh, axis)
        off = 0
        for i in idx:
            n = ts[i].numel()
            out[i] = flat[off:off + n].view_as(ts[i])
            off += n
    return tuple(out)


def _like(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def _tangent(t_t, like: tuple) -> torch.Tensor:
    """A tangent, or zeros where an input carries none."""
    if t_t is not None:
        return t_t
    shape, dtype, device = like
    return torch.zeros(shape, dtype=dtype, device=device)


class _CopyParams(torch.autograd.Function):
    @staticmethod
    def forward(mesh, axes, *ts):
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axes = inputs[0], inputs[1]
        ctx.save_for_backward(inputs[2])

    @staticmethod
    def backward(ctx, *grads):
        (link,) = ctx.saved_tensors
        return (None, None) + _SumParams.apply(ctx.mesh, ctx.axes, link, *grads)

    @staticmethod
    def jvp(ctx, _mesh_t, _axes_t, *ts_t):
        return tuple(t.view_as(t) for t in ts_t)


class _SumParams(torch.autograd.Function):
    @staticmethod
    def forward(mesh, axes, link, *ts):
        return _sum_params(mesh, axes, ts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axes = inputs[0], inputs[1]
        ctx.like = [_like(t) for t in inputs[3:]]

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + _CopyParams.apply(ctx.mesh, ctx.axes, *grads)

    @staticmethod
    def jvp(ctx, _mesh_t, _axes_t, _link_t, *ts_t):
        return _sum_params(ctx.mesh, ctx.axes,
                           tuple(_tangent(t, like) for t, like in zip(ts_t, ctx.like)))


def copy_params(ts, mesh, axes) -> tuple:
    """``ts`` unchanged, each gradient summed over its axis of ``axes``
    ("model", "data", "mesh" or None), in one backward node: however many
    of them a rank uses, every rank runs the same all-reduces."""
    return _CopyParams.apply(mesh, tuple(axes), *ts)


def _shift(x: torch.Tensor, mesh, moves: tuple) -> torch.Tensor:
    """Model index ``dst`` receives ``x`` of model index ``src`` for each
    ``(src, dst)`` of ``moves`` (``src != dst``; a send and a receive on
    the two ranks); a rank that receives nothing gets zeros."""
    x = x.contiguous()
    got = mesh.send_recv([(src, dst, x.shape) for src, dst in moves], lambda dst: x, x,
                         "model")
    return next(iter(got.values())) if got else torch.zeros_like(x)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(x, link, mesh, moves):
        return _shift(x, mesh, moves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.moves, ctx.like = inputs[2], inputs[3], _like(inputs[0])
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, grad):
        (link,) = ctx.saved_tensors
        back = tuple((dst, src) for src, dst in ctx.moves)
        return _Shift.apply(grad, link, ctx.mesh, back), None, None, None

    @staticmethod
    def jvp(ctx, x_t, _link_t, _mesh_t, _moves_t):
        return _shift(_tangent(x_t, ctx.like), ctx.mesh, ctx.moves)


def shift_stages(x: torch.Tensor, link: torch.Tensor, mesh, moves) -> torch.Tensor:
    """For each ``(src, dst)`` stage pair of ``moves``, stage ``dst``'s
    result is stage ``src``'s ``x`` (every rank passes a tensor of one
    shape); zeros where nothing arrives.  Linear: the jvp is itself, the
    transpose the reverse moves."""
    return _Shift.apply(x, link, mesh, tuple(moves))


def _replicated(parts: tuple) -> bool:
    return all(p == parts[0] for p in parts)


def _from_last(x: torch.Tensor, mesh, parts: tuple) -> torch.Tensor:
    """Rows ``parts[r]`` of the last stage's ``x`` on stage r."""
    S, me = mesh.num_model, mesh.model_index
    last = S - 1
    if _replicated(parts):
        buf = x.contiguous().clone() if me == last else torch.empty_like(x)
        return mesh.broadcast_on(buf, last, "model")
    rest = tuple(x.shape[1:])
    moves = [(last, r, (hi - lo,) + rest) for r, (lo, hi) in enumerate(parts[:last]) if hi > lo]
    got = mesh.send_recv(moves, lambda r: x[parts[r][0]:parts[r][1]].contiguous(), x, "model")
    lo, hi = parts[me]
    if me == last:
        return x[lo:hi].clone()
    return got.get(last, x.new_zeros((hi - lo,) + rest))


def _to_last(g: torch.Tensor, mesh, parts: tuple) -> torch.Tensor:
    """The transpose of :func:`_from_last`: every stage's rows ``parts[r]``
    back to the last stage (summed where they overlap); zeros elsewhere."""
    S, me = mesh.num_model, mesh.model_index
    last = S - 1
    rows = max(hi for _, hi in parts)
    if _replicated(parts):
        total = _sum_over(g, mesh)
        return total if me == last else torch.zeros_like(total)
    rest = tuple(g.shape[1:])
    moves = [(r, last, (hi - lo,) + rest) for r, (lo, hi) in enumerate(parts[:last]) if hi > lo]
    got = mesh.send_recv(moves, lambda dst: g.contiguous(), g, "model")
    out = g.new_zeros((rows,) + rest)
    if me == last:
        for r, buf in got.items():
            lo, hi = parts[r]
            out[lo:hi] += buf
        lo, hi = parts[last]
        out[lo:hi] += g
    return out


class _FromLastStage(torch.autograd.Function):
    @staticmethod
    def forward(x, link, mesh, parts):
        return _from_last(x, mesh, parts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.parts, ctx.like = inputs[2], inputs[3], _like(inputs[0])
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, grad):
        (link,) = ctx.saved_tensors
        return _ToLastStage.apply(grad, link, ctx.mesh, ctx.parts), None, None, None

    @staticmethod
    def jvp(ctx, x_t, _link_t, _mesh_t, _parts_t):
        return _from_last(_tangent(x_t, ctx.like), ctx.mesh, ctx.parts)


class _ToLastStage(torch.autograd.Function):
    @staticmethod
    def forward(g, link, mesh, parts):
        return _to_last(g, mesh, parts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.parts, ctx.like = inputs[2], inputs[3], _like(inputs[0])
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, grad):
        (link,) = ctx.saved_tensors
        return _FromLastStage.apply(grad, link, ctx.mesh, ctx.parts), None, None, None

    @staticmethod
    def jvp(ctx, g_t, _link_t, _mesh_t, _parts_t):
        return _to_last(_tangent(g_t, ctx.like), ctx.mesh, ctx.parts)


def scatter_from_last_stage(x: torch.Tensor, link: torch.Tensor, mesh, parts) -> torch.Tensor:
    """Rows ``parts[r] = (lo, hi)`` of the last stage's ``x`` (leading
    dim) on stage r, every stage passing an ``x`` of one shape; the
    transpose gathers them back to the last stage.  Equal parts on every
    stage: a broadcast (the transpose sums the stages' cotangents)."""
    return _FromLastStage.apply(x, link, mesh, tuple(tuple(p) for p in parts))


def model_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the model ranks, with no
    gradient (a shift that cancels wherever it is used)."""
    x = x.detach()
    both = gather_from_model(x.unsqueeze(-1), mesh, -1)
    return both.amax(-1).detach()


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor, mesh,
                             scatter_dim=None) -> torch.Tensor:
    """Rows of a vocab-sharded embedding: this rank holds ``table``, the
    contiguous rows ``[m·V/n, (m+1)·V/n)``; an id outside them reads zeros
    here, and the sum over the model axis gives every id its row (with
    ``scatter_dim``, then this rank's slice of that dimension)."""
    rows = table.shape[0]
    local = ids - mesh.model_index * rows
    inside = (local >= 0) & (local < rows)
    picked = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
    if scatter_dim is not None:
        return reduce_scatter_to_model(picked, mesh, scatter_dim)
    return reduce_from_model(picked, mesh)


def vocab_parallel_log_likelihood(logits: torch.Tensor, targets: torch.Tensor,
                                  mesh) -> torch.Tensor:
    """``log softmax(z)[target]`` from this rank's vocab slice of the logits
    (``logits`` (..., V/n), f32 or wider; ``targets`` global ids): a shift
    by the maximum over every rank (no gradient; it cancels), then the sum
    of exponentials and the target's logit each summed over the model axis.
    Replicated on every rank, twice differentiable."""
    cols = logits.shape[-1]
    shift = model_max(logits.amax(-1), mesh)
    sum_exp = reduce_from_model(torch.exp(logits - shift[..., None]).sum(-1), mesh)
    local = targets - mesh.model_index * cols
    inside = (local >= 0) & (local < cols)
    picked = logits.gather(-1, local.clamp(0, cols - 1)[..., None]).squeeze(-1)
    target = reduce_from_model(picked * inside.to(logits.dtype), mesh)
    return target - shift - torch.log(sum_exp)
