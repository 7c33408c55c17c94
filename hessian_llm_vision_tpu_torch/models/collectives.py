"""Collectives on the model axis that ``torch.func`` can differentiate.

The JAX package shards a model with annotations and lets XLA's partitioner
put the collectives into the program, where ``jvp(grad(loss))`` sees them
as ordinary primitives.  PyTorch has no partitioner, so a tensor-, sequence-
or expert-parallel model carries its collectives in its own forward, and
the curvature transforms must differentiate through them twice.  Each
collective here is a ``torch.autograd.Function`` in the functorch style
(``forward`` without ``ctx``, ``setup_context``, ``backward`` and a ``jvp``
staticmethod), so ``torch.func.grad``, ``torch.func.jvp`` and their
composition all see it:

* :func:`copy_to_model` (Megatron's *f*): identity forward and jvp, sum
  over the model axis backward.  It sits where a replicated tensor enters
  work that each rank does only part of.
* :func:`reduce_from_model` (Megatron's *g*): sum over the model axis
  forward and jvp, identity backward.  It sits where each rank's partial
  result becomes the replicated whole.
* :func:`gather_from_model`: the ranks' slices concatenated along a
  dimension; backward the reduce-scatter (a sum, then this rank's slice),
  for a gathered tensor that each rank consumes only in part (the keys and
  values of sequence-parallel attention).

Under ``jvp(grad(f))`` a ``backward`` is itself differentiated by the outer
``jvp``, and a c10d call cannot take a functorch-wrapped tensor; so every
``backward`` calls the conjugate Function's ``apply``, and only a
``forward`` or a ``jvp`` (which see plain tensors) calls c10d.  A forward
sums a copy, never its input in place.  Every collective runs on the mesh's
model group with ``all_reduce`` alone: gloo runs nothing else on CUDA
tensors, so a gather is the sum of zero-padded buffers.  Every rank must
issue the same collectives in the same order, or the group hangs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _sum_over_model(t: torch.Tensor, mesh) -> torch.Tensor:
    out = t.clone()
    if mesh.model_group is not None and mesh.num_model > 1:
        dist.all_reduce(out, group=mesh.model_group)
    return out


def _gather_over_model(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    n, m = mesh.num_model, mesh.model_index
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = size * n
    buf = t.new_zeros(shape)
    buf.narrow(dim, m * size, size).copy_(t)
    if mesh.model_group is not None and n > 1:
        dist.all_reduce(buf, group=mesh.model_group)
    return buf


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFromModel.apply(grad, ctx.mesh), None

    @staticmethod
    def jvp(ctx, x_t, _mesh_t):
        return x_t.view_as(x_t)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh):
        return _sum_over_model(x, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _CopyToModel.apply(grad, ctx.mesh), None

    @staticmethod
    def jvp(ctx, x_t, _mesh_t):
        return _sum_over_model(x_t, ctx.mesh)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, dim):
        return _gather_over_model(x, mesh, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.mesh, ctx.dim = inputs
        ctx.size = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, grad):
        whole = _ReduceFromModel.apply(grad, ctx.mesh)
        return whole.narrow(ctx.dim, ctx.mesh.model_index * ctx.size, ctx.size), None, None

    @staticmethod
    def jvp(ctx, x_t, _mesh_t, _dim_t):
        return _gather_over_model(x_t, ctx.mesh, ctx.dim)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the model axis."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the model axis; its gradient passed through."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim`` in rank order (all
    of equal shape); the gradient reduce-scattered back."""
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


def model_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the model ranks, with no
    gradient (a shift that cancels wherever it is used)."""
    x = x.detach()
    both = gather_from_model(x.unsqueeze(-1), mesh, -1)
    return both.amax(-1).detach()


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """Rows of a vocab-sharded embedding: this rank holds ``table``, the
    contiguous rows ``[m·V/n, (m+1)·V/n)``; an id outside them reads zeros
    here, and the sum over the model axis gives every id its row."""
    rows = table.shape[0]
    local = ids - mesh.model_index * rows
    inside = (local >= 0) & (local < rows)
    picked = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
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
