"""Sequence (context) parallelism over the mesh's model axis (port of
``parallel/seq_parallel.py``).

The JAX package asserts a (data, seq, None) sharding on the (B, T, C)
residual stream between blocks and lets XLA gather the context where causal
attention needs it.  In the port a config carrying :func:`seq_sharding`
runs, on rank m of the axis, tokens ``[m·T/n, (m+1)·T/n)`` of every
sequence at their own positions (``wpe``, rotary), gathers keys and values
along T in attention (``models/collectives.py::gather_from_model``),
and the loss (``models/losses.py``) takes each rank's targets from the
whole ``input_ids``, sums its token losses over the axis and divides by
the whole batch's count.  Every leaf a rank holds whole enters the model
through ``copy_to_model``, so gradients and HVPs come out whole and equal
on every rank of the axis.  Beside ``model_parallel`` on the same mesh
(``param_sharding.model_parallel_config``), tensor and sequence
parallelism share the axis: the T-slices are gathered before each
column-parallel layer and the row-parallel partial sums reduce-scattered
back (``models/gpt2.py``).  The batch axis splits over ``data_axis`` as
usual (``parallel.mesh.shard_batch`` and a ``ShardedLoss``), or replicates
(None: the bs1 long-context case this exists for).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from hessian_llm_vision_tpu_torch.parallel.mesh import Sharding


def seq_sharding(mesh, seq_axis: str = "model", data_axis: Optional[str] = "data") -> Sharding:
    """The (B, T, C) residual stream's sharding: batch over ``data_axis``
    (None: replicated), sequence over ``seq_axis`` (the mesh's model axis),
    hidden replicated."""
    if seq_axis != mesh.axis_names[1]:
        raise ValueError(f"the sequence splits over the model axis {mesh.axis_names[1]!r}, "
                         f"not {seq_axis!r}")
    return Sharding(mesh, (data_axis, seq_axis, None))


def seq_parallel_config(cfg: Any, mesh, seq_axis: str = "model",
                        data_axis: Optional[str] = "data") -> Any:
    """``cfg`` (GPT2Config, NeoXConfig or LlamaConfig) with its residual
    stream split along T over ``mesh``'s model axis."""
    return dataclasses.replace(cfg, seq_sharding=seq_sharding(mesh, seq_axis, data_axis))
