"""Parallelism on ``torch.distributed`` (port of ``parallel/``).

The data axis: the batch or the probes split over the ranks, the
parameters replicate, and the Krylov basis splits along P
(``krylov/sharded.py``).  The model axis: tensor parallelism
(``param_sharding``), sequence parallelism (``seq_parallel``) and expert
parallelism (``models/moe.py``), with the differentiable collectives of
``models/collectives.py`` inside the model, and the basis split over both
axes.  The GPipe pipeline (``pipeline``): GPT-2's blocks stacked by
stage over the second axis of a ``('data', 'pp')`` mesh, the microbatches
rotated through the stages inside a differentiable loss.
``parallel.spawn`` (n ranks in new interpreters) and ``parallel.dryrun``
are imported on their own.
"""

from hessian_llm_vision_tpu_torch.parallel.dist_init import (
    initialize,
    is_multihost,
    local_device_count,
)
from hessian_llm_vision_tpu_torch.parallel.hvp_sharded import (
    ShardedHessianOperator,
    ShardedLoss,
    make_sharded_loss,
    sharded_grad_fn,
)
from hessian_llm_vision_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
    basis_sharding,
    data_sharding,
    flat_vector_sharding,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
from hessian_llm_vision_tpu_torch.parallel.offload import to_device, to_host
from hessian_llm_vision_tpu_torch.parallel.param_sharding import (
    DEFAULT_TP_RULES,
    model_parallel_config,
    shard_params_for_tp,
    tp_spec_tree,
)
from hessian_llm_vision_tpu_torch.parallel.pipeline import (
    make_pipeline_mesh,
    make_pipelined_lm_loss,
    pipeline_apply,
    pipeline_param_sharding,
    stack_pipeline_params,
    unstack_pipeline_params,
)
from hessian_llm_vision_tpu_torch.parallel.probe_parallel import (
    probe_parallel_spectrum_host,
)
from hessian_llm_vision_tpu_torch.parallel.seq_parallel import (
    seq_parallel_config,
    seq_sharding,
)

__all__ = [
    "initialize",
    "is_multihost",
    "local_device_count",
    "Mesh",
    "Sharding",
    "make_mesh",
    "data_sharding",
    "replicated_sharding",
    "basis_sharding",
    "flat_vector_sharding",
    "shard_batch",
    "ShardedLoss",
    "ShardedHessianOperator",
    "make_sharded_loss",
    "sharded_grad_fn",
    "to_host",
    "to_device",
    "shard_params_for_tp",
    "tp_spec_tree",
    "DEFAULT_TP_RULES",
    "model_parallel_config",
    "seq_sharding",
    "seq_parallel_config",
    "probe_parallel_spectrum_host",
    "make_pipeline_mesh",
    "make_pipelined_lm_loss",
    "pipeline_apply",
    "pipeline_param_sharding",
    "stack_pipeline_params",
    "unstack_pipeline_params",
]
