"""Parallelism on ``torch.distributed``: the data axis (port of the data
half of ``parallel/``).

The batch or the probes split over the ranks, the parameters replicate,
and the Krylov basis splits along P (``krylov/sharded.py``).  The model
axis -- tensor parallelism, sequence parallelism, the pipeline and
expert parallelism -- is ROADMAP A13b.  ``parallel.spawn`` (n ranks in new
interpreters) and ``parallel.dryrun`` are imported on their own.
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
from hessian_llm_vision_tpu_torch.parallel.probe_parallel import (
    probe_parallel_spectrum_host,
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
    "probe_parallel_spectrum_host",
]
