"""PyTorch/CUDA port of ``hessian_llm_vision_tpu`` for one NVIDIA H100.

Module paths mirror the JAX package (``models/gpt2.py`` here is the
counterpart of ``hessian_llm_vision_tpu/models/gpt2.py``).  The port imports
torch, numpy and the standard library only; the one rank-k kernel pair is
hand-written CUDA (``ops/csrc/rank_k.cu``), built at first use.

Submodules are not imported eagerly: ``import hessian_llm_vision_tpu_torch``
costs nothing beyond this file.
"""

__version__ = "0.1.0"
