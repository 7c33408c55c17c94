"""Models and loss closures: the JAX package's ``models/__init__.py`` --
the language-model families (GPT-2 with its mixture-of-experts MLP and
its expert-parallel helpers, Pythia/NeoX, LLaMA) and the vision and MLP
models (``SpiralMLP``, ``SimpleNet``, ``VGG16``, ``ResNet50``)."""

from hessian_llm_vision_tpu_torch.models.attention import causal_attention
from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from hessian_llm_vision_tpu_torch.models.pythia import PYTHIA_CONFIGS, NeoXConfig, NeoXLMHead
from hessian_llm_vision_tpu_torch.models.llama import LLAMA_CONFIGS, LlamaConfig, LlamaLMHead
from hessian_llm_vision_tpu_torch.models.moe import (
    MoEMLP,
    make_ep_mesh,
    moe_param_sharding,
    shard_params_for_ep,
)
from hessian_llm_vision_tpu_torch.models.mlp import SimpleNet, SpiralMLP
from hessian_llm_vision_tpu_torch.models.resnet import ResNet50
from hessian_llm_vision_tpu_torch.models.vgg import VGG16
from hessian_llm_vision_tpu_torch.models import losses

__all__ = [
    "causal_attention",
    "GPT2Config",
    "GPT2LMHead",
    "NeoXConfig",
    "NeoXLMHead",
    "PYTHIA_CONFIGS",
    "LlamaConfig",
    "LlamaLMHead",
    "LLAMA_CONFIGS",
    "losses",
    "MoEMLP",
    "make_ep_mesh",
    "moe_param_sharding",
    "shard_params_for_ep",
    "ResNet50",
    "SimpleNet",
    "SpiralMLP",
    "VGG16",
]
