"""LoRA adapters over any LM of the port (port of ``models/lora.py``).

Adapters are ordinary parameters: for every 2-D kernel whose dotted name
matches ``targets``, ``{name}.A`` (in, r) and ``{name}.B`` (r, out), with
``B`` zero so that the adapted model equals the base at init.  They merge
into the kernels at call time (``base + scale A @ B``), so the whole
curvature and training stack applies to them unchanged: an HVP of
:func:`lora_loss_fn` is the loss Hessian restricted to the adapter
subspace, and LanczosSGD trains the adapters.  The adapter dict's flat
order (``utils/flatten.py``) is the JAX adapter tree's.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping, Optional

import torch

#: the JAX package's target regex, on dotted names: GPT-2, NeoX and the
#: LLaMA projections (the PEFT target modules of the reference's LLaMA run)
DEFAULT_TARGETS = (
    r".*(c_attn|c_fc|query_key_value|dense_h_to_4h|attn\.c_proj"
    r"|attention\.dense|mlp\.c_proj|dense_4h_to_h"
    r"|q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj"
    r")\.kernel$"
)


def lora_init(
    base_params: Mapping[str, torch.Tensor],
    rank: int,
    generator: Optional[torch.Generator] = None,
    *,
    targets: str = DEFAULT_TARGETS,
) -> dict[str, torch.Tensor]:
    """Adapters ``{name}.A ~ N(0, 1) / rank`` (in, rank) and ``{name}.B =
    0`` (rank, out), in f32 on the kernels' device, for every 2-D kernel
    matching ``targets``, drawn in name order from ``generator`` (which
    lives on that device)."""
    pat = re.compile(targets)
    adapters: dict[str, torch.Tensor] = {}
    for name in sorted(base_params):
        leaf = base_params[name]
        if leaf.ndim != 2 or not pat.match(name):
            continue
        d_in, d_out = leaf.shape
        a = torch.randn(d_in, rank, generator=generator, device=leaf.device)
        adapters[f"{name}.A"] = a / rank
        adapters[f"{name}.B"] = torch.zeros(rank, d_out, device=leaf.device)
    if not adapters:
        raise ValueError(f"no kernels match {targets!r}")
    return adapters


def merge_lora(
    base_params: Mapping[str, torch.Tensor],
    adapters: Mapping[str, torch.Tensor],
    scale: float = 1.0,
) -> dict[str, torch.Tensor]:
    """``base + scale * A @ B`` on the adapted kernels (differentiable in
    A and B); every other parameter as it is."""
    out = dict(base_params)
    for key in adapters:
        if key.endswith(".A"):
            name = key[: -len(".A")]
            delta = adapters[key].float() @ adapters[f"{name}.B"].float()
            out[name] = base_params[name] + scale * delta.to(base_params[name].dtype)
    return out


def lora_loss_fn(
    loss_fn: Callable,
    base_params: Mapping[str, torch.Tensor],
    scale: float = 1.0,
) -> Callable:
    """Lift ``loss_fn(params, batch)`` to ``loss(adapters, batch)`` with the
    base frozen: the closure every curvature engine and optimiser takes.
    It carries ``loss_fn``'s model config for the precision scopes."""

    def loss(adapters, batch):
        return loss_fn(merge_lora(base_params, adapters, scale), batch)

    loss.model_config = getattr(loss_fn, "model_config", None)
    return loss
