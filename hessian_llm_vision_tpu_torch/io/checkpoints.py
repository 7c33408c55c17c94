"""Model and train-state checkpoints (port of ``io/checkpoints.py``).

A checkpoint is one ``torch.save`` file of a nested dict of tensors and
numbers (named tuples such as ``TrainState`` are stored as dicts), written
to a temporary name and renamed into place, and read back with
``torch.load(weights_only=True)``.  Tensors are stored on the CPU, so a
file written on a card loads on the CPU and the other way round.

``load_checkpoint(path, template=...)`` restores the template's structure
(its named tuples, its key order) and puts each tensor on the template
tensor's device; a missing or extra key, or a tensor of another shape or
dtype, raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _to_tree(node, where: str = ""):
    if _is_namedtuple(node):
        node = node._asdict()
    if isinstance(node, Mapping):
        return {str(k): _to_tree(v, f"{where}/{k}") for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if isinstance(node, (int, float)):
        return node
    raise TypeError(f"checkpoint entry {where or '/'}: {type(node).__name__} is not a "
                    "tensor, number, dict or named tuple")


def save_checkpoint(path: str, state: Any) -> None:
    """Save params, a full train state, or any nested dict of tensors and
    numbers at ``path`` (one file; parent directories are created)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(_to_tree(state), tmp)
    os.replace(tmp, path)


def _restore(node, template, where: str, path: str):
    def fail(msg):
        raise ValueError(f"checkpoint {path}: {where or '/'}: {msg}")

    if _is_namedtuple(template) or isinstance(template, Mapping):
        keys = template._fields if _is_namedtuple(template) else list(template)
        if not isinstance(node, Mapping):
            fail(f"expected a dict with keys {list(keys)}, found {type(node).__name__}")
        missing = [k for k in keys if k not in node]
        extra = [k for k in node if k not in keys]
        if missing or extra:
            fail(f"missing keys {missing}, extra keys {extra}")
        sub = template._asdict() if _is_namedtuple(template) else template
        restored = {k: _restore(node[k], sub[k], f"{where}/{k}", path) for k in keys}
        return type(template)(**restored) if _is_namedtuple(template) else restored
    if isinstance(template, torch.Tensor):
        if not isinstance(node, torch.Tensor):
            fail(f"expected a tensor, found {type(node).__name__}")
        if node.shape != template.shape or node.dtype != template.dtype:
            fail(f"{tuple(node.shape)} {node.dtype} where the template has "
                 f"{tuple(template.shape)} {template.dtype}")
        return node.to(template.device)
    if isinstance(template, (int, float)):
        if isinstance(node, bool) or not isinstance(node, type(template)):
            fail(f"expected {type(template).__name__}, found {type(node).__name__}")
        return node
    fail(f"template entry of type {type(template).__name__} is not restorable")


def load_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    """Load a checkpoint: the stored nested dict (tensors on the CPU), or,
    with ``template``, the template's structure with the stored values."""
    path = os.path.abspath(path)
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if template is None:
        return tree
    return _restore(tree, template, "", path)


def load_torch_state_dict(path: str, strip_module_prefix: bool = True) -> dict:
    """Read a reference torch checkpoint (a state dict or a pickled module,
    so the file must be trusted) into a numpy dict, stripping the
    DataParallel ``module.`` prefix."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out = {}
    for k, v in sd.items():
        if strip_module_prefix and k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().numpy() if hasattr(v, "detach") else v
    return out
