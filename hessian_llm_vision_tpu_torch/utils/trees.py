"""Parameter-subtree selection over ``{name: tensor}`` dicts (port of
``utils/trees.py``).

Labels are the JAX package's: '/'-joined flax paths in flax flatten order
(``h_0/attn/c_attn/kernel``), so a predicate such as ``"h_0/attn" in
label`` selects the same leaves in both packages.  The port's dotted names
map to them one to one (``h_0.attn.c_attn.kernel``); the flatten order is
``utils.flatten.flat_order``'s.
"""

from __future__ import annotations

import re
from typing import Callable, List, Mapping, Tuple

import torch

from hessian_llm_vision_tpu_torch.utils.flatten import flat_order


def _label(name: str) -> str:
    return name.replace(".", "/")


def param_labels(params: Mapping[str, torch.Tensor]) -> List[str]:
    """Stable '/'-joined path names for every leaf, in flatten order."""
    return [_label(n) for n in flat_order(params)]


def subtree_mask(params: Mapping[str, torch.Tensor], predicate: Callable[[str], bool]) -> dict:
    """``{name: bool}``: True where the leaf's '/'-joined label satisfies
    ``predicate``."""
    return {n: bool(predicate(_label(n))) for n in flat_order(params)}


def mask_tree(tree: Mapping[str, torch.Tensor], mask: Mapping[str, bool]) -> dict:
    """Zero out leaves where ``mask`` is False (block-restriction of a vector)."""
    return {n: x if mask[n] else torch.zeros_like(x) for n, x in tree.items()}


def partition_labels(params: Mapping[str, torch.Tensor]) -> Tuple[List[str], List[Tuple[int, int]]]:
    """Labels plus (offset, size) flat-vector spans per leaf, in flatten order."""
    labels, spans, off = [], [], 0
    for n in flat_order(params):
        size = params[n].numel()
        labels.append(_label(n))
        spans.append((off, size))
        off += size
    return labels, spans


#: Matches one repeated-block path component (GPT-2 ``h_3``, LLaMA/NeoX
#: ``layer_0``, generically ``block(s)_i``/``layer(s)_i``).
BLOCK_GROUP_REGEX = r"(?:^|/)((?:h|blocks?|layers?)_\d+)(?:/|$)"


def group_spans(
    labels: List[str], spans: List[Tuple[int, int]], regex: str
) -> Tuple[List[str], List[Tuple[int, int]]]:
    """Merge per-leaf flat-vector spans into per-group contiguous spans.

    ``regex`` is searched against each leaf label; the group label is
    capture group 1 (or the whole match).  Leaves that do not match are
    dropped.  A group must be one parameter subtree, hence contiguous in
    flatten order; a non-contiguous group is an error.
    """
    pat = re.compile(regex)
    order: List[str] = []
    merged: dict = {}
    for label, (off, size) in zip(labels, spans):
        m = pat.search(label)
        if not m:
            continue
        g = m.group(1) if m.groups() else m.group(0)
        if g not in merged:
            order.append(g)
            merged[g] = (off, size)
        else:
            o0, s0 = merged[g]
            if o0 + s0 != off:
                raise ValueError(
                    f"group {g!r} is non-contiguous in flatten order "
                    f"(leaf {label!r} at offset {off}, group ends at {o0 + s0}); "
                    "a group must be one parameter subtree"
                )
            merged[g] = (o0, s0 + size)
    return order, [merged[g] for g in order]
