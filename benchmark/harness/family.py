"""A configuration's model family and its plain reference, found by name.

* the family: ``benchmark/families/<cfg["family"]>.py``, with ``build(cfg)
  -> (model, loss_fn)``, the program's model and its loss ``loss_fn(params,
  batch)``, and ``forward_flops(cfg, batch, seq) -> (weight product FLOPs,
  attention FLOPs)`` of one forward pass (``metrics/flop_counts.py``);
* the reference: ``benchmark/reference/<cfg["reference"]>.py``, with
  ``shapes(cfg)``, ``loss(weights, batch, cfg)`` and ``check(cfg)``.

A family is added by adding its file; no file here names one.

The model is built on PyTorch's meta device: the program runs every product
through ``torch.func.functional_call`` on the weights the benchmark drew,
as the spectrum CLI does on its own, so the module holds no weights of its
own.  Its parameter names and shapes must be the reference's, which
:func:`build` checks.
"""

from __future__ import annotations

import torch

from benchmark.harness import registry


def load(root: str, cfg: dict):
    """The configuration's family module."""
    return registry.module(root, "families", cfg["family"])


def reference(root: str, cfg: dict):
    """The configuration's plain reference module, which refuses a
    configuration it does not describe."""
    mod = registry.module(root, "reference", cfg["reference"])
    mod.check(cfg)
    return mod


def build(root: str, cfg: dict, shapes: dict):
    """``(model, loss_fn)`` of the configuration's family, the model on the
    meta device, its parameters checked against the reference's ``shapes``."""
    with torch.device("meta"):
        model, loss_fn = load(root, cfg).build(cfg)
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(s) for n, s in shapes.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise ValueError(f"the program's parameters are not the reference's: {diff}")
    return model, loss_fn
