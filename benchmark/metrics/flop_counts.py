"""Operation counts of the curvature products, from a configuration's shapes.

One forward pass over ``B`` sequences of ``T`` tokens costs, in matrix
products (2 FLOPs a multiply-add; gathers, norms, softmax and activations
are not counted):

* weight products: ``2 * B * T * (weights of every dense kernel and the
  output head)``;
* attention: ``Q K^T`` and ``A V`` over the causal pairs only,
  ``2 * C * T * (T + 1)`` a layer and a sequence (``C`` the width).

A forward-over-reverse HVP (the JVP of the gradient) needs, for each
product ``Y = X W`` of the forward: the product (1), its tangent ``X' W +
X W'`` (2), the input gradient ``dX = dY W^T`` (1) and the tangents of both
gradients (4): 8 units.  The primal weight gradient ``X^T dY`` is not needed
for ``H v``, so it is not counted.  A product of two activations (the
attention's) also needs the second input gradient: 9 units.  Work
recomputed by rematerialisation is not counted, so the count is the same
whatever implements the HVP.
"""

from __future__ import annotations

#: f32 FLOP/s of one NVIDIA H100 SXM outside the tensor cores (NVIDIA's data sheet)
H100_FP32_FLOPS = 67e12

WEIGHT_UNITS = 8
ATTENTION_UNITS = 9


def transformer_forward_flops(width: int, layers: int, vocab: int, inner: int, batch: int,
                              seq: int) -> tuple[float, float]:
    """``(weight product FLOPs, attention FLOPs)`` of one forward pass of a
    decoder with ``layers`` blocks of fused QKV, output projection and a
    two-layer MLP ``inner`` wide, and a ``vocab``-wide head: the count a
    family's ``forward_flops`` gives for such a model."""
    C, L = width, layers
    kernel_weights = L * (3 * C * C + C * C + 2 * C * inner) + C * vocab
    weight = 2.0 * batch * seq * kernel_weights
    attention = 2.0 * C * seq * (seq + 1) * L * batch
    return weight, attention


def hvp_flops(weight: float, attention: float) -> float:
    """FLOPs of one forward-over-reverse HVP whose forward pass costs
    ``weight`` FLOPs in weight products and ``attention`` in products of two
    activations (a family's ``forward_flops``)."""
    return WEIGHT_UNITS * weight + ATTENTION_UNITS * attention
