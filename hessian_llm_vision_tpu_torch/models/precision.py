"""Per-layer matmul precision for the LM family (port of
``models/precision.py``), re-based on the H100's tiers.

``block_matmul_precision`` on the LM configs (GPT-2, NeoX, LLaMA) takes
the JAX package's three forms:

* ``None`` -- inherit the caller's precision (the curvature code's outer
  scope, :func:`outer_precision`);
* a string -- one precision for every transformer block (the "mixed"
  mode: blocks "default", the vocab head and the loss at the outer tier);
* a sequence of one ``None`` / str entry per layer -- per-block
  precision, the auto-precision escalation surface (``krylov/autoprec.py``).

The names keep the JAX package's roles and mean this on the card:

=====================================================  ============================
name                                                   on the card
=====================================================  ============================
``None``                                               ambient: fp32, TF32 off
``"default"``, ``BF16_BF16_F32``                       bf16 operands, f32 accumulation
``TF32_TF32_F32``                                      TF32 tensor cores
``"high"``, ``"highest"``, ``BF16_BF16_F32_X6``,       IEEE fp32
``F32_F32_F32``
``F64_F64_F64``                                        float64 operands and sums,
                                                       result cast back
=====================================================  ============================

Any other upper-case preset is refused (the JAX package lets XLA validate
it at scope entry).  So "high" and the X6 preset, two rungs on the TPU
(bf16x3 and bf16x6), are one rung here: the card has true fp32.

bf16 output.  A bf16 matmul in torch returns bf16, where the TPU's 1-pass
mode returns its f32 accumulator.  The bf16 tier therefore casts the
result back to f32, after torch has rounded it to bf16: one more rounding
than on the TPU, of the same size as the operands' own.  The outer scope
keeps cuBLAS from reducing split-K partial sums in bf16.

How a scope reaches every pass.  A scope is a ``with`` block around a
module's forward; :func:`matmul` and :func:`einsum` read the innermost
tier when they run and fix it for that product:

* tiers carried by dtype (bf16, float64) are casts, which autograd and
  forward-mode AD follow into the reverse and tangent products;
* TF32 or fp32 is a global cuBLAS flag, read when a kernel launches.  Under
  ``torch.func.jvp(torch.func.grad(f))`` a block's reverse products run
  after its ``with`` block has closed, so a product whose tier differs
  from the ambient flag runs as :class:`_FlagEinsum`, an autograd
  Function whose forward, backward and jvp each set the flag they need.
  Products whose tier equals the ambient flag run plain: the whole
  ``jvp(grad)`` call runs inside the one outer scope, so the flag the
  reverse pass sees is the one the forward saw.  The outer scope sets
  the ambient flag once, to what most of the model's fp32/TF32 products
  want (:func:`outer_precision` reads the config that the loss closure
  carries), so blocks-TF32 under an fp32 head runs its block products
  plain and only the head switches.

The switched product is the custom op ``hlv_port::flag_einsum`` (an
einsum with its TF32 flag as an argument, with a fake implementation and
a batching rule), which :class:`_FlagEinsum`'s forward, backward and jvp
each call: a graph traced by ``make_fx`` (``curvature/linearized.py``)
keeps it as a node, so the replayed graph switches the flag per product
as the eager HVP does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

BlockPrecision = Union[None, str, Sequence[Optional[str]]]

_VALID = (None, "default", "high", "highest")

BF16, TF32, FP32, FP64 = "bf16", "tf32", "fp32", "fp64"

#: JAX preset names the port runs, with their tier on the card
PRESETS = {
    "BF16_BF16_F32": BF16,
    "TF32_TF32_F32": TF32,
    "BF16_BF16_F32_X6": FP32,
    "F32_F32_F32": FP32,
    "F64_F64_F64": FP64,
}
_NAMED = {"default": BF16, "high": FP32, "highest": FP32}
_CAST = {BF16: torch.bfloat16, FP64: torch.float64}


def _check(p) -> None:
    if p is None or (isinstance(p, str) and (p in _VALID or p in PRESETS)):
        return
    if isinstance(p, str) and p.isupper():
        raise ValueError(
            f"block matmul precision preset {p!r} has no counterpart on the card; "
            f"the port runs {', '.join(PRESETS)}"
        )
    raise ValueError(
        f"invalid block matmul precision {p!r}; expected one of "
        f"{_VALID} or a jax dot-algorithm preset name (e.g. "
        "'BF16_BF16_F32_X6')"
    )


def tier_of(p: Optional[str]) -> Optional[str]:
    """The card tier of a precision name (``None`` -> ``None``)."""
    _check(p)
    if p is None:
        return None
    return _NAMED.get(p) or PRESETS[p]


def per_layer_precision(
    bmp: BlockPrecision, n_layers: int
) -> Tuple[Optional[str], ...]:
    """Normalize ``block_matmul_precision`` to an ``n_layers`` tuple."""
    if bmp is None or isinstance(bmp, str):
        per = (bmp,) * n_layers
    else:
        per = tuple(bmp)
        if len(per) != n_layers:
            raise ValueError(
                f"block_matmul_precision sequence has {len(per)} entries "
                f"for {n_layers} layers"
            )
    for p in per:
        _check(p)
    return per


def uniform_precision(bmp: BlockPrecision) -> Optional[str]:
    """Collapse a per-layer spec to one string if uniform, else raise."""
    if bmp is None or isinstance(bmp, str):
        return bmp
    per = set(bmp)
    if len(per) == 1:
        return next(iter(per))
    raise ValueError(
        "this code path supports a single uniform block_matmul_precision; "
        f"got per-layer spec {tuple(bmp)!r}"
    )


_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "tiers"):
        _local.tiers = []
    return _local.tiers


def current_tier() -> Optional[str]:
    """The innermost scope's tier, or None outside every scope."""
    s = _stack()
    return s[-1] if s else None


@contextlib.contextmanager
def _pushed(tier: str):
    s = _stack()
    s.append(tier)
    try:
        yield
    finally:
        s.pop()


def rescoped(fn):
    """``fn`` run under the scopes open now, wherever and whenever it is
    called: the recompute of a rematerialised region (``utils/remat.py``)
    runs in a backward pass, after its scopes have closed, and on CUDA on
    autograd's device thread, whose stack is its own."""
    tiers = list(_stack())

    def run(*args):
        s = _stack()
        saved = s[:]
        s[:] = tiers
        try:
            return fn(*args)
        finally:
            s[:] = saved

    return run


def precision_scope(prec: Optional[str]):
    """Context manager: the products inside run at ``prec``'s tier; a no-op
    for ``None``."""
    if prec is None:
        return contextlib.nullcontext()
    return _pushed(tier_of(prec))


@contextlib.contextmanager
def _flags(tf32: bool):
    """cuBLAS and cuDNN TF32 flags inside the block; bf16 products reduce
    in f32.  Restored on exit."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_tf32, torch.backends.cudnn.allow_tf32,
         m.allow_bf16_reduced_precision_reduction) = saved


def _product_tiers(config, outer: Optional[str]) -> list:
    """The tier of each kind of product of a model ``config`` under the
    outer tier ``outer``, then the vocab head's.  Every LM config answers
    ``config.product_scopes()``: per kind of product (per block, its
    attention dense, attention score and MLP products for GPT-2, one kind
    for NeoX and LLaMA) the precision names of its scopes from the block
    inwards, the innermost set one winning."""
    tiers = []
    for chain in config.product_scopes():
        tier = outer
        for p in chain:
            if p is not None:
                tier = tier_of(p)
        tiers.append(tier)
    return tiers + [outer]


def _ambient_tf32(tiers) -> bool:
    flagged = [t == TF32 for t in tiers if t in (TF32, FP32)]
    return 2 * sum(flagged) > len(flagged)


def tf32_switches(config, prec: Optional[str]) -> bool:
    """Whether some product of a model with this config, run inside
    ``outer_precision(prec, config)``, needs the TF32 flag switched per
    product (:class:`_FlagEinsum`, a ``flag_einsum`` node in a traced
    graph): its fp32 and TF32 products mix.  ``config`` None (a model
    without scopes): never."""
    if config is None:
        return False
    tiers = {FP32 if t is None else t for t in _product_tiers(config, tier_of(prec))}
    return {TF32, FP32} <= tiers


@contextlib.contextmanager
def outer_precision(prec: Optional[str], config=None):
    """The curvature code's outer scope (``hvp_fn(precision=...)``): the
    tier itself, which products outside any model scope (the vocab head,
    the loss) and blocks at ``None`` inherit, and the ambient TF32 flag.
    The flag is the tier's (on for TF32, off otherwise) or, given the
    model's ``config``, what most of its fp32/TF32 products want, so that
    only the rest take :class:`_FlagEinsum`, whose host cost per call
    (torch.func wraps each custom Function call) outweighs the products at
    GPT-2 scale.  ``None`` keeps the ambient settings."""
    if prec is None:
        yield
        return
    tier = tier_of(prec)
    tf32 = tier == TF32 if config is None else _ambient_tf32(_product_tiers(config, tier))
    with _flags(tf32), _pushed(tier):
        yield


def _grad_equations(eq: str) -> Tuple[str, str]:
    ins, out = eq.replace(" ", "").split("->")
    a, b = ins.split(",")
    for x, other in ((a, b), (b, a)):
        if set(x.replace("...", "")) - set(other + out):
            raise ValueError(f"einsum {eq!r}: an operand index is summed alone")
    return f"{out},{b}->{a}", f"{a},{out}->{b}"


@contextlib.contextmanager
def _tf32(on: bool):
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32
    m.allow_tf32 = on
    try:
        yield
    finally:
        m.allow_tf32 = saved


@torch.library.custom_op("hlv_port::flag_einsum", mutates_args=())
def flag_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """Two-operand ``torch.einsum`` with cuBLAS's TF32 flag at ``tf32``
    while it runs (no derivative of its own: :class:`_FlagEinsum`'s)."""
    with _tf32(tf32):
        return torch.einsum(eq, a, b)


@flag_einsum.register_fake
def _flag_einsum_fake(eq, a, b, tf32):
    return torch.einsum(eq, a, b)


def _flag_einsum_vmap(info, in_dims, eq, a, b, tf32):
    """The batch dimension as a new leading index of the equation."""
    ins, out = eq.replace(" ", "").split("->")
    z = next(c for c in "zyxwvutsrqponmlkjihgfedcbaZYXWVUTSRQPONMLKJIHGFEDCBA" if c not in eq)
    terms = []
    for t, term, d in ((a, ins.split(",")[0], in_dims[1]), (b, ins.split(",")[1], in_dims[2])):
        terms.append((t, term) if d is None else (t.movedim(d, 0), z + term))
    (a, ta), (b, tb) = terms
    return flag_einsum(f"{ta},{tb}->{z}{out}", a, b, tf32), 0


torch.library.register_vmap(flag_einsum, _flag_einsum_vmap)


class _FlagEinsum(torch.autograd.Function):
    """Two-operand einsum whose forward, backward and tangent products all
    run with cuBLAS's TF32 flag at ``tf32`` (each a :func:`flag_einsum`)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(eq, a, b, tf32):
        return flag_einsum(eq, a, b, tf32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        eq, a, b, tf32 = inputs
        ctx.eq, ctx.tf32 = eq, tf32
        ctx.save_for_backward(a, b)
        ctx.save_for_forward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga_eq, gb_eq = _grad_equations(ctx.eq)
        ga = _FlagEinsum.apply(ga_eq, g, b, ctx.tf32) if ctx.needs_input_grad[1] else None
        gb = _FlagEinsum.apply(gb_eq, a, g, ctx.tf32) if ctx.needs_input_grad[2] else None
        return None, ga, gb, None

    @staticmethod
    def jvp(ctx, _eq, ta, tb, _tf32_flag):
        a, b = ctx.saved_tensors
        out = None
        if ta is not None:
            out = flag_einsum(ctx.eq, ta, b, ctx.tf32)
        if tb is not None:
            t = flag_einsum(ctx.eq, a, tb, ctx.tf32)
            out = t if out is None else out + t
        return out


def _tiered(eq: str, a: torch.Tensor, b: torch.Tensor, plain):
    tier = current_tier()
    if tier is None:
        return plain()
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if tier in _CAST:
        dt = _CAST[tier]
        if out_dtype == dt:
            return plain()
        return torch.einsum(eq, a.to(dt), b.to(dt)).to(out_dtype)
    if out_dtype != torch.float32:
        return plain()  # the TF32 flag only acts on f32 operands
    want = tier == TF32
    if torch.backends.cuda.matmul.allow_tf32 == want:
        return plain()
    return _FlagEinsum.apply(eq, a, b, want)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``b`` of shape (in, out), at the innermost tier."""
    return _tiered("...i,io->...o", a, b, lambda: a @ b)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-operand ``torch.einsum`` at the innermost tier."""
    return _tiered(eq, a, b, lambda: torch.einsum(eq, a, b))


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding=0) -> torch.Tensor:
    """``F.conv2d`` (NCHW, weight (out, in, kh, kw)) at the innermost tier:
    the bf16 and float64 tiers are casts, as for :func:`matmul`; TF32 and
    fp32 follow cuDNN's TF32 flag, which the outer scope sets (the vision
    models open no scope of their own, so no convolution needs the flag
    switched per product)."""
    tier = current_tier()
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if tier in _CAST and out_dtype != _CAST[tier]:
        dt = _CAST[tier]
        return F.conv2d(x.to(dt), w.to(dt), stride=stride, padding=padding).to(out_dtype)
    return F.conv2d(x, w, stride=stride, padding=padding)
