"""Workload registry (port of ``cli/workloads.py``): the model, params,
loss, batches and the GGN pieces (``model_fn`` -> logits, ``out_loss_fn``
on them) a CLI runs on.  The language models: ``gpt2``, ``gpt2-tiny`` and
``gpt2-moe`` (with ``--experts`` / ``--moe_top_k`` on the gpt2 family),
``pythia-70m|160m|410m|1.4b`` and ``llama-tiny|micro|134m|7b``; the
classifiers: ``spiral``/``mlp`` (SiLU MLP on k-spirals), ``simplenet``/
``mnist`` (784-100-10 on MNIST's test split, which must be on disk) and
``vgg16``/``resnet50`` at their CIFAR-10 heads, on CIFAR-10, else MNIST
padded to 32x32x3, else random images.

Weights are random from ``--seed`` (torch generators, so they are not the
JAX package's weights for the same seed), or for a language model
``--checkpoint``'s params loaded with the random init as template (the
classifiers ignore it, as the JAX CLI does); tokens, points and images come
from the same numpy generators and loaders as the JAX package's, so both
packages see the same batches.  A classifier batch is a dict ``{"image":
(B, ...) f32, "label": (B,) int64}`` on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

_MODELS = ("gpt2", "gpt2-tiny", "gpt2-moe", "pythia-70m", "pythia-160m", "pythia-410m",
           "pythia-1.4b", "llama-tiny", "llama-micro", "llama-134m", "llama-7b")
_VISION = ("spiral", "mlp", "simplenet", "mnist", "vgg16", "resnet50")
#: a model with at least this many parameters draws its init on the card
#: (a CPU draw of Pythia-1.4B's 1.41e9 normals takes about 10 s where the
#: card's takes under 1 s, which chip_smoke.py 13a prints); a smaller one
#: draws on the CPU and moves, so a card run and a CPU run of the same
#: --seed start from the same weights
CARD_INIT_MIN_PARAMS = 1 << 28


@dataclasses.dataclass
class Workload:
    name: str
    model: torch.nn.Module
    params: dict
    loss_fn: Callable[[Any, Any], torch.Tensor]
    batches: list  # list of batch dicts on the device
    batch_size: int
    apply_fn: Optional[Callable] = None  # classifier apply_fn(params, x) for accuracy
    labels: Optional[Any] = None
    # GGN / Fisher: model_fn(params, batch) -> outputs, out_loss_fn(outputs, batch)
    model_fn: Optional[Callable[[Any, Any], torch.Tensor]] = None
    out_loss_fn: Optional[Callable[[torch.Tensor, Any], torch.Tensor]] = None
    # per-epoch stochastic data: make_batches(epoch) -> fresh batch list
    # (--augment / --noise redraw crops, flips and noise per epoch; epoch 0
    # equals batches, so curvature jobs see a fixed dataset)
    make_batches: Optional[Callable[[int], list]] = None


def _lm_batches(args, vocab_size: int, device: torch.device) -> list[dict]:
    from hessian_llm_vision_tpu_torch.data.synthetic import (
        markov_token_batches,
        random_token_batches,
    )
    from hessian_llm_vision_tpu_torch.data.text import load_local_corpus

    if args.dataset == "wikipedia":
        # the port reads no hub dataset: the JAX CLI's offline path only
        if not args.allow_fallback:
            raise SystemExit(
                "dataset 'wikipedia' unavailable (the port has no hub loader); pass "
                "--allow_fallback to proceed on seeded random tokens, or use "
                "--dataset random/markov/local:<path>"
            )
        print("[data] wikipedia unavailable (no hub loader); falling back to seeded "
              "random tokens (--allow_fallback)")
    if args.dataset.startswith("local:"):
        stacked = load_local_corpus(
            args.dataset[len("local:"):], max_length=args.max_length,
            batch_size=args.batch_size, subsample=args.subsample, seed=args.data_seed,
        )
        # --num_batches caps the loaded corpus too (the whole corpus at the
        # default --subsample 1.0 multiplies the cost of every iteration)
        nb = args.num_batches
        if nb is not None and nb > 0 and stacked["input_ids"].shape[0] > nb:
            print(f"[data] local corpus: capping {stacked['input_ids'].shape[0]} -> {nb} "
                  "batches (--num_batches; omit it to load the whole corpus)")
            stacked = {k: v[:nb] for k, v in stacked.items()}
    else:
        # 0/None = default size (synthetic data has no natural "whole")
        n_batches = max(1, int(args.num_batches or 4))
        if args.dataset == "markov":
            # learnable chain over a small vocab
            stacked = markov_token_batches(n_batches, args.batch_size, args.max_length,
                                           min(vocab_size, 512), seed=args.data_seed)
        else:
            stacked = random_token_batches(n_batches, args.batch_size, args.max_length,
                                           vocab_size, seed=args.data_seed,
                                           random_mask=getattr(args, "random_mask", False))
    max_id = int(stacked["input_ids"].max())
    if max_id >= vocab_size:
        raise SystemExit(
            f"dataset token id {max_id} >= model vocab_size {vocab_size}; "
            "pick a matching model/tokenizer"
        )
    n = stacked["input_ids"].shape[0]
    return [
        {k: torch.as_tensor(v[i].astype(np.int64), device=device) for k, v in stacked.items()}
        for i in range(n)
    ]


def _refuse(args) -> None:
    """The JAX CLI's refusals of the MoE and LM-only flags, and unknown
    models."""
    name = args.model
    if args.experts and not name.startswith("gpt2"):
        raise SystemExit(f"--experts applies to the gpt2 family only; model {name!r} has "
                         "no MoE variant")
    if args.moe_top_k and not args.experts:
        raise SystemExit("--moe_top_k requires --experts N")
    if not name.startswith(("gpt2", "pythia", "llama")):
        dropped = [flag for flag, set_ in [
            ("--attn_block_q", args.attn_block_q is not None),
            ("--block_precision (or --*_precision mixed)", args.block_precision is not None),
            ("--loss_chunk", args.loss_chunk is not None),
        ] if set_]
        if dropped:
            raise SystemExit(f"{', '.join(dropped)} apply to LM models only; model {name!r} "
                             "has no transformer-block/vocab path")
    if name not in _MODELS + _VISION:
        raise ValueError(f"unknown model {name!r}")


def _cfg_overrides(cfg, attn_blk, block_prec, bf16=False):
    """Apply the shared LM config flags (the JAX CLI's one site).  Unlike
    the JAX CLI, ``--bf16`` applies to gpt2-tiny too (its gpt2-tiny config
    ignores the flag)."""
    if bf16:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    if attn_blk:
        cfg = dataclasses.replace(cfg, attn_block_q=attn_blk)
    if block_prec:
        cfg = dataclasses.replace(cfg, block_matmul_precision=block_prec)
    return cfg


def lm_config(args):
    """(model class, config) of ``--model`` with the LM flags applied."""
    from hessian_llm_vision_tpu_torch.models import (
        LLAMA_CONFIGS,
        PYTHIA_CONFIGS,
        GPT2Config,
        GPT2LMHead,
        LlamaLMHead,
        NeoXLMHead,
    )

    name = args.model
    if name.startswith("pythia"):
        return NeoXLMHead, _cfg_overrides(PYTHIA_CONFIGS[name], args.attn_block_q,
                                          args.block_precision, args.bf16)
    if name.startswith("llama"):
        return LlamaLMHead, _cfg_overrides(LLAMA_CONFIGS[name], args.attn_block_q,
                                           args.block_precision, args.bf16)
    if name == "gpt2-tiny":
        cfg = GPT2Config.tiny(n_positions=max(64, args.max_length))
    elif name == "gpt2-moe":
        cfg = GPT2Config.moe_80m(n_positions=max(args.max_length, 32))
    else:
        cfg = GPT2Config.gpt2_124m(n_positions=max(args.max_length, 32))
    cfg = _cfg_overrides(cfg, args.attn_block_q, args.block_precision, args.bf16)
    if args.experts:
        cfg = dataclasses.replace(cfg, n_experts=args.experts)
    if args.moe_top_k:
        cfg = dataclasses.replace(cfg, moe_top_k=args.moe_top_k,
                                  moe_capacity_factor=args.moe_capacity_factor)
    return GPT2LMHead, cfg


def init_model(model_cls, cfg, seed: int, device: torch.device) -> torch.nn.Module:
    """``model_cls(cfg)`` with its weights drawn from a generator seeded
    with ``seed``, on ``device``: drawn on the CPU and moved, or on the
    card itself for a model of at least ``CARD_INIT_MIN_PARAMS``
    parameters."""
    with torch.device("meta"):
        n = sum(p.numel() for p in model_cls(cfg).parameters())
    on = device if device.type == "cuda" and n >= CARD_INIT_MIN_PARAMS else torch.device("cpu")
    with torch.device(on):
        model = model_cls(cfg, generator=torch.Generator(on).manual_seed(seed))
    return model.to(device)


def _image_batches(x: np.ndarray, y: np.ndarray, batch_size: int,
                   device: torch.device) -> list[dict]:
    """The first ``len(x) // batch_size`` full batches of (x, y) as
    ``{"image", "label"}`` dicts on ``device``."""
    n = (len(x) // batch_size) * batch_size
    xs = torch.as_tensor(np.ascontiguousarray(x[:n])).reshape(-1, batch_size, *x.shape[1:])
    ys = torch.as_tensor(np.asarray(y[:n], np.int64)).reshape(-1, batch_size)
    return [{"image": xs[i].to(device), "label": ys[i].to(device)} for i in range(xs.shape[0])]


def _cifar_like(args) -> tuple[np.ndarray, np.ndarray, int]:
    """vgg16/resnet50 data as the JAX CLI finds it: CIFAR-10's train split,
    else MNIST padded to 32x32x3 (train, then test), else random images;
    ``--classes`` and ``--subsample`` / ``--num_batches`` apply to real
    data.  Returns (x (N, 32, 32, 3), y (N,), num_classes)."""
    from hessian_llm_vision_tpu_torch.data import (
        get_class_subset,
        load_cifar10,
        load_mnist_as_cifar,
        random_image_batches,
    )

    try:
        x, y = load_cifar10("train")
    except FileNotFoundError:
        try:
            try:
                x, y = load_mnist_as_cifar("train")
            except FileNotFoundError:
                # some deployments carry only the t10k idx files
                x, y = load_mnist_as_cifar("test")
            print("[data] CIFAR-10 unavailable; using real MNIST upscaled to 32x32x3")
        except FileNotFoundError:
            print("[data] CIFAR-10 and MNIST unavailable; falling back to random images")
            x = y = None
    if x is None:
        # 0/None = default size (synthetic data has no natural "whole")
        xb, yb = random_image_batches(max(1, int(args.num_batches or 4)), args.batch_size,
                                      seed=args.data_seed)
        return xb.reshape(-1, 32, 32, 3), yb.reshape(-1), 10
    if args.classes:
        x, y = get_class_subset(x, y, args.classes)
    n_take = int(len(x) * args.subsample) or args.batch_size
    # --num_batches caps real data too (0/None = no cap, never empty)
    if args.num_batches:
        n_take = min(n_take, int(args.num_batches) * args.batch_size)
    return x[:n_take], y[:n_take], len(args.classes) if args.classes else 10


def _classifier(args, device: torch.device, model_cls, **kw) -> torch.nn.Module:
    """``model_cls(**kw)`` with its weights drawn from a CPU generator
    seeded with ``--seed`` and moved, so the card and the CPU start from
    the same weights."""
    return model_cls(**kw, generator=torch.Generator().manual_seed(args.seed)).to(device)


def _classifier_workload(args, device: torch.device) -> Workload:
    """The spiral, simplenet, vgg16 and resnet50 workloads."""
    from torch.func import functional_call

    from hessian_llm_vision_tpu_torch.data import (
        add_gaussian_noise,
        augment_batch,
        load_mnist,
        make_spirals,
    )
    from hessian_llm_vision_tpu_torch.models import VGG16, ResNet50, SimpleNet, SpiralMLP
    from hessian_llm_vision_tpu_torch.models.losses import (
        classification_loss_fn,
        classification_loss_fn_bn,
        softmax_cross_entropy,
    )
    from hessian_llm_vision_tpu_torch.models.resnet import batch_stats

    name, bs = args.model, args.batch_size
    if name in ("vgg16", "resnet50"):
        x, y, num_classes = _cifar_like(args)
        # --augment (random crop + flip) / --noise (Gaussian), redrawn per
        # epoch from data_seed + 100003 * epoch; epoch 0 is what curvature
        # jobs see, training redraws through make_batches
        x_raw = x if (args.augment or args.noise) else None

        def transform(epoch: int) -> np.ndarray:
            xa, seed = x_raw, args.data_seed + 100003 * epoch
            if args.augment:
                xa = augment_batch(xa, seed=seed)
            if args.noise:
                xa = add_gaussian_noise(xa, std=args.noise, seed=seed)
            return xa

        if x_raw is not None:
            x = transform(0)
        if name == "vgg16":
            model = _classifier(args, device, VGG16, num_classes=num_classes)
            loss_fn = classification_loss_fn(model)
        else:
            model = _classifier(args, device, ResNet50, num_classes=num_classes)
            loss_fn = classification_loss_fn_bn(model, batch_stats(model),
                                                bn_train_mode=args.bn_train_mode)
        wl = Workload(name, model, {n: p.detach() for n, p in model.named_parameters()},
                      loss_fn, _image_batches(x, y, bs, device), bs)
        if x_raw is not None:
            wl.make_batches = lambda epoch: _image_batches(transform(epoch), y, bs, device)
        return wl

    if name in ("mlp", "spiral"):
        x, y = make_spirals(args.num_points, noise=args.spiral_noise, seed=args.data_seed)
        model = _classifier(args, device, SpiralMLP, width=args.width, depth=args.depth)
    else:  # simplenet / mnist: no random fallback, as in the JAX CLI
        x, y = load_mnist("test")
        sel = slice(0, int(len(x) * args.subsample) or bs)
        x, y = x[sel], y[sel]
        model = _classifier(args, device, SimpleNet)

    def model_fn(p, b):
        return functional_call(model, p, (b["image"],))

    def out_loss_fn(logits, b):
        return softmax_cross_entropy(logits, b["label"])

    return Workload(name, model, {n: p.detach() for n, p in model.named_parameters()},
                    classification_loss_fn(model), _image_batches(x, y, bs, device), bs,
                    apply_fn=lambda p, xx: functional_call(model, p, (xx,)),
                    model_fn=model_fn, out_loss_fn=out_loss_fn)


def build_workload(args, device: torch.device) -> Workload:
    """``--model`` at random init from ``--seed`` or (an LM) from ``--checkpoint``,
    on ``device``, with its loss and batches: for an LM the ``--dataset``
    tokens, ``--bf16`` and ``--block_precision`` setting the config's
    compute dtype and block precision (the params stay f32)."""
    from hessian_llm_vision_tpu_torch.io.checkpoints import load_checkpoint
    from hessian_llm_vision_tpu_torch.models.losses import causal_lm_loss, lm_loss_fn

    _refuse(args)
    if args.model in _VISION:  # as in the JAX CLI, no --checkpoint here
        return _classifier_workload(args, device)
    model_cls, cfg = lm_config(args)
    model = init_model(model_cls, cfg, args.seed, device)
    params = {n: p.detach() for n, p in model.named_parameters()}
    if args.checkpoint:
        params = load_checkpoint(args.checkpoint, template=params)

    # the dense logits: --loss_chunk does not apply to the GGN's model_fn
    def lm_model_fn(p, b):
        return torch.func.functional_call(model, p, (b["input_ids"],))

    def lm_out_loss(logits, b):
        return causal_lm_loss(logits, b["input_ids"], b.get("attention_mask"))

    return Workload(
        args.model, model, params, lm_loss_fn(model, loss_chunk=args.loss_chunk),
        _lm_batches(args, cfg.vocab_size, device), args.batch_size,
        model_fn=lm_model_fn, out_loss_fn=lm_out_loss,
    )
