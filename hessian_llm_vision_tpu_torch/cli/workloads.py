"""Workload registry (port of ``cli/workloads.py``): the model, params,
loss, batches and the GGN pieces (``model_fn`` -> logits, ``out_loss_fn``
on them) a CLI runs on, for ``--model gpt2 | gpt2-tiny``.

Weights are random from ``--seed`` (a torch generator, so they are not the
JAX package's weights for the same seed), or ``--checkpoint``'s params
loaded with the random init as template; tokens come from the same numpy
generators as the JAX package's, so both packages see the same batches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

_MODELS = ("gpt2", "gpt2-tiny")


@dataclasses.dataclass
class Workload:
    name: str
    model: torch.nn.Module
    params: dict
    loss_fn: Callable[[Any, Any], torch.Tensor]
    batches: list  # list of batch dicts on the device
    batch_size: int
    # GGN / Fisher: model_fn(params, batch) -> outputs, out_loss_fn(outputs, batch)
    model_fn: Optional[Callable[[Any, Any], torch.Tensor]] = None
    out_loss_fn: Optional[Callable[[torch.Tensor, Any], torch.Tensor]] = None


def _lm_batches(args, vocab_size: int, device: torch.device) -> list[dict]:
    from hessian_llm_vision_tpu_torch.data.synthetic import (
        markov_token_batches,
        random_token_batches,
    )
    from hessian_llm_vision_tpu_torch.data.text import load_local_corpus

    if args.dataset == "wikipedia":
        raise SystemExit("--dataset wikipedia: not ported yet (ROADMAP A15); "
                         "use random, markov or local:<path>")
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


def _refuse_unported(args) -> None:
    if args.model not in _MODELS:
        raise SystemExit(f"--model {args.model}: not ported yet (ROADMAP A12; "
                         f"ported: {', '.join(_MODELS)})")
    if args.experts:
        raise SystemExit("--experts: not ported yet (ROADMAP A12)")


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


def build_workload(args, device: torch.device) -> Workload:
    """GPT-2 (124M or tiny) at random init from ``--seed`` or from
    ``--checkpoint``, on ``device``, with its LM loss and the ``--dataset``
    batches; ``--bf16`` and ``--block_precision`` set the config's compute
    dtype and block precision (the params stay f32)."""
    from hessian_llm_vision_tpu_torch.io.checkpoints import load_checkpoint
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.losses import causal_lm_loss, lm_loss_fn

    _refuse_unported(args)
    if args.model == "gpt2-tiny":
        cfg = GPT2Config.tiny(n_positions=max(64, args.max_length))
    else:
        cfg = GPT2Config.gpt2_124m(n_positions=max(args.max_length, 32))
    cfg = _cfg_overrides(cfg, args.attn_block_q, args.block_precision, args.bf16)
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(args.seed)).to(device)
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
