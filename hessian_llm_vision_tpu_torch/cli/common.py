"""Shared CLI plumbing (port of ``cli/common.py``): the common flags, with
the JAX CLI's names and defaults, and the device choice."""

from __future__ import annotations

import argparse

import torch

from hessian_llm_vision_tpu_torch.models.precision import PRESETS


def _block_precision_arg(value: str) -> str:
    """--block_precision values: the named tiers or one of the JAX
    dot-algorithm presets the card runs (``models/precision.py``)."""
    if value in ("default", "high", "highest") or value in PRESETS:
        return value
    raise argparse.ArgumentTypeError(
        f"invalid block precision {value!r}: expected default | high | "
        f"highest or one of the presets the card runs: {' | '.join(PRESETS)}"
    )


def add_common_args(parser: argparse.ArgumentParser) -> None:
    """The model/data flags of the JAX CLIs, with their names and defaults."""
    parser.add_argument("--model", default="gpt2-tiny",
                        help="gpt2 | gpt2-tiny | gpt2-moe | pythia-70m | pythia-160m | "
                        "pythia-410m | pythia-1.4b | llama-tiny | llama-micro | llama-134m | "
                        "llama-7b | spiral | simplenet | vgg16 | resnet50")
    parser.add_argument("--dataset", default="random",
                        help="wikipedia (needs --allow_fallback: seeded random tokens) "
                        "| random | markov | local:<path> (byte-level corpus from "
                        "on-disk text) for LMs; builtin for vision")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--subsample", type=float, default=1.0)
    parser.add_argument("--max_length", type=int, default=64)
    parser.add_argument("--num_batches", type=int, default=None,
                        help="batch-count cap: synthetic datasets generate "
                        "this many (default 4); local:<path> corpora are "
                        "truncated to it (default: whole corpus)")
    parser.add_argument("--allow_fallback", action="store_true",
                        help="permit the wikipedia->random-tokens fallback "
                        "(offline dev); without it a failed hub load is an "
                        "error, never silent noise-training")
    parser.add_argument("--random_mask", action="store_true",
                        help="random attention masks on synthetic tokens")
    parser.add_argument("--attn_block_q", type=int, default=None,
                        help="query-block size of the attention loop; default dense")
    parser.add_argument("--block_precision", default=None, type=_block_precision_arg,
                        help="matmul precision of the transformer blocks only: "
                        "default (bf16 operands) | high | highest (both fp32), or "
                        "a JAX preset the card runs: TF32_TF32_F32, "
                        "BF16_BF16_F32_X6 and F32_F32_F32 (fp32), BF16_BF16_F32, "
                        "F64_F64_F64 (models/precision.py).  Mixed curvature "
                        "mode = outer 'high' + blocks 'default'; unset inherits")
    parser.add_argument("--loss_chunk", type=int, default=None,
                        help="chunked-vocab LM loss: chunk size in sequence positions")
    parser.add_argument("--experts", type=int, default=0,
                        help="gpt2 family only: replace every block's MLP with a dense "
                        "softmax-gated MoE of this many experts (models/moe.py)")
    parser.add_argument("--moe_top_k", type=int, default=0,
                        help="with --experts: route each token to its top-k "
                        "experts through fixed-capacity buffers (GShard "
                        "semantics) instead of the dense softmax mix. "
                        "Sparse COMPUTE, but piecewise-constant routing — "
                        "curvature jobs over a top-k config get a loud "
                        "TopKCurvatureWarning (models/moe.py)")
    parser.add_argument("--moe_capacity_factor", type=float, default=1.25,
                        help="with --moe_top_k: expert capacity slack "
                        "factor (buffer = ceil(k*N/E * factor))")
    parser.add_argument("--seed", type=int, default=0,
                        help="parameter init seed; a model of at least 2^28 "
                        "parameters (pythia-410m, pythia-1.4b, llama-7b) draws "
                        "its init on the card, so on the card the same seed "
                        "gives it other weights than on the CPU")
    parser.add_argument("--data_seed", type=int, default=42)
    parser.add_argument("--checkpoint", default=None,
                        help="params saved by cli.train --save_checkpoint "
                        "(io/checkpoints.py) in place of the random init")
    parser.add_argument("--precision_plan", default=None,
                        help="persisted auto-precision plan file (default: "
                        "<--checkpoint>.autoprec.json when --checkpoint is set); "
                        "a fingerprint-matched plan resolves --hvp_precision/"
                        "--refresh_precision auto with zero probe HVPs "
                        "(krylov/precplan.py)")
    parser.add_argument("--reprobe", action="store_true",
                        help="ignore any persisted auto-precision plan and "
                        "re-probe this checkpoint (overwrites the plan file)")
    parser.add_argument("--bf16", action="store_true",
                        help="compute in bfloat16 with f32 params, as flax's dtype "
                        "(dense products and activations bf16, LayerNorm "
                        "statistics f32, logits f32)")
    parser.add_argument("--bn_train_mode", action="store_true",
                        help="resnet50: BatchNorm normalises with each batch's own "
                        "statistics (an eval model with BN in train mode); default: "
                        "the stored statistics")
    parser.add_argument("--classes", type=int, nargs="*", default=None,
                        help="vgg16/resnet50 on real data: keep these classes, "
                        "relabelled 0..n-1")
    parser.add_argument("--augment", action="store_true",
                        help="RandomCrop(4)+flip on vision data. Multi-epoch training "
                        "redraws crops/flips per epoch keyed on (data_seed, epoch); "
                        "curvature/spectrum jobs see the fixed epoch-0 draw (a "
                        "deterministic operator)")
    parser.add_argument("--noise", type=float, default=0.0,
                        help="AddGaussianNoise std on vision data")
    parser.add_argument("--width", type=int, default=64, help="spiral MLP width")
    parser.add_argument("--depth", type=int, default=3, help="spiral MLP hidden layers")
    parser.add_argument("--num_points", type=int, default=600, help="spiral points")
    parser.add_argument("--spiral_noise", type=float, default=0.2)
    parser.add_argument("--out", default="runs", help="root of the run directories")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")


def device_for(cpu: bool) -> torch.device:
    """The first CUDA device, or the CPU when asked; without ``--cpu`` and
    without a card this exits and never continues on the CPU."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device available; pass --cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
