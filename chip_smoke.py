"""On-card smoke test of the PyTorch port: builds the CUDA kernels, holds
each against its plain PyTorch version, drives LanczosSGD training, the
spectrum paths, Adam training from and to checkpoints and the rest of the
train CLI's optimisers on GPT-2 124M through the CLIs, then the other
language-model families (Pythia-1.4B at full width, LLaMA-134m, the MoE
GPT-2, LoRA), the vision models (VGG-16 and ResNet-50 at full width,
SpiralMLP, SimpleNet), the remaining CLIs (forget, evaluate, sweep, hpo,
devices-info through the python -m dispatch), the data axis of parallel/
(one NCCL rank; two gloo ranks sharing the card) and its model axis
(tensor, sequence and expert parallelism on two gloo ranks sharing the
card), and checks the results.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero and prints no result line):
  1. require a CUDA device; print the card's name and power limit;
  2. build every kernel from ops/csrc (nvcc; registers and spills printed
     by kernel name) and print pass 1's and pass 2's launch plans at the
     timed shapes, with the resident blocks per SM the wrapper got from the
     occupancy API;
  3. rank-k kernels vs their plain versions at (10, 124,046,592) -- the
     trainer's shape -- and (35, 124,046,592), (35, 16384), (3, 20000),
     (5, 20001), f32 and bf16 bases, each also rerun for bitwise equality
     and pass 2 also on its other path (ring or direct), bit for bit equal;
     at (10, 124,046,592), kernel and a one-call library yardstick timed
     in turns (median and min-max, nvidia-smi sampled beside), then the
     plain version ((35, P) is checked untimed since phase 13 took its
     time; its last times stand in PERF.md); at every timed shape each call's wall (those events),
     host time (perf_counter over back-to-back calls) and device time (the
     kernel rows of a torch.profiler trace), for both kernels and their
     library calls;
  4. main path: 4 LanczosSGD steps of GPT-2 124M (bs8, seq512, k=10, bf16
     basis) via cli.train.main, with every launch count zeroed just before
     and read just after; each rank-k kernel must run once per step;
  5. the same trainer on gpt2-tiny, card against CPU, must agree;
  6. device time of a 124M step's pieces (forward, gradient, HVP, update);
  7. spectrum: (a) cli.spectrum.main on gpt2-tiny, card against CPU, host
     loop and in-core CGS2: lambda_max and lambda_min within 1e-5
     relative, the first 3 alphas within 1e-5 of the spectrum's scale;
     (b) the headline job through cli.spectrum.main -- GPT-2 124M, 4
     batches x bs8 x seq512, 10 T-only iterations of the dataset-mean
     Hessian (bench.py's 35, cut to leave room for phase 16) -- with its gates (finite Ritz values, lambda_max > 0 >
     lambda_min, weights summing to 1, |trace| <= 1e-2 lambda_max, the
     artifact read back, no rank-k launch) and one {"spectrum": ...} JSON
     line of its times and memory; (c) at that shape, the f32 HVP on (b)'s
     start vector against a float64 central difference of reverse-mode
     gradients on the card, and (b)'s alpha_1 against it; a TF32 HVP must
     miss the same limit;
  8. the spectrum CLI's estimators beyond SLQ at GPT-2 124M, 1 batch x bs8
     x seq512, through cli.spectrum.main: (a) --thick_restart 5 with a bf16
     buffer: converged, an independent residual |H u - lambda u| per pair
     from a fresh f32 HVP, the rows orthonormal, each rank-k kernel launched
     twice per CGS2 call; (b) --host_loop --kpm 20 --kpm_deflate 4 (60
     moments before phase 13, 30 before phase 14): spikes converged and agreeing with the SLQ
     extreme, the deflated operator annihilating each spike vector, the bulk
     range inside the SLQ range, mu_0 = 1, 2 x 31 launches of each kernel in
     the KPM stage; (c) in-core --hutchpp 9 (30 before phase 13, 15 before
     phase 17): a finite
     trace in the artifact; one {"spectrum_ext": ...}
     JSON line of their times, matvecs and memory; (d) on gpt2-tiny, card
     against CPU: thick restart, deflated KPM, Hutch++ and --host_basis.
  9. the rest of the single-card curvature at GPT-2 124M, 1 batch x bs8 x
     seq512, through cli.spectrum.main / cli.train.main: (a) --layerwise
     --layerwise_group block --host_loop, 3 iterations a block (10 before
     phase 13, 5 before phase 14, 4 before phase 16): 12 block artifacts and the grid,
     weights summing to 1, lambda_max > 0, per-block |trace| small, h_0's T
     equal to an in-core LayerHessianOperator run; (b) --operator ggn
     --host_loop, 12 iterations (20 before phase 17): Ritz values >= 0, the GGN matvec against jvp, an explicit
     float64 softmax Hessian and vjp; (c) --linearized against the plain
     host loop, 4 iterations each (20 before phase 13, 10 before phase
     14, 6 before phase 17); (d) --bigmodel with
     float32 and bfloat16 vectors against the same plain run; (e) phase 4's training with --refresh_linearized; (f)
     the empirical Fisher over 8 per-example gradients with a bf16 G, the
     kernel pair against its plain versions and an f32 G; (g) every new
     path on gpt2-tiny, card against CPU; one {"curvature_ext": ...} line.
 10. the trained-checkpoint path on GPT-2 124M, on the card machine's own
     Python standard library as a byte corpus, every checkpoint in a
     temporary directory: (a) Adam through cli.train.main over ADAM_N
     batches for two epochs, saving the checkpoint: step 0 near ln 50257,
     the loss halved; then over RESUME_N batches, two epochs uninterrupted
     against one epoch with --save_state and one resumed: the states
     reloading equal to the ones in memory with steps M and 2M, the resumed
     losses tracking the uninterrupted ones; an Adam step's gradient and
     update by CUDA events; (b) the host-loop spectrum of the checkpoint and
     of the init on one batch, 6 iterations (20 before phase 13, 10 before
     phase 14; the same depth for phase 11's CLI runs) (weights summing to 1, lambda_max above
     init's) and the f32 HVP at the checkpoint against a float64 central
     difference; (c) phase 4's LanczosSGD from the checkpoint: step 0's
     loss equal to the checkpoint's, each rank-k kernel once per step; (d)
     gpt2-tiny Adam with accumulation and linear decay, card against CPU,
     and checkpoints loading across the two; one {"trained_checkpoint":
     ...} line.  Phases 7-10 pin --hvp_precision high: their gates hold
     fp32 HVPs, and the CLI's default "auto" may pick a lower tier.
 11. the precision ladder, inside phase 10's temporary directory, on one
     stdlib batch of bs8 x seq512: (a) at init and on the 600-step
     checkpoint, the reorthogonalised probe (3 iterations, 10 before phase 13, 6
     before phase 14, 4 before phase 16;
     CGS2 on the
     rank-k pair) of the bf16, TF32 and "high" tiers against the "highest"
     referee: bf16 and TF32 differ from fp32, bf16 errs more than TF32 at
     init, "high" equals "highest" bit for bit, and an HVP with block 0 alone
     at TF32 differs from all-fp32 and all-TF32; (b) cli.spectrum
     --hvp_precision auto on the checkpoint: the plan names its arms, the
     chosen one within 1e-3 or the referee, its file next to the checkpoint,
     reused with no probe, probed again with --reprobe; and at init; (c)
     --precision_check with --hvp_precision default warns iff its error
     passes 2e-3; (d) the fp32 referee against blocks in float64 and
     against the whole model in float64; (e) phase 4's LanczosSGD from the
     checkpoint with --refresh_precision auto --precision_recheck 1: the
     guard's events, each rank-k kernel once per step plus the probes' CGS2
     launches; (f) gpt2-tiny card against CPU: --hvp_precision high with
     --precision_check, and --bf16 Adam losses; one {"precision": ...} line.
 12. the rest of training on GPT-2 124M at phase 4's batches, fp32: (a)
     phase 4's run with --optimiser lanczos (the fused step, CGS2, an f32
     (10, P) basis), 2 steps (4 before phase 16): each kernel once per step
     at (10, P) f32, step 0's loss and eig_max as phase 4's; (b) --optimiser gn and ngd, 1 step each
     (2 before phase 13) at
     --damping 1e-3 --cg_iters 10 (20 before phase 16): finite, cg_iters
     <= 10, no rank-k
     launch, and a GN step's reported CG residual recomputed from a fresh
     GGN matvec; (c) HostLayerwiseLanczosSGDTrainer on wte and the first 4
     of the 24 MLP kernels in flat order (all 24 before phase 14, 8 before
     phase 16; bf16 bases, k=4, refresh_every 2, 2 steps): 5 launches of each kernel per
     step, finite Ritz values, lambda_max > 0 on wte, the frozen step equal
     to a plain-version replay, and the plan (path, alignment of g) of each
     of a step's 9 per-leaf launches printed; (d)
     the fused layer-wise step on wte alone: its extremes as (c)'s; (e)
     Adam with --snapshot_every 1 and --post_spectrum_iters 6 (10 before
     phase 14): the T files
     and the eigenspace read back; (f) project_gradients and frozen_spectral_adjust
     with an orthonormal (10, P) basis in f32 and bf16 against the plain
     version; (g) torch.profiler around one HVP, summarized by
     obs.trace_summary; (h) gpt2-tiny card against CPU for every new
     optimiser and flag, and --tensorboard (or its exit naming the missing
     package); one {"train_ext": ...} line.
 13. the other language-model families through cli.spectrum.main and
     cli.train.main at fp32 HVPs, on one stdlib batch: (a) Pythia-1.4B (P =
     1,414,647,808) at full width and depth, --host_loop --bigmodel with
     bf16 Krylov vectors, 1 x bs1 x seq512, 4 iterations (15 before phase
     15, 10 before phase 16, 6 before phase 17): finite Ritz
     values, lambda_max > 0 > lambda_min, the weights summing to 1 within
     1e-6, |trace| <= 1e-2 lambda_max, the artifact read back, no rank-k
     launch; its peak memory, seconds per iteration and init seconds (drawn
     on the card; the same init drawn on the CPU and moved took 11.42 s
     when it was last read, before phase 14); (b) LanczosSGD on
     Pythia-1.4B, k=4, a bf16 basis, delta 1e4,
     bs1, seq512 (seq256 if 512 does not fit, printed), one refresh and one
     frozen step: each rank-k kernel once per step at (4, 1,414,647,808)
     bf16, finite losses; on the frozen step the trainer's pass-1 w within
     1e-5 of the plain w, its adjusted gradient within 1e-5 (plus the f32
     rounding of g + term, itself <= 1e-3) of the plain one, both relative
     to the adjust term, and the update within 1e-5 of a plain replay; (c)
     LLaMA-134m, 1 x bs8 x seq512, 4 iterations (20 before phase 15, 10
     before phase 16, 6 before phase 17) with
     (a)'s gates, its f32
     HVP against a float64 central difference within 2e-5, and phase 4's
     LanczosSGD for 2 steps (4 before phase 16) with each kernel once per
     step at (10, 134,105,856)
     bf16; (d) gpt2-moe (80M, 8 dense experts), 1 x bs8 x seq512, 6
     iterations with (a)'s gates; (e) llama-tiny (grouped-query attention),
     pythia-70m at bs1 x seq16 and gpt2-tiny --experts 4, dense and with
     --moe_top_k 2, card against CPU through both CLIs (Ritz extremes within
     1e-3, the trainer's first loss within 1e-5; the top-k runs warn), and
     LanczosSGD over llama-tiny's rank-4 LoRA adapters (the rank-k pair on
     the adapters' P); one {"lm_families": ...} line.
 14. the vision models at their CIFAR-10 widths on random images (both data
     directories pointed at empty temporary ones, so the loaders fall back
     as the JAX CLI does, printed): (a) VGG-16 (P = 33,638,218) through
     cli.spectrum.main, bs128 x 4 batches, --host_loop, 6 iterations (20
     before phase 15, 10 before phase 16) at
     fp32 HVPs, with 13a's gates; (b) ResNet-50 (P = 23,528,522) the same
     way with BatchNorm in eval and in train mode (--bn_train_mode), both
     passing (a)'s gates, their lambda_max differing; (c) on one batch, the
     f32, bf16 ("default") and TF32 HVPs against a float64 HVP and a
     float64 central difference (step 1e-6): the float64 HVP of VGG-16 and
     of ResNet-50 (BN eval) within 2e-5 of the difference, their f32 HVP
     within 5e-3 of the float64 HVP (at init on random images it lies
     9e-4 to 3e-3 from float64 on the card and on the CPU alike, the
     models' own conditioning), the bf16 and TF32 HVPs beyond both limits
     (the convolutions take the precision tier), the f32 HVP nearest the
     float64 one; ResNet-50 in BN train mode read (ReLU kinks within the
     step) but for that last gate; (d) LanczosSGD through cli.train.main on
     each (ResNet-50 in BN eval mode), k=10, a bf16 basis, delta 1e4, 4
     steps: each rank-k kernel once a step at (10, P) bf16, rows not
     16-byte aligned, and the frozen step against the plain versions as
     13b's, with the update resolved in f32; (e) spiral, SimpleNet (on MNIST
     idx files written from seeded numpy), VGG-16 and ResNet-50 at bs4, card
     against CPU through both CLIs (spectra of 6 iterations, 8 before
     phase 15, their Ritz extremes within 1e-3; training losses within
     1e-5, the trainers' Ritz values within 1e-3);
     one {"vision": ...} line.
 15. the remaining CLIs, on seeded random CIFAR-10 pickles and MNIST idx
     files written to temporary directories: (a) cli.forget at its defaults
     on the spiral (600 Adam steps on task A, a plain k=10 Lanczos basis),
     task B 10 epochs, on the card and on the CPU from the same draws: task
     A's params after 30 steps within 1e-5 rel-L2 (read after 100, 300 and
     600); from the card's task-A params on the CPU, acc_a0 equal, the CPU's
     basis's Ritz values within 1e-3 of max |lambda| of the card's and the
     task-B phases on the card's basis with every tracked accuracy within
     2/600; (b) cli.forget on VGG-16 at full convolutional width (the CLI's
     256-wide classifier, P = 14,913,093), 256 images a task, task A 40
     Adam steps at lr 1e-4 with cuDNN's deterministic algorithms, task B at
     the CLI's lr 0.1 in minibatches of 64, a k=10 basis by --thick_restart:
     converged, an independent residual per pair within 1e-2 of max |lambda|,
     the rows within 5e-3 of orthonormal, the first projected step's
     projection within 1e-5 of the plain version and its update within 1e-5
     of the f32 momentum step replayed from the plain projection (and from
     the kernels' own), phase 3 timing the pair at (10, 14,913,093) f32; (c)
     cli.forget on SimpleNet, task B permuted and noisy; every forget run:
     the npz's six keys, ab_overlap in [0, 1], the projected phase's whole
     parameter change within 1e-3 of orthogonal to the basis (float64, the
     plain product), and on the card no rank-k launch in task A or the
     baseline and each kernel once per projected step; (d) cli.evaluate on
     GPT-2 124M, 4 x bs8 x seq512 random tokens (mean loss within 0.5 of ln
     50257, the pickle read back) and on VGG-16 (the per-batch losses within
     1e-6 of a plain recount on the workload, no accuracy line, as the JAX
     CLI); (e) cli.sweep over two learning rates and
     cli.hpo's two TPE trials of fused LanczosSGD on the spiral: finite
     losses, both kernels launched in every point; (f) `python -m
     hessian_llm_vision_tpu_torch devices-info --json` in a subprocess (a
     "gpu" row per card with its name and memory), the dispatch's help and
     its exit 2 on an unknown command; one {"remaining_clis": ...} line.
 16. the data axis (parallel/) on GPT-2 124M at full width: (a) a NCCL
     group of one rank from dist_init.initialize over an in-process store
     (one card admits one NCCL rank), 1 x bs8 x seq512: the sharded loss's
     gradient and HVP (through NCCL's all-reduce) within 1e-5 of the
     unsharded ones and a 4-iteration host-loop spectrum over it within
     1e-4 (bit for bit printed), no rank-k launch; (b) two gloo ranks
     spawned on this card (parallel/spawn.py), the global batch of 8
     sequences of 256 tokens split 4 + 4: the DP HVP within 1e-5 of one
     process's HVP of the whole batch, its time with the gloo transfer of a
     P-vector on CUDA tensors timed apart; the Lanczos with the basis split
     along P, (10, 62,023,296) f32 a rank, each CGS2 projection pass 1 on
     the rank's block, an all-reduce of w, pass 2 (each kernel 20 times a
     rank), T within 1e-4 and Ritz values within 1e-3 of rank 0's unsharded
     run, each rank's pair against its plain version (1e-5, bit for bit
     repeated, pass 1's aligned ring); --probe_parallel --probes 2 through
     cli.spectrum.main on both ranks equal to --probes 2 in one process
     within 1e-4, rank 0 alone printing the report and writing the
     artifact; the ranks without JAX; one {"data_axis_two_ranks": ...} line.
 17. the model axis (parallel/) on the same two gloo ranks (16b, 17 and 18
     share one spawn, which saves the ranks' start), each building the whole model from its seed on the card and keeping
     its part, rank 0 also running the whole-model references (in the
     ranks 17c runs first, on an empty card, then 17a, 17b, 17e, 18 and
     17d): (a) GPT-2
     124M (1024 positions, P = 124,439,808) tensor-parallel over 2, 2 x
     bs2 x seq512: loss within 1e-6, the gathered gradient and HVP within
     1e-5, the HVP's seconds and one more HVP's with the model's gloo
     collectives timed apart,
     each rank about half of the split leaves' bytes; a 10-iteration
     Lanczos with its basis on the model axis, (10, 62,219,904) f32 a rank,
     each CGS2 projection pass 1 on the rank's block, an all-reduce of w,
     pass 2 (each kernel 20 times a rank), T within 1e-4 and Ritz values
     within 1e-3 of the whole model's, the pair against its plain version
     there (1e-5, bit for bit repeated, pass 1's aligned ring); (b) the same
     model sequence-parallel over 2 at bs1 x seq1024: loss, gradient and
     HVP; (c) Pythia-1.4B tensor-parallel over 2 (embed_in and embed_out
     vocab-parallel) on 13b's weights and first batch: the loss within 1e-6
     of 13b's step 0, one gradient and two HVPs through inner products
     with seeded vectors u, |x.u - y.u| sqrt(P) / (|y| |u|) within 1e-5
     (the whole vectors' bar: an error e of y moves y.u by about
     e |y| |u| / sqrt(P)); the unsharded ones come after 13b from its
     weights drawn again from the seed and its first batch, outside 13b's
     timings and peak, so no second unsharded training run; 13b's first
     refresh (4 iterations from the gradient) within 1e-4, each rank's
     parameter bytes
     and peak; (d) gpt2-moe expert-parallel over 2, dense and top-2 gating,
     bs4 x seq256: loss, gradient and HVP; (f) then the same models expert-
     and sequence-parallel on the one axis, held to (d)'s whole-model
     references at (d)'s bars, half of the experts' bytes a rank; every
     phase 16-18 prints the collective path it took (native on 16a's NCCL
     rank, padded/broadcast on the gloo ranks); (e) GPT-2 124M tensor- and
     sequence-parallel on the one model axis at 17b's bs1 x seq1024, held
     to 17b's whole-model references: loss, gradient and HVP, half of the
     split leaves' bytes a rank, one more HVP with the model's gloo
     collectives timed apart; the ranks without JAX; one
     {"model_axis_two_ranks": ...} line, which also holds phase 18.
 18. the pipeline (parallel/pipeline.py) in the same spawn, after 17e:
     GPT-2 124M (1024 positions) pipelined over 2 stages of 6 blocks on a
     1 x 2 ('data', 'pp') mesh, 17a's batch in 2 microbatches (a GPipe
     bubble of 1/3), held to 17a's whole-model references: loss within
     1e-6, gathered gradient and HVP within 1e-5, half of the block bytes a
     rank; one more HVP with the shifts and the exit (broadcasts) and the
     gradient sums (all-reduces) timed apart; a 10-iteration Lanczos from
     17a's start vector with its basis on the pipeline axis, (10,
     62,219,904) f32 a rank (its stage's blocks and half of the replicated
     leaves), each kernel 20 times a rank, T within 1e-4 and Ritz values
     within 1e-3 of 17a's whole-model Lanczos, the basis's first row the
     start vector, the pair against its plain version there (1e-5, bit for
     bit repeated, pass 1's aligned ring); then one HVP of the plain pipeline
     and one with remat_ticks=True, each from a peak reset: the remat HVP
     within 1e-6 of 18's own, each rank's two peaks printed.
 19. (run after phase 6, on its GPT-2 124M model and params, seed 0, 512
     positions) (a) one HVP on each of three arms at bs16 x seq512 (bs8 if
     an arm does not fit, printed): dense attention and logits; query
     blocks and loss chunks of 128 rematerialised (the JAX defaults); the
     same blocks and chunks without remat; and the whole loss as one
     rematerialised region (hvp_fn(remat=True)): each within 1e-5 of the
     dense HVP, the two blocked arms equal bit for bit (or the difference
     printed), the remat arm's peak below the plain blocked arm's; each
     arm's HVP ms (CUDA events after a warm call) and peak beside the
     reckoned bytes of one layer's scores and of the logits; (b) phase 4's
     LanczosSGD through cli.train.main with --attn_block_q 128
     --loss_chunk 128 for a refresh and a frozen step: step 0's loss
     within 1e-5 and lambda_max within 1e-3 of phase 4's, each kernel once
     a step at (10, 124,046,592) bf16; (c) TF32 under --linearized: the
     auto ladder resolved for --linearized probes its blocks-TF32 rung,
     and at bs4 x seq512 the linearized HVP under blocks-TF32 (outer
     "high") lies within 1e-5 of the eager HVP under that spec and farther
     than that from the fp32 linearized HVP (the same traced graphs
     replayed with TF32 off), its graphs holding the head's products as
     flag_einsum nodes; (d) dropout 0.1:
     deterministic=True equals dropout 0 bit for bit, deterministic=False
     differs and repeats bit for bit from one generator seed, one c_proj
     output keeps 0.9 +- 0.01 of its entries, each scaled by 1/0.9.
Phase 3 also checks (4, 124,046,592) in both dtypes, (8, 124,046,592) and
(16, 124,046,592) in bf16 -- the deflation projector's, the empirical
Fisher's and the CGS2 pass's shapes, timed only (4, P) in bf16 since phase 13
-- and times phase 12's per-leaf shapes (4, 2,359,296) and (4, 38,597,376)
in both dtypes, phase 14's (10, 33,638,218) and (10, 23,528,522) in both
dtypes (P = 2 mod 8: every row after the first off 16 bytes, pass 1's
shifted ring, pass 2's direct kernel without vector loads) and 13b's
(4, 1,414,647,808) in bf16, the first with k x P
>= 2**31 at full width (V alone 11.3 GB), where pass 1 is held to a
float64 w on two draws (within 1e-5 and no farther than cuBLAS's f32 sum,
which on some draws lies 1e-5 off itself), and 15b's (10, 14,913,093) in
f32 (P = 5 mod 8, the same two paths), 16b's (10, 62,023,296) in f32
(each rank's half of P) and 17a's (10, 62,219,904) in f32 (each model
rank's block, and each pipeline rank's in phase 18); it checks small leaves at
unaligned offsets of g, the bf16 MLP leaf with g 1-7 elements off 16
bytes, and (256, 2**24) bf16, whose pass 2 sweeps each chunk's rows in 22
stages.  Then pass 1's alignment sweep: f32 and bf16 bases, V's base off
16 bytes by every element offset, g's by 0-3 elements, P of every class
mod the 16-byte vector (a few chunks long, and 1 to 8), k in 1, 3, 10, 17,
35 -- 3200 points, each within 1e-5 rel-L2 of the plain version (or, where
the two f32 sums of a w near zero differ more, within 1e-5 of the size of
its terms from a float64 w), bit for bit on repeat and as on fresh copies
of V and g, the aligned ring exactly where V, g and P are whole 16-byte
vectors, no call reaching the plain version.  Every phase prints its wall
seconds on a line of its own.  Then it prints one JSON line of kernels
(launches per path), the card line, and finally {"ok": true, "device":
{...}}.

Imports torch, numpy and the port only (no JAX: the card machine has none);
16b's, 17's and 18's ranks import this file for ``axes_rank``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Optional

import numpy as np
import torch

P_124M = 124_046_592  # GPT-2 124M parameters at n_positions 512
TIMED_DTYPES = (torch.bfloat16, torch.float32)
# k timed at P = 124M (10: the trainer's); (35, P) is checked untimed, to
# leave room for phase 13 (its last times stand in PERF.md)
TIMED_KS = (10,)
# the deflation projector's rows (--kpm_deflate 4), the empirical Fisher's
# 8 per-example gradients and the CGS2 pass's widest (16 filled rows of the
# deflation's inner-16 buffer), in bf16; k = 4 also in f32, so every timed k
# is read in both dtypes
PATH_SHAPES = ((torch.bfloat16, 4), (torch.float32, 4), (torch.bfloat16, 8), (torch.bfloat16, 16))
# of those, timed: (4, P) bf16, the k of 13b's Pythia-1.4B shape; the others
# are checked untimed (their last times stand in PERF.md)
PATH_TIMED = ((torch.bfloat16, 4),)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# calls per host-time reading (a quarter of it at P = 124M; 200 before phase 19)
COST_CALLS = 100
FP32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
KERNEL_SRC = "hessian_llm_vision_tpu_torch/ops/csrc/rank_k.cu"
TPU_KERNELS = {
    "rank_k_dots": "hessian_llm_vision_tpu/ops/spectral.py:130",  # _dots_kernel
    "rank_k_axpy": "hessian_llm_vision_tpu/ops/spectral.py:155",  # _axpy_kernel
}
TRAIN_ARGV = [
    "--model", "gpt2", "--optimiser", "lanczos-host", "--dataset", "random",
    "--batch_size", "8", "--max_length", "512", "--num_batches", "4",
    "--k", "10", "--delta", "1e-4", "--lr", "1e-3", "--momentum", "0.9",
    "--refresh_every", "2", "--lanczos_momentum", "0.9", "--max_steps", "4",
    "--seed", "0",
]
# bench.py's headline job (4 batches x bs8 x seq512, T-only
# dataset-mean host loop; --fused_iter is bench.py's flag, one path here), in fp32
# (every spectrum of phases 7-10 pins --hvp_precision high: the fp32 HVPs
# its gates were set on; the CLI's default "auto" may pick bf16 or TF32)
SPECTRUM_ARGV = [
    "--model", "gpt2", "--dataset", "random", "--num_batches", "4", "--batch_size", "8",
    "--max_length", "512", "--attn_block_q", "512", "--loss_chunk", "512",
    "--lanczos_iters", "10", "--host_loop", "--fused_iter", "--vector_seed", "997",
    "--hvp_precision", "high",
]
HEADLINE_ITERS = 10  # bench.py's 35, cut to leave room for phase 16 (15) and 17 (10)
TINY_SPECTRUM_ARGV = [
    "--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "32", "--num_batches", "2",
    "--lanczos_iters", "12", "--vector_seed", "5", "--hvp_precision", "high",
]
# the JAX package's committed 124M spectrum (3 probes, mixed precision, its own weights)
JAX_SPECTRUM = "artifacts/slq_multiprobe_r3/spec.npz"
# 7a: card against CPU on gpt2-tiny (readings 3.4e-7 and 2.6e-7 for the
# extremes, PERF.md); the alphas only before late steps amplify rounding
CARD_CPU_LAMBDA_RTOL = 1e-5
CARD_CPU_EARLY_ALPHAS = 3
CARD_CPU_ALPHA_TOL = 1e-5  # of max |lambda|
# phase 8: GPT-2 124M, one batch of bs8 x seq512, true fp32 HVPs
EXT_BASE = [
    "--model", "gpt2", "--dataset", "random", "--num_batches", "1", "--batch_size", "8",
    "--max_length", "512", "--attn_block_q", "512", "--loss_chunk", "512",
    "--hvp_precision", "high", "--vector_seed", "997",
]
# artifacts/trlan124m_r3's protocol (random tokens, true fp32)
TR_ARGV = EXT_BASE + ["--thick_restart", "5", "--lanczos_iters", "15", "--tr_dtype", "bfloat16",
                      "--tr_tol", "2e-3"]
# artifacts/kpm_deflate124m_r3's flags, cut to 1 x bs8, 1 probe and (for
# phase 13's time) 20 moments, from 60 (30 before phase 14)
KPM_MOMENTS = 20
KPM_ARGV = EXT_BASE + ["--host_loop", "--lanczos_iters", "35", "--kpm", str(KPM_MOMENTS),
                       "--kpm_probes", "1", "--kpm_deflate", "4", "--tr_dtype", "bfloat16",
                       "--tr_tol", "2e-3"]
# 9 matvecs of Hutch++ (30 before phase 13, 15 before phase 17)
HUTCHPP_MATVECS = 9
HUTCHPP_ARGV = EXT_BASE + ["--lanczos_iters", "10", "--hutchpp", str(HUTCHPP_MATVECS)]
TR_RESIDUAL_LIMIT = 1e-2  # of max |lambda|, independent residual per pair
TR_ORTHO_LIMIT = 5e-3  # max |V V^T - I|: the bf16 storage floor
SPIKE_SLQ_RTOL = 1e-3
BULK_WIDEN = 0.05  # of the SLQ range, on each side
MU0_TOL = 1e-6
KPM_STAGE_MATVECS = 12 + KPM_MOMENTS - 1  # range estimate + the moments' recurrence
# 8d: gpt2-tiny card against CPU
TINY_EXT = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "32", "--num_batches",
            "2", "--vector_seed", "5", "--hvp_precision", "high"]
EXT_EIG_RTOL, EXT_MOMENT_ATOL, EXT_HUTCHPP_RTOL = 1e-5, 1e-5, 1e-4
# 7c: step along the unit start vector of the float64 central difference,
# and the rel-L2 limit of the f32 HVP (and of alpha_1) against it: about
# 10x the f32 reading 2.1e-6, 75x below the TF32 reading 1.5e-3 (PERF.md)
FD_EPS = 1e-4
HVP_FD_LIMIT = 2e-5
# phase 9: GPT-2 124M at EXT_BASE's 1 x bs8 x seq512
# 9a: 3 iterations per block (10 before phase 13, 5 before phase 14, 4
# before phase 16), 36 masked HVPs
LW_ITERS = 3
LW_ARGV = EXT_BASE + ["--layerwise", "--layerwise_group", "block", "--host_loop",
                      "--lanczos_iters", str(LW_ITERS)]
GGN_ITERS = 12  # 20 before phase 17
GGN_ARGV = EXT_BASE + ["--operator", "ggn", "--host_loop", "--lanczos_iters", str(GGN_ITERS)]
# 9c/9d: 4 iterations per run (20 before phase 13, 10 before phase 14, 6
# before phase 17)
PLAIN_ITERS = 4
PLAIN_ARGV = EXT_BASE + ["--host_loop", "--lanczos_iters", str(PLAIN_ITERS)]
LW_TRACE_TOL = 1e-2  # |trace| over max(1, max |lambda|) per block (the golden test's)
LW_T_RTOL = 1e-5  # h_0's T against the in-core operator, of max |T|
GGN_PSD_TOL = 1e-4  # lowest Ritz value >= -tol * lambda_max
# rel-L2 of the GGN matvec against the explicit product: about 10x the
# first card reading, 2.1e-7 (PERF.md)
GGN_INDEP_LIMIT = 2e-6
LIN_RTOL = 1e-4  # linearized against the plain loop, extremes of max |lambda|
BIG_RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
TRAIN_LIN_RTOL = 1e-3  # 9e loss and eig_max against phase 4's
EF_N = 8
EF_PLAIN_RTOL = 1e-5  # kernel pair against its f32 plain version, same G
EF_BF16_RTOL = 2e-2  # against the JAX-rounding plain version and an f32 G
EF_RECOMPUTED_RTOL = 1e-3  # a recomputed bf16 G may round a few entries apart
TINY_NEW_RTOL = 1e-5  # 9g card against CPU, extremes of max |lambda|
# phase 10: the trained-checkpoint path on GPT-2 124M.  The corpus is the
# card machine's own Python standard library as bytes, the corpus of the
# JAX package's trained-124M protocol; 10a trains on ADAM_N of its batches.
# 2 x ADAM_N = 600 steps (1000 before phase 16): on this corpus lambda_max
# first falls below the init's (0.44x after 200 steps) and sharpens past it
# later (16.6x it after 600 steps; PERF.md)
STDLIB = os.path.dirname(os.__file__)
ADAM_N = 300
# dense attention and logits since phase 19 (the JAX protocol's 256-query
# blocks and 256-position chunks, now rematerialised, cost ~20-100% more a
# step by host; 19b drives the blocked path, and its values are the same)
ADAM_ARGV = ["--model", "gpt2", "--batch_size", "8", "--max_length", "512",
             "--optimiser", "adam", "--lr", "1e-3",
             "--num_batches", str(ADAM_N), "--dataset", f"local:{STDLIB}"]
# 10a: the resumed run's per-step losses against the uninterrupted run's;
# the first card reading was 0.0 (bit-identical over 200 steps), so the
# gate allows only last-bit differences.  The save/resume split runs on the
# first RESUME_N batches (2 x RESUME_N steps, split at an epoch), beside the
# 2 x ADAM_N-step run that makes the checkpoint (20 batches before phase 15).
RESUME_LOSS_ATOL = 1e-6
RESUME_N = 10
# 6 iterations (20 before phase 13, 10 before phase 14), to leave room for them
CKPT_BASE = ["--model", "gpt2", "--dataset", f"local:{STDLIB}", "--num_batches", "1",
             "--batch_size", "8", "--max_length", "512", "--host_loop", "--lanczos_iters", "6"]
CKPT_SPECTRUM_ARGV = CKPT_BASE + ["--hvp_precision", "high"]
# 10b: the f32 HVP at the checkpoint against the float64 difference, gated
# at 10x its first reading at this depth: 2.83e-4 at 600 steps, 14x 7c's
# limit at init (at 1000 steps it read 6.45e-3 and the gate was 6.5e-2;
# the difference's own truncation read 2.5e-7 there): a finding for the
# precision ladder (ROADMAP A11)
CKPT_FD_LIMIT = 2.9e-3
CKPT_LOSS_RTOL = 1e-5  # 10c step 0 against the checkpoint's loss computed directly
TINY_ADAM_ARGV = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "32",
                  "--optimiser", "adam", "--num_batches", "5", "--accumulation_steps", "2",
                  "--linear_decay_steps", "10"]
TINY_ADAM_RTOL = 1e-5  # 10d card against CPU, per-step losses
# phase 11: the precision ladder at the init and the 600-step checkpoint,
# GPT-2 124M, one stdlib batch of bs8 x seq512
PROBE_ITERS = 3  # reorthogonalised Lanczos iterations per probe arm (10 before phase 13,
# 6 before phase 14, 4 before phase 16)
PROBE_ARMS = ("default", "TF32_TF32_F32", "high")  # against the "highest" referee
# 11b/11c: each probe arm runs PRECISION_CHECK_ITERS reorthogonalised
# iterations (the CLI's default 10 before phase 16)
PRECISION_CHECK_ITERS = 6
AUTO_ARGV = CKPT_BASE + ["--hvp_precision", "auto", "--precision_check_iters",
                         str(PRECISION_CHECK_ITERS)]
AUTO_TOL = 1e-3  # the planner's bar on the chosen arm's extreme-Ritz error
CHECK_BAR = 2e-3  # report_precision_probe's bar
GUARD_RITZ_ITERS = 8  # RefreshPrecisionGuard's default probe depth
# 11f: gpt2-tiny --bf16 Adam, card against CPU.  Step 0 is one forward of
# the same params: bf16 products round once per output on both devices
# (the card matched the CPU bit for bit), while the f32 loss lies 1.7e-5
# from the bf16 one, so the limit tells --bf16 from a card that ignored it
# (the f32 control run is gated to miss it).  Adam's normalised update
# turns the devices' rare rounding flips into lr-sized steps (1.6e-5 after
# 2 steps), as large as the bf16/f32 gap: the later steps are held to a
# drift bound, not to the control.
TINY_BF16_ARGV = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "32",
                  "--optimiser", "adam", "--num_batches", "3", "--bf16"]
TINY_BF16_STEP0_RTOL = 2e-6
TINY_BF16_DRIFT_RTOL = 1e-4
# phase 12: the rest of training on GPT-2 124M at TRAIN_ARGV's batches
# (random tokens, bs8 x seq512, seed 0), fp32 HVPs as in phases 7-10
# 12a: phase 4's run with the fused step, 2 steps (a refresh and a frozen
# step; 4 before phase 16)
FUSED_STEPS = 2
FUSED_ARGV = list(TRAIN_ARGV)
FUSED_ARGV[FUSED_ARGV.index("lanczos-host")] = "lanczos"
FUSED_ARGV[FUSED_ARGV.index("--max_steps") + 1] = str(FUSED_STEPS)
FUSED_LOSS_RTOL = 1e-5  # 12a step 0 against phase 4's step 0 (same params and batch)
FUSED_EIG_RTOL = 1e-3  # 12a step 0's eig_max (CGS2) against phase 4's (no reorthogonalization)
SECOND_ORDER_ARGV = ["--model", "gpt2", "--dataset", "random", "--batch_size", "8",
                     "--max_length", "512", "--num_batches", "2", "--max_steps", "2",
                     "--seed", "0", "--cg_iters", "10"]  # --damping 1e-3, the default
CG_MAX_ITERS = 10  # the CLI's default 20 before phase 16
SECOND_ORDER_STEPS = 1  # gn and ngd steps each in 12b (2 before phase 13)
CG_RESIDUAL_RTOL = 1e-3  # reported ‖r‖ against ‖(G + λI)x − g‖ from a fresh matvec
# 12c/12d: min_leaf_size 2,000,000 keeps wte and the 24 MLP kernels (2,359,296
# each), of which 12c adjusts wte and the first 4 MLP kernels in flat order
# (all 24 before phase 14: 100 masked HVPs a refresh; 36 before phase 16,
# 20 now); 3,000,000
# keeps wte alone (38,597,376)
LAYER_MIN_LEAF = 2_000_000
WTE_MIN_LEAF = 3_000_000
LAYER_LEAVES = 5
LAYER_K = 4
REPLAY_RTOL = 1e-5  # 12c frozen step's update against a plain-version replay
WTE_RITZ_RTOL = 1e-3  # 12d wte extremes against 12c's
SNAPSHOT_ITERS = 6  # 12e's snapshots and post-training spectrum (10 before phase 14)
SNAPSHOT_ARGV = SECOND_ORDER_ARGV + ["--optimiser", "adam", "--snapshot_every", "1",
                                     "--snapshot_iters", str(SNAPSHOT_ITERS),
                                     "--post_spectrum_iters", str(SNAPSHOT_ITERS)]
PROJECTION_RTOL = 1e-5  # 12f kernel against the plain version
PROJECTION_LEAK = 1e-3  # ‖V g_out‖ / ‖g‖ after project_gradients
TRACE_TOP = 10
# 12h: gpt2-tiny, card against CPU, knobs as tests/test_torch_train_ext_cli.py
TINY_TRAIN_EXT = ["--model", "gpt2-tiny", "--batch_size", "4", "--max_length", "32",
                  "--num_batches", "2", "--log_every", "1"]
TINY_TRAIN_CASES = {
    "lanczos": ["--optimiser", "lanczos", "--k", "4", "--delta", "10", "--lr", "0.01",
                "--refresh_every", "2", "--lanczos_momentum", "0.5", "--max_steps", "3"],
    "lanczos-layer": ["--optimiser", "lanczos-layer", "--k", "3", "--delta", "10", "--lr",
                      "0.01", "--max_steps", "2"],
    "lanczos-layer-host": ["--optimiser", "lanczos-layer-host", "--k", "3", "--delta", "10",
                           "--lr", "0.01", "--refresh_every", "2", "--lanczos_momentum", "0.5",
                           "--max_steps", "3"],
    "gn": ["--optimiser", "gn", "--lr", "0.5", "--damping", "1", "--cg_iters", "8",
           "--max_steps", "2"],
    "ngd": ["--optimiser", "ngd", "--lr", "0.5", "--damping", "1", "--cg_iters", "8",
            "--max_steps", "2"],
    "adam_snapshots": ["--optimiser", "adam", "--max_steps", "2", "--snapshot_every", "1",
                       "--snapshot_iters", "6", "--post_spectrum_iters", "6"],
}
TINY_TRAIN_LOSS_RTOL = 1e-5
TINY_TRAIN_RITZ_RTOL = 1e-3
# phase 13: the other language-model families at full width, every run
# through a CLI at fp32 HVPs on the card machine's stdlib bytes (phase 10's
# corpus), one batch
PYTHIA_P = 1_414_647_808  # Pythia-1.4B: 2048 wide, 24 layers, untied 50304-token head
LLAMA_P = 134_105_856  # llama-134m
LM_BASE = ["--dataset", f"local:{STDLIB}", "--num_batches", "1", "--hvp_precision", "high",
           "--vector_seed", "997"]
LM_GAMMA_TOL = 1e-6  # |sum of the SLQ weights - 1|
# 13a: artifacts/pythia1p4b_r3's protocol (bs1, --bigmodel with bf16 Krylov
# vectors, 15 iterations) at seq512, cut to 4 iterations to leave room for
# phases 15-17; the JAX package cut it to seq256 only to fit a 16 GB chip
PYTHIA_SPECTRUM_ARGV = ["--model", "pythia-1.4b", "--batch_size", "1", "--max_length", "512",
                        "--host_loop", "--bigmodel", "--lanczos_iters", "4"] + LM_BASE
# 13b: LanczosSGD at full width, k=4, a bf16 basis, one refresh and one
# frozen step (--max_length is added: 512, or 256 if 512 does not fit).
# delta 1e4 (> 10 max |lambda|) makes the adjust coefficients 1/lambda -
# 1/(lambda + delta) near 1/lambda; at the CLI's default 1e-4 they are
# about 1e-10 and the term vanishes in the f32 rounding of g + term, so no
# comparison of the step could see the kernel pair's part in it
PYTHIA_TRAIN_ARGV = ["--model", "pythia-1.4b", "--dataset", f"local:{STDLIB}", "--num_batches",
                     "2", "--batch_size", "1", "--optimiser", "lanczos-host", "--k", "4",
                     "--basis_bf16", "--lanczos_momentum", "0", "--refresh_every", "2",
                     "--max_steps", "2", "--delta", "1e4", "--lr", "1e-3", "--seed", "0"]
TERM_RTOL = 1e-5  # 13b frozen step's w and adjust term against the plain versions (phase 3's bar)
TERM_FLOOR_MAX = 1e-3  # the f32 rounding of g + term, of the term: the comparison must resolve it
# 13c, 13d: the llama134m_r3 and moe_r3 protocols, 1 x bs8 x seq512, 20
# iterations, cut to 4 to leave room for phases 15-17
LLAMA_SPECTRUM_ARGV = ["--model", "llama-134m", "--batch_size", "8", "--max_length", "512",
                       "--attn_block_q", "512", "--loss_chunk", "512", "--host_loop",
                       "--lanczos_iters", "4"] + LM_BASE
MOE_SPECTRUM_ARGV = [a if a != "llama-134m" else "gpt2-moe" for a in LLAMA_SPECTRUM_ARGV]
# phase 4's run, 2 steps (4 before phase 16)
LLAMA_TRAIN_ARGV = [a if a != "gpt2" else "llama-134m" for a in TRAIN_ARGV]
LLAMA_TRAIN_ARGV[LLAMA_TRAIN_ARGV.index("--max_steps") + 1] = "2"
# 13e: the tiny configs, card against CPU, knobs as tests/test_torch_lm_families_cli.py
TINY_FAMILIES = {
    "llama_tiny": ["--model", "llama-tiny"],
    "pythia_70m": ["--model", "pythia-70m"],
    "moe_dense": ["--model", "gpt2-tiny", "--experts", "4"],
    "moe_top2": ["--model", "gpt2-tiny", "--experts", "4", "--moe_top_k", "2"],
}
TINY_FAMILY_SPECTRUM = ["--batch_size", "1", "--max_length", "16", "--num_batches", "1",
                        "--host_loop", "--lanczos_iters", "8", "--hvp_precision", "high",
                        "--vector_seed", "5"]
TINY_FAMILY_TRAIN = ["--batch_size", "1", "--max_length", "16", "--num_batches", "2",
                     "--optimiser", "lanczos-host", "--k", "3", "--delta", "10", "--lr", "0.01",
                     "--refresh_every", "2", "--lanczos_momentum", "0.5", "--max_steps", "2",
                     "--no-basis_bf16"]
LORA_RANK, LORA_K = 4, 4
# phase 3: the per-leaf shapes of phase 12 -- k=4 on an MLP kernel and on
# wte, timed in both dtypes -- and small leaves at unaligned offsets of a
# flat gradient (gpt2-tiny's 768- and 2304-wide rows, a 2-entry leaf)
LEAF_TIMED = ((4, 2_359_296), (4, 38_597_376))
LEAF_CHECKED = ((torch.float32, 10, 768, 1), (torch.bfloat16, 10, 768, 1),
                (torch.float32, 10, 2304, 3), (torch.bfloat16, 10, 2304, 3),
                (torch.float32, 2, 2, 1),
                *((torch.bfloat16, 4, 2_359_296, offset) for offset in range(1, 8)))
# a basis of many rows on the ring: its stages hold 12 of the 256 rows, so
# pass 2 sweeps each chunk 22 times (256 x 2**24 bf16 = 8.6 GB)
ROW_SWEEP = (torch.bfloat16, 256, 1 << 24)
# 13b's shape: Pythia-1.4B's (4, P) bf16 basis, k * P = 5.66e9 >= 2**31.
# There two f32 sums over 1.41e9 terms are compared, and on some draws
# cuBLAS's alone lies 1e-5 from float64, so pass 1 is held to a float64 w
# instead, on two draws: within 1e-5, and no farther from it than the plain
# version (cuBLAS's f32 sum)
PYTHIA_SHAPE = (torch.bfloat16, 4, PYTHIA_P)
DOTS_F64_LIMIT = 1e-5
PHASE3_SEED = 1234
# phase 3's alignment sweep of pass 1: both dtypes, V's base off 16 bytes
# by every element offset (0 .. vec - 1), g's by 0-3 elements, P of every
# class mod the 16-byte vector, a few chunks long (3 x 2048 + 5 vec + class)
# and at most one vector (1 + class), k of these; each point within
# SWEEP_DOTS_LIMIT rel-L2 of the plain version, bit for bit on repeat and
# as on fresh copies of V and g.  Where the two f32 sums lie farther apart
# (a w whose terms sum to near zero: the card readings held 3 of 3200
# points up to 6.4e-4 from the plain version, the fresh copies' w the same
# bits, and either sum the nearer to float64), the point is held instead to
# a float64 w: within SWEEP_DOTS_LIMIT of the size of its terms,
# |c| (|V| |g|)
SWEEP_KS = (1, 3, 10, 17, 35)
SWEEP_DOTS_LIMIT = 1e-5
# phase 14: the vision models at their published CIFAR-10 widths, on the
# random-image path (both data directories empty).  P at 10 classes, 32x32x3:
# both are 2 mod 8, so every (k, P) basis row after the first is off 16
# bytes and the rank-k pair takes pass 1's shifted ring (each row's aligned
# interior bulk-copied, its ends loaded by the producer warp) and pass 2's
# direct kernel without vector loads
VGG16_P = 33_638_218
RESNET50_P = 23_528_522
VISION_SHAPES = ((10, VGG16_P), (10, RESNET50_P))  # phase 3, timed in both dtypes
RANDOM_IMAGES = "[data] CIFAR-10 and MNIST unavailable; falling back to random images"
# 14a/14b: the JAX package's vision_r2 / vision_r3_real protocol, bs128 x 4
# batches, fp32 HVPs, cut from its 20 iterations to 6 to leave room for
# phases 15 and 16 (at init both models' Ritz values reach -0.4 to -1 x lambda_max)
VISION_SPECTRUM = ["--batch_size", "128", "--num_batches", "4", "--host_loop",
                   "--lanczos_iters", "6", "--hvp_precision", "high", "--vector_seed", "997"]
VGG_SPECTRUM_ARGV = ["--model", "vgg16"] + VISION_SPECTRUM
RESNET_SPECTRUM_ARGV = ["--model", "resnet50"] + VISION_SPECTRUM
# 14c: one batch of 14a's; the step of the difference is 1e-6, as 7c's 1e-4
# crosses ReLU kinks of a randomly initialised ResNet-50.  With BatchNorm in
# train mode even 1e-6 crosses them at bs128 (its second- and fourth-order
# differences read 14.5% apart on the card): the difference is read there,
# not gated, and the HVPs are read against the float64 HVP
VISION_FD_BASE = ["--batch_size", "128", "--num_batches", "1", "--vector_seed", "997"]
VISION_FD_EPS = 1e-6
# 14c: at init on random images the f32 HVP itself lies 2.6e-3 (VGG-16) and
# 9.4e-4 (ResNet-50, BN eval) from the float64 HVP on the card, and as far
# on the CPU (scripts/torch_vision_hvp_witness.py), while the TF32 HVP lies
# 5.0e-2 and 1.3e-2 from it: the f32 HVP is held within this limit of the
# float64 HVP, which the bf16 and TF32 HVPs must miss
VISION_F32_LIMIT = 5e-3
# 14d: LanczosSGD, k=10, a bf16 basis, 4 steps; delta 1e4 as 13b's, so the
# adjust term stands above the f32 rounding of g + term.  The learning rate
# makes the update resolvable in f32 (at 1e-3 VGG-16's update is about a
# hundred ulps of its weights, and the replay read 1.3e-5 on rounding
# alone); ResNet-50 runs BN in eval mode, as in train mode at init its
# Ritz values (1.4e7 on the card) put the adjust term below g's rounding
# for any delta
VISION_TRAIN = ["--batch_size", "128", "--num_batches", "4", "--optimiser", "lanczos-host",
                "--k", "10", "--basis_bf16", "--refresh_every", "2", "--lanczos_momentum", "0",
                "--max_steps", "4", "--delta", "1e4", "--seed", "0"]
VGG_TRAIN_ARGV = ["--model", "vgg16", "--lr", "0.1"] + VISION_TRAIN
RESNET_TRAIN_ARGV = ["--model", "resnet50", "--lr", "0.01"] + VISION_TRAIN
# 14e: small configs, card against CPU: (model flags, spectrum batches,
# train batches, train steps); SimpleNet reads MNIST idx files the phase
# writes (MNIST_N images from seeded numpy)
MNIST_N = 64
VISION_TINY = {
    "spiral": (["--model", "spiral", "--num_points", "120", "--batch_size", "30"], [], [], 4),
    "simplenet": (["--model", "simplenet", "--batch_size", "16"], [], [], 4),
    "vgg16": (["--model", "vgg16", "--batch_size", "4"], ["--num_batches", "1"],
              ["--num_batches", "2"], 2),
    "resnet50": (["--model", "resnet50", "--batch_size", "4"], ["--num_batches", "1"],
                 ["--num_batches", "2"], 2),
}
# 6 iterations (8 before phase 15)
VISION_TINY_SPECTRUM = ["--host_loop", "--lanczos_iters", "6", "--hvp_precision", "high",
                        "--vector_seed", "5"]
# the trainers' Ritz values (3 Lanczos steps) are gated like the spectra's
# extremes; they read 2.5e-3 apart on ResNet-50 while the CPU's f32 norms
# of its 23.5M-entry vectors ran 1.3e-3 low (utils/norms.py)
VISION_TINY_TRAIN = ["--optimiser", "lanczos-host", "--k", "3", "--delta", "10", "--lr", "0.01",
                     "--refresh_every", "2", "--lanczos_momentum", "0.5", "--no-basis_bf16",
                     "--log_every", "1"]
# phase 15: the remaining CLIs.  15a: forget at the CLI's defaults on the
# spiral (width 64, depth 3, 600 points, k 10, a plain Lanczos basis, 600
# full-batch Adam steps on task A), task B 10 full-batch epochs a phase, on
# the card and on the CPU from the same draws.  Task A's params are gated
# card against CPU after the first of FORGET_TASK_A_STEPS (read at all):
# 600 Adam steps near a minimum amplify the two devices' f32 rounding (the
# Ritz values of the two runs' own task A ended 1e-2 apart).  The basis
# and the task-B phases are then gated on the CPU from the card's task-A
# params: the Ritz values over max |lambda|, the curves on the card's
# basis within two of 600 points (on each device's own basis, whose rows of
# near-zero Ritz values are ill-determined, they are read)
FORGET_SPIRAL_ARGV = ["--model", "spiral", "--epochs_b", "10"]
FORGET_TASK_A_STEPS = (30, 100, 300, 600)
FORGET_TASK_A_RTOL = 1e-5
FORGET_RITZ_RTOL = 1e-3
FORGET_CURVE_ATOL = 2 / 600
# ‖V Δθ‖ / ‖Δθ‖ of the projected phase's whole parameter change, float64
# and the plain product: with wd 0 the momentum sums projected gradients
FORGET_DRIFT_LIMIT = 1e-3
# 15b: the CLI's VGG-16 (256-wide classifier, 5 classes; P = 14,913,093 =
# 5 mod 8, so the rows of its f32 basis are not 16-byte aligned: pass 1's
# shifted ring) on seeded
# random CIFAR-10 pickles of CIFAR_PER_BATCH images each, 256 images a task
# (--subsample under one image takes the CLI's fallback of 256), task B in
# minibatches of 64 at the CLI's lr 0.1, a k=10 basis by thick restart.
# Task A at Adam lr 1e-4 (at the CLI's 5e-3 this VGG-16 without BatchNorm
# collapses to one class), with cuDNN's deterministic algorithms: 40 Adam
# steps amplify the rounding of atomic reductions, and with cuDNN's
# default ones the same inputs ended task A at lambda_max 176 to 1049 from
# run to run.  The drift gate reads the f32 rows' own distance from
# orthonormal (about 1e-7) times ||V g|| / ||g'|| (scripts/torch_forget_leak.py)
FORGET_P = 14_913_093
FORGET_SHAPE = (torch.float32, 10, FORGET_P)  # phase 3, timed
CIFAR_PER_BATCH = 200
FORGET_VGG_ARGV = ["--model", "vgg16", "--k", "10", "--thick_restart", "--tr_inner", "30",
                   "--subsample", "0.001", "--batch_size_b", "64", "--epochs_a", "40",
                   "--lr_a", "1e-4", "--epochs_b", "2"]
# the first projected step's projection against the plain version, and its
# update against the f32 momentum step replayed from the plain projection
# and from the kernels' own
FORGET_REPLAY_RTOL = 1e-5
# 15c: SimpleNet on FORGET_MNIST_N written idx images (80% for the tasks)
FORGET_MNIST_N = 1000
FORGET_MNIST_ARGV = ["--model", "simplenet", "--epochs_a", "100", "--epochs_b", "5"]
# 15d: evaluate on GPT-2 124M, 4 x bs8 x seq512 random tokens (mean loss
# within EVAL_LOSS_ATOL of ln 50257), and on VGG-16 over the written CIFAR
EVAL_GPT2_ARGV = ["--model", "gpt2", "--batch_size", "8", "--max_length", "512",
                  "--num_batches", "4"]
EVAL_LOSS_ATOL = 0.5
EVAL_VGG_ARGV = ["--model", "vgg16", "--batch_size", "128", "--num_batches", "2"]
EVAL_RECOUNT_RTOL = 1e-6
# 15e: sweep and hpo over fused LanczosSGD (--optimiser lanczos) on the
# spiral, 4 steps a point
SPIRAL_LANCZOS = ["--model", "spiral", "--max_steps", "4"]
SWEEP_GRID = ["--grid", "lr=0.01,0.05"]
HPO_TRIALS = 2
# phase 16: the data axis (parallel/).  16a: one NCCL rank, the only
# group one card admits (NCCL refuses two ranks on one GPU), over an
# in-process store, at phase 7's shape cut to 1 batch and DP_ONE_ITERS
# iterations: the sharded loss's grad, HVP and host loop, whose all-reduce
# over one rank must leave them as the unsharded ones
DP_ONE_ARGV = ["--model", "gpt2", "--dataset", "random", "--num_batches", "1",
               "--batch_size", "8", "--max_length", "512", "--attn_block_q", "512",
               "--loss_chunk", "512", "--hvp_precision", "high"]
DP_ONE_ITERS = 4
# 16b: two gloo ranks sharing the card (the only way to have two ranks on
# one GPU), GPT-2 124M at n_positions 512 (P = 124,046,592) on a global
# batch of 8 random sequences of DP_SEQ tokens split 4 + 4; the P-sharded
# Lanczos stores DP_ITERS rows of each rank's half of P, so the rank-k pair
# runs at DP_SHAPE on each rank (P/2 = 62,023,296: aligned rows, pass 1's
# aligned ring), timed in phase 3
DP_RANKS = 2
DP_SEQ = 256
DP_ITERS = 10
DP_SHAPE = (torch.float32, DP_ITERS, P_124M // DP_RANKS)
DP_HVP_RTOL = 1e-5  # the DP HVP against one process's HVP of the whole batch
DP_T_TOL = 1e-4  # the sharded T against the unsharded run's, rtol and atol
DP_RITZ_RTOL = 1e-3  # Ritz values of the two runs, of max |lambda|
# --probe_parallel --probes 2 over the two ranks against --probes 2 in one
# process (the JAX test's bar, tests/distributed/test_probe_parallel.py)
PROBE_PAR_ARGV = ["--model", "gpt2", "--dataset", "random", "--num_batches", "1",
                  "--batch_size", "4", "--max_length", "128", "--host_loop", "--lanczos_iters",
                  "4", "--probes", "2", "--hvp_precision", "high", "--vector_seed", "997"]
PROBE_PAR_RTOL = 1e-4
DP_TIMEOUT = 300.0
# phase 17: the model axis on two gloo ranks sharing the card, every rank
# building the whole model from its seed on the card and keeping its part.
# 17a: GPT-2 124M at full width, depth and context (n_positions 1024, P =
# 124,439,808), tensor-parallel over 2, both ranks on one batch of bs2 x
# seq512 (2 x bs2 x seq512, in 16b's notation); 17b: the
# same model sequence-parallel over 2 at bs1 x seq1024; 17c: Pythia-1.4B
# tensor-parallel over 2 on 13b's weights and first batch, held to 13b's
# unsharded step 0 (no second unsharded 1.4B run); 17d: gpt2-moe (dense and
# top-2 gating) expert-parallel over 2 at bs4 x seq256
MA_RANKS = 2
MA_SEED = 17
MA_TP_BATCHES, MA_TP_SHAPE = 1, (2, 512)
MA_SP_SHAPE = (1, 1024)
MA_MOE_SHAPE = (4, 256)
MA_ITERS = 10  # 17a's model-axis Lanczos: rows of each rank's basis block
MA_PYTHIA_K = 4  # 13b's k: its first refresh is 17c's host loop
MA_PROBES = 2  # 17c's seeded vectors
MA_LOSS_RTOL = 1e-6
MA_REL = 1e-5  # gradient and HVP (124M: whole vectors; 1.4B: inner products)
MA_TIMEOUT = 420.0
# 17e: GPT-2 124M tensor- and sequence-parallel on the one model axis, on
# 17b's batch, held to 17b's whole-model references; phase 18: GPT-2 124M
# (1024 positions) pipelined over 2 stages of 6 blocks on a ('data', 'pp')
# mesh of the same two ranks, 17a's batch in 2 microbatches of bs1 x
# seq512, 17a's start vector, held to 17a's whole-model references
PP_STAGES = 2
PP_MICRO = 2
PP_REMAT_REL = 1e-6  # 18's remat_ticks HVP against 18's own (the same products)
# phase 19: rematerialisation, TF32 under --linearized and dropout, at
# GPT-2 124M with phase 6's model (seed 0, 512 positions).  19a: one HVP
# per arm at REMAT_SHAPE (REMAT_FALLBACK_SHAPE if the plain blocked arm
# does not fit), query blocks and loss chunks of REMAT_BLOCK
REMAT_SHAPE, REMAT_FALLBACK_SHAPE = (16, 512), (8, 512)
REMAT_BLOCK = 128
REMAT_REL = 1e-5  # each arm's HVP against the dense one, rel-L2
REMAT_ITERS = 1  # timed HVPs per arm after a warm one (CUDA events)
# 19b: phase 4's LanczosSGD run with the blocks and chunks, a refresh and
# a frozen step, held to phase 4's step 0
REMAT_TRAIN_STEPS = 2
REMAT_TRAIN_ARGV = [a if a != "4" else str(REMAT_TRAIN_STEPS) for a in TRAIN_ARGV] + [
    "--attn_block_q", str(REMAT_BLOCK), "--loss_chunk", str(REMAT_BLOCK)]
REMAT_LOSS_RTOL, REMAT_EIG_RTOL = 1e-5, 1e-3
# 19c: the linearized HVP under blocks-TF32 (outer "high") against the eager
# one, at LIN_TF32_SHAPE; the auto ladder probed under --linearized
LIN_TF32_SHAPE = (4, 512)
LIN_TF32_REL = 1e-5
LIN_AUTO_ARGV = ["--model", "gpt2", "--dataset", "random", "--num_batches", "1",
                 "--batch_size", "2", "--max_length", "512", "--host_loop", "--linearized",
                 "--lanczos_iters", "2", "--precision_check_iters", "2"]
# 19d: dropout 0.1; the kept fraction of one c_proj output
DROPOUT, DROPOUT_SHAPE = 0.1, (8, 512)
DROPOUT_KEPT_TOL = 0.01
CARD = torch.device("cuda")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64, summed over slices of 2**26 entries (a
    float64 copy of a 1.41e9-entry vector would take 11.3 GB)."""
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for s in range(0, b.numel(), 1 << 26):
        x, y = a[s:s + (1 << 26)].double(), b[s:s + (1 << 26)].double()
        num += float(torch.sum((x - y) ** 2))
        den += float(torch.sum(y * y))
    if den == 0:
        return math.inf if num else math.nan
    return math.sqrt(num / den)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def timings(kernel, plain, library, *, nbytes: float, flops: float, big: bool = False) -> dict:
    """Kernel and library call timed in turns on one card: 10 warm-up
    launches each, then 3 rounds (5 before phase 19) of (kernel, library,
    library, kernel), 20 launches a timing, nvidia-smi sampled beside;
    median and min-max of the 6 timings of each (``big``: 2 warm-up
    launches, 3 rounds, 4 launches a timing, for a shape whose library call
    takes tens of ms).  Then the plain version, and the bound."""
    from hessian_llm_vision_tpu_torch.utils.cuda_timing import in_turns, smi_samples, time_ms

    turns = dict(rounds=3, iters=4, warmup=2) if big else dict(rounds=3, iters=20, warmup=10)
    with smi_samples() as smi:
        t = in_turns({"kernel": kernel, "library": library}, **turns)
    plain_ms = time_ms(plain, iters=5, warmup=1)
    bound, bound_by = bound_ms(nbytes, flops)
    return {"ms": t["kernel"]["ms"], "ms_spread": [t["kernel"]["min"], t["kernel"]["max"]],
            "plain_ms": plain_ms, "library_ms": t["library"]["ms"],
            "library_spread": [t["library"]["min"], t["library"]["max"]],
            "bound_ms": bound, "bound_by": bound_by, "smi": smi}


def call_costs(fns: dict, *, calls: int, traced: int = 20) -> dict:
    """Where one call's time goes, per candidate: ``host_us``, the host's
    time per call by ``time.perf_counter`` over ``calls`` calls issued
    back to back (after a synchronise, so the launch queue starts empty and
    stays far from full), and ``device_us``, the device rows of a
    ``torch.profiler`` trace of ``traced`` calls (read by
    obs.trace_summary, as phase 12g reads them): per kernel name its mean
    row times its rows per call (rounded: a trace may miss a row at its
    edges), summed over the names, with ``device_rows`` per call.  A trace
    with fewer device rows than half its calls fails the run."""
    from hessian_llm_vision_tpu_torch.obs import profile_trace, trace_summary

    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_us = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            with profile_trace(tmp):
                for _ in range(traced):
                    fn()
                torch.cuda.synchronize()
            rows, _ = trace_summary.device_rows(trace_summary.load_trace_events(tmp))
        if 2 * len(rows) < traced:  # each call launches a kernel at least, and a
            # trace misses a row or two at its edges: one that lost the card's
            # rows must not read as a time
            raise SystemExit(f"call_costs: the trace of {traced} calls of {name} holds "
                             f"{len(rows)} device rows")
        by_name: dict[str, list[float]] = {}
        for e in rows:
            by_name.setdefault(e["name"], []).append(e["dur"])
        device_us = sum(statistics.fmean(d) * max(1, round(len(d) / traced))
                        for d in by_name.values())
        out[name] = {"host_us": host_us, "device_us": device_us, "device_rows": len(rows) / traced}
    return out


def _summed(counts: list) -> dict:
    return {n: sum(c[n] for c in counts) for n in TPU_KERNELS}


def without_smi(t: dict) -> dict:
    return {key: v for key, v in t.items() if key != "smi"}


def phase(n: int, title: str):
    print(f"\n[phase {n}] {title}", flush=True)
    return time.perf_counter()


def phase3_shapes() -> list[tuple]:
    """Phase 3's shapes before phase 14's and 13b's, in the order they
    draw from its generator: (dtype, k, P, g offset, timed).  (35, P): k*P >
    2**31 needs 64-bit offsets; P = 20001 takes both passes' unaligned paths
    (P not a multiple of the 16-byte vector)."""
    out = [(dtype, k, p, 0, p == P_124M and k in TIMED_KS) for dtype in TIMED_DTYPES
           for k, p in ((10, P_124M), (35, P_124M), (35, 16384), (3, 20000), (5, 20001))]
    out += [(dtype, k, P_124M, 0, (dtype, k) in PATH_TIMED) for dtype, k in PATH_SHAPES]
    out += [(dtype, k, p, 0, True) for dtype in TIMED_DTYPES for k, p in LEAF_TIMED]
    out += [(dtype, k, p, offset, False) for dtype, k, p, offset in LEAF_CHECKED]
    return out + [(*ROW_SWEEP, 0, False)]


def check_rank_k(kernels, spectral, dtype, k, p, gen, timed: bool, g_offset: int = 0) -> dict:
    """Kernel vs plain versions on one shape, each kernel rerun for the
    same bits and pass 2 also on its other path; timings when ``timed``.
    ``g_offset``: g is a view that many elements into a larger tensor, as
    a per-leaf slice of a flat gradient is (not 16-byte aligned unless the
    offset is a multiple of 4)."""
    dev = torch.device("cuda")
    V = torch.randn((k, p), generator=gen, device=dev, dtype=dtype).mul_(1.0 / math.sqrt(p))
    g = torch.randn(p + g_offset, generator=gen, device=dev)[g_offset:]
    c = torch.randn(k, generator=gen, device=dev)
    w = kernels.rank_k_dots(g, V, c)
    out = kernels.rank_k_axpy(g, V, w)
    repeatable = torch.equal(w, kernels.rank_k_dots(g, V, c)) and torch.equal(
        out, kernels.rank_k_axpy(g, V, w)
    )
    torch.cuda.synchronize()
    w_ref = spectral.rank_k_dots_reference(g, V, c)
    ref = spectral.rank_k_apply_reference(g, V, c)
    axpy_ref = spectral.rank_k_axpy_reference(g, V, w_ref)
    out_same_w = kernels.rank_k_axpy(g, V, w_ref)
    plan = kernels.axpy_launch_plan(k, p, dtype, dev, (V.data_ptr(), g.data_ptr()))
    # pass 2's other path gives the same bits (the ring only for aligned rows)
    other_path = (not plan.ring,) if plan.vec_v and p % plan.vec == 0 else ()
    paths_equal = all(torch.equal(kernels.rank_k_axpy(g, V, w_ref, ring=ring), out_same_w)
                      for ring in other_path)
    res = {
        "dtype": str(dtype).removeprefix("torch."), "k": k, "P": p, "g_offset": g_offset,
        "rel_l2_vs_reference": rel_l2(out, ref),
        "rel_l2_dots": rel_l2(w, w_ref),
        "dots_max_abs_err": float((w - w_ref).abs().max()),
        "axpy_max_abs_err": float((out_same_w - axpy_ref).abs().max()),
        "bitwise_repeatable": repeatable,
        "axpy_plan": dataclasses.asdict(plan),
        "axpy_paths_bitwise_equal": paths_equal,
    }
    ok = repeatable and paths_equal and res["rel_l2_vs_reference"] <= 1e-5
    if p > 4 * P_124M:
        # both f32 sums over P terms against a float64 w, summed over column
        # slices (PYTHIA_SHAPE's comment)
        w64 = sum(c.double() * (V[:, s:s + (1 << 26)].double() @ g[s:s + (1 << 26)].double())
                  for s in range(0, p, 1 << 26))
        res["rel_l2_dots_vs_f64"] = rel_l2(w, w64)
        res["rel_l2_dots_plain_vs_f64"] = rel_l2(w_ref, w64)
        del w64
        ok = (ok and res["rel_l2_dots_vs_f64"] <= DOTS_F64_LIMIT
              and res["rel_l2_dots_vs_f64"] <= res["rel_l2_dots_plain_vs_f64"])
    else:
        ok = ok and res["rel_l2_dots"] <= 1e-5
    # freed before the bf16 plain version: at (4, 1.41e9) its f32 copy of V
    # alone takes 22.6 GB
    del out_same_w, axpy_ref, ref
    if dtype == torch.bfloat16:
        res["rel_l2_vs_bf16_plain"] = rel_l2(out, spectral.rank_k_apply_bf16(g, V, c))
        ok = ok and res["rel_l2_vs_bf16_plain"] <= 2e-3
    if timed:
        es = V.element_size()
        big = p > 4 * P_124M  # 13b's shape: torch.mv alone takes 64 ms there
        # library yardstick: torch.mv / torch.addmv take one dtype, so with a
        # bf16 basis g and w are rounded to bf16 (as rank_k_apply_bf16 does)
        gl, wl = g.to(dtype), w_ref.to(dtype)
        res["rank_k_dots"] = timings(
            lambda: kernels.rank_k_dots(g, V, c),
            lambda: spectral.rank_k_dots_reference(g, V, c),
            lambda: torch.mv(V, gl),
            nbytes=k * p * es + 4 * p + 8 * k, flops=2 * k * p, big=big,
        )
        res["rank_k_axpy"] = timings(
            lambda: kernels.rank_k_axpy(g, V, w_ref),
            lambda: spectral.rank_k_axpy_reference(g, V, w_ref),
            lambda: torch.addmv(gl, V.t(), wl),
            nbytes=k * p * es + 8 * p + 4 * k, flops=2 * k * p + p, big=big,
        )
        costs = call_costs({
            "rank_k_dots": lambda: kernels.rank_k_dots(g, V, c),
            "rank_k_dots_library": lambda: torch.mv(V, gl),
            "rank_k_axpy": lambda: kernels.rank_k_axpy(g, V, w_ref),
            "rank_k_axpy_library": lambda: torch.addmv(gl, V.t(), wl),
        }, calls=8 if big else COST_CALLS if p < P_124M else COST_CALLS // 4,
            traced=4 if big else 20)
        for name in ("rank_k_dots", "rank_k_axpy"):
            res[name]["max_abs_err"] = res[f"{name.split('_')[-1]}_max_abs_err"]
            res[name].update(costs[name])
            res[name].update({f"library_{key}": v for key, v in costs[f"{name}_library"].items()})
    res["ok"] = bool(ok)
    print(json.dumps(res), flush=True)
    return res


def dots_alignment_sweep(kernels, spectral) -> dict:
    """Pass 1 at every alignment class (SWEEP_KS's comment): V a view that
    many elements into a buffer, g a slice of another.  Per point: w
    against the plain version (cuBLAS's f32 sum) and both against a
    float64 w; w again, and w of fresh copies of V and g (whose rows sit at
    other shifts), bit for bit.  Counts the points whose plan took the
    aligned ring (V, g and P all whole 16-byte vectors: offset 0 of both
    and P = 0 mod vec), the launches, and every call of the wrappers' plain
    version, which a CUDA call must never reach.  Reads the card once, at
    the end."""
    gen = torch.Generator(device=CARD).manual_seed(PHASE3_SEED + 1)
    plain, fell_back = kernels.rank_k_dots_reference, []
    kernels.rank_k_dots_reference = lambda *a: fell_back.append(1) or plain(*a)
    points, aligned, expect_aligned = [], 0, 0
    before = kernels.LAUNCHES["rank_k_dots"]

    def norm(x):
        return torch.linalg.vector_norm(x)

    try:
        for dtype in TIMED_DTYPES:
            vec = 16 // torch.empty((), dtype=dtype).element_size()
            for cls in range(vec):
                for p in (3 * 2048 + 5 * vec + cls, 1 + cls):
                    for k in SWEEP_KS:
                        vbuf = torch.randn(k * p + vec, generator=gen, device=CARD).to(dtype)
                        gbuf = torch.randn(p + 4, generator=gen, device=CARD)
                        c = torch.randn(k, generator=gen, device=CARD)
                        for v_off in range(vec):
                            V = vbuf[v_off:v_off + k * p].view(k, p)
                            for g_off in range(4):
                                g = gbuf[g_off:g_off + p]
                                w = kernels.rank_k_dots(g, V, c)
                                again = kernels.rank_k_dots(g, V, c)
                                copied = kernels.rank_k_dots(g.clone(), V.clone(), c)
                                ref = spectral.rank_k_dots_reference(g, V, c).double()
                                w64 = c.double() * (V.double() @ g.double())
                                # the size of the terms each w sums
                                scale = c.double().abs() * (V.double().abs() @ g.double().abs())
                                wd = w.double()
                                points.append(torch.stack([
                                    norm(wd - ref) / norm(ref), norm(wd - w64) / norm(w64),
                                    norm(ref - w64) / norm(w64), norm(wd - w64) / norm(scale),
                                    ((w != again).any() | (w != copied).any()).double()]))
                                aligned += kernels.dots_launch_plan(
                                    k, p, dtype, CARD, (V.data_ptr(), g.data_ptr())).aligned
                                expect_aligned += v_off == 0 and g_off == 0 and p % vec == 0
    finally:
        kernels.rank_k_dots_reference = plain
    errs, f64, plain_f64, of_terms, differ = torch.stack(points).cpu().unbind(1)
    far = errs > SWEEP_DOTS_LIMIT  # the two f32 sums of a w near zero differ
    return {"points": len(points), "launches": kernels.LAUNCHES["rank_k_dots"] - before,
            "max_rel_l2_dots": float(errs.max()),
            "beyond_limit": int(far.sum()),
            # per such point: w and the plain version against float64, and
            # w's distance from float64 over the size of its terms
            "beyond_limit_vs_f64": torch.stack([f64, plain_f64, of_terms], 1)[far].tolist(),
            "within_limit_or_of_its_terms": bool(torch.all(~far | (of_terms <= SWEEP_DOTS_LIMIT))),
            "max_rel_l2_dots_vs_f64": float(f64.max()),
            "max_rel_l2_plain_vs_f64": float(plain_f64.max()),
            "max_dots_vs_f64_of_terms": float(of_terms.max()),
            "bitwise_repeatable_and_as_fresh_copies": not bool(differ.any()),
            "aligned_points": aligned, "expected_aligned_points": expect_aligned,
            "plain_version_calls": len(fell_back)}


def streaming_rates_torch() -> dict:
    """TB/s that the card gives PyTorch's own elementwise kernels on f32
    vectors of P: a copy (one read, one write), an add (two reads, one
    write) and a sum (reads only), timed in turns."""
    from hessian_llm_vision_tpu_torch.utils.cuda_timing import in_turns

    a, b = torch.randn(P_124M, device=CARD), torch.randn(P_124M, device=CARD)
    c = torch.empty_like(a)
    t = in_turns({"copy": lambda: c.copy_(a), "add": lambda: torch.add(a, b, out=c),
                  "sum": lambda: a.sum()}, rounds=3, iters=20, warmup=5)
    moved = {"copy": 8 * P_124M, "add": 12 * P_124M, "sum": 4 * P_124M}
    del a, b, c
    torch.cuda.empty_cache()
    return {f"torch_{n}": moved[n] / (1e9 * r["ms"]) for n, r in t.items()}


def streaming_rates(checks: dict) -> dict:
    """TB/s of each pass at (10, P) -- the bytes of its bound over its time
    -- beside :func:`streaming_rates_torch`.  Pass 2 mixes reads and writes
    as the add does; pass 1 only reads."""
    out = streaming_rates_torch()
    for dtype in TIMED_DTYPES:
        for name in TPU_KERNELS:
            r = checks[(dtype, 10, P_124M)][name]
            out[f"{name}_{str(dtype).removeprefix('torch.')}"] = (
                r["bound_ms"] * HBM_BYTES_PER_S / (1e12 * r["ms"]))
    return out


def step_breakdown(keep: dict) -> dict:
    """Device time of the pieces of a GPT-2 124M LanczosSGD step at the
    main path's shapes (bs8, seq512, "sum" HVPs, fp32 matmuls), by CUDA
    events: the loss forward, one gradient, one HVP (a refresh runs k of
    them), and the flatten/update work around them.  The model and its
    params go into ``keep`` for phase 19."""
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp_fn
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.losses import lm_loss_fn
    from hessian_llm_vision_tpu_torch.utils.cuda_timing import time_ms
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    dev = torch.device("cuda")
    B, T = 8, 512
    cfg = GPT2Config.gpt2_124m(n_positions=T)
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    params = {n: p.detach() for n, p in model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev)
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids)}
    loss_fn = lm_loss_fn(model)
    fl = Flattener(params)
    v = fl.unflatten(torch.randn(fl.size, generator=gen, device=dev) / math.sqrt(fl.size))
    hvp = hvp_fn(loss_fn, normalization="sum", batch_size=B)
    momentum = {n: torch.zeros_like(p) for n, p in params.items()}
    g_flat = fl.flatten(grad_and_loss(loss_fn, params, batch)[1])

    def update(lr=0.0):  # the trainer's unflatten + momentum/SGD arithmetic; lr 0 keeps the weights
        for name, a in fl.unflatten(g_flat).items():
            momentum[name].mul_(0.9).add_(a)
            params[name].sub_(lr * momentum[name])

    with torch.no_grad():
        forward_ms = time_ms(lambda: loss_fn(params, batch), iters=3, warmup=1)
    C, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    keep.update(model=model, params=params)
    return {
        "forward_ms": forward_ms,
        "grad_ms": time_ms(lambda: fl.flatten(grad_and_loss(loss_fn, params, batch)[1]),
                           iters=3, warmup=1),
        "hvp_ms": time_ms(lambda: fl.flatten(hvp(params, batch, v)), iters=3, warmup=1),
        "update_ms": time_ms(update, iters=3, warmup=1),
        # matmul operations of one forward, from the shapes
        "forward_flops": B * T * (L * (24 * C * C + 4 * T * C) + 2 * C * V),
        "P": fl.size,
    }


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def check_gates(what: str, gates: dict) -> None:
    failed = [g for g, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"{what} failed its gates: {failed}")


def spectrum_card_vs_cpu(spectrum_cli) -> dict:
    """Phase 7a: the spectrum CLI on gpt2-tiny on the card and on the CPU,
    same flags and probe vector, host loop and in-core CGS2.  The extreme
    Ritz values are held to the card; the alphas only over the first
    iterations, as late Lanczos steps amplify the two BLAS libraries'
    rounding in the unconverged interior of T."""
    out = {}
    for name, mode in (("host_loop", ["--host_loop"]), ("incore_cgs2", [])):
        (card, res_card), (cpu, res_cpu) = (spectrum_cli.main(TINY_SPECTRUM_ARGV + mode + extra)
                                            for extra in ([], ["--cpu"]))
        rel = {"lambda_max": abs(float(card.eigvals.max()) / float(cpu.eigvals.max()) - 1),
               "lambda_min": abs(float(card.eigvals.min()) / float(cpu.eigvals.min()) - 1)}
        a_card, a_cpu = res_card.alphas.cpu().numpy(), res_cpu.alphas.numpy()
        scale = max(abs(float(cpu.eigvals.max())), abs(float(cpu.eigvals.min())))
        n = CARD_CPU_EARLY_ALPHAS
        early = np.abs(a_card[:n] - a_cpu[:n]) / scale
        worst = int(np.argmax(np.abs(a_card - a_cpu) / np.abs(a_cpu)))
        out[name] = {**rel, "early_alphas_err_over_scale": early.tolist(),
                     "alphas_max_rel": max_rel(res_card.alphas, res_cpu.alphas),
                     "alphas_worst": {"index": worst, "card": float(a_card[worst]),
                                      "cpu": float(a_cpu[worst])}}
        if max(rel.values()) > CARD_CPU_LAMBDA_RTOL or early.max() > CARD_CPU_ALPHA_TOL:
            raise SystemExit(f"spectrum CLI on card and CPU disagree ({name}): {out[name]}")
    return out


def headline_spectrum(spectrum_cli, spectra, kernels, hvp_ms: float) -> dict:
    """Phase 7b: the headline job through cli.spectrum.main, its gates and
    its numbers."""
    iter_s = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec")
        t0 = time.perf_counter()
        spec, lres = spectrum_cli.main(SPECTRUM_ARGV + ["--out_spectrum", path],
                                       on_iter=lambda i, sec: iter_s.append(sec))
        main_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        back = spectra.load_spectrum(path)
    launches = dict(kernels.LAUNCHES)
    ev = spec.eigvals
    lam_max, lam_min = float(ev.max()), float(ev.min())
    trace = float(torch.dot(spec.eigvals, spec.gammas))
    gamma_sum = float(spec.gammas.sum())
    loop_s, hvps = sum(iter_s), HEADLINE_ITERS * 4
    with np.load(JAX_SPECTRUM) as z:
        jax_lam_max = float(z["eigvals"].max())
    res = {
        "hvps": hvps, "lanczos_loop_s": loop_s, "hvps_per_s": hvps / loop_s,
        "s_per_hvp": loop_s / hvps, "phase6_hvp_s": hvp_ms / 1e3,
        "loop_over_phase6_hvps": loop_s / (hvps * hvp_ms / 1e3),
        "iter_s": {"median": statistics.median(iter_s), "min": min(iter_s),
                   "max": max(iter_s), "first": iter_s[0],
                   "max_after_first": max(iter_s[1:]), "n": len(iter_s)},
        "main_s": main_s, "max_memory_allocated_bytes": peak,
        "lambda_max": lam_max, "lambda_min": lam_min, "trace_estimate": trace,
        "gamma_sum": gamma_sum, "alpha_1": float(lres.alphas[0]), "rank_k_launches": launches,
        "jax_artifact_lambda_max": {
            "value": jax_lam_max, "source": JAX_SPECTRUM,
            "note": "reference point, other weights and precision, not a gate"},
    }
    print(json.dumps({"spectrum": res}))
    gates = {
        f"{HEADLINE_ITERS} iterations timed": len(iter_s) == HEADLINE_ITERS,
        "finite Ritz values": bool(torch.isfinite(ev).all()),
        "lambda_max > 0 > lambda_min": lam_max > 0 > lam_min,
        "gammas sum to 1 within 1e-3": abs(gamma_sum - 1) <= 1e-3,
        "|trace| <= 1e-2 lambda_max": abs(trace) <= 1e-2 * lam_max,
        "artifact reads back": all(torch.equal(a, b) for a, b in
                                   ((back.eigvals, spec.eigvals), (back.gammas, spec.gammas))),
        "no rank-k launch": all(n == 0 for n in launches.values()),
    }
    check_gates("headline spectrum", gates)
    return res


def central_difference_hvp(loss_fn, params, batches, v: torch.Tensor, eps: float):
    """float64 reference for the dataset-mean Hessian times ``v``: a
    central difference of the batch-mean gradient, by reverse mode in
    float64 (not the forward-over-reverse HVP).  Returns the fourth-order
    difference (8 (g(+e) - g(-e)) - (g(+2e) - g(-2e))) / 12e and the
    second-order (g(+e) - g(-e)) / 2e; their distance bounds the
    truncation error of the reference."""
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    fl = Flattener(params)
    p64 = {n: t.double() for n, t in params.items()}
    v64 = {n: t.double() for n, t in fl.unflatten(v).items()}

    def mean_grad(step):
        shifted = {n: p64[n] + step * v64[n] for n in p64}
        g = torch.zeros(fl.size, dtype=torch.float64, device=v.device)
        for batch in batches:
            grads = grad_and_loss(loss_fn, shifted, batch)[1]
            g += torch.cat([grads[n].reshape(-1) for n in fl.names])
            del grads
        return g / len(batches)

    d1 = mean_grad(eps) - mean_grad(-eps)
    d2 = mean_grad(2 * eps) - mean_grad(-2 * eps)
    return (8 * d1 - d2) / (12 * eps), d1 / (2 * eps)


def hvp_against_central_difference(spectrum_cli, argv) -> tuple[dict, float]:
    """The port's f32 dataset-mean HVP (per-batch HVPs summed and scaled,
    as the host loop does) and a TF32 one, on the CLI's first probe for
    ``argv`` (drawn on the CPU, copied, normalised on the card), against a
    float64 central difference of gradients on the card at the workload's
    params.  Returns the readings and q1.Hq1 of the difference."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.operators import DatasetHessianOperator
    from hessian_llm_vision_tpu_torch.krylov.lanczos import start_vector

    dev = CARD
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    args = spectrum_cli.build_parser().parse_args(argv)
    wl = build_workload(args, dev)
    dim = sum(p.numel() for p in wl.params.values())
    v0 = torch.randn(dim, generator=torch.Generator().manual_seed(args.vector_seed)).to(dev)
    q1 = start_vector(v0, None, dim)

    def port_hvp(precision):
        return DatasetHessianOperator(wl.loss_fn, wl.params, wl.batches, normalization="mean",
                                      precision=precision).matvec(q1)

    hv = port_hvp("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        hv_tf32 = port_hvp(None)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref, ref2 = central_difference_hvp(wl.loss_fn, wl.params, wl.batches, q1, FD_EPS)
    torch.cuda.synchronize()
    res = {"eps": FD_EPS, "hv_norm": float(torch.linalg.vector_norm(ref)),
           "rel_l2_hvp_vs_fd": rel_l2(hv, ref),
           "rel_l2_tf32_hvp_vs_fd": rel_l2(hv_tf32, ref),
           "rel_l2_fd2_vs_fd4": rel_l2(ref2, ref),
           "build_and_hvps_s": t1 - t0, "fd_s": time.perf_counter() - t1}
    return res, float(torch.dot(q1.double(), ref))


def hvp_vs_central_difference(spectrum_cli, alpha_1: float) -> dict:
    """Phase 7c: at the headline shape, the f32 HVP on 7b's start vector
    against a float64 central difference of gradients on the card; 7b's
    alpha_1 against the difference's q1.Hq1.  A TF32 HVP must miss the
    limit, which shows that the check can see reduced precision."""
    res, alpha_fd = hvp_against_central_difference(spectrum_cli, SPECTRUM_ARGV)
    res.update({"limit": HVP_FD_LIMIT, "alpha_1": alpha_1, "alpha_1_fd": alpha_fd,
                "alpha_1_err_over_hv_norm": abs(alpha_1 - alpha_fd) / res["hv_norm"],
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    print(json.dumps({"hvp_vs_central_difference": res}))
    gates = {
        "f32 HVP within the limit": res["rel_l2_hvp_vs_fd"] <= HVP_FD_LIMIT,
        "7b alpha_1 within the limit": res["alpha_1_err_over_hv_norm"] <= HVP_FD_LIMIT,
        "reference's truncation within the limit": res["rel_l2_fd2_vs_fd4"] <= HVP_FD_LIMIT,
        "TF32 HVP misses the limit": res["rel_l2_tf32_hvp_vs_fd"] > HVP_FD_LIMIT,
    }
    check_gates("HVP against the float64 central difference", gates)
    return res


class _Tee:
    """A stdout that also keeps what is written: the CLI's report lines."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_cli(spectrum_cli, argv, on_iter=None):
    """``cli.spectrum.main(argv)`` with its report kept: (spectrum, result,
    stdout lines, host seconds of the whole call, synchronised)."""
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        spec, res = spectrum_cli.main(argv, on_iter=on_iter)
    torch.cuda.synchronize()
    return spec, res, "".join(tee.parts).splitlines(), time.perf_counter() - t0


def reported(lines, pattern: str) -> tuple:
    """The groups of the last report line that matches ``pattern``."""
    found = [m for line in lines if (m := re.search(pattern, line))]
    if not found:
        raise SystemExit(f"no report line matches {pattern!r}")
    return found[-1].groups()


def cli_wall_s(lines) -> float:
    """The CLI's own 'wall-clock: <s>s' (the Lanczos / thick-restart part)."""
    return float(reported(lines, r"^wall-clock: ([\d.]+)s")[0])


def npz_meta(path: str) -> dict:
    with np.load(path + ".npz") as z:
        return {k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")}


def thick_restart_124m(spectrum_cli, kernels) -> dict:
    """Phase 8a: --thick_restart 5 at GPT-2 124M with a bf16 buffer, each
    CGS2 call counted; then an independent residual per pair from one fresh
    f32 HVP, and the rows' orthonormality."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.operators import DatasetHessianOperator
    from hessian_llm_vision_tpu_torch.krylov import thick_restart

    orth_calls = 0
    body = thick_restart._orth_body

    def counted(*args):
        nonlocal orth_calls
        orth_calls += 1
        return body(*args)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    thick_restart._orth_body = counted
    try:
        _, res, lines, main_s = run_cli(spectrum_cli, TR_ARGV)
    finally:
        thick_restart._orth_body = body
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    wall = cli_wall_s(lines)
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    wl = build_workload(spectrum_cli.build_parser().parse_args(TR_ARGV), dev)
    op = DatasetHessianOperator(wl.loss_fn, wl.params, wl.batches, precision="high")
    scale = float(np.abs(res.eigvals).max())
    resid = [float(torch.linalg.vector_norm(op.matvec(u) - float(lam) * u)) / scale
             for u, lam in zip(res.vectors, res.eigvals)]
    V = res.vectors.double()
    ortho = float((V @ V.T - torch.eye(len(V), dtype=torch.float64, device=dev)).abs().max())
    del wl, op, V
    out = {
        "eigvals": res.eigvals.tolist(), "residual_estimates": res.residuals.tolist(),
        "independent_residual_over_max_lambda": resid, "max_abs_VVt_minus_I": ortho,
        "converged": res.converged, "restarts": res.restarts, "matvecs": res.matvecs,
        "cgs2_calls": orth_calls, "rank_k_launches": launches,
        "cli_wall_s": wall, "hvps_per_s": res.matvecs / wall, "main_s": main_s,
        "max_memory_allocated_bytes": peak, "residual_check_s": time.perf_counter() - t0,
    }
    print(json.dumps({"thick_restart_124m": out}))
    check_gates("8a thick restart", {
        "converged": res.converged,
        "independent residuals within the limit": max(resid) <= TR_RESIDUAL_LIMIT,
        "rows orthonormal": ortho <= TR_ORTHO_LIMIT,
        "each kernel twice per CGS2 call": all(launches[n] == 2 * orth_calls for n in TPU_KERNELS),
    })
    return out


def deflated_kpm_124m(spectrum_cli, kernels) -> dict:
    """Phase 8b: the host-loop spectrum, then the two-scale density (thick
    restart of the 4 largest |lambda|, KPM of the deflated operator); the
    deflation basis and the launch counts at the start of the KPM stage
    are taken where deflated_matvec builds the projector."""
    from hessian_llm_vision_tpu_torch.krylov import deflate

    seen = {}
    build_projector = deflate.deflated_matvec

    def capture(matvec, basis, *sharding):
        seen.update(launches=dict(kernels.LAUNCHES), basis=basis,
                    mv=build_projector(matvec, basis, *sharding))
        return seen["mv"]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "kpm")
        deflate.deflated_matvec = capture
        try:
            spec, _, lines, main_s = run_cli(spectrum_cli, KPM_ARGV + ["--out_spectrum", path])
        finally:
            deflate.deflated_matvec = build_projector
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        meta = npz_meta(path)
    kpm_launches = {n: launches[n] - seen["launches"][n] for n in launches}
    lam_max, lam_min = float(spec.eigvals.max()), float(spec.eigvals.min())
    slq_extreme = max(abs(lam_max), abs(lam_min))
    spikes = meta["kpm_deflate_eigvals"]
    spike = float(np.abs(spikes).max())
    annihilated = [float(torch.linalg.vector_norm(seen["mv"](u.float()))) / spike
                   for u in seen["basis"]]
    center, radius = float(meta["kpm_center"]), float(meta["kpm_radius"])
    span = lam_max - lam_min
    kpm_s, kpm_mv = reported(lines, r"\(([\d.]+)s, (\d+) matvecs\)$")
    wall = cli_wall_s(lines)
    out = {
        "slq_lambda_max": lam_max, "slq_lambda_min": lam_min, "spikes": spikes.tolist(),
        "spike_residuals": meta["kpm_deflate_residuals"].tolist(),
        "spikes_converged": int(meta["kpm_deflate_converged"]),
        "spike_vs_slq_extreme_rel": abs(spike / slq_extreme - 1),
        "deflated_op_on_spike_over_max_lambda": annihilated,
        "bulk_range": [center - radius, center + radius], "mu_0": float(meta["kpm_raw_moments"][0]),
        "kpm_stage_launches": kpm_launches, "rank_k_launches": launches,
        "host_loop_hvps": len(spec.eigvals), "host_loop_cli_wall_s": wall,
        "deflate_and_kpm_s": float(kpm_s), "deflate_and_kpm_matvecs": int(kpm_mv),
        "hvps_per_s": (len(spec.eigvals) + int(kpm_mv)) / (wall + float(kpm_s)), "main_s": main_s,
        "max_memory_allocated_bytes": peak,
    }
    del seen
    print(json.dumps({"deflated_kpm_124m": out}))
    check_gates("8b deflated KPM", {
        "spikes converged": out["spikes_converged"] == 1,
        "largest spike = SLQ extreme": out["spike_vs_slq_extreme_rel"] <= SPIKE_SLQ_RTOL,
        "deflated operator annihilates the spikes": max(annihilated) <= TR_RESIDUAL_LIMIT,
        "bulk range inside the SLQ range": (center - radius >= lam_min - BULK_WIDEN * span
                                            and center + radius <= lam_max + BULK_WIDEN * span),
        "mu_0 = 1": abs(out["mu_0"] - 1) <= MU0_TOL,
        "2 launches of each kernel per deflated matvec":
            all(kpm_launches[n] == 2 * KPM_STAGE_MATVECS for n in TPU_KERNELS),
    })
    return out


def hutchpp_124m(spectrum_cli, kernels) -> dict:
    """Phase 8c: in-core Lanczos and the Hutch++ trace at GPT-2 124M."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hpp")
        spec, _, lines, main_s = run_cli(spectrum_cli, HUTCHPP_ARGV + ["--out_spectrum", path])
        peak = torch.cuda.max_memory_allocated()
        meta = npz_meta(path)
    trace = float(meta["hutchpp_trace"])
    wall = cli_wall_s(lines)
    hpp_s = float(reported(lines, rf"^trace \(hutch\+\+ {HUTCHPP_MATVECS} matvecs\) = \S+ "
                                  r"\(([\d.]+)s\)")[0])
    out = {"hutchpp_trace": trace, "hutchpp_matvecs": int(meta["hutchpp_matvecs"]),
           "lanczos_hvps": len(spec.eigvals), "lanczos_cli_wall_s": wall, "hutchpp_s": hpp_s,
           "hvps_per_s": (len(spec.eigvals) + HUTCHPP_MATVECS) / (wall + hpp_s), "main_s": main_s,
           "max_memory_allocated_bytes": peak, "rank_k_launches": dict(kernels.LAUNCHES)}
    print(json.dumps({"hutchpp_124m": out}))
    check_gates("8c Hutch++", {"finite trace": math.isfinite(trace),
                               f"{HUTCHPP_MATVECS} matvecs in the artifact":
                                   out["hutchpp_matvecs"] == HUTCHPP_MATVECS})
    return out


def estimators_card_vs_cpu(spectrum_cli) -> dict:
    """Phase 8d: gpt2-tiny on the card and on the CPU, the same draws (CPU
    generators): thick restart with an f32 buffer; in-core --host_basis
    Lanczos with --kpm/--kpm_deflate and --hutchpp."""
    tr = TINY_EXT + ["--thick_restart", "3", "--lanczos_iters", "12"]
    # 12 iterations, as 7a: at 10, gpt2-tiny's lambda_max is not converged
    # and moves with the card's HVP rounding beyond the 1e-5 gate
    ext = TINY_EXT + ["--lanczos_iters", "12", "--host_basis", "--kpm", "20", "--kpm_probes", "2",
                      "--kpm_deflate", "2", "--hutchpp", "9"]
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        (_, tr_card), (_, tr_cpu) = (spectrum_cli.main(tr + extra) for extra in ([], ["--cpu"]))
        with tempfile.TemporaryDirectory() as tmp:
            specs, metas = [], []
            for name, extra in (("card", []), ("cpu", ["--cpu"])):
                path = os.path.join(tmp, name)
                specs.append(spectrum_cli.main(ext + extra + ["--out_spectrum", path])[0])
                metas.append(npz_meta(path))
    (card, cpu), (m_card, m_cpu) = specs, metas
    out = {
        "thick_restart_eigvals_rel": max_rel(*map(torch.as_tensor, (tr_card.eigvals, tr_cpu.eigvals))),
        "host_basis_extremes_rel": max_rel(torch.stack([card.eigvals.max(), card.eigvals.min()]),
                                           torch.stack([cpu.eigvals.max(), cpu.eigvals.min()])),
        "spikes_rel": max_rel(*(torch.as_tensor(m["kpm_deflate_eigvals"]) for m in metas)),
        "moments_abs": float(np.abs(m_card["kpm_moments"] - m_cpu["kpm_moments"]).max()),
        "hutchpp_rel": max_rel(*(torch.as_tensor(m["hutchpp_trace"]) for m in metas)),
        "thick_restart_matvecs": [tr_card.matvecs, tr_cpu.matvecs],
    }
    print(json.dumps({"estimators_card_vs_cpu": out}))
    check_gates("8d card against CPU", {
        "thick-restart eigenvalues": out["thick_restart_eigvals_rel"] <= EXT_EIG_RTOL,
        "host-basis extremes": out["host_basis_extremes_rel"] <= EXT_EIG_RTOL,
        "spikes": out["spikes_rel"] <= EXT_EIG_RTOL,
        "bulk moments": out["moments_abs"] <= EXT_MOMENT_ATOL,
        "Hutch++ trace": out["hutchpp_rel"] <= EXT_HUTCHPP_RTOL,
    })
    return out


def extremes_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest gap of the two extremes, over b's max |lambda|."""
    a, b = a.double().cpu(), b.double().cpu()
    scale = float(b.abs().max())
    return max(abs(float(a.max() - b.max())), abs(float(a.min() - b.min()))) / scale


def layerwise_124m(spectrum_cli, spectra, kernels) -> dict:
    """Phase 9a: the per-block sweep, 12 blocks x 10 masked HVPs, its
    artifacts and gates; then h_0's T against an in-core LayerHessianOperator
    T-only run from the same start vector (the generator's first draw)."""
    from hessian_llm_vision_tpu_torch.cli import spectrum_layerwise
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.operators import LayerHessianOperator
    from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
    from hessian_llm_vision_tpu_torch.utils import trees

    seen = {}
    sweep = spectrum_layerwise.layerwise_spectrum_host

    def timed_sweep(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen["t"] = sweep(*args, **kw)
        torch.cuda.synchronize()
        seen["s"] = time.perf_counter() - t0
        return seen["t"]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out, plot = os.path.join(tmp, "lw"), os.path.join(tmp, "grid.png")
        spectrum_layerwise.layerwise_spectrum_host = timed_sweep
        try:
            results, _, _, main_s = run_cli(spectrum_cli, LW_ARGV + ["--out_spectrum", out,
                                                                      "--plot", plot])
        finally:
            spectrum_layerwise.layerwise_spectrum_host = sweep
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        names = sorted(os.path.basename(f) for f in glob.glob(out + "_*.npz"))
        saved = {label: spectra.load_spectrum(f"{out}_{label}") for label in results}
        grid = os.path.exists(plot) and os.path.getsize(plot) > 0
    lam = {label: (float(sp.eigvals.max()), float(sp.eigvals.min())) for label, sp in saved.items()}
    trace = {label: abs(float(torch.dot(sp.eigvals, sp.gammas)))
             / max(1.0, float(sp.eigvals.abs().max())) for label, sp in saved.items()}
    gsum = {label: abs(float(sp.gammas.sum()) - 1) for label, sp in saved.items()}
    dev = CARD
    wl = build_workload(spectrum_cli.build_parser().parse_args(LW_ARGV), dev)
    labels, spans = trees.group_spans(*trees.partition_labels(wl.params), trees.BLOCK_GROUP_REGEX)
    off, size = spans[0]
    q = torch.zeros(sum(p.numel() for p in wl.params.values()), device=dev)
    q[off:off + size] = torch.randn(size, generator=torch.Generator().manual_seed(997)).to(dev)
    mask = trees.subtree_mask(wl.params, lambda n: n.startswith(labels[0] + "/"))
    op = LayerHessianOperator(wl.loss_fn, wl.params, wl.batches[0], mask)
    ref = lanczos(op.matvec, op.dim, LW_ITERS, v0=q, reorth=False, store_basis=False)
    got = seen["t"][labels[0]]
    t_scale = float(torch.cat([ref.alphas, ref.betas]).abs().max())
    t_err = max(float((got.alphas - ref.alphas).abs().max()),
                float((got.betas - ref.betas).abs().max())) / t_scale
    del wl, op, q
    hvps = sum(r.num_iters for r in seen["t"].values())
    out = {"blocks": list(results), "lambda_max_by_block": {k: v[0] for k, v in lam.items()},
           "lambda_min_by_block": {k: v[1] for k, v in lam.items()},
           "trace_over_max_lambda": max(trace.values()), "gamma_sum_err": max(gsum.values()),
           "h_0_T_err_vs_incore": t_err, "masked_hvps": hvps, "sweep_s": seen["s"],
           "hvps_per_s": hvps / seen["s"], "main_s": main_s, "max_memory_allocated_bytes": peak,
           "rank_k_launches": launches}
    print(json.dumps({"layerwise_124m": out}))
    check_gates("9a layerwise block sweep", {
        "12 block artifacts h_0..h_11": names == sorted(f"lw_h_{i}.npz" for i in range(12)),
        "grid written": grid,
        "weights sum to 1 per block": max(gsum.values()) <= 1e-3,
        "lambda_max > 0 per block": all(v[0] > 0 for v in lam.values()),
        "|trace| <= 1e-2 max(1, max |lambda|) per block": max(trace.values()) <= LW_TRACE_TOL,
        "h_0's T = the in-core operator's": t_err <= LW_T_RTOL,
        "no rank-k launch": all(n == 0 for n in launches.values()),
    })
    return out


def ggn_124m(spectrum_cli, kernels, hvp_ms: float) -> dict:
    """Phase 9b: the GGN host loop; then its matvec on the start vector
    against an independent product: jvp of the logits, the softmax Hessian
    (diag p - p p^T) / N_targets written out in float64 on the shifted
    positions, vjp."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.krylov import driver
    from hessian_llm_vision_tpu_torch.krylov.lanczos import start_vector
    from hessian_llm_vision_tpu_torch.utils.cuda_timing import time_ms
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    iters = []
    spec, _, lines, main_s = run_cli(spectrum_cli, GGN_ARGV,
                                     on_iter=lambda i, sec: iters.append(sec))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    lam_max, lam_min = float(spec.eigvals.max()), float(spec.eigvals.min())
    dev = CARD
    wl = build_workload(spectrum_cli.build_parser().parse_args(GGN_ARGV), dev)
    fl = Flattener(wl.params)
    batch = wl.batches[0]
    q1 = start_vector(torch.randn(fl.size, generator=torch.Generator().manual_seed(997)).to(dev),
                      None, fl.size)
    matvec = driver.dataset_matvec(wl.loss_fn, wl.params, wl.batches, operator="ggn",
                                   model_fn=wl.model_fn, out_loss_fn=wl.out_loss_fn)
    w = matvec(q1)
    ggn_ms = time_ms(lambda: matvec(q1), iters=3, warmup=1)

    def f(p):
        return wl.model_fn(p, batch)

    with torch.no_grad():
        tangent = fl.unflatten(q1)
        logits, jq = torch.func.jvp(f, (dict(wl.params),), ({n: tangent[n] for n in wl.params},))
        probs = torch.softmax(logits[:, :-1].double(), dim=-1)
        u = jq[:, :-1].double()
        del jq
        wts = batch["attention_mask"][:, 1:].double()
        hu = (probs * u - probs * (probs * u).sum(-1, keepdim=True)) * (wts / wts.sum())[..., None]
        del probs, u
        h_out = torch.zeros_like(logits)
        h_out[:, :-1] = hu.float()
        del hu, logits
    _, vjp_fn = torch.func.vjp(f, dict(wl.params))
    ref = fl.flatten(vjp_fn(h_out)[0])
    err = rel_l2(w, ref)
    del wl, matvec, vjp_fn, h_out, ref, w
    out = {"lambda_max": lam_max, "lambda_min": lam_min, "matvecs": len(iters),
           "iter_s_median": statistics.median(iters), "ggn_matvec_ms": ggn_ms,
           "ggn_over_phase6_hvp": ggn_ms / hvp_ms, "cli_wall_s": cli_wall_s(lines),
           "hvps_per_s": len(iters) / cli_wall_s(lines), "main_s": main_s,
           "rel_l2_vs_explicit_softmax_hessian": err, "limit": GGN_INDEP_LIMIT,
           "max_memory_allocated_bytes": peak, "rank_k_launches": launches}
    print(json.dumps({"ggn_124m": out}))
    check_gates("9b GGN host loop", {
        f"{GGN_ITERS} iterations": len(iters) == GGN_ITERS,
        "Ritz values >= -1e-4 lambda_max": lam_min >= -GGN_PSD_TOL * lam_max,
        "matvec = the explicit product": err <= GGN_INDEP_LIMIT,
        "no rank-k launch": all(n == 0 for n in launches.values()),
    })
    return out


def _peak_run(spectrum_cli, kernels, argv):
    """A host-loop run from fresh memory and launch counts: (spectrum,
    stdout lines, per-iteration host seconds, whole-call seconds, peak
    bytes, launches).  An iteration's seconds end with T on the host."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    iters = []
    spec, res, lines, main_s = run_cli(spectrum_cli, argv, on_iter=lambda i, sec: iters.append(sec))
    return (spec, lines, iters, main_s, torch.cuda.max_memory_allocated(),
            dict(kernels.LAUNCHES))


def linearized_and_bigmodel_124m(spectrum_cli, kernels, hvp_ms: float) -> dict:
    """Phases 9c and 9d: the plain host loop (PLAIN_ITERS HVPs), then --linearized
    (at the first of bs8, bs4, bs2 whose residuals fit, with the plain loop
    again at a cut batch), then --bigmodel with float32 and bfloat16
    vectors, each against the plain run of its batch."""
    plain, lines, iters, main_s, peak, launches = _peak_run(spectrum_cli, kernels, PLAIN_ARGV)
    plain_iter = statistics.median(iters)
    out = {"plain": {"lambda_max": float(plain.eigvals.max()),
                     "lambda_min": float(plain.eigvals.min()), "iter_s_median": plain_iter,
                     "cli_wall_s": cli_wall_s(lines), "main_s": main_s,
                     "max_memory_allocated_bytes": peak, "rank_k_launches": launches}}
    cut = []
    for argv in (PLAIN_ARGV, PLAIN_ARGV + ["--batch_size", "4"], PLAIN_ARGV + ["--batch_size", "2"]):
        bs = spectrum_cli.build_parser().parse_args(argv).batch_size
        try:
            lin, lines, iters, main_s, peak, launches = _peak_run(spectrum_cli, kernels,
                                                                  argv + ["--linearized"])
            break
        except torch.cuda.OutOfMemoryError as e:
            cut.append({"batch_size": bs, "error": str(e).splitlines()[0]})
            torch.cuda.empty_cache()
    else:
        raise SystemExit(f"9c: the linearized residuals fit at no batch size: {cut}")
    nbytes, resid_s = reported(lines, r"^linearized residual pass: (\d+) bytes in ([\d.]+)s$")
    tangent_s = statistics.median(iters[1:])  # the first also holds the residual pass
    ref = plain if argv is PLAIN_ARGV else _peak_run(spectrum_cli, kernels, argv)[0]
    out["linearized"] = {
        "batch_size": bs, "oom_at": cut, "residual_bytes": int(nbytes),
        "residual_pass_s": float(resid_s), "tangent_ms_median": 1e3 * tangent_s,
        "tangent_over_phase6_hvp": 1e3 * tangent_s / hvp_ms,
        "tangent_over_plain_iteration": tangent_s / plain_iter,
        "extremes_rel_vs_plain": extremes_rel(lin.eigvals, ref.eigvals),
        "cli_wall_s": cli_wall_s(lines), "main_s": main_s,
        "hvps_per_s": PLAIN_ITERS / cli_wall_s(lines), "max_memory_allocated_bytes": peak,
        "rank_k_launches": launches}
    for q in ("float32", "bfloat16"):
        big, lines, iters, main_s, peak, launches = _peak_run(
            spectrum_cli, kernels, PLAIN_ARGV + ["--bigmodel", "--bigmodel_q", q])
        it = statistics.median(iters)
        out[f"bigmodel_{q}"] = {
            "extremes_rel_vs_plain": extremes_rel(big.eigvals, plain.eigvals),
            "limit": BIG_RTOL[q], "iter_s_median": it, "iter_over_plain": it / plain_iter,
            "cli_wall_s": cli_wall_s(lines), "hvps_per_s": PLAIN_ITERS / cli_wall_s(lines),
            "main_s": main_s, "max_memory_allocated_bytes": peak, "rank_k_launches": launches}
    print(json.dumps({"linearized_and_bigmodel_124m": out}))
    runs = [out["plain"], out["linearized"], out["bigmodel_float32"], out["bigmodel_bfloat16"]]
    check_gates("9c/9d linearized and bigmodel", {
        "linearized extremes = the plain loop's": out["linearized"]["extremes_rel_vs_plain"]
        <= LIN_RTOL,
        **{f"bigmodel {q} extremes = the plain loop's":
           out[f"bigmodel_{q}"]["extremes_rel_vs_plain"] <= BIG_RTOL[q] for q in BIG_RTOL},
        "no rank-k launch": all(n == 0 for r in runs for n in r["rank_k_launches"].values()),
    })
    return out


def linearized_training(train_cli, kernels, phase4: list) -> dict:
    """Phase 9e: phase 4's training with --refresh_linearized: 4 steps, loss
    and eig_max as phase 4's, each rank-k kernel once per step."""
    records = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    train_cli.main(TRAIN_ARGV + ["--refresh_linearized"],
                   on_step=lambda step, rec: records.append(rec))
    launches = dict(kernels.LAUNCHES)
    rel = {k: max(abs(a[k] / b[k] - 1) for a, b in zip(records, phase4)) for k in ("loss",
                                                                                  "eig_max")}
    out = {"steps": records, "rel_vs_phase4": rel,
           "refresh_step_s": [r["seconds"] for r in records[::2]],
           "phase4_refresh_step_s": [r["seconds"] for r in phase4[::2]],
           "frozen_step_s": [r["seconds"] for r in records[1::2]],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "launches": launches}
    print(json.dumps({"linearized_training": out}))
    check_gates("9e linearized training", {
        "4 steps": len(records) == 4,
        "loss and eig_max as phase 4's": max(rel.values()) <= TRAIN_LIN_RTOL,
        "each kernel once per step": all(launches[n] == 4 for n in TPU_KERNELS),
    })
    return out


def empirical_fisher_124m(spectrum_cli, kernels, spectral) -> dict:
    """Phase 9f: G = 8 per-example gradients of one bs8 x seq512 batch in
    bf16; one matvec of EmpiricalFisherOperator counted (the kernel pair);
    then on the same G the pair against its f32 plain version and the
    JAX-rounding plain version, and against an f32 G; and the row blocks
    of a G taller than one launch takes, against the plain version."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature import ggn
    from hessian_llm_vision_tpu_torch.krylov.lanczos import start_vector

    dev = CARD
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wl = build_workload(spectrum_cli.build_parser().parse_args(EXT_BASE), dev)
    batch = wl.batches[0]

    def per_example(p, e):
        return wl.loss_fn(p, {k: x[None] for k, x in e.items()})

    dim = sum(p.numel() for p in wl.params.values())
    q = start_vector(torch.randn(dim, generator=torch.Generator().manual_seed(997)).to(dev),
                     None, dim)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = ggn.EmpiricalFisherOperator(per_example, wl.params, batch, grad_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    grads_s = time.perf_counter() - t0
    w_op = op.matvec(q)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    del op
    G = ggn.per_example_grads(per_example, wl.params, batch, grad_dtype=torch.bfloat16)
    w = ggn.ef_apply(G, q, EF_N)
    c = torch.full((EF_N,), 1.0 / EF_N, device=dev)
    plain = spectral.rank_k_axpy_reference(torch.zeros_like(q), G,
                                           spectral.rank_k_dots_reference(q, G, c))
    dots = (G.float() @ q.to(G.dtype).float()).to(G.dtype).float()
    jax_rounding = (dots @ G.float()) / EF_N
    del G
    G32 = ggn.per_example_grads(per_example, wl.params, batch)
    w32 = ggn.ef_apply(G32, q, EF_N)
    del G32
    tall = torch.randn((kernels._MAX_K + 5, 4096), generator=torch.Generator(device=CARD)
                       .manual_seed(3), device=dev)
    v = torch.randn(4096, generator=torch.Generator(device=CARD).manual_seed(4), device=dev)
    tall_err = rel_l2(ggn.ef_apply(tall, v, tall.shape[0]), (tall.T @ (tall @ v)) / tall.shape[0])
    out = {"n": EF_N, "P": dim, "grads_s": grads_s,
           "rel_l2_operator_vs_ef_apply": rel_l2(w_op, w),
           "rel_l2_vs_f32_plain": rel_l2(w, plain), "rel_l2_vs_jax_rounding_plain":
               rel_l2(w, jax_rounding), "rel_l2_vs_f32_G": rel_l2(w, w32),
           "rel_l2_row_blocks": tall_err, "max_memory_allocated_bytes":
               torch.cuda.max_memory_allocated(), "launches": launches}
    del wl, tall
    print(json.dumps({"empirical_fisher_124m": out}))
    check_gates("9f empirical Fisher", {
        "operator matvec ~ ef_apply on a recomputed G":
            out["rel_l2_operator_vs_ef_apply"] <= EF_RECOMPUTED_RTOL,
        "pair = f32 plain version": out["rel_l2_vs_f32_plain"] <= EF_PLAIN_RTOL,
        "pair ~ JAX-rounding plain version": out["rel_l2_vs_jax_rounding_plain"] <= EF_BF16_RTOL,
        "bf16 G ~ f32 G": out["rel_l2_vs_f32_G"] <= EF_BF16_RTOL,
        "row blocks summed": tall_err <= EF_PLAIN_RTOL,
        "each kernel once in the matvec": all(launches[n] == 1 for n in TPU_KERNELS),
    })
    return out


def new_paths_card_vs_cpu(spectrum_cli, train_cli) -> dict:
    """Phase 9g: gpt2-tiny, card against CPU, the same draws: the layerwise
    block sweep (host loop) and an in-core leaf sweep, the GGN host loop and
    in-core Fisher, --linearized, --bigmodel (f32 gated, bf16 read) and the
    linearized trainer."""
    it = ["--lanczos_iters", "12"]
    one = TINY_EXT + ["--num_batches", "1", "--host_loop"] + it
    runs = {
        "layerwise_block_host_loop": TINY_EXT + it + ["--layerwise", "--layerwise_group",
                                                      "block", "--host_loop"],
        "layerwise_leaf_incore": TINY_EXT + it + ["--layerwise", "--group_regex",
                                                  r"(h_1/mlp/c_\w+/kernel)"],
        "ggn_host_loop": TINY_EXT + it + ["--operator", "ggn", "--host_loop"],
        "fisher_incore": TINY_EXT + it + ["--operator", "fisher"],
        "linearized": one + ["--linearized"],
        "bigmodel_float32": one + ["--bigmodel", "--bigmodel_q", "float32"],
        "bigmodel_bfloat16": one + ["--bigmodel"],
    }
    out = {}
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        for name, argv in runs.items():
            card, cpu = (spectrum_cli.main(argv + extra)[0] for extra in ([], ["--cpu"]))
            if isinstance(card, dict):  # layerwise: the worst block
                out[name] = max(extremes_rel(card[k].eigvals, cpu[k].eigvals) for k in cpu)
            else:
                out[name] = extremes_rel(card.eigvals, cpu.eigvals)
        tiny = ["--model", "gpt2-tiny", "--optimiser", "lanczos-host", "--batch_size", "4",
                "--max_length", "32", "--k", "4", "--delta", "1e-2", "--refresh_every", "2",
                "--lanczos_momentum", "0.5", "--max_steps", "3", "--no-basis_bf16",
                "--refresh_linearized"]
        recs = ([], [])
        for r, extra in zip(recs, ([], ["--cpu"])):
            train_cli.main(tiny + extra, on_step=lambda s, rec, r=r: r.append(rec))
    out["train_linearized_loss_rel"] = max(abs(a["loss"] / b["loss"] - 1) for a, b in zip(*recs))
    out["train_linearized_eig_max_rel"] = max(abs(a["eig_max"] / b["eig_max"] - 1)
                                              for a, b in zip(*recs))
    print(json.dumps({"new_paths_card_vs_cpu": out}))
    check_gates("9g card against CPU", {
        **{name: out[name] <= (BIG_RTOL["bfloat16"] if name == "bigmodel_bfloat16"
                               else TINY_NEW_RTOL) for name in runs},
        "linearized trainer loss": out["train_linearized_loss_rel"] <= 1e-5,
        "linearized trainer eig_max": out["train_linearized_eig_max_rel"] <= 1e-3,
    })
    return out


def _train(train_cli, argv) -> tuple[list, float]:
    """``cli.train.main(argv)``: the per-step records and the host seconds
    of the whole call."""
    records = []
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_cli.main(argv, on_step=lambda s, r: records.append(r))
    torch.cuda.synchronize()
    return records, time.perf_counter() - t0


def _leaves(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for key, v in tree.items():
            yield from _leaves(v, f"{prefix}/{key}")
    else:
        yield prefix, tree


def _reloads_equal(load_checkpoint, path: str, state) -> bool:
    """Every entry of the file at ``path`` equals ``state``, the state in
    memory when it was saved (tensors by ``torch.equal``)."""
    back = dict(_leaves(load_checkpoint(path, template=state)))
    ref = dict(_leaves(state))
    return back.keys() == ref.keys() and all(
        torch.equal(back[k], v) if isinstance(v, torch.Tensor) else back[k] == v
        for k, v in ref.items())


def adam_update_vs_gradient(train_cli) -> dict:
    """Device time of an Adam step's pieces at 10a's shapes by CUDA events:
    one gradient (blockwise attention 256, chunked loss 256) and the update
    (manual_adam's multi-tensor arithmetic and apply_updates), with the
    update's byte bound: read p, g, m, v once, write p, m, v once."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
    from hessian_llm_vision_tpu_torch.optim.manual import apply_updates, manual_adam
    from hessian_llm_vision_tpu_torch.utils.cuda_timing import time_ms

    torch.cuda.empty_cache()
    wl = build_workload(train_cli.build_parser().parse_args(ADAM_ARGV), CARD)
    batch = wl.batches[0]
    tx = manual_adam(1e-3)
    state = tx.init(wl.params)
    _, grads = grad_and_loss(wl.loss_fn, wl.params, batch)
    state = tx.update(grads, state, wl.params)[1]  # nonzero moments

    def update():
        updates, _ = tx.update(grads, state, wl.params)
        return apply_updates(wl.params, updates)

    p = sum(t.numel() for t in wl.params.values())
    out = {"grad_ms": time_ms(lambda: grad_and_loss(wl.loss_fn, wl.params, batch), iters=5,
                              warmup=1),
           "update_ms": time_ms(update, iters=10, warmup=2),
           "update_bound_ms": bound_ms(7 * 4 * p, 0)[0], "tensors": len(wl.params), "P": p}
    out["update_over_grad"] = out["update_ms"] / out["grad_ms"]
    del wl, grads, state
    return out


def adam_save_resume_124m(train_cli, tmp: str) -> tuple[dict, str]:
    """Phase 10a: Adam on GPT-2 124M over ADAM_N stdlib batches for two
    epochs, saving the checkpoint; then on the first RESUME_N batches, (i)
    two epochs uninterrupted, (ii) one epoch with --save_state, (iii) one
    epoch resumed; the state files reload equal to the states in memory
    when they were saved.  Returns the readings and the checkpoint's path."""
    from hessian_llm_vision_tpu_torch.io.checkpoints import load_checkpoint

    out = ["--out", os.path.join(tmp, "runs")]
    split = ADAM_ARGV + out + ["--num_batches", str(RESUME_N)]
    S, S2, C = (os.path.join(tmp, name) for name in ("state1", "state2", "ckpt"))
    saved = {}
    save = train_cli.save_checkpoint

    def capture(path, state):
        save(path, state)
        saved[path] = state

    torch.cuda.reset_peak_memory_stats()
    whole, whole_s = _train(train_cli, ADAM_ARGV + out + ["--epochs", "2", "--save_checkpoint", C])
    peak = torch.cuda.max_memory_allocated()
    train_cli.save_checkpoint = capture
    try:
        ref, ref_s = _train(train_cli, split + ["--epochs", "2"])
        first, first_s = _train(train_cli, split + ["--epochs", "1", "--save_state", S])
        reloads = [_reloads_equal(load_checkpoint, S, saved.pop(S))]
        second, second_s = _train(train_cli, split + [
            "--epochs", "1", "--resume_state", S, "--save_state", S2])
        reloads.append(_reloads_equal(load_checkpoint, S2, saved.pop(S2)))
        saved.clear()
    finally:
        train_cli.save_checkpoint = save
    steps = [load_checkpoint(s)["step"] for s in (S, S2)]
    state_bytes = os.path.getsize(S)
    os.remove(S)
    os.remove(S2)
    losses = [r["loss"] for r in whole]
    resumed = [r["loss"] for r in first + second]
    diffs = [abs(a - b["loss"]) for a, b in zip(resumed, ref)]
    step_s = [r["seconds"] for r in whole[1:]]
    res = {
        "N": ADAM_N, "resume_N": RESUME_N,
        "steps": [len(whole), len(ref), len(first), len(second)],
        "loss_step0": losses[0], "ln_vocab": math.log(50257),
        "last10_mean": statistics.mean(losses[-10:]), "loss_every_50": losses[::50],
        "resume_max_abs_loss_diff": max(diffs), "resume_first_diff_step":
            next((i for i, d in enumerate(diffs) if d > 0), None),
        "resume_loss_atol": RESUME_LOSS_ATOL,
        "step_s_median": statistics.median(step_s), "step_s_min_max": [min(step_s), max(step_s)],
        "first_step_s": whole[0]["seconds"], "max_memory_allocated_bytes": peak,
        "run_s": [whole_s, ref_s, first_s, second_s], "saved_steps": steps,
        "state_bytes": state_bytes, "checkpoint_bytes": os.path.getsize(C),
        "reloads_equal": reloads, "pieces": adam_update_vs_gradient(train_cli),
    }
    print(json.dumps({"adam_save_resume_124m": res}))
    check_gates("10a Adam save and resume", {
        "2N, 2M, M and M steps": res["steps"] == [2 * ADAM_N, 2 * RESUME_N, RESUME_N, RESUME_N],
        "the split starts as the checkpoint's run": ref[0]["loss"] == losses[0],
        "step 0 loss within 0.5 of ln 50257": abs(losses[0] - math.log(50257)) <= 0.5,
        "last 10 losses below half of step 0's": res["last10_mean"] < 0.5 * losses[0],
        "states reload equal": all(reloads),
        "saved steps M then 2M": steps == [RESUME_N, 2 * RESUME_N],
        "resumed losses track the uninterrupted run": max(diffs) <= RESUME_LOSS_ATOL,
    })
    return res, C


def checkpoint_spectrum_124m(spectrum_cli, ckpt: str) -> dict:
    """Phase 10b: the host-loop spectrum of 10a's checkpoint and of the
    random init on the same stdlib batch; then the f32 HVP at the
    checkpoint's params against a float64 central difference."""
    runs = {}
    for name, extra in (("checkpoint", ["--checkpoint", ckpt]), ("init", [])):
        torch.cuda.empty_cache()
        spec, _, lines, main_s = run_cli(spectrum_cli, CKPT_SPECTRUM_ARGV + extra)
        runs[name] = {"lambda_max": float(spec.eigvals.max()),
                      "lambda_min": float(spec.eigvals.min()),
                      "gamma_sum": float(spec.gammas.double().sum()),
                      "trace_estimate": float(torch.dot(spec.eigvals, spec.gammas)),
                      "cli_wall_s": cli_wall_s(lines), "main_s": main_s}
    fd, _ = hvp_against_central_difference(spectrum_cli, CKPT_SPECTRUM_ARGV + ["--checkpoint",
                                                                               ckpt])
    res = {**runs, "lambda_max_ratio": runs["checkpoint"]["lambda_max"]
           / runs["init"]["lambda_max"], "hvp_vs_central_difference": {**fd,
                                                                        "limit": CKPT_FD_LIMIT}}
    print(json.dumps({"checkpoint_spectrum_124m": res}))
    check_gates("10b spectrum of the checkpoint", {
        "weights sum to 1 within 1e-6": all(abs(r["gamma_sum"] - 1) <= 1e-6 for r in runs.values()),
        "lambda_max above init's": res["lambda_max_ratio"] > 1,
        "f32 HVP within the limit": fd["rel_l2_hvp_vs_fd"] <= CKPT_FD_LIMIT,
    })
    return res


def lanczos_sgd_from_checkpoint(train_cli, kernels, ckpt: str, tmp: str) -> dict:
    """Phase 10c: phase 4's LanczosSGD from 10a's checkpoint on stdlib
    batches; step 0's loss against the checkpoint's loss on that batch,
    computed directly; each rank-k kernel once per step."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload

    argv = TRAIN_ARGV + ["--checkpoint", ckpt, "--dataset", f"local:{STDLIB}",
                         "--out", os.path.join(tmp, "runs")]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    records, main_s = _train(train_cli, argv)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    wl = build_workload(train_cli.build_parser().parse_args(argv), CARD)
    with torch.no_grad():
        direct = float(wl.loss_fn(wl.params, wl.batches[0]))
    del wl
    res = {"steps": records, "checkpoint_loss_batch0": direct,
           "step0_rel_vs_direct": abs(records[0]["loss"] / direct - 1), "main_s": main_s,
           "max_memory_allocated_bytes": peak, "launches": launches}
    print(json.dumps({"lanczos_sgd_from_checkpoint": res}))
    check_gates("10c LanczosSGD from the checkpoint", {
        "4 steps": len(records) == 4,
        "finite losses and eigenvalues": all(math.isfinite(v) for r in records for v in r.values()),
        "step 0 = the checkpoint's loss": res["step0_rel_vs_direct"] <= CKPT_LOSS_RTOL,
        "each kernel once per step": all(launches[n] == 4 for n in TPU_KERNELS),
    })
    return res


def tiny_adam_card_vs_cpu(train_cli, tmp: str) -> dict:
    """Phase 10d: gpt2-tiny Adam with accumulation 2 and linear decay, card
    against CPU; the card's checkpoint loads with --cpu and the CPU's on
    the card, through the train CLI."""
    out = ["--out", os.path.join(tmp, "tiny_runs")]
    ck = {dev: os.path.join(tmp, f"tiny_{dev}") for dev in ("card", "cpu")}
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        card, _ = _train(train_cli, TINY_ADAM_ARGV + out + ["--save_checkpoint", ck["card"]])
        cpu, _ = _train(train_cli, TINY_ADAM_ARGV + out + ["--save_checkpoint", ck["cpu"],
                                                           "--cpu"])
        one = ["--max_steps", "1"]
        card_on_cpu, _ = _train(train_cli, TINY_ADAM_ARGV + out + one + ["--checkpoint",
                                                                        ck["card"], "--cpu"])
        cpu_on_card, _ = _train(train_cli, TINY_ADAM_ARGV + out + one + ["--checkpoint",
                                                                        ck["cpu"]])
    res = {"loss_rel": max(abs(a["loss"] / b["loss"] - 1) for a, b in zip(card, cpu)),
           "steps": [len(card), len(cpu)],
           "reloaded_loss_rel": abs(card_on_cpu[0]["loss"] / cpu_on_card[0]["loss"] - 1)}
    print(json.dumps({"tiny_adam_card_vs_cpu": res}))
    check_gates("10d gpt2-tiny Adam card against CPU", {
        "5 steps each": res["steps"] == [5, 5],
        "per-step losses": res["loss_rel"] <= TINY_ADAM_RTOL,
        "checkpoints cross devices": res["reloaded_loss_rel"] <= TINY_ADAM_RTOL,
    })
    return res


def run_cli_both(spectrum_cli, argv):
    """``cli.spectrum.main(argv)`` with stdout and stderr kept: (spectrum,
    stdout lines, stderr text, host seconds, synchronised)."""
    out, err = _Tee(sys.stdout), _Tee(sys.stderr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        spec, _ = spectrum_cli.main(argv)
    torch.cuda.synchronize()
    return spec, "".join(out.parts).splitlines(), "".join(err.parts), time.perf_counter() - t0


def _probe_workload(spectrum_cli, ckpt) -> tuple:
    """(workload, loss factory) of GPT-2 124M at init (``ckpt`` None) or
    at the checkpoint, for 11a, 11b and 11d."""
    from hessian_llm_vision_tpu_torch.cli.precision import lm_loss_factory
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload

    argv = CKPT_SPECTRUM_ARGV + (["--checkpoint", ckpt] if ckpt else [])
    args = spectrum_cli.build_parser().parse_args(argv)
    wl = build_workload(args, CARD)
    return wl, lm_loss_factory(wl, args)


def _probe(driver, wl, loss_fn, precision, **kw) -> dict:
    stats = driver.matvec_precision_probe(
        loss_fn, wl.params, wl.batches[0], generator=torch.Generator().manual_seed(997),
        precision=precision, ritz_iters=PROBE_ITERS, reorth=True, **kw)
    return {"rel_err": stats["rel_err"], "ritz_rel_err": stats["ritz_rel_err"],
            "ms_per_hvp": 1e3 * stats["seconds_requested"],
            "referee_ms_per_hvp": 1e3 * stats["seconds_referee"],
            "extremes": stats["ritz_extremes_requested"],
            "referee_extremes": stats["ritz_extremes_referee"]}


def _tier_probes(driver, wl) -> dict:
    """:func:`_probe` of every arm of PROBE_ARMS with the "highest" referee
    run once for all of them: the probe's vector, its timed HVPs (the
    second of two calls) and its reorthogonalised extremes, as
    ``krylov.driver.matvec_precision_probe`` computes them."""
    from hessian_llm_vision_tpu_torch.krylov.lanczos import start_vector
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    fl, batch = Flattener(wl.params), wl.batches[0]
    v = start_vector(torch.randn(fl.size, generator=torch.Generator().manual_seed(997)).to(CARD),
                     None, fl.size)

    def run(precision):
        hv = driver.batch_hvp(wl.loss_fn, precision, fl)
        w = hv(v, wl.params, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hv(v, wl.params, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return w, seconds, driver._tiny_lanczos_extremes(hv, v, wl.params, batch, PROBE_ITERS,
                                                         reorth=True)

    w_ref, s_ref, (lo_r, hi_r) = run("highest")
    scale = max(abs(lo_r), abs(hi_r), 1e-30)
    out = {}
    for arm in PROBE_ARMS:
        w, secs, (lo, hi) = run(arm)
        out[arm] = {"rel_err": float(torch.linalg.vector_norm(w - w_ref))
                    / max(float(torch.linalg.vector_norm(w_ref)), 1e-30),
                    "ritz_rel_err": max(abs(hi - hi_r), abs(lo - lo_r)) / scale,
                    "ms_per_hvp": 1e3 * secs, "referee_ms_per_hvp": 1e3 * s_ref,
                    "extremes": (lo, hi), "referee_extremes": (lo_r, hi_r)}
        del w
    return out


def tier_map(kernels, wls: dict) -> dict:
    """Phase 11a: each tier against the "highest" referee by the
    reorthogonalised probe (one referee run per point), at init and at the
    checkpoint; then an HVP with only block 0 at TF32 against all-fp32 and
    all-TF32 (the scope's reach)."""
    from hessian_llm_vision_tpu_torch.krylov import driver
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    out = {}
    kernels.reset_launch_counts()
    for point in ("init", "checkpoint"):
        torch.cuda.empty_cache()
        wl, factory = wls[point]
        out[point] = _tier_probes(driver, wl)
        if point == "checkpoint":
            fl = Flattener(wl.params)
            v = torch.randn(fl.size, generator=torch.Generator().manual_seed(5)).to(CARD)
            block0 = ("TF32_TF32_F32",) + (None,) * (wl.model.config.n_layer - 1)

            def hv(loss_fn, precision):
                return driver.batch_hvp(loss_fn, precision, fl)(v, wl.params, wl.batches[0])

            b0 = hv(factory(block0), "high")
            out["block0_tf32"] = {"rel_l2_vs_fp32": rel_l2(b0, hv(wl.loss_fn, "high")),
                                  "rel_l2_vs_all_tf32": rel_l2(b0, hv(wl.loss_fn,
                                                                      "TF32_TF32_F32"))}
    out["launches"] = dict(kernels.LAUNCHES)
    print(json.dumps({"tier_map": out}))
    gates = {}
    for point in ("init", "checkpoint"):
        r = out[point]
        gates[f"{point}: bf16 and TF32 differ from fp32"] = (
            r["default"]["rel_err"] > 0 and r["TF32_TF32_F32"]["rel_err"] > 0)
        gates[f"{point}: high equals highest bit for bit"] = (
            r["high"]["rel_err"] == 0 and r["high"]["ritz_rel_err"] == 0)
        gates[f"{point}: finite"] = all(math.isfinite(x) for a in r.values()
                                        for x in (a["rel_err"], a["ritz_rel_err"]))
    gates["init: bf16 errs more than TF32"] = (
        out["init"]["default"]["rel_err"] > out["init"]["TF32_TF32_F32"]["rel_err"])
    gates["block 0 at TF32 differs from all-fp32 and all-TF32"] = (
        out["block0_tf32"]["rel_l2_vs_fp32"] > 0 and out["block0_tf32"]["rel_l2_vs_all_tf32"] > 0)
    # 2 points x (3 arms + the referee) x PROBE_ITERS iterations x 2 CGS2 passes
    n = 2 * (len(PROBE_ARMS) + 1) * PROBE_ITERS * 2
    gates[f"{n} CGS2 launches of each kernel"] = all(out["launches"][k] == n
                                                      for k in TPU_KERNELS)
    check_gates("11a the tier map", gates)
    return out


_PLAN = r"^auto precision plan: (.+) \(extreme-Ritz err ([\d.e+-]+) vs f32 referee\)"
_ARM = r"^  probed (.+): err ([\d.e+-]+), (\d+) ms/HVP"
_LOGGED = r"^\[auto-precision\] (.+): err ([\d.e+-]+), (\d+) ms/HVP"


def _resolved(spectrum_cli, argv, wl) -> list:
    """``cli.precision.resolve_auto_precision`` on a built workload, as
    the spectrum CLI calls it: its stdout lines."""
    from hessian_llm_vision_tpu_torch.cli.precision import resolve_auto_precision

    out = _Tee(sys.stdout)
    with contextlib.redirect_stdout(out):
        resolve_auto_precision(spectrum_cli.build_parser().parse_args(argv), wl)
    return "".join(out.parts).splitlines()


def auto_plan(spectrum_cli, kernels, ckpt: str, wls: dict) -> dict:
    """Phase 11b: the spectrum CLI with --hvp_precision auto on the
    checkpoint (the plan and its file); then the CLI's resolution alone on
    11a's workloads: the plan's reuse, --reprobe, and the plan at init."""
    out = {}
    plan_path = ckpt + ".autoprec.json"
    runs = (("checkpoint", ["--checkpoint", ckpt], None),
            ("reuse", ["--checkpoint", ckpt], "checkpoint"),
            ("reprobe", ["--checkpoint", ckpt, "--reprobe"], "checkpoint"),
            ("init", [], "init"))
    for name, extra, point in runs:
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        if point is None:
            spec, lines, _, main_s = run_cli_both(spectrum_cli, AUTO_ARGV + extra)
            out[name] = {"lambda_max": float(spec.eigvals.max()), "main_s": main_s}
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lines = _resolved(spectrum_cli, AUTO_ARGV + extra, wls[point][0])
            torch.cuda.synchronize()
            out[name] = {"resolve_s": time.perf_counter() - t0}
        text = "\n".join(lines)
        plan = [(m.group(1), float(m.group(2))) for line in lines if (m := re.search(_PLAN, line))]
        out[name] |= {"plan": plan[-1] if plan else None,
                      "arms": [(m.group(1), float(m.group(2)), int(m.group(3)))
                               for line in lines if (m := re.search(_ARM, line))],
                      "logged": [m.group(1) for line in lines if (m := re.search(_LOGGED, line))],
                      "skipped": [line for line in lines if "SKIPPED" in line],
                      "probed": "[auto-precision] referee" in text,
                      "reused": "reusing persisted plan" in text,
                      "launches": dict(kernels.LAUNCHES)}
        if name == "checkpoint":
            out["plan_file_written"] = os.path.isfile(plan_path)
    print(json.dumps({"auto_plan": out}))
    label, err = out["checkpoint"]["plan"]
    check_gates("11b --hvp_precision auto", {
        "the plan names each probed arm with error and speed":
            [a[0] for a in out["checkpoint"]["arms"]] == out["checkpoint"]["logged"] != [],
        "chosen arm within the bar, or the referee": err <= AUTO_TOL
        or label.startswith("referee fallback"),
        "plan file next to the checkpoint": out["plan_file_written"],
        "second run reuses, no probe": out["reuse"]["reused"] and not out["reuse"]["probed"],
        "--reprobe probes again": out["reprobe"]["probed"],
        "init resolves a plan": out["init"]["plan"] is not None,
        "no probe arm skipped": not any(out[name]["skipped"] for name, _, _ in runs),
    })
    return out


def precision_check_default(spectrum_cli, ckpt: str) -> dict:
    """Phase 11c: --precision_check with --hvp_precision default on the
    checkpoint: the report line, and the warning iff the bar breaks."""
    torch.cuda.empty_cache()
    _, lines, err, main_s = run_cli_both(spectrum_cli, CKPT_BASE + [
        "--checkpoint", ckpt, "--hvp_precision", "default", "--precision_check",
        "--precision_check_iters", str(PRECISION_CHECK_ITERS), "--lanczos_iters", "2"])
    ritz, matvec = (float(x) for x in reported(
        lines, rf"^\[precision\] HVP extreme-Ritz rel err vs f32 referee \({PRECISION_CHECK_ITERS} iters\): "
               r"([\d.e+-]+)  \(matvec rel err ([\d.e+-]+);"))
    warned = "exceeds the 0.002 parity bar" in err
    res = {"ritz_rel_err": ritz, "rel_err": matvec, "warned": warned, "main_s": main_s}
    if ritz <= CHECK_BAR:
        res["finding"] = "--hvp_precision default stays within the 2e-3 bar at the checkpoint"
    print(json.dumps({"precision_check_default": res}))
    check_gates("11c --precision_check", {"warns iff the bar breaks": warned == (ritz > CHECK_BAR)})
    return res


def float64_arms(wls: dict) -> dict:
    """Phase 11d: the fp32 referee against blocks in float64 (head fp32)
    and against the whole model in float64, at the checkpoint."""
    from hessian_llm_vision_tpu_torch.krylov import driver

    torch.cuda.empty_cache()
    wl, factory = wls["checkpoint"]
    arms = {"blocks_f64": factory("F64_F64_F64"),
            "whole_f64": lambda p, b: wl.loss_fn({n: t.double() for n, t in p.items()}, b)}
    out = {}
    for name, loss in arms.items():
        torch.cuda.reset_peak_memory_stats()
        out[name] = _probe(driver, wl, wl.loss_fn, "highest", referee_loss_fn=loss,
                           referee_precision="highest")
        out[name]["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
    del arms
    print(json.dumps({"float64_arms": out}))
    check_gates("11d float64 arms", {"finite": all(
        math.isfinite(r["rel_err"]) and math.isfinite(r["ritz_rel_err"]) for r in out.values())})
    return out


def guarded_training(train_cli, kernels, ckpt: str, tmp: str) -> dict:
    """Phase 11e: phase 4's LanczosSGD from the checkpoint with
    --refresh_precision auto --precision_recheck 1: the guard's tier,
    events and summary; each rank-k kernel once per step plus 2 x 2 x
    GUARD_RITZ_ITERS CGS2 launches per probe."""
    runs = os.path.join(tmp, "runs11")
    argv = TRAIN_ARGV + ["--checkpoint", ckpt, "--dataset", f"local:{STDLIB}", "--out", runs,
                         "--refresh_precision", "auto", "--precision_recheck", "1"]
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    records, main_s = _train(train_cli, argv)
    launches = dict(kernels.LAUNCHES)
    (path,) = glob.glob(os.path.join(runs, "**", "precision_guard.json"), recursive=True)
    with open(path) as f:
        summary = json.load(f)
    probes = len(summary["events"])
    res = {"steps": records, "main_s": main_s, "summary": summary, "launches": launches,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps({"guarded_training": res}))
    expected = 4 + probes * 2 * 2 * GUARD_RITZ_ITERS
    check_gates("11e the refresh precision guard", {
        "4 steps": len(records) == 4,
        "finite losses and eigenvalues": all(math.isfinite(v) for r in records for v in r.values()),
        "an initial and a periodic probe": [e["trigger"] for e in summary["events"]][:1]
        == ["initial"] and "periodic" in {e["trigger"] for e in summary["events"]},
        f"each kernel once per step + CGS2 ({expected})": all(launches[k] == expected
                                                              for k in TPU_KERNELS),
    })
    return res


def precision_card_vs_cpu(spectrum_cli, train_cli, tmp: str) -> dict:
    """Phase 11f: gpt2-tiny, card against CPU: --hvp_precision high with
    --precision_check, and --bf16 Adam losses, with the card's f32 run as
    the control that the step-0 limit must tell apart."""
    reads = {}
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        for dev, extra in (("card", []), ("cpu", ["--cpu"])):
            spec, lines, _, _ = run_cli_both(spectrum_cli, TINY_SPECTRUM_ARGV + [
                "--host_loop", "--precision_check"] + extra)
            ritz = float(reported(lines, r"referee \(10 iters\): ([\d.e+-]+)")[0])
            recs, _ = _train(train_cli, TINY_BF16_ARGV + ["--out", os.path.join(tmp, "bf16")]
                             + extra)
            reads[dev] = (spec, ritz, [r["loss"] for r in recs])
        f32, _ = _train(train_cli, [a for a in TINY_BF16_ARGV if a != "--bf16"]
                        + ["--out", os.path.join(tmp, "f32")])
    (card, ritz_card, loss_card), (cpu, ritz_cpu, loss_cpu) = reads["card"], reads["cpu"]
    rel = [abs(a / b - 1) for a, b in zip(loss_card, loss_cpu)]
    res = {"high_extremes_rel": extremes_rel(card.eigvals, cpu.eigvals),
           "check_ritz_rel_err": [ritz_card, ritz_cpu],
           "bf16_step0_rel": rel[0], "bf16_loss_rel": max(rel),
           "f32_control_step0_rel": abs(f32[0]["loss"] / loss_cpu[0] - 1),
           "bf16_losses": [loss_card, loss_cpu], "f32_control_losses": [r["loss"] for r in f32]}
    print(json.dumps({"precision_card_vs_cpu": res}))
    check_gates("11f gpt2-tiny card against CPU", {
        "high extremes": res["high_extremes_rel"] <= CARD_CPU_LAMBDA_RTOL,
        "high against highest is 0 on both": ritz_card == ritz_cpu == 0,
        "bf16 step-0 loss": res["bf16_step0_rel"] <= TINY_BF16_STEP0_RTOL,
        "the f32 control misses the step-0 limit":
            res["f32_control_step0_rel"] > TINY_BF16_STEP0_RTOL,
        "bf16 Adam drift": res["bf16_loss_rel"] <= TINY_BF16_DRIFT_RTOL and len(loss_card) == 3,
    })
    return res


def precision_ladder(train_cli, spectrum_cli, kernels, ckpt: str, tmp: str) -> dict:
    """Phase 11: 11a-11f on phase 10's 600-step checkpoint; 11a, 11b and
    11d share one workload at init and one at the checkpoint."""
    t0 = time.perf_counter()
    wls = {"init": _probe_workload(spectrum_cli, None),
           "checkpoint": _probe_workload(spectrum_cli, ckpt)}
    workloads_s = time.perf_counter() - t0
    print(f"phase 11 workloads took {workloads_s:.1f} s", flush=True)
    steps = (("11a", lambda: tier_map(kernels, wls)),
             ("11b", lambda: auto_plan(spectrum_cli, kernels, ckpt, wls)),
             ("11c", lambda: precision_check_default(spectrum_cli, ckpt)),
             ("11d", lambda: float64_arms(wls)),
             ("11e", lambda: guarded_training(train_cli, kernels, ckpt, tmp)),
             ("11f", lambda: precision_card_vs_cpu(spectrum_cli, train_cli, tmp)))
    out = {}
    for name, run in steps:
        t0 = time.perf_counter()
        out[name] = run()
        out[name]["phase_s"] = time.perf_counter() - t0
        print(f"phase {name} took {out[name]['phase_s']:.1f} s", flush=True)
        if name == "11d":
            wls.clear()
    out["11a"]["workloads_s"] = workloads_s
    return out


def precision_summary(prec: dict) -> dict:
    """The {"precision": ...} line: phase 11's readings."""
    a11 = prec["11a"]
    return {
        "11a_tiers": {point: {arm: {k: a11[point][arm][k] for k in (
            "rel_err", "ritz_rel_err", "ms_per_hvp", "referee_ms_per_hvp")}
            for arm in PROBE_ARMS} for point in ("init", "checkpoint")},
        "11a_block0_tf32": a11["block0_tf32"],
        "11b_auto": {name: {"plan": r["plan"], "arms": r["arms"], "reused": r["reused"]}
                     for name, r in prec["11b"].items() if isinstance(r, dict)},
        "11c_check_default": {k: prec["11c"][k] for k in ("ritz_rel_err", "rel_err", "warned")},
        "11d_float64": {name: {k: r[k] for k in ("rel_err", "ritz_rel_err", "ms_per_hvp",
                                                  "referee_ms_per_hvp",
                                                  "max_memory_allocated_bytes")}
                        for name, r in prec["11d"].items() if isinstance(r, dict)},
        "11e_guard": {k: prec["11e"]["summary"][k] for k in ("final_tier", "final_precision",
                                                             "escalations")}
        | {"probes": len(prec["11e"]["summary"]["events"]),
           "losses": [r["loss"] for r in prec["11e"]["steps"]]},
        "11f_card_vs_cpu": {k: prec["11f"][k] for k in (
            "high_extremes_rel", "bf16_step0_rel", "bf16_loss_rel", "f32_control_step0_rel")},
        "phase_s": {name: r["phase_s"] for name, r in prec.items()},
    }


def trained_checkpoint(train_cli, spectrum_cli, kernels, after=None) -> dict:
    """Phase 10: 10a-10d, then ``after(ckpt, tmp)`` (phase 11) as
    ``out["after"]``, with every checkpoint in a temporary directory
    deleted at the end."""
    from hessian_llm_vision_tpu_torch.data.text import load_local_corpus

    corpus = load_local_corpus(STDLIB, max_length=512, batch_size=8)["input_ids"]
    print(f"[10] corpus local:{STDLIB}: {corpus.size} bytes in {corpus.shape[0]} batches of "
          f"8 x 512", flush=True)
    out = {"corpus": {"path": STDLIB, "bytes": int(corpus.size), "batches": corpus.shape[0]}}
    del corpus
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["10a"], ckpt = adam_save_resume_124m(train_cli, tmp)
        print(f"phase 10a took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["10b"] = checkpoint_spectrum_124m(spectrum_cli, ckpt)
        print(f"phase 10b took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["10c"] = lanczos_sgd_from_checkpoint(train_cli, kernels, ckpt, tmp)
        print(f"phase 10c took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["10d"] = tiny_adam_card_vs_cpu(train_cli, tmp)
        print(f"phase 10d took {time.perf_counter() - t0:.1f} s")
        if after is not None:
            out["after"] = after(ckpt, tmp)
    return out


def _rel(a: float, b: float) -> float:
    return abs(a / b - 1) if b else abs(a)


def fused_lanczos_124m(train_cli, kernels, phase4: list) -> dict:
    """Phase 12a: phase 4's training with --optimiser lanczos (the fused
    step: CGS2 Lanczos, an f32 (10, P) basis), each adjust's basis shape
    recorded."""
    from hessian_llm_vision_tpu_torch.optim import lanczos_sgd

    shapes = []
    adjust = lanczos_sgd.spectral_adjust

    def recording(g, basis, eigvals, delta):
        shapes.append([*basis.shape, str(basis.dtype).removeprefix("torch.")])
        return adjust(g, basis, eigvals, delta)

    lanczos_sgd.spectral_adjust = recording
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        records, run_s = _train(train_cli, FUSED_ARGV)
        launches = dict(kernels.LAUNCHES)
    finally:
        lanczos_sgd.spectral_adjust = adjust
    out = {"steps": records, "run_s": run_s, "launches": launches, "adjust_shapes": shapes,
           "loss_rel_vs_phase4": _rel(records[0]["loss"], phase4[0]["loss"]),
           "eig_max_rel_vs_phase4": _rel(records[0]["eig_max"], phase4[0]["eig_max"]),
           "refresh_step_s": [r["seconds"] for r in records[::2]],
           "frozen_step_s": [r["seconds"] for r in records[1::2]],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps({"fused_lanczos_124m": out}))
    check_gates("12a fused LanczosSGD", {
        f"{FUSED_STEPS} steps": len(records) == FUSED_STEPS,
        "finite": all(math.isfinite(v) for r in records for v in r.values()),
        "each kernel once per step": all(launches[n] == FUSED_STEPS for n in TPU_KERNELS),
        "every adjust at (10, P) f32": shapes == [[10, P_124M, "float32"]] * FUSED_STEPS,
        "step 0 loss as phase 4's": out["loss_rel_vs_phase4"] <= FUSED_LOSS_RTOL,
        "step 0 eig_max as phase 4's": out["eig_max_rel_vs_phase4"] <= FUSED_EIG_RTOL,
    })
    return out


def second_order_124m(train_cli, kernels) -> dict:
    """Phase 12b: --optimiser gn and ngd, SECOND_ORDER_STEPS each at the defaults; then
    one GN step called directly, its reported CG residual against
    ‖(G + λI)x − g‖ recomputed from a fresh GGN matvec and gradient."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.ggn import GGNOperator
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
    from hessian_llm_vision_tpu_torch.optim.second_order import make_gauss_newton_step
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    out = {}
    for opt in ("gn", "ngd"):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        records, run_s = _train(train_cli, SECOND_ORDER_ARGV + [
            "--optimiser", opt, "--max_steps", str(SECOND_ORDER_STEPS)])
        out[opt] = {"steps": records, "run_s": run_s, "launches": dict(kernels.LAUNCHES),
                    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    args = train_cli.build_parser().parse_args(SECOND_ORDER_ARGV + ["--optimiser", "gn"])
    wl = build_workload(args, CARD)
    fl, batch = Flattener(wl.params), wl.batches[0]
    step = make_gauss_newton_step(wl.model_fn, wl.out_loss_fn, wl.loss_fn, wl.params, lr=1.0,
                                  damping=args.damping, cg_iters=args.cg_iters)
    new, metrics = step(wl.params, batch)
    x = fl.flatten(wl.params) - fl.flatten(new)  # lr 1: the CG solution
    del new
    g = fl.flatten(grad_and_loss(wl.loss_fn, wl.params, batch)[1])
    op = GGNOperator(wl.model_fn, wl.out_loss_fn, wl.params, batch, damping=args.damping,
                     flattener=fl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    residual = float(torch.linalg.vector_norm(op.matvec(x) - g))
    out["residual"] = {"reported": float(metrics["cg_residual"]), "recomputed": residual,
                       "cg_iters": metrics["cg_iters"], "g_norm": float(
                           torch.linalg.vector_norm(g)), "matvec_s": time.perf_counter() - t0}
    out["residual"]["rel"] = _rel(out["residual"]["reported"], residual)
    del wl, x, g, op
    print(json.dumps({"second_order_124m": out}))
    check_gates("12b Gauss-Newton and natural gradient", {
        **{f"{opt}: {SECOND_ORDER_STEPS} steps, finite loss":
           len(out[opt]["steps"]) == SECOND_ORDER_STEPS and all(
            math.isfinite(r["loss"]) for r in out[opt]["steps"]) for opt in ("gn", "ngd")},
        **{f"{opt}: cg_iters <= {CG_MAX_ITERS}": all(
            1 <= r["cg_iters"] <= CG_MAX_ITERS for r in out[opt]["steps"]) for opt in ("gn", "ngd")},
        **{f"{opt}: no rank-k launch": not any(out[opt]["launches"].values())
           for opt in ("gn", "ngd")},
        "the CG residual recomputed": out["residual"]["rel"] <= CG_RESIDUAL_RTOL,
    })
    return out


def layerwise_training_124m(train_cli, kernels, spectral) -> dict:
    """Phases 12c, 12d and 12f on one GPT-2 124M workload (TRAIN_ARGV's
    params and first batch).  12d: the fused layer-wise step on wte alone,
    one step from the init.  12c: HostLayerwiseLanczosSGDTrainer on wte and
    LAYER_LEAVES - 1 MLP kernels (bf16 bases), k=4, refresh_every 2, 2 steps from the
    init, each step's launches counted; the frozen step replayed with the
    plain rank-k apply.  12f: the frozen-spectrum transforms on 12c's
    gradient with an orthonormal (10, P) basis."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.optim import LanczosSGDConfig
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd import make_layerwise_lanczos_sgd_step
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import HostLayerwiseLanczosSGDTrainer
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    torch.cuda.empty_cache()
    wl = build_workload(train_cli.build_parser().parse_args(TRAIN_ARGV), CARD)
    batch, fl = wl.batches[0], Flattener(wl.params)
    cfg = LanczosSGDConfig(k=LAYER_K, delta=1e-4, lr=1e-3, momentum=0.9, refresh_every=2,
                           normalization="sum")
    out = {}
    # 12d, before 12c's trainer moves the params in place
    init, step = make_layerwise_lanczos_sgd_step(wl.loss_fn, wl.params, cfg,
                                                 batch_size=wl.batch_size,
                                                 min_leaf_size=WTE_MIN_LEAF)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st, m = step(init(wl.params), batch)
    torch.cuda.synchronize()
    out["12d"] = {"seconds": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
                  "layer_eig_max": m["layer_eig_max"].tolist(),
                  "layer_eig_min": m["layer_eig_min"].tolist(),
                  "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    del st, m, init, step
    # 12c
    trainer = HostLayerwiseLanczosSGDTrainer(wl.loss_fn, wl.params, cfg, batch_size=wl.batch_size,
                                             basis_dtype=torch.bfloat16,
                                             min_leaf_size=LAYER_MIN_LEAF)
    # wte (last in flat order) and the first MLP kernels: each leaf's plan
    # and replay read as with all 24
    trainer.active = trainer.active[:LAYER_LEAVES - 1] + trainer.active[-1:]
    state = trainer.init(wl.params)
    grads = []
    grad = trainer._grad

    def keep_grad(params, b):
        loss, g = grad(params, b)
        grads[:] = [g]
        return loss, g

    trainer._grad = keep_grad
    steps = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        if i == 1:
            p_old, buf_old = fl.flatten(state.params), fl.flatten(state.momentum)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch)
        torch.cuda.synchronize()
        steps.append({"seconds": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
                      "loss": float(m["loss"])})
        if i == 0:
            ritz = {label: ev.tolist() for (label, *_), ev in zip(trainer.active, state.eigvals)}
    g = grads[0]
    # the plans the step's per-leaf launches took: the wrappers' pure,
    # cached plan of each leaf's basis and slice of the flat gradient
    plans = []
    for (label, off, size, _), V in zip(trainer.active, state.bases):
        ptrs = (V.data_ptr(), g.data_ptr() + 4 * off)
        dots = kernels.dots_launch_plan(V.shape[0], size, V.dtype, CARD, ptrs)
        axpy = kernels.axpy_launch_plan(V.shape[0], size, V.dtype, CARD, ptrs)
        plans.append({"leaf": label, "k": V.shape[0], "P": size, "g_byte_offset": 4 * off,
                      "g_aligned": ptrs[1] % 16 == 0, "dots_aligned": dots.aligned,
                      "axpy": {f: getattr(axpy, f) for f in ("ring", "vec_v", "vec_g", "rows",
                                                              "nblocks")}})
    print(json.dumps({"12c_launch_plans": plans}))
    adj = g.clone()
    for (_, off, size, _), V, ev in zip(trainer.active, state.bases, state.eigvals):
        adj[off:off + size] = spectral.spectral_adjust_reference(g[off:off + size], V, ev,
                                                                 cfg.delta)
    replay = p_old - cfg.lr * (cfg.momentum * buf_old + adj)
    update = fl.flatten(state.params) - p_old
    out["12c"] = {"leaves": [a[0] for a in trainer.active], "steps": steps, "ritz": ritz,
                  "replay_rel": rel_l2(update, replay - p_old),
                  "refresh_masked_hvps": sum(a[3] for a in trainer.active),
                  "launch_plans": {"g_aligned": sum(p["g_aligned"] for p in plans),
                                   "dots_aligned": sum(p["dots_aligned"] for p in plans),
                                   "axpy_ring": sum(p["axpy"]["ring"] for p in plans),
                                   "leaves": len(plans)},
                  "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    del adj, replay, update, p_old, buf_old
    wte = ritz["wte"]
    out["12d"]["rel_vs_12c"] = max(_rel(out["12d"]["layer_eig_max"][0], wte[-1]),
                                   _rel(out["12d"]["layer_eig_min"][0], wte[0]))
    out["12f"] = projections_124m(kernels, spectral, fl, g)
    print(json.dumps({"layerwise_training_124m": out}))
    check_gates("12c/12d layer-wise LanczosSGD", {
        f"{LAYER_LEAVES} leaves": len(trainer.active) == LAYER_LEAVES,
        f"{LAYER_LEAVES} launches of each kernel per step": all(
            s["launches"][n] == LAYER_LEAVES for s in steps for n in TPU_KERNELS),
        "finite Ritz values": all(math.isfinite(v) for ev in ritz.values() for v in ev),
        "wte lambda_max > 0": wte[-1] > 0,
        "frozen step = plain-version replay": out["12c"]["replay_rel"] <= REPLAY_RTOL,
        "12d: one leaf, each kernel once": out["12d"]["launches"] == {n: 1 for n in TPU_KERNELS}
        and len(out["12d"]["layer_eig_max"]) == 1,
        "12d: wte extremes as 12c's": out["12d"]["rel_vs_12c"] <= WTE_RITZ_RTOL,
    })
    del trainer, state, wl, g
    return out


def projections_124m(kernels, spectral, fl, g: torch.Tensor) -> dict:
    """Phase 12f: project_gradients and frozen_spectral_adjust with an
    orthonormal (10, P) basis (CGS2 rows of a seeded draw) in f32 and bf16,
    against the plain version; the projection's leak ‖V g_out‖ / ‖g‖."""
    from hessian_llm_vision_tpu_torch.optim.projection import (
        frozen_spectral_adjust,
        project_gradients,
    )

    gen = torch.Generator(device=CARD).manual_seed(12)
    Q = torch.empty((10, fl.size), device=CARD)
    for i in range(10):
        v = torch.randn(fl.size, generator=gen, device=CARD)
        for _ in range(2):
            v -= Q[:i].T @ (Q[:i] @ v)
        Q[i] = v / torch.linalg.vector_norm(v)
    eigvals = torch.linspace(-2.0, 50.0, 10, device=CARD)
    out = {}
    for dtype in TIMED_DTYPES:
        V = Q.to(dtype)
        kernels.reset_launch_counts()
        tx = project_gradients(V, fl)
        proj = fl.flatten(tx.update(fl.unflatten(g), tx.init(None))[0])
        tx = frozen_spectral_adjust(V, eigvals, 1e-4, fl)
        frozen = fl.flatten(tx.update(fl.unflatten(g), tx.init(None))[0])
        launches = dict(kernels.LAUNCHES)
        name = str(dtype).removeprefix("torch.")
        out[name] = {
            "launches": launches,
            "project_rel_vs_plain": rel_l2(proj, spectral.project_out_reference(g, V)),
            "leak": float(torch.linalg.vector_norm(V.float() @ proj)
                          / torch.linalg.vector_norm(g)),
            "frozen_equals_spectral_adjust": torch.equal(
                frozen, spectral.spectral_adjust(g, V, eigvals, 1e-4)),
            "frozen_rel_vs_plain": rel_l2(frozen, spectral.spectral_adjust_reference(
                g, V, eigvals, 1e-4)),
        }
        del V, proj, frozen
    del Q
    check_gates("12f frozen-spectrum transforms", {
        **{f"{d}: kernel as plain": r["project_rel_vs_plain"] <= PROJECTION_RTOL
           and r["frozen_rel_vs_plain"] <= PROJECTION_RTOL for d, r in out.items()},
        **{f"{d}: leak": r["leak"] <= PROJECTION_LEAK for d, r in out.items()},
        **{f"{d}: frozen adjust = spectral_adjust": r["frozen_equals_spectral_adjust"]
           for d, r in out.items()},
        **{f"{d}: each kernel twice": r["launches"] == {n: 2 for n in TPU_KERNELS}
           for d, r in out.items()},
    })
    return out


def snapshots_124m(train_cli, kernels, spectra) -> dict:
    """Phase 12e: Adam, 2 steps, with a SNAPSHOT_ITERS-iteration T-only
    snapshot after each and a reorthogonalised post-training spectrum as deep (the
    format's full read-back is tests/test_torch_train_ext_cli.py's)."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        records, run_s = _train(train_cli, SNAPSHOT_ARGV + ["--out", tmp])
        launches = dict(kernels.LAUNCHES)
        tfiles = sorted(glob.glob(os.path.join(tmp, "**", "T_step*.npz"), recursive=True))
        tri = [spectra.load_tridiag(f) for f in tfiles]
        (eig,) = glob.glob(os.path.join(tmp, "**", "eigenspace.npz"), recursive=True)
        # eigenvalues and weights read back; the 5 GB of Ritz vectors by their header
        with np.load(eig) as z:
            eigvals, gammas = z["eigvals"], z["gammas"]
            with z.zip.open("V.npy") as f:
                np.lib.format.read_magic(f)
                v_shape = np.lib.format.read_array_header_1_0(f)[0]
    out = {"steps": records, "run_s": run_s, "launches": launches,
           "snapshots": [os.path.basename(f) for f in tfiles],
           "snapshot_shapes": [[len(a), len(b)] for a, b in tri],
           "lambda_max": float(eigvals.max()), "lambda_min": float(eigvals.min()),
           "gamma_sum": float(gammas.astype(np.float64).sum()),
           "ritz_vectors_shape": list(v_shape),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps({"snapshots_124m": out}))
    check_gates("12e snapshots and post-training spectrum", {
        "two T files read back": out["snapshots"] == ["T_step000000.npz", "T_step000001.npz"]
        and out["snapshot_shapes"] == [[SNAPSHOT_ITERS, SNAPSHOT_ITERS - 1]] * 2,
        "finite": all(math.isfinite(v) for a, b in tri for v in (*a, *b)),
        "weights sum to 1": abs(out["gamma_sum"] - 1) <= 1e-5,
        "lambda_max > 0": out["lambda_max"] > 0,
        f"ritz vectors ({SNAPSHOT_ITERS}, P)":
            out["ritz_vectors_shape"] == [SNAPSHOT_ITERS, P_124M],
        "no rank-k launch": not any(launches.values()),
    })
    return out


def hvp_trace_124m() -> dict:
    """Phase 12g: torch.profiler around one GPT-2 124M HVP (phase 6's
    shapes), read back by obs.trace_summary: the top device ops and their
    share of the traced wall (first to last event)."""
    from hessian_llm_vision_tpu_torch.curvature.hvp import hvp_fn
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.losses import lm_loss_fn
    from hessian_llm_vision_tpu_torch.obs import profile_trace, summarize_trace, trace_summary
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    torch.cuda.empty_cache()
    B, T = 8, 512
    cfg = GPT2Config.gpt2_124m(n_positions=T)
    model = GPT2LMHead(cfg, generator=torch.Generator().manual_seed(0)).to(CARD)
    params = {n: p.detach() for n, p in model.named_parameters()}
    gen = torch.Generator(device=CARD).manual_seed(7)
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=CARD)
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids)}
    fl = Flattener(params)
    v = fl.unflatten(torch.randn(fl.size, generator=gen, device=CARD) / math.sqrt(fl.size))
    hvp = hvp_fn(lm_loss_fn(model), normalization="sum", batch_size=B)
    hvp(params, batch, v)  # warm-up
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp):
            t0 = time.perf_counter()
            hvp(params, batch, v)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        events = trace_summary.load_trace_events(tmp)
        rows, found = trace_summary.device_rows(events)
        top = summarize_trace(tmp, top=TRACE_TOP)
        read_s = time.perf_counter() - t0
        trace_bytes = os.path.getsize(trace_summary.find_trace_file(tmp))
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X" and "dur" in e]
    wall_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    device_ms = sum(e["dur"] for e in rows) / 1e3
    out = {"host_s": host_s, "traced_wall_ms": wall_ms, "device_ms": device_ms,
           "device_share": device_ms / wall_ms, "device_rows": len(rows),
           "found_by": found, "events": len(events), "trace_bytes": trace_bytes,
           "read_s": read_s,
           "top": [{"name": name[:120], "ms": ms, "share_of_wall": ms / wall_ms}
                   for name, ms, _ in top]}
    print(json.dumps({"hvp_trace_124m": out}))
    check_gates("12g the HVP's trace", {
        "device rows found": len(rows) > 0,
        "device time within the traced wall": device_ms <= wall_ms,
    })
    return out


def _records_rel(a: list, b: list, key: str) -> float:
    vals = [(x, y) for ra, rb in zip(a, b, strict=True)
            for x, y in zip(np.ravel(ra[key]), np.ravel(rb[key]), strict=True)]
    return max(_rel(x, y) for x, y in vals)


def train_ext_card_vs_cpu(train_cli) -> dict:
    """Phase 12h: gpt2-tiny through cli.train.main, card against CPU: every
    new optimiser and the snapshot and post-spectrum flags (their draws
    differ between the two generators, so only losses are held); then
    --tensorboard, or its exit naming the package where it is missing."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp, open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(null):
        for name, argv in TINY_TRAIN_CASES.items():
            recs = ([], [])
            for r, extra in zip(recs, (["--out", os.path.join(tmp, "card")],
                                       ["--cpu", "--out", os.path.join(tmp, "cpu")])):
                train_cli.main(TINY_TRAIN_EXT + argv + extra,
                               on_step=lambda s, rec, r=r: r.append(rec))
            out[name] = {"loss_rel": _records_rel(*recs, "loss"), "steps": len(recs[0])}
            ritz = [k for k in ("eig_max", "eig_min", "layer_eig_max", "layer_eig_min")
                    if k in recs[0][0]]
            if ritz:
                out[name]["ritz_rel"] = max(_records_rel(*recs, k) for k in ritz)
        out["snapshot_files"] = len(glob.glob(os.path.join(tmp, "**", "T_step*.npz"),
                                              recursive=True))
        tb = TINY_TRAIN_EXT + ["--optimiser", "sgd", "--max_steps", "1", "--tensorboard",
                               "--out", tmp]
        try:
            import torch.utils.tensorboard  # noqa: F401
        except ImportError:
            try:
                train_cli.main(tb)
                out["tensorboard"] = "ran without the package"
            except SystemExit as e:
                out["tensorboard"] = f"exit: {e}"
        else:
            train_cli.main(tb)
            out["tensorboard"] = "event files: " + str(len(glob.glob(
                os.path.join(tmp, "**", "events.out.tfevents.*"), recursive=True)))
    print(json.dumps({"train_ext_card_vs_cpu": out}))
    cases = [n for n in TINY_TRAIN_CASES]
    check_gates("12h card against CPU", {
        **{f"{n}: losses": out[n]["loss_rel"] <= TINY_TRAIN_LOSS_RTOL for n in cases},
        **{f"{n}: Ritz extremes": out[n]["ritz_rel"] <= TINY_TRAIN_RITZ_RTOL
           for n in cases if "ritz_rel" in out[n]},
        "Ritz values compared for the three LanczosSGD modes": sum(
            "ritz_rel" in out[n] for n in cases) == 3,
        "snapshot files (2 steps x card and CPU)": out["snapshot_files"] == 4,
        "--tensorboard ran or named the package": out["tensorboard"].startswith(
            ("event files: ", "exit: --tensorboard needs the 'tensorboard' package"))
        and out["tensorboard"] != "event files: 0",
    })
    return out


def rest_of_training(train_cli, kernels, spectral, spectra, phase4: list) -> dict:
    """Phase 12: 12a-12h, each part timed."""
    parts = (("12a", lambda: fused_lanczos_124m(train_cli, kernels, phase4)),
             ("12b", lambda: second_order_124m(train_cli, kernels)),
             ("12cdf", lambda: layerwise_training_124m(train_cli, kernels, spectral)),
             ("12e", lambda: snapshots_124m(train_cli, kernels, spectra)),
             ("12g", hvp_trace_124m),
             ("12h", lambda: train_ext_card_vs_cpu(train_cli)))
    out = {}
    for name, run in parts:
        t0 = time.perf_counter()
        out[name] = run()
        out[name + "_s"] = time.perf_counter() - t0
        print(f"phase {name} took {out[name + '_s']:.1f} s", flush=True)
    return out


def train_ext_summary(ext: dict) -> dict:
    """The {"train_ext": ...} line: phase 12's readings."""
    a, b, lw, e, g = ext["12a"], ext["12b"], ext["12cdf"], ext["12e"], ext["12g"]
    return {
        "phase_s": {k: v for k, v in ext.items() if k.endswith("_s")},
        "12a_fused": {"refresh_step_s": a["refresh_step_s"], "frozen_step_s": a["frozen_step_s"],
                      "eig_max_rel_vs_phase4": a["eig_max_rel_vs_phase4"],
                      "max_memory_allocated_bytes": a["max_memory_allocated_bytes"]},
        "12b": {opt: {"step_s": [r["seconds"] for r in b[opt]["steps"]],
                      "cg_iters": [r["cg_iters"] for r in b[opt]["steps"]],
                      "max_memory_allocated_bytes": b[opt]["max_memory_allocated_bytes"]}
                for opt in ("gn", "ngd")} | {"residual_rel": b["residual"]["rel"]},
        "12c_host_layerwise": {"step_s": [s["seconds"] for s in lw["12c"]["steps"]],
                               "masked_hvps": lw["12c"]["refresh_masked_hvps"],
                               "replay_rel": lw["12c"]["replay_rel"],
                               "max_memory_allocated_bytes":
                                   lw["12c"]["max_memory_allocated_bytes"]},
        "12d_fused_layerwise_wte": {k: lw["12d"][k] for k in ("seconds", "rel_vs_12c")},
        "12e": {"run_s": e["run_s"], "lambda_max": e["lambda_max"]},
        "12f_leak": {d: r["leak"] for d, r in lw["12f"].items()},
        "12g_trace": {k: g[k] for k in ("traced_wall_ms", "device_ms", "device_share",
                                        "found_by", "top")},
    }


# ---------------------------------------------------------------------------
# phase 13: the other language-model families at full width


def _spectrum_gates(what: str, spec, back, iters: list, n_iters: int) -> dict:
    """13a's gates on a T-only spectrum: finite Ritz values, lambda_max > 0
    > lambda_min, the weights summing to 1 within 1e-6, |trace| <= 1e-2
    lambda_max, the artifact read back."""
    ev = spec.eigvals
    lam_max, lam_min = float(ev.max()), float(ev.min())
    trace = float(torch.dot(spec.eigvals.double(), spec.gammas.double()))
    gamma_sum = float(spec.gammas.double().sum())
    check_gates(what, {
        f"{n_iters} iterations timed": len(iters) == n_iters,
        "finite Ritz values": bool(torch.isfinite(ev).all()),
        "lambda_max > 0 > lambda_min": lam_max > 0 > lam_min,
        "gammas sum to 1 within 1e-6": abs(gamma_sum - 1) <= LM_GAMMA_TOL,
        "|trace| <= 1e-2 lambda_max": abs(trace) <= 1e-2 * lam_max,
        "artifact reads back": all(torch.equal(a, b) for a, b in
                                   ((back.eigvals, spec.eigvals), (back.gammas, spec.gammas))),
    })
    return {"lambda_max": lam_max, "lambda_min": lam_min, "trace_estimate": trace,
            "gamma_sum": gamma_sum}


@contextlib.contextmanager
def _init_seconds():
    """The seconds of each model init the CLIs run inside the block
    (``cli.workloads.init_model``, synchronised with the card), appended to
    the yielded list."""
    from hessian_llm_vision_tpu_torch.cli import workloads

    seconds, init_model = [], workloads.init_model

    def timed(*args, **kw):
        t0 = time.perf_counter()
        model = init_model(*args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return model

    workloads.init_model = timed
    try:
        yield seconds
    finally:
        workloads.init_model = init_model


def lm_spectrum(spectrum_cli, spectra, kernels, argv, what: str,
                expect_line: str | None = None) -> dict:
    """A T-only host-loop spectrum through cli.spectrum.main from fresh
    memory: 13a's gates, the peak, the seconds per iteration and the init
    seconds of an LM (``cli.workloads.init_model``); no rank-k launch, and
    ``expect_line`` among the CLI's lines when given."""
    n_iters = int(argv[argv.index("--lanczos_iters") + 1])
    with tempfile.TemporaryDirectory() as tmp, _init_seconds() as init_s:
        path = os.path.join(tmp, "spec")
        spec, lines, iters, main_s, peak, launches = _peak_run(
            spectrum_cli, kernels, argv + ["--out_spectrum", path])
        back = spectra.load_spectrum(path)
    res = {"iters": n_iters, "iter_s": {"median": statistics.median(iters), "min": min(iters),
                                        "max": max(iters), "first": iters[0]},
           "init_s": init_s[0] if init_s else None, "main_s": main_s,
           "cli_wall_s": cli_wall_s(lines), "max_memory_allocated_bytes": peak,
           "rank_k_launches": launches, **_spectrum_gates(what, spec, back, iters, n_iters)}
    gates = {"no rank-k launch": all(n == 0 for n in launches.values())}
    if expect_line is not None:
        gates[f"printed {expect_line!r}"] = expect_line in lines
    check_gates(what, gates)
    return res


@contextlib.contextmanager
def _adjust_calls(kernels, keep: bool, later_steps: bool = False):
    """Every ``HostLanczosSGDTrainer._adjust_update`` inside the block,
    appended to the first yielded list as (step, basis shape, basis dtype).
    With ``keep``, the second step's (the first frozen one at
    refresh_every 2) inputs and outputs go into the yielded dict: the
    trainer, its state, the gradient, the eigenvalues and the basis, the
    params and momentum before the update (flat copies), pass 1's w and the
    adjusted gradient the trainer's kernel pair returned; with
    ``later_steps`` (a run that goes on after that step) also the params
    after the update (a flat copy)."""
    from hessian_llm_vision_tpu_torch.optim import lanczos_sgd_host as lsh

    calls, snap = [], {}
    adjust, apply, dots = (lsh.HostLanczosSGDTrainer._adjust_update, lsh.spectral_adjust,
                           kernels.rank_k_dots)

    def recorded(self, state, g_flat):
        calls.append((state.step, tuple(state.basis.shape), str(state.basis.dtype)))
        kept = keep and state.step == 1
        if kept:
            snap.update(trainer=self, state=state, g=g_flat, eigvals=state.eigvals.clone(),
                        basis=state.basis, p_old=self.fl.flatten(state.params),
                        buf_old=self.fl.flatten(state.momentum))
        out = adjust(self, state, g_flat)
        if kept and later_steps:
            snap["p_new"] = self.fl.flatten(state.params)
        return out

    def kept_apply(*args):
        adj = apply(*args)
        if snap and "adj" not in snap:
            snap["adj"] = adj
        return adj

    def kept_dots(*args):
        w = dots(*args)
        if snap and "w" not in snap:
            snap["w"] = w.clone()
        return w

    lsh.HostLanczosSGDTrainer._adjust_update = recorded
    lsh.spectral_adjust, kernels.rank_k_dots = kept_apply, kept_dots
    try:
        yield calls, snap
    finally:
        lsh.HostLanczosSGDTrainer._adjust_update = adjust
        lsh.spectral_adjust, kernels.rank_k_dots = apply, dots


def frozen_step_check(spectral, snap: dict) -> dict:
    """The frozen step against the plain versions, in column slices of V
    and g (pass 1 sums its slices' dot products, pass 2 is per column):

    * ``w_rel``: the trainer's pass-1 output w against the plain w;
    * ``term_rel``: the trainer's adjusted gradient against the plain one,
      fl(g + Vᵀw), over the norm of the adjust term Vᵀw itself;
      ``term_floor`` is the plain version's own f32 rounding of g + Vᵀw
      over that norm, the finest difference the comparison resolves, and
      ``term_share`` the term's norm over the adjusted gradient's;
    * ``replay_rel``: the update of the params against a plain replay of
      the momentum step, as 12c's; ``update_floor`` is the replay's own
      f32 rounding of p - lr buf over the update lr buf, the finest
      difference that comparison resolves."""
    trainer, state, g = snap["trainer"], snap["state"], snap["g"]
    cfg, V, adj = trainer.cfg, snap.pop("basis"), snap.pop("adj")
    c = spectral.adjust_coeffs(snap["eigvals"], cfg.delta)
    cols = [(s, s + (1 << 27)) for s in range(0, g.numel(), 1 << 27)]
    w = sum(spectral.rank_k_dots_reference(g[s:e], V[:, s:e], c) for s, e in cols)
    buf = snap.pop("buf_old").mul_(cfg.momentum)
    sq = dict.fromkeys(("diff", "term", "rounding", "adjusted"), 0.0)
    for s, e in cols:
        t = spectral.rank_k_axpy_reference(torch.zeros_like(g[s:e]), V[:, s:e], w)
        a = g[s:e] + t  # = rank_k_axpy_reference(g[s:e], V[:, s:e], w)
        sq["diff"] += float(torch.sum((adj[s:e].double() - a.double()) ** 2))
        sq["term"] += float(torch.sum(t.double() ** 2))
        sq["rounding"] += float(torch.sum((a.double() - g[s:e].double() - t.double()) ** 2))
        sq["adjusted"] += float(torch.sum(a.double() ** 2))
        buf[s:e] += a
        if cfg.weight_decay:
            buf[s:e] += cfg.weight_decay * snap["p_old"][s:e]
        del t, a
    del adj
    term = math.sqrt(sq["term"])
    # the trainer's own rounding: p - (lr buf), both updates relative to p
    p_old = snap.pop("p_old")
    replay = (p_old - float(cfg.lr) * buf).sub_(p_old)
    update_floor = rel_l2(replay, buf.mul_(-float(cfg.lr)))
    del buf
    p_new = snap.pop("p_new") if "p_new" in snap else trainer.fl.flatten(state.params)
    update = p_new.sub_(p_old)
    return {"w_rel": rel_l2(snap["w"], w), "term_rel": math.sqrt(sq["diff"]) / term,
            "term_floor": math.sqrt(sq["rounding"]) / term,
            "term_share": term / math.sqrt(sq["adjusted"]), "replay_rel": rel_l2(update, replay),
            "update_floor": update_floor}


def lm_lanczos_sgd(train_cli, kernels, spectral, argv, what: str, *, replay: bool) -> dict:
    """LanczosSGD through cli.train.main from fresh memory, the launch
    counts zeroed just before and read after each step; with ``replay`` the
    frozen step against a plain-version replay."""
    records, launches = [], []

    def on_step(step, rec):
        torch.cuda.synchronize()
        launches.append(dict(kernels.LAUNCHES))
        kernels.reset_launch_counts()
        records.append(rec)

    n = int(argv[argv.index("--max_steps") + 1])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _adjust_calls(kernels, replay, later_steps=n > 2) as (shapes, snap), \
            _init_seconds() as init_s:
        kernels.reset_launch_counts()
        train_cli.main(argv, on_step=on_step)
    peak = torch.cuda.max_memory_allocated()
    res = {"steps": records, "launches_per_step": launches, "adjust_shapes": shapes,
           "init_s": init_s[0] if init_s else None, "max_memory_allocated_bytes": peak,
           "refresh_step_s": [r["seconds"] for r in records[::2]],
           "frozen_step_s": [r["seconds"] for r in records[1::2]]}
    if replay:
        res["frozen_step"] = frozen_step_check(spectral, snap)
    snap.clear()
    gc.collect()
    torch.cuda.empty_cache()
    gates = {
        f"{n} steps": len(records) == n,
        "finite loss and Ritz values": all(math.isfinite(v) for r in records
                                           for v in (r["loss"], r["eig_max"], r["eig_min"])),
        "each kernel once per step": all(c == {k: 1 for k in TPU_KERNELS} for c in launches),
    }
    if replay:
        fs = res["frozen_step"]
        gates.update({
            "frozen step's pass 1 (w) = the plain version's": fs["w_rel"] <= TERM_RTOL,
            "adjust term resolved (f32 rounding of g + term <= 1e-3 of it)":
                fs["term_floor"] <= TERM_FLOOR_MAX,
            "frozen step's adjust term = the plain version's, within 1e-5 + that rounding":
                fs["term_rel"] <= TERM_RTOL + fs["term_floor"],
            "frozen step = plain-version replay": fs["replay_rel"] <= REPLAY_RTOL,
        })
    check_gates(what, gates)
    return res


def pythia_1p4b(spectrum_cli, train_cli, spectra, kernels, spectral) -> dict:
    """13a and 13b: Pythia-1.4B at full width and depth."""
    out = {"13a_spectrum": lm_spectrum(spectrum_cli, spectra, kernels, PYTHIA_SPECTRUM_ARGV,
                                       "13a Pythia-1.4B spectrum")}
    print(json.dumps({"13a_pythia_spectrum": out["13a_spectrum"]}))
    out["13b_lanczos_sgd"], out["17c_reference"] = pythia_lanczos_sgd(train_cli, kernels,
                                                                      spectral)
    print(json.dumps({"13b_pythia_lanczos_sgd": out["13b_lanczos_sgd"]}))
    print(json.dumps({"13b_step0_for_17c": {k: v for k, v in out["17c_reference"].items()
                                            if k != "input_ids"}}))
    return out


def llama_134m(spectrum_cli, train_cli, spectra, kernels, spectral) -> dict:
    """13c: LLaMA-134m at full width: the llama134m_r3 spectrum, its f32 HVP
    against a float64 central difference, 4 LanczosSGD steps."""
    out = {"spectrum": lm_spectrum(spectrum_cli, spectra, kernels, LLAMA_SPECTRUM_ARGV,
                                   "13c LLaMA-134m spectrum")}
    torch.cuda.empty_cache()
    fd, _ = hvp_against_central_difference(spectrum_cli, LLAMA_SPECTRUM_ARGV)
    out["hvp_vs_central_difference"] = fd
    check_gates("13c LLaMA-134m HVP against the float64 central difference", {
        "f32 HVP within the limit": fd["rel_l2_hvp_vs_fd"] <= HVP_FD_LIMIT,
        "reference's truncation within the limit": fd["rel_l2_fd2_vs_fd4"] <= HVP_FD_LIMIT,
    })
    train = lm_lanczos_sgd(train_cli, kernels, spectral, LLAMA_TRAIN_ARGV,
                           "13c LLaMA-134m LanczosSGD", replay=False)
    check_gates("13c LLaMA-134m LanczosSGD", {
        "every adjust at (10, 134,105,856) bf16": all(
            sh == (10, LLAMA_P) and dt == "torch.bfloat16" for _, sh, dt in train["adjust_shapes"]),
    })
    out["lanczos_sgd"] = train
    print(json.dumps({"13c_llama_134m": out}))
    return out


def tiny_families_card_vs_cpu(spectrum_cli, train_cli, kernels) -> dict:
    """13e: the tiny configs through both CLIs, card against CPU: Ritz
    extremes within 1e-3, the trainer's first loss within 1e-5 and its Ritz
    values within 1e-3; a top-k run warns; LanczosSGD over llama-tiny's
    LoRA adapters launches the rank-k pair on the adapters' P."""
    from hessian_llm_vision_tpu_torch.models.moe import TopKCurvatureWarning

    out, warned = {}, {}
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        for name, model in TINY_FAMILIES.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                card, cpu = (spectrum_cli.main(model + TINY_FAMILY_SPECTRUM + extra)[0]
                             for extra in ([], ["--cpu"]))
                recs = ([], [])
                for r, extra in zip(recs, ([], ["--cpu"])):
                    train_cli.main(model + TINY_FAMILY_TRAIN + extra,
                                   on_step=lambda s, rec, r=r: r.append(rec))
            warned[name] = sum(issubclass(w.category, TopKCurvatureWarning) for w in caught)
            out[name] = {"spectrum_extremes_rel": extremes_rel(card.eigvals, cpu.eigvals),
                         "train_step0_loss_rel": _rel(recs[0][0]["loss"], recs[1][0]["loss"]),
                         "train_ritz_rel": max(_rel(a[k], b[k]) for a, b in zip(*recs)
                                               for k in ("eig_max", "eig_min")),
                         "topk_warnings": warned[name]}
    out["lora_llama_tiny"] = lora_lanczos_sgd_card_vs_cpu(train_cli, kernels)
    print(json.dumps({"13e_tiny_card_vs_cpu": out}))
    lora = out["lora_llama_tiny"]
    check_gates("13e tiny families, card against CPU", {
        **{f"{n} spectrum extremes": r["spectrum_extremes_rel"] <= TINY_TRAIN_RITZ_RTOL
           for n, r in out.items() if n in TINY_FAMILIES},
        **{f"{n} first loss": r["train_step0_loss_rel"] <= TINY_TRAIN_LOSS_RTOL
           for n, r in out.items() if n in TINY_FAMILIES},
        **{f"{n} trainer Ritz values": r["train_ritz_rel"] <= TINY_TRAIN_RITZ_RTOL
           for n, r in out.items() if n in TINY_FAMILIES},
        "the top-k runs warn, the others not": all(
            (warned[n] > 0) == ("--moe_top_k" in m) for n, m in TINY_FAMILIES.items()),
        "LoRA losses": lora["loss_rel"] <= TINY_TRAIN_LOSS_RTOL,
        "LoRA Ritz values": lora["ritz_rel"] <= TINY_TRAIN_RITZ_RTOL,
        "LoRA: each kernel once per step": all(
            c == {k: 1 for k in TPU_KERNELS} for c in lora["launches_per_step"]),
    })
    return out


def lora_lanczos_sgd_card_vs_cpu(train_cli, kernels) -> dict:
    """HostLanczosSGDTrainer over rank-4 LoRA adapters of llama-tiny (drawn
    on the CPU, the same on both devices), 2 steps on the card and the CPU."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.models import lora
    from hessian_llm_vision_tpu_torch.optim import LanczosSGDConfig
    from hessian_llm_vision_tpu_torch.optim.lanczos_sgd_host import HostLanczosSGDTrainer

    args = train_cli.build_parser().parse_args(TINY_FAMILIES["llama_tiny"] + TINY_FAMILY_TRAIN)
    cfg = LanczosSGDConfig(k=LORA_K, delta=10.0, lr=0.01, momentum=0.9, refresh_every=2)
    adapters = lora.lora_init(build_workload(args, torch.device("cpu")).params, LORA_RANK,
                              torch.Generator().manual_seed(0))
    runs = []
    for dev in (CARD, torch.device("cpu")):
        wl = build_workload(args, dev)
        ad = {n: a.to(dev, copy=True) for n, a in adapters.items()}  # the trainer updates in place
        trainer = HostLanczosSGDTrainer(lora.lora_loss_fn(wl.loss_fn, wl.params), ad, cfg,
                                        batch_size=wl.batch_size)
        state = trainer.init(ad)
        steps, launches = [], []
        for i in range(2):
            kernels.reset_launch_counts()
            state, m = trainer.step(state, wl.batches[i % len(wl.batches)])
            launches.append(dict(kernels.LAUNCHES))
            steps.append({k: float(v) for k, v in m.items()})
        runs.append({"steps": steps, "launches": launches,
                     "basis_shape": list(state.basis.shape)})
    card, cpu = runs
    return {"P": sum(a.numel() for a in adapters.values()), "basis_shape": card["basis_shape"],
            "steps": card["steps"], "launches_per_step": card["launches"],
            "loss_rel": max(_rel(a["loss"], b["loss"]) for a, b in zip(card["steps"], cpu["steps"])),
            "ritz_rel": max(_rel(a[k], b[k]) for a, b in zip(card["steps"], cpu["steps"])
                            for k in ("eig_max", "eig_min"))}


def lm_families(spectrum_cli, train_cli, spectra, kernels, spectral) -> dict:
    """Phase 13: 13a-13e, each timed."""
    out = {}
    for key, run in (
        ("13ab", lambda: pythia_1p4b(spectrum_cli, train_cli, spectra, kernels, spectral)),
        ("13c", lambda: llama_134m(spectrum_cli, train_cli, spectra, kernels, spectral)),
        ("13d", lambda: lm_spectrum(spectrum_cli, spectra, kernels, MOE_SPECTRUM_ARGV,
                                    "13d gpt2-moe spectrum")),
        ("13e", lambda: tiny_families_card_vs_cpu(spectrum_cli, train_cli, kernels)),
    ):
        t0 = time.perf_counter()
        out[key] = run()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase {key} took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def lm_families_summary(fam: dict) -> dict:
    a, b = fam["13ab"]["13a_spectrum"], fam["13ab"]["13b_lanczos_sgd"]
    c, d = fam["13c"], fam["13d"]
    keys = ("lambda_max", "lambda_min", "trace_estimate", "gamma_sum", "iter_s", "init_s",
            "max_memory_allocated_bytes")
    return {
        "13a_pythia_1p4b_spectrum": {k: a[k] for k in keys},
        "13b_pythia_1p4b_lanczos_sgd": {k: b[k] for k in (
            "max_length", "oom_at", "init_s", "refresh_step_s", "frozen_step_s", "frozen_step",
            "max_memory_allocated_bytes", "launches_per_step")}
        | {"losses": [r["loss"] for r in b["steps"]]},
        "13c_llama_134m": {"spectrum": {k: c["spectrum"][k] for k in keys},
                           "rel_l2_hvp_vs_fd": c["hvp_vs_central_difference"]["rel_l2_hvp_vs_fd"],
                           "rel_l2_tf32_hvp_vs_fd":
                               c["hvp_vs_central_difference"]["rel_l2_tf32_hvp_vs_fd"],
                           "lanczos_sgd_step_s": [r["seconds"] for r in c["lanczos_sgd"]["steps"]]},
        "13d_gpt2_moe_spectrum": {k: d[k] for k in keys},
        "13e_tiny": fam["13e"],
    }


@contextlib.contextmanager
def vision_data(mnist_dir: str, cifar_dir: str):
    """``HLV_MNIST_DIR`` and ``HLV_CIFAR_DIR`` set inside the block, restored
    after (the loaders read them at call time)."""
    keys = ("HLV_MNIST_DIR", "HLV_CIFAR_DIR")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(zip(keys, (mnist_dir, cifar_dir)))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def write_mnist_test_idx(directory: str, n: int, seed: int = 0) -> None:
    """MNIST's t10k idx pair (n random 28x28 uint8 digits, labels 0-9) from
    seeded numpy, in the format ``data.vision._read_idx`` reads."""
    import struct

    rng = np.random.RandomState(seed)
    arrays = {"t10k-images-idx3-ubyte": rng.randint(0, 256, (n, 28, 28)).astype(np.uint8),
              "t10k-labels-idx1-ubyte": rng.randint(0, 10, n).astype(np.uint8)}
    for stem, a in arrays.items():
        with open(os.path.join(directory, stem), "wb") as f:
            f.write(struct.pack(">I", 0x0800 | a.ndim) + struct.pack(f">{a.ndim}I", *a.shape))
            f.write(a.tobytes())


def vision_hvp_vs_central_difference(spectrum_cli, argv, gated: bool) -> dict:
    """14c: on one batch, the f32 HVP and the bf16 ("default") and TF32
    ones, on the CLI's first probe, against a float64 HVP (the model on
    float64 params) and a float64 central difference of gradients on the
    card.  ``gated``: the float64 HVP within HVP_FD_LIMIT of the difference,
    the f32 HVP within VISION_F32_LIMIT of the float64 HVP (at init on
    random images both models' f32 HVPs are ill-conditioned: this phase
    reads VGG-16's 2.6e-3 and ResNet-50's 9.4e-4), and the bf16 and TF32
    HVPs (convolutions and dense products alike) beyond both limits.
    Otherwise (BN train mode) the difference is read; every mode gates the
    f32 HVP nearer the float64 one than the bf16 and TF32 HVPs."""
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.operators import DatasetHessianOperator
    from hessian_llm_vision_tpu_torch.krylov.lanczos import start_vector

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    args = spectrum_cli.build_parser().parse_args(argv)
    wl = build_workload(args, CARD)
    dim = sum(p.numel() for p in wl.params.values())
    v0 = torch.randn(dim, generator=torch.Generator().manual_seed(args.vector_seed)).to(CARD)
    q1 = start_vector(v0, None, dim)
    hv = {name: DatasetHessianOperator(wl.loss_fn, wl.params, wl.batches, normalization="mean",
                                       precision=prec).matvec(q1)
          for name, prec in (("f32", "high"), ("bf16", "default"), ("tf32", "TF32_TF32_F32"))}
    hv["f64"] = DatasetHessianOperator(wl.loss_fn, {n: t.double() for n, t in wl.params.items()},
                                       wl.batches, normalization="mean",
                                       precision=None).matvec(q1.double())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref, ref2 = central_difference_hvp(wl.loss_fn, wl.params, wl.batches, q1, VISION_FD_EPS)
    torch.cuda.synchronize()
    res = {"eps": VISION_FD_EPS, "P": dim, "hv_norm": float(torch.linalg.vector_norm(ref)),
           **{f"rel_l2_{n}_hvp_vs_fd": rel_l2(h, ref) for n, h in hv.items()},
           **{f"rel_l2_{n}_hvp_vs_f64_hvp": rel_l2(hv[n], hv["f64"]) for n in ("f32", "bf16",
                                                                               "tf32")},
           "rel_l2_fd2_vs_fd4": rel_l2(ref2, ref), "build_and_hvps_s": t1 - t0,
           "fd_s": time.perf_counter() - t1}
    del wl, hv, ref, ref2
    f32 = res["rel_l2_f32_hvp_vs_f64_hvp"]
    gates = {"f32 HVP nearer the float64 HVP than the bf16 and TF32 ones":
             f32 < min(res["rel_l2_bf16_hvp_vs_f64_hvp"], res["rel_l2_tf32_hvp_vs_f64_hvp"])}
    if gated:
        gates.update({
            "f64 HVP within the limit of the difference":
                res["rel_l2_f64_hvp_vs_fd"] <= HVP_FD_LIMIT,
            "reference's truncation within the limit": res["rel_l2_fd2_vs_fd4"] <= HVP_FD_LIMIT,
            "bf16 HVP misses the limit": res["rel_l2_bf16_hvp_vs_fd"] > HVP_FD_LIMIT,
            "TF32 HVP misses the limit": res["rel_l2_tf32_hvp_vs_fd"] > HVP_FD_LIMIT,
            f"f32 HVP within {VISION_F32_LIMIT} of the float64 HVP": f32 <= VISION_F32_LIMIT,
            **{f"{n} HVP beyond {VISION_F32_LIMIT} of the float64 HVP":
               res[f"rel_l2_{n}_hvp_vs_f64_hvp"] > VISION_F32_LIMIT for n in ("bf16", "tf32")},
        })
    mode = " (BN train mode)" if "--bn_train_mode" in argv else ""
    check_gates(f"14c {argv[1]}{mode} HVP against float64", gates)
    return res


def vision_lanczos_sgd(train_cli, kernels, spectral, argv, what: str, p: int) -> dict:
    """14d: 13b's LanczosSGD checks on a vision model: each kernel once a
    step, every adjust at (10, p) bf16, the frozen step against the plain
    versions; the update resolved in f32 (its rounding <= 1e-3 of it), so
    that the replay can see the kernels' part."""
    res = lm_lanczos_sgd(train_cli, kernels, spectral, argv, what, replay=True)
    check_gates(what, {
        f"every adjust at (10, {p}) bf16": all(
            sh == (10, p) and dt == "torch.bfloat16" for _, sh, dt in res["adjust_shapes"]),
        "update resolved (f32 rounding of p - lr buf <= 1e-3 of it)":
            res["frozen_step"]["update_floor"] <= TERM_FLOOR_MAX})
    return res


def vision_card_vs_cpu(spectrum_cli, train_cli, kernels, mnist_dir: str) -> dict:
    """14e: the small configs through both CLIs, card against CPU: the
    spectrum's Ritz extremes within 1e-3, every training loss within 1e-5
    and the trainer's Ritz values (3 Lanczos steps, unconverged) within
    1e-3; the card runs' launches."""
    out = {}
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        for name, (model, spec_nb, train_nb, steps) in VISION_TINY.items():
            base = model + ["--out", os.path.join(mnist_dir, "runs")]
            card, cpu = (spectrum_cli.main(model + spec_nb + VISION_TINY_SPECTRUM + extra)[0]
                         for extra in ([], ["--cpu"]))
            recs, launches = ([], []), {}
            for r, extra in zip(recs, ([], ["--cpu"])):
                kernels.reset_launch_counts()
                train_cli.main(base + train_nb + VISION_TINY_TRAIN + ["--max_steps", str(steps)]
                               + extra, on_step=lambda s, rec, r=r: r.append(rec))
                if not extra:
                    torch.cuda.synchronize()
                    launches = dict(kernels.LAUNCHES)
            out[name] = {"spectrum_extremes_rel": extremes_rel(card.eigvals, cpu.eigvals),
                         "steps": len(recs[0]), "cpu_steps": len(recs[1]),
                         "loss_rel": max(_rel(a["loss"], b["loss"]) for a, b in zip(*recs)),
                         "ritz_rel": max(_rel(a[k], b[k]) for a, b in zip(*recs)
                                         for k in ("eig_max", "eig_min")),
                         "launches": launches}
    print(json.dumps({"14e_vision_card_vs_cpu": out}))
    check_gates("14e vision configs, card against CPU", {
        **{f"{n}: {VISION_TINY[n][3]} steps on each device":
           r["steps"] == r["cpu_steps"] == VISION_TINY[n][3] for n, r in out.items()},
        **{f"{n} spectrum extremes": r["spectrum_extremes_rel"] <= TINY_TRAIN_RITZ_RTOL
           for n, r in out.items()},
        **{f"{n} losses": r["loss_rel"] <= TINY_TRAIN_LOSS_RTOL for n, r in out.items()},
        **{f"{n} trainer's Ritz values": r["ritz_rel"] <= TINY_TRAIN_RITZ_RTOL
           for n, r in out.items()},
    })
    return out


def vision(spectrum_cli, train_cli, spectra, kernels, spectral) -> dict:
    """Phase 14: 14a-14e, each timed, with both data directories pointed at
    empty temporary directories (14e's SimpleNet at its idx files)."""
    out = {}
    with tempfile.TemporaryDirectory() as empty, tempfile.TemporaryDirectory() as mnist:
        write_mnist_test_idx(mnist, MNIST_N)
        with vision_data(empty, empty):
            steps = (
                ("14a", lambda: lm_spectrum(spectrum_cli, spectra, kernels, VGG_SPECTRUM_ARGV,
                                            "14a VGG-16 spectrum", RANDOM_IMAGES)),
                ("14b", lambda: {mode: lm_spectrum(
                    spectrum_cli, spectra, kernels, RESNET_SPECTRUM_ARGV + extra,
                    f"14b ResNet-50 spectrum, BN {mode} mode", RANDOM_IMAGES)
                    for mode, extra in (("eval", []), ("train", ["--bn_train_mode"]))}),
                ("14c", lambda: {name: vision_hvp_vs_central_difference(
                    spectrum_cli, argv + VISION_FD_BASE, gated)
                    for name, argv, gated in (
                        ("vgg16", ["--model", "vgg16"], True),
                        ("resnet50_eval", ["--model", "resnet50"], True),
                        ("resnet50_train", ["--model", "resnet50", "--bn_train_mode"], False))}),
                ("14d", lambda: {
                    "vgg16": vision_lanczos_sgd(train_cli, kernels, spectral, VGG_TRAIN_ARGV,
                                                "14d VGG-16 LanczosSGD", VGG16_P),
                    "resnet50": vision_lanczos_sgd(train_cli, kernels, spectral,
                                                   RESNET_TRAIN_ARGV, "14d ResNet-50 LanczosSGD",
                                                   RESNET50_P)}),
            )
            for key, run in steps:
                t0 = time.perf_counter()
                out[key] = run()
                gc.collect()
                torch.cuda.empty_cache()
                print(json.dumps({f"{key}_vision": out[key]}))
                print(f"phase {key} took {time.perf_counter() - t0:.1f} s", flush=True)
            b = out["14b"]
            check_gates("14b ResNet-50 BN modes", {
                "lambda_max differs between the modes":
                    b["eval"]["lambda_max"] != b["train"]["lambda_max"]})
        t0 = time.perf_counter()
        with vision_data(mnist, empty):
            out["14e"] = vision_card_vs_cpu(spectrum_cli, train_cli, kernels, mnist)
        print(f"phase 14e took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def vision_summary(vis: dict) -> dict:
    keys = ("lambda_max", "lambda_min", "trace_estimate", "gamma_sum", "iter_s",
            "max_memory_allocated_bytes")
    return {
        "14a_vgg16_spectrum": {k: vis["14a"][k] for k in keys},
        **{f"14b_resnet50_spectrum_{m}": {k: r[k] for k in keys} for m, r in vis["14b"].items()},
        **{f"14c_{n}": {k: v for k, v in r.items() if k.startswith("rel_l2")}
           for n, r in vis["14c"].items()},
        **{f"14d_{n}_lanczos_sgd": {k: r[k] for k in (
            "refresh_step_s", "frozen_step_s", "frozen_step", "max_memory_allocated_bytes",
            "launches_per_step")} | {"losses": [s["loss"] for s in r["steps"]]}
           for n, r in vis["14d"].items()},
        "14e_tiny": vis["14e"],
    }


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_forget(forget, kernels, argv, device, snapshot_steps=()) -> dict:
    """forget.run(argv) with its records: the Result, its npz read back,
    its stdout lines, its seconds, and from its ``on_step`` events the
    rank-k launches of each step (and of the basis) by phase, the params
    after the first step of each phase, the first projected step's raw
    gradient (flat), and task A's params after each of ``snapshot_steps``
    (on the CPU)."""
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    rec = {"launches": {"task_a": [], "basis": [], "baseline": [], "projected": []},
           "p_first": {}, "task_a_at": {}}

    def on_step(phase, p_in, g, p_out):
        rec["launches"][phase].append(dict(kernels.LAUNCHES))
        kernels.reset_launch_counts()
        rec["p_first"].setdefault(phase, p_out)
        if phase == "projected" and "g_first" not in rec:
            rec["g_first"] = Flattener(g).flatten(g)
        if phase == "task_a" and len(rec["launches"]["task_a"]) in snapshot_steps:
            rec["task_a_at"][len(rec["launches"]["task_a"])] = {n: t.cpu()
                                                                  for n, t in p_out.items()}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "curves.npz")
        tee = _Tee(sys.stdout)
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(tee):
            t0 = time.perf_counter()
            rec["result"] = forget.run(argv + ["--out_curves", path], on_step=on_step)
            _sync(device)
            rec["seconds"] = time.perf_counter() - t0
        with np.load(path) as z:
            rec["npz"] = {k: z[k] for k in z.files}
    rec["lines"] = "".join(tee.parts).splitlines()
    return rec


def _flat(params: dict) -> torch.Tensor:
    """The params flat in name order (the Flattener's), float64."""
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    return Flattener(params).flatten(params).double()


def drift_leak(V: torch.Tensor, phase) -> float:
    """``||V Δθ|| / ||Δθ||`` of a phase's whole parameter change, float64
    and the plain product."""
    V64, drift = V.double(), _flat(phase.params_out) - _flat(phase.params_in)
    return float(torch.linalg.vector_norm(V64 @ drift) / torch.linalg.vector_norm(drift))


def forget_gates(what: str, rec: dict) -> dict:
    """The checks every forget run passes: the npz's six keys, ab_overlap
    in [0, 1], the projected phase's parameter change orthogonal to the
    basis (``FORGET_DRIFT_LIMIT``, float64, plain product), and on the
    card no rank-k launch in task A or the baseline and one of each kernel
    per projected step."""
    res_ = rec["result"]
    phases = dict(zip(("task_a", "baseline", "projected"),
                      (res_.task_a, res_.baseline, res_.projected)))
    L = rec["launches"]
    res = {
        "seconds": rec["seconds"], "basis_s": res_.basis.seconds,
        "phase_s": {n: ph.seconds for n, ph in phases.items()},
        "steps": {n: len(L[n]) for n in phases},
        "ms_per_step": {n: 1e3 * phases[n].seconds / max(len(L[n]), 1)
                        for n in ("baseline", "projected")},
        "acc_a0": res_.acc_a0, "ab_overlap": res_.ab_overlap,
        "final_acc_a": [c[-1] for c in res_.curves],
        "acc_b": [res_.acc_b_base, res_.acc_b_proj],
        "drift_leak": drift_leak(res_.basis.vectors, res_.projected),
        "finite_params": all(bool(torch.isfinite(t).all()) for ph in phases.values()
                             for t in ph.params_out.values()),
        "launches": {n: _summed(L[n]) for n in phases},
        "basis_launches": _summed(L["basis"]),
    }
    print(json.dumps({"forget_gates": {"what": what, **res}}))
    gates = {
        "the npz's six keys": sorted(rec["npz"]) == sorted(
            ["baseline_drop", "method_results", "acc_a0", "acc_b_base", "acc_b_proj",
             "ab_overlap"]),
        "ab_overlap in [0, 1]": 0.0 <= res["ab_overlap"] <= 1.0,
        "curves in the npz": (np.array_equal(rec["npz"]["baseline_drop"], res_.curves[0])
                              and np.array_equal(rec["npz"]["method_results"], res_.curves[1])),
        "finite params after every phase": res["finite_params"],
        f"projected drift within {FORGET_DRIFT_LIMIT} of orthogonal to the basis":
            res["drift_leak"] <= FORGET_DRIFT_LIMIT,
        "finite accuracies": all(math.isfinite(a) for c in res_.curves for a in c),
        "one basis event": len(L["basis"]) == 1,
    }
    if res_.basis.vectors.is_cuda:
        gates.update({
            "no rank-k launch in task A or the baseline": all(
                c == dict.fromkeys(TPU_KERNELS, 0) for n in ("task_a", "baseline")
                for c in L[n]),
            "each kernel once per projected step": all(
                c == dict.fromkeys(TPU_KERNELS, 1) for c in L["projected"]),
        })
    check_gates(what, gates)
    return res


def forget_spiral_card_vs_cpu(forget, kernels) -> dict:
    """15a: the forget CLI at its defaults on the spiral, on the card and
    on the CPU, each from the same seeded draws; both pass
    :func:`forget_gates`.  Task A's params card against CPU after each of
    FORGET_TASK_A_STEPS Adam steps, gated within FORGET_TASK_A_RTOL after
    the first of them (the two devices' rounding grows through the phase,
    read at the others).  From the card's task-A params on the CPU
    (:func:`forget.task_a_basis`, :func:`forget.task_b_phases`): acc_a0
    equal, the CPU's basis's Ritz values within FORGET_RITZ_RTOL of the
    card's over max |lambda|, and the two task-B phases on the card's basis
    with each curve within FORGET_CURVE_ATOL of the card's at every step;
    read: the same phases on the CPU's own basis, and the two devices'
    whole runs apart."""
    from hessian_llm_vision_tpu_torch.krylov import subspace_overlap

    card = run_forget(forget, kernels, FORGET_SPIRAL_ARGV, CARD, FORGET_TASK_A_STEPS)
    cpu = run_forget(forget, kernels, FORGET_SPIRAL_ARGV + ["--cpu"], torch.device("cpu"),
                     FORGET_TASK_A_STEPS)
    rc, rp = card["result"], cpu["result"]
    exp = rp.experiment
    params_a = {n: t.cpu() for n, t in rc.task_a.params_out.items()}
    basis = forget.task_a_basis(exp, params_a)
    V_card = rc.basis.vectors.cpu()
    on_card = forget.task_b_phases(exp, params_a, V_card)
    on_own = forget.task_b_phases(exp, params_a, basis.vectors)
    ev_card, ev_cpu = (np.asarray(e, np.float64) for e in (rc.basis.eigvals, basis.eigvals))

    def apart(a, b):
        return float(np.abs(np.subtract(a, b)).max())

    res = {"card": forget_gates("15a forget on the spiral, card", card),
           "cpu": forget_gates("15a forget on the spiral, CPU", cpu),
           "task_a_rel": {s: rel_l2(_flat(card["task_a_at"][s]), _flat(cpu["task_a_at"][s]))
                          for s in FORGET_TASK_A_STEPS},
           "eigvals": ev_card.tolist(),
           "ritz_rel": float(np.abs(ev_card - ev_cpu).max() / np.abs(ev_cpu).max()),
           "acc_a0_cpu": exp.acc_fn(params_a, exp.eval_a["image"], exp.eval_a["label"]),
           "basis_overlap": subspace_overlap(V_card, basis.vectors),
           "params_rel": {n: rel_l2(_flat(ph.params_out).cpu(), _flat(mine.params_out))
                          for n, ph, mine in (("baseline", rc.baseline, on_card[0]),
                                              ("projected", rc.projected, on_card[1]))},
           "curve_max_abs_diff": [apart(a, b.curve) for a, b in zip(rc.curves, on_card)],
           "own_basis_curve_max_abs_diff": apart(rc.curves[1], on_own[1].curve),
           "own_runs": {"ritz_rel": float(np.abs(ev_card - rp.basis.eigvals).max()
                                          / np.abs(ev_card).max()),
                        "curve_max_abs_diff": [apart(a, b) for a, b in zip(rc.curves,
                                                                           rp.curves)]}}
    first = FORGET_TASK_A_STEPS[0]
    print(json.dumps({"15a_forget_spiral": res}))
    check_gates("15a forget on the spiral, card against CPU", {
        f"task A after {first} steps within {FORGET_TASK_A_RTOL}":
            res["task_a_rel"][first] <= FORGET_TASK_A_RTOL,
        "acc_a0 equal": res["acc_a0_cpu"] == rc.acc_a0,
        f"Ritz values within {FORGET_RITZ_RTOL}": res["ritz_rel"] <= FORGET_RITZ_RTOL,
        "curves as long": [len(c) for c in rc.curves] == [len(p.curve) for p in on_card],
        f"curves within {FORGET_CURVE_ATOL:.4f}": max(res["curve_max_abs_diff"])
        <= FORGET_CURVE_ATOL + 1e-9,
    })
    return res


def write_cifar_batches(directory: str, n_per_batch: int, seed: int = 0) -> None:
    """CIFAR-10's python pickles (five train batches and a test batch of
    random uint8 images, labels 0-9) from seeded numpy, in the format
    ``data.vision.load_cifar10`` reads."""
    import pickle

    base = os.path.join(directory, "cifar-10-batches-py")
    os.makedirs(base)
    rng = np.random.RandomState(seed)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.randint(0, 256, (n_per_batch, 3072)).astype(np.uint8),
                 b"labels": rng.randint(0, 10, n_per_batch).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(batch, f)


def forget_vgg16(forget, kernels, spectral) -> dict:
    """15b: the forget CLI on VGG-16 at full convolutional width (the
    written CIFAR files): :func:`forget_gates`; the thick-restart basis
    converged, each pair's residual from a fresh f32 HVP outside the CLI
    within TR_RESIDUAL_LIMIT of max |lambda|, the rows within
    TR_ORTHO_LIMIT of orthonormal; the first projected step's projection
    (the kernels' on the step's raw gradient) against the plain version and
    its update against a replay; P = FORGET_P (phase 3 holds and times the
    pair at this shape)."""
    from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    deterministic, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
    try:
        rec = run_forget(forget, kernels, FORGET_VGG_ARGV, CARD)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    peak = torch.cuda.max_memory_allocated()
    res = forget_gates("15b forget on VGG-16", rec)
    r = rec["result"]
    exp, tres, V = r.experiment, r.basis.result, r.basis.vectors
    t0 = time.perf_counter()
    params_a = r.task_a.params_out
    op = HessianOperator(exp.loss_fn, params_a, exp.batch_a, precision="high")
    scale = float(np.abs(tres.eigvals).max())
    resid = [float(torch.linalg.vector_norm(op.matvec(u) - float(lam) * u)) / scale
             for u, lam in zip(V, tres.eigvals)]
    V64 = V.double()
    ortho = float((V64 @ V64.T - torch.eye(len(V), dtype=torch.float64, device=CARD)).abs().max())
    del V64
    # the first projected step: the kernels' projection of its raw gradient
    # against the plain version, and the update against the momentum step
    # from zero (buf = g', update = -lr buf) replayed in f32 from the plain
    # projection and from the kernels' own (the trainer's arithmetic, bit
    # for bit)
    lr = exp.args.lr
    g = rec["g_first"]
    out, plain = spectral.project_out(g, V), spectral.project_out_reference(g, V)
    kernels.reset_launch_counts()
    p0, p1 = _flat(params_a).float(), _flat(rec["p_first"]["projected"]).float()
    replay = (p0 + out * (-lr)) - p0
    replay_plain = (p0 + plain * (-lr)) - p0
    res.update({
        "P": Flattener(params_a).size, "eigvals": tres.eigvals.tolist(),
        "residual_estimates": tres.residuals.tolist(), "restarts": tres.restarts,
        "matvecs": tres.matvecs, "converged": tres.converged,
        "independent_residual_over_max_lambda": resid, "max_abs_VVt_minus_I": ortho,
        "projection_rel": rel_l2(out, plain), "replay_rel": rel_l2(p1 - p0, replay),
        "replay_from_plain_rel": rel_l2(p1 - p0, replay_plain),
        "update_floor": rel_l2(replay_plain, plain * (-lr)),
        "max_memory_allocated_bytes": peak, "residual_check_s": time.perf_counter() - t0,
        "lines": [line for line in rec["lines"] if line.startswith("task")],
    })
    del op, g, out, plain, p0, p1, replay, replay_plain
    print(json.dumps({"15b_forget_vgg16": res}))
    check_gates("15b forget on VGG-16", {
        f"P = {FORGET_P}": res["P"] == FORGET_P,
        "lr the CLI's default": lr == forget.build_parser().get_default("lr"),
        "basis converged": tres.converged and any("CONVERGED" in line for line in res["lines"]),
        "independent residuals within the limit": max(resid) <= TR_RESIDUAL_LIMIT,
        "rows orthonormal": ortho <= TR_ORTHO_LIMIT,
        "thick restart's CGS2 on the kernel pair": all(
            res["basis_launches"][n] > 0 for n in TPU_KERNELS),
        "first projection = the plain version's": res["projection_rel"] <= FORGET_REPLAY_RTOL,
        "update resolved (f32 rounding of p + u <= 1e-3 of it)":
            res["update_floor"] <= TERM_FLOOR_MAX,
        "first projected update = its replay from the plain projection":
            res["replay_from_plain_rel"] <= FORGET_REPLAY_RTOL,
        "first projected update = its f32 replay": res["replay_rel"] <= FORGET_REPLAY_RTOL,
    })
    return res


def forget_simplenet(forget, kernels) -> dict:
    """15c: the forget CLI on SimpleNet over the written MNIST idx files,
    task B permuted and then noisy, on the card: :func:`forget_gates`."""
    out = {}
    for task_b in ("permuted", "noisy"):
        rec = run_forget(forget, kernels, FORGET_MNIST_ARGV + ["--task_b", task_b], CARD)
        out[task_b] = forget_gates(f"15c forget on SimpleNet, task B {task_b}", rec)
        out[task_b]["held_out"] = any("held-out eval" in line for line in rec["lines"])
    print(json.dumps({"15c_forget_simplenet": out}))
    check_gates("15c forget on SimpleNet", {
        "task A evaluated on its held-out split": all(r["held_out"] for r in out.values())})
    return out


def evaluate_cli(evaluate, kernels) -> dict:
    """15d: the evaluate CLI on GPT-2 124M (the mean loss near ln 50257 at
    init, the pickle read back) and on VGG-16 over the written CIFAR files
    (its per-batch losses equal to a recount by a plain forward and
    cross-entropy on the workload ``cli.workloads.build_workload`` builds
    from the same flags, and, as the JAX CLI, no accuracy line: the vision
    workloads have no ``apply_fn``); no rank-k launch.  The accuracy of that
    forward is read."""
    import pickle

    from torch.func import functional_call

    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload

    res = {}
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "losses.pkl")
        t0 = time.perf_counter()
        losses = evaluate.main(EVAL_GPT2_ARGV + ["--out_losses", path])
        res["gpt2_s"] = time.perf_counter() - t0
        with open(path, "rb") as f:
            back = pickle.load(f)
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        vgg_losses = evaluate.main(EVAL_VGG_ARGV)
    res["vgg16_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    lines = "".join(tee.parts).splitlines()
    wl = build_workload(evaluate.build_parser().parse_args(EVAL_VGG_ARGV), CARD)
    recount, right, n = [], 0, 0
    with torch.no_grad():
        for b in wl.batches:
            logits = functional_call(wl.model, wl.params, (b["image"],))
            recount.append(float(torch.nn.functional.cross_entropy(logits, b["label"])))
            right += int((logits.argmax(-1) == b["label"]).sum())
            n += len(b["label"])
    res.update({"gpt2_losses": losses.tolist(), "gpt2_mean_loss": float(losses.mean()),
                "vgg16_losses": vgg_losses.tolist(), "vgg16_losses_recount": recount,
                "vgg16_accuracy_recount": right / n, "vgg16_images": n,
                "vgg16_lines": lines, "launches": launches})
    del wl
    print(json.dumps({"15d_evaluate": res}))
    check_gates("15d evaluate", {
        "4 finite GPT-2 losses": len(losses) == 4 and bool(np.isfinite(losses).all()),
        f"mean loss within {EVAL_LOSS_ATOL} of ln 50257":
            abs(res["gpt2_mean_loss"] - math.log(50257)) <= EVAL_LOSS_ATOL,
        "pickle read back": list(back) == ["per_batch_losses"]
        and np.array_equal(back["per_batch_losses"], losses),
        "VGG-16 losses = the recount": len(recount) == len(vgg_losses) and bool(
            np.allclose(vgg_losses, recount, rtol=EVAL_RECOUNT_RTOL, atol=0)),
        "VGG-16 printed mean = the recount's":
            reported(lines, r"batches: mean ([\d.]+)")[0] == f"{np.mean(recount):.4f}",
        "no accuracy line, as the JAX CLI": not any(line.startswith("accuracy") for line in lines),
        "no rank-k launch": all(c == 0 for c in launches.values()),
    })
    return res


def sweep_and_hpo(sweep, hpo, train_cli, kernels, tmp: str) -> dict:
    """15e: cli.sweep over two learning rates and cli.hpo's two TPE trials,
    each point fused LanczosSGD on the spiral through cli.train.main: every
    point's loss finite and both rank-k kernels launched in every point
    (the CLIs' catch-all scores a failed point inf)."""
    calls, train = [], train_cli.main

    def counted(argv, on_step=None):
        kernels.reset_launch_counts()
        loss = train(argv, on_step=on_step)
        calls.append({"loss": loss, "launches": dict(kernels.LAUNCHES)})
        return loss

    runs = os.path.join(tmp, "runs")
    train_cli.main = counted
    try:
        t0 = time.perf_counter()
        results = sweep.main(SWEEP_GRID + ["--out_json", os.path.join(tmp, "sweep.json"), "--",
                                           "--optimiser", "lanczos", "--out", runs]
                             + SPIRAL_LANCZOS)
        sweep_s, n_sweep = time.perf_counter() - t0, len(calls)
        t0 = time.perf_counter()
        best = hpo.main(["--trials", str(HPO_TRIALS), "--out_json",
                         os.path.join(tmp, "best.json"), "--", "--out", runs] + SPIRAL_LANCZOS)
        hpo_s = time.perf_counter() - t0
    finally:
        train_cli.main = train
    res = {"sweep": results, "hpo_backend": best["backend"],
           "hpo_trials": best["trials"], "per_point": calls, "sweep_s": sweep_s,
           "hpo_s": hpo_s}
    print(json.dumps({"15e_sweep_hpo": res}))
    losses = [r["final_loss"] for r in results] + [t["loss"] for t in best["trials"]]
    check_gates("15e sweep and hpo", {
        "every point ran": n_sweep == 2 and len(calls) == 2 + HPO_TRIALS,
        "every loss finite": all(math.isfinite(x) for x in losses),
        "hpo took the TPE sampler": best["backend"] == "tpe",
        "both kernels launched in every point": all(
            c["launches"][n] > 0 for c in calls for n in TPU_KERNELS),
    })
    return res


def dispatch_cli(dispatch) -> dict:
    """15f: ``python -m hessian_llm_vision_tpu_torch devices-info --json``
    in a subprocess (one row per card: platform "gpu", the card's name,
    its total memory), and the dispatch's help and unknown-command exit in
    this process."""
    t0 = time.perf_counter()
    got = subprocess.run([sys.executable, "-m", "hessian_llm_vision_tpu_torch", "devices-info",
                          "--json"], capture_output=True, text=True, timeout=300, check=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    rows = json.loads(got.stdout)
    seconds = time.perf_counter() - t0
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee), contextlib.redirect_stderr(io.StringIO()) as err:
        help_rc, bad_rc = dispatch.main(["--help"]), dispatch.main(["no-such-command"])
    res = {"rows": rows, "subprocess_s": seconds, "help_rc": help_rc, "unknown_rc": bad_rc}
    print(json.dumps({"15f_dispatch": res}))
    check_gates("15f the python -m dispatch", {
        "one row per card": len(rows) == torch.cuda.device_count(),
        "platform gpu": rows[0]["platform"] == "gpu",
        "kind is the card's name": rows[0]["kind"] == torch.cuda.get_device_name(0),
        "bytes_limit is the card's memory":
            rows[0].get("bytes_limit") == torch.cuda.get_device_properties(0).total_memory,
        "help lists every command": help_rc == 0 and all(
            f"  {name:13s} " in "".join(tee.parts) for name in dispatch.COMMANDS),
        "unknown command exits 2": bad_rc == 2 and "unknown command" in err.getvalue(),
    })
    return res


def remaining_clis(kernels, spectral, train_cli) -> dict:
    """Phase 15: 15a-15f, each timed; 15b-15d read seeded CIFAR-10 pickles
    and MNIST idx files written to temporary directories."""
    from hessian_llm_vision_tpu_torch import __main__ as dispatch
    from hessian_llm_vision_tpu_torch.cli import evaluate, forget, hpo, sweep

    out = {}
    with tempfile.TemporaryDirectory() as cifar, tempfile.TemporaryDirectory() as mnist, \
            tempfile.TemporaryDirectory() as tmp:
        write_cifar_batches(cifar, CIFAR_PER_BATCH)
        write_mnist_test_idx(mnist, FORGET_MNIST_N)
        with vision_data(mnist, cifar):
            steps = (("15a", lambda: forget_spiral_card_vs_cpu(forget, kernels)),
                     ("15b", lambda: forget_vgg16(forget, kernels, spectral)),
                     ("15c", lambda: forget_simplenet(forget, kernels)),
                     ("15d", lambda: evaluate_cli(evaluate, kernels)),
                     ("15e", lambda: sweep_and_hpo(sweep, hpo, train_cli, kernels, tmp)),
                     ("15f", lambda: dispatch_cli(dispatch)))
            for key, run in steps:
                t0 = time.perf_counter()
                out[key] = run()
                gc.collect()
                torch.cuda.empty_cache()
                print(f"phase {key} took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def remaining_clis_summary(rc: dict) -> dict:
    b = rc["15b"]
    return {
        "15a_forget_spiral": {k: rc["15a"][k] for k in (
            "task_a_rel", "ritz_rel", "curve_max_abs_diff", "own_basis_curve_max_abs_diff",
            "own_runs", "basis_overlap", "params_rel")}
        | {"card_s": rc["15a"]["card"]["seconds"], "cpu_s": rc["15a"]["cpu"]["seconds"],
           "drift_leak": [rc["15a"][d]["drift_leak"] for d in ("card", "cpu")]},
        "15b_forget_vgg16": {k: b[k] for k in (
            "P", "restarts", "matvecs", "basis_s", "phase_s", "ms_per_step", "drift_leak",
            "max_abs_VVt_minus_I", "projection_rel", "replay_rel", "replay_from_plain_rel",
            "update_floor",
            "max_memory_allocated_bytes", "ab_overlap")}
        | {"max_independent_residual": max(b["independent_residual_over_max_lambda"])},
        "15c_forget_simplenet": {t: {k: r[k] for k in ("seconds", "drift_leak", "ms_per_step")}
                                 for t, r in rc["15c"].items()},
        "15d_evaluate": {k: rc["15d"][k] for k in ("gpt2_mean_loss", "gpt2_s", "vgg16_s",
                                                   "vgg16_accuracy_recount")},
        "15e_sweep_hpo": {"losses": [p["loss"] for p in rc["15e"]["per_point"]],
                          "sweep_s": rc["15e"]["sweep_s"], "hpo_s": rc["15e"]["hpo_s"]},
        "15f_dispatch_s": rc["15f"]["subprocess_s"],
    }


def _synced(fn):
    """``(fn(), seconds)`` with the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _tree_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def data_axis_one_rank(spectrum_cli, kernels) -> dict:
    """Phase 16a: a NCCL group of one rank from ``dist_init.initialize``
    over an in-process store; the sharded loss's gradient, HVP and host-loop
    spectrum against the unsharded ones in this process."""
    import torch.distributed as dist

    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
    from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
    from hessian_llm_vision_tpu_torch.krylov.driver import dataset_spectrum_host
    from hessian_llm_vision_tpu_torch.parallel import (
        ShardedHessianOperator,
        dist_init,
        make_mesh,
        make_sharded_loss,
        shard_batch,
    )
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    wl = build_workload(spectrum_cli.build_parser().parse_args(DP_ONE_ARGV), CARD)
    up = dist_init.initialize(num_processes=1, process_id=0, store=dist.HashStore(),
                              backend="nccl")
    try:
        mesh = make_mesh()
        res = {"group_up": up, "backend": dist.get_backend(), "world_size": dist.get_world_size(),
               "mesh": mesh.shape,
               "collective_path": mesh.collective_path(torch.zeros(1, device=CARD), "data")}
        print(f"16a: one NCCL rank, the {res['collective_path']} collective path", flush=True)
        sharded = make_sharded_loss(wl.loss_fn, mesh)
        local = [shard_batch(b, mesh) for b in wl.batches]
        (l_1, g_1), res["grad_s"] = _synced(lambda: grad_and_loss(wl.loss_fn, wl.params,
                                                                   wl.batches[0]))
        (l_n, g_n), res["dp_grad_s"] = _synced(lambda: grad_and_loss(sharded, wl.params,
                                                                      local[0]))
        fl = Flattener(wl.params)
        res["grad_rel"] = rel_l2(fl.flatten(g_n), fl.flatten(g_1))
        res["grad_bitwise"] = _tree_equal(g_n, g_1) and torch.equal(l_n, l_1)
        del g_1, g_n
        v = torch.randn(fl.size, generator=torch.Generator(device=CARD).manual_seed(16),
                        device=CARD)
        v /= torch.linalg.vector_norm(v)
        op_1 = HessianOperator(wl.loss_fn, wl.params, wl.batches[0], precision="high")
        op_n = ShardedHessianOperator(wl.loss_fn, wl.params, local[0], mesh, precision="high")
        op_1(v), op_n(v)  # warm
        hv_1, res["hvp_s"] = _synced(lambda: op_1(v))
        hv_n, res["dp_hvp_s"] = _synced(lambda: op_n(v))
        res["hvp_rel"] = rel_l2(hv_n, hv_1)
        res["hvp_bitwise"] = torch.equal(hv_n, hv_1)
        del hv_1, hv_n
        kernels.reset_launch_counts()
        t_n, res["dp_spectrum_s"] = _synced(lambda: dataset_spectrum_host(
            sharded, wl.params, local, DP_ONE_ITERS, v0=v, precision="high", flattener=fl))
        res["launches"] = dict(kernels.LAUNCHES)
        t_1, res["spectrum_s"] = _synced(lambda: dataset_spectrum_host(
            wl.loss_fn, wl.params, wl.batches, DP_ONE_ITERS, v0=v, precision="high",
            flattener=fl))
        res["T_max_abs_diff"] = max(float((t_n.alphas - t_1.alphas).abs().max()),
                                    float((t_n.betas - t_1.betas).abs().max()))
        res["T_bitwise"] = torch.equal(t_n.alphas, t_1.alphas) and torch.equal(t_n.betas,
                                                                                t_1.betas)
        res["alphas"] = t_n.alphas.tolist()
    finally:
        dist.destroy_process_group()
    print(json.dumps({"data_axis_one_rank": res}), flush=True)
    scale = float(t_1.alphas.abs().max())
    check_gates("16a one NCCL rank", {
        "a NCCL group of one rank": up and res["backend"] == "nccl" and res["world_size"] == 1,
        "NCCL takes the native path": res["collective_path"] == "native",
        "DP grad within 1e-5": res["grad_rel"] <= DP_HVP_RTOL,
        "DP HVP within 1e-5": res["hvp_rel"] <= DP_HVP_RTOL,
        "host-loop T within 1e-4": res["T_max_abs_diff"] <= DP_T_TOL * max(1.0, scale),
        "no rank-k launch in the T-only loop": all(n == 0 for n in res["launches"].values()),
    })
    return res


def data_axis_rank(mesh, *, tmp: str) -> dict:
    """Phase 16b on one of two gloo ranks sharing the card (run by
    ``parallel.spawn.run_ranks``): the DP HVP timed with its gloo transfer
    apart, the P-sharded Lanczos with the rank-k pair on this rank's half
    of P, the pair against its plain version there, and the spectrum CLI's
    --probe_parallel.  Rank 0 also runs the unsharded references."""
    import torch.distributed as dist

    from hessian_llm_vision_tpu_torch.cli import spectrum as spectrum_cli
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.operators import HessianOperator
    from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
    from hessian_llm_vision_tpu_torch.krylov.sharded import PShard
    from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition
    from hessian_llm_vision_tpu_torch.ops import kernels, spectral
    from hessian_llm_vision_tpu_torch.parallel import (
        ShardedHessianOperator,
        basis_sharding,
        shard_batch,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lead = mesh.index == 0
    res = {"rank": mesh.index, "device": torch.cuda.get_device_name(0),
           "collective_path": mesh.collective_path(torch.zeros(1, device=CARD), "data")}
    wl = build_workload(spectrum_cli.build_parser().parse_args(DP_ONE_ARGV), CARD)
    batch = {k: t[:, :DP_SEQ] for k, t in wl.batches[0].items()}  # 8 x DP_SEQ tokens
    local = shard_batch(batch, mesh)
    res["local_rows"] = int(local["input_ids"].shape[0])
    P = sum(p.numel() for p in wl.params.values())
    v = torch.randn(P, generator=torch.Generator(device=CARD).manual_seed(16), device=CARD)
    v /= torch.linalg.vector_norm(v)
    op_dp = ShardedHessianOperator(wl.loss_fn, wl.params, local, mesh, precision="high")
    op_local = HessianOperator(wl.loss_fn, wl.params, local, precision="high")
    sh = PShard(basis_sharding(mesh), P)
    buf = torch.randn(P, device=CARD)
    times = {"hvp_dp_s": [], "hvp_local_s": [], "gloo_all_reduce_P_s": [], "gloo_gather_P_s": []}
    hv = op_dp(v)  # warm
    for _ in range(2):  # both ranks start each reading together
        dist.barrier()
        hv, t = _synced(lambda: op_dp(v))
        times["hvp_dp_s"].append(t)
        dist.barrier()
        times["hvp_local_s"].append(_synced(lambda: op_local(v))[1])
        dist.barrier()
        times["gloo_all_reduce_P_s"].append(_synced(lambda: mesh.sum_(buf, "data"))[1])
        dist.barrier()
        times["gloo_gather_P_s"].append(_synced(lambda: sh.gather(sh.part(buf)))[1])
    res["times"] = {k: statistics.median(t) for k, t in times.items()}
    res["times_all"] = times
    del buf, op_local
    if lead:  # one process's HVP of the whole batch
        whole = HessianOperator(wl.loss_fn, wl.params, batch, precision="high")(v)
        res["hvp_rel_vs_whole_batch"] = rel_l2(hv, whole)
        del whole
    del hv

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    lres, res["sharded_lanczos_s"] = _synced(lambda: lanczos(
        op_dp.matvec, P, DP_ITERS, v0=v, basis_sharding=basis_sharding(mesh)))
    res["launches"] = dict(kernels.LAUNCHES)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["basis_block"] = list(lres.basis.shape)
    res["T"] = [lres.alphas.tolist(), lres.betas.tolist()]
    res["ritz"] = sorted(ritz_decomposition(lres).eigvals.tolist())

    # the pair on this rank's block of the basis, against its plain version
    rows, g = lres.basis, sh.part(v).contiguous()
    c = torch.randn(DP_ITERS, generator=torch.Generator(device=CARD).manual_seed(17),
                    device=CARD)
    w = kernels.rank_k_dots(g, rows, c)
    out = kernels.rank_k_axpy(g, rows, w)
    res["pair"] = {
        "shape": list(rows.shape), "dtype": str(rows.dtype),
        "rel_l2_dots": rel_l2(w, spectral.rank_k_dots_reference(g, rows, c)),
        "rel_l2_apply": rel_l2(out, spectral.rank_k_apply_reference(g, rows, c)),
        "bitwise_repeatable": torch.equal(w, kernels.rank_k_dots(g, rows, c))
        and torch.equal(out, kernels.rank_k_axpy(g, rows, w)),
        "dots_plan": dataclasses.asdict(kernels.dots_launch_plan(
            DP_ITERS, rows.shape[1], rows.dtype, CARD, (rows.data_ptr(), g.data_ptr()))),
    }
    del lres, rows, w, out, op_dp
    torch.cuda.empty_cache()
    if lead:  # the unsharded run: one process, the whole batch, a (rows, P) basis
        ref, res["unsharded_lanczos_s"] = _synced(lambda: lanczos(
            HessianOperator(wl.loss_fn, wl.params, batch, precision="high").matvec, P,
            DP_ITERS, v0=v))
        res["T_ref"] = [ref.alphas.tolist(), ref.betas.tolist()]
        res["ritz_ref"] = sorted(ritz_decomposition(ref).eigvals.tolist())
        del ref
    del wl, v
    torch.cuda.empty_cache()
    if not lead:  # meanwhile, --probes 2 in this process alone
        with contextlib.redirect_stdout(io.StringIO()):
            seq, res["probes_in_turn_s"] = _synced(lambda: spectrum_cli.main(PROBE_PAR_ARGV)[0])
        res["probes_in_turn_eigvals"] = sorted(seq.eigvals.tolist())
    dist.barrier()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        spec, res["probe_parallel_s"] = _synced(lambda: spectrum_cli.main(
            PROBE_PAR_ARGV + ["--probe_parallel", "--out_spectrum", os.path.join(tmp, "pp")])[0])
    res["probe_parallel_stdout"] = out.getvalue()
    res["probe_parallel_eigvals"] = sorted(spec.eigvals.tolist())
    dist.barrier()
    return res


def data_axis_gates(res: list, artifact: bool, without_jax: bool) -> dict:
    """Phase 16b's summary and gates, from each rank's ``data_axis_rank``."""
    for r in res:
        print(f"16b rank {r['rank']}'s --probe_parallel output:\n{r['probe_parallel_stdout']}",
              flush=True)
    lead = res[0]
    T, T_ref = np.asarray(lead["T"][0]), np.asarray(lead["T_ref"][0])
    B, B_ref = np.asarray(lead["T"][1]), np.asarray(lead["T_ref"][1])
    ritz, ritz_ref = np.asarray(lead["ritz"]), np.asarray(lead["ritz_ref"])
    summary = {
        "s": [r["s"] for r in res], "ranks": len(res),
        "times_per_rank": [r["times"] for r in res],
        "hvp_rel_vs_whole_batch": lead["hvp_rel_vs_whole_batch"],
        "T_max_abs_diff": float(max(np.abs(T - T_ref).max(), np.abs(B - B_ref).max())),
        "ritz_max_rel": float(np.abs(ritz - ritz_ref).max() / np.abs(ritz_ref).max()),
        "ritz_extremes": [float(ritz[0]), float(ritz[-1])],
        "sharded_lanczos_s": [r["sharded_lanczos_s"] for r in res],
        "unsharded_lanczos_s": lead["unsharded_lanczos_s"],
        "basis_blocks": [r["basis_block"] for r in res],
        "launches": [r["launches"] for r in res],
        "peak_bytes": [r["peak_bytes"] for r in res],
        "pair": [r["pair"] for r in res],
        "probe_parallel_s": [r["probe_parallel_s"] for r in res],
        "probes_in_turn_s": res[1]["probes_in_turn_s"],
        "probe_parallel_max_rel": max(
            float(np.abs(np.asarray(r["probe_parallel_eigvals"])
                         - np.asarray(res[1]["probes_in_turn_eigvals"])).max()
                  / np.abs(res[1]["probes_in_turn_eigvals"]).max()) for r in res),
        "modules_without_jax": without_jax,
    }
    print(json.dumps({"data_axis_two_ranks": summary}), flush=True)
    for r in res:
        t = r["times"]
        print(f"16b rank {r['rank']}: the {r['collective_path']} collective path (gloo on CUDA "
              "tensors)", flush=True)
        print(f"16b rank {r['rank']}: DP HVP {t['hvp_dp_s']:.4f} s, of which the local HVP "
              f"{t['hvp_local_s']:.4f} s; gloo all-reduce of a P-vector on CUDA tensors "
              f"{t['gloo_all_reduce_P_s']:.4f} s, gather from halves "
              f"{t['gloo_gather_P_s']:.4f} s (gloo stages through host memory)", flush=True)
    per_iter = 2  # CGS2: two sharded projections an iteration
    check_gates("16b two gloo ranks on one card", {
        "two ranks, 4 + 4 rows": [r["local_rows"] for r in res] == [4, 4],
        "gloo on CUDA tensors takes the padded/broadcast path": all(
            r["collective_path"] == "padded/broadcast" for r in res),
        "DP HVP within 1e-5 of the whole batch's": summary["hvp_rel_vs_whole_batch"]
        <= DP_HVP_RTOL,
        "each rank holds (rows, P/2)": summary["basis_blocks"] == [list(DP_SHAPE[1:])] * 2,
        "T within 1e-4 of the unsharded run": np.allclose(T, T_ref, rtol=DP_T_TOL,
                                                          atol=DP_T_TOL)
        and np.allclose(B, B_ref, rtol=DP_T_TOL, atol=DP_T_TOL),
        "every rank's T the same": all(r["T"] == lead["T"] for r in res),
        "Ritz values within 1e-3": summary["ritz_max_rel"] <= DP_RITZ_RTOL,
        "the pair on each rank, pass 1 then pass 2 per projection": all(
            r["launches"] == {"rank_k_dots": per_iter * DP_ITERS,
                              "rank_k_axpy": per_iter * DP_ITERS} for r in res),
        "the pair against its plain version": all(
            p["rel_l2_dots"] <= 1e-5 and p["rel_l2_apply"] <= 1e-5 and p["bitwise_repeatable"]
            for p in summary["pair"]),
        "pass 1's aligned ring at P/2": all(p["dots_plan"]["aligned"] for p in summary["pair"]),
        "--probe_parallel --probes 2 = --probes 2": summary["probe_parallel_max_rel"]
        <= PROBE_PAR_RTOL,
        "rank 0 alone reports and writes the artifact": artifact and all(
            ("probe-parallel" in r["probe_parallel_stdout"]
             and "lambda_max = " in r["probe_parallel_stdout"]) == (r["rank"] == 0)
            for r in res),
        "the ranks ran without JAX": summary["modules_without_jax"],
    })
    return summary


def axes_rank(mesh, *, tmp: str, pythia_ref: dict, pythia_argv: list) -> dict:
    """Phases 16b, 17 and 18 on one of two gloo ranks sharing the card (run
    by ``parallel.spawn.run_ranks``; one spawn for all saves the ranks'
    start): ``data_axis_rank`` on the spawn's data axis, then
    ``model_axis_rank`` on a model axis and a pipeline axis of its own."""
    t0 = time.perf_counter()
    res = {"16b": data_axis_rank(mesh, tmp=tmp)}
    res["16b"]["s"] = time.perf_counter() - t0
    _free()
    res["17"] = model_axis_rank(pythia_ref=pythia_ref, pythia_argv=pythia_argv)
    return res


def axes_two_ranks(pythia_ref: dict, pythia_seq: int) -> tuple[dict, dict]:
    """Phases 16b, 17 and 18: ``axes_rank`` on two gloo ranks spawned on
    this card, then the gates (17's and 18's together)."""
    from hessian_llm_vision_tpu_torch.parallel.spawn import run_ranks

    _free()
    argv = PYTHIA_TRAIN_ARGV + ["--max_length", str(pythia_seq)]
    with tempfile.TemporaryDirectory() as tmp:
        ranks, wall = _synced(lambda: run_ranks(
            f"{os.path.abspath(__file__)}:axes_rank", DP_RANKS, tmp, backend="gloo",
            kwargs={"tmp": tmp, "pythia_ref": pythia_ref, "pythia_argv": argv},
            timeout=DP_TIMEOUT + MA_TIMEOUT))
        artifact = os.path.isfile(os.path.join(tmp, "pp.npz"))
    without_jax = all("jax" not in r["modules"] and "hessian_llm_vision_tpu" not in r["modules"]
                      for r in ranks)
    res = [r["result"] for r in ranks]
    dp = data_axis_gates([r["16b"] for r in res], artifact, without_jax)
    ma = model_axis_gates([r["17"] for r in res], pythia_ref, without_jax)
    dp["spawn_wall_s"] = ma["spawn_wall_s"] = wall
    return dp, ma


# ---------------------------------------------------------------------------
# phase 17: the model axis (tensor, sequence and expert parallelism)

def pp_block_columns() -> int:
    """18's per-rank basis columns: GPT-2 124M's blocks stacked over
    ``PP_STAGES`` stages, each rank's owned vector (its stage and its share
    of the replicated leaves), from a meta model."""
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.parallel.mesh import Mesh
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params
    from hessian_llm_vision_tpu_torch.parallel.pipeline import (
        pipeline_param_sharding,
        stack_pipeline_params,
    )
    from hessian_llm_vision_tpu_torch.utils.flatten import ModelAxisLayout

    cfg, axis = GPT2Config.gpt2_124m(), Mesh(1, PP_STAGES, axis_names=("data", "pp"))
    with torch.device("meta"):
        params = dict(GPT2LMHead(cfg).named_parameters())
    stacked = stack_pipeline_params(params, cfg.n_layer, PP_STAGES)
    splits = pipeline_param_sharding(stacked, axis)
    return ModelAxisLayout(shard_params(stacked, splits, axis), splits, PP_STAGES, 0).length


def tp_block_columns() -> int:
    """17a's per-rank basis columns: GPT-2 124M's owned vector on a model
    axis of 2 (``utils/flatten.py::ModelAxisLayout``), from a meta model."""
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.parallel.mesh import Mesh
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params, tp_layout
    from hessian_llm_vision_tpu_torch.utils.flatten import ModelAxisLayout

    cfg, axis = GPT2Config.gpt2_124m(), Mesh(1, MA_RANKS)
    with torch.device("meta"):
        params = dict(GPT2LMHead(cfg).named_parameters())
    splits = tp_layout(params, axis, cfg)
    return ModelAxisLayout(shard_params(params, splits, axis), splits, MA_RANKS, 0).length


def seeded_leaf(index: int, shape, seed: int, device) -> torch.Tensor:
    """Leaf ``index`` (in the flat order) of seeded vector ``seed``: the same
    numbers in every process on one card, leaf by leaf (no whole vector)."""
    gen = torch.Generator(device=device).manual_seed(seed * 100_003 + index)
    return torch.randn(shape, generator=gen, device=device)


def seeded_tree(shapes: dict, seed: int, device, splits=None, axis=None) -> dict:
    """Seeded vector ``seed`` as a dict of leaves of the whole ``shapes``,
    each leaf this rank's part under ``splits``."""
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_leaf
    from hessian_llm_vision_tpu_torch.utils.flatten import flat_order

    out = {}
    for i, name in enumerate(flat_order(shapes)):
        leaf = seeded_leaf(i, shapes[name], seed, device)
        out[name] = leaf if not splits else shard_leaf(leaf, splits[name], axis.model_index,
                                                       axis.num_model)
    return out


def tree_dot(a: dict, b, shapes: dict, splits=None, axis=None) -> float:
    """The whole vectors' dot product, float64-summed; ``b`` a dict or the
    seed of a seeded vector (drawn leaf by leaf).  On a model axis the split
    leaves' parts sum over the ranks and the replicated leaves count once."""
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_leaf
    from hessian_llm_vision_tpu_torch.utils.flatten import flat_order

    device = next(iter(a.values())).device
    total = torch.zeros(1, dtype=torch.float64, device=device)
    for i, name in enumerate(flat_order(shapes)):
        split = splits[name] if splits else None
        if axis is not None and split is None and axis.model_index != 0:
            continue
        y = b[name] if isinstance(b, dict) else seeded_leaf(i, shapes[name], b, device)
        if split is not None and not isinstance(b, dict):
            y = shard_leaf(y, split, axis.model_index, axis.num_model)
        total += torch.dot(a[name].reshape(-1).double(), y.reshape(-1).double())
    if axis is not None:
        axis.sum_(total, "model")
    return float(total)


def seeded_products(grad: dict, hvp, shapes: dict, splits=None, axis=None) -> dict:
    """17c's numbers, for either side: |g|, g . u_j, and for u_0 and u_1 the
    norm of H u_i and u_j . H u_i (u_j seeded vectors, ``hvp(tangent
    dict)``), and |u_j|."""
    device = next(iter(grad.values())).device
    seeds = [MA_SEED + j for j in range(MA_PROBES)]
    out = {"g_norm": math.sqrt(tree_dot(grad, grad, shapes, splits, axis)),
           "g_dot_u": [tree_dot(grad, s, shapes, splits, axis) for s in seeds],
           "u_norm": [], "hu_norm": [], "u_dot_hu": []}
    for s in seeds:
        u = seeded_tree(shapes, s, device, splits, axis)
        out["u_norm"].append(math.sqrt(tree_dot(u, u, shapes, splits, axis)))
        hu = hvp(u)
        del u
        out["hu_norm"].append(math.sqrt(tree_dot(hu, hu, shapes, splits, axis)))
        out["u_dot_hu"].append([tree_dot(hu, t, shapes, splits, axis) for t in seeds])
        del hu
    return out


@contextlib.contextmanager
def pythia_reference(ref: dict):
    """13b's first batch and its first refresh's T, recorded while 13b runs
    (the trainer reads every alpha and beta to the host itself, so this
    adds no synchronisation); :func:`pythia_step0` takes the rest of 17c's
    reference after 13b, outside its timings and its peak."""
    from hessian_llm_vision_tpu_torch.optim import lanczos_sgd_host as lsh

    grad, step = lsh.HostLanczosSGDTrainer._grad, lsh.host_recurrence_step

    def first_grad(self, params, batch):
        ref.setdefault("input_ids", batch["input_ids"])
        return grad(self, params, batch)

    def recorded(*args, **kw):
        out = step(*args, **kw)
        if len(ref.setdefault("alphas", [])) < MA_PYTHIA_K:  # the first refresh
            ref["alphas"].append(float(out[0]))
            ref.setdefault("betas", []).append(float(out[1]))
        return out

    lsh.HostLanczosSGDTrainer._grad, lsh.host_recurrence_step = first_grad, recorded
    try:
        yield ref
    finally:
        lsh.HostLanczosSGDTrainer._grad, lsh.host_recurrence_step = grad, step


def pythia_model(train_cli, argv: list) -> tuple:
    """``(args, model, params, init seconds)``: 13b's weights, the train
    CLI's init from its seed, drawn on the card."""
    from hessian_llm_vision_tpu_torch.cli import workloads

    args = train_cli.build_parser().parse_args(argv)
    model_cls, cfg = workloads.lm_config(args)
    model, init_s = _synced(lambda: workloads.init_model(model_cls, cfg, args.seed, CARD))
    return args, model, {n: p.detach() for n, p in model.named_parameters()}, init_s


def pythia_trainer(args, loss_fn, params: dict, basis_sharding=None):
    """13b's trainer as ``cli.train`` builds it from ``args``: a bf16
    basis, the refresh at "high"."""
    from hessian_llm_vision_tpu_torch.cli.train_optimizers import _lanczos_config
    from hessian_llm_vision_tpu_torch.optim import lanczos_sgd_host as lsh

    return lsh.HostLanczosSGDTrainer(
        loss_fn, params, _lanczos_config(args, args.lr, 1), batch_size=args.batch_size,
        basis_dtype=torch.bfloat16, refresh_precision="high", basis_sharding=basis_sharding)


def pythia_step0(train_cli, argv: list, ref: dict) -> None:
    """17c's unsharded reference, after 13b: 13b's weights drawn again from
    the seed, its first batch, the loss and :func:`seeded_products` of the
    gradient and of two HVPs at the trainer's refresh normalisation."""
    from hessian_llm_vision_tpu_torch.models import losses

    args, model, params, _ = pythia_model(train_cli, argv)
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    batch = {"input_ids": ref["input_ids"]}
    trainer = pythia_trainer(args, losses.lm_loss_fn(model, loss_chunk=args.loss_chunk), params)
    torch.cuda.reset_peak_memory_stats()
    (loss, g), ref["grad_s"] = _synced(lambda: trainer._grad(params, batch))
    products, ref["products_s"] = _synced(lambda: seeded_products(
        trainer.fl.unflatten(g), lambda u: trainer._hvp(params, batch, u), shapes))
    ref.update(loss=float(loss), input_ids=batch["input_ids"].cpu(),
               peak_bytes=torch.cuda.max_memory_allocated(), **products)
    del model, params, trainer, g
    _free()


def pythia_lanczos_sgd(train_cli, kernels, spectral) -> tuple[dict, dict]:
    """13b: LanczosSGD on Pythia-1.4B at seq 512 (or its one allowed cut,
    seq 256), recording 17c's reference; then :func:`pythia_step0`."""
    cut = []
    for seq in ("512", "256"):  # the one allowed cut: seq 256, the JAX protocol's
        argv = PYTHIA_TRAIN_ARGV + ["--max_length", seq]
        try:
            with pythia_reference({}) as ref:
                res = lm_lanczos_sgd(train_cli, kernels, spectral, argv,
                                     "13b Pythia-1.4B LanczosSGD", replay=True)
            break
        except torch.cuda.OutOfMemoryError as e:
            cut.append({"max_length": int(seq), "error": str(e).splitlines()[0]})
            print(f"13b: out of memory at seq {seq}; cutting to seq 256", flush=True)
            _free()
    else:
        raise SystemExit(f"13b: LanczosSGD on Pythia-1.4B fits at no length: {cut}")
    res.update({"max_length": int(seq), "oom_at": cut})
    pythia_step0(train_cli, argv, ref)
    check_gates("13b Pythia-1.4B LanczosSGD", {
        "every adjust at (4, 1,414,647,808) bf16": all(
            sh == (4, PYTHIA_P) and dt == "torch.bfloat16" for _, sh, dt in res["adjust_shapes"]),
        "17c's reference, drawn again, has step 0's loss": abs(
            ref["loss"] - res["steps"][0]["loss"]) <= MA_LOSS_RTOL * abs(res["steps"][0]["loss"]),
    })
    return res, ref


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _lm_parts(model, params: dict, axis, mode: str):
    """(this rank's params, the model on the axis, the splits) of a whole
    model: "tp"/"ep" split leaves, "sp" the tokens, "tpsp" and "epsp"
    both.  The axis's model is built on the meta device: only ``params``
    hold memory."""
    from hessian_llm_vision_tpu_torch.models.moe import ep_layout
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import (
        model_parallel_config,
        shard_params,
        tp_layout,
    )
    from hessian_llm_vision_tpu_torch.parallel.seq_parallel import seq_parallel_config

    cfg, seq_axis = model.config, axis.axis_names[1]
    if mode == "sp":
        splits, cfg_axis = dict.fromkeys(params), seq_parallel_config(cfg, axis, data_axis=None)
    else:
        splits = (ep_layout(params, axis, ep_axis=seq_axis) if mode in ("ep", "epsp")
                  else tp_layout(params, axis, cfg))
        cfg_axis = model_parallel_config(cfg, axis)
        if mode in ("tpsp", "epsp"):
            cfg_axis = seq_parallel_config(cfg_axis, axis, seq_axis=seq_axis, data_axis=None)
    with torch.device("meta"):
        on_axis = type(model)(cfg_axis)
    return shard_params(params, splits, axis), on_axis, splits


def _loss_grad_hvp(loss_fn, params, batch, v) -> tuple:
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss, hvp

    (loss, grad), grad_s = _synced(lambda: grad_and_loss(loss_fn, params, batch))
    hv, hvp_s = _synced(lambda: hvp(loss_fn, params, batch, v))
    return float(loss), grad, hv, grad_s, hvp_s


def _on_axis(mode: str, model, params: dict, axis, micro: int = PP_MICRO) -> tuple:
    """(this rank's params, its loss closure, the splits, the whole model's
    names to the layout's and back) on the axis: ``_lm_parts``'s modes, or
    "pp": the blocks stacked into the stages of the pipeline mesh ``axis``
    (its second axis), ``micro`` microbatches."""
    from hessian_llm_vision_tpu_torch.models import losses
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params
    from hessian_llm_vision_tpu_torch.parallel.pipeline import (
        make_pipelined_lm_loss,
        pipeline_param_sharding,
        stack_pipeline_params,
        unstack_pipeline_params,
    )

    if mode != "pp":
        local, on_axis, splits = _lm_parts(model, params, axis, mode)
        return local, losses.lm_loss_fn(on_axis), splits, lambda t: t, lambda t: t

    def stack(tree):
        return stack_pipeline_params(tree, model.config.n_layer, axis.num_model)

    stacked = stack(params)
    splits = pipeline_param_sharding(stacked, axis)
    with torch.device("meta"):
        meta = type(model)(model.config)
    loss_fn = make_pipelined_lm_loss(meta, axis, num_microbatches=micro)
    return shard_params(stacked, splits, axis), loss_fn, splits, stack, unstack_pipeline_params


def _vs_whole(mode: str, model, params, batches, axis, *, iters=0, timed=False,
              ref=None, remat_ticks=False, micro=PP_MICRO,
              clock_lanczos=False) -> tuple[dict, dict]:
    """One model on the axis against the same model whole in one process:
    loss, gathered gradient and HVP (the last rank runs the whole model's,
    and compares), and with ``iters`` the Lanczos with its basis on the
    model axis (the rank-k pair on each rank's aligned block) against the
    whole model's (rank 0 runs it, and compares).  ``timed``: one more HVP,
    with the model's collectives timed apart.  ``ref``: the whole model's
    numbers of an earlier call on the same params, batches and start
    vector, reused.  ``remat_ticks`` ("pp"): one more HVP of the plain
    pipeline and one with each tick rematerialised, each from a peak
    reset.  ``micro``: the pipeline's microbatches.  ``clock_lanczos``: the
    Lanczos's collectives counted by kind (each synchronised).  Returns
    (this run's numbers, the references)."""
    import torch.distributed as dist

    from hessian_llm_vision_tpu_torch.curvature.hvp import hvp
    from hessian_llm_vision_tpu_torch.krylov.driver import dataset_matvec
    from hessian_llm_vision_tpu_torch.krylov.lanczos import lanczos
    from hessian_llm_vision_tpu_torch.krylov.sharded import p_shard
    from hessian_llm_vision_tpu_torch.krylov.slq import ritz_decomposition
    from hessian_llm_vision_tpu_torch.models import losses
    from hessian_llm_vision_tpu_torch.models.convert import gather_model_axis
    from hessian_llm_vision_tpu_torch.ops import kernels
    from hessian_llm_vision_tpu_torch.parallel.mesh import basis_sharding, collective_clock
    from hessian_llm_vision_tpu_torch.parallel.param_sharding import shard_params
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener, ModelAxisLayout

    fl = Flattener(params)
    v = torch.randn(fl.size, generator=torch.Generator(device=CARD).manual_seed(MA_SEED),
                    device=CARD)
    res = {}
    checker = axis.model_index == axis.num_model - 1
    if ref is None:
        ref = {}
        whole_loss = losses.lm_loss_fn(model)
        if checker:  # the whole model in one process
            ref["loss"], g, hv, _, ref["hvp_s"] = _loss_grad_hvp(whole_loss, params, batches[0],
                                                                 fl.unflatten(v))
            ref["grad"], ref["hvp"] = fl.flatten(g), fl.flatten(hv)
            del g, hv
        if iters and axis.model_index == 0:  # meanwhile its Lanczos
            whole = lanczos(dataset_matvec(whole_loss, params, batches), fl.size, iters, v0=v)
            ref["T"] = [whole.alphas.tolist(), whole.betas.tolist()]
            ref["ritz"] = sorted(ritz_decomposition(whole).eigvals.tolist())
            del whole
    dist.barrier()
    local, loss_fn, splits, to_layout, from_layout = _on_axis(mode, model, params, axis, micro)
    res["collective_path"] = axis.collective_path(v, "model")
    laid_out = to_layout(params)
    tangent = shard_params(to_layout(fl.unflatten(v)), splits, axis)
    torch.cuda.reset_peak_memory_stats()
    res["loss"], g, hv, res["grad_s"], res["hvp_s"] = _loss_grad_hvp(
        loss_fn, local, batches[0], tangent)
    if timed:
        dist.barrier()
        with collective_clock() as clock:
            _synced(lambda: hvp(loss_fn, local, batches[0], tangent))
        res["collectives"] = {"hvp_s": clock["s"], "calls": clock["calls"],
                              "bytes": clock["bytes"], "by": clock["by"]}
    split_bytes = sum(local[k].numel() for k, s in splits.items() if s is not None)
    whole_split = sum(laid_out[k].numel() for k, s in splits.items() if s is not None)
    res["split_share"] = split_bytes / whole_split if whole_split else 0.0
    res["param_bytes"] = sum(t.numel() * t.element_size() for t in local.values())
    G = fl.flatten(from_layout(gather_model_axis(g, axis, splits)))
    H = fl.flatten(from_layout(gather_model_axis(hv, axis, splits)))
    del g, hv
    if remat_ticks:
        from hessian_llm_vision_tpu_torch.parallel.pipeline import make_pipelined_lm_loss

        with torch.device("meta"):
            meta = type(model)(model.config)
        res["remat_ticks"] = {}
        for name, fn in (("plain", loss_fn), ("remat_ticks", make_pipelined_lm_loss(
                meta, axis, num_microbatches=micro, remat_ticks=True))):
            _free()
            torch.cuda.reset_peak_memory_stats()
            out, secs = _synced(lambda fn=fn: hvp(fn, local, batches[0], tangent))
            res["remat_ticks"][f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated()
            res["remat_ticks"][f"{name}_hvp_s"] = secs
            if name == "remat_ticks":
                res["remat_ticks"]["hvp_rel"] = rel_l2(
                    fl.flatten(from_layout(gather_model_axis(out, axis, splits))), H)
            del out
    if iters:
        layout = ModelAxisLayout(local, splits, axis.num_model, axis.model_index)
        both = basis_sharding(axis, layout)
        v_rank = Flattener(local).flatten(tangent)
        del tangent
        kernels.reset_launch_counts()
        dist.barrier()
        with collective_clock() if clock_lanczos else contextlib.nullcontext() as clock:
            lres, res["lanczos_s"] = _synced(lambda: lanczos(
                dataset_matvec(loss_fn, local, batches), layout.size, iters, v0=v_rank,
                basis_sharding=both))
        res["launches"] = dict(kernels.LAUNCHES)
        if clock_lanczos:
            res["lanczos_collectives"] = clock
        res["T"] = [lres.alphas.tolist(), lres.betas.tolist()]
        res["ritz"] = sorted(ritz_decomposition(lres).eigvals.tolist())
        res["basis_block"] = list(lres.basis.shape)
        sh = p_shard(both, layout.size)
        first = gather_model_axis(sh.gather(lres.basis[0].contiguous()), axis, layout)
        first = fl.flatten(from_layout(Flattener(laid_out).unflatten(first)))
        res["first_row_rel"] = rel_l2(first, v / torch.linalg.vector_norm(v))
        del first
        rows = lres.basis
        gv = torch.randn(rows.shape[1], generator=torch.Generator(device=CARD).manual_seed(18),
                         device=CARD)
        c = torch.randn(iters, generator=torch.Generator(device=CARD).manual_seed(19),
                        device=CARD)
        res["pair"] = _pair_check(kernels, rows, gv, c)
        del lres, rows, gv
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    if checker:
        res.update({"loss_rel": abs(res["loss"] - ref["loss"]) / abs(ref["loss"]),
                    "grad_rel": rel_l2(G, ref["grad"]), "hvp_rel": rel_l2(H, ref["hvp"]),
                    "whole_hvp_s": ref["hvp_s"]})
    if "T" in ref:
        res["T_ref"], res["ritz_ref"] = ref["T"], ref["ritz"]
    return res, ref


def _pair_check(kernels, rows, g, c) -> dict:
    """The rank-k pair on a rank's basis block against its plain version,
    repeated bit for bit, and pass 1's launch plan there."""
    from hessian_llm_vision_tpu_torch.ops import spectral

    w = kernels.rank_k_dots(g, rows, c)
    out = kernels.rank_k_axpy(g, rows, w)
    return {"shape": list(rows.shape), "dtype": str(rows.dtype),
            "rel_l2_dots": rel_l2(w, spectral.rank_k_dots_reference(g, rows, c)),
            "rel_l2_apply": rel_l2(out, spectral.rank_k_apply_reference(g, rows, c)),
            "bitwise_repeatable": torch.equal(w, kernels.rank_k_dots(g, rows, c))
            and torch.equal(out, kernels.rank_k_axpy(g, rows, w)),
            "dots_plan": dataclasses.asdict(kernels.dots_launch_plan(
                rows.shape[0], rows.shape[1], rows.dtype, CARD,
                (rows.data_ptr(), g.data_ptr())))}


def _token_batches(vocab: int, shape: tuple, n: int, seed: int) -> list:
    ids = np.random.RandomState(seed).randint(0, vocab, size=(n,) + tuple(shape))
    return [{"input_ids": torch.as_tensor(i, device=CARD)} for i in ids]


def pythia_on_axis(axis, pythia_ref: dict, argv: list, keep: Optional[dict] = None) -> dict:
    """17c: Pythia-1.4B tensor-parallel on 13b's weights (the train CLI's
    init from its seed) and first batch: the loss, one gradient, two HVPs
    and 13b's first refresh (a 4-iteration host loop from the gradient,
    the trainer's basis on the model axis), held to 13b's unsharded numbers
    through inner products with seeded vectors."""
    import torch.distributed as dist

    from hessian_llm_vision_tpu_torch.cli import train as train_cli
    from hessian_llm_vision_tpu_torch.curvature.hvp import grad_and_loss
    from hessian_llm_vision_tpu_torch.models import losses
    from hessian_llm_vision_tpu_torch.optim import lanczos_sgd_host as lsh
    from hessian_llm_vision_tpu_torch.parallel.mesh import basis_sharding
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener, ModelAxisLayout

    args, model, params, init_s = pythia_model(train_cli, argv)
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    local, on_axis, splits = _lm_parts(model, params, axis, "tp")
    del model, params
    _free()
    res = {"init_s": init_s, "max_length": int(pythia_ref["input_ids"].shape[1]),
           "P": sum(math.prod(s) for s in shapes.values()),
           "param_bytes": sum(t.numel() * t.element_size() for t in local.values()),
           "split_leaves": sum(1 for s in splits.values() if s is not None),
           "vocab_parallel": [n for n in ("embed_in", "embed_out.kernel") if splits[n]]}
    batch = {"input_ids": pythia_ref["input_ids"].to(CARD)}
    loss_fn = losses.lm_loss_fn(on_axis, loss_chunk=args.loss_chunk)
    layout = ModelAxisLayout(local, splits, axis.num_model, axis.model_index)
    trainer = pythia_trainer(args, loss_fn, local, basis_sharding(axis, layout))
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    (loss, grad), res["grad_s"] = _synced(lambda: grad_and_loss(loss_fn, local, batch))
    res["loss"] = float(loss)
    hvps = []

    def hvp(u):
        out, s = _synced(lambda: trainer._hvp(local, batch, u))
        hvps.append(s)
        return out

    res["products"] = seeded_products(grad, hvp, shapes, splits, axis)
    res["hvp_s"] = hvps
    g_rank = Flattener(local).flatten(grad)
    del grad
    T, step = {"alphas": [], "betas": []}, lsh.host_recurrence_step

    def recorded(*a, **kw):
        out = step(*a, **kw)
        T["alphas"].append(float(out[0]))
        T["betas"].append(float(out[1]))
        return out

    lsh.host_recurrence_step = recorded
    try:
        dist.barrier()
        (_, basis), res["host_loop_s"] = _synced(lambda: trainer.refresh_spectrum(
            local, batch, g_rank))
    finally:
        lsh.host_recurrence_step = step
    if keep is not None:  # the refresh's (k, P_local) block, the gradient and the shard
        keep.update(basis=basis, grad=g_rank, shard=trainer.sh)
    del basis
    res["T"] = T
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    return res


def model_axis_rank(*, pythia_ref: dict, pythia_argv: list) -> dict:
    """Phases 17 and 18 on one of the two gloo ranks, after 16b in the same
    spawn: 17c first (its two ranks fill most of the card, so it runs
    before the others have allocated anything), then 17a, 17b, 17e, 18 and
    17d, each model built whole from its seed on every rank, then split;
    the ranks share the whole-model references, and 17e and 18 reuse
    17b's and 17a's."""
    import torch.distributed as dist

    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.moe import make_ep_mesh
    from hessian_llm_vision_tpu_torch.parallel.mesh import make_mesh
    from hessian_llm_vision_tpu_torch.parallel.pipeline import make_pipeline_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    axis, ep_axis = make_mesh(1, MA_RANKS), make_ep_mesh(1, MA_RANKS)
    pp_axis = make_pipeline_mesh(MA_RANKS // PP_STAGES, PP_STAGES)
    res = {"rank": axis.model_index, "mesh": axis.shape, "ep_mesh": ep_axis.shape,
           "pp_mesh": pp_axis.shape}
    t_start = t0 = time.perf_counter()
    res["17c"] = pythia_on_axis(axis, pythia_ref, pythia_argv)
    res["17c"]["s"] = time.perf_counter() - t0
    _free()
    t0 = time.perf_counter()
    cfg = GPT2Config.gpt2_124m()
    with torch.device(CARD):
        model = GPT2LMHead(cfg, generator=torch.Generator(CARD).manual_seed(MA_SEED))
    params = {n: p.detach() for n, p in model.named_parameters()}
    res["gpt2_params"] = sum(p.numel() for p in params.values())
    tp_batches = _token_batches(cfg.vocab_size, MA_TP_SHAPE, MA_TP_BATCHES, MA_SEED)
    res["17a"], ref_a = _vs_whole("tp", model, params, tp_batches, axis, iters=MA_ITERS,
                                  timed=True)
    res["17a"]["s"] = time.perf_counter() - t0
    _free()
    t0 = time.perf_counter()
    sp_batches = _token_batches(cfg.vocab_size, MA_SP_SHAPE, 1, MA_SEED + 1)
    res["17b"], ref_b = _vs_whole("sp", model, params, sp_batches, axis)
    res["17b"]["s"] = time.perf_counter() - t0
    _free()
    t0 = time.perf_counter()
    res["17e"] = _vs_whole("tpsp", model, params, sp_batches, axis, timed=True, ref=ref_b)[0]
    res["17e"]["s"] = time.perf_counter() - t0
    del ref_b
    _free()
    t0 = time.perf_counter()
    res["18"] = _vs_whole("pp", model, params, tp_batches, pp_axis, iters=MA_ITERS,
                          timed=True, ref=ref_a, remat_ticks=True)[0]
    res["18"]["s"] = time.perf_counter() - t0
    del model, params, ref_a
    _free()
    t0 = time.perf_counter()
    for gating, top_k in (("dense", 0), ("top2", 2)):
        cfg = GPT2Config.moe_80m(moe_top_k=top_k)
        with torch.device(CARD):
            model = GPT2LMHead(cfg, generator=torch.Generator(CARD).manual_seed(MA_SEED))
        params = {n: p.detach() for n, p in model.named_parameters()}
        batches = _token_batches(cfg.vocab_size, MA_MOE_SHAPE, 1, MA_SEED + 2)
        res[f"17d_{gating}"], ref_d = _vs_whole("ep", model, params, batches, ep_axis)
        # 17f: expert and sequence parallelism on the one axis, on 17d's references
        res[f"17f_{gating}"] = _vs_whole("epsp", model, params, batches, ep_axis, ref=ref_d)[0]
        del model, params, ref_d
        _free()
    res["17d_s"] = time.perf_counter() - t0
    dist.barrier()
    res["s"] = time.perf_counter() - t_start
    return res


def axes_alone(train_cli, kernels, spectral) -> tuple[dict, dict]:
    """13b with 17c's reference, then phases 16b, 17 and 18 (the kernels
    built)."""
    res, ref = pythia_lanczos_sgd(train_cli, kernels, spectral)
    return axes_two_ranks(ref, res["max_length"])


def tp_sp_and_pipeline(res: list, T_ref: np.ndarray, ritz_ref: np.ndarray) -> tuple:
    """17e's and 18's summary (merged into 17's line), printed lines and
    gates, from each rank's ``model_axis_rank`` and 17a's whole-model T
    and Ritz values."""
    lead, last = res[0], res[-1]
    e, pp = last["17e"], {**lead["18"], **last["18"]}
    pp["T"] = lead["18"]["T"]
    T18, ritz18 = np.concatenate(pp["T"]), np.asarray(pp["ritz"])
    bubble = (PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1)
    pp_block = pp_block_columns()
    per_iter = 2  # CGS2: two projections an iteration
    summary = {
        "17e_tp_sp": {k: e[k] for k in ("loss_rel", "grad_rel", "hvp_rel", "hvp_s", "grad_s",
                                        "whole_hvp_s", "s")}
        | {"split_share": [r["17e"]["split_share"] for r in res],
           "param_bytes": [r["17e"]["param_bytes"] for r in res],
           "collectives": [r["17e"]["collectives"] for r in res],
           "hvp_s_per_rank": [r["17e"]["hvp_s"] for r in res],
           "peak_bytes": [r["17e"]["peak_bytes"] for r in res]},
        "18_pipeline": {k: pp[k] for k in ("loss_rel", "grad_rel", "hvp_rel", "first_row_rel",
                                           "basis_block", "lanczos_s", "hvp_s", "grad_s",
                                           "whole_hvp_s", "s")}
        | {"stages": PP_STAGES, "microbatches": PP_MICRO, "bubble": bubble,
           "T_max_abs_diff": float(np.abs(T18 - T_ref).max()),
           "ritz_max_rel": float(np.abs(ritz18 - ritz_ref).max() / np.abs(ritz_ref).max()),
           "split_share": [r["18"]["split_share"] for r in res],
           "param_bytes": [r["18"]["param_bytes"] for r in res],
           "launches": [r["18"]["launches"] for r in res],
           "pair": [r["18"]["pair"] for r in res],
           "collectives": [r["18"]["collectives"] for r in res],
           "hvp_s_per_rank": [r["18"]["hvp_s"] for r in res],
           "peak_bytes": [r["18"]["peak_bytes"] for r in res],
           "remat_ticks": [r["18"]["remat_ticks"] for r in res]},
    }
    for r in res:
        t, c = r["17e"], r["17e"]["collectives"]
        print(f"17e rank {r['rank']}: TP x SP HVP {t['hvp_s']:.4f} s (17b's whole model "
              f"{e['whole_hvp_s']:.4f} s); its model's gloo collectives {c['hvp_s']:.4f} s of an "
              f"HVP in {c['calls']} calls, {c['bytes']} bytes; params {t['param_bytes']} bytes, "
              f"peak {t['peak_bytes']} bytes", flush=True)
        t, c = r["18"], r["18"]["collectives"]
        moved = {k: sum(c["by"][kind][k] for kind in ("send_recv", "broadcast"))
                 for k in ("s", "calls", "bytes")}
        print(f"18 rank {r['rank']}: pipelined HVP {t['hvp_s']:.4f} s (17a's whole model "
              f"{pp['whole_hvp_s']:.4f} s), {PP_STAGES} stages, {PP_MICRO} microbatches, bubble "
              f"{bubble:.4f}; the shifts and the exit ({t['collective_path']}) {moved['s']:.4f} s "
              f"of an HVP in {moved['calls']} calls, {moved['bytes']} bytes; the gradient and "
              f"loss sums {c['by']['all_reduce']['s']:.4f} s in "
              f"{c['by']['all_reduce']['calls']} calls, {c['by']['all_reduce']['bytes']} bytes; "
              f"params {t['param_bytes']} bytes, peak {t['peak_bytes']} bytes; the Lanczos "
              f"{t['lanczos_s']:.2f} s", flush=True)
        rt = t["remat_ticks"]
        print(f"18 rank {r['rank']}: an HVP from a peak reset, plain {rt['plain_hvp_s']:.4f} s "
              f"peak {rt['plain_peak_bytes']} bytes; remat_ticks {rt['remat_ticks_hvp_s']:.4f} s "
              f"peak {rt['remat_ticks_peak_bytes']} bytes, rel-L2 to 18's HVP "
              f"{rt['hvp_rel']:.3e}", flush=True)
    gates = {
        "17e TP x SP loss within 1e-6 of 17b's whole model": e["loss_rel"] <= MA_LOSS_RTOL,
        "17e gathered grad and HVP within 1e-5": max(e["grad_rel"], e["hvp_rel"]) <= MA_REL,
        "17e half of the split leaves' bytes on each rank": all(
            abs(r["17e"]["split_share"] - 0.5) < 1e-9 for r in res),
        "18 pipelined loss within 1e-6 of 17a's whole model": pp["loss_rel"] <= MA_LOSS_RTOL,
        "18 gathered grad and HVP within 1e-5": max(pp["grad_rel"], pp["hvp_rel"]) <= MA_REL,
        "18 T within 1e-4": np.allclose(T18, T_ref, rtol=DP_T_TOL, atol=DP_T_TOL),
        "18 every rank's T the same": all(r["18"]["T"] == pp["T"] for r in res),
        "18 Ritz values within 1e-3":
            summary["18_pipeline"]["ritz_max_rel"] <= DP_RITZ_RTOL,
        "18 the basis's first row the start vector": pp["first_row_rel"] <= MA_REL,
        f"18 each rank's block (10, {pp_block})": all(
            r["18"]["basis_block"] == [MA_ITERS, pp_block] for r in res),
        "18 half of the block bytes on each rank": all(
            abs(r["18"]["split_share"] - 0.5) < 1e-9 for r in res),
        "18 the pair on each rank, pass 1 then pass 2 per projection": all(
            r["18"]["launches"] == {"rank_k_dots": per_iter * MA_ITERS,
                                    "rank_k_axpy": per_iter * MA_ITERS} for r in res),
        "18 the pair against its plain version": all(
            p["rel_l2_dots"] <= 1e-5 and p["rel_l2_apply"] <= 1e-5 and p["bitwise_repeatable"]
            and p["dtype"] == "torch.float32"
            for p in summary["18_pipeline"]["pair"]),
        "18 pass 1's aligned ring at P_local": all(p["dots_plan"]["aligned"]
                                                   for p in summary["18_pipeline"]["pair"]),
        "18 the remat_ticks HVP within 1e-6 of 18's own": all(
            r["18"]["remat_ticks"]["hvp_rel"] <= PP_REMAT_REL for r in res),
    }
    return summary, gates


def model_axis_gates(res: list, q: dict, without_jax: bool) -> dict:
    """Phase 17's and 18's summary and gates, from each rank's
    ``model_axis_rank`` and 13b's unsharded reference ``q``."""
    lead, last = res[0], res[-1]  # rank 0 holds the whole Lanczos, the last rank the rest
    a, b = {**lead["17a"], **last["17a"]}, last["17b"]
    a["T"] = lead["17a"]["T"]
    T, T_ref = np.concatenate(a["T"]), np.concatenate(a["T_ref"])  # alphas, then betas
    ritz, ritz_ref = np.asarray(a["ritz"]), np.asarray(a["ritz_ref"])
    c = [r["17c"] for r in res]
    p, root_P = c[0]["products"], math.sqrt(c[0]["P"])
    # inner products with seeded vectors u, held to the whole vectors' bar:
    # a relative error e of y moves y.u by about e |y| |u| / sqrt(P), so
    # |x.u - y.u| sqrt(P) / (|y| |u|) is read against 1e-5
    g_dot = max(abs(x - y) * root_P / (q["g_norm"] * u)
                for x, y, u in zip(p["g_dot_u"], q["g_dot_u"], p["u_norm"]))
    hu_dot = max(abs(x - y) * root_P / (q["hu_norm"][i] * u) for i in range(MA_PROBES)
                 for x, y, u in zip(p["u_dot_hu"][i], q["u_dot_hu"][i], p["u_norm"]))
    pT = np.asarray([c[0]["T"]["alphas"], c[0]["T"]["betas"]])
    qT = np.asarray([q["alphas"], q["betas"]])
    summary = {
        "s": lead["s"], "ranks": len(res), "gpt2_params": lead["gpt2_params"],
        "17a_tp": {k: a[k] for k in ("loss_rel", "grad_rel", "hvp_rel", "first_row_rel",
                                     "basis_block", "lanczos_s", "hvp_s", "grad_s",
                                     "whole_hvp_s", "s")}
        | {"T_max_abs_diff": float(np.abs(T - T_ref).max()),
           "ritz_max_rel": float(np.abs(ritz - ritz_ref).max() / np.abs(ritz_ref).max()),
           "ritz_extremes": [float(ritz[0]), float(ritz[-1])],
           "split_share": [r["17a"]["split_share"] for r in res],
           "param_bytes": [r["17a"]["param_bytes"] for r in res],
           "launches": [r["17a"]["launches"] for r in res],
           "pair": [r["17a"]["pair"] for r in res],
           "collectives": [r["17a"]["collectives"] for r in res],
           "hvp_s_per_rank": [r["17a"]["hvp_s"] for r in res],
           "peak_bytes": [r["17a"]["peak_bytes"] for r in res]},
        "17b_sp": {k: b[k] for k in ("loss_rel", "grad_rel", "hvp_rel", "hvp_s", "whole_hvp_s",
                                     "s")}
        | {"peak_bytes": [r["17b"]["peak_bytes"] for r in res]},
        "17c_pythia_tp": {"loss": c[0]["loss"], "loss_13b": q["loss"],
                          "loss_rel": abs(c[0]["loss"] - q["loss"]) / abs(q["loss"]),
                          "g_dot_rel": g_dot, "hu_dot_rel": hu_dot, "P": c[0]["P"],
                          "T_max_abs_diff": float(np.abs(pT - qT).max()),
                          "T": pT.tolist(), "T_13b": qT.tolist(),
                          "max_length": c[0]["max_length"],
                          "vocab_parallel": c[0]["vocab_parallel"],
                          "param_bytes": [r["param_bytes"] for r in c],
                          "peak_bytes": [r["peak_bytes"] for r in c],
                          "grad_s": c[0]["grad_s"], "hvp_s": c[0]["hvp_s"],
                          "host_loop_s": c[0]["host_loop_s"], "init_s": c[0]["init_s"],
                          "s": c[0]["s"], "reference_grad_s": q["grad_s"],
                          "reference_products_s": q["products_s"],
                          "reference_peak_bytes": q["peak_bytes"]},
        **{f"17{p}_{name}_{g}": {k: last[f"17{p}_{g}"][k] for k in (
            "loss_rel", "grad_rel", "hvp_rel", "hvp_s", "whole_hvp_s")}
           | {"split_share": [r[f"17{p}_{g}"]["split_share"] for r in res]}
           for p, name in (("d", "ep"), ("f", "ep_sp")) for g in ("dense", "top2")},
        "collective_paths": sorted({r[k]["collective_path"] for r in res
                                    for k in ("17a", "17b", "17e", "18", "17f_dense")}),
        "17d_s": last["17d_s"],
        "modules_without_jax": without_jax,
    }
    new, new_gates = tp_sp_and_pipeline(res, T_ref, ritz_ref)
    summary.update(new)
    print(json.dumps({"model_axis_two_ranks": summary}), flush=True)
    for r in res:
        t = r["17a"]
        print(f"17 rank {r['rank']}: the model's collectives took the "
              f"{t['collective_path']} path (gloo on CUDA tensors)", flush=True)
        print(f"17a rank {r['rank']}: TP HVP {t['hvp_s']:.4f} s (whole model on one process "
              f"{a['whole_hvp_s']:.4f} s); its model's gloo collectives "
              f"{t['collectives']['hvp_s']:.4f} s of an HVP in {t['collectives']['calls']} calls, "
              f"{t['collectives']['bytes']} bytes; peak {t['peak_bytes']} bytes; 17c peak "
              f"{r['17c']['peak_bytes']} bytes, params {r['17c']['param_bytes']} bytes "
              f"(13a's whole-model HVP peak: 43.86 GB)", flush=True)
    per_iter = 2  # CGS2: two projections an iteration
    check_gates("17 the model axis on two gloo ranks", {
        "17a loss within 1e-6": a["loss_rel"] <= MA_LOSS_RTOL,
        "17a gathered grad and HVP within 1e-5": max(a["grad_rel"], a["hvp_rel"]) <= MA_REL,
        "17a T within 1e-4": np.allclose(T, T_ref, rtol=DP_T_TOL, atol=DP_T_TOL),
        "17a every rank's T the same": all(r["17a"]["T"] == a["T"] for r in res),
        "17a Ritz values within 1e-3": summary["17a_tp"]["ritz_max_rel"] <= DP_RITZ_RTOL,
        "17a the basis's first row the start vector": a["first_row_rel"] <= MA_REL,
        "17a each rank's block (10, P_local), P_local a multiple of 8": all(
            r["17a"]["basis_block"][0] == MA_ITERS and r["17a"]["basis_block"][1] % 8 == 0
            for r in res),
        "17a about half of the split leaves' bytes on each rank": all(
            abs(r["17a"]["split_share"] - 0.5) < 1e-9 for r in res),
        "17a the pair on each rank, pass 1 then pass 2 per projection": all(
            r["17a"]["launches"] == {"rank_k_dots": per_iter * MA_ITERS,
                                     "rank_k_axpy": per_iter * MA_ITERS} for r in res),
        "17a the pair against its plain version": all(
            p["rel_l2_dots"] <= 1e-5 and p["rel_l2_apply"] <= 1e-5 and p["bitwise_repeatable"]
            for p in summary["17a_tp"]["pair"]),
        "17a pass 1's aligned ring at P_local": all(p["dots_plan"]["aligned"]
                                                    for p in summary["17a_tp"]["pair"]),
        "17b loss within 1e-6": b["loss_rel"] <= MA_LOSS_RTOL,
        "17b gathered grad and HVP within 1e-5": max(b["grad_rel"], b["hvp_rel"]) <= MA_REL,
        "17c loss within 1e-6 of 13b's": summary["17c_pythia_tp"]["loss_rel"] <= MA_LOSS_RTOL,
        "17c gradient within 1e-5 (seeded inner products, scaled by sqrt(P))": g_dot <= MA_REL,
        "17c two HVPs within 1e-5 (seeded inner products, scaled by sqrt(P))": hu_dot <= MA_REL,
        "17c 13b's 4-iteration T within 1e-4": np.allclose(pT, qT, rtol=DP_T_TOL,
                                                          atol=DP_T_TOL),
        "17c vocab-parallel embed_in and embed_out":
            c[0]["vocab_parallel"] == ["embed_in", "embed_out.kernel"],
        **{f"17{p} {g} {name} loss, grad and HVP": last[f"17{p}_{g}"]["loss_rel"] <= MA_LOSS_RTOL
           and max(last[f"17{p}_{g}"]["grad_rel"], last[f"17{p}_{g}"]["hvp_rel"]) <= MA_REL
           for p, name in (("d", "EP"), ("f", "EP x SP on one axis")) for g in ("dense", "top2")},
        "17f half of the experts' bytes on each rank": all(
            abs(r[f"17f_{g}"]["split_share"] - 0.5) < 1e-9 for r in res for g in ("dense", "top2")),
        "the gloo ranks on CUDA tensors take the padded/broadcast path":
            summary["collective_paths"] == ["padded/broadcast"],
        **new_gates,
        "the ranks ran without JAX": summary["modules_without_jax"],
    })
    return summary


# ------------------------------------------------------------------ phase 19

def _chunked_loss(model, chunk: int, remat: bool):
    """``lm_loss_fn(model, loss_chunk=chunk)`` with the chunks'
    rematerialisation switched by ``remat`` (the closure keeps it on)."""
    from torch.func import functional_call

    from hessian_llm_vision_tpu_torch.models.losses import chunked_causal_lm_loss

    def loss(params, batch):
        ids = batch["input_ids"]
        hidden = functional_call(model, params, (ids,), {"return_hidden": True})
        return chunked_causal_lm_loss(hidden, model.output_kernel(params), ids,
                                      batch.get("attention_mask"), chunk=chunk, remat=remat)

    loss.model_config = model.config
    return loss


def _hvp_arm(loss_fn, params: dict, batch: dict, v: torch.Tensor, *, remat=False) -> dict:
    """One arm of 19a: its HVP (flat), the peak from a reset around one HVP
    and that peak over what was allocated before it, then the ms of one HVP
    by CUDA events over ``REMAT_ITERS`` calls (the first call warmed it)."""
    from hessian_llm_vision_tpu_torch.curvature.hvp import hvp_fn
    from hessian_llm_vision_tpu_torch.utils.cuda_timing import time_ms
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    fl = Flattener(params)
    hvp, vt = hvp_fn(loss_fn, remat=remat), fl.unflatten(v)
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fl.flatten(hvp(params, batch, vt))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = time_ms(lambda: hvp(params, batch, vt), iters=REMAT_ITERS, warmup=0)
    return {"hvp": out, "peak_bytes": peak, "working_set_bytes": peak - base, "hvp_ms": ms}


def remat_124m(keep: dict) -> dict:
    """Phase 19a: one HVP per arm on phase 6's model (see the docstring)."""
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.losses import lm_loss_fn

    model, params = keep["model"], keep["params"]
    cfg = model.config
    with torch.device("meta"):
        blocked = GPT2LMHead(dataclasses.replace(cfg, attn_block_q=REMAT_BLOCK))
        plain = GPT2LMHead(dataclasses.replace(cfg, attn_block_q=REMAT_BLOCK, attn_remat=False))
    arms = {"dense": lm_loss_fn(model), "blocked_remat": lm_loss_fn(blocked, loss_chunk=REMAT_BLOCK),
            "blocked_no_remat": _chunked_loss(plain, REMAT_BLOCK, remat=False)}
    v = torch.randn(P_124M, generator=torch.Generator(device=CARD).manual_seed(19), device=CARD)
    v /= torch.linalg.vector_norm(v)
    for shape in (REMAT_SHAPE, REMAT_FALLBACK_SHAPE):
        ids = torch.randint(0, cfg.vocab_size, shape, device=CARD,
                            generator=torch.Generator(device=CARD).manual_seed(7))
        batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids)}
        try:
            res = {name: _hvp_arm(fn, params, batch, v) for name, fn in arms.items()}
            res["whole_loss_remat"] = _hvp_arm(arms["dense"], params, batch, v, remat=True)
            break
        except torch.cuda.OutOfMemoryError:
            res = None
            _free()
            print(f"19a: an arm does not fit at bs{shape[0]} x seq{shape[1]}", flush=True)
    if res is None:
        raise SystemExit("19a: no batch fits every arm")
    B, T = shape
    dense = res["dense"]["hvp"]
    a, b = res["blocked_remat"]["hvp"], res["blocked_no_remat"]["hvp"]
    bitwise = bool(torch.equal(a, b))
    out = {"batch": list(shape), "block": REMAT_BLOCK,
           "scores_bytes_one_layer": B * cfg.n_head * T * T * 4,
           "logits_bytes": B * (T - 1) * cfg.vocab_size * 4,
           "rel_l2_vs_dense": {k: rel_l2(r["hvp"], dense) for k, r in res.items() if k != "dense"},
           "blocked_arms_bitwise_equal": bitwise,
           "blocked_arms_max_abs_diff": float((a - b).abs().max())}
    for name, r in res.items():
        out[name] = {k: r[k] for k in ("hvp_ms", "peak_bytes", "working_set_bytes")}
        print(f"19a {name} at bs{B} x seq{T}: HVP {r['hvp_ms']:.2f} ms, peak {r['peak_bytes']} "
              f"bytes ({r['working_set_bytes']} over what was allocated before)", flush=True)
    if not bitwise:
        print(f"19a: the blocked arms differ by at most {out['blocked_arms_max_abs_diff']:.3e}: "
              "the recompute's backward sums the blocks' contributions to K and V in "
              "another order", flush=True)
    del res, a, b, dense
    _free()
    print(json.dumps({"remat_124m": out}), flush=True)
    check_gates("19a rematerialisation", {
        "every arm within 1e-5 of the dense HVP": all(
            x <= REMAT_REL for x in out["rel_l2_vs_dense"].values()),
        "the remat arm's peak below the plain blocked arm's":
            out["blocked_remat"]["peak_bytes"] < out["blocked_no_remat"]["peak_bytes"],
    })
    return out


def remat_training(train_cli, kernels, phase4: list) -> dict:
    """Phase 19b: phase 4's LanczosSGD with the remat blocks and chunks."""
    records, counts = [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _adjust_calls(kernels, keep=False) as (calls, _):
        train_cli.main(REMAT_TRAIN_ARGV, on_step=lambda s, r: (records.append(r),
                                                               counts.append(dict(kernels.LAUNCHES))))
    per_step = [{n: c[n] - (counts[i - 1][n] if i else 0) for n in TPU_KERNELS}
                for i, c in enumerate(counts)]
    out = {"steps": records, "launches_per_step": per_step, "launches": dict(kernels.LAUNCHES),
           "adjust_calls": [list(c) for c in calls],
           "loss_rel_vs_phase4": _rel(records[0]["loss"], phase4[0]["loss"]),
           "eig_max_rel_vs_phase4": _rel(records[0]["eig_max"], phase4[0]["eig_max"]),
           "refresh_step_s": records[0]["seconds"], "phase4_refresh_step_s": phase4[0]["seconds"],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps({"remat_training": out}), flush=True)
    check_gates("19b LanczosSGD with the remat blocks and chunks", {
        f"{REMAT_TRAIN_STEPS} steps": len(records) == REMAT_TRAIN_STEPS,
        "step 0's loss within 1e-5 of phase 4's": out["loss_rel_vs_phase4"] <= REMAT_LOSS_RTOL,
        "step 0's lambda_max within 1e-3 of phase 4's":
            out["eig_max_rel_vs_phase4"] <= REMAT_EIG_RTOL,
        "each kernel once a step": per_step == [dict.fromkeys(TPU_KERNELS, 1)] * len(records),
        "every adjust at (10, P) bf16": [c[1:] for c in calls] == [
            ((10, P_124M), "torch.bfloat16")] * len(records),
    })
    return out


def linearized_tf32(spectrum_cli, keep: dict) -> dict:
    """Phase 19c: the auto ladder under --linearized, and the linearized HVP
    under blocks-TF32 against the eager one and the fp32 linearized one
    (one trace, replayed in fp32)."""
    from hessian_llm_vision_tpu_torch.cli.precision import resolve_auto_precision
    from hessian_llm_vision_tpu_torch.cli.workloads import build_workload
    from hessian_llm_vision_tpu_torch.curvature.hvp import _precision_context, hvp_fn
    from hessian_llm_vision_tpu_torch.curvature.linearized import linearized_hvp_programs
    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2LMHead
    from hessian_llm_vision_tpu_torch.models.losses import lm_loss_fn
    from hessian_llm_vision_tpu_torch.utils.flatten import Flattener

    args = spectrum_cli.build_parser().parse_args(LIN_AUTO_ARGV)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        wl = resolve_auto_precision(args, build_workload(args, CARD))
    ladder = text.getvalue()
    print(ladder, end="", flush=True)
    del wl
    _free()
    model, params = keep["model"], keep["params"]
    with torch.device("meta"):
        tf32 = GPT2LMHead(dataclasses.replace(model.config, block_matmul_precision="TF32_TF32_F32"))
    fl = Flattener(params)
    ids = torch.randint(0, model.config.vocab_size, LIN_TF32_SHAPE, device=CARD,
                        generator=torch.Generator(device=CARD).manual_seed(23))
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids)}
    v = torch.randn(fl.size, generator=torch.Generator(device=CARD).manual_seed(24), device=CARD)
    loss = lm_loss_fn(tf32)
    resid_p, tangent_p = linearized_hvp_programs(loss, "mean", "high", fl)
    t0 = time.perf_counter()
    consts = resid_p(params, batch)
    torch.cuda.synchronize()
    out = {"trace_and_residual_pass_s": time.perf_counter() - t0}
    hv = {"tf32": tangent_p(v, consts),
          "eager": fl.flatten(hvp_fn(loss, precision="high")(params, batch, fl.unflatten(v)))}
    sp = consts[0]
    flags = [n.args[3] for g in (sp.residual, sp.tangent) for n in g.graph.nodes
             if "flag_einsum" in str(n.target)]
    out.update(flag_einsum_nodes=len(flags), flag_einsum_tf32_args=sorted(map(str, set(flags))))
    # the fp32 linearized HVP: the same graphs replayed with every product
    # in fp32 (TF32 off; the flag nodes ask for it off too), as a trace of
    # the fp32 model would run them
    del consts
    with torch.no_grad(), _precision_context("high"):
        res = sp.residual(*(params[n] for n in sp.names), *(batch[k] for k in sp.batch_keys))
        tangents = fl.unflatten(v)
        hv["fp32"] = fl.flatten(dict(zip(sp.names, sp.tangent(
            *res, *(tangents[n] for n in sp.names)))))
    del res, tangents
    _free()
    out.update({"rel_l2_linearized_vs_eager_tf32": rel_l2(hv["tf32"], hv["eager"]),
                "rel_l2_tf32_vs_fp32_linearized": rel_l2(hv["tf32"], hv["fp32"]),
                "batch": list(LIN_TF32_SHAPE)})
    del hv
    _free()
    print(json.dumps({"linearized_tf32": out}), flush=True)
    check_gates("19c TF32 under --linearized", {
        "the auto ladder probes blocks-TF32 under --linearized":
            "probed blocks-TF32 + head high: err" in ladder and "dropped" not in ladder,
        "the linearized HVP within 1e-5 of the eager one under blocks-TF32":
            out["rel_l2_linearized_vs_eager_tf32"] <= LIN_TF32_REL,
        "and farther than that from the fp32 linearized HVP":
            out["rel_l2_tf32_vs_fp32_linearized"] > LIN_TF32_REL,
        "the head's products traced as flag_einsum nodes with the flag off":
            out["flag_einsum_nodes"] > 0 and out["flag_einsum_tf32_args"] == ["False"],
    })
    return out


def dropout_124m(keep: dict) -> dict:
    """Phase 19d: dropout 0.1 on phase 6's model and one c_proj output."""
    from torch.func import functional_call

    from hessian_llm_vision_tpu_torch.models.gpt2 import GPT2LMHead

    model, params = keep["model"], keep["params"]
    with torch.device("meta"):
        drop = GPT2LMHead(dataclasses.replace(model.config, dropout=DROPOUT))
    gen = torch.Generator(device=CARD).manual_seed(29)
    ids = torch.randint(0, model.config.vocab_size, DROPOUT_SHAPE, generator=gen, device=CARD)

    def run(m, **kw):
        return functional_call(m, params, (ids,), kw)

    attn = {k[len("h_0.attn."):]: t for k, t in params.items() if k.startswith("h_0.attn.")}
    x = torch.randn(*DROPOUT_SHAPE, model.config.n_embd, generator=gen, device=CARD)
    with torch.no_grad():
        plain, det = run(model), run(drop, deterministic=True)
        a, b, c = (run(drop, deterministic=False,
                       generator=torch.Generator(device=CARD).manual_seed(s)) for s in (31, 31, 32))
        y_det = functional_call(drop.h_0.attn, attn, (x,))
        y = functional_call(drop.h_0.attn, attn, (x,), {
            "deterministic": False, "generator": torch.Generator(device=CARD).manual_seed(33)})
    kept = y != 0
    out = {"deterministic_equals_dropout_0": bool(torch.equal(det, plain)),
           "stochastic_differs": not torch.equal(a, plain),
           "same_seed_repeats": bool(torch.equal(a, b)),
           "other_seed_differs": not torch.equal(a, c),
           "c_proj_kept_fraction": float(kept.float().mean()),
           "kept_scaled_by_1_over_keep": bool(torch.equal(y[kept], (y_det / (1 - DROPOUT))[kept]))}
    del plain, det, a, b, c, y, y_det
    _free()
    print(json.dumps({"dropout_124m": out}), flush=True)
    check_gates("19d dropout", {
        "deterministic=True equals dropout 0 bit for bit": out["deterministic_equals_dropout_0"],
        "deterministic=False differs, repeats from a seed, differs across seeds":
            out["stochastic_differs"] and out["same_seed_repeats"] and out["other_seed_differs"],
        "a c_proj output keeps 0.9 +- 0.01": abs(out["c_proj_kept_fraction"] - (1 - DROPOUT))
        <= DROPOUT_KEPT_TOL,
        "the kept entries scaled by 1/0.9": out["kept_scaled_by_1_over_keep"],
    })
    return out


def remat_and_rest(train_cli, spectrum_cli, kernels, keep: dict, phase4: list) -> dict:
    """Phase 19a-19d, each with its seconds."""
    res = {}
    for key, fn in (("19a", lambda: remat_124m(keep)),
                    ("19b", lambda: remat_training(train_cli, kernels, phase4)),
                    ("19c", lambda: linearized_tf32(spectrum_cli, keep)),
                    ("19d", lambda: dropout_124m(keep))):
        t0 = time.perf_counter()
        res[key] = fn()
        res[key]["s"] = time.perf_counter() - t0
        print(f"phase {key} took {res[key]['s']:.1f} s", flush=True)
    return res


def main() -> int:
    t_start = phase(1, "device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from hessian_llm_vision_tpu_torch.cli import spectrum as spectrum_cli
    from hessian_llm_vision_tpu_torch.cli import train as train_cli
    from hessian_llm_vision_tpu_torch.io import spectra
    from hessian_llm_vision_tpu_torch.ops import kernels, spectral

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  python {sys.version.split()[0]}")

    t0 = phase(2, "build kernels")
    for res in kernels.build().values():
        print(f"built {res.path.name} in {res.seconds:.2f} s")
        for name, use in kernels.ptxas_usage(res.log).items():
            print(f"  {name}: {use['registers']} registers, {use['spill_bytes']} bytes spilled")
    for dtype in TIMED_DTYPES:  # pass 1's and pass 2's plans at the timed shapes
        for k, p in [(10, P_124M), (35, P_124M)] + list(LEAF_TIMED + VISION_SHAPES):
            for name, plan in (("rank_k_dots_plan", kernels.dots_launch_plan(k, p, dtype, CARD)),
                               ("rank_k_axpy_plan", kernels.axpy_launch_plan(k, p, dtype, CARD))):
                print(json.dumps({name: {"dtype": str(dtype).removeprefix("torch."), "k": k,
                                         "P": p, **dataclasses.asdict(plan)}}))
    tp_shape = (torch.float32, MA_ITERS, tp_block_columns())
    for dt, k, p in (PYTHIA_SHAPE, FORGET_SHAPE, DP_SHAPE, tp_shape):
        for name, plan in (("rank_k_dots_plan", kernels.dots_launch_plan(k, p, dt, CARD)),
                           ("rank_k_axpy_plan", kernels.axpy_launch_plan(k, p, dt, CARD))):
            print(json.dumps({name: {"dtype": str(dt).removeprefix("torch."), "k": k, "P": p,
                                     **dataclasses.asdict(plan)}}))
    print(f"phase 2 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(3, "rank-k kernels vs plain versions")
    gen = torch.Generator(device=CARD).manual_seed(PHASE3_SEED)
    checks = {}
    for dtype, k, p, offset, timed in phase3_shapes():
        checks[(dtype, k, p) + ((offset,) if offset else ())] = check_rank_k(
            kernels, spectral, dtype, k, p, gen, timed=timed, g_offset=offset)
        torch.cuda.empty_cache()
    # phase 14's (10, P), rows not 16-byte aligned; then 13b's shape, the
    # first with k * P >= 2**31 at full width (V alone 11.3 GB), on two
    # draws: the generator after phase 14's shapes and, untimed, before them
    before_vision = gen.get_state()
    for dtype in TIMED_DTYPES:
        for k, p in VISION_SHAPES:
            checks[(dtype, k, p)] = check_rank_k(kernels, spectral, dtype, k, p, gen, timed=True)
    checks[PYTHIA_SHAPE] = check_rank_k(kernels, spectral, *PYTHIA_SHAPE, gen, timed=True)
    torch.cuda.empty_cache()
    gen.set_state(before_vision)
    checks[PYTHIA_SHAPE + ("second draw",)] = check_rank_k(kernels, spectral, *PYTHIA_SHAPE, gen,
                                                           timed=False)
    torch.cuda.empty_cache()
    # 15b's projected steps' shape, on a generator of its own (the draws
    # above are unchanged)
    checks[FORGET_SHAPE] = check_rank_k(kernels, spectral, *FORGET_SHAPE,
                                        torch.Generator(device=CARD).manual_seed(PHASE3_SEED),
                                        timed=True)
    # 16b's per-rank block of the P-sharded basis, on a generator of its own
    checks[DP_SHAPE] = check_rank_k(kernels, spectral, *DP_SHAPE,
                                    torch.Generator(device=CARD).manual_seed(PHASE3_SEED),
                                    timed=True)
    # 17a's per-rank block of the basis on the model axis, on a generator of its own
    checks[tp_shape] = check_rank_k(kernels, spectral, *tp_shape,
                                    torch.Generator(device=CARD).manual_seed(PHASE3_SEED),
                                    timed=True)
    torch.cuda.empty_cache()
    failed = [key for key, r in checks.items() if not r["ok"]]
    if failed:
        raise SystemExit(f"rank-k kernel disagrees with its plain version at {failed}")
    sweep = dots_alignment_sweep(kernels, spectral)
    print(json.dumps({"dots_alignment_sweep": sweep}))
    check_gates("3 pass 1's alignment sweep", {
        f"within {SWEEP_DOTS_LIMIT} of the plain version, or of its terms from float64":
            sweep["within_limit_or_of_its_terms"],
        "bit for bit on repeat and as on fresh copies of V and g":
            sweep["bitwise_repeatable_and_as_fresh_copies"],
        "the kernel at every point, three times": sweep["launches"] == 3 * sweep["points"],
        "no CUDA call reached the plain version": sweep["plain_version_calls"] == 0,
        "the aligned ring exactly where V, g and P are whole vectors":
            sweep["aligned_points"] == sweep["expected_aligned_points"],
    })
    sweep_plan = checks[ROW_SWEEP]["axpy_plan"]
    if not (sweep_plan["ring"] and sweep_plan["rows"] < ROW_SWEEP[1]):
        raise SystemExit(f"the many-row check did not reach pass 2's row sweeps: {sweep_plan}")
    timed = [(dtype, k) for dtype in TIMED_DTYPES for k in TIMED_KS] + list(PATH_TIMED)
    for dtype, k in timed:  # pass 1 and the pair, per timed shape
        d, a = (checks[(dtype, k, P_124M)][n] for n in TPU_KERNELS)
        print(f"{str(dtype).removeprefix('torch.'):8s} k={k:2d}: rank_k_dots "
              f"{d['ms']:.3f} ms [{d['ms_spread'][0]:.3f}-{d['ms_spread'][1]:.3f}] "
              f"library {d['library_ms']:.3f} bound {d['bound_ms']:.3f}; rank_k_axpy "
              f"{a['ms']:.3f} ms; pair {d['ms'] + a['ms']:.3f} ms")
    # per call, µs: wall (events, in turns), host (perf_counter), device (trace)
    for key in ([(dt, k, P_124M) for dt, k in timed] + [(dt, k, p) for dt in TIMED_DTYPES
                                                       for k, p in LEAF_TIMED + VISION_SHAPES]
                + [PYTHIA_SHAPE, FORGET_SHAPE, DP_SHAPE, tp_shape]):
        for name in TPU_KERNELS:
            t = checks[key][name]
            print(f"{str(key[0]).removeprefix('torch.'):8s} k={key[1]:2d} P={key[2]:>9d} {name}: "
                  f"wall {1e3 * t['ms']:.1f} host {t['host_us']:.1f} device {t['device_us']:.1f}"
                  f" | library wall {1e3 * t['library_ms']:.1f} host {t['library_host_us']:.1f}"
                  f" device {t['library_device_us']:.1f} | bound {1e3 * t['bound_ms']:.1f}")
    print(json.dumps({"streaming_rate_tb_s": streaming_rates(checks)}))
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(4, "main path: LanczosSGD on GPT-2 124M through cli.train.main")
    records = []
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    train_cli.main(TRAIN_ARGV, on_step=lambda step, rec: records.append(rec))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"train_steps": records, "launches": launches,
                      "max_memory_allocated_bytes": peak}))
    if len(records) != 4:
        raise SystemExit(f"expected 4 steps, got {len(records)}")
    if not all(math.isfinite(v) for r in records for v in r.values()):
        raise SystemExit("non-finite loss or eigenvalue in the main path")
    if abs(records[0]["loss"] - math.log(50257)) > 0.25:
        raise SystemExit(f"step-0 loss {records[0]['loss']} far from ln(50257) at init")
    for name in TPU_KERNELS:
        if launches[name] != 4:
            raise SystemExit(f"{name} launched {launches[name]} times in 4 steps, expected 4")
    print(f"phase 4 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(5, "gpt2-tiny trainer: card vs CPU")
    tiny = ["--model", "gpt2-tiny", "--optimiser", "lanczos-host", "--batch_size", "4",
            "--max_length", "32", "--k", "4", "--delta", "1e-2", "--refresh_every", "2",
            "--lanczos_momentum", "0.5", "--max_steps", "3", "--no-basis_bf16"]
    on_card, on_cpu = [], []
    train_cli.main(tiny, on_step=lambda s, r: on_card.append(r))
    train_cli.main(tiny + ["--cpu"], on_step=lambda s, r: on_cpu.append(r))
    for a, b in zip(on_card, on_cpu, strict=True):
        if not (math.isclose(a["loss"], b["loss"], rel_tol=1e-5)
                and math.isclose(a["eig_max"], b["eig_max"], rel_tol=1e-3)):
            raise SystemExit(f"card and CPU trainers disagree: {a} vs {b}")
    print(f"phase 5 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(6, "where a 124M training step's time goes")
    keep = {}
    breakdown = step_breakdown(keep)
    print(json.dumps({"step_breakdown": breakdown}))
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(19, "(on phase 6's model) rematerialisation at GPT-2 124M: dense, remat and "
                   "plain blocked HVPs, whole-loss remat, LanczosSGD with the blocks and "
                   "chunks; TF32 under --linearized; dropout")
    p19 = remat_and_rest(train_cli, spectrum_cli, kernels, keep, records)
    del keep
    _free()
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s")

    t0 = phase(7, "spectrum: gpt2-tiny card vs CPU, the GPT-2 124M headline job, "
                  "its HVP against a float64 central difference")
    print(json.dumps({"spectrum_card_vs_cpu": spectrum_card_vs_cpu(spectrum_cli)}))
    print(f"phase 7a took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    headline = headline_spectrum(spectrum_cli, spectra, kernels, breakdown["hvp_ms"])
    print(f"phase 7b took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    hvp_vs_central_difference(spectrum_cli, headline["alpha_1"])
    print(f"phase 7c took {time.perf_counter() - t0:.1f} s")

    t0 = phase(8, "spectrum estimators beyond SLQ at GPT-2 124M: thick restart, "
                  "deflated KPM, Hutch++; gpt2-tiny card vs CPU")
    ext = {"8a_thick_restart": thick_restart_124m(spectrum_cli, kernels)}
    print(f"phase 8a took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ext["8b_deflated_kpm"] = deflated_kpm_124m(spectrum_cli, kernels)
    print(f"phase 8b took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ext["8c_hutchpp"] = hutchpp_124m(spectrum_cli, kernels)
    print(f"phase 8c took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    estimators_card_vs_cpu(spectrum_cli)
    print(f"phase 8d took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"spectrum_ext": {
        name: {key: r[key] for key in r if key.endswith(("_s", "matvecs", "hvps", "restarts",
                                                         "per_s", "_bytes", "launches"))}
        for name, r in ext.items()}}))

    t0 = phase(9, "layerwise, GGN, linearized, bigmodel, linearized training and the "
                  "empirical Fisher at GPT-2 124M; gpt2-tiny card vs CPU")
    cur = {"9a_layerwise": layerwise_124m(spectrum_cli, spectra, kernels)}
    print(f"phase 9a took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cur["9b_ggn"] = ggn_124m(spectrum_cli, kernels, breakdown["hvp_ms"])
    print(f"phase 9b took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cur["9cd"] = linearized_and_bigmodel_124m(spectrum_cli, kernels, breakdown["hvp_ms"])
    print(f"phase 9c/9d took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cur["9e_train"] = linearized_training(train_cli, kernels, records)
    print(f"phase 9e took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cur["9f_ef"] = empirical_fisher_124m(spectrum_cli, kernels, spectral)
    print(f"phase 9f took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    new_paths_card_vs_cpu(spectrum_cli, train_cli)
    print(f"phase 9g took {time.perf_counter() - t0:.1f} s")
    lin, cd = cur["9cd"]["linearized"], cur["9cd"]
    print(json.dumps({"curvature_ext": {
        "9a_layerwise": {k: cur["9a_layerwise"][k] for k in (
            "masked_hvps", "sweep_s", "hvps_per_s", "main_s", "max_memory_allocated_bytes")},
        "9b_ggn": {k: cur["9b_ggn"][k] for k in (
            "matvecs", "ggn_matvec_ms", "ggn_over_phase6_hvp", "cli_wall_s", "hvps_per_s",
            "max_memory_allocated_bytes")},
        "9c_linearized": {k: lin[k] for k in (
            "batch_size", "residual_bytes", "residual_pass_s", "tangent_ms_median",
            "tangent_over_phase6_hvp", "cli_wall_s", "hvps_per_s", "max_memory_allocated_bytes")},
        "9c_plain": {k: cd["plain"][k] for k in ("iter_s_median", "cli_wall_s",
                                                 "max_memory_allocated_bytes")},
        **{f"9d_bigmodel_{q}": {k: cd[f"bigmodel_{q}"][k] for k in (
            "iter_s_median", "cli_wall_s", "hvps_per_s", "max_memory_allocated_bytes")}
           for q in BIG_RTOL},
        "9e_train": {k: cur["9e_train"][k] for k in ("refresh_step_s", "phase4_refresh_step_s",
                                                     "frozen_step_s",
                                                     "max_memory_allocated_bytes")},
        "9f_ef": {k: cur["9f_ef"][k] for k in ("grads_s", "max_memory_allocated_bytes")},
    }}))
    t0 = phase(10, "the trained-checkpoint path on GPT-2 124M: Adam save and resume, the "
                   "checkpoint's spectrum, LanczosSGD from it; gpt2-tiny Adam card vs CPU")
    t11 = []

    def phase11(ckpt, tmp):
        t11.append(phase(11, "the precision ladder at init and on the 600-step checkpoint: "
                             "tiers, auto plans, --precision_check, float64 arms, the "
                             "refresh guard; gpt2-tiny card vs CPU"))
        return precision_ladder(train_cli, spectrum_cli, kernels, ckpt, tmp)

    trained = trained_checkpoint(train_cli, spectrum_cli, kernels, after=phase11)
    prec = trained["after"]
    print(f"phase 10 took {t11[0] - t0:.1f} s")
    print(f"phase 11 took {time.perf_counter() - t11[0]:.1f} s")
    a, b = trained["10a"], trained["10b"]
    print(json.dumps({"trained_checkpoint": {
        "corpus": trained["corpus"],
        "10a_adam": {k: a[k] for k in ("N", "loss_step0", "last10_mean", "resume_max_abs_loss_diff",
                                       "step_s_median", "saved_steps", "state_bytes",
                                       "max_memory_allocated_bytes")}
        | {k: a["pieces"][k] for k in ("grad_ms", "update_ms", "update_bound_ms")},
        "10b_spectrum": {"lambda_max": b["checkpoint"]["lambda_max"],
                         "lambda_min": b["checkpoint"]["lambda_min"],
                         "init_lambda_max": b["init"]["lambda_max"],
                         "lambda_max_ratio": b["lambda_max_ratio"],
                         "rel_l2_hvp_vs_fd": b["hvp_vs_central_difference"]["rel_l2_hvp_vs_fd"]},
        "10c_lanczos_sgd": {"step0_rel_vs_direct": trained["10c"]["step0_rel_vs_direct"],
                            "losses": [r["loss"] for r in trained["10c"]["steps"]]},
        "10d_tiny": trained["10d"],
    }}))
    print(json.dumps({"precision": precision_summary(prec)}))

    t0 = phase(12, "the rest of training on GPT-2 124M: fused LanczosSGD, GN and NGD, "
                   "layer-wise LanczosSGD, snapshots, projections, an HVP's trace; "
                   "gpt2-tiny card vs CPU")
    rest = rest_of_training(train_cli, kernels, spectral, spectra, records)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"train_ext": train_ext_summary(rest)}))

    t0 = phase(13, "the other language-model families: Pythia-1.4B at full width (spectrum, "
                   "LanczosSGD), LLaMA-134m, gpt2-moe; the tiny configs card vs CPU")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"allocated at the start of phase 13: {torch.cuda.memory_allocated()} bytes")
    fam = lm_families(spectrum_cli, train_cli, spectra, kernels, spectral)
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"lm_families": lm_families_summary(fam)}))

    t0 = phase(14, "the vision models at full width on random images: VGG-16 and ResNet-50 "
                   "spectra, f32 HVPs against a float64 central difference, LanczosSGD with "
                   "the rank-k pair at unaligned rows; the small configs card vs CPU")
    vis = vision(spectrum_cli, train_cli, spectra, kernels, spectral)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"vision": vision_summary(vis)}))

    t0 = phase(15, "the remaining CLIs: forget on the spiral (card vs CPU), on VGG-16 at full "
                   "convolutional width and on SimpleNet; evaluate; sweep and hpo; the python -m "
                   "dispatch")
    rc = remaining_clis(kernels, spectral, train_cli)
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"remaining_clis": remaining_clis_summary(rc)}))

    t0 = phase(16, "the data axis: one NCCL rank on GPT-2 124M (DP grad, HVP, host loop); two "
                   "gloo ranks sharing the card (DP HVP, the P-sharded Lanczos with the rank-k "
                   "pair on each half of P, --probe_parallel)")
    dp1 = data_axis_one_rank(spectrum_cli, kernels)
    print(f"phase 16a took {time.perf_counter() - t0:.1f} s")
    phase(17, "the model axis on the same two gloo ranks (one spawn for 16b, 17 and 18): GPT-2 "
              "124M tensor-parallel (loss, grad, HVP, the Lanczos with its basis on the model "
              "axis), sequence-parallel at seq1024 and both on one axis (17e), Pythia-1.4B "
              "tensor-parallel against 13b's step 0, gpt2-moe expert-parallel (dense and top-2); "
              "phase 18, GPT-2 124M pipelined over two stages (loss, grad, HVP, the Lanczos with "
              "its basis on the pipeline axis)")
    t1 = time.perf_counter()
    dp2, ma = axes_two_ranks(fam["13ab"].pop("17c_reference"),
                             fam["13ab"]["13b_lanczos_sgd"]["max_length"])
    print(f"phase 16b took {max(dp2['s']):.1f} s in the ranks")
    print(f"phase 17 took {ma['s']:.1f} s in the ranks (17e {ma['17e_tp_sp']['s']:.1f} s, "
          f"phase 18 {ma['18_pipeline']['s']:.1f} s of it)")
    print(f"phases 16b, 17 and 18 took {time.perf_counter() - t1:.1f} s (one spawn)")
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s (16a, 16b, 17 and 18)")
    lw = rest["12cdf"]
    by_path = {"phase4_train_4_steps": launches,
               "phase19b_remat_train_2_steps": p19["19b"]["launches"],
               "phase7b_spectrum": headline["rank_k_launches"],
               "phase8a_thick_restart": ext["8a_thick_restart"]["rank_k_launches"],
               "phase8b_host_loop_and_deflated_kpm": ext["8b_deflated_kpm"]["rank_k_launches"],
               "phase8b_kpm_stage": ext["8b_deflated_kpm"]["kpm_stage_launches"],
               "phase8c_hutchpp": ext["8c_hutchpp"]["rank_k_launches"],
               "phase9a_layerwise": cur["9a_layerwise"]["rank_k_launches"],
               "phase9b_ggn_host_loop": cur["9b_ggn"]["rank_k_launches"],
               "phase9c_linearized": lin["rank_k_launches"],
               **{f"phase9d_bigmodel_{q}": cd[f"bigmodel_{q}"]["rank_k_launches"]
                  for q in BIG_RTOL},
               "phase9e_train_linearized": cur["9e_train"]["launches"],
               "phase9f_empirical_fisher_matvec": cur["9f_ef"]["launches"],
               "phase10c_lanczos_sgd_from_checkpoint": trained["10c"]["launches"],
               "phase11a_probe_cgs2": prec["11a"]["launches"],
               "phase11b_auto_plan_probes": prec["11b"]["checkpoint"]["launches"],
               "phase11e_guarded_train": prec["11e"]["launches"],
               "phase12a_fused_lanczos_2_steps": rest["12a"]["launches"],
               "phase12b_gn_1_step": rest["12b"]["gn"]["launches"],
               "phase12b_ngd_1_step": rest["12b"]["ngd"]["launches"],
               "phase12c_host_layerwise_step0": lw["12c"]["steps"][0]["launches"],
               "phase12c_host_layerwise_step1": lw["12c"]["steps"][1]["launches"],
               "phase12d_fused_layerwise_wte": lw["12d"]["launches"],
               "phase12e_snapshots": rest["12e"]["launches"],
               **{f"phase12f_frozen_transforms_{d}": r["launches"]
                  for d, r in lw["12f"].items()},
               **{f"phase13b_pythia_1p4b_step{i}": c for i, c in enumerate(
                   fam["13ab"]["13b_lanczos_sgd"]["launches_per_step"])},
               "phase13c_llama_134m_2_steps": _summed(fam["13c"]["lanczos_sgd"]["launches_per_step"]),
               "phase13e_lora_llama_tiny_2_steps": _summed(
                   fam["13e"]["lora_llama_tiny"]["launches_per_step"]),
               **{f"phase14d_{n}_4_steps": _summed(r["launches_per_step"])
                  for n, r in vis["14d"].items()},
               **{f"phase14e_{n}_train": r["launches"] for n, r in vis["14e"].items()},
               **{f"phase15{key}_{phase_name}": r["launches"][phase_name]
                  for key, r in (("a_spiral", rc["15a"]["card"]), ("b_vgg16", rc["15b"]),
                                 ("c_simplenet_permuted", rc["15c"]["permuted"]),
                                 ("c_simplenet_noisy", rc["15c"]["noisy"]))
                  for phase_name in ("baseline", "projected")},
               "phase15b_thick_restart_basis": rc["15b"]["basis_launches"],
               "phase15d_evaluate": rc["15d"]["launches"],
               **{f"phase15e_point{i}": c["launches"] for i, c in enumerate(rc["15e"]["per_point"])},
               "phase16a_one_rank_host_loop": dp1["launches"],
               **{f"phase16b_sharded_lanczos_rank{i}": c for i, c in enumerate(dp2["launches"])},
               **{f"phase17a_model_axis_lanczos_rank{i}": c
                  for i, c in enumerate(ma["17a_tp"]["launches"])},
               **{f"phase18_pipeline_lanczos_rank{i}": c
                  for i, c in enumerate(ma["18_pipeline"]["launches"])}}
    # the T-only spectra (7b, 8c's in-core CGS2 and Hutch++, 9a-9d), GN/NGD
    # and Adam with snapshots take no rank-k apply; every other path must
    # have launched both kernels
    t_only = ("phase7b", "phase8c", "phase9a", "phase9b", "phase9c", "phase9d", "phase12b",
              "phase12e", "phase15d", "phase16a")  # and phase 13's spectra, gated to launch none
    # the forget baselines, gated in phase 15 to launch none
    t_only += tuple(p for p in by_path if p.startswith("phase15") and p.endswith("_baseline"))
    for path, counts in by_path.items():
        if not path.startswith(t_only) and not all(counts[n] > 0 for n in TPU_KERNELS):
            raise SystemExit(f"a rank-k kernel was never launched on {path}: {counts}")

    entries = []
    for name, replaces in TPU_KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": KERNEL_SRC, "replaces": replaces,
                 "launches": launches[name]}
        entry.update(without_smi(checks[(torch.bfloat16, 10, P_124M)][name]))
        entry.update({"dtype": "bfloat16", "shape": [10, P_124M],
                      "f32": without_smi(checks[(torch.float32, 10, P_124M)][name]),
                      **{f"{str(dt).removeprefix('torch.')}_k{k}":
                         without_smi(checks[(dt, k, P_124M)][name]) for dt, k in PATH_TIMED},
                      **{f"{str(dt).removeprefix('torch.')}_k{k}_P{p}":
                         without_smi(checks[(dt, k, p)][name])
                         for dt in TIMED_DTYPES
                         for k, p in LEAF_TIMED + VISION_SHAPES + (PYTHIA_SHAPE[1:],
                                                                   FORGET_SHAPE[1:],
                                                                   DP_SHAPE[1:], tp_shape[1:])
                         if (dt, k, p) in checks},
                      "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
                      "checks_passed": len(checks)})
        entries.append(entry)
    print(json.dumps({"kernels": entries}))
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
