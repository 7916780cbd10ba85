#!/usr/bin/env python3
"""GPU smoke check of the PyTorch port: the serving path of ATST-Frame
base (bf16 and int8), the linear probe, full finetuning and clip-to-frame
distillation at ATST-Clip and ATST-Frame base width, sound event
detection (DCASE, AudioSet-strong, distill) at ATST-Frame base, the
pretraining steps of ATST-Frame base (bf16, f32 and the int8 recipes),
ATST-Clip small (f32, bf16 and the int8 recipes), MAE and dual small (f32
and bf16), the pretraining CLIs with their run loop, checkpoints and
crash-restart, data-parallel pretraining on 2 ranks (replicated and
ZeRO-1; the dual step too), and the eight
comparison encoders (BEATs, BYOL-A, AudioMAE, M2D, SSAST and MAE-AST, frame
and patch) at full width with MAE-AST's attention on K6.

Run from the repository root on a machine with one CUDA GPU (Hopper,
sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py [--profile DIR]

1. prints the card's name and power limit, builds the hand-written CUDA
   kernels from ``audiossl_tpu_torch/csrc`` and prints the build time and
   the registers and spills of K7's kernel and each K8 instantiation;
   then the GEMM phase: the bf16 GEMM template of K2-K5 and the int8 one
   of K2q-K5q alone (``ops/gemm.py``), each instantiation's registers,
   spills and ``wgmma`` count from the build (HGMMA for bf16, IGMMA for
   int8, and no HMMA or IMMA); the bf16 template in each operand layout and
   epilogue against float64 products of the same bf16 operands at the
   ATST-Frame base step's products, the ATST-Clip small step's fc1,
   serving's qkv and a small ragged shape, each main shape timed beside
   ``torch.matmul`` in bf16 (cuBLAS); the GELU epilogues' reciprocal
   against the IEEE division over its domain; the int8 template against
   its plain version on the same codes and scales, bit for bit in f32
   (bias epilogue within 4e-3), at K5q's fc1, fc2, da and dh and K4q's
   qkv, proj, do and dh (48,000 rows; the int8dx products against the
   codes of the transposed weight), the clip fc1 (28,992 rows), serving's
   qkv with the bias epilogue (2,000 rows) and a 97-row case of each
   epilogue, each main shape timed beside ``torch._int_mm`` of the same
   codes in TOP/s and as a share of the int8 peak;
2. holds each kernel against its plain PyTorch version on the card, with
   its error and both times from CUDA events: K1 at the main paths' STFT
   shapes (serving's 8 and the frame step's 96 clips of 10 s, clip
   inference's 8 and the clip step's 96 crops of 6 s: [8 or 96, 1026, 1001
   or 601]; the probes', clip finetuning's and ``distill_other``'s 64 crops
   of 12 s: [64, 1026, 1201]; ``distill_as``'s 64 clips of 10 s: [64, 1026,
   1001]; the clip
   CLI's 96 crops of 9 s: [96, 1026, 901]; the DCASE step's 256 and the
   SED evaluations' and AudioSet-strong step's 32 clips of 10 s: [256 or
   32, 1026, 1001]), also in
   device time from the profiler and in the host's time
   to issue a call, its second and third calls under
   ``set_sync_debug_mode("error")``, and untimed with a dense random
   filterbank (one mel all zero) and at 97 frames; K2 and K3 at the
   serving shapes (8 clips of 10 s, 250 tokens, width 768), K2 and K3 at
   the bf16 frame step's teacher shape (192
   sequences of 250 tokens, width 768); the training mel (TF32 STFT)
   against the f32 one; K4 and K5, forward and every gradient, at the
   ATST-Frame base step's shapes (192 sequences of 250 tokens, width 768);
   K2-K5 at the ATST-Clip small step's (192 sequences of 151 tokens,
   width 384, 6 heads; errors only) and at the clip CLI's (226 tokens, 9 s
   crops); K6, forward and backward, in
   f32 at the ATST-Clip small step's shape (192 sequences of 151 tokens,
   width 384, 6 heads) and at the ATST-Frame base one ([192, 250, 768],
   12 heads), and in bf16 at [192, 250, 768], each beside
   ``scaled_dot_product_attention`` with the key mask (its library call),
   and untimed in both dtypes at [16, 97, 256] with 8 heads of 32, with a
   sequence that has no valid key; K6 in f32 at MAE-AST's shapes (32 clips
   of 10 s at full width, 12 heads of 64, every key valid): [32, 499,
   3 * 768] (frame variant, timed beside its bound and SDPA) and [32, 496,
   3 * 768] (patch variant), on the qkv MAE-AST's layers compute from a
   seeded authors'-layout checkpoint, each layer's largest score held
   below the f32 ``exp`` overflow (K6 subtracts no row maximum), output,
   r, dq, dk and dv each within 1e-4; K8 in f32 and bf16 at [192 * 151, 384] and
   [192 * 250, 768], in device time too beside aten's LayerNorm backward,
   and untimed in bf16 at [192 * 226, 384] and at 97 rows of widths 100,
   200, 1000 and 1023; K7 over the
   full parameter set of the ATST-Frame base student branch through a
   kept leaf table, bit for bit against its plain version, its second and
   third calls under ``set_sync_debug_mode("error")``, in CUDA-event,
   device and host time, and untimed over leaves of odd lengths; the int8
   kernels K2q and K3q at [8, 250, 768], [192, 250, 768] and
   [192, 151, 384], K4q and K5q (int8 forward, int8dx
   backward) at [192, 250, 768], [192, 151, 384] and [192, 226, 384],
   each also against its
   float kernel, which a kernel that skipped quantizing would sit next
   to; K2 and K2q at head dim 128 ([8, 97, 512], 4 heads; errors only).
   Every kernel's bound (bytes or operations over the card's peak rates)
   and, where one PyTorch call computes the same function, that call's
   time; for K2-K5 the cuBLAS time of their bf16 products alone, for the
   int8 kernels ``torch._int_mm``'s of their int8 products alone;
3. serving: writes a seeded random ATST-Frame base encoder as a
   reference-layout ``.ckpt``, loads it with ``load_model(fused=True)``
   and ``load_model(fused=False)``, and drives ``get_scene_embedding`` (8 x
   10 s, and 1 x 160,320 samples: two chunks, the second with no valid
   token) and ``get_timestamp_embedding`` through the kernels, checking
   shapes, finiteness, launch counts and agreement with the plain f32
   path on the card, and the plain f32 path on the card against the CPU;
   ``utils.plot.plot_attention`` without a path on the card (shape and
   finiteness); times scene embedding (clips/s, B=8) on both paths; then the same
   with ``load_model(fused=True, quant="int8")`` (K1, K2q, K3q) against
   ``load_model(fused=True)``; then the clip encoder's inference path at
   ATST-Clip small width (``get_intermediate_layers`` of 8 ragged 6 s
   crops, the CLS token first, through K1-K3 in bf16) against its f32
   module path; then the linear probe, ``python -m
   audiossl_tpu_torch.downstream.train_freeze``'s ``main``, once with a
   seeded random ATST-Clip base and once with an ATST-Frame base encoder
   written as reference ``.ckpt`` files, on one seeded ``audioset_b`` pack
   (527 labels; 256 train, 64 valid and 64 test tone clips of 1-12 s,
   some longer than one 6 s chunk), 12 s crops, 64 clips a batch, 20
   epochs: K1 once per extraction batch and no block kernel (f32 encoders,
   the module route), the first 8 test clips' embeddings against the same
   extractor on the CPU, the clip checkpoint's Linear and Conv2d
   patch-embed layouts bit-equal on the card, ``result.json`` (mAP, finite
   in [0, 1]) and at most 10 kept heads, the probe's ACC branch on the
   frame embeddings, ``datamodules.EmbeddingExtractor`` over
   ``DownstreamDataModule``'s test loader (shape, labels, K1 a batch);
   extraction clips/s by split (without the run's first
   batch) and the probe's seconds; then full finetuning,
   ``train_finetune.main``, on the same pack at ATST-Clip base (12 s crops,
   chunks of 601 frames) and ATST-Frame base (10 s crops, SpecAugment,
   RandomResizeCrop, frozen embeddings, mixup_ratio 0.5), batches of 64
   drawn by class-balanced weights, 2 epochs with 1 of warm-up, mixup,
   layer decay 0.75, SGD: K1 once per train and eval batch and no other
   kernel, ``result.json`` and the kept states; train clips/s by step
   (the first left out), eval clips/s, peak memory, the test mAP; one step
   at B = 4 on the card against the CPU from the same state and draws
   (loss, every leaf's clipped gradient, the updated parameters, the
   frozen embeddings); and for the clip encoder one step's device time by
   kernel at B = 64; then sound event detection at ATST-Frame base on
   seeded trees of 10 s tone clips (one tone a class, one to three events
   a clip): ``train_dcase.main`` (256 synthetic strong, 284 weak, 64
   synthetic validation and 64 test clips; batches of 128 + 128, 2 epochs
   with 1 of warm-up, learning rate 0.1), ``train_as_strong.main`` (407
   labels; 128 / 32 / 32 clips, batches of 32, learning rate 1e-3,
   ``lr_scale`` 0.75, patience 10, 2 epochs) and one epoch of
   ``train_dcase.main --distill_ckpt`` from the first run's kept states:
   K1 once per train and eval batch (twice a train batch with the
   teacher) and no other kernel, ``result.json`` (PSDS scenarios 1 and 2,
   event F1: finite in [0, 1]) and the keeper's index in mode "max" or
   "min"; train clips/s by step (the first left out), eval clips/s, the
   test's decoding and scoring seconds, peak memory; ``decode_preds`` and
   ``intersection_stats`` on the card against the CPU on the run's own
   test scores (bit-equal, equal counts), and one DCASE step (4 + 4 clips)
   and one AudioSet-strong step (8 clips, ``lr_scale`` 0.75) on the card
   against the CPU from the same weights and drop-path draws (loss,
   every leaf's gradient, the updated parameters); then data-parallel
   downstream on this one card, 2 ranks spawned by ``parallel.launch.
   spawn`` on gloo over CUDA tensors: ``ddp_finetune`` (after the
   finetuning paths) and ``ddp_sed`` (after the SED paths) each take 2
   steps at a global batch of 16, 8 a rank (the clip base finetuning step
   with mixup, SpecAugment and RandomResizeCrop on; the DCASE step at
   ATST-Frame base on 8 strong then 8 weak rows, so the ranks hold
   different sources), each from the 1-rank run's state before it and
   held to the 1-rank step on the same global batch and draws (loss and
   gradient norm rel 1e-4, every leaf's gradient cosine 0.999, a
   vanishing leaf within 1e-4 of the largest), both ranks' states
   bit-equal after each step, each rank's K1 launches equal to the
   1-rank step's; then ``train_finetune`` (one epoch of batches of 16 on
   a pack whose 33-clip validation and test splits end on a ragged batch)
   and ``train_dcase`` (one epoch of 8 + 8) at ``--n_devices 2`` on the
   ranks: rank 0 alone writes ``result.json`` and the keeper, finite
   metrics, K1 once a train and evaluation batch on each rank. With 2
   cards or more the two drivers also run over NCCL at ``--n_devices``
   the count; on one card a line says they did not run; then clip-to-frame
   distillation at base width, after ``ddp_finetune`` on the probe pack: a
   seeded random ATST-Clip base classifier (its encoder and a LinearHead
   with non-trivial running statistics) as a reference-layout teacher
   ``.ckpt`` and the finetuning paths' ATST-Frame base ``.ckpt`` as the
   student; ``distill_as`` (``methods.distill.train.main``: batches of 64
   drawn by class-balanced weights, 2 epochs with 1 of warm-up, lambda_d
   0.5): K1 once a train batch (one mel for teacher and student) and no
   other kernel, finite losses, the checkpoint manager's one save (the
   first epoch's) read back by the ``distillatst`` adapter equal tensor for
   tensor; train clips/s by step (the first left out), peak memory; one
   step at B = 4 on the card against the CPU (loss, each leaf's clipped
   gradient, the updated parameters) and one step's device time by kernel
   at B = 64; ``distill_other`` (``train_other.main`` on a seeded spcv2
   tree of 1 s clips, 35 labels, 256 / 70 / 70 clips, 12 s central crops,
   batches of 64, 1 epoch): K1 once a train and evaluation batch,
   ``result.json``'s ACC finite in [0, 1], train and evaluation clips/s;
   ``ddp_distill``: the ``distill_as`` step on 2 ranks as ``ddp_finetune``
   holds its step, then ``train_other`` at ``--n_devices 2`` on a 64 / 33 /
   33 spcv2 tree;
4. ATST-Frame training: one step of ``FrameMethod`` at the ATST-Frame base
   recipe (``bench.py:358-378``, B=96 clips of 10 s, bf16, seeded weights
   and waveforms) through the kernels K1-K5, K7 and K8, checking the launch
   counts of every kernel, a finite loss and a teacher that moved; the
   same step from the same state and draws through the plain versions
   (loss and every gradient leaf); clips/s of both paths in turns and peak
   memory;
5. ATST-Clip training, f32: the same for one step of ``ClipMethod`` at the
   ATST-Clip small recipe (``bench.py:119-129``, B=96 clips of 10 s, two
   6 s crops each) at its default dtype f32, through K1, K6, K8 and K7;
6. ATST-Clip training, bf16: the same for the recipe in bf16 (K1-K5, K8
   for the final norm, K7; the CLS token on the block kernels), with both
   paths' gradients held to the same step in f32 (bf16 rounding dominates
   this step's gradient, so the kernels are held to the plain version's
   distance from it);
7. ATST-Frame training, f32: the same for ``FramePretrainConfig(arch=
   "base")`` at its default dtype f32 (K1, K6, K8, K7);
8. ATST-Frame training, int8: the bf16 recipe of phase 4 with
   ``teacher_quant="int8"`` and ``student_quant="int8dx"`` (K2q, K3q, K4q
   and K5q forward and backward, K1, K7, K8): its loss and gradients held
   to its plain-version step (the lowest leaf cosine to what the plain
   step moves by under a rounding-scale shift of its input), both paths'
   gradients to the same step in f32 as in phase 6, timed in turns with
   the bf16 step; then, untimed, with ``student_quant="int8"`` (the
   K4q/K5q forward, the K4/K5 backward);
9. ATST-Clip training, int8: the bf16 recipe of phase 6 with the int8
   teacher and each int8 student, untimed, held as phase 6 is; then the
   data2vec variant of phase 4 (``avg_blocks=8``: the teacher's K2/K3
   collect its last 8 block outputs, the student has a linear projector
   whose bf16 output puts the loss in bf16, as in JAX), untimed, held as
   phase 6 is.
10. the frame CLI's run loop (``pretrain_frame_cli``, timed): a seeded int16
   pack of 480 tone clips of 2-10 s (~90 MB, 5 batches an epoch); the
   method built by ``methods/atstframe/train.py``'s ``build_method`` from
   the arguments of ``recipes/torch_atst_frame_base.sh`` (ATST-Frame base,
   bf16) at B=96, 2 warm-up steps of 12, a checkpoint every 6;
   ``run_pretraining`` through the native loader, logging every 3 steps:
   launches (12 x phase 4's), finite losses, a teacher that moved, clips/s
   by interval (the median of intervals 2-4 is the CLI's rate) beside the
   bare step's on a resident batch in the same process, each save's
   blocking host copy and background write, peak memory; then the last
   checkpoint restored into a fresh method (every tensor equal, the
   generator's state included) and one step from each state on the same
   batch and draws (loss and leaves: bit-equal reported, cosine >=
   0.99999 held), beside a control with no save or restore (one step from
   each of two states built alike): where the control is bit-equal, the
   restored step must be too; the run's clips/s over all its steps, saves
   included; then the run's newest checkpoint evaluated
   (``pretrain_eval``): its step directory through ``embedding.
   load_model`` and its ``state.pt`` through ``train_freeze.
   load_encoder``, each encoder equal tensor for tensor to the saved
   teacher encoder, the base arch read off its shapes, and one scene
   embedding through K1;
11. crash-restart, untimed: ``python -m audiossl_tpu_torch.methods.
   atstframe.train`` at the recipe's arguments, B=96, 8 steps, a
   checkpoint every 3, killed (SIGKILL) once its step-3 checkpoint exists;
   run again it resumes from step 3 (or 6), ends at step 8 and keeps at
   most 3 steps, 8 the latest; a third run takes no step and saves
   nothing;
12. the other CLIs, untimed, 3 steps each at B=96 with launch counts
   checked: ATST-Clip small through ``methods/atst/train.py`` in bf16
   (``recipes/torch_atst_clip_small.sh``; K1 2, K2-K5 12, K7 1, K8 1 a
   step), the data2vec variant (``--avg_blocks 8``: the teacher's K2/K3
   collect its last 8 block outputs) and the int8 recipe
   (``--teacher_quant int8 --student_quant int8dx``: K2q-K5q) of the
   frame CLI;
13. data-parallel pretraining (``ddp_frame``): 2 ranks on this one card,
   spawned by ``parallel.launch.spawn`` on gloo over CUDA tensors (NCCL
   refuses two ranks on one device), at the frame base bf16 recipe with a
   global batch of 32 (16 a rank), 3 steps from one seed, replicated and
   under ZeRO-1; each step against the 1-rank step on the same global
   batch run first in this process, from the 1-rank run's state before
   that step (loss rel 1e-2, lowest leaf cosine 0.99: the bf16
   kernel-vs-plain bounds), both ranks' states bit-equal
   after each step, each rank's launches of K1-K5, K7 and K8 equal to the
   1-rank step's, the moment bytes of each rank under ZeRO-1 (about half);
   then ``run_pretraining`` on the 2 ranks under ZeRO-1 for 6 steps on
   the CLI pack with a checkpoint every 3, rank 0's last checkpoint
   restored into a 1-rank state equal tensor for tensor to rank 0's final
   state; per-step wall and global clips/s (a correctness run, not a
   data-parallel rate). With 2 cards or more, also the frame CLI over
   NCCL at ``--n_devices`` the count for 3 steps; on one card a line says
   it did not run.
14. the comparison encoders, after ``ddp_sed`` (``comparison_encoders``):
   each of the eight adapters of ``downstream.comparison_models`` at the
   full width JAX's loaders build by default (BEATs iter3, ViT-B/16 for
   AudioMAE, M2D and both SSAST variants, MAE-AST 768 / 12 / 12, BYOL-A at
   d 3072), built in memory from seeded random weights in its authors'
   layout (``compat.synthetic``); ``frame_embeddings`` of 4 clips of 10 s
   on the card against the CPU (f32 both, TF32 off, rel L2 <= 1e-4), ``T'``
   = ``token_count``, K6 12 times a forward for each MAE-AST variant and no
   kernel for the others; clips/s at B = 32 and the peak; one SED step
   (2 strong and 2 weak clips) of ``maeast`` (12 K6 forward and backward
   launches) and of ``beats`` on the card against the CPU (loss rel 1e-5,
   lowest leaf cosine 0.9999); then ``comparison_sed``: ``train_dcase
   --arch maeast`` (finetuning through K6) and ``train_as_strong --arch
   beats --freeze_mode``, one epoch at batches of 32 on the SED trees, each
   reading one authors'-layout file: launches, ``result.json``, train and
   evaluation clips/s, peak memory.
15. the MAE and dual pretraining methods (no teacher: K7 updates with no
   teacher leaf): ``mae_small`` (MAE at its defaults: encoder 384 wide, 12
   blocks, 6 heads, decoder 384 wide, 6 blocks, 6 s crops, 111 of 148
   patches masked, B = 96; K1 and K7, its blocks on the module route),
   ``dual_f32`` (dual at ``--arch small``, 6.4 s crops: 160 tokens a
   branch, expanders of 8192, B = 96; K6 and K8 in both encoders, K1, K7)
   and ``dual_bf16`` (K4/K5 and K8 for the final norms), each held to its
   plain-version step as phases 5 and 6 hold theirs and timed in turns
   (clips/s, peak memory); ``pretrain_mae_cli`` and ``pretrain_dual_cli``
   (3 steps at B = 96 on the CLI pack with a checkpoint at the last, then a
   rerun that resumes from it, takes no step and holds the saved state
   tensor for tensor); ``ddp_dual`` (the dual small f32 step on 2 gloo
   ranks of this card at a global batch of 16, 2 steps against the 1-rank
   step: loss rel 1e-4, every leaf's gradient cosine 0.999, ranks
   bit-equal). Phase 2 also holds K1 at [96, 1026, 641], K4 and K5 at [96,
   160, 384] with 6 heads, K6 in f32 at [96, 160, 3 * 384] (timed beside
   SDPA) and at the ddp_dual steps' [8 and 16, 160, 3 * 384], K8 at [96 *
   160, 384] in f32 and bf16 and at the ddp_dual steps' rows, and K7 over
   the MAE and dual leaves with no teacher copy beside
   ``torch.optim.AdamW(fused=True)``.
Each path's seconds are printed (``path NAME: S s``), and the MAE and dual
phases' sum.
``--profile DIR`` also writes a ``torch.profiler`` table and trace of one
kernel-path step of phases 4, 5, 7 and 8 to DIR.

The shape of every launch of K1-K6 and K8 is recorded (``LAUNCH_SHAPE``):
every shape a main path launches must have been compared with the plain
version in phase 2 (K1 compares any other STFT shape after the paths),
and the STFT shapes each path hands K1 must include the one it was timed
at.
Any failed check raises and exits non-zero. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
The last two lines are a JSON summary of the kernels and the result line
``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
B, SAMPLES = 8, 160000  # 8 clips of 10 s at 16 kHz
LONG = 160320  # 1003 frames: a second chunk with 2 frames, no valid token
N, C, H, HID = 250, 768, 12, 3072  # ATST-Frame base tokens per 10 s chunk
K1_ATOL_DB = 1e-3  # f32 kernel vs f32 plain: summation order only
BLOCK_REL_L2 = 1e-2  # bf16 kernel vs bf16 plain: same rounding points,
# f32 sums in another order can move an element by one bf16 step
COS_MIN = 0.995  # fused bf16 vs plain f32: bf16 tokens, weights, residual
# stream over 12 blocks and final norm
CPU_ATOL = 1e-3  # plain f32 on the card vs the CPU: f32 summation order
TRAIN_B = 96  # clips per training step (bench.py:384): 2B sequences
ADAMW_REL = 1e-6  # K7 vs plain: the same f32 operations in the same order
MEL_TF32_ATOL = 2e-3  # TF32 vs f32 STFT, normalized mel: the JAX package's
# documented ~2e-3 for its 1-pass bf16 training STFT (TF32 keeps 2 more bits)
CLIP_N, CLIP_C, CLIP_H = 151, 384, 6  # ATST-Clip small, 6 s crops: 150
# patches and the CLS token, width 384, 6 heads of 64
CLI_CLIP_N = 226  # the clip CLI's 9 s crops (recipes/torch_atst_clip_small.sh)
# the dual method at 6.4 s (641 frames: 160 tokens a branch, G = 40; JAX's
# default 6.0 s fails, methods/dual/method.py); ddp_dual's global batch
DUAL_ANCHOR, DUAL_N, DUAL_DDP_B = 6.4, 160, 16
MHA_F32_REL = 1e-4  # f32 kernel vs f32 plain (K6, K8): f32 FMA sums in
# another order
STEP_LOSS_REL = 1e-2  # kernel vs plain step: bf16 at the same rounding
STEP_GRAD_COS = 0.99  # points, sums in another order, over 12 blocks
F32_STEP_LOSS_REL = 1e-4  # the same in f32: f32 sums in another order
F32_STEP_GRAD_COS = 0.999
# The bf16 ATST-Clip step's gradient is dominated by bf16 rounding: its
# plain version and its kernels each reach a median leaf cosine of ~0.98
# against the f32 step, and ~0.97-0.98 against each other. So there the
# kernels are held to add nothing beyond the plain version's rounding:
# against the same step in f32 (plain versions), their median leaf cosine
# within 0.005 of the plain bf16 step's and their lowest within 0.02.
REF_MEDIAN_MARGIN, REF_MIN_MARGIN = 0.005, 0.02
# The final LayerNorm's bias has no gradient in exact arithmetic (the
# projector's BatchNorm cancels a constant added to its input): both paths
# hold rounding noise there, whose cosine means nothing; it is held to a
# small norm instead.
ZERO_GRAD_REL = 1e-2
# int8 kernels (K2q-K5q) against the float kernels on the same inputs: the
# JAX package's budget for its int8 kernels against its float ones
# (tests/test_pallas_kernels.py:479-564), forward and every gradient
Q8_FWD_REL, Q8_GRAD_REL = 2e-2, 5e-2
# An int8 kernel that skipped quantizing would sit next to its float
# kernel: its distance from the float kernel (on the residual branch, and
# on dx less dy) must be at least this share of its plain version's
Q8_SPREAD = 0.5
# The int8 steps' kernel and plain paths, each against the same step in
# f32: both sit at a median leaf cosine of ~0.995 and a lowest of ~0.987
# (pos_embed), 2e-5 and 6e-5 apart (PERF.md); held two-sided to these
Q8_REF_MARGINS = (1e-3, 5e-3)
# An int8 code turns on rounding, so the int8 steps' two paths lie further
# apart than rounding alone moves a bf16 step. The witness of that: the
# plain step against itself on the waveform scaled by WITNESS_GAIN (a
# constant 0.017 dB shift of the mel, which the f32 step's gradient
# follows within F32_STEP_GRAD_COS); the kernel path's lowest leaf cosine
# to the plain path must reach the witness's less WITNESS_MARGIN
WITNESS_GAIN, WITNESS_MARGIN = 1.0 + 2.0 ** -9, 5e-3
Q8_COS_MIN = 0.99  # int8 vs bf16 serving, per row with audio: ~1e-2
# relative change of each block's output over 12 blocks
# The card's peak rates (NVIDIA H100 SXM data sheet, dense) for the bounds:
# operations by type, bytes of device memory. K6's f32 products count as
# three TF32 passes (the 3xTF32 split that keeps f32 accuracy on the tensor
# cores): 3 x ops / 495 TFLOP/s lies below ops / 67 TFLOP/s of SIMT f32
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
# The GEMM template alone against float64 products of the same bf16
# operands: exact products summed in f32 in another order (f32 outputs),
# and one rounding of sum + bias to bf16 (bias epilogue)
GEMM_F32_REL, GEMM_BIAS_REL = 1e-5, 4e-3


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"ok: {what}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, match=None, iters=10, warmup=3, launches=1):
    """Device time per call of ``fn``: the profiler's self CUDA time of the
    kernels whose names hold one of the strings in ``match`` (of every
    device event when None), over ``iters`` calls after ``warmup``. The
    card's own time, which the host's launch cost does not reach.

    A profiling window may hold fewer records than launches (on the H100
    some windows keep 9 of 10 calls' kernels), which a sum over the window
    divided by ``iters`` would read as a shorter call. So each kernel's
    time is its mean over the records kept, times its launches a call
    (its records over ``iters``, rounded, at least 1); those launches must
    add up to ``launches`` (when ``match`` is given) and each kernel must
    keep at least half its records, else the window is profiled again,
    twice at most."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    what = match or "the call"
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.self_device_time_total > 0
                and (match is None or any(m in e.key for m in match))]
        counts = [e.count for e in seen]
        per_call = [max(1, round(c / iters)) for c in counts]
        us = sum(e.self_device_time_total / c * n
                 for e, c, n in zip(seen, counts, per_call))
        ok = (bool(seen) and all(2 * c >= iters * n
                                 for c, n in zip(counts, per_call))
              and (match is None or sum(per_call) == launches))
        if ok:
            break
        print(f"device_ms: {counts} records of {what} over {iters} calls; "
              "profiling again")
    check(ok, f"the profiler kept the launches of {what} ({counts} records "
          f"over {iters} calls)")
    if sum(counts) != iters * sum(per_call):
        print(f"device_ms: {counts} records of {what} over {iters} calls; "
              "timed as the mean over the records kept")
    return us / 1e3


def card_state(label):
    """Prints the card's SM clock (and its maximum), power draw,
    temperature and active clock-event reasons beside a timed phase: a card
    that throttles runs every kernel slower, library calls included."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu,clocks_event_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"card state ({label}): {(q.stdout or q.stderr).strip()}")


def nbytes(*tensors):
    """Bytes of the given tensors (other arguments skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(nbytes_moved, **ops):
    """The least time the card could take for a kernel's work: the larger
    of the bytes it must move (each input read once, each output written
    once) over the memory rate and its operations, by type, over the peak
    rate of that type (``PEAK_OPS``)."""
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops.items())
    t_mem = nbytes_moved / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_mem) * 1e3,
                bound_by="bytes" if t_mem >= t_ops else "operations")


def attn_pairs(lengths, n):
    """(query, key) pairs the masked attention needs: every query against
    the valid keys of its sequence, against all n for a sequence with no
    valid key (uniform attention)."""
    return n * int(torch.where(lengths > 0, lengths,
                               torch.full_like(lengths, n)).sum())


def int_mm_ms(pairs):
    """CUDA-event time of ``torch._int_mm`` over the (codes, weight)
    pairs of a kernel's int8 products alone (the library call for them)."""
    return cuda_ms(lambda: [torch._int_mm(a, w) for a, w in pairs], iters=10)


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def row_cos(a, b):
    a = a.reshape(-1, a.shape[-1]).double()
    b = b.reshape(-1, b.shape[-1]).double()
    return torch.nn.functional.cosine_similarity(a, b, dim=-1)


def gemm_operands(layout, m, n, k, gen, dev):
    """bf16 operands of a product of ``ops.gemm``'s ``layout`` drawn from
    ``gen``, and the same product through ``torch.matmul``'s operand
    views (lhs [m, k], rhs [k, n])."""
    shapes = {"forward": ((m, k), (n, k)), "dx": ((m, k), (k, n)),
              "weight_grad": ((k, m), (k, n))}[layout]
    a, b = (torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
            for s in shapes)
    lhs = a.t() if layout == "weight_grad" else a
    rhs = b.t() if layout == "forward" else b
    return a, b, lhs, rhs


def _epi_name(mangled):
    """The epilogue functor's name in a kernel's mangled name: the
    identifier after the length prefix that ends where the name does."""
    import re

    for m in re.finditer(r"(\d+)(Epi\w+)", mangled):
        digits, rest = m.groups()
        for k in range(1, len(digits) + 1):
            n = int(digits[-k:])
            if 3 <= n <= len(rest) and rest[n:n + 1] in ("E", ""):
                return rest[:n]
    return mangled


def ptxas_props(kernel):
    """The build log's ``-Xptxas -v`` report (stack, spills, registers) of
    each compiled entry function whose mangled name matches the regular
    expression ``kernel``."""
    import re

    from audiossl_tpu_torch.kernels import build as kb

    lib = kb.build()
    digest = lib.name[len("libaudiossl_kernels_"):-len(".so")]
    log = (lib.parent / f"{digest}.log").read_text().splitlines()
    props = {}
    for i, line in enumerate(log):
        m = re.search(rf"Compiling entry function '(\w*(?:{kernel})\w*)'",
                      line)
        if m:
            props[m.group(1)] = " ".join(s.strip().replace("ptxas info    : ",
                                                           "")
                                         for s in log[i + 2:i + 4])
    return props


def spills(props):
    """Bytes of spill stores and loads in a ``ptxas_props`` report."""
    import re

    return [int(v) for v in re.findall(r"(\d+) bytes spill", props)]


def k1_k7_k8_build_report():
    """Registers and spills of K1's and K7's kernels and of each K8
    instantiation (element type, vector width V, lanes a row, vectors a
    lane) and its column-sum kernel, from the build's ``-Xptxas -v`` log.
    Fails if K1, K7, the column sums or an instantiation the main paths run
    (widths 384 and 768 in f32 and bf16) spills."""
    import re

    main = {("f32", 4, 32, 3), ("f32", 4, 32, 6), ("bf16", 8, 16, 3),
            ("bf16", 8, 32, 3)}
    props = ptxas_props(
        "mel_db_kernel|adamw_ema_kernel|ln_pg_bwd_kernel|ln_pg_colsum")
    seen = set()
    for name, p in sorted(props.items()):
        m = re.search(r"ln_pg_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)"
                      r"ELi(\d+)E", name)
        if m:
            key = ("f32" if m.group(1) == "f" else "bf16",
                   *map(int, m.group(2, 3, 4)))
            short = "ln_pg_bwd_kernel<{}, V={}, LPR={}, NPL={}>".format(*key)
            held = key in main
            seen.add(key)
        else:
            short = next(k for k in ("mel_db_kernel", "adamw_ema_kernel",
                                     "ln_pg_colsum_kernel") if k in name)
            held = True
        print(f"build: {short}: {p}")
        if held:
            sp = spills(p)
            check(len(sp) == 2 and not any(sp),
                  f"{short} spills nothing ({sp} bytes stored, loaded)")
    check(main <= seen and all(any(k in n for n in props)
                               for k in ("mel_db", "adamw_ema")),
          "the build log lists K1, K7 and K8's main-path instantiations")


def gemm_build_report():
    """What the compiler made of the GEMM templates: each instantiation of
    ``gemm_bf16_kernel`` and ``gemm_s8_kernel``, its registers, spills and
    barriers from the build's ``-Xptxas -v`` log and its count of
    warpgroup (``wgmma``: HGMMA for bf16, IGMMA for int8) and warp-level
    (``mma.sync``, WMMA: HMMA, IMMA) tensor-core instructions in the built
    library (``cuobjdump -sass``). Fails unless each issues its ``wgmma``
    and no warp-level product, with no spills."""
    import re

    from audiossl_tpu_torch.kernels import build as kb

    lib = kb.build()
    props = ptxas_props(r"gemm_(?:bf16|s8)_kernel")
    check(any("gemm_bf16_kernel" in n for n in props)
          and any("gemm_s8_kernel" in n for n in props),
          "the build log lists both GEMM templates' kernels")
    cuobjdump = os.path.join(os.path.dirname(kb._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", "-fun", ",".join(props),
                           str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    ops = ("HGMMA", "IGMMA", "HMMA", "IMMA")
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts.setdefault(fn, dict.fromkeys(ops, 0))
        elif fn:
            for op in ops:
                counts[fn][op] += len(re.findall(rf"\b{op}\b", line))
    for name, p in props.items():
        n = counts.get(name, dict.fromkeys(ops, 0))
        int8 = "gemm_s8_kernel" in name
        if int8:
            short = f"gemm_s8_kernel<{_epi_name(name)}>"
        else:  # the template arguments A_K, B_K, Epi
            m = re.search(r"gemm_bf16_kernelILb(\d)ELb(\d)E", name)
            short = (f"gemm_bf16_kernel<{m.group(1) == '1'}, "
                     f"{m.group(2) == '1'}, {_epi_name(name)}>" if m
                     else name)
        wg, warp = ("IGMMA", "IMMA") if int8 else ("HGMMA", "HMMA")
        sp = spills(p)
        print(f"{short}: {p}; SASS: " + ", ".join(f"{n[o]} {o}" for o in ops))
        check(n[wg] > 0 and n["HMMA"] + n["IMMA"] == 0,
              f"{short} computes with wgmma ({n[wg]} {wg}) and no mma.sync /"
              f" WMMA ({n['HMMA']} HMMA, {n['IMMA']} IMMA)")
        check(len(sp) == 2 and not any(sp),
              f"{short} spills nothing ({sp} bytes stored, loaded)")


def gemm_checks(dev):
    """The bf16 GEMM template of K2-K5 alone (``ops.gemm``), each operand
    layout against ``torch.matmul`` in float64 of the same bf16 operands:
    at the ATST-Frame base step's products (48,000 rows, width 768, hidden
    3072: forward, input-gradient and the weight gradients over all rows
    with the block kernels' own K splits), the ATST-Clip small step's
    ragged fc1 (28,992 rows), serving's qkv with the bias epilogue (2,000
    rows) and a small ragged case of each layout and epilogue; each main
    shape timed beside ``torch.matmul`` in bf16 (cuBLAS) at the same
    shape. Then the GELU epilogues' branch-free reciprocal against the
    IEEE division over its whole domain."""
    from audiossl_tpu_torch.ops.gemm import gemm_bf16, reciprocal_mismatches

    gemm_build_report()
    card_state("GEMM phase")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    M, MC = 2 * TRAIN_B * N, 2 * TRAIN_B * CLIP_N
    # (what, layout, epilogue, M, N, K, splits, timed)
    cases = [("fc1", "forward", "f32", M, HID, C, 1, True),
             ("fc2", "forward", "f32", M, C, HID, 1, True),
             ("proj", "forward", "f32", M, C, C, 1, True),
             ("da = dyb W2", "dx", "f32", M, HID, C, 1, True),
             ("dh = du W1", "dx", "f32", M, C, HID, 1, True),
             ("do = dyb W_proj", "dx", "f32", M, C, C, 1, True),
             ("dW2 = dyb^T a", "weight_grad", "atomic", C, HID, M, 0, True),
             ("dW1 = du^T h", "weight_grad", "atomic", HID, C, M, 0, True),
             ("dW_proj = dyb^T o", "weight_grad", "atomic", C, C, M, 0,
              True),
             ("clip fc1", "forward", "f32", MC, 4 * CLIP_C, CLIP_C, 1, True),
             ("serving qkv", "forward", "bias", B * N, 3 * C, C, 1, True)]
    # small and ragged: M = 97 rows (K = 97 rows for the weight gradient,
    # whose M is contiguous), every epilogue
    for layout in ("forward", "dx", "weight_grad"):
        m, k = (256, 97) if layout == "weight_grad" else (97, 256)
        for epi, splits in (("f32", 1), ("atomic", 2), ("bias", 1)):
            cases.append((f"small {epi}", layout, epi, m, 200, k, splits,
                          False))
    for what, layout, epi, m, n, k, splits, timed in cases:
        a, b, lhs, rhs = gemm_operands(layout, m, n, k, gen, dev)
        bias = (torch.randn(n, generator=gen, device=dev)
                if epi == "bias" else None)
        got = gemm_bf16(a, b, layout, epi, bias=bias, splits=splits)
        want = lhs.double() @ rhs.double()
        if bias is not None:
            want += bias.double()
        r = rel_l2(got.double(), want)
        tol = GEMM_BIAS_REL if epi == "bias" else GEMM_F32_REL
        label = (f"gemm {layout} {epi} ({what}) [{m} x {k}] x [{k} x {n}]"
                 f"{f', {splits} splits' if splits != 1 else ''}")
        line = f"{label}: rel_l2 {r}"
        if timed:
            flop = 2.0 * m * n * k
            ms = cuda_ms(lambda: gemm_bf16(a, b, layout, epi, bias=bias,
                                           splits=splits), iters=10)
            lib = cuda_ms(lambda: torch.matmul(lhs, rhs), iters=10)
            line += "".join(
                f", {who} {t} ms {flop / t / 1e9:.1f} TFLOP/s "
                f"({100 * flop / t / 1e-3 / PEAK_OPS['bf16']:.1f}% of the "
                f"bf16 peak)" for who, t in (("template", ms),
                                             ("cuBLAS bf16", lib)))
        print(line)
        check(bool(torch.isfinite(got.float()).all()), f"{label} finite")
        check(r <= tol, f"{label} rel L2 {r} <= {tol}")
        del a, b, lhs, rhs, got, want
    torch.cuda.empty_cache()
    # host time of a launch: the hook's Python checks, ctypes call, two
    # tensor-map encodings and launch, beside one cuBLAS call (enqueue
    # only: the small product finishes faster than the host enqueues it)
    a, b, lhs, rhs = gemm_operands("forward", 97, 200, 256, gen, dev)
    host = {}
    for who, fn in (("template hook", lambda: gemm_bf16(a, b, "forward")),
                    ("torch.matmul", lambda: torch.matmul(lhs, rhs))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        host[who] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    print("host time per call, [97 x 256] x [256 x 200]: " + ", ".join(
        f"{who} {us} us" for who, us in host.items()))
    bad = reciprocal_mismatches(dev)
    check(bad == 0, f"the GELU epilogues' reciprocal equals 1 / x over every "
          f"float in [1, 2^126] and +inf ({bad} differ)")
    gemm_s8_checks(dev)


def gemm_s8_checks(dev):
    """The int8 GEMM template of K2q-K5q alone (``ops.gemm.gemm_s8``) on
    seeded codes and scales, against its plain version on the card (the
    exact product in float64, then the two scales): the f32 epilogue bit
    for bit (the int32 sum is exact in any order), the bias epilogue within
    ``GEMM_BIAS_REL``. At K5q's products at 48,000 rows (fc1, fc2, and the
    int8dx da = q8(dy dp) W2 and dh = q8(du) W1 against the codes of W2^T
    and W1^T), K4q's (qkv, proj and their int8dx do and dh), the clip
    fc1 (28,992 rows), serving's qkv with the bias epilogue (2,000 rows)
    and a 97-row ragged case of each epilogue; each main shape timed beside
    ``torch._int_mm`` of the same codes."""
    from audiossl_tpu_torch.ops.gemm import gemm_s8, gemm_s8_ref

    card_state("int8 GEMM phase")
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    M, MC = 2 * TRAIN_B * N, 2 * TRAIN_B * CLIP_N
    # (what, epilogue, M, N, K, b as the transpose of a [K, N] code matrix,
    # timed)
    cases = [("K5q fc1", "f32", M, HID, C, False, True),
             ("K5q fc2", "f32", M, C, HID, False, True),
             ("K5q da = q8(dy dp) W2", "f32", M, HID, C, True, True),
             ("K5q dh = q8(du) W1", "f32", M, C, HID, True, True),
             ("K4q qkv", "f32", M, 3 * C, C, False, True),
             ("K4q proj", "f32", M, C, C, False, True),
             ("K4q do = q8(dy dp) W_proj", "f32", M, C, C, True, True),
             ("K4q dh = q8(dqkv) W_qkv", "f32", M, C, 3 * C, True, True),
             ("clip fc1", "f32", MC, 4 * CLIP_C, CLIP_C, False, True),
             ("serving qkv", "bias", B * N, 3 * C, C, False, True),
             ("small f32", "f32", 97, 200, 256, False, False),
             ("small bias", "bias", 97, 200, 256, True, False)]
    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    for what, epi, m, n, k, transposed, timed in cases:
        a = codes(m, k)
        b = codes(k, n).t().contiguous() if transposed else codes(n, k)
        ra = torch.rand(m, generator=gen, device=dev) * 1e-2 + 1e-4
        sb = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-5
        bias = (torch.randn(n, generator=gen, device=dev)
                if epi == "bias" else None)
        got = gemm_s8(a, b, ra, sb, epi, bias=bias)
        want = gemm_s8_ref(a, b, ra, sb, epi, bias=bias)
        differ = int((got != want).sum())
        r = rel_l2(got, want)
        label = f"gemm_s8 {epi} ({what}) [{m} x {k}] x [{k} x {n}]"
        line = f"{label}: {differ} of {got.numel()} differ, rel_l2 {r}"
        if timed:
            ops = 2.0 * m * n * k
            ms = cuda_ms(lambda: gemm_s8(a, b, ra, sb, epi, bias=bias),
                         iters=10)
            lib = cuda_ms(lambda: torch._int_mm(a, b.t()), iters=10)
            line += "".join(
                f", {who} {t} ms {ops / t / 1e9:.1f} TOP/s "
                f"({100 * ops / t / 1e-3 / PEAK_OPS['int8']:.1f}% of the "
                f"int8 peak)" for who, t in (("template", ms),
                                             ("torch._int_mm", lib)))
        print(line)
        check(bool(torch.isfinite(got.float()).all()), f"{label} finite")
        if epi == "f32":
            check(differ == 0, f"{label} bit-equal to the plain version "
                  f"({differ} differ)")
        else:
            check(r <= GEMM_BIAS_REL, f"{label} rel L2 {r} <= {GEMM_BIAS_REL}")
        del a, b, got, want
    torch.cuda.empty_cache()


# K1 at the main paths' STFT shapes [B, 2 * 513, T], timed: serving 8 x
# 10 s, clip inference 8 x 6 s, the frame step 96 x 10 s, the clip step 96 x
# 6 s crops, the probes' extraction batches 64 x 12 s, the clip CLI's 96 x
# 9 s crops, the DCASE step's 128 + 128 x 10 s, the SED evaluations' and
# AudioSet-strong step's 32 x 10 s and the AudioSet distillation step's 64 x
# 10 s; any other shape a main path hands K1 is compared after the paths
# (``k1_compare``)
K1_SHAPES = {"serving": (B, 1026, 1001), "clip_serving": (B, 1026, 601),
             "frame_bf16": (TRAIN_B, 1026, 1001),
             "clip_f32": (TRAIN_B, 1026, 601),
             "probe_clip": (64, 1026, 1201),
             "pretrain_clip_cli": (TRAIN_B, 1026, 901),
             "sed_dcase": (256, 1026, 1001), "sed_as_strong": (32, 1026, 1001),
             "distill_as": (64, 1026, 1001)}
# paths that hand K1 the shape another path's entry times
K1_SAME_SHAPE = {"probe_frame": "probe_clip", "finetune_clip": "probe_clip",
                 "sed_dcase_distill": "sed_dcase",
                 "distill_other": "probe_clip"}
# The shape of each launch, as its comparison with the plain version must
# have covered it: K1's STFT [B, 2F, T]; K2-K5 and K2q-K5q (tokens, width,
# heads or hidden width: the batch only sizes the grid); K6 (dtype,
# tokens, width, heads); K8 (dtype, rows, width). The integers a wrapper
# hands ``kb.launch`` after the pointers, in the order of its C entry
# point; K7 is not recorded (its leaf table is checked at the base
# student's leaves and at odd ones).
_BLOCK = lambda a: tuple(a[1:4])  # noqa: E731  (B, N, C, H or Hd)
LAUNCH_SHAPE = {
    "mel_db": lambda a: (a[0], 2 * a[1], a[2]),
    "mha_fwd": lambda a: (a[0], *a[2:5]), "mha_bwd": lambda a: (a[0], *a[2:5]),
    "ln_pg_bwd": lambda a: tuple(a[1:4]),
    **{k: _BLOCK for k in (
        "attn_block", "mlp_block", "attn_train_fwd", "attn_train_bwd",
        "mlp_train_fwd", "mlp_train_bwd", "attn_block_q8", "mlp_block_q8",
        "attn_train_fwd_q8", "attn_train_bwd_q8dx", "mlp_train_fwd_q8",
        "mlp_train_bwd_q8dx")}}
LAUNCH_SEEN = {}  # kernel -> the shapes of its launches on the card since
# the last clear (record_launch_shapes)


def record_launch_shapes():
    """Adds the shape (``LAUNCH_SHAPE``) of every launch of K1-K6 and K8 to
    ``LAUNCH_SEEN``; the launch and its count go on as they were."""
    from audiossl_tpu_torch.kernels import build as kb

    launch = kb.launch

    def recorded(name, device, *args):
        if name in LAUNCH_SHAPE:
            ints = [a for a in args if type(a) is int]
            LAUNCH_SEEN.setdefault(name, set()).add(LAUNCH_SHAPE[name](ints))
        return launch(name, device, *args)

    kb.launch = recorded


def k1_compare(dev, shape):
    """K1 against its plain version, untimed, on the STFT of seeded
    waveforms at ``shape`` [B, 1026, T] (the recipe's filterbank); returns
    the largest error."""
    from audiossl_tpu_torch.ops import mel_db as md
    from audiossl_tpu_torch.ops.melspec import MelConfig, mel_filterbank, stft_conv

    cfg = MelConfig()
    rng = np.random.RandomState(SEED + 40)
    wav = torch.from_numpy((rng.randn(shape[0], (shape[2] - 1)
                                      * cfg.hop_length) * 0.1).astype(
        np.float32)).to(dev)
    stft = stft_conv(wav, cfg)
    check(tuple(stft.shape) == tuple(shape), f"K1 STFT shape {shape}")
    fb = mel_filterbank(cfg, dev)
    got = md.stft_to_mel_db(stft, fb, cfg.amin)
    want = md.stft_to_mel_db_ref(stft, fb, cfg.amin)
    err = float((got - want).abs().max())
    print(f"K1 mel_db {tuple(shape)} (a main path's shape, untimed): "
          f"max_abs_err {err} dB, rel_l2 {rel_l2(got, want)}")
    check(bool(torch.isfinite(got).all()) and err <= K1_ATOL_DB,
          f"K1 {tuple(shape)} finite, max abs error {err} <= {K1_ATOL_DB} dB")
    return err


def mel_db_checks(dev):
    """K1 against its plain version at each shape of ``K1_SHAPES`` (on the
    STFT of seeded waveforms, the recipe's filterbank), each with its
    device time (profiler), its time by CUDA events over back-to-back calls
    (the host included), the host's own time to issue a call, the plain
    version's time and the bound; its first call for the filterbank builds
    the band table, the next two run under ``set_sync_debug_mode("error")``;
    then, untimed, a dense random filterbank with an all-zero mel column
    and a 97-frame clip. Returns the serving shape's numbers, the largest
    error of every case and each shape's numbers under ``shapes``."""
    from audiossl_tpu_torch.ops import mel_db as md
    from audiossl_tpu_torch.ops.melspec import MelConfig, mel_filterbank, stft_conv

    rng = np.random.RandomState(SEED)
    cfg = MelConfig()
    fb = mel_filterbank(cfg, dev)
    md._TABLES.clear()  # the first call below builds the table
    words, n_groups, n_pairs = md.band_table(fb.cpu().numpy())
    groups = list(md.table_groups(words, n_groups, n_pairs))
    n_terms = sum(int((fl & md.EMPTY == 0).sum()) for _, _, fl, _ in groups)
    lo = min(int(bins.min()) for _, bins, _, _ in groups)
    hi = max(int(bins.max()) for _, bins, _, _ in groups)
    print(f"K1 band table: {n_pairs} pairs ({n_terms} terms) over bins "
          f"{lo}-{hi} in {n_groups} groups")

    def stft_of(b, samples):
        wav = torch.from_numpy((rng.randn(b, samples) * 0.1).astype(
            np.float32)).to(dev)
        return stft_conv(wav, cfg)

    def held(label, stft, fb_):
        got = md.stft_to_mel_db(stft, fb_, cfg.amin)
        want = md.stft_to_mel_db_ref(stft, fb_, cfg.amin)
        err = float((got - want).abs().max())
        print(f"K1 mel_db {label} {tuple(stft.shape)} -> {tuple(got.shape)}:"
              f" max_abs_err {err} dB, rel_l2 {rel_l2(got, want)}")
        check(bool(torch.isfinite(got).all()), f"K1 {label} finite")
        check(err <= K1_ATOL_DB, f"K1 {label} max abs error {err} <= "
              f"{K1_ATOL_DB} dB")
        return err

    shapes, errs = {}, []
    for label, shape in K1_SHAPES.items():
        stft = stft_of(shape[0], (shape[2] - 1) * cfg.hop_length)
        check(tuple(stft.shape) == shape, f"K1 {label} STFT shape {shape}")
        errs.append(held(label, stft, fb))
        if not shapes:
            table = md._device_table(fb)[0]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(2):
                    md.stft_to_mel_db(stft, fb, cfg.amin)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            check(md._device_table(fb)[0] is table, "K1 reused its band table")
            print("ok: K1's second and third calls made no synchronizing call")

        def kernel():
            md.stft_to_mel_db(stft, fb, cfg.amin)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            kernel()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        n_b, _, n_t = shape
        # what this filterbank needs: the real and imaginary rows of bins
        # lo..hi read once, the band table read once, the mel written once;
        # per frame and term its power (3) and FMA (2)
        out_bytes = 4 * n_b * fb.shape[1] * n_t
        r = dict(shape=list(shape), max_abs_err=errs[-1],
                 ms=cuda_ms(kernel), device_ms=device_ms(kernel,
                                                         ("mel_db_kernel",)),
                 host_ms=host_ms,
                 plain_ms=cuda_ms(lambda: md.stft_to_mel_db_ref(
                     stft, fb, cfg.amin)),
                 library_ms=None,
                 **bound(4 * 2 * (hi - lo + 1) * n_b * n_t + 4 * words.size
                         + out_bytes, f32=5 * n_terms * n_b * n_t))
        # the whole STFT and the dense filterbank read instead
        r["bound_stft_ms"] = bound(nbytes(stft, fb) + out_bytes)["bound_ms"]
        print(f"K1 mel_db {label} {shape}: device {r['device_ms']} ms, "
              f"events {r['ms']} ms, host {host_ms} ms to issue a call, "
              f"plain {r['plain_ms']} ms; bound {r['bound_ms']} ms (bins "
              f"{lo}-{hi}), {r['bound_stft_ms']} ms (the whole STFT)")
        shapes[label] = r
        del stft
        torch.cuda.empty_cache()
    # a dense random filterbank with an all-zero mel column (every bin of
    # every other mel in its band), and a ragged 97-frame clip
    dense = torch.from_numpy(rng.rand(fb.shape[0], fb.shape[1]).astype(
        np.float32)).to(dev)
    dense[:, 5] = 0.0
    errs.append(held("dense filterbank", stft_of(B, SAMPLES), dense))
    errs.append(held("97 frames", stft_of(2, 96 * cfg.hop_length), fb))
    return {"mel_db": dict(shapes["serving"], max_abs_err=max(errs),
                           shapes=shapes)}


def kernel_checks(dev):
    """K1 (``mel_db_checks``), K2 and K3 against their plain versions at the
    serving shapes, and K2 and K3 at the bf16 frame step's teacher shape
    [192, 250, 768]."""
    rng = np.random.RandomState(SEED)
    res = mel_db_checks(dev)

    def t(*shape, s=1.0, off=0.0, dtype=torch.float32):
        a = (rng.randn(*shape) * s + off).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    x = t(B, N, C, dtype=torch.bfloat16)
    lengths = torch.tensor([250, 200, 137, 64, 1, 0, 250, 99], device=dev)
    valid = (torch.arange(N, device=dev)[None] < lengths[:, None]).float()
    dp = torch.tensor([1, 0, 1 / 0.9, 1, 1, 1 / 0.9, 0, 1], device=dev,
                      dtype=torch.float32)
    res.update(infer_block_checks(t, x, valid, dp, H, HID, lengths))
    # the bf16 frame step's teacher: 192 sequences of 250 tokens, all valid
    S = 2 * TRAIN_B
    xt = t(S, N, C, dtype=torch.bfloat16)
    full = torch.full((S,), N, device=dev)
    for name, r in infer_block_checks(
            t, xt, torch.ones(S, N, device=dev), torch.ones(S, device=dev),
            H, HID, full).items():
        print(f"{name} [{S}, {N}, {C}]: {r['ms']} ms, bound {r['bound_ms']}"
              f" ms, cuBLAS products {r['library_ms']} ms")
        res[name]["teacher"] = r
    return res


def infer_block_checks(t, x, valid, dp, h, hid, lengths=None, timed=True):
    """K2 and K3 against their plain versions on x [S, n, c] bf16 with
    weights drawn by ``t``; with ``timed``, both times and the bounds as
    well (``lengths`` the valid tokens of each sequence)."""
    from audiossl_tpu_torch.ops import block_infer as bi

    bf, c = torch.bfloat16, x.shape[-1]
    attn_args = (x, valid, t(c, s=0.1, off=1.0), t(c, s=0.1),
                 t(3 * c, c, s=0.05, dtype=bf), t(3 * c, s=0.02),
                 t(c, c, s=0.05, dtype=bf), t(c, s=0.02), h)
    mlp_args = (x, t(c, s=0.1, off=1.0), t(c, s=0.1),
                t(hid, c, s=0.05, dtype=bf), t(hid, s=0.02),
                t(c, hid, s=0.05, dtype=bf), t(c, s=0.02))
    res = {}
    for name, fn, ref, args in (
            ("attn_block", bi.attn_block_infer, bi.attn_block_infer_ref,
             attn_args),
            ("mlp_block", bi.mlp_block_infer, bi.mlp_block_infer_ref,
             mlp_args)):
        got = fn(*args, dp=dp)
        want = ref(*args, dp=dp)
        r = rel_l2(got, want)
        rb = rel_l2(got.float() - x.float(), want.float() - x.float())
        err = float((got.float() - want.float()).abs().max())
        print(f"{name} {tuple(x.shape)} bf16: rel_l2 {r}, residual-branch "
              f"rel_l2 {rb}, max_abs_err {err}, "
              f"equal {float((got == want).float().mean())}")
        check(bool(torch.isfinite(got.float()).all()), f"{name} finite")
        check(r <= BLOCK_REL_L2, f"{name} rel L2 {r} <= {BLOCK_REL_L2}")
        check(rb <= BLOCK_REL_L2,
              f"{name} residual-branch rel L2 {rb} <= {BLOCK_REL_L2}")
        res[name] = dict(max_abs_err=err, rel_l2=r)
        if timed:
            M = x.shape[0] * x.shape[1]
            ops = (dict(bf16=8 * M * c * c
                        + 4 * c * attn_pairs(lengths, x.shape[1]))
                   if name == "attn_block" else dict(bf16=4 * M * c * hid))
            mm = ([("forward", M, 3 * c, c), ("forward", M, c, c)]
                  if name == "attn_block" else
                  [("forward", M, hid, c), ("forward", M, c, hid)])
            res[name].update(ms=cuda_ms(lambda: fn(*args, dp=dp)),
                             plain_ms=cuda_ms(lambda: ref(*args, dp=dp)),
                             library_ms=library_mm(mm, x.device),
                             **bound(nbytes(*args, dp, got), **ops))
    return res


def q8_infer_checks(dev):
    """K2q and K3q against their plain versions on the same int8 codes, and
    against the bf16 kernels K2/K3 on the same weights (the JAX package's
    int8 budget, and at least ``Q8_SPREAD`` of the plain int8 version's
    distance on the residual branch): at the serving shape [8, 250, 768],
    at the teacher's [192, 250, 768] with drop-path multipliers, both timed
    with their bounds and the int8 products alone through
    ``torch._int_mm``, and at the ATST-Clip small teacher's [192, 151, 384]
    (6 heads, hidden 1536; errors only). The serving case is the one the
    summary line reports at its top level."""
    from audiossl_tpu_torch.ops import block_infer as bi
    from audiossl_tpu_torch.ops.quant import quantize_weight_q8

    rng = np.random.RandomState(SEED + 12)
    bf = torch.bfloat16

    def t(*shape, s=1.0, off=0.0, dtype=torch.float32):
        a = (rng.randn(*shape) * s + off).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    res = {"attn_block_q8": {}, "mlp_block_q8": {}}
    for label, S, n, c, h, hid, timed in (
            ("serving", B, N, C, H, HID, True),
            ("teacher", 2 * TRAIN_B, N, C, H, HID, True),
            ("clip", 2 * TRAIN_B, CLIP_N, CLIP_C, CLIP_H, 4 * CLIP_C, False)):
        x = t(S, n, c, dtype=bf)
        ragged = [min(v, n) for v in (250, 200, 137, 64, 1, 0, 250, 99)]
        lengths = torch.tensor([ragged[i % 8] if i % 3 != 1 else n
                                for i in range(S)], device=dev)
        valid = (torch.arange(n, device=dev)[None] < lengths[:, None]).float()
        dp = torch.tensor([(1.0, 0.0, 1 / 0.9)[i % 3] for i in range(S)],
                          device=dev)
        M = S * n
        # f32 masters, quantized per output channel as the wrappers do
        w_qkv, w_proj = t(3 * c, c, s=0.05), t(c, c, s=0.05)
        w1, w2 = t(hid, c, s=0.05), t(c, hid, s=0.05)
        qkv_q, proj_q = quantize_weight_q8(w_qkv), quantize_weight_q8(w_proj)
        w1_q, w2_q = quantize_weight_q8(w1), quantize_weight_q8(w2)
        ln = [t(c, s=0.1, off=1.0), t(c, s=0.1)]
        b_qkv, b_proj, b1, b2 = (t(3 * c, s=0.02), t(c, s=0.02),
                                 t(hid, s=0.02), t(c, s=0.02))
        cases = {
            "attn_block_q8": (
                bi.attn_block_infer_q8, bi.attn_block_infer_q8_ref,
                (x, valid, *ln, *qkv_q, b_qkv, *proj_q, b_proj, h),
                bi.attn_block_infer,
                (x, valid, *ln, w_qkv.to(bf), b_qkv, w_proj.to(bf), b_proj,
                 h),
                dict(int8=8 * M * c * c, bf16=4 * c * attn_pairs(lengths, n)),
                [(M, qkv_q[0].t()), (M, proj_q[0].t())]),
            "mlp_block_q8": (
                bi.mlp_block_infer_q8, bi.mlp_block_infer_q8_ref,
                (x, *ln, *w1_q, b1, *w2_q, b2), bi.mlp_block_infer,
                (x, *ln, w1.to(bf), b1, w2.to(bf), b2),
                dict(int8=4 * M * c * hid),
                [(M, w1_q[0].t()), (M, w2_q[0].t())])}
        for name, (fn, ref, args, flt, fargs, ops, lib) in cases.items():
            got, want = fn(*args, dp=dp), ref(*args, dp=dp)
            f = flt(*fargs, dp=dp)
            r = rel_l2(got, want)
            rb = rel_l2(got.float() - x.float(), want.float() - x.float())
            rf = rel_l2(got, f)
            rfb = rel_l2(got.float() - x.float(), f.float() - x.float())
            pfb = rel_l2(want.float() - x.float(), f.float() - x.float())
            err = float((got.float() - want.float()).abs().max())
            print(f"{name} {tuple(x.shape)} ({label}): vs plain rel_l2 {r}, "
                  f"residual-branch rel_l2 {rb}, max_abs_err {err}, equal "
                  f"{float((got == want).float().mean())}; vs the bf16 "
                  f"kernel rel_l2 {rf}, residual-branch rel_l2 {rfb} (the "
                  f"plain int8 version's {pfb})")
            check(bool(torch.isfinite(got.float()).all()), f"{name} finite")
            check(max(r, rb) <= BLOCK_REL_L2,
                  f"{name} ({label}) rel L2 {max(r, rb)} <= {BLOCK_REL_L2}")
            check(rf <= Q8_FWD_REL,
                  f"{name} ({label}) vs bf16 rel L2 {rf} <= {Q8_FWD_REL}")
            check(rfb >= Q8_SPREAD * pfb,
                  f"{name} ({label}) quantizes: residual branch vs bf16 "
                  f"{rfb} >= {Q8_SPREAD} x the plain int8 version's {pfb}")
            res[name][label] = dict(
                max_abs_err=err, rel_l2=max(r, rb), float_rel_l2=rf,
                float_branch_rel_l2=rfb)
            if timed:
                res[name][label].update(
                    ms=cuda_ms(lambda: fn(*args, dp=dp)),
                    plain_ms=cuda_ms(lambda: ref(*args, dp=dp)),
                    library_ms=library_int_mm(lib),
                    **bound(nbytes(*args, dp, got), **ops))
            del got, want, f
        torch.cuda.empty_cache()
    return {k: dict(v.pop("serving"), **v) for k, v in res.items()}


def train_kernel_checks(dev, n=N, c=C, h=H, hid=HID, timed=True, quant=None,
                        S=2 * TRAIN_B):
    """K4 and K5 (with ``quant="int8dx"`` K4q and K5q: the int8 forward and
    the int8dx backward), forward and backward, against their plain
    versions at a training step's shapes: S = 2B = 192 sequences of n
    tokens (ATST-Frame base: 250, width 768, 12 heads; the dual step's
    encoders take B = 96 sequences of 160 tokens), bf16, ragged lengths and
    drop-path multipliers; with ``timed``, both times and the bounds as
    well. Under ``quant`` each is also held on the residual branch of y
    (y - x) to its plain version, and to the float kernels K4/K5 on the
    same inputs: within the JAX package's int8 budget, and on the residual
    branches of y and dx (dx - dy) at least ``Q8_SPREAD`` of the plain
    int8 version's distance from them."""
    from audiossl_tpu_torch.ops import attn_train as at
    from audiossl_tpu_torch.ops import mlp_train as mt
    from audiossl_tpu_torch.ops.quant import (dequantize_weight_q8,
                                              quantize_weight_q8)

    rng = np.random.RandomState(SEED + 2)
    bf = torch.bfloat16
    M = S * n

    def t(*shape, s=1.0, off=0.0, dtype=torch.float32):
        a = (rng.randn(*shape) * s + off).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    x = t(S, n, c, dtype=bf)
    ragged = [min(v, n) for v in (250, 200, 137, 64, 1, 0)]
    lengths = torch.tensor([ragged[i // 4 % 6] if i % 4 == 3 else n
                            for i in range(S)], device=dev)
    valid = (torch.arange(n, device=dev)[None] < lengths[:, None]).float()
    dp = torch.tensor([(0.0, 1.0, 1 / 0.9)[i % 3] for i in range(S)],
                      device=dev)
    w = t(S, n, c)  # cotangent of y
    dyb = w.to(bf)
    pairs = attn_pairs(lengths, n)
    params = {
        "attn_train": [t(c, s=0.1, off=1.0), t(c, s=0.1), t(3 * c, c, s=0.03),
                       t(3 * c, s=0.02), t(c, c, s=0.03), t(c, s=0.02)],
        "mlp_train": [t(c, s=0.1, off=1.0), t(c, s=0.1), t(hid, c, s=0.03),
                      t(hid, s=0.02), t(c, hid, s=0.03), t(c, s=0.02)]}

    def kernels(name, p):
        """(forward, backward) of the half as functions of ``plain``, the
        weights as the kernels read them, and the operations of each."""
        if quant:  # codes per output channel; of the dequantized weights
            # per input channel for the int8dx backward
            fq = [quantize_weight_q8(p[i]) for i in (2, 4)]
            bq = [quantize_weight_q8(dequantize_weight_q8(*q, bf), dim=0)
                  for q in fq]
            wts = [v for q in fq + bq for v in q]
        else:
            wts = [p[2].to(bf), p[4].to(bf)]
        if name == "attn_train":
            mm = 8 * M * c * c
            if quant:
                fwd = lambda plain: (at.attn_train_fwd_q8_ref if plain else at.attn_train_fwd_q8)(  # noqa: E731,E501
                    x, valid, dp, p[0], p[1], *fq[0], p[3], *fq[1], p[5], h)
                bwd = lambda plain, r: (at.attn_train_bwd_q8dx_ref if plain else at.attn_train_bwd_q8dx)(  # noqa: E731,E501
                    x, dyb, r[1], r[2], r[3], valid, dp, p[0], p[1], *bq[0],
                    *bq[1], h)
                ops = (dict(int8=mm, bf16=4 * c * pairs),
                       dict(int8=mm, bf16=mm + 10 * c * pairs))
                lib = ([(M, fq[0][0].t()), (M, fq[1][0].t())],
                       [(M, bq[1][0]), (M, bq[0][0])])
            else:
                fwd = lambda plain: (at.attn_train_fwd_ref if plain else at.attn_train_fwd)(  # noqa: E731,E501
                    x, valid, dp, *p, h)
                bwd = lambda plain, r: (at.attn_train_bwd_ref if plain else at.attn_train_bwd)(  # noqa: E731,E501
                    x, dyb, r[1], r[2], r[3], valid, dp, p[0], p[1], p[2],
                    p[4], h)
                ops = (dict(bf16=mm + 4 * c * pairs),
                       dict(bf16=2 * mm + 10 * c * pairs))
                # qkv, proj; dW_proj, do, dW_qkv, dh
                lib = ([("forward", M, 3 * c, c), ("forward", M, c, c)],
                       [("weight_grad", c, c, M), ("dx", M, c, c),
                        ("weight_grad", 3 * c, c, M), ("dx", M, c, 3 * c)])
        else:
            mm = 4 * M * c * hid
            if quant:
                fwd = lambda plain: (mt.mlp_train_fwd_q8_ref if plain else mt.mlp_train_fwd_q8)(  # noqa: E731,E501
                    x, dp, p[0], p[1], *fq[0], p[3], *fq[1], p[5])
                bwd = lambda plain, r: (mt.mlp_train_bwd_q8dx_ref if plain else mt.mlp_train_bwd_q8dx)(  # noqa: E731,E501
                    x, dyb, r[1], dp, p[0], p[1], *bq[0], *bq[1])
                ops = (dict(int8=mm), dict(int8=mm, bf16=mm))
                lib = ([(M, fq[0][0].t()), (M, fq[1][0].t())],
                       [(M, bq[1][0]), (M, bq[0][0])])
            else:
                fwd = lambda plain: (mt.mlp_train_fwd_ref if plain else mt.mlp_train_fwd)(  # noqa: E731,E501
                    x, dp, *p)
                bwd = lambda plain, r: (mt.mlp_train_bwd_ref if plain else mt.mlp_train_bwd)(  # noqa: E731,E501
                    x, dyb, r[1], dp, p[0], p[1], p[2], p[4])
                ops = (dict(bf16=mm), dict(bf16=2 * mm))
                # fc1, fc2; dW2, da, dW1, dh
                lib = ([("forward", M, hid, c), ("forward", M, c, hid)],
                       [("weight_grad", c, hid, M), ("dx", M, hid, c),
                        ("weight_grad", hid, c, M), ("dx", M, c, hid)])
        return fwd, bwd, wts, ops, lib

    def run(name, p, plain, q):
        xx = x.clone().requires_grad_()
        ps = [v.clone().requires_grad_() for v in p]
        if name == "attn_train":
            y = at.fused_attn_block(xx, valid, dp, *ps, h, plain=plain,
                                    quant=q)
        else:
            y = mt.fused_mlp_block(xx, dp, *ps, plain=plain, quant=q)
        (y.float() * w).sum().backward()
        return y.detach(), [xx.grad] + [v.grad for v in ps]

    sfx = ("_fwd_q8", "_bwd_q8dx") if quant else ("_fwd", "_bwd")
    res = {}
    for name, p in params.items():
        (yk, gk), (yp, gp) = run(name, p, False, quant), run(name, p, True,
                                                             quant)
        ry = rel_l2(yk, yp)
        rg = [rel_l2(a, b) for a, b in zip(gk, gp)]
        err_y = float((yk.float() - yp.float()).abs().max())
        err_dx = float((gk[0].float() - gp[0].float()).abs().max())
        label = f"{name}{' ' + quant if quant else ''}"
        print(f"{label} {tuple(x.shape)} bf16: y rel_l2 {ry}, max_abs_err "
              f"{err_y}; gradient rel_l2 (dx, dLN w, dLN b, dW_in, db_in, "
              f"dW_out, db_out) {rg}; dx max_abs_err {err_dx}")
        check(bool(torch.isfinite(yk.float()).all())
              and all(bool(torch.isfinite(g).all()) for g in gk),
              f"{label} output and gradients finite")
        check(ry <= BLOCK_REL_L2, f"{label} y rel L2 {ry} <= {BLOCK_REL_L2}")
        check(max(rg) <= BLOCK_REL_L2,
              f"{label} every gradient rel L2 {max(rg)} <= {BLOCK_REL_L2}")
        res[name + sfx[0]] = dict(max_abs_err=err_y, rel_l2=ry)
        res[name + sfx[1]] = dict(max_abs_err=err_dx, rel_l2=max(rg))
        if quant:  # residual branches; the int8 kernels against the float
            yf, gf = run(name, p, False, None)
            fy = rel_l2(yk, yf)
            fg = [rel_l2(a, b) for a, b in zip(gk, gf)]
            # y - x and dx - dy of the kernels, the plain int8 version and
            # the float kernels
            xf, dyf = x.float(), dyb.float()
            br = {"y": [v.float() - xf for v in (yk, yp, yf)],
                  "dx": [g[0].float() - dyf for g in (gk, gp, gf)]}
            rb = {k: rel_l2(v[0], v[1]) for k, v in br.items()}
            fb = {k: [rel_l2(v[0], v[2]), rel_l2(v[1], v[2])]
                  for k, v in br.items()}
            print(f"{label} residual branches vs plain: y - x rel_l2 "
                  f"{rb['y']}, dx - dy rel_l2 {rb['dx']}; vs the float "
                  f"kernels: y rel_l2 {fy}; gradient rel_l2 {fg}; residual "
                  f"branches (kernel, plain int8) y - x {fb['y']}, dx - dy "
                  f"{fb['dx']}")
            check(rb["y"] <= BLOCK_REL_L2, f"{label} y residual branch rel "
                  f"L2 {rb['y']} <= {BLOCK_REL_L2}")
            check(fy <= Q8_FWD_REL,
                  f"{label} y vs float rel L2 {fy} <= {Q8_FWD_REL}")
            check(max(fg) <= Q8_GRAD_REL, f"{label} every gradient vs float "
                  f"rel L2 {max(fg)} <= {Q8_GRAD_REL}")
            for k, (kf, pf) in fb.items():
                check(kf >= Q8_SPREAD * pf,
                      f"{label} quantizes: {k} residual branch vs float {kf}"
                      f" >= {Q8_SPREAD} x the plain int8 version's {pf}")
            res[name + sfx[0]].update(rel_l2=max(ry, rb["y"]),
                                      float_rel_l2=fy,
                                      float_branch_rel_l2=fb["y"][0])
            res[name + sfx[1]].update(float_rel_l2=max(fg),
                                      dx_branch_rel_l2=rb["dx"],
                                      float_branch_rel_l2=fb["dx"][0])
            del yf, gf, br
        del yk, gk, yp, gp
        if timed:
            card_state(f"{label} timing")
            fwd, bwd, wts, ops, lib = kernels(name, p)
            fres = fwd(False)
            bres = bwd(False, fres)
            small = [v for v in p if v.ndim == 1]
            vk = [valid] if name == "attn_train" else []
            fin = nbytes(x, *vk, dp, *small, *wts[:4 if quant else 2])
            bin_ = nbytes(x, dyb, *fres[1:], *vk, dp, *p[:2], *wts[4:],
                          *(wts if not quant else []))
            for key, f, pf, nb, op, lb in (
                    (sfx[0], lambda: fwd(False), lambda: fwd(True),
                     fin + nbytes(*fres), ops[0], lib[0]),
                    (sfx[1], lambda: bwd(False, fres),
                     lambda: bwd(True, fres), bin_ + nbytes(*bres), ops[1],
                     lib[1])):
                res[name + key].update(
                    ms=cuda_ms(f, iters=10), plain_ms=cuda_ms(pf, iters=10),
                    library_ms=(library_int_mm(lb) if quant
                                else library_mm(lb, dev)),
                    **bound(nb, **op))
            del fres, bres
        torch.cuda.empty_cache()
    return res


def library_int_mm(products):
    """``int_mm_ms`` of a kernel's int8 products [(rows, weight codes as
    [K, N])], on int8 activation codes of the same shapes; None where the
    kernel has none. The weight is copied column-major first (cuBLASLt's
    int8 layout)."""
    if not products:
        return None
    pairs = [(torch.randint(-127, 128, (m, wk.shape[0]), dtype=torch.int8,
                            device=wk.device), wk.t().contiguous().t())
             for m, wk in products]
    try:
        return int_mm_ms(pairs)
    except RuntimeError as exc:  # a layout cuBLASLt refuses: not timed
        print(f"torch._int_mm refused {[tuple(w.shape) for _, w in pairs]}:"
              f" {exc}")
        return None


def library_mm(products, dev):
    """CUDA-event time of ``torch.matmul`` in bf16 (cuBLAS) over a bf16
    block kernel's products alone [(layout, m, n, k)], on seeded operands
    stored as the kernel reads them (``gemm_operands``): the library call
    for its products, not for its whole function."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    pairs = [gemm_operands(*p, gen, dev)[2:] for p in products]
    return cuda_ms(lambda: [torch.matmul(a, b) for a, b in pairs], iters=10)


def clip_block_checks(dev, n):
    """K2-K5, and K4q/K5q (int8 forward, int8dx backward), against their
    plain versions at the ATST-Clip small step's shapes: 192 sequences of
    ``n`` tokens (the CLS token and the patches: 151 for 6 s crops, 226 for
    the CLI's 9 s), width 384, 6 heads, hidden 1536, bf16 (K2q/K3q at 151
    tokens: ``q8_infer_checks``)."""
    rng = np.random.RandomState(SEED + 11)
    S = 2 * TRAIN_B

    def t(*shape, s=1.0, off=0.0, dtype=torch.float32):
        a = (rng.randn(*shape) * s + off).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    x = t(S, n, CLIP_C, dtype=torch.bfloat16)
    ragged = [n, 126, 77, 1]
    lengths = torch.tensor([ragged[i // 4 % 4] if i % 4 == 1 else n
                            for i in range(S)], device=dev)
    valid = (torch.arange(n, device=dev)[None] < lengths[:, None]).float()
    dp = torch.tensor([(1.0, 0.0, 1 / 0.9)[i % 3] for i in range(S)],
                      device=dev)
    res = infer_block_checks(t, x, valid, dp, CLIP_H, 4 * CLIP_C,
                             timed=False)
    for quant in (None, "int8dx"):
        res.update(train_kernel_checks(dev, n, CLIP_C, CLIP_H,
                                       4 * CLIP_C, timed=False, quant=quant))
    return res


def d128_checks(dev):
    """K2 and K2q at head dim 128 (the D = 128 template of the forward
    attention core, which no main path here reaches): bf16 [8, 97, 512], 4
    heads, ragged lengths with one sequence with no valid key (uniform
    attention), against their plain versions on the output and on the
    residual branch y - x; untimed."""
    from audiossl_tpu_torch.ops import block_infer as bi
    from audiossl_tpu_torch.ops.quant import quantize_weight_q8

    rng = np.random.RandomState(SEED + 15)
    S, n, c, h, bf = 8, 97, 512, 4, torch.bfloat16

    def t(*shape, s=1.0, off=0.0, dtype=torch.float32):
        a = (rng.randn(*shape) * s + off).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    x = t(S, n, c, dtype=bf)
    lengths = torch.tensor([97, 60, 0, 1, 97, 33, 96, 97], device=dev)
    valid = (torch.arange(n, device=dev)[None] < lengths[:, None]).float()
    dp = torch.tensor([1, 0, 1 / 0.9, 1, 1, 1 / 0.9, 0, 1], device=dev,
                      dtype=torch.float32)
    ln = (t(c, s=0.1, off=1.0), t(c, s=0.1))
    w_qkv, w_proj = t(3 * c, c, s=0.05), t(c, c, s=0.05)
    b_qkv, b_proj = t(3 * c, s=0.02), t(c, s=0.02)
    res = {}
    for name, fn, ref, args in (
            ("attn_block", bi.attn_block_infer, bi.attn_block_infer_ref,
             (x, valid, *ln, w_qkv.to(bf), b_qkv, w_proj.to(bf), b_proj, h)),
            ("attn_block_q8", bi.attn_block_infer_q8,
             bi.attn_block_infer_q8_ref,
             (x, valid, *ln, *quantize_weight_q8(w_qkv), b_qkv,
              *quantize_weight_q8(w_proj), b_proj, h))):
        got, want = fn(*args, dp=dp), ref(*args, dp=dp)
        r = rel_l2(got, want)
        rb = rel_l2(got.float() - x.float(), want.float() - x.float())
        err = float((got.float() - want.float()).abs().max())
        print(f"{name} {tuple(x.shape)} H={h} (head dim 128): rel_l2 {r}, "
              f"residual-branch rel_l2 {rb}, max_abs_err {err}")
        check(bool(torch.isfinite(got.float()).all()), f"{name} D=128 finite")
        check(max(r, rb) <= BLOCK_REL_L2,
              f"{name} D=128 rel L2 {max(r, rb)} <= {BLOCK_REL_L2}")
        res[name] = dict(max_abs_err=err, rel_l2=max(r, rb))
    return res


def sdpa_library(qkv, valid, g, h, scale):
    """K6's library call, timed: ``F.scaled_dot_product_attention`` on the
    q, k, v views of qkv with the boolean key mask (the same function on
    every sequence with a valid key; a sequence with none gets a full mask
    here, since SDPA has no defined output there), forward and its autograd
    backward to qkv from g. Returns (forward ms, backward ms, the backend
    PyTorch's dispatcher picks, SDPA's output as [S, n, C])."""
    from torch.nn.attention import SDPBackend

    S, n, c3 = qkv.shape
    d = c3 // 3 // h
    x = qkv.detach().requires_grad_()
    q, k, v = x.view(S, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    keep = valid.bool()
    keep[~keep.any(dim=1)] = True
    mask = keep[:, None, None, :]
    backend = SDPBackend(torch._fused_sdp_choice(
        q, k, v, mask, 0.0, False, scale=scale)).name

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)

    out = fwd()
    go = g.view(S, n, h, d).transpose(1, 2)
    fwd_ms = cuda_ms(fwd, iters=10)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, x, go,
                                                 retain_graph=True), iters=10)
    return fwd_ms, bwd_ms, backend, out.detach().transpose(1, 2).reshape(
        S, n, c3 // 3)


def mha_kernel_checks(dev):
    """K6 forward and backward against its plain version at the shapes of
    the training steps: f32 at ATST-Clip small's ([192, 151, 3 * 384], 6
    heads), ATST-Frame base's ([192, 250, 3 * 768], 12 heads) and the dual
    small step's ([96, 160, 3 * 384], 6 heads), bf16 at ATST-Frame base's,
    each timed beside its library call (``sdpa_library``); untimed, f32 at
    the ddp_dual phase's rank and 1-rank steps ([8 or 16, 160, 3 * 384]);
    and, untimed, both dtypes at [16, 97, 3 * 256] with 8 heads of 32 (the
    other head-dim instantiation, and tile edges that are no multiple of
    16);
    some sequences short and one with no valid key, whose output and
    gradient must be 0. The backward of both versions reads the plain
    forward's out and r. The first case is the one the summary line
    reports at its top level."""
    from audiossl_tpu_torch.ops import mha

    rng = np.random.RandomState(SEED + 6)
    res = {}
    f32, bf = torch.float32, torch.bfloat16
    for label, dtype, S, n, c, h, tol, timed in (
            ("f32", f32, 2 * TRAIN_B, CLIP_N, CLIP_C, CLIP_H, MHA_F32_REL,
             True),
            ("f32_frame", f32, 2 * TRAIN_B, N, C, H, MHA_F32_REL, True),
            ("bf16", bf, 2 * TRAIN_B, N, C, H, BLOCK_REL_L2, True),
            ("f32_dual", f32, TRAIN_B, DUAL_N, CLIP_C, CLIP_H, MHA_F32_REL,
             True),
            ("f32_dual_ddp_rank", f32, DUAL_DDP_B // DDP_RANKS, DUAL_N,
             CLIP_C, CLIP_H, MHA_F32_REL, False),
            ("f32_dual_ddp_one_rank", f32, DUAL_DDP_B, DUAL_N, CLIP_C, CLIP_H,
             MHA_F32_REL, False),
            ("f32_d32", f32, 16, 97, 256, 8, MHA_F32_REL, False),
            ("bf16_d32", bf, 16, 97, 256, 8, BLOCK_REL_L2, False)):
        name = f"K6 mha {label}"
        qkv = torch.from_numpy(rng.randn(S, n, 3 * c).astype(
            np.float32)).to(dev, dtype)
        g = torch.from_numpy(rng.randn(S, n, c).astype(np.float32)).to(
            dev, dtype)
        ragged = [n - 1, min(100, n), 17, 1]
        lengths = torch.tensor([ragged[i // 4 % 4] if i % 4 == 1 else n
                                for i in range(S)], device=dev)
        lengths[5] = 0  # a sequence with no valid key
        valid = (torch.arange(n, device=dev)[None] < lengths[:, None]).float()
        scale = (c // h) ** -0.5
        out, r = mha.mha_fwd(qkv, valid, h, scale)
        out_p, r_p = mha.mha_fwd_ref(qkv, valid, h, scale)
        dq = mha.mha_bwd(qkv, valid, out_p, r_p, g, h, scale)
        dq_p = mha.mha_bwd_ref(qkv, valid, out_p, r_p, g, h, scale)
        live = lengths > 0
        errs = {"out": rel_l2(out, out_p), "r": rel_l2(r[live], r_p[live]),
                "dqkv": rel_l2(dq, dq_p)}
        err_o = float((out.float() - out_p.float()).abs().max())
        print(f"{name} {tuple(qkv.shape)} H={h}: rel_l2 {errs}, out "
              f"max_abs_err {err_o}, dqkv max_abs_err "
              f"{float((dq.float() - dq_p.float()).abs().max())}")
        check(bool(torch.isfinite(out.float()).all())
              and bool(torch.isfinite(dq.float()).all()),
              f"{name} output and gradient finite")
        check(max(errs.values()) <= tol,
              f"{name} rel L2 {max(errs.values())} <= {tol}")
        check(not bool(out[5].any()) and not bool(dq[5].any()),
              f"{name} output and gradient 0 for the sequence with no "
              "valid key")
        res[label] = dict(
            fwd=dict(max_abs_err=err_o, rel_l2=max(errs["out"], errs["r"])),
            bwd=dict(max_abs_err=float((dq.float() - dq_p.float()).abs().max()),
                     rel_l2=errs["dqkv"]))
        if timed:  # the training steps' shapes
            # K6 masks by key validity alone: a sequence with no valid key
            # needs no pair; f32 products count as three TF32 passes
            # (PEAK_OPS), so no f32 kernel can beat its bound
            pairs = n * int(lengths.sum())
            kind, passes = (("tf32", 3) if dtype == torch.float32
                            else ("bf16", 1))
            n_fwd, n_bwd = passes * 4 * c * pairs, passes * 10 * c * pairs
            lib_fwd, lib_bwd, backend, lib_out = sdpa_library(
                qkv, valid, g, h, scale)
            print(f"{name} library call: scaled_dot_product_attention, "
                  f"backend {backend}; output rel_l2 to K6 on sequences with "
                  f"a valid key {rel_l2(lib_out[live], out[live])}")
            res[label]["fwd"].update(
                ms=cuda_ms(lambda: mha.mha_fwd(qkv, valid, h, scale),
                           iters=10),
                plain_ms=cuda_ms(lambda: mha.mha_fwd_ref(qkv, valid, h, scale),
                                 iters=10),
                library_ms=lib_fwd, library_backend=backend,
                **bound(nbytes(qkv, valid, out, r), **{kind: n_fwd}))
            res[label]["bwd"].update(
                ms=cuda_ms(lambda: mha.mha_bwd(qkv, valid, out_p, r_p, g, h,
                                               scale), iters=10),
                plain_ms=cuda_ms(lambda: mha.mha_bwd_ref(
                    qkv, valid, out_p, r_p, g, h, scale), iters=10),
                library_ms=lib_bwd, library_backend=backend,
                **bound(nbytes(qkv, valid, out_p, r_p, g, dq),
                        **{kind: n_bwd}))
            del lib_out
        del qkv, g, out, r, out_p, r_p, dq, dq_p
        torch.cuda.empty_cache()
    main = res.pop("f32")
    return {f"mha_{d}": dict(main[d], **{k: v[d] for k, v in res.items()})
            for d in ("fwd", "bwd")}


def ln_kernel_checks(dev):
    """K8 against its plain version in f32 and bf16 at the rows of the
    ATST-Clip small step ([192 * 151, 384]) and of the ATST-Frame base step
    ([192 * 250, 768]), timed by CUDA events and in device time beside
    aten's LayerNorm backward; then untimed in bf16 at the rows of the clip
    CLI's step ([192 * 226, 384]), of the ddp_frame phase's steps
    ([32 * 250, 768] a rank, [64 * 250, 768] the 1-rank step), in f32 and
    bf16 at the dual small step's ([96 * 160, 384]), in f32 at the
    ddp_dual phase's ([8 or 16 * 160, 384]), and at 97
    rows of widths 100, 200,
    1000 and 1023 (16-byte vectors that do not fill the lanes, single
    elements where a row is not a whole number of 16-byte vectors). The
    first case is the one the summary line reports at its top level."""
    from audiossl_tpu_torch.ops import layer_norm as ln

    rng = np.random.RandomState(SEED + 7)
    S = 2 * TRAIN_B
    f32, bf = torch.float32, torch.bfloat16
    cases = [("f32", f32, S * CLIP_N, CLIP_C, MHA_F32_REL, True),
             ("f32_frame", f32, S * N, C, MHA_F32_REL, True),
             ("bf16_clip", bf, S * CLIP_N, CLIP_C, BLOCK_REL_L2, True),
             ("bf16", bf, S * N, C, BLOCK_REL_L2, True),
             ("bf16_clip_cli", bf, S * CLI_CLIP_N, CLIP_C, BLOCK_REL_L2,
              False),
             # the ddp_frame phase's rank (2 x 16 sequences) and 1-rank
             # (2 x 32) steps
             ("bf16_ddp_rank", bf, 2 * DDP_B // DDP_RANKS * N, C,
              BLOCK_REL_L2, False),
             ("bf16_ddp_one_rank", bf, 2 * DDP_B * N, C, BLOCK_REL_L2,
              False),
             # the dual small step's encoders (96 sequences of 160 tokens)
             # and the ddp_dual phase's rank and 1-rank f32 steps
             ("f32_dual", f32, TRAIN_B * DUAL_N, CLIP_C, MHA_F32_REL, False),
             ("bf16_dual", bf, TRAIN_B * DUAL_N, CLIP_C, BLOCK_REL_L2, False),
             ("f32_dual_ddp_rank", f32, DUAL_DDP_B // DDP_RANKS * DUAL_N,
              CLIP_C, MHA_F32_REL, False),
             ("f32_dual_ddp_one_rank", f32, DUAL_DDP_B * DUAL_N, CLIP_C,
              MHA_F32_REL, False)]
    cases += [(f"{n}_97x{c}", dt, 97, c, tol, False) for c in (100, 200,
                                                                1000, 1023)
              for n, dt, tol in (("f32", f32, MHA_F32_REL),
                                 ("bf16", bf, BLOCK_REL_L2))]
    res = {}
    for label, dtype, rows, c, tol, timed in cases:
        x = torch.from_numpy((rng.randn(rows, c) * 2.0 + 0.3).astype(
            np.float32)).to(dev, dtype)
        g = torch.from_numpy(rng.randn(rows, c).astype(np.float32)).to(
            dev, dtype)
        sc = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(dev)
        got = ln.ln_bwd(x, g, sc, 1e-6)
        want = ln.ln_bwd_ref(x, g, sc, 1e-6)
        errs = [rel_l2(a, b) for a, b in zip(got, want)]
        err = float((got[0].float() - want[0].float()).abs().max())
        print(f"K8 ln_pg_bwd [{rows}, {c}] {label}: rel_l2 (dx, "
              f"dscale, dbias) {errs}, dx max_abs_err {err}")
        check(all(bool(torch.isfinite(t.float()).all()) for t in got),
              "K8 gradients finite")
        check(max(errs) <= tol, f"K8 rel L2 {max(errs)} <= {tol}")
        res[label] = dict(max_abs_err=err, rel_l2=max(errs))
        if not timed:
            continue
        # the library call: aten's LayerNorm backward from the statistics
        # its forward saves (computed outside the timing)
        wb = (sc.to(dtype), torch.zeros_like(sc, dtype=dtype))
        _, mean, rstd = torch.native_layer_norm(x, [c], *wb, 1e-6)
        lib_args = (g, x, [c], mean, rstd, *wb, [True, True, True])

        def lib():
            torch.ops.aten.native_layer_norm_backward(*lib_args)

        def kernel():
            ln.ln_bwd(x, g, sc, 1e-6)

        r = res[label]
        r.update(ms=cuda_ms(kernel, iters=10),
                 device_ms=device_ms(kernel, ("ln_pg_",), launches=2),
                 plain_ms=cuda_ms(lambda: ln.ln_bwd_ref(x, g, sc, 1e-6),
                                  iters=10),
                 library_ms=cuda_ms(lib, iters=10),
                 library_device_ms=device_ms(lib),
                 **bound(nbytes(x, g, sc, *got), f32=10 * rows * c))
        print(f"K8 [{rows}, {c}] {label}: {r['ms']} ms (CUDA events), "
              f"{r['device_ms']} ms (device); aten {r['library_ms']} ms, "
              f"{r['library_device_ms']} ms (device); bound {r['bound_ms']}"
              " ms")
        del lib_args
        del x, g, got, want
    return {"ln_pg_bwd": dict(res.pop("f32"), **res)}


def adamw_ema_check(dev, shapes, teacher_leaves, decay, timed=True):
    """K7 against its plain version over leaves of the given shapes (the
    teacher holds the leaves flagged in ``teacher_leaves``), through one
    ``LeafTable`` as the training step keeps it: the first call builds the
    table, the next two reuse it under ``set_sync_debug_mode("error")``,
    which raises if the launch path synchronizes the host with the device.
    After each, the count of elements of p, mu, nu and t that differ from
    the plain version's (0: bit-equal) and the worst relative error (max
    |kernel - plain| / max |plain| per state tensor). With ``timed``, the
    time per call by CUDA events over back-to-back calls (host included),
    the device time and the host's own time to issue a call."""
    from audiossl_tpu_torch.ops import adamw_ema as ae

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def state():
        r = lambda s, sc: torch.randn(s, device=dev, generator=gen) * sc  # noqa: E731
        p = [r(s, 0.02) for s in shapes]
        g = [r(s, 1e-3) for s in shapes]
        mu = [r(s, 1e-4) for s in shapes]
        nu = [r(s, 1e-6).abs() for s in shapes]
        tt = [r(s, 0.02) if keep else None
              for s, keep in zip(shapes, teacher_leaves)]
        return p, g, mu, nu, tt

    sc = ae.update_scalars(8e-5, 0.04, 0.9996, 7, 0.9, 0.999, 1e-6)
    a = state()
    b = [[None if v is None else v.clone() for v in lst] for lst in a]
    table = ae.LeafTable()

    def kernel():
        ae.adamw_ema(*a, decay, sc, table=table)

    def compare(what):
        worst, diff = 0.0, 0
        for la, lb in zip((a[0], a[2], a[3], a[4]), (b[0], b[2], b[3], b[4])):
            for u, v in zip(la, lb):
                if u is not None:
                    worst = max(worst, float((u - v).abs().max()
                                             / v.abs().max().clamp_min(1e-30)))
                    diff += int((u != v).sum())
        n = sum(int(np.prod(s)) for s in shapes)
        print(f"K7 adamw_ema {what}, {len(shapes)} leaves, {n} elements "
              f"({sum(teacher_leaves)} with a teacher copy): {diff} "
              f"mismatched elements, max rel error {worst}")
        check(worst <= ADAMW_REL, f"K7 max rel error {worst} <= {ADAMW_REL}")
        check(diff == 0, f"K7 bit-equal to the plain version ({diff} "
              "mismatched elements)")
        return worst, diff

    kernel()
    ae.adamw_ema_ref(*b, decay, sc)
    compare("first call (table built)")
    built = table.table
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            kernel()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(table.table is built, "K7 reused its device table")
    print("ok: K7's second and third calls made no synchronizing call")
    for _ in range(2):
        ae.adamw_ema_ref(*b, decay, sc)
    worst, diff = compare("third call (cached table)")
    if not timed:
        return None
    # reads p, g, mu, nu (and the teacher's copy), writes p, mu, nu (and
    # the teacher's); ~20 f32 operations per element
    n = sum(int(np.prod(s)) for s in shapes)
    n_t = sum(int(np.prod(s)) for s, k in zip(shapes, teacher_leaves) if k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        kernel()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    res = dict(max_abs_err=worst, mismatches=diff,
               ms=cuda_ms(kernel, iters=10),
               device_ms=device_ms(kernel, ("adamw_ema_kernel",)),
               host_ms=host_ms,
               plain_ms=cuda_ms(lambda: ae.adamw_ema_ref(*b, decay, sc),
                                iters=10),
               library_ms=None,
               **bound(4 * (7 * n + 2 * n_t), f32=20 * n))
    print(f"K7 adamw_ema: {res['ms']} ms (CUDA events, back to back), "
          f"{res['device_ms']} ms (device), host {host_ms} ms to issue a "
          f"call; bound {res['bound_ms']} ms")
    return res


def write_base_ckpt(workdir):
    """A seeded random ATST-Frame base encoder as a reference-layout
    ``.ckpt`` in workdir; returns its path."""
    from audiossl_tpu_torch.models.atst import frame_ast_base

    enc = frame_ast_base(spec_w=1001, device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    path = os.path.join(workdir, "atstframe_base.ckpt")
    torch.save({"state_dict": {f"model.teacher.encoder.{k}": v
                               for k, v in enc.state_dict().items()},
                "hyper_parameters": {"arch": "base"}}, path)
    return path


def serving_audio():
    """8 clips of 10 s and one of 160,320 samples, seeded."""
    rng = np.random.RandomState(SEED + 1)
    return ((rng.randn(B, SAMPLES) * 0.1).astype(np.float32),
            (rng.randn(1, LONG) * 0.1).astype(np.float32))


def main_path(dev, path):
    """The public embedding API at ATST-Frame base width, through the
    kernels; returns the launch counts of that run."""
    from audiossl_tpu_torch.embedding import (get_scene_embedding,
                                              get_timestamp_embedding,
                                              load_model)
    from audiossl_tpu_torch.kernels import build as kb

    from audiossl_tpu_torch.ops import mel_db as md
    from audiossl_tpu_torch.ops.melspec import mel_filterbank

    fused = load_model(path, fused=True, device=dev)
    plain = load_model(path, fused=False, device=dev)
    wav8, wav1 = serving_audio()
    # as in a fresh process: serving builds its filterbank (under its
    # inference mode) and K1's band table itself
    mel_filterbank.cache_clear()
    md._TABLES.clear()

    torch.cuda.synchronize()
    kb.reset_launches()
    scene8 = get_scene_embedding(wav8, fused)
    scene1 = get_scene_embedding(wav1, fused)
    ts1, tms = get_timestamp_embedding(wav1, fused)
    torch.cuda.synchronize()
    launches = dict(kb.LAUNCHES)
    print(f"main path launches (3 forwards): {launches}")
    check([e[0].is_inference() for e in md._TABLES.values()] == [True],
          "serving built one filterbank, an inference tensor, and its table")
    check(launches["mel_db"] >= 3, "mel kernel launched in every forward")
    check(launches["attn_block"] == 3 * 12 and launches["mlp_block"] == 3 * 12,
          "12 attention and 12 MLP block launches per forward")

    check(tuple(scene8.shape) == (B, 12 * C), f"scene shape {tuple(scene8.shape)}")
    check(tuple(scene1.shape) == (1, 12 * C), f"long-clip scene shape {tuple(scene1.shape)}")
    check(tuple(ts1.shape) == (1, 500, 12 * C), f"timestamp shape {tuple(ts1.shape)}")
    check(tuple(tms.shape) == (1, 500) and float(tms[0, 1] - tms[0, 0]) == 40.0,
          "timestamps every 40 ms")
    for name, v in (("scene", scene8), ("long scene", scene1), ("timestamp", ts1)):
        check(bool(torch.isfinite(v).all()), f"{name} embedding finite")

    p8 = get_scene_embedding(wav8, plain)
    p1 = get_scene_embedding(wav1, plain)
    pts, _ = get_timestamp_embedding(wav1, plain)
    cs8, cs1, cts = row_cos(scene8, p8), row_cos(scene1, p1), row_cos(ts1, pts)
    # Timestamp rows 250..499 come from the second chunk, which holds no
    # valid token (2 frames of audio, no whole patch): padding, not audio.
    # There the block kernels attend uniformly over all keys (the TPU
    # kernel's rule, pallas_block.py:319-325) while the module path takes
    # the softmax over keys that all carry the -10000 mask; the JAX
    # package's two paths differ there in the same way. Those rows are
    # reported and held to finiteness only.
    print(f"cosine fused vs plain f32: scene min {float(cs8.min())}, long "
          f"scene {float(cs1.min())}, timestamp rows with audio min "
          f"{float(cts[:250].min())}, padding rows of the chunk with no "
          f"valid token min {float(cts[250:].min())}")
    for name, cs in (("scene", cs8), ("long scene", cs1),
                     ("timestamp (rows with audio)", cts[:250])):
        check(float(cs.min()) >= COS_MIN,
              f"{name} per-row cosine {float(cs.min())} >= {COS_MIN}")

    cpu = load_model(path, fused=False, device="cpu")
    c1 = get_scene_embedding(wav8[:1], cpu)
    d = float((p8[:1].cpu() - c1).abs().max())
    print(f"plain f32 card vs CPU, 1 clip: max abs diff {d}, cosine "
          f"{float(row_cos(p8[:1].cpu(), c1).min())}")
    check(d <= CPU_ATOL, f"plain path on the card matches the CPU within {CPU_ATOL}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30} GiB")

    # utils/plot.py without a path (no matplotlib on the card's machine):
    # the last block's maps (their values are held against JAX's in the
    # CPU tests)
    from audiossl_tpu_torch.ops.melspec import log_melspec
    from audiossl_tpu_torch.utils.plot import plot_attention

    wav = torch.from_numpy(wav8).to(dev)
    valid = torch.full((B,), SAMPLES, device=dev)
    mel = log_melspec(wav, valid, plain.mel)
    length = valid // plain.mel.hop_length + 1
    maps = plot_attention(plain.encoder, mel, length)
    check(maps.shape == (B, H, N, N) and np.isfinite(maps).all(),
          f"plot_attention's maps {maps.shape} finite, (B, H, N, N) on the "
          "card")

    # scene-embedding throughput, in turns: plain, fused, fused, plain
    rates = {"plain_f32": [], "fused_bf16": []}
    for label in ("plain_f32", "fused_bf16", "fused_bf16", "plain_f32"):
        model = plain if label == "plain_f32" else fused
        for _ in range(2):
            get_scene_embedding(wav8, model)
        torch.cuda.synchronize()
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            get_scene_embedding(wav8, model)
        torch.cuda.synchronize()
        rates[label].append(reps * B / (time.perf_counter() - t0))
    print(json.dumps({"scene_clips_per_s_B8": rates}))
    return launches


def q8_serving_path(dev, path):
    """int8 serving: ``load_model(fused=True, quant="int8")`` (K1, K2q,
    K3q) on the same checkpoint and audio as the serving phase, held to
    ``load_model(fused=True)`` (K1-K3) per row with audio; both rates in
    turns. Returns the launch counts of the int8 run."""
    from audiossl_tpu_torch.embedding import (get_scene_embedding,
                                              get_timestamp_embedding,
                                              load_model)
    from audiossl_tpu_torch.kernels import build as kb

    q8 = load_model(path, fused=True, quant="int8", device=dev)
    fused = load_model(path, fused=True, device=dev)
    wav8, wav1 = serving_audio()

    torch.cuda.synchronize()
    kb.reset_launches()
    scene8 = get_scene_embedding(wav8, q8)
    scene1 = get_scene_embedding(wav1, q8)
    ts1, _ = get_timestamp_embedding(wav1, q8)
    torch.cuda.synchronize()
    launches = dict(kb.LAUNCHES)
    print(f"int8 serving launches (3 forwards): {launches}")
    check(launches["mel_db"] >= 3, "mel kernel launched in every forward")
    check(launches["attn_block_q8"] == 3 * 12
          and launches["mlp_block_q8"] == 3 * 12,
          "12 K2q and 12 K3q launches per forward")
    check(not any(v for k, v in launches.items()
                  if k not in ("mel_db", "attn_block_q8", "mlp_block_q8")),
          "no other kernel launched")
    check(tuple(scene8.shape) == (B, 12 * C)
          and tuple(scene1.shape) == (1, 12 * C)
          and tuple(ts1.shape) == (1, 500, 12 * C), "int8 embedding shapes")
    for name, v in (("scene", scene8), ("long scene", scene1),
                    ("timestamp", ts1)):
        check(bool(torch.isfinite(v).all()), f"int8 {name} embedding finite")
    f8 = get_scene_embedding(wav8, fused)
    f1 = get_scene_embedding(wav1, fused)
    fts, _ = get_timestamp_embedding(wav1, fused)
    # rows 250..499 of the timestamp embedding: the chunk with no valid
    # token (main_path), not audio
    cos = {"scene": row_cos(scene8, f8), "long scene": row_cos(scene1, f1),
           "timestamp (rows with audio)": row_cos(ts1, fts)[:250]}
    print("cosine int8 vs bf16 serving, lowest per row: "
          + ", ".join(f"{k} {float(v.min())}" for k, v in cos.items()))
    for name, cs in cos.items():
        check(float(cs.min()) >= Q8_COS_MIN,
              f"int8 {name} per-row cosine {float(cs.min())} >= {Q8_COS_MIN}")

    rates = {"fused_bf16": [], "int8": []}
    for label in ("fused_bf16", "int8", "int8", "fused_bf16"):
        model = q8 if label == "int8" else fused
        for _ in range(2):
            get_scene_embedding(wav8, model)
        torch.cuda.synchronize()
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            get_scene_embedding(wav8, model)
        torch.cuda.synchronize()
        rates[label].append(reps * B / (time.perf_counter() - t0))
    print(json.dumps({"int8_scene_clips_per_s_B8": rates}))
    return launches


def clip_infer_path(dev):
    """The clip encoder's inference path at ATST-Clip small width (384, 12
    blocks, 6 heads, CLS token), seeded weights: ``get_intermediate_layers``
    (scene, all 12 blocks) of 8 ragged 6 s crops through K1 and the block
    kernels (``fused=True``, bf16) against the module path in f32, per row;
    returns the launch counts of the kernel run."""
    from audiossl_tpu_torch.kernels import build as kb
    from audiossl_tpu_torch.models.atst import ast_small
    from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec

    rng = np.random.RandomState(SEED + 16)
    samples = 96000  # 6 s: 601 frames, 150 patches and the CLS token
    wav = torch.from_numpy((rng.randn(B, samples) * 0.1).astype(
        np.float32)).to(dev)
    valid = torch.tensor([96000, 64000, 32000, 15600, 96000, 48000, 6000,
                          96000], device=dev)
    length = valid // 160 + 1
    models = {fused: ast_small(spec_w=601, fused=fused, device=dev,
                               dtype=torch.bfloat16 if fused else
                               torch.float32,
                               generator=torch.Generator().manual_seed(SEED))
              for fused in (True, False)}
    with torch.inference_mode():
        torch.cuda.synchronize()
        kb.reset_launches()
        mel = log_melspec(wav, valid, MelConfig())
        got = models[True].get_intermediate_layers(mel, length, n=12)
        torch.cuda.synchronize()
        launches = dict(kb.LAUNCHES)
        want = models[False].get_intermediate_layers(mel, length, n=12)
    print(f"clip inference launches: {launches}")
    check(launches["mel_db"] == 1 and launches["attn_block"] == 12
          and launches["mlp_block"] == 12,
          "clip inference: K1 once, 12 K2 and 12 K3 launches")
    check(tuple(got.shape) == (B, 12 * CLIP_C)
          and bool(torch.isfinite(got).all()),
          f"clip scene embedding shape {tuple(got.shape)}, finite")
    cs = row_cos(got, want)
    print(f"clip inference (ast_small, {tuple(mel.shape)}, patches "
          f"{(length // 4).tolist()}): cosine fused bf16 vs plain f32 per "
          f"row {cs.tolist()}")
    check(float(cs.min()) >= COS_MIN,
          f"clip scene per-row cosine {float(cs.min())} >= {COS_MIN}")
    return launches


# The linear probe (``downstream/train_freeze.py``) at ATST-Clip and
# ATST-Frame base width: an audioset_b pack of tone clips of 1-12 s, 12 s
# crops, 64 clips a batch, 20 epochs of the probe
PROBE_SPLITS = (("train", 256), ("valid", 64), ("test", 64))
PROBE_B, PROBE_CROP_S, PROBE_EPOCHS = 64, 12.0, 20
PROBE_ARCH, PROBE_BLOCKS = "base", 12  # the encoder, its blocks read
PROBE_ATOL, PROBE_COS = 2e-4, 0.99999  # f32 card vs f32 CPU, TF32 off


def write_probe_pack(workdir):
    """The seeded ``audioset_b`` pack both probe paths read (527 labels,
    multi-label, tone clips of 1-12 s); returns its directory."""
    from audiossl_tpu_torch.datasets import (PackedAudioDataset,
                                             write_synthetic_pack)

    data = os.path.join(workdir, "audioset_b")
    t0 = time.perf_counter()
    for i, (split, n) in enumerate(PROBE_SPLITS):
        write_synthetic_pack(data, split, n, min_s=1.0, max_s=12.0,
                             num_labels=527, multi_label=True,
                             seed=SEED + 20 + i, kind="tones")
    reader = PackedAudioDataset(data, "test").reader
    long = sum(reader.num_samples(i) > 6 * 16000 for i in range(len(reader)))
    print(f"probe pack written in {time.perf_counter() - t0:.1f} s; "
          f"{long} of {len(reader)} test clips longer than 6 s")
    check(long > 0, "some probe clips are longer than one 6 s chunk")
    return data


def write_probe_ckpts(workdir, kind):
    """A seeded random ATST-Clip (``kind="clip"``, 1001 frames) or
    ATST-Frame (601 frames) encoder of ``PROBE_ARCH`` as a reference-layout
    ``.ckpt`` with the Linear patch embedding, and for the clip encoder a
    second file with the Conv2d one ([D, 1, 64, 4]); returns their paths
    and the encoder's width in frames."""
    from audiossl_tpu_torch.downstream.train_freeze import _MAKERS

    spec_w = 1001 if kind == "clip" else 601
    sd = _MAKERS[(kind, PROBE_ARCH)](
        spec_w=spec_w, device="cpu",
        generator=torch.Generator().manual_seed(SEED + 21)).state_dict()
    paths = [os.path.join(workdir, f"{kind}_base.ckpt")]
    layouts = [sd]
    if kind == "clip":
        w = sd["patch_embed.patch_embed.weight"]
        conv = {k: v for k, v in sd.items()
                if not k.startswith("patch_embed.")}
        conv["patch_embed.proj.weight"] = w.reshape(w.shape[0], 1, 64, 4)
        conv["patch_embed.proj.bias"] = sd["patch_embed.patch_embed.bias"]
        paths.append(os.path.join(workdir, f"{kind}_base_conv.ckpt"))
        layouts.append(conv)
    for path, layout in zip(paths, layouts):
        torch.save({"state_dict": {f"model.teacher.encoder.{k}": v
                                   for k, v in layout.items()}}, path)
    return paths, spec_w


def breakdown(run, label, top=6):
    """Where a call's time goes: ``run()`` (the host's copy to the card
    included) to ``synchronize()``, the mean of 3 calls after one, and its
    device time by kernel from the profiler, the GEMMs (cuBLAS f32) and K1
    grouped, the rest by name."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages() if e.self_device_time_total > 0}
    gemm = sum(t for k, t in kernels.items() if "gemm" in k.lower())
    k1 = sum(t for k, t in kernels.items() if "mel_db" in k)
    rest = sorted(((t, k) for k, t in kernels.items()
                   if "gemm" not in k.lower() and "mel_db" not in k),
                  reverse=True)
    print(json.dumps({label: {
        "wall_ms": wall, "device_ms": sum(kernels.values()),
        "gemm_ms": gemm, "k1_ms": k1,
        "rest_top": [[k[:60], t] for t, k in rest[:top]]}}))


def probe_path(dev, workdir, data, kind):
    """``train_freeze.main`` at base width on the card: a reference
    ``.ckpt``, 12 s central crops, the mel through K1 once a batch, the
    chunked frozen f32 encoder (module route, no block kernel), the
    probe's 20 epochs on the cached embeddings and ``result.json``; the
    first 8 test clips' embeddings against the same extractor on the CPU;
    the clip checkpoint's two patch-embed layouts bit-equal on the card;
    for the frame encoder also the probe's ACC branch on its embeddings.
    Returns the launch counts of ``main``."""
    from audiossl_tpu_torch.datasets import BatchLoader, PackedAudioDataset
    from audiossl_tpu_torch.downstream import train_freeze
    from audiossl_tpu_torch.downstream.embedding import (
        make_clip_extractor, make_frame_extractor)
    from audiossl_tpu_torch.downstream.linear import (LinearProbeConfig,
                                                      train_linear_probe)
    from audiossl_tpu_torch.kernels import build as kb

    paths, spec_w = write_probe_ckpts(workdir, kind)
    out = os.path.join(workdir, f"probe_{kind}")
    argv = ["--pretrained_ckpt_path", paths[0], "--data_path", data,
            "--dataset_name", "audioset_b", "--model_type", kind,
            "--arch", PROBE_ARCH, "--n_last_blocks", str(PROBE_BLOCKS),
            "--train_len", str(PROBE_CROP_S),
            "--batch_size", str(PROBE_B), "--max_epochs", str(PROBE_EPOCHS),
            "--save_path", out, "--device", str(dev), "--n_devices", "1"]
    record = {}
    torch.cuda.synchronize()
    kb.reset_launches()
    t0 = time.perf_counter()
    res = train_freeze.main(argv, record=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    rec = record[0]
    n_batches = sum(len(t) for t in rec["timings"].values())
    print(f"probe_{kind} launches: {launches}; {n_batches} extraction "
          f"batches; main took {wall:.2f} s")
    check(n_batches == sum(-(-n // PROBE_B) for _, n in PROBE_SPLITS),
          f"probe_{kind}: every split extracted in batches of {PROBE_B}")
    check(launches["mel_db"] == n_batches,
          f"probe_{kind}: K1 launched once per extraction batch "
          f"({launches['mel_db']} of {n_batches})")
    check(not any(v for k, v in launches.items() if k != "mel_db"),
          f"probe_{kind}: no other kernel launched (f32 module route)")

    # clips/s by split, to the host (so to the device's end), without the
    # run's first batch (cuBLAS set-up, the filterbank and K1's table)
    batches = [(split, n, t) for split, ts in rec["timings"].items()
               for n, t in ts][1:]
    rates = {}
    for split, _ in PROBE_SPLITS:
        n = sum(b[1] for b in batches if b[0] == split)
        t = sum(b[2] for b in batches if b[0] == split)
        rates[split] = n / t
    print(json.dumps({f"probe_{kind}_extract_clips_per_s": rates,
                      "first_batch_s": rec["timings"]["train"][0][1],
                      "probe_s": rec["probe_s"], "main_s": wall,
                      "k1_launches": launches["mel_db"]}))

    with open(os.path.join(out, "result.json")) as f:
        result = json.load(f)
    check(result == res and result["metric"] == "mAP"
          and result["folds"] == 1, f"probe_{kind} result.json {result}")
    for key in ("val", "test"):
        check(np.isfinite(result[key]) and 0.0 <= result[key] <= 1.0,
              f"probe_{kind} {key} mAP {result[key]} finite in [0, 1]")
    with open(os.path.join(out, "fold0", "top", "index.json")) as f:
        saved = json.load(f)["scores"]
    check(0 < len(saved) <= 10, f"probe_{kind}: {len(saved)} heads kept "
          "(at most 10)")

    # the first test batch; its first 8 clips, card (main's cache) against
    # the CPU
    batch = next(iter(BatchLoader(PackedAudioDataset(data, "test"), PROBE_B,
                                  pad_samples=int(PROBE_CROP_S * 16000),
                                  shuffle=False, drop_last=False)))
    first8 = {k: v[:8] for k, v in batch.items()}

    def extractor(path, device):
        enc = train_freeze.load_encoder(path, kind, PROBE_ARCH,
                                        spec_w=spec_w, device=device)
        if kind == "clip":
            return make_clip_extractor(enc, crop_len_s=PROBE_CROP_S,
                                       n_blocks=PROBE_BLOCKS)
        return make_frame_extractor(enc, crop_len_s=PROBE_CROP_S,
                                    n_blocks=PROBE_BLOCKS)

    card = torch.from_numpy(rec["embeddings"]["test"][0][:8])
    cpu = extractor(paths[0], "cpu")(first8["wav"], first8["valid"])
    err = float((card - cpu).abs().max())
    cos = float(row_cos(card, cpu).min())
    print(f"probe_{kind} embeddings {tuple(card.shape)}, card vs CPU: max "
          f"abs diff {err}, lowest row cosine {cos}")
    check(err <= PROBE_ATOL and cos >= PROBE_COS,
          f"probe_{kind} card embeddings match the CPU (<= {PROBE_ATOL}, "
          f"cosine >= {PROBE_COS})")
    if kind == "clip":
        a, b = (extractor(p, dev)(first8["wav"], first8["valid"])
                for p in paths)
        check(torch.equal(a, b), "probe_clip: the Linear and Conv2d "
              "patch-embed checkpoints give bit-equal embeddings on the card")
    extract = extractor(paths[0], dev)
    breakdown(lambda: extract(batch["wav"], batch["valid"]),
              f"probe_{kind}_batch_of_{len(batch['valid'])}")
    if kind == "frame":
        (tr, _), (va, _), (te, _) = (rec["embeddings"][s]
                                     for s, _ in PROBE_SPLITS)
        rng = np.random.RandomState(SEED + 22)
        acc = train_linear_probe(
            tr, rng.randint(10, size=len(tr)), va,
            rng.randint(10, size=len(va)), te, rng.randint(10, size=len(te)),
            LinearProbeConfig(batch_size=PROBE_B, max_epochs=5,
                              lr_scale=PROBE_B / 256.0), device=dev)
        print(f"probe_frame ACC branch (10 seeded classes): val "
              f"{acc['val_metric']}, test {acc['test_metric']}")
        check(np.isfinite(acc["test_metric"])
              and 0.0 <= acc["test_metric"] <= 1.0,
              "probe_frame: the probe's ACC branch gives a finite accuracy")
        # the data-module facade (datamodules.py) over the same pack: its
        # test loader through EmbeddingExtractor, K1 once a batch (the
        # values are held against JAX's in the CPU tests)
        from audiossl_tpu_torch.datamodules import (DownstreamDataModule,
                                                    EmbeddingExtractor)

        facade = DownstreamDataModule(data, "audioset_b", batch_size=PROBE_B,
                                      train_len_s=PROBE_CROP_S)
        kb.reset_launches()
        x, y = EmbeddingExtractor(extract).extract(facade.test_dataloader())
        k1 = kb.LAUNCHES["mel_db"]
        n_test = dict(PROBE_SPLITS)["test"]
        check(x.shape == te.shape and np.isfinite(x).all()
              and np.array_equal(y, rec["embeddings"]["test"][1])
              and k1 == -(-n_test // PROBE_B),
              f"probe_frame: EmbeddingExtractor over DownstreamDataModule's "
              f"test loader gives {x.shape} finite embeddings ({te.shape} "
              f"from the probe) and its labels, K1 {k1} a batch")
    return launches


# Full finetuning (``downstream/train_finetune.py``) at ATST-Clip and
# ATST-Frame base width on the probe pack: batches of 64, 2 epochs with 1 of
# warm-up (cut from the reference's 50 and 5), mixup alpha 0.5, layer decay
# 0.75, SGD; the clip encoder on 12 s crops in chunks of 601 frames, the
# frame encoder on 10 s crops (JAX's frame encoder has position embeddings
# for 10 s only) with SpecAugment, RandomResizeCrop, frozen embeddings and
# mixup_ratio 0.5
FT_B, FT_EPOCHS, FT_WARMUP, FT_LR = 64, 2, 1, 5e-4
FT_ARCH, FT_BLOCKS = "base", 12  # the encoder, its blocks read
FT_ARGS = {"clip": ["--train_len", "12"],
           "frame": ["--train_len", "10", "--mask_aug", "--rrc",
                     "--freeze_embed", "--mixup_ratio", "0.5"]}
FT_CHECK_B = 4  # the step held on the card against the CPU
FT_LOSS_REL, FT_LEAF_COS = 1e-4, 0.9999  # f32 card vs f32 CPU, TF32 off
FT_PARAM_ATOL = 1e-6  # the updated parameters: a few f32 steps of each
# The final norm's bias can have no gradient in exact arithmetic: the
# head's BatchNorm cancels a shift shared by every clip's features (the
# clip encoder's shift differs by clip only where a clip's first chunk
# divides its mean by more patches than it holds, a clip longer than one
# chunk). Rounding noise has no direction to compare, so that leaf is held
# by its distance from the CPU's, as a share of the largest leaf's norm
FT_ZERO_REL = 1e-4


def finetune_argv(kind, ckpt, data, out, dev):
    """The path's flags of ``train_finetune.main``."""
    return ["--pretrained_ckpt_path", ckpt, "--data_path", data,
            "--dataset_name", "audioset_b", "--model_type", kind,
            "--arch", FT_ARCH, "--n_last_blocks", str(FT_BLOCKS),
            "--batch_size", str(FT_B), "--max_epochs", str(FT_EPOCHS),
            "--warmup_epochs", str(FT_WARMUP), "--learning_rate", str(FT_LR),
            "--alpha", "0.5", "--layer_wise_lr", "0.75", "--save_path", out,
            "--device", str(dev), "--n_devices", "1", *FT_ARGS[kind]]


def step_agreement(gc, gh, pc, ph, before, skip=None):
    """A step on the card against the same step on the CPU: each leaf's
    gradient ``gc`` against ``gh`` by cosine (the leaves with a CPU
    gradient, but ``skip``), the lowest, the leaves without one, the
    parameters the CPU's step left at ``before``, and the largest
    difference of the updated parameters ``pc`` and ``ph``."""
    cos = {k: float(torch.nn.functional.cosine_similarity(
        gc[k].double().flatten(), v.double().flatten(), dim=0))
        for k, v in gh.items() if float(v.norm()) > 0 and k != skip}
    unused = sorted(k for k, v in gh.items() if float(v.norm()) == 0)
    unchanged = sorted(k for k, v in ph.items() if torch.equal(v, before[k]))
    param_err = max(float((pc[k] - v).abs().max()) for k, v in ph.items())
    return cos, min(cos, key=cos.get), unused, unchanged, param_err


def finetune_step_check(dev, argv, kind, data):
    """One step of the task ``train_finetune.build_task`` makes of the
    path's flags ``argv`` (one step an epoch, so the step runs at the base
    learning rate), at B = 4, from the same state and draws on the card
    and on the CPU (f32, TF32 off): the loss within ``FT_LOSS_REL``;
    every leaf's step (the momentum trace after one step: the clipped
    gradient, which the layer-decay factor and the learning rate scale
    into the update) at cosine >= ``FT_LEAF_COS``; every updated parameter
    within ``FT_PARAM_ATOL``; the frozen embeddings of the frame recipe
    unchanged. Comparing the parameters' changes instead would compare
    their f32 rounding: an update of a few f32 steps of the weight.
    Returns the card's task and state."""
    from audiossl_tpu_torch.datasets import (BatchLoader, PackedAudioDataset,
                                             get_dataset)
    from audiossl_tpu_torch.downstream import train_finetune
    from audiossl_tpu_torch.downstream.finetune import draw_finetune, draws_to
    from audiossl_tpu_torch.downstream.train_freeze import load_encoder

    args = train_finetune.build_parser().parse_args(argv)
    info = get_dataset(args.dataset_name)
    batch = next(iter(BatchLoader(
        PackedAudioDataset(data, "train"), FT_CHECK_B,
        pad_samples=int(args.train_len * 16000), shuffle=False)))
    out = []
    for d in (dev, torch.device("cpu")):
        enc = load_encoder(args.pretrained_ckpt_path, args.model_type,
                           args.arch, which=args.use_encoder, device=d)
        task = train_finetune.build_task(args, info, enc, steps_per_epoch=1)
        state = task.init_state()
        if d == dev:
            draws = draw_finetune(task.cfg, FT_CHECK_B,
                                  task.rows(FT_CHECK_B, batch["wav"].shape[1]),
                                  enc.depth,
                                  torch.Generator().manual_seed(SEED + 30),
                                  np.random.default_rng(SEED + 31))
        before = {k: p.detach().to("cpu", copy=True)
                  for k, p in state.params.items()}
        t0 = time.perf_counter()
        _, m = task.train_step(state, batch, draws_to(draws, d))
        loss = float(m["loss"])
        out.append((loss, {k: v.detach().cpu() for k, v in state.mu.items()},
                    {k: p.detach().cpu() for k, p in state.params.items()},
                    before, time.perf_counter() - t0, task, state))
    (lc, gc, pc, _, tc, *card), (lh, gh, ph, before, th, *_) = out
    rel = abs(lc - lh) / abs(lh)
    zero = f"encoder.{'norm' if kind == 'clip' else 'norm_frame'}.bias"
    top = max(float(v.norm()) for v in gh.values())
    zero_rel = float((gc[zero] - gh[zero]).norm()) / top
    cos, worst, unused, unchanged, param_err = step_agreement(
        gc, gh, pc, ph, before, skip=zero)
    print(json.dumps({f"finetune_{kind}_step_card_vs_cpu": {
        "batch": FT_CHECK_B, "loss": [lc, lh], "loss_rel": rel,
        "leaves_compared": len(cos), "lowest_cos": [worst, cos[worst]],
        "param_max_abs_diff": param_err, "no_gradient": unused,
        "unchanged": unchanged, "final_norm_bias": {
            "norm_rel": float(gh[zero].norm()) / top, "diff_rel": zero_rel},
        "card_s": tc, "cpu_s": th}}))
    check(np.isfinite(lc) and rel <= FT_LOSS_REL,
          f"finetune_{kind}: card loss {lc} vs CPU {lh} (rel {rel} <= "
          f"{FT_LOSS_REL})")
    check(cos[worst] >= FT_LEAF_COS,
          f"finetune_{kind}: every leaf's step at cosine >= {FT_LEAF_COS} "
          f"to the CPU's (lowest {worst} {cos[worst]})")
    check(param_err <= FT_PARAM_ATOL, f"finetune_{kind}: the updated "
          f"parameters within {FT_PARAM_ATOL} of the CPU's ({param_err})")
    check(zero_rel <= FT_ZERO_REL, f"finetune_{kind}: {zero}'s gradient "
          f"within {FT_ZERO_REL} of the largest leaf's norm of the CPU's "
          f"({zero_rel})")
    check(unused == ["encoder.mask_embed"],
          f"finetune_{kind}: only the unused mask_embed has no gradient")
    frozen = {"encoder.pos_embed", "encoder.patch_embed.patch_embed.weight",
              "encoder.patch_embed.patch_embed.bias"}
    check(kind == "clip" or frozen <= set(unchanged),
          f"finetune_{kind}: --freeze_embed keeps {sorted(frozen)}")
    return card


def finetune_breakdown(task, state, data, kind):
    """Where a training step's time goes at B = 64 (:func:`breakdown`),
    on the first train batch with fresh draws each step."""
    from audiossl_tpu_torch.datasets import BatchLoader, PackedAudioDataset
    from audiossl_tpu_torch.downstream.finetune import draw_finetune

    cfg = task.cfg
    batch = next(iter(BatchLoader(
        PackedAudioDataset(data, "train"), FT_B,
        pad_samples=int(cfg.crop_len_s * 16000), shuffle=False)))
    gen, rng = torch.Generator().manual_seed(SEED + 32), \
        np.random.default_rng(SEED + 33)

    def step():
        draws = draw_finetune(cfg, FT_B, task.rows(FT_B, batch["wav"].shape[1]),
                              task.encoder.depth, gen, rng, task.device)
        return float(task.train_step(state, batch, draws)[1]["loss"])

    breakdown(step, f"finetune_{kind}_step_of_{FT_B}", top=8)


def run_timed(main, argv):
    """``main(argv, record)`` with the launch counts and the peak memory
    reset first; -> (its result, record, launches, peak GiB, seconds)."""
    from audiossl_tpu_torch.kernels import build as kb

    record = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    t0 = time.perf_counter()
    res = main(argv, record=record)
    torch.cuda.synchronize()
    return (res, record, dict(kb.LAUNCHES),
            torch.cuda.max_memory_allocated() / 2 ** 30,
            time.perf_counter() - t0)


def write_ft_ckpt(workdir, kind):
    """A seeded random encoder of ``FT_ARCH`` with 1001 frames of position
    embeddings as a reference-layout ``.ckpt`` (the finetuning paths' and
    the distillation student's), written once; returns its path."""
    from audiossl_tpu_torch.downstream.train_freeze import _MAKERS

    ckpt = os.path.join(workdir, f"finetune_{kind}.ckpt")
    if not os.path.exists(ckpt):
        sd = _MAKERS[(kind, FT_ARCH)](
            spec_w=1001, device="cpu",
            generator=torch.Generator().manual_seed(SEED + 21)).state_dict()
        torch.save({"state_dict": {f"model.teacher.encoder.{k}": v
                                   for k, v in sd.items()}}, ckpt)
    return ckpt


def finetune_path(dev, workdir, data, kind):
    """``train_finetune.main`` at base width on the card: a reference
    ``.ckpt`` (1001 frames of position embeddings, as the driver loads it),
    class-balanced batches of 64 drawn with replacement, the mel through K1
    once a batch, the f32 module-route encoder with drop path, mixup (and
    for the frame encoder SpecAugment, RandomResizeCrop and frozen
    embeddings), layer-decayed SGD, validation each epoch, the kept states
    and the test on the best. Checks K1's launches (one a train and one an
    eval batch, no other kernel), ``result.json`` and the kept states,
    then one step on the card against the CPU; prints the train clips/s
    by step (the first left out), the eval clips/s, peak memory and the
    test metric; for the clip encoder also one step's device breakdown.
    Returns the launch counts of ``main``."""
    from audiossl_tpu_torch.downstream import train_finetune

    ckpt = write_ft_ckpt(workdir, kind)
    out = os.path.join(workdir, f"finetune_{kind}")
    argv = finetune_argv(kind, ckpt, data, out, dev)
    res, record, launches, peak, wall = run_timed(train_finetune.main, argv)
    steps = [s for epoch in record["steps"] for s in epoch]
    evals = [b for _, batches in record["evals"] for b in batches]
    print(f"finetune_{kind} launches: {launches}; {len(steps)} train and "
          f"{len(evals)} eval batches; main took {wall:.2f} s")
    check(len(steps) == FT_EPOCHS * (PROBE_SPLITS[0][1] // FT_B)
          and all(n == FT_B for n, _ in steps),
          f"finetune_{kind}: {FT_EPOCHS} epochs of full train batches")
    check(launches["mel_db"] == len(steps) + len(evals),
          f"finetune_{kind}: K1 launched once per train and eval batch "
          f"({launches['mel_db']} of {len(steps) + len(evals)})")
    check(not any(v for k, v in launches.items() if k != "mel_db"),
          f"finetune_{kind}: no other kernel launched (f32 module route)")
    train = steps[1:]
    print(json.dumps({
        f"finetune_{kind}_train_clips_per_s": sum(n for n, _ in train)
        / sum(t for _, t in train),
        "by_step": [n / t for n, t in steps],
        "eval_clips_per_s": sum(n for n, _ in evals)
        / sum(t for _, t in evals),
        "eval_by_batch": [n / t for n, t in evals],
        "peak_gib": peak, "test_mAP": record["test"], "val_mAP": res["val"],
        "main_s": wall, "k1_launches": launches["mel_db"]}))
    with open(os.path.join(out, "result.json")) as f:
        result = json.load(f)
    check(result == res and set(result) == {"dataset", "val", "test"},
          f"finetune_{kind} result.json {result}")
    for key in ("val", "test"):
        check(np.isfinite(result[key]) and 0.0 <= result[key] <= 1.0,
              f"finetune_{kind} {key} mAP {result[key]} finite in [0, 1]")
    with open(os.path.join(out, "top", "index.json")) as f:
        saved = json.load(f)["scores"]
    check(0 < len(saved) <= FT_EPOCHS, f"finetune_{kind}: {len(saved)} "
          f"states kept (audioset keeps up to 10 of {FT_EPOCHS} epochs)")
    torch.cuda.empty_cache()
    task, state = finetune_step_check(dev, argv, kind, data)
    if kind == "clip":
        finetune_breakdown(task, state, data, kind)
    return launches


# The SED paths: ``train_dcase.main`` and ``train_as_strong.main`` at
# ATST-Frame base on seeded trees of 10 s tone clips (one tone a class, one
# to three events a clip), and one epoch of DCASE distill from the first
# run's kept states
SED_DCASE_SPLITS = {"synth_train": 256, "weak_train": 284, "synth_val": 64,
                    "strong_val": 64}  # weak_train: 256 train, 28 valid
SED_AS_SPLITS = {"train": 128, "val": 32, "eval": 32}
SED_AS_LABELS = 407
SED_EPOCHS, SED_WARMUP = 2, 1  # from 100 and 10 (DCASE) or 5
SED_DCASE_B, SED_AS_B = 128, 32  # synth and weak rows each; AudioSet-strong
SED_CHECK_B = 4  # strong and weak rows of the step held against the CPU
SED_ARCH = "base"  # ATST-Frame base: 768 wide, 12 blocks, 250 tokens a clip
SED_ARGS = {
    "dcase": ["--batch_size_synth", str(SED_DCASE_B), "--batch_size_weak",
              str(SED_DCASE_B), "--learning_rate", "0.1"],
    "as_strong": ["--batch_size", str(SED_AS_B), "--learning_rate", "1e-3",
                  "--lr_scale", "0.75", "--patience", "10"]}
CARD = ""  # nvidia-smi's name and power limit, printed beside the numbers


def write_sed_trees(workdir):
    """The seeded DCASE and AudioSet-strong trees and a seeded random
    ATST-Frame base encoder as a reference-layout ``.ckpt``; returns their
    paths."""
    from audiossl_tpu_torch.datasets.sed import (DCASE_CLASSES,
                                                 write_synthetic_sed)
    from audiossl_tpu_torch.downstream.train_freeze import _MAKERS

    t0 = time.perf_counter()
    dcase = os.path.join(workdir, "dcase")
    write_synthetic_sed(dcase, SED_DCASE_SPLITS, DCASE_CLASSES,
                        weak_splits=("weak_train",),
                        duration_splits=("strong_val",), seed=SEED + 50)
    as_strong = os.path.join(workdir, "as_strong")
    write_synthetic_sed(as_strong, SED_AS_SPLITS,
                        [f"/m/sed{i:03d}" for i in range(SED_AS_LABELS)],
                        duration_splits=("eval",), seed=SEED + 51)
    size = sum(os.path.getsize(os.path.join(d, f))
               for top in (dcase, as_strong)
               for d, _, files in os.walk(top) for f in files)
    ckpt = os.path.join(workdir, "sed_frame_base.ckpt")
    sd = _MAKERS[("frame", SED_ARCH)](
        spec_w=1001, device="cpu",
        generator=torch.Generator().manual_seed(SEED + 52)).state_dict()
    torch.save({"state_dict": {f"model.teacher.encoder.{k}": v
                               for k, v in sd.items()}}, ckpt)
    print(f"SED trees written in {time.perf_counter() - t0:.1f} s: "
          f"{size / 1e6:.1f} MB")
    return dcase, as_strong, ckpt


def sed_decode_check(name, kind, data, scores):
    """``decode_preds`` and ``intersection_stats`` of each threshold on the
    card against the CPU, on the run's own test scores: the hard
    predictions bit-equal, the counts equal. DCASE at the test's 50
    operating points and 0.5; AudioSet-strong (407 classes, slow on the
    host) at every fifth and 0.5."""
    from audiossl_tpu_torch.datasets.sed import (MixedBatchLoader,
                                                 create_as_strong,
                                                 create_dcase, dcase_encoder,
                                                 load_as_strong_labels)
    from audiossl_tpu_torch.sed.decode import decode_preds
    from audiossl_tpu_torch.sed.metrics import intersection_stats

    thds = list(np.arange(1 / 100, 1, 1 / 50))
    if kind == "dcase":
        test = create_dcase(data, "test")
    else:
        test = create_as_strong(data, "test", encoder=dcase_encoder(
            labels=load_as_strong_labels(os.path.join(
                data, "common_labels.txt"))))
        thds = thds[::5]
    thds.append(0.5)
    loader = MixedBatchLoader([test], [32], shuffle=False)
    diff, counts = 0, 0.0
    for strong, batch in zip(scores, loader):
        y = torch.from_numpy(np.transpose(batch["strong"], (0, 2, 1))[
            ..., :strong.shape[-1]].copy())
        hard = decode_preds(strong, thds, 7)
        host = decode_preds(strong.cpu(), thds, 7)
        diff += int((hard.cpu() != host).sum())
        n, B, C, T = hard.shape
        yy = y.repeat(n, 1, 1)
        got = intersection_stats(hard.reshape(n * B, C, T), yy.to(
            hard.device))
        want = intersection_stats(host.reshape(n * B, C, T), yy)
        for g, w in zip(got, want):
            diff += int((g.cpu() != w).sum())
        counts += float(want[3].sum())
    print(f"{name}: card vs CPU decoding of {len(scores)} test batches at "
          f"{len(thds)} thresholds: {diff} elements differ; {counts:.0f} "
          "intersection events")
    check(diff == 0 and counts > 0, f"{name}: decode_preds and "
          "intersection_stats on the card equal the CPU's")


def sed_step_check(dev, kind, ckpt, data):
    """One SED step at ATST-Frame base from the same weights and drop-path
    draws on the card and the CPU (f32, TF32 off): DCASE (4 strong and 4
    weak clips, learning rate 0.1) or AudioSet-strong (8 clips, 407 labels,
    learning rate 1e-3, lr_scale 0.75). The loss within ``FT_LOSS_REL``,
    each leaf's gradient (the momentum trace after one step) at cosine >=
    ``FT_LEAF_COS``, the updated parameters within ``FT_PARAM_ATOL``;
    only the unused mask_embed (and with no weak rows the weak pooling's
    linear_softmax) without a gradient. A parameter whose update lies
    under half an f32 step of its value (a LayerNorm scale at a decayed
    1e-3) stays unchanged on both devices; those are printed."""
    from audiossl_tpu_torch.datasets.sed import (MixedBatchLoader,
                                                 create_as_strong,
                                                 create_dcase, dcase_encoder,
                                                 load_as_strong_labels)
    from audiossl_tpu_torch.downstream.train_freeze import load_encoder
    from audiossl_tpu_torch.sed.module import SEDConfig, SEDTask

    common = dict(max_epochs=1, steps_per_epoch=1, warmup_epochs=0)
    if kind == "dcase":
        sets, sizes = create_dcase(data, "train"), [SED_CHECK_B] * 2
        cfg = SEDConfig(num_labels=10, learning_rate=0.1, **common)
    else:
        labels = load_as_strong_labels(os.path.join(data,
                                                    "common_labels.txt"))
        sets = [create_as_strong(data, "train",
                                 encoder=dcase_encoder(labels=labels))]
        sizes = [2 * SED_CHECK_B]
        cfg = SEDConfig(num_labels=len(labels), learning_rate=1e-3,
                        lr_scale=0.75, distill_combine="average_strong",
                        **common)
    batch = next(iter(MixedBatchLoader(sets, sizes, shuffle=False)))
    out = []
    for d in (dev, torch.device("cpu")):
        enc = load_encoder(ckpt, "frame", SED_ARCH, spec_w=1001, device=d)
        task = SEDTask(enc, cfg, generator=torch.Generator().manual_seed(SEED))
        state = task.init_state()
        u = task.draw(torch.Generator().manual_seed(SEED + 53), sum(sizes))
        before = {k: p.detach().to("cpu", copy=True)
                  for k, p in state.params.items()}
        t0 = time.perf_counter()
        _, m = task.train_step(state, batch, u)
        loss = float(m["loss"])
        out.append((loss, {k: v.detach().cpu() for k, v in state.mu.items()},
                    {k: p.detach().cpu() for k, p in state.params.items()},
                    before, time.perf_counter() - t0))
        del task, state, enc
    (lc, gc, pc, _, tc), (lh, gh, ph, before, th) = out
    rel = abs(lc - lh) / abs(lh)
    cos, worst, unused, unchanged, param_err = step_agreement(
        gc, gh, pc, ph, before)
    label = f"sed_{kind}" + ("_lr_scale" if kind == "as_strong" else "")
    print(json.dumps({f"{label}_step_card_vs_cpu": {
        "card": CARD, "batch": sum(sizes), "loss": [lc, lh],
        "loss_rel": rel, "leaves_compared": len(cos),
        "lowest_cos": [worst, cos[worst]], "param_max_abs_diff": param_err,
        "no_gradient": unused, "unchanged": unchanged, "card_s": tc,
        "cpu_s": th}}))
    check(np.isfinite(lc) and rel <= FT_LOSS_REL,
          f"{label}: card loss {lc} vs CPU {lh} (rel {rel} <= "
          f"{FT_LOSS_REL})")
    check(cos[worst] >= FT_LEAF_COS,
          f"{label}: every leaf's gradient at cosine >= {FT_LEAF_COS} to "
          f"the CPU's (lowest {worst} {cos[worst]})")
    check(param_err <= FT_PARAM_ATOL, f"{label}: the updated parameters "
          f"within {FT_PARAM_ATOL} of the CPU's ({param_err})")
    # AudioSet-strong batches have no weak rows: no weak loss reaches the
    # pooling's linear_softmax
    want = ["encoder.mask_embed"] + (
        [] if kind == "dcase" else ["head.linear_softmax.bias",
                                    "head.linear_softmax.weight"])
    check(unused == want, f"{label}: every parameter but {want} has a "
          "gradient")


def sed_breakdown(dev, ckpt, data):
    """Where a DCASE training step's time goes at 128 + 128 clips
    (:func:`breakdown`): ``SEDTask.train_step`` at ATST-Frame base on the
    first train batch, read once from the host, with fresh draws each
    step; the host's copy of the batch to the card included."""
    from audiossl_tpu_torch.datasets.sed import MixedBatchLoader, create_dcase
    from audiossl_tpu_torch.downstream.train_freeze import load_encoder
    from audiossl_tpu_torch.sed.module import SEDConfig, SEDTask

    batch = next(iter(MixedBatchLoader(create_dcase(data, "train"),
                                       [SED_DCASE_B] * 2, shuffle=False)))
    enc = load_encoder(ckpt, "frame", SED_ARCH, spec_w=1001, device=dev)
    task = SEDTask(enc, SEDConfig(num_labels=10, learning_rate=0.1),
                   generator=torch.Generator().manual_seed(SEED))
    state = task.init_state()
    gen = torch.Generator().manual_seed(SEED + 54)

    def step():
        u = task.draw(gen, 2 * SED_DCASE_B)
        return float(task.train_step(state, batch, u)[1]["loss"])

    breakdown(step, f"sed_dcase_step_of_{2 * SED_DCASE_B}", top=8)


def sed_path(dev, name, kind, ckpt, data, out, extra=(), want_mode="max",
             teacher=False):
    """``train_dcase.main`` or ``train_as_strong.main`` at ATST-Frame base
    on the card: the mel through K1 once a train and eval batch (twice a
    train batch with a distill teacher), the f32 module-route encoder with
    drop path, the SED head and loss, the SGD update, validation each
    epoch, the kept states and the test from the best (decoding on the
    card, PSDS on the host). Checks the launches, ``result.json`` and the
    keeper's mode; prints train clips/s by step (the first left out) and
    each step's loading seconds, eval clips/s and loading seconds, the
    test's decoding and scoring seconds and peak memory.
    Returns the launch counts of ``main`` and its record."""
    from audiossl_tpu_torch.downstream import train_as_strong, train_dcase

    argv = ["--pretrained_ckpt_path", ckpt, "--data_path", data, "--arch",
            SED_ARCH, "--max_epochs", str(SED_EPOCHS), "--warmup_epochs",
            str(SED_WARMUP), "--median_window", "7", "--save_path", out,
            "--device", str(dev), "--n_devices", "1", *SED_ARGS[kind],
            *extra]
    main = train_dcase.main if kind == "dcase" else train_as_strong.main
    res, record, launches, peak, wall = run_timed(main, argv)
    steps = [s for epoch in record["steps"] for s in epoch]
    evals = [b for epoch in record["evals"] for b in epoch]
    test = record["test"]
    n_eval = len(evals) + len(test["strong"])
    B = 2 * SED_DCASE_B if kind == "dcase" else SED_AS_B
    print(f"{name} launches: {launches}; {len(steps)} train, {len(evals)} "
          f"validation and {len(test['strong'])} test batches; main took "
          f"{wall:.2f} s")
    check(steps and all(n == B for n, _, _ in steps),
          f"{name}: train batches of {B}")
    want = len(steps) * (2 if teacher else 1) + n_eval
    check(launches["mel_db"] == want, f"{name}: K1 launched once per train"
          f"{' (and teacher)' if teacher else ''} and eval batch "
          f"({launches['mel_db']} of {want})")
    check(not any(v for k, v in launches.items() if k != "mel_db"),
          f"{name}: no other kernel launched (f32 module route)")
    train = steps[1:]
    print(json.dumps({name: {
        "card": CARD,
        "train_clips_per_s": (sum(n for n, _, _ in train)
                              / sum(t for _, t, _ in train) if train
                              else None),
        "by_step": [n / t for n, t, _ in steps],
        "load_s_by_step": [load for _, _, load in steps],
        "eval_clips_per_s": sum(n for n, _, _ in evals)
        / sum(t for _, t, _ in evals),
        "eval_by_batch": [n / t for n, t, _ in evals],
        "eval_load_s": sum(load for _, _, load in evals),
        "test_decode_s": test["decode_s"], "test_psds_s": test["psds_s"],
        "peak_gib": peak, "result": res, "main_s": wall,
        "k1_launches": launches["mel_db"]}}))
    with open(os.path.join(out, "result.json")) as f:
        result = json.load(f)
    check(result == res and set(result) == {"psds1", "psds2", "event_f1"},
          f"{name} result.json {result}")
    for k, v in result.items():
        check(np.isfinite(v) and 0.0 <= v <= 1.0,
              f"{name} {k} {v} finite in [0, 1]")
    with open(os.path.join(out, "top", "index.json")) as f:
        index = json.load(f)
    check(index["mode"] == want_mode and 0 < len(index["scores"]) <= 3,
          f"{name}: the keeper's index in mode {index['mode']!r} with "
          f"{len(index['scores'])} states")
    return launches, record


def sed_paths(dev, workdir, run_path):
    """The three SED paths, each through ``run_path``, with the decoding
    and the step held against the CPU after the first two; returns the
    DCASE tree, the AudioSet-strong tree and the encoder's checkpoint."""
    dcase, as_strong, ckpt = write_sed_trees(workdir)
    dcase_out = os.path.join(workdir, "sed_dcase")

    def path(name, kind, data, out, checks, **kw):
        launches, record = sed_path(dev, name, kind, ckpt, data, out, **kw)
        if checks:
            sed_decode_check(name, kind, data, record["test"]["strong"])
            del record
            torch.cuda.empty_cache()
            sed_step_check(dev, kind, ckpt, data)
            if kind == "dcase":
                torch.cuda.empty_cache()
                sed_breakdown(dev, ckpt, data)
        return launches

    for name, kind, data, out, checks, kw in (
            ("sed_dcase", "dcase", dcase, dcase_out, True, {}),
            ("sed_as_strong", "as_strong", as_strong,
             os.path.join(workdir, "sed_as_strong"), True,
             dict(want_mode="min")),
            ("sed_dcase_distill", "dcase", dcase,
             os.path.join(workdir, "sed_dcase_distill"), False,
             dict(extra=["--max_epochs", "1", "--distill_ckpt", dcase_out],
                  teacher=True))):
        torch.cuda.empty_cache()
        run_path(name, lambda: path(name, kind, data, out, checks, **kw))
    return dcase, as_strong, ckpt


# The comparison encoders (``compat/``, ``downstream/comparison_models.py``)
# at the full width of the JAX package's default loaders, from seeded random
# weights in their authors' layouts (``compat.synthetic``): BEATs iter3
# (768 / 12 / 12, patch embedding 512 wide), ViT-B/16 for AudioMAE, M2D and
# both SSAST variants, MAE-AST 768 / 12 / 12 (both variants: its attention
# is K6), BYOL-A at n_mels 64, d 3072
CMP_B, CMP_RATE_B = 4, 32  # clips of 10 s: card vs CPU; the timed rate
CMP_REL = 1e-4  # f32 card vs f32 CPU (TF32 off), rel L2 of the frames
CMP_LOSS_REL, CMP_LEAF_COS = 1e-5, 0.9999  # one SED step, card vs CPU
MAEAST_N = {"maeast": 499, "patchmaeast": 496}  # K6's tokens at 10 s
EXP_F32_MAX = 88.72  # exp overflows f32 above ln(FLT_MAX)
# the comparison SED runs' batches: DCASE 16 strong + 16 weak, so K6 trains
# at the [32, 499] that k6_maeast_checks holds; AudioSet-strong 32
CMP_SED_B = 32


def seeded_clips(n, seed):
    """n seeded clips of 10 s (noise at 0.1) on the host."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(n, SAMPLES) * 0.1).astype(np.float32))


def k6_maeast_checks(dev):
    """K6 forward and backward at MAE-AST's shapes, 32 clips of 10 s at full
    width (12 heads of 64): [32, 499, 3 * 768] (frame variant, timed beside
    its bound and SDPA with the key mask) and [32, 496, 3 * 768] (patch
    variant, untimed), every key valid (the zero mask MAE-AST hands it). The
    qkv is the one MAE-AST's layers compute from a seeded authors'-layout
    checkpoint (captured from the plain versions' forward): of the 12
    layers, the one with the largest score. K6 subtracts no row maximum, so
    every layer's largest score is printed and held below the f32 ``exp``
    overflow, and the plain output must be finite. Output, r and each
    third of the gradient (dq, dk, dv) within ``MHA_F32_REL`` of the plain
    version."""
    from audiossl_tpu_torch.compat import maeast, synthetic
    from audiossl_tpu_torch.ops import mha

    ckpt = synthetic.authors_checkpoint("maeast", seed=SEED + 61)
    wav = seeded_clips(CMP_RATE_B, SEED + 62).to(dev)
    fb = maeast.maeast_fbank(wav)
    res = {}
    for arch, label in (("maeast", "f32_maeast"),
                        ("patchmaeast", "f32_maeast_patch")):
        enc = synthetic.encoder_from_checkpoint(arch, ckpt, dev)
        layers = []
        orig = mha.fused_mha

        def capture(qkv, mask, h, scale, plain=False):
            layers.append(qkv.detach())
            return orig(qkv, mask, h, scale, True)

        mha.fused_mha = capture
        try:
            with torch.no_grad():
                enc(fb)
        finally:
            mha.fused_mha = orig
        S, n, c3 = layers[0].shape
        c, h = c3 // 3, enc.cfg.num_heads
        scale = (c // h) ** -0.5
        check((n, len(layers)) == (MAEAST_N[arch], 12),
              f"{arch}: 12 layers hand K6 {MAEAST_N[arch]} tokens (got "
              f"{len(layers)} of {n})")
        top = []
        for qkv in layers:
            q, k = qkv.view(S, n, 3, h, c // h)[:, :, :2].unbind(2)
            top.append(float(torch.einsum("bnhd,bmhd->bhnm", q, k).amax())
                       * scale)
        worst = int(np.argmax(top))
        print(f"K6 {label}: the largest score of each layer {top} (f32 exp "
              f"overflows above {EXP_F32_MAX}); the check takes layer {worst}")
        check(max(top) < EXP_F32_MAX, f"{arch}: no score reaches the f32 exp "
              f"overflow ({max(top)} < {EXP_F32_MAX})")
        qkv = layers[worst].contiguous()
        del layers, enc
        g = torch.from_numpy(np.random.RandomState(SEED + 63).randn(
            S, n, c).astype(np.float32)).to(dev)
        valid = torch.ones(S, n, device=dev)
        out, r = mha.mha_fwd(qkv, valid, h, scale)
        out_p, r_p = mha.mha_fwd_ref(qkv, valid, h, scale)
        dq = mha.mha_bwd(qkv, valid, out_p, r_p, g, h, scale)
        dq_p = mha.mha_bwd_ref(qkv, valid, out_p, r_p, g, h, scale)
        check(bool(torch.isfinite(out_p).all())
              and bool(torch.isfinite(dq_p).all()),
              f"K6 {label}: the plain version's output and gradient finite")
        errs = {"out": rel_l2(out, out_p), "r": rel_l2(r, r_p)}
        for i, part in enumerate(("dq", "dk", "dv")):
            errs[part] = rel_l2(dq[..., i * c:(i + 1) * c],
                                dq_p[..., i * c:(i + 1) * c])
        e_o = float((out - out_p).abs().max())
        e_d = float((dq - dq_p).abs().max())
        print(f"K6 mha {label} {tuple(qkv.shape)} H={h}: rel_l2 {errs}, out "
              f"max_abs_err {e_o}, dqkv max_abs_err {e_d}")
        check(max(errs.values()) <= MHA_F32_REL,
              f"K6 {label} rel L2 {max(errs.values())} <= {MHA_F32_REL}")
        res[label] = dict(
            fwd=dict(max_abs_err=e_o, rel_l2=max(errs["out"], errs["r"])),
            bwd=dict(max_abs_err=e_d, rel_l2=max(errs[p] for p in
                                                  ("dq", "dk", "dv"))))
        if arch == "maeast":
            # every pair valid; f32 products as three TF32 passes
            pairs = S * n * n
            lib_fwd, lib_bwd, backend, lib_out = sdpa_library(
                qkv, valid, g, h, scale)
            print(f"K6 {label} library call: scaled_dot_product_attention, "
                  f"backend {backend}; output rel_l2 to K6 "
                  f"{rel_l2(lib_out, out)}")
            card_state(f"K6 {label}")
            res[label]["fwd"].update(
                ms=cuda_ms(lambda: mha.mha_fwd(qkv, valid, h, scale),
                           iters=10),
                plain_ms=cuda_ms(lambda: mha.mha_fwd_ref(qkv, valid, h,
                                                         scale), iters=10),
                library_ms=lib_fwd, library_backend=backend,
                **bound(nbytes(qkv, valid, out, r), tf32=3 * 4 * c * pairs))
            res[label]["bwd"].update(
                ms=cuda_ms(lambda: mha.mha_bwd(qkv, valid, out_p, r_p, g, h,
                                               scale), iters=10),
                plain_ms=cuda_ms(lambda: mha.mha_bwd_ref(
                    qkv, valid, out_p, r_p, g, h, scale), iters=10),
                library_ms=lib_bwd, library_backend=backend,
                **bound(nbytes(qkv, valid, out_p, r_p, g, dq),
                        tf32=3 * 10 * c * pairs))
            print(json.dumps({f"K6_{label}": dict(card=CARD, **res[label])}))
            del lib_out
        del qkv, g, out, r, out_p, r_p, dq, dq_p
        torch.cuda.empty_cache()
    return {f"mha_{d}": {k: v[d] for k, v in res.items()}
            for d in ("fwd", "bwd")}


def comparison_step_check(dev, arch, ckpt, ad_cpu):
    """One ``SEDTask`` step (finetuning: the encoder trained, no drop
    path) with ``arch``'s adapter on the card against the same step on the
    CPU, from the same authors' weights, head and batch (2 strong and 2
    weak clips of 10 s, seeded labels of 10 classes): the loss within
    ``CMP_LOSS_REL``, every leaf's gradient (the momentum trace after one
    step) at cosine >= ``CMP_LEAF_COS``. A key bias has no gradient in
    exact arithmetic (the softmax cancels it): BEATs' ``k_proj.bias``
    leaves are held to a vanishing norm instead. Returns the card step's
    launch counts."""
    from audiossl_tpu_torch.compat import synthetic
    from audiossl_tpu_torch.downstream.comparison_models import (
        comparison_adapter)
    from audiossl_tpu_torch.kernels import build as kb
    from audiossl_tpu_torch.sed.module import SEDConfig, SEDTask

    T = ad_cpu.token_count(SAMPLES)
    batch = {"wav": seeded_clips(CMP_B, SEED + 65).numpy(),
             "valid": np.full(CMP_B, SAMPLES),
             "strong": (np.random.RandomState(SEED + 64).rand(CMP_B, T, 10)
                        > 0.8).astype(np.float32),
             "source": np.arange(CMP_B) * 2 // CMP_B}  # strong, then weak
    cfg = SEDConfig(num_labels=10, learning_rate=0.1, max_epochs=1,
                    steps_per_epoch=1, warmup_epochs=0)
    out = []
    for d in (dev, None):
        ad = ad_cpu if d is None else comparison_adapter(
            arch, synthetic.encoder_from_checkpoint(arch, ckpt, d))
        task = SEDTask(ad, cfg, generator=torch.Generator().manual_seed(SEED))
        state = task.init_state()
        check(task.draw(torch.Generator().manual_seed(0), CMP_B) is None,
              f"{arch}: no drop-path draws for a comparison adapter")
        torch.cuda.synchronize()
        kb.reset_launches()
        t0 = time.perf_counter()
        _, m = task.train_step(state, batch, None)
        loss = float(m["loss"])
        launches = dict(kb.LAUNCHES)
        out.append((loss, {k: v.detach().cpu() for k, v in state.mu.items()},
                    launches, time.perf_counter() - t0))
        del task, state
    (lc, gc, launches, tc), (lh, gh, _, th) = out
    rel = abs(lc - lh) / abs(lh)
    zero = sorted(k for k in gh if k.endswith("k_proj.bias"))
    cos = {k: float(torch.nn.functional.cosine_similarity(
        gc[k].double().flatten(), v.double().flatten(), dim=0))
        for k, v in gh.items() if k not in zero}
    worst = min(cos, key=cos.get)
    vanish = max([float(max(gc[k].norm(), gh[k].norm())
                        / gh[k.replace("bias", "weight")].norm())
                  for k in zero] or [0.0])
    print(json.dumps({f"sed_{arch}_step_card_vs_cpu": {
        "card": CARD, "batch": CMP_B, "loss": [lc, lh], "loss_rel": rel,
        "leaves_compared": len(cos), "lowest_cos": [worst, cos[worst]],
        "key_bias_grad_over_key_weight_grad": vanish,
        "launches": launches, "card_s": tc, "cpu_s": th}}))
    check(np.isfinite(lc) and rel <= CMP_LOSS_REL, f"sed_{arch}: card loss "
          f"{lc} vs CPU {lh} (rel {rel} <= {CMP_LOSS_REL})")
    check(cos[worst] >= CMP_LEAF_COS, f"sed_{arch}: every leaf's gradient "
          f"at cosine >= {CMP_LEAF_COS} to the CPU's (lowest {worst} "
          f"{cos[worst]})")
    check(vanish <= 1e-4, f"sed_{arch}: the key biases' gradients vanish "
          f"({vanish} of the key weights')")
    want = 12 if arch == "maeast" else 0
    check(launches.get("mha_fwd", 0) == want
          and launches.get("mha_bwd", 0) == want
          and not any(v for k, v in launches.items()
                      if k not in ("mha_fwd", "mha_bwd")),
          f"sed_{arch} step: {want} K6 forward and backward launches and "
          f"no other kernel ({launches})")
    return launches


def comparison_encoders_path(dev):
    """The eight comparison adapters at full width on the card: each built
    in memory through its loader's state-dict function from a seeded
    authors'-layout checkpoint, ``frame_embeddings`` of ``CMP_B`` clips of
    10 s on the card (the counted run: K6 12 times for each MAE-AST
    variant, no kernel for the others) against the CPU within ``CMP_REL``,
    ``T'`` = ``token_count``; clips/s at B = ``CMP_RATE_B`` and the peak;
    then one SED step of ``maeast`` and of ``beats`` on the card against
    the CPU (:func:`comparison_step_check`). Returns the launch counts of
    the counted forwards and the steps."""
    from audiossl_tpu_torch.compat import synthetic
    from audiossl_tpu_torch.downstream.comparison_models import (
        comparison_adapter)
    from audiossl_tpu_torch.kernels import build as kb

    wav = seeded_clips(CMP_RATE_B, SEED + 66)
    valid = torch.full((CMP_RATE_B,), SAMPLES, dtype=torch.long)
    wav_d, valid_d = wav.to(dev), valid.to(dev)
    total, ckpts, rates = {}, {}, {}
    # the variants of a family together: one checkpoint each family
    for arch in ("audioMAE", "mmd", "ssast", "patchssast", "maeast",
                 "patchmaeast", "beats", "byola"):
        fam = synthetic.FAMILY[arch]
        if fam not in ckpts:
            ckpts = {fam: synthetic.authors_checkpoint(arch,
                                                       seed=SEED + 67)}
        ckpt = ckpts[fam]
        ad = comparison_adapter(
            arch, synthetic.encoder_from_checkpoint(arch, ckpt, dev))
        ad_cpu = comparison_adapter(
            arch, synthetic.encoder_from_checkpoint(arch, ckpt, "cpu"))
        torch.cuda.synchronize()
        kb.reset_launches()
        with torch.no_grad():
            card = ad.frame_embeddings(wav_d[:CMP_B], valid_d[:CMP_B])
        torch.cuda.synchronize()
        launches = dict(kb.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        with torch.no_grad():
            host = ad_cpu.frame_embeddings(wav[:CMP_B], valid[:CMP_B])
        err = rel_l2(card.cpu(), host)
        T = ad.token_count(SAMPLES)
        want_k6 = 12 if fam == "maeast" else 0
        check(tuple(card.shape) == (CMP_B, T, ad.embed_dim)
              and bool(torch.isfinite(card).all()),
              f"{arch}: frames {tuple(card.shape)} finite, T' = token_count "
              f"= {T}, D = {ad.embed_dim}")
        check(err <= CMP_REL, f"{arch}: card frames vs CPU rel L2 {err} <= "
              f"{CMP_REL}")
        check(launches.get("mha_fwd", 0) == want_k6 and not any(
            v for k, v in launches.items() if k != "mha_fwd"),
            f"{arch}: {want_k6} K6 launches a forward and no other kernel "
            f"({launches})")
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ad.frame_embeddings(wav_d, valid_d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                ad.frame_embeddings(wav_d, valid_d)
            torch.cuda.synchronize()
        rates[arch] = {"clips_per_s": 3 * CMP_RATE_B
                       / (time.perf_counter() - t0),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "card_vs_cpu_rel_l2": err, "frames": T,
                       "embed_dim": ad.embed_dim, "k6_launches": want_k6}
        print(json.dumps({f"comparison_{arch}": dict(card=CARD,
                                                     **rates[arch])}))
        del card
        torch.cuda.empty_cache()
        if arch in ("maeast", "beats"):
            for k, v in comparison_step_check(dev, arch, ckpt,
                                              ad_cpu).items():
                total[k] = total.get(k, 0) + v
        del ad, ad_cpu
        torch.cuda.empty_cache()
    print(json.dumps({"comparison_encoders_B32": dict(card=CARD, **rates)}))
    return total


def comparison_sed_path(dev, workdir, dcase, as_strong):
    """``train_dcase --arch maeast`` (finetuning: K6 forward and backward)
    and ``train_as_strong --arch beats --freeze_mode``, one epoch each at
    batches of ``CMP_SED_B`` (DCASE: half strong, half weak), on the SED
    paths' trees, each reading one authors'-layout file (seeded, full
    width) written to ``workdir``: K6 12 times a train and evaluation
    batch (and 12 backward a train batch) for MAE-AST and no other
    kernel, none for BEATs; ``result.json`` finite in [0, 1]; train clips/s
    (the first step left out), eval clips/s and the peak. Returns the
    launch counts of both runs."""
    from audiossl_tpu_torch.compat import synthetic
    from audiossl_tpu_torch.downstream import train_as_strong, train_dcase

    total = {}
    for name, arch, main, data, extra in (
            ("comparison_sed_dcase_maeast", "maeast", train_dcase.main, dcase,
             ["--batch_size_synth", str(CMP_SED_B // 2),
              "--batch_size_weak", str(CMP_SED_B // 2),
              "--learning_rate", "0.01"]),
            ("comparison_sed_as_strong_beats", "beats",
             train_as_strong.main, as_strong,
             ["--batch_size", str(CMP_SED_B), "--learning_rate", "1e-3",
              "--freeze_mode"])):
        path = os.path.join(workdir, f"{arch}_authors.pt")
        torch.save(synthetic.authors_checkpoint(arch, seed=SEED + 68), path)
        out = os.path.join(workdir, name)
        argv = ["--pretrained_ckpt_path", path, "--data_path", data,
                "--arch", arch, "--max_epochs", "1", "--warmup_epochs", "1",
                "--save_path", out, "--device", str(dev), "--n_devices", "1",
                *extra]
        torch.cuda.empty_cache()
        res, record, launches, peak, wall = run_timed(main, argv)
        steps = [s for epoch in record["steps"] for s in epoch]
        evals = [b for epoch in record["evals"] for b in epoch]
        n_eval = len(evals) + len(record["test"]["strong"])
        if arch == "maeast":
            want = {"mha_fwd": 12 * (len(steps) + n_eval),
                    "mha_bwd": 12 * len(steps)}
        else:
            want = {}
        got = {k: v for k, v in launches.items() if v}
        print(f"{name} launches: {launches}; {len(steps)} train, "
              f"{len(evals)} validation and {len(record['test']['strong'])} "
              f"test batches; main took {wall:.2f} s")
        check(got == want, f"{name}: launches {got} == {want}")
        with open(os.path.join(out, "result.json")) as f:
            result = json.load(f)
        check(result == res and set(result) == {"psds1", "psds2",
                                                "event_f1"},
              f"{name} result.json {result}")
        for k, v in result.items():
            check(np.isfinite(v) and 0.0 <= v <= 1.0,
                  f"{name} {k} {v} finite in [0, 1]")
        train = steps[1:]
        print(json.dumps({name: {
            "card": CARD, "batch": steps[0][0] if steps else None,
            "train_clips_per_s": (sum(n for n, _, _ in train)
                                  / sum(t for _, t, _ in train)
                                  if train else None),
            "eval_clips_per_s": sum(n for n, _, _ in evals)
            / sum(t for _, t, _ in evals),
            "peak_gib": peak, "main_s": wall, "result": res}}))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del record
    return total


def train_mel_check(dev):
    """The training mel (``stft_precision="default"``: TF32 STFT on the
    card) against the f32 serving mel on the same crops."""
    from audiossl_tpu_torch.ops.melspec import MelConfig, log_melspec

    rng = np.random.RandomState(SEED + 5)
    wav = torch.from_numpy((rng.randn(TRAIN_B, SAMPLES) * 0.1).astype(
        np.float32)).to(dev)
    valid = torch.full((TRAIN_B,), SAMPLES, device=dev)
    valid[1::3] = SAMPLES * 3 // 4  # some crops shorter than the anchor
    got = log_melspec(wav, valid, MelConfig(stft_precision="default"))
    want = log_melspec(wav, valid, MelConfig())
    err = (got - want).abs()
    print(f"training mel (TF32 STFT) vs f32 mel {tuple(got.shape)}: max abs "
          f"{float(err.max())}, mean abs {float(err.mean())}")
    check(float(err.max()) <= MEL_TF32_ATOL,
          f"TF32 training mel within {MEL_TF32_ATOL} of the f32 mel")


def base_recipe():
    """ATST-Frame base as ``bench.py:358-378`` times it."""
    from audiossl_tpu_torch.methods.atstframe.method import FramePretrainConfig
    from audiossl_tpu_torch.training.pretrain import OptimizerConfig

    return FramePretrainConfig(
        arch="base", anchor_len=10.0, mask_type="block", mask_ratio=0.65,
        mask_len=5, aug_tea=False, aug_stu=True, dtype="bfloat16",
        optimizer=OptimizerConfig(learning_rate=8e-5, warmup_steps=19900,
                                  max_steps=398000, ema=0.9996))


def clip_recipe(dtype):
    """ATST-Clip small as ``bench.py:119-129`` times it (two independent 6 s
    crops of each 10 s clip, mixup and RandomResizeCrop on both views)."""
    from audiossl_tpu_torch.methods.atst.method import ClipPretrainConfig
    from audiossl_tpu_torch.training.pretrain import OptimizerConfig

    return ClipPretrainConfig(
        arch="small", anchor_len=(6.0, 6.0), positive_len=(6.0, 6.0),
        optimizer=OptimizerConfig(learning_rate=5e-4, warmup_steps=1300,
                                  max_steps=39100, ema=0.99), dtype=dtype)


def student_leaves(dev):
    """Shapes of the base student branch's parameters, whether the teacher
    holds each, and whether each decays (K7's main-path leaves)."""
    from audiossl_tpu_torch.methods.atstframe.method import FrameMethod

    m = FrameMethod(base_recipe(), device="meta")
    t_names = {k for k, _ in m.teacher.named_parameters()}
    leaves = list(m.student.named_parameters())
    return ([tuple(p.shape) for _, p in leaves],
            [k in t_names for k, _ in leaves], [p.ndim >= 2 for _, p in leaves])


def zero1_leaves(shapes, teacher, decay):
    """``student_leaves`` split as ZeRO-1 splits them over ``DDP_RANKS``
    ranks (``parallel.partition_leaves``): each rank's K7 leaves."""
    from audiossl_tpu_torch.parallel.mesh import partition_leaves

    owner = partition_leaves([4 * int(np.prod(s)) for s in shapes], DDP_RANKS)
    return [tuple([x for x, o in zip(lst, owner) if o == r]
                  for lst in (shapes, teacher, decay))
            for r in range(DDP_RANKS)]


def wav_batch(dev, samples, seed, short=None):
    """B=96 clips of seeded noise; with ``short``, every fourth clip holds
    only that many valid samples."""
    rng = np.random.RandomState(seed)
    wav = torch.from_numpy((rng.randn(TRAIN_B, samples) * 0.1).astype(
        np.float32)).to(dev)
    valid = torch.full((TRAIN_B,), samples, device=dev)
    if short is not None:
        valid[1::4] = short
        wav[1::4, short:] = 0.0
    return {"wav": wav, "valid": valid}


def counted_step(step, state, batch, draws=None):
    """One step with the launch counts set to 0 just before it and read
    just after; returns (metrics, launches)."""
    from audiossl_tpu_torch.kernels import build as kb

    torch.cuda.synchronize()
    kb.reset_launches()
    out = step(state, batch, draws)
    torch.cuda.synchronize()
    return out, dict(kb.LAUNCHES)


def check_launches(label, launches, want):
    """Every kernel launched exactly as often as ``want`` says (0 where it
    says nothing)."""
    print(f"{label} launches: {launches}")
    for name, count in launches.items():
        n = want.get(name, 0)
        check(count == n, f"{label}: {name} launched {count} times == {n}")


def leaf_cos(a, b, skip):
    """Per-leaf cosine of the student gradients of states ``a`` and ``b``
    (leaves in ``skip`` left out), the leaves neither holds a gradient for,
    and each leaf's larger gradient norm."""
    cos, norms, unused = {}, {}, []
    bparams = dict(b.student.named_parameters())
    for k, p in a.student.named_parameters():
        if p.grad is None and bparams[k].grad is None:
            unused.append(k)  # a clip encoder's mask_embed
            continue
        g, pg = p.grad.double().flatten(), bparams[k].grad.double().flatten()
        norms[k] = max(float(g.norm()), float(pg.norm()))
        if k not in skip:
            cos[k] = float(torch.nn.functional.cosine_similarity(g, pg, dim=0))
    return cos, unused, norms


def step_path(dev, label, make_method, batch, want, loss_rel, grad_cos,
              profile_dir=None, make_ref=None, rival=None, timed=True,
              ref_margins=(REF_MEDIAN_MARGIN, REF_MIN_MARGIN),
              grad_floor=None, bn_projector=True):
    """One step of ``make_method(plain=False)`` through the kernels (launch
    counts, finite loss, a teacher that moved, or the model where the state
    has no teacher), the same step from the same
    state and draws through every plain version (``make_method(True)``),
    and clips/s of both paths in turns; returns the kernel path's
    launches. Both states start at the end of warmup, so the step moves
    the parameters at the recipe's peak lr (at step 0 the warmup lr is
    0). The gradients of the two paths are held to a leaf cosine of
    ``grad_cos``; with ``make_ref`` (a method that runs the step in f32
    through the plain versions) each path is held to that step instead,
    the kernels' median and lowest leaf cosine within ``ref_margins`` of
    the plain version's on either side, and the two paths to a median leaf
    cosine of ``grad_cos`` and a lowest of ``grad_floor`` where given.
    ``rival`` (label, method factory) adds another method's kernel-path
    step to the turns; ``timed=False`` leaves the turns out. Behind a
    BatchNorm projector the student's final norm bias has no gradient in
    exact arithmetic (``ZERO_GRAD_REL``); ``bn_projector=False`` (the
    data2vec student's linear projector, MAE and dual, which have none)
    holds it as any other leaf."""
    runs = {}
    for plain in (False, True):
        method = make_method(plain)
        state = method.init_state(seed=SEED)
        state.step = method.cfg.optimizer.warmup_steps
        runs[plain] = (method, state, method.make_step())
    method, state, step = runs[False]
    cfg = method.cfg
    draws = method.draw(torch.Generator(device=dev).manual_seed(SEED),
                        TRAIN_B)
    # a leaf of the last block of the teacher, or of the model
    watched = state.student if state.teacher is None else state.teacher
    t_name = next(k for k, _ in watched.named_parameters()
                  if k.endswith(f"blocks.{method.depth - 1}.mlp.fc2.weight"))
    who = "model" if state.teacher is None else "teacher"
    t_before = dict(watched.named_parameters())[t_name].detach().clone()

    torch.cuda.reset_peak_memory_stats()
    out, launches = counted_step(step, state, batch, draws)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = float(out["loss"])
    # MAE's config names no arch and no dtype: its defaults, in f32
    print(f"{label} step ({getattr(cfg, 'arch', 'defaults')}, B={TRAIN_B}, "
          f"{getattr(cfg, 'dtype', 'float32')}): "
          + ", ".join(f"{k} {float(v)}" for k, v in out.items())
          + f"; peak device memory {peak} GiB")
    check_launches(f"{label} step", launches, want)
    check(np.isfinite(loss), f"{label} loss {loss} finite")
    t_after = dict(watched.named_parameters())[t_name].detach()
    moved = float((t_after - t_before).abs().max())
    check(moved > 0.0, f"{label}: the {who} moved ({t_name} max change "
          f"{moved})")

    pmethod, pstate, pstep = runs[True]
    pout = pstep(pstate, batch, draws)
    ploss = float(pout["loss"])
    rel = abs(loss - ploss) / abs(ploss)
    skip = set()
    if bn_projector:
        zero_grad = f"encoder.{method.student.encoder._norm_name}.bias"
        skip = {zero_grad}
    cos, unused, norms = leaf_cos(state, pstate, skip)
    worst = min(cos, key=cos.get)
    print(f"{label} plain-path step loss {ploss}: rel diff {rel}; gradient "
          f"cosine min {cos[worst]} ({worst}), median "
          f"{float(np.median(list(cos.values())))} over {len(cos)} leaves "
          f"(no gradient on either path: {unused})" + "".join(
              f"; {k} gradient norm {norms[k]} (largest leaf "
              f"{max(norms.values())})" for k in skip))
    check(rel <= loss_rel, f"{label} step loss rel diff {rel} <= {loss_rel}")
    if make_ref is None:
        check(cos[worst] >= grad_cos,
              f"{label}: every gradient leaf cosine >= {grad_cos}")
    else:
        if grad_cos is not None:
            med = float(np.median(list(cos.values())))
            check(med >= grad_cos,
                  f"{label}: median gradient leaf cosine {med} >= {grad_cos}")
        if grad_floor is not None:
            check(cos[worst] >= grad_floor, f"{label}: lowest gradient leaf "
                  f"cosine {cos[worst]} >= {grad_floor}")
        torch.cuda.empty_cache()
        rmethod = make_ref()
        rstate = rmethod.init_state(seed=SEED)
        rstate.step = rmethod.cfg.optimizer.warmup_steps
        rloss = float(rmethod.make_step()(rstate, batch, draws)["loss"])
        stats = {}
        for name, st, lo in (("kernel", state, loss), ("plain", pstate, ploss)):
            c = leaf_cos(st, rstate, skip)[0]
            low = sorted(c, key=c.get)[:3]
            stats[name] = (float(np.median(list(c.values()))), c[low[0]])
            print(f"{label} {name} path vs the f32 plain step (loss {rloss}):"
                  f" loss rel diff {abs(lo - rloss) / abs(rloss)}; gradient "
                  f"cosine median {stats[name][0]}, lowest "
                  f"{[(k, c[k]) for k in low]}")
        (km, kmin), (pm, pmin) = stats["kernel"], stats["plain"]
        check(abs(km - pm) <= ref_margins[0],
              f"{label}: median leaf cosine to the f32 step {km} within "
              f"{ref_margins[0]} of the plain path's {pm}")
        check(abs(kmin - pmin) <= ref_margins[1],
              f"{label}: lowest leaf cosine to the f32 step {kmin} within "
              f"{ref_margins[1]} of the plain path's {pmin}")
        del rmethod, rstate
    if bn_projector:
        check(norms[zero_grad] <= ZERO_GRAD_REL * max(norms.values()),
              f"{label}: {zero_grad} gradient (zero in exact arithmetic) <= "
              f"{ZERO_GRAD_REL} of the largest leaf's on both paths")

    if not timed:
        return launches
    # clips/s in turns: plain, kernels, [rival, rival,] kernels, plain
    # (1 warm-up + 3 steps each)
    turns = {"plain": runs[True], "kernels": runs[False]}
    order = ["plain", "kernels", "kernels", "plain"]
    if rival is not None:
        rmethod = rival[1]()
        rstate = rmethod.init_state(seed=SEED)
        rstate.step = rmethod.cfg.optimizer.warmup_steps
        turns[rival[0]] = (rmethod, rstate, rmethod.make_step())
        order[2:2] = [rival[0], rival[0]]
    rates = {k: [] for k in turns}
    card_state(f"{label} turns, before")
    for which in order:
        _, st, fn = turns[which]
        fn(st, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn(st, batch)
        torch.cuda.synchronize()
        rates[which].append(3 * TRAIN_B / (time.perf_counter() - t0))
    card_state(f"{label} turns, after")
    print(json.dumps({f"{label}_clips_per_s_B96": rates,
                      f"{label}_peak_gib_kernels": peak}))
    if profile_dir:
        profile_step(step, state, batch, profile_dir, label)
    return launches


def frame_bf16_path(dev, profile_dir=None):
    """The ATST-Frame base step at B=96 through K1-K5, K7 and K8 (the
    student's final norm)."""
    from audiossl_tpu_torch.methods.atstframe.method import FrameMethod

    cfg = base_recipe()
    return step_path(
        dev, "frame_bf16",
        lambda plain: FrameMethod(cfg, device=dev, seed=SEED, plain=plain),
        wav_batch(dev, cfg.out_samples, SEED + 4), bf16_want(1),
        STEP_LOSS_REL, STEP_GRAD_COS, profile_dir)


def frame_d2v_path(dev):
    """The data2vec variant of the ATST-Frame base step (``avg_blocks=8``)
    at B=96 in bf16, untimed: the teacher's K2/K3 collect its last 8 block
    outputs, whose instance-normalized mean is the target; the student has
    a linear projector and no predictor. Its projector returns bf16, so
    its normalization and loss run in bf16, as JAX's do (a loss near 2
    lands on bf16's steps of 2^-6 there), and that rounding dominates the
    gradient: it is held as the clip bf16 step is, both paths against the
    same step in f32."""
    import dataclasses

    from audiossl_tpu_torch.methods.atstframe.method import FrameMethod

    cfg = dataclasses.replace(base_recipe(), avg_blocks=8)
    ref_cfg = dataclasses.replace(cfg, dtype="float32")
    return step_path(
        dev, "frame_bf16_d2v",
        lambda plain: FrameMethod(cfg, device=dev, seed=SEED, plain=plain),
        wav_batch(dev, cfg.out_samples, SEED + 17), bf16_want(1),
        STEP_LOSS_REL, None, timed=False, bn_projector=False,
        make_ref=lambda: FrameMethod(ref_cfg, device=dev, seed=SEED,
                                     plain=True))


def clip_f32_path(dev, profile_dir=None):
    """The ATST-Clip small step at B=96, f32, through K1, K6, K8 and K7:
    per step K6 forward in the 12 student and 12 teacher blocks, its
    backward in the student's 12, K8 for the student's 24 block norms and
    its final norm, one mel per view. Every fourth clip holds 5 s of
    audio, so its crops are shorter than 6 s and carry padding."""
    from audiossl_tpu_torch.methods.atst.method import ClipMethod

    cfg = clip_recipe("float32")
    return step_path(
        dev, "clip_f32",
        lambda plain: ClipMethod(cfg, device=dev, seed=SEED, plain=plain),
        wav_batch(dev, SAMPLES, SEED + 8, short=80000),
        dict(mha_fwd=24, mha_bwd=12, ln_pg_bwd=25, mel_db=2, adamw_ema=1),
        F32_STEP_LOSS_REL, F32_STEP_GRAD_COS, profile_dir)


def clip_bf16_path(dev):
    """The ATST-Clip small step at B=96 in bf16 (the CLI's recipe): K4/K5
    for the student and K2/K3 for the teacher over N = 151 tokens with the
    CLS token, K8 for the student's final norm; its gradients held to the
    f32 step's as closely as the plain version's are (``REF_*_MARGIN``)."""
    from audiossl_tpu_torch.methods.atst.method import ClipMethod

    cfg, ref_cfg = clip_recipe("bfloat16"), clip_recipe("float32")
    return step_path(
        dev, "clip_bf16",
        lambda plain: ClipMethod(cfg, device=dev, seed=SEED, plain=plain),
        wav_batch(dev, SAMPLES, SEED + 9, short=80000), bf16_want(2),
        STEP_LOSS_REL,
        None,
        make_ref=lambda: ClipMethod(ref_cfg, device=dev, seed=SEED,
                                    plain=True))


def frame_f32_path(dev, profile_dir=None):
    """The ATST-Frame base step at B=96 at the config's default dtype f32
    (the route that raised before the f32 encoders took K6 and
    LayerNormPG): K6 forward in the 12 student and 12 teacher blocks,
    backward in the student's 12, K8 for the student's 24 block norms and
    its final norm."""
    from audiossl_tpu_torch.methods.atstframe.method import (
        FrameMethod, FramePretrainConfig)

    cfg = FramePretrainConfig(arch="base")
    check(cfg.dtype == "float32", "the ATST-Frame config's default dtype is "
          "float32")
    return step_path(
        dev, "frame_f32",
        lambda plain: FrameMethod(cfg, device=dev, seed=SEED, plain=plain),
        wav_batch(dev, cfg.out_samples, SEED + 10),
        dict(mha_fwd=24, mha_bwd=12, ln_pg_bwd=25, mel_db=1, adamw_ema=1),
        F32_STEP_LOSS_REL, F32_STEP_GRAD_COS, profile_dir)


def q8_recipe(recipe, student_quant):
    """``recipe`` with the int8 teacher (K2q/K3q) and the student's int8
    forward (K4q/K5q), its backward int8dx (the K4q/K5q backward) or the
    float K4/K5 backward on the dequantized weights."""
    import dataclasses

    return dataclasses.replace(recipe, teacher_quant="int8",
                               student_quant=student_quant)


def bf16_want(mel):
    """Launches per step of a bf16 step on the block kernels (12 blocks):
    K4/K5 for the student, K2/K3 for the teacher, K8 for the student's
    final norm, ``mel`` K1 and one K7."""
    want = {k: 12 for k in ("attn_train_fwd", "attn_train_bwd",
                            "mlp_train_fwd", "mlp_train_bwd", "attn_block",
                            "mlp_block")}
    want.update(mel_db=mel, adamw_ema=1, ln_pg_bwd=1)
    return want


def q8_want(student_quant, mel):
    """Launches per step of an int8 recipe on the bf16 block kernels."""
    bwd = "_q8dx" if student_quant == "int8dx" else ""
    want = {k: 12 for k in ("attn_block_q8", "mlp_block_q8",
                            "attn_train_fwd_q8", "mlp_train_fwd_q8",
                            f"attn_train_bwd{bwd}", f"mlp_train_bwd{bwd}")}
    want.update(mel_db=mel, adamw_ema=1, ln_pg_bwd=1)
    return want


def rounding_witness(dev, label, make_method, make_ref, batch):
    """The plain-version step against itself on the waveform scaled by
    ``WITNESS_GAIN``, from the same state and draws, and the same for the
    f32 step (``make_ref``), which must follow the shift within
    ``F32_STEP_GRAD_COS``: how far rounding alone moves the plain path's
    gradient. Returns its lowest leaf cosine."""
    gained = dict(batch, wav=batch["wav"] * WITNESS_GAIN)
    low, draws = {}, None
    for name, make in (("plain", lambda: make_method(True)), ("f32", make_ref)):
        states = []
        for b in (batch, gained):
            method = make()
            st = method.init_state(seed=SEED)
            st.step = method.cfg.optimizer.warmup_steps
            if draws is None:
                draws = method.draw(
                    torch.Generator(device=dev).manual_seed(SEED), TRAIN_B)
            method.make_step()(st, b, draws)
            states.append(st)
            zero_grad = f"encoder.{method.student.encoder._norm_name}.bias"
            del method
            torch.cuda.empty_cache()
        c = leaf_cos(*states, {zero_grad})[0]
        lowest = sorted(c, key=c.get)[:3]
        low[name] = c[lowest[0]]
        print(f"{label} {name} step vs itself on the waveform x "
              f"{WITNESS_GAIN}: gradient cosine median "
              f"{float(np.median(list(c.values())))}, lowest "
              f"{[(k, c[k]) for k in lowest]}")
        del states
        torch.cuda.empty_cache()
    check(low["f32"] >= F32_STEP_GRAD_COS,
          f"{label}: the f32 step follows the gain within "
          f"{F32_STEP_GRAD_COS} (lowest leaf cosine {low['f32']})")
    return low["plain"]


def frame_q8_path(dev, student_quant, profile_dir=None):
    """The int8 ATST-Frame base step at B=96: its loss and its median leaf
    cosine held to the same step through the plain versions, its lowest
    leaf cosine to the plain step's own under a rounding-scale shift of
    the input (``rounding_witness``) less ``WITNESS_MARGIN``, and both
    paths' gradients to the same step in f32 (plain versions), the kernels
    within ``Q8_REF_MARGINS`` of the plain path: an int8 code turns on
    rounding, so a last-bit difference upstream moves a product by a whole
    step, and the two paths' gradients sit further apart than in bf16
    (lowest leaf cosine 0.989 against 0.996, PERF.md). Under ``"int8dx"``
    timed in turns with the bf16 frame step, under ``"int8"`` (the shorter
    phase) not timed."""
    import dataclasses

    from audiossl_tpu_torch.methods.atstframe.method import FrameMethod

    cfg = q8_recipe(base_recipe(), student_quant)
    label = f"frame_{student_quant}"
    timed = student_quant == "int8dx"
    batch = wav_batch(dev, cfg.out_samples, SEED + 13)

    def make(plain):
        return FrameMethod(cfg, device=dev, seed=SEED, plain=plain)

    def make_ref():
        return FrameMethod(dataclasses.replace(cfg, dtype="float32"),
                           device=dev, seed=SEED, plain=True)

    floor = rounding_witness(dev, label, make, make_ref, batch)
    return step_path(
        dev, label, make, batch, q8_want(student_quant, 1), STEP_LOSS_REL,
        STEP_GRAD_COS, profile_dir if timed else None, make_ref=make_ref,
        rival=("bf16_kernels", lambda: FrameMethod(
            base_recipe(), device=dev, seed=SEED)) if timed else None,
        timed=timed, ref_margins=Q8_REF_MARGINS,
        grad_floor=floor - WITNESS_MARGIN)


def clip_q8_path(dev, student_quant):
    """The ATST-Clip small bf16 step at B=96 with the int8 teacher and
    ``student_quant``, untimed: K2q/K3q for the teacher and K4q/K5q for the
    student over N = 151 tokens with the CLS token; held as the bf16 clip
    step is (loss to its plain-version step, both paths' gradients to the
    f32 step within ``REF_*_MARGIN`` of each other)."""
    from audiossl_tpu_torch.methods.atst.method import ClipMethod

    cfg = q8_recipe(clip_recipe("bfloat16"), student_quant)
    ref_cfg = clip_recipe("float32")
    return step_path(
        dev, f"clip_{student_quant}",
        lambda plain: ClipMethod(cfg, device=dev, seed=SEED, plain=plain),
        wav_batch(dev, SAMPLES, SEED + 14, short=80000),
        q8_want(student_quant, 2), STEP_LOSS_REL, None,
        make_ref=lambda: ClipMethod(ref_cfg, device=dev, seed=SEED,
                                    plain=True),
        timed=False)


def mae_recipe():
    """MAE at ``MAEConfig``'s defaults: encoder 384 wide, 12 blocks, 6
    heads; decoder 384 wide, 6 blocks, 6 heads; 6 s crops, 148 patches,
    111 of them masked."""
    from audiossl_tpu_torch.methods.mae.method import MAEConfig

    return MAEConfig()


def dual_recipe(dtype):
    """Dual at ``--arch small``: two 384-wide, 12-block, 6-head encoders
    without a CLS token, expanders of 8192, output 256, at 6.4 s crops."""
    from audiossl_tpu_torch.methods.dual.method import DualConfig

    return DualConfig(arch="small", anchor_len=DUAL_ANCHOR, dtype=dtype)


MAE_WANT = dict(mel_db=1, adamw_ema=1)  # its blocks take the module route


def dual_want(dtype):
    """Launches per step of the dual small step: both encoders' 12 blocks
    on K6 and K8 (two norms a block and the final norm) in f32, on K4/K5
    with K8 for the final norms in bf16; one K1 and one K7."""
    if dtype == "float32":
        want = dict(mha_fwd=24, mha_bwd=24, ln_pg_bwd=50)
    else:
        want = {k: 24 for k in ("attn_train_fwd", "attn_train_bwd",
                                "mlp_train_fwd", "mlp_train_bwd")}
        want["ln_pg_bwd"] = 2
    want.update(mel_db=1, adamw_ema=1)
    return want


def mae_small_path(dev):
    """The MAE step at its defaults, B = 96 (every fourth clip 5 s of
    audio), f32: K1 and K7 (no teacher leaf) and no block kernel; held to
    its plain-version step at the f32 bounds."""
    from audiossl_tpu_torch.methods.mae.method import MAEMethod

    cfg = mae_recipe()
    check((cfg.n_patches, cfg.n_masked) == (148, 111),
          f"MAE at 6 s: 148 patches, 111 masked ({cfg.n_patches}, "
          f"{cfg.n_masked})")
    return step_path(
        dev, "mae_small",
        lambda plain: MAEMethod(cfg, device=dev, seed=SEED, plain=plain),
        wav_batch(dev, SAMPLES, SEED + 50, short=80000), MAE_WANT,
        F32_STEP_LOSS_REL, F32_STEP_GRAD_COS, bn_projector=False)


def dual_f32_path(dev):
    """The dual small step at 6.4 s, B = 96, f32 (its default dtype): K6
    forward and backward in both encoders' 24 blocks, K8 for their 50
    norms, K1 and K7 (no teacher leaf); held to its plain-version step at
    the f32 bounds."""
    from audiossl_tpu_torch.methods.dual.method import DualMethod

    cfg = dual_recipe("float32")
    check(cfg.out_frames == 641 and cfg.n_groups == 40,
          f"dual at {DUAL_ANCHOR} s: 641 frames, 40 groups")
    return step_path(
        dev, "dual_f32",
        lambda plain: DualMethod(cfg, device=dev, seed=SEED, plain=plain),
        wav_batch(dev, SAMPLES, SEED + 51, short=80000), dual_want("float32"),
        F32_STEP_LOSS_REL, F32_STEP_GRAD_COS, bn_projector=False)


def dual_bf16_path(dev):
    """The dual small step in bf16: K4/K5 in both encoders' 24 blocks, K8
    for the final norms, K1 and K7; both paths' gradients held to the same
    step in f32 (plain versions) as the clip bf16 step is
    (``REF_*_MARGIN``)."""
    from audiossl_tpu_torch.methods.dual.method import DualMethod

    cfg, ref_cfg = dual_recipe("bfloat16"), dual_recipe("float32")
    return step_path(
        dev, "dual_bf16",
        lambda plain: DualMethod(cfg, device=dev, seed=SEED, plain=plain),
        wav_batch(dev, SAMPLES, SEED + 52, short=80000),
        dual_want("bfloat16"), STEP_LOSS_REL, None, bn_projector=False,
        make_ref=lambda: DualMethod(ref_cfg, device=dev, seed=SEED,
                                    plain=True))


def adamw_no_teacher_check(dev, label, make_meta):
    """K7 over the leaves of a method with no teacher (``make_meta()``
    builds it on the meta device), as ``adamw_ema_check`` holds it, and
    its library call: ``torch.optim.AdamW(fused=True)`` over the same
    leaves (decay 0.04 on the leaves of two or more dimensions, none on
    the rest), the same update with no EMA."""
    model = make_meta().model
    leaves = [p for _, p in model.named_parameters()]
    shapes = [tuple(p.shape) for p in leaves]
    decay = [p.ndim >= 2 for p in leaves]
    del model, leaves
    n = sum(int(np.prod(s)) for s in shapes)
    print(f"K7 {label}: {len(shapes)} leaves, {n} parameters, no teacher "
          "copy")
    res = adamw_ema_check(dev, shapes, [False] * len(shapes), decay)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    params = [torch.nn.Parameter(torch.randn(s, device=dev, generator=gen)
                                 * 0.02) for s in shapes]
    for p in params:
        p.grad = torch.randn(p.shape, device=dev, generator=gen) * 1e-3
    opt = torch.optim.AdamW(
        [{"params": [p for p, d in zip(params, decay) if d],
          "weight_decay": 0.04},
         {"params": [p for p, d in zip(params, decay) if not d],
          "weight_decay": 0.0}],
        lr=8e-5, betas=(0.9, 0.999), eps=1e-6, fused=True)
    opt.step()  # makes the moments
    res.update(parameters=n, library_ms=cuda_ms(opt.step, iters=10),
               library="torch.optim.AdamW(fused=True)")
    print(f"K7 {label}: {res['ms']} ms (CUDA events), {res['device_ms']} ms "
          f"(device), plain {res['plain_ms']} ms, AdamW(fused=True) "
          f"{res['library_ms']} ms; bound {res['bound_ms']} ms")
    del params, opt
    torch.cuda.empty_cache()
    return res


CLI_PACK_N = 480  # tone clips of 2-10 s: 5 batches of TRAIN_B an epoch
CLI_STEPS, CLI_CKPT, CLI_LOG = 12, 6, 3  # the timed CLI run
CLI_UNTIMED_STEPS = 3
CRASH_STEPS, CRASH_CKPT = 8, 3
RESTORE_COS = 0.99999  # a step from a restored state, if not bit-equal


class Tee:
    """stdout that also keeps what was written (the runner's lines)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.out.write(s)
        self.parts.append(s)
        return len(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def write_cli_pack(workdir):
    """The seeded int16 pack the CLI phases read: ``CLI_PACK_N`` tone clips
    of 2-10 s (~90 MB, 5 batches of ``TRAIN_B`` an epoch)."""
    from audiossl_tpu_torch.datasets import write_synthetic_pack

    data = os.path.join(workdir, "pretrain_pack")
    t0 = time.perf_counter()
    write_synthetic_pack(data, "train", CLI_PACK_N, min_s=2.0, max_s=10.0,
                         seed=SEED + 30, kind="tones")
    mb = os.path.getsize(os.path.join(data, "train.ards")) / 1e6
    print(f"pretraining pack written in {time.perf_counter() - t0:.1f} s: "
          f"{CLI_PACK_N} clips, {mb:.1f} MB")
    return data


def recipe_argv(name, data, save):
    """(module, arguments) of the ``python -m`` command of
    ``recipes/<name>``, with its ``$DATA`` and ``$SAVE``."""
    import shlex

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "recipes", name)) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith("python"))
    argv = shlex.split(line)
    check(argv[1] == "-m", f"{name} runs a module")
    args = [{"$DATA": data, "$SAVE": save}.get(a, a) for a in argv[3:]]
    return argv[2], args


def state_tensors(state):
    """Every tensor of a ``PretrainState`` by name (a teacher where it has
    one), and its step, count and generator state."""
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    if state.teacher is not None:
        out.update({f"teacher.{k}": v
                    for k, v in state.teacher.state_dict().items()})
    out.update({f"mu.{k}": v for k, v in state.mu.items()})
    out.update({f"nu.{k}": v for k, v in state.nu.items()})
    out["generator"] = state.generator.get_state()
    out["step"] = torch.tensor(state.step)
    out["count"] = torch.tensor(state.count)
    return out


def step_differences(a, b):
    """The tensors of states ``a`` and ``b`` that differ (``state_tensors``
    names) and the lowest cosine between a pair of them (floating, not all
    zero)."""
    a, b = state_tensors(a), state_tensors(b)

    def cos(x, y):  # no eps floor: Adam's nu holds values near 1e-12
        x, y = x.double().flatten(), y.double().flatten()
        return float(x @ y / (x.norm() * y.norm()))

    differ = [k for k in a if not torch.equal(a[k], b[k])]
    low = min(cos(a[k], b[k]) for k in a
              if a[k].is_floating_point() and a[k].abs().max() > 0)
    return differ, low


def pretrain_frame_cli_path(dev, workdir, data):
    """The frame CLI's run loop at ATST-Frame base, B = 96, bf16: the
    method built by ``build_method`` from ``recipes/
    torch_atst_frame_base.sh``'s arguments, ``run_pretraining`` for
    ``CLI_STEPS`` steps through the native loader with checkpoints every
    ``CLI_CKPT``; its launches, clips/s by interval beside the bare step's,
    each save's host copy and write, peak memory; then the last checkpoint
    restored into a fresh method (every tensor equal) and one step from
    each state on the same batch and draws. Returns the run's launches."""
    import contextlib
    import re

    from audiossl_tpu_torch.datasets import PackedAudioDataset
    from audiossl_tpu_torch.kernels import build as kb
    from audiossl_tpu_torch.methods.atstframe import train as ft
    from audiossl_tpu_torch.training.checkpoint import CheckpointManager
    from audiossl_tpu_torch.training.runner import run_pretraining

    save = os.path.join(workdir, "frame_cli")
    module, argv = recipe_argv("torch_atst_frame_base.sh", data, save)
    check(module == ft.__name__, f"the frame recipe runs {ft.__name__}")
    args = ft.build_parser().parse_args(argv + [
        "--n_devices", "1",
        "--batch_size_per_device", str(TRAIN_B), "--warmup_steps", "2",
        "--max_steps", str(CLI_STEPS), "--ckpt_interval", str(CLI_CKPT)])
    check(args.dtype == "bfloat16" and args.arch == "base"
          and args.device == "cuda", "the frame CLI's defaults: bf16 on the "
          "card, at base width")
    method = ft.build_method(args)
    dataset = PackedAudioDataset(data, "train", subset=args.subset)
    t_name = f"encoder.blocks.{method.depth - 1}.mlp.fc2.weight"
    init = dict(method.student.named_parameters())[t_name].detach().clone()

    tee = Tee(sys.stdout)
    torch.cuda.synchronize()
    kb.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        state = run_pretraining(
            method, dataset, batch_size_per_device=args.batch_size_per_device,
            max_steps=args.max_steps, save_path=args.save_path,
            ckpt_interval=args.ckpt_interval, log_interval=CLI_LOG,
            seed=args.seed, clip_len_s=args.clip_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = tee.text()
    check(state.step == CLI_STEPS, f"the frame CLI ran to step {CLI_STEPS}")
    check("loader: native" in out, "the frame CLI took the native loader")
    check_launches("pretrain_frame_cli", launches,
                   {k: n * CLI_STEPS for k, n in bf16_want(1).items()})
    steps = [(int(m.group(1)), m.group(2)) for m in
             re.finditer(r"^step (\d+) (.*)$", out, re.M)]
    vals = [dict(kv.split("=") for kv in rest.split()) for _, rest in steps]
    rates = [float(v["clips_per_sec"]) for v in vals]
    losses = [float(v["loss"]) for v in vals]
    check([s for s, _ in steps] == list(range(CLI_LOG, CLI_STEPS + 1,
                                              CLI_LOG)),
          f"a log line every {CLI_LOG} steps")
    check(all(np.isfinite(losses)), f"the frame CLI's losses {losses} finite")
    moved = float((dict(state.teacher.named_parameters())[t_name]
                   - init).abs().max())
    check(moved > 0.0, f"pretrain_frame_cli: the teacher moved ({t_name} max "
          f"change {moved})")
    copies = {int(s): float(ms) for s, ms in re.findall(
        r"^checkpoint step (\d+): host copy ([\d.]+) ms$", out, re.M)}
    writes = {int(s): float(x) for s, x in re.findall(
        r"^checkpoint step (\d+): written in ([\d.]+) s$", out, re.M)}
    want_saves = list(range(CLI_CKPT, CLI_STEPS + 1, CLI_CKPT))
    check(sorted(copies) == sorted(writes) == want_saves,
          f"checkpoints at steps {want_saves}")
    cli_rate = float(np.median(rates[1:4]))

    # the last checkpoint into a fresh method: every tensor equal
    fresh = ft.build_method(args)
    rstate = fresh.init_state(args.seed)
    mgr = CheckpointManager(os.path.join(save, "ckpt"), args.ckpt_interval)
    check(mgr.latest_step == CLI_STEPS and mgr.all_steps() == want_saves,
          f"kept steps {mgr.all_steps()}, the latest {mgr.latest_step}")
    t1 = time.perf_counter()
    mgr.restore_latest(rstate)
    restore_s = time.perf_counter() - t1
    a, b = state_tensors(state), state_tensors(rstate)
    check(a.keys() == b.keys(), "the restored state holds the same tensors")
    unequal = [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]
    check(not unequal, f"every restored tensor (of {len(a)}, the generator "
          f"state included) equal to the run's: unequal {unequal[:5]}")
    # one step from each on the same batch and draws
    batch = wav_batch(dev, method.cfg.out_samples, SEED + 31)
    draws = method.draw(torch.Generator(device=dev).manual_seed(SEED),
                        TRAIN_B)
    run_step, rstep = method.make_step(), fresh.make_step()
    la = float(run_step(state, batch, draws)["loss"])
    lb = float(rstep(rstate, batch, draws)["loss"])
    differ, low = step_differences(state, rstate)
    bit_equal = la == lb and not differ
    print(f"pretrain_frame_cli: the step after restore: loss {la} / {lb}, "
          f"bit-equal {bit_equal} ({len(differ)} tensors differ: "
          f"{differ[:6]}), lowest leaf cosine {low}")
    del fresh, rstate, rstep
    torch.cuda.empty_cache()
    # the control: one step from each of two states built alike (no save,
    # no restore), on the same batch and draws
    pair = []
    for _ in range(2):
        m = ft.build_method(args)
        st = m.init_state(args.seed)
        st.step = CLI_STEPS
        pair.append((m, st))
    a, b = state_tensors(pair[0][1]), state_tensors(pair[1][1])
    check(all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a),
          "the control's two states start equal")
    del a, b
    lc = [float(m.make_step()(st, batch, draws)["loss"]) for m, st in pair]
    cdiffer, clow = step_differences(pair[0][1], pair[1][1])
    control_equal = lc[0] == lc[1] and not cdiffer
    print(f"pretrain_frame_cli: control, one step from each of two equal "
          f"states: loss {lc[0]} / {lc[1]}, bit-equal {control_equal} "
          f"({len(cdiffer)} tensors differ: {cdiffer[:6]}), lowest leaf "
          f"cosine {clow}; {len(set(differ) & set(cdiffer))} of the "
          f"restored step's {len(differ)} differing tensors differ here too")
    del pair
    torch.cuda.empty_cache()
    check(bit_equal or not control_equal, "the step from the restored state "
          "is bit-equal to the run's wherever two equal states step alike")
    check(abs(la - lb) <= 1e-5 * abs(la) and low >= RESTORE_COS,
          f"the step from the restored state matches the run's (loss rel "
          f"1e-5, every leaf cosine >= {RESTORE_COS})")

    # the bare step on a resident batch, in the same process
    run_step(state, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        run_step(state, batch)
    torch.cuda.synchronize()
    bare = 3 * TRAIN_B / (time.perf_counter() - t1)
    print(json.dumps({"pretrain_frame_cli": {
        "loader": re.search(r"^loader: (.*)$", out, re.M).group(1),
        "clips_per_s_by_interval": rates, "cli_clips_per_s": cli_rate,
        "bare_step_clips_per_s": bare, "cli_over_bare": cli_rate / bare,
        "host_copy_ms": copies, "write_s": writes, "restore_s": restore_s,
        "peak_gib": peak, "wall_s": wall, "losses": losses,
        "restored_step_bit_equal": bit_equal,
        "restored_step_tensors_differing": len(differ),
        "control_step_bit_equal": control_equal,
        "control_step_tensors_differing": len(cdiffer),
        "cli_clips_per_s_whole_run": CLI_STEPS * TRAIN_B / wall}}))
    del method, state, run_step
    torch.cuda.empty_cache()
    return launches  # pretrain_eval reads the checkpoints, then removes them


def crash_restart_path(workdir, data):
    """``python -m ...atstframe.train`` at the recipe's arguments, B = 96,
    killed (SIGKILL) once its step-3 checkpoint exists; run again it must
    resume from step 3 (or 6), end at step 8 and keep at most 3 steps,
    8 the latest; a third run takes no step."""
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    save = os.path.join(workdir, "frame_crash")
    module, argv = recipe_argv("torch_atst_frame_base.sh", data, save)
    cmd = [sys.executable, "-m", module, *argv, "--n_devices", "1",
           "--batch_size_per_device", str(TRAIN_B), "--warmup_steps", "2",
           "--max_steps", str(CRASH_STEPS), "--ckpt_interval",
           str(CRASH_CKPT)]
    ckpt = os.path.join(save, "ckpt")
    first = os.path.join(ckpt, str(CRASH_CKPT), "state.pt")
    logs = []

    def run(i, kill_when=None):
        log = os.path.join(workdir, f"crash_run{i}.log")
        logs.append(log)
        t0 = time.perf_counter()
        with open(log, "w") as f:
            p = subprocess.Popen(cmd, cwd=root, stdout=f,
                                 stderr=subprocess.STDOUT)
            try:
                while p.poll() is None:
                    if kill_when is not None and os.path.exists(kill_when):
                        p.kill()
                        break
                    if time.perf_counter() - t0 > 400:
                        raise RuntimeError(f"crash run {i} took over 400 s")
                    time.sleep(0.1)
            finally:
                if p.poll() is None:
                    p.kill()
                p.wait()
        with open(log) as f:
            text = f.read()
        steps = sorted(int(n) for n in os.listdir(ckpt) if n.isdigit())
        print(f"crash run {i}: exit {p.returncode} after "
              f"{time.perf_counter() - t0:.1f} s; kept steps {steps}; "
              f"{[ln for ln in text.splitlines() if ln.startswith(('resumed', 'run ended', 'checkpoint'))]}")
        return p.returncode, text, steps

    rc, _, _ = run(1, kill_when=first)
    check(rc == -9, f"the first run was killed (exit {rc})")
    rc, text, steps = run(2)
    check(rc == 0, "the second run ended")
    check(f"resumed from step {CRASH_CKPT}\n" in text
          or f"resumed from step {2 * CRASH_CKPT}\n" in text,
          "the second run resumed from the first run's checkpoint")
    check(f"run ended at step {CRASH_STEPS}:" in text,
          f"the second run ended at step {CRASH_STEPS}")
    check(len(steps) <= 3 and steps[-1] == CRASH_STEPS,
          f"at most 3 steps kept, {CRASH_STEPS} the latest: {steps}")
    mtime = os.path.getmtime(os.path.join(ckpt, str(CRASH_STEPS), "state.pt"))
    rc, text, steps3 = run(3)
    check(rc == 0 and f"resumed from step {CRASH_STEPS}\n" in text
          and f"run ended at step {CRASH_STEPS}: 0 steps taken" in text
          and steps3 == steps and mtime == os.path.getmtime(
              os.path.join(ckpt, str(CRASH_STEPS), "state.pt")),
          "a third run at max_steps takes no step and saves nothing")
    shutil.rmtree(save)


def cli_untimed_path(dev, data, recipe, extra, want):
    """``main`` of a recipe's CLI module for ``CLI_UNTIMED_STEPS`` steps at
    B = 96 with ``extra`` flags and no checkpoints; its launches checked
    against ``want`` per step and the student's parameters finite."""
    import contextlib
    import importlib

    from audiossl_tpu_torch.kernels import build as kb

    module, argv = recipe_argv(recipe, data, "")
    i = argv.index("--save_path")
    del argv[i:i + 2]
    cli = importlib.import_module(module)
    label = " ".join([f"{module.rsplit('.', 2)[-2]} CLI", *extra])
    tee = Tee(sys.stdout)
    torch.cuda.synchronize()
    kb.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        state = cli.main(argv + [
            "--n_devices", "1",
            "--batch_size_per_device", str(TRAIN_B), "--warmup_steps", "2",
            "--max_steps", str(CLI_UNTIMED_STEPS), *extra])
    torch.cuda.synchronize()
    launches = dict(kb.LAUNCHES)
    print(f"{label}: {CLI_UNTIMED_STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s")
    check("loader: native" in tee.text(), f"{label} took the native loader")
    check_launches(label, launches,
                   {k: v * CLI_UNTIMED_STEPS for k, v in want.items()})
    check(all(bool(torch.isfinite(p).all())
              for p in state.student.parameters()),
          f"{label}: the student's parameters are finite")
    del state
    torch.cuda.empty_cache()
    return launches


def method_cli_path(dev, data, workdir, which, extra, want):
    """``main`` of the MAE or dual CLI (``which``) at B = 96 for
    ``CLI_UNTIMED_STEPS`` steps with ``extra`` flags and a checkpoint at
    the last one: its launches (``want`` a step), finite parameters, no
    teacher saved; then ``main`` again, which resumes from that
    checkpoint, takes no step and launches nothing, and holds the first
    run's final state tensor for tensor (the generator's state included).
    Returns the first run's launches."""
    import contextlib
    import importlib

    from audiossl_tpu_torch.kernels import build as kb

    cli = importlib.import_module(f"audiossl_tpu_torch.methods.{which}.train")
    save = os.path.join(workdir, f"{which}_cli")
    steps = CLI_UNTIMED_STEPS
    argv = ["--data_path", data, "--save_path", save, "--n_devices", "1",
            "--batch_size_per_device", str(TRAIN_B), "--warmup_steps", "2",
            "--max_steps", str(steps), "--ckpt_interval", str(steps), *extra]
    label = f"{which} CLI"
    runs = []
    for i in range(2):
        tee = Tee(sys.stdout)
        torch.cuda.synchronize()
        kb.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            state = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append((dict(kb.LAUNCHES), tee.text()))
        print(f"{label} run {i + 1}: {wall:.1f} s")
        if i == 0:
            check(state.teacher is None, f"{label}: a state with no teacher")
            check(all(bool(torch.isfinite(p).all())
                      for p in state.student.parameters()),
                  f"{label}: the parameters are finite")
            first = {k: v.detach().to("cpu", copy=True)
                     for k, v in state_tensors(state).items()}
        else:
            got = state_tensors(state)
        del state
        torch.cuda.empty_cache()
    (launches, text), (launches2, text2) = runs
    check("loader: native" in text, f"{label} took the native loader")
    check_launches(label, launches, {k: v * steps for k, v in want.items()})
    saved = torch.load(os.path.join(save, "ckpt", str(steps), "state.pt"),
                       map_location="cpu", weights_only=True)
    check(saved["teacher"] is None and saved["step"] == steps,
          f"{label}: checkpoint {steps} written, with no teacher")
    check(f"resumed from step {steps}\n" in text2
          and f"run ended at step {steps}: 0 steps taken" in text2,
          f"{label}: the second run resumed from step {steps} and took no "
          "step")
    check(not any(launches2.values()), f"{label}: the second run launched "
          f"nothing ({launches2})")
    check(got.keys() == first.keys(), f"{label}: the restore holds the "
          "saved state's tensors")
    unequal = [k for k in got if not torch.equal(got[k].cpu(), first[k])]
    check(not unequal, f"{label}: the restored state equal to the saved one "
          f"tensor for tensor ({len(got)} tensors; unequal {unequal[:5]})")
    del got, first, saved
    return launches


DDP_RANKS, DDP_B, DDP_STEPS = 2, 32, 3  # ddp_frame: 16 clips a rank
DDP_RUN_STEPS, DDP_RUN_CKPT = 6, 3
DDP_TIMEOUT_S = 400  # the ranks' hard limit


def ddp_batch(samples, n=DDP_B):
    """The seeded global batch of the ddp_frame phase (``n`` clips: the
    ddp_dual phase's), on the host: clips of noise, every fourth with
    three quarters of it valid (so the ranks select unequal counts of
    frames)."""
    rng = np.random.RandomState(SEED + 40)
    wav = (rng.randn(n, samples) * 0.1).astype(np.float32)
    valid = np.full(n, samples, np.int64)
    valid[1::4] = samples * 3 // 4
    wav[1::4, samples * 3 // 4:] = 0.0
    return {"wav": wav, "valid": valid}


def state_fingerprint(state):
    """Two int64 sums of the bits of every tensor of both branches (plain
    and weighted by position; the student alone where there is no
    teacher): equal states give equal fingerprints."""
    out = []
    for branch in (state.student, state.teacher):
        if branch is None:
            continue
        for t in branch.state_dict().values():
            bits = t.detach().contiguous().view(torch.int32).long().flatten()
            pos = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            out += [int(bits.sum()), int((bits * pos).sum())]
    return out


def save_branches(state, path):
    """What a step's gradient depends on: both branches (BatchNorm
    statistics included; the student alone where there is no teacher),
    the generator, the step and Adam's count."""
    torch.save({"student": state.student.state_dict(),
                "teacher": (None if state.teacher is None
                            else state.teacher.state_dict()),
                "generator": state.generator.get_state(),
                "step": state.step, "count": state.count}, path)


@torch.no_grad()
def load_branches(state, path, dev):
    """``save_branches``'s file into ``state`` in place (its moments go
    on as they were)."""
    saved = torch.load(path, map_location=dev, weights_only=True)
    state.student.load_state_dict(saved["student"])
    if state.teacher is not None:
        state.teacher.load_state_dict(saved["teacher"])
    state.generator.set_state(saved["generator"].cpu())
    state.step, state.count = saved["step"], saved["count"]


def ddp_rank(out_dir, data, device):
    """One rank of the ddp_frame phase (``parallel.launch.spawn``): the
    replicated and the ZeRO-1 steps on its rows of the global batch, each
    from the 1-rank run's state before that step, with each step's
    launches, loss, wall time, state fingerprint and (rank 0) lowest leaf
    cosine to the 1-rank step's gradient; then ``run_pretraining`` under
    ZeRO-1 with checkpoints. Writes ``rank<r>.json``."""
    import contextlib

    import torch.distributed as dist

    from audiossl_tpu_torch.datasets import PackedAudioDataset
    from audiossl_tpu_torch.kernels import build as kb
    from audiossl_tpu_torch.methods.atstframe.method import FrameMethod
    from audiossl_tpu_torch.parallel.launch import rank_device
    from audiossl_tpu_torch.parallel.mesh import local_rows, world
    from audiossl_tpu_torch.training.checkpoint import host_state
    from audiossl_tpu_torch.training.pretrain import shard_optimizer
    from audiossl_tpu_torch.training.runner import run_pretraining

    record_launch_shapes()
    w = world()
    dev = rank_device(device)
    cfg = base_recipe()
    sl = local_rows(DDP_B)
    batch = {k: torch.from_numpy(v[sl]).to(dev)
             for k, v in ddp_batch(cfg.out_samples).items()}
    res = {"rank": w.rank, "backend": dist.get_backend(),
           "device": str(dev)}
    total = dict.fromkeys(kb.LAUNCHES, 0)
    for label in ("replicated", "zero1"):
        method = FrameMethod(cfg, device=dev, seed=SEED)
        state = method.init_state(SEED)
        state.step = cfg.optimizer.warmup_steps
        if label == "zero1":
            shard_optimizer(state)
        moment_bytes = sum(v.numel() * v.element_size() for v in
                           (*state.mu.values(), *state.nu.values()))
        step = method.make_step()
        zero_grad = f"encoder.{method.student.encoder._norm_name}.bias"
        steps = []
        for i in range(DDP_STEPS):
            load_branches(state, os.path.join(out_dir, f"pre{i}.pt"), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, launches = counted_step(step, state, batch)
            wall = time.perf_counter() - t0
            for k, n in launches.items():
                total[k] += n
            rec = {"loss": float(out["loss"]), "launches": launches,
                   "wall_s": wall, "global_clips_per_s": DDP_B / wall,
                   "fingerprint": state_fingerprint(state)}
            if w.is_main:
                ref = torch.load(os.path.join(out_dir, f"ref_grads{i}.pt"),
                                 map_location=dev, weights_only=True)
                cos, norms = {}, {}
                for k, p in state.student.named_parameters():
                    g, r = p.grad.double().flatten(), ref[k].double().flatten()
                    norms[k] = max(float(g.norm()), float(r.norm()))
                    if k != zero_grad:
                        cos[k] = float(torch.nn.functional.cosine_similarity(
                            g, r, dim=0))
                worst = min(cos, key=cos.get)
                rec.update(min_cos=cos[worst], min_cos_leaf=worst,
                           median_cos=float(np.median(list(cos.values()))),
                           zero_grad_share=norms[zero_grad]
                           / max(norms.values()))
                del ref
            steps.append(rec)
        res[label] = {"steps": steps, "moment_bytes": moment_bytes}
        del method, state, step
        torch.cuda.empty_cache()

    # the run loop: ZeRO-1, checkpoints, rank 0 printing and writing
    method = FrameMethod(cfg, device=dev, seed=SEED)
    save = os.path.join(out_dir, "run")
    torch.cuda.synchronize()
    kb.reset_launches()
    t0 = time.perf_counter()
    quiet = open(os.devnull, "w") if not w.is_main else None
    with contextlib.redirect_stdout(quiet or sys.stdout):
        state = run_pretraining(
            method, PackedAudioDataset(data, "train"),
            batch_size_per_device=DDP_B // w.size, max_steps=DDP_RUN_STEPS,
            save_path=save, ckpt_interval=DDP_RUN_CKPT,
            log_interval=DDP_RUN_CKPT, seed=SEED, shard_optimizer=True)
    torch.cuda.synchronize()
    run_launches = dict(kb.LAUNCHES)
    for k, n in run_launches.items():
        total[k] += n
    final = host_state(state)  # the moments from their owners: every rank
    if w.is_main:
        torch.save(final, os.path.join(out_dir, "rank0_final.pt"))
    res["run"] = {"launches": run_launches, "step": state.step,
                  "wall_s": time.perf_counter() - t0,
                  "fingerprint": state_fingerprint(state),
                  "moment_bytes": sum(v.numel() * v.element_size() for v in
                                      (*state.mu.values(),
                                       *state.nu.values()))}
    res["launches"] = total
    res["seen"] = {k: sorted(v) for k, v in LAUNCH_SEEN.items()}
    with open(os.path.join(out_dir, f"rank{w.rank}.json"), "w") as f:
        json.dump(res, f)
    if quiet is not None:
        quiet.close()


def ddp_frame_path(dev, workdir, data):
    """Data-parallel ATST-Frame pretraining on this one card: 2 ranks
    (``parallel.launch.spawn``, gloo over CUDA tensors: NCCL refuses two
    ranks on one device) at the frame base bf16 recipe, a global batch of
    ``DDP_B`` (16 a rank), ``DDP_STEPS`` steps from one seed, replicated
    and under ZeRO-1; each step against the 1-rank step on the same global
    batch run here first, from the state the 1-rank run had before it
    (loss rel ``STEP_LOSS_REL``, lowest leaf cosine ``STEP_GRAD_COS``: the
    bf16 kernel-vs-plain bounds, since K4/K5's f32 atomics already make
    two equal 1-rank steps differ, and so two runs drift apart step by
    step), both ranks' states bit-equal after each step, each rank's
    launches equal to the 1-rank step's, its moment bytes under ZeRO-1;
    then ``run_pretraining``
    on the 2 ranks under ZeRO-1 for ``DDP_RUN_STEPS`` steps with a
    checkpoint every ``DDP_RUN_CKPT``, rank 0's last checkpoint restored
    into a 1-rank state equal tensor for tensor to rank 0's final state.
    With 2 cards or more, also the frame CLI over NCCL at ``--n_devices``
    the count. Returns the ranks' launches, summed."""
    from audiossl_tpu_torch.methods.atstframe.method import FrameMethod
    from audiossl_tpu_torch.parallel import launch
    from audiossl_tpu_torch.training.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    out_dir = os.path.join(workdir, "ddp_frame")
    os.makedirs(out_dir)
    cfg = base_recipe()
    method = FrameMethod(cfg, device=dev, seed=SEED)
    state = method.init_state(SEED)
    state.step = cfg.optimizer.warmup_steps
    step = method.make_step()
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in ddp_batch(cfg.out_samples).items()}
    ref = []
    for i in range(DDP_STEPS):
        save_branches(state, os.path.join(out_dir, f"pre{i}.pt"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches = counted_step(step, state, batch)
        wall = time.perf_counter() - t0
        check_launches(f"ddp_frame 1-rank step {i + 1}", launches,
                       bf16_want(1))
        ref.append({"loss": float(out["loss"]), "wall_s": wall,
                    "launches": launches})
        torch.save({k: p.grad for k, p in state.student.named_parameters()},
                   os.path.join(out_dir, f"ref_grads{i}.pt"))
    ref_moment_bytes = sum(v.numel() * v.element_size() for v in
                           (*state.mu.values(), *state.nu.values()))
    del method, state, step, batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    launch.spawn(ddp_rank, DDP_RANKS, (out_dir, data, str(dev)),
                 device=str(dev), backend="gloo", timeout_s=DDP_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    got = []
    for r in range(DDP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            got.append(json.load(f))
    for g in got:
        for k, shapes in g["seen"].items():
            LAUNCH_SEEN.setdefault(k, set()).update(map(tuple, shapes))
    print(f"ddp_frame: {DDP_RANKS} ranks on {got[0]['device']}, backend "
          f"{got[0]['backend']} over CUDA tensors, global batch {DDP_B} "
          f"({DDP_B // DDP_RANKS} a rank); ranks ran {ranks_s:.1f} s")
    check(all(g["backend"] == "gloo" for g in got), "ddp_frame ranks on gloo")
    summary = {"backend": got[0]["backend"], "ranks": DDP_RANKS,
               "global_batch": DDP_B, "one_rank": ref,
               "moment_bytes_replicated": ref_moment_bytes}
    for label in ("replicated", "zero1"):
        steps = [g[label]["steps"] for g in got]
        for i, want in enumerate(ref):
            a, b = steps[0][i], steps[1][i]
            rel = abs(a["loss"] - want["loss"]) / abs(want["loss"])
            print(f"ddp_frame {label} step {i + 1}: loss {a['loss']} (1-rank "
                  f"{want['loss']}, rel diff {rel}); gradient cosine to the "
                  f"1-rank step min {a['min_cos']} ({a['min_cos_leaf']}), "
                  f"median {a['median_cos']}; wall {a['wall_s']} s / "
                  f"{b['wall_s']} s, global clips/s {a['global_clips_per_s']}"
                  f" (a correctness run, not a data-parallel rate; 1-rank "
                  f"wall {want['wall_s']} s)")
            check(rel <= STEP_LOSS_REL, f"ddp_frame {label} step {i + 1} loss "
                  f"rel diff {rel} <= {STEP_LOSS_REL}")
            check(a["min_cos"] >= STEP_GRAD_COS, f"ddp_frame {label} step "
                  f"{i + 1}: every gradient leaf cosine to the 1-rank step "
                  f">= {STEP_GRAD_COS}")
            check(a["zero_grad_share"] <= ZERO_GRAD_REL, f"ddp_frame {label}: "
                  f"the final norm bias's gradient <= {ZERO_GRAD_REL} of the "
                  "largest leaf's")
            check(a["fingerprint"] == b["fingerprint"]
                  and a["loss"] == b["loss"],
                  f"ddp_frame {label} step {i + 1}: both ranks' states and "
                  "losses bit-equal")
            for r, st in enumerate((a, b)):
                check_launches(f"ddp_frame {label} rank {r} step {i + 1}",
                               st["launches"], bf16_want(1))
        summary[label] = {
            "loss": [s["loss"] for s in steps[0]],
            "min_leaf_cos": [s["min_cos"] for s in steps[0]],
            "wall_s": [[s["wall_s"] for s in st] for st in steps],
            "global_clips_per_s": [s["global_clips_per_s"]
                                   for s in steps[0]],
            "moment_bytes": [g[label]["moment_bytes"] for g in got]}
    mb = summary["zero1"]["moment_bytes"]
    print(f"ddp_frame ZeRO-1 moment bytes by rank {mb} (replicated "
          f"{summary['replicated']['moment_bytes']}, 1-rank "
          f"{ref_moment_bytes})")
    check(sum(mb) == ref_moment_bytes and max(mb) <= 0.6 * ref_moment_bytes,
          "ddp_frame ZeRO-1: the moments split over the ranks, about half "
          "each")

    runs = [g["run"] for g in got]
    check(all(r["step"] == DDP_RUN_STEPS for r in runs),
          f"ddp_frame run_pretraining reached step {DDP_RUN_STEPS}")
    check(runs[0]["fingerprint"] == runs[1]["fingerprint"],
          "ddp_frame run_pretraining: both ranks end on the same state")
    for r, run in enumerate(runs):
        check_launches(f"ddp_frame run_pretraining rank {r}", run["launches"],
                       {k: n * DDP_RUN_STEPS for k, n in bf16_want(1).items()})
    mgr = CheckpointManager(os.path.join(out_dir, "run", "ckpt"),
                            DDP_RUN_CKPT)
    kept = list(range(DDP_RUN_CKPT, DDP_RUN_STEPS + 1, DDP_RUN_CKPT))
    check(mgr.all_steps() == kept, f"ddp_frame checkpoints {mgr.all_steps()} "
          f"== {kept}")
    fresh = FrameMethod(cfg, device=dev, seed=SEED + 1)
    rstate = fresh.init_state(SEED + 1)
    mgr.restore_latest(rstate)
    final = torch.load(os.path.join(out_dir, "rank0_final.pt"),
                       map_location="cpu", weights_only=True)
    rs = state_tensors(rstate)
    want = {f"student.{k}": v for k, v in final["student"].items()}
    want.update({f"teacher.{k}": v for k, v in final["teacher"].items()})
    want.update({f"mu.{k}": v for k, v in final["mu"].items()})
    want.update({f"nu.{k}": v for k, v in final["nu"].items()})
    want["generator"] = final["generator"]
    want["step"], want["count"] = (torch.tensor(final["step"]),
                                   torch.tensor(final["count"]))
    check(rs.keys() == want.keys(), "ddp_frame: the checkpoint restores into "
          "a 1-rank state's tensors")
    unequal = [k for k in rs if not torch.equal(rs[k].cpu(), want[k].cpu())]
    check(not unequal, "ddp_frame: rank 0's checkpoint restored into a "
          f"1-rank state equal to rank 0's final state tensor for tensor ({len(rs)} "
          f"tensors; unequal {unequal[:5]})")
    del fresh, rstate, rs, want, final
    torch.cuda.empty_cache()
    summary["run"] = {"steps": DDP_RUN_STEPS, "wall_s": [r["wall_s"]
                                                         for r in runs],
                      "moment_bytes": [r["moment_bytes"] for r in runs],
                      "checkpoints": kept}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        summary["nccl_cli"] = ddp_nccl_cli(workdir, data, n_cards)
    else:
        print(f"ddp_frame: the frame CLI over NCCL did not run: it needs 2 "
              f"cards or more and this machine has {n_cards}")
    summary["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"ddp_frame": summary}))
    launches = dict.fromkeys(got[0]["launches"], 0)
    for g in got:
        for k, n in g["launches"].items():
            launches[k] += n
    return launches


def ddp_nccl_cli(workdir, data, n_cards):
    """The frame CLI at the base recipe's arguments, ``--n_devices``
    ``n_cards`` (NCCL, one rank a card, started by the CLI), 16 clips a
    rank, 3 steps."""
    root = os.path.dirname(os.path.abspath(__file__))
    save = os.path.join(workdir, "ddp_nccl")
    module, argv = recipe_argv("torch_atst_frame_base.sh", data, save)
    cmd = [sys.executable, "-m", module, *argv, "--n_devices", str(n_cards),
           "--batch_size_per_device", str(DDP_B // DDP_RANKS),
           "--warmup_steps", "2", "--max_steps", "3", "--ckpt_interval", "3"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=DDP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith(("loader", "run ended"))]
    print(f"ddp_frame: the frame CLI over NCCL on {n_cards} cards: exit "
          f"{r.returncode} in {wall:.1f} s; {lines}")
    check(r.returncode == 0 and "run ended at step 3: 3 steps taken"
          in r.stdout, f"the frame CLI on {n_cards} NCCL ranks ran 3 steps "
          f"({r.stderr[-2000:]})")
    return {"cards": n_cards, "wall_s": wall}


# Data-parallel downstream (ddp_finetune, ddp_sed): 2 ranks on this one
# card on gloo, each step at a global batch of DDP_DS_B (8 a rank) held to
# the 1-rank step on the same global batch and draws at the f32 step bounds
DDP_DS_B, DDP_DS_STEPS = 16, 2
DUAL_DDP_STEPS = 2


def ddp_dual_rank(out_dir, device):
    """One rank of the ddp_dual phase (``parallel.launch.spawn``): the dual
    small f32 step on its rows of the global batch of ``DUAL_DDP_B``, each
    of ``DUAL_DDP_STEPS`` steps from the 1-rank run's state before it,
    with its launches, metrics, wall time, state fingerprint and (rank 0)
    the leaf cosines to the 1-rank step's gradient. Writes
    ``rank<r>.json``."""
    import torch.distributed as dist

    from audiossl_tpu_torch.methods.dual.method import DualMethod
    from audiossl_tpu_torch.parallel.launch import rank_device
    from audiossl_tpu_torch.parallel.mesh import local_rows, world

    record_launch_shapes()
    w = world()
    dev = rank_device(device)
    cfg = dual_recipe("float32")
    sl = local_rows(DUAL_DDP_B)
    batch = {k: torch.from_numpy(v[sl]).to(dev)
             for k, v in ddp_batch(SAMPLES, DUAL_DDP_B).items()}
    method = DualMethod(cfg, device=dev, seed=SEED)
    state = method.init_state(SEED)
    step = method.make_step()
    steps = []
    for i in range(DUAL_DDP_STEPS):
        load_branches(state, os.path.join(out_dir, f"pre{i}.pt"), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches = counted_step(step, state, batch)
        wall = time.perf_counter() - t0
        rec = {"metrics": {k: float(v) for k, v in out.items()},
               "launches": launches, "wall_s": wall,
               "fingerprint": state_fingerprint(state)}
        if w.is_main:
            ref = torch.load(os.path.join(out_dir, f"ref_grads{i}.pt"),
                             map_location=dev, weights_only=True)
            cos = {k: float(torch.nn.functional.cosine_similarity(
                p.grad.double().flatten(), ref[k].double().flatten(), dim=0))
                for k, p in state.student.named_parameters()}
            worst = min(cos, key=cos.get)
            rec.update(min_cos=cos[worst], min_cos_leaf=worst,
                       median_cos=float(np.median(list(cos.values()))))
            del ref
        steps.append(rec)
    res = {"rank": w.rank, "backend": dist.get_backend(), "device": str(dev),
           "steps": steps,
           "seen": {k: sorted(v) for k, v in LAUNCH_SEEN.items()}}
    with open(os.path.join(out_dir, f"rank{w.rank}.json"), "w") as f:
        json.dump(res, f)


def ddp_dual_path(dev, workdir):
    """Data-parallel dual pretraining on this one card: 2 gloo ranks over
    CUDA tensors at the dual small f32 recipe, a global batch of
    ``DUAL_DDP_B`` (8 a rank), ``DUAL_DDP_STEPS`` steps, each against the
    1-rank step on the same global batch run here first, from the state
    the 1-rank run had before it (the generator's too, so the same draws):
    loss rel ``F32_STEP_LOSS_REL`` (the masked-MSE counts and the variance
    terms' statistics span both ranks), every leaf's gradient cosine
    ``F32_STEP_GRAD_COS``, both ranks' states and losses bit-equal, each
    rank's launches the 1-rank step's. Returns the ranks' launches,
    summed."""
    from audiossl_tpu_torch.methods.dual.method import DualMethod
    from audiossl_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    out_dir = os.path.join(workdir, "ddp_dual")
    os.makedirs(out_dir)
    cfg = dual_recipe("float32")
    method = DualMethod(cfg, device=dev, seed=SEED)
    state = method.init_state(SEED)
    state.step = cfg.optimizer.warmup_steps
    step = method.make_step()
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in ddp_batch(SAMPLES, DUAL_DDP_B).items()}
    ref = []
    for i in range(DUAL_DDP_STEPS):
        save_branches(state, os.path.join(out_dir, f"pre{i}.pt"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches = counted_step(step, state, batch)
        wall = time.perf_counter() - t0
        check_launches(f"ddp_dual 1-rank step {i + 1}", launches,
                       dual_want("float32"))
        ref.append({"metrics": {k: float(v) for k, v in out.items()},
                    "wall_s": wall})
        torch.save({k: p.grad for k, p in state.student.named_parameters()},
                   os.path.join(out_dir, f"ref_grads{i}.pt"))
    del method, state, step, batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    launch.spawn(ddp_dual_rank, DDP_RANKS, (out_dir, str(dev)),
                 device=str(dev), backend="gloo", timeout_s=DDP_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    got = []
    for r in range(DDP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            got.append(json.load(f))
    for g in got:
        for k, shapes in g["seen"].items():
            LAUNCH_SEEN.setdefault(k, set()).update(map(tuple, shapes))
    print(f"ddp_dual: {DDP_RANKS} ranks on {got[0]['device']}, backend "
          f"{got[0]['backend']} over CUDA tensors, global batch {DUAL_DDP_B} "
          f"({DUAL_DDP_B // DDP_RANKS} a rank); ranks ran {ranks_s:.1f} s")
    check(all(g["backend"] == "gloo" for g in got), "ddp_dual ranks on gloo")
    for i, want in enumerate(ref):
        a, b = got[0]["steps"][i], got[1]["steps"][i]
        wl, al = want["metrics"]["loss"], a["metrics"]["loss"]
        rel = abs(al - wl) / abs(wl)
        aux = {k: (a["metrics"][k], v) for k, v in want["metrics"].items()
               if k not in ("loss", "lr", "wd")}
        print(f"ddp_dual step {i + 1}: loss {al} (1-rank {wl}, rel diff "
              f"{rel}); aux (2 ranks, 1 rank) {aux}; gradient cosine to the "
              f"1-rank step min {a['min_cos']} ({a['min_cos_leaf']}), median "
              f"{a['median_cos']}; wall {a['wall_s']} s / {b['wall_s']} s "
              f"(a correctness run, not a data-parallel rate; 1-rank wall "
              f"{want['wall_s']} s)")
        check(rel <= F32_STEP_LOSS_REL, f"ddp_dual step {i + 1} loss rel "
              f"diff {rel} <= {F32_STEP_LOSS_REL}")
        check(a["min_cos"] >= F32_STEP_GRAD_COS, f"ddp_dual step {i + 1}: "
              f"every gradient leaf cosine to the 1-rank step >= "
              f"{F32_STEP_GRAD_COS}")
        check(a["fingerprint"] == b["fingerprint"]
              and a["metrics"] == b["metrics"],
              f"ddp_dual step {i + 1}: both ranks' states and metrics "
              "bit-equal")
        for r, st in enumerate((a, b)):
            check_launches(f"ddp_dual rank {r} step {i + 1}", st["launches"],
                           dual_want("float32"))
    print(json.dumps({"ddp_dual": {
        "backend": got[0]["backend"], "ranks": DDP_RANKS,
        "global_batch": DUAL_DDP_B,
        "loss": [s["metrics"]["loss"] for s in got[0]["steps"]],
        "one_rank_loss": [r["metrics"]["loss"] for r in ref],
        "min_leaf_cos": [s["min_cos"] for s in got[0]["steps"]],
        "wall_s": [[s["wall_s"] for s in g["steps"]] for g in got],
        "one_rank_wall_s": [r["wall_s"] for r in ref],
        "phase_s": time.perf_counter() - t_phase}}))
    launches = dict.fromkeys(got[0]["steps"][0]["launches"], 0)
    for g in got:
        for st in g["steps"]:
            for k, n in st["launches"].items():
                launches[k] += n
    return launches


DDP_DS_PACK = (("train", 64), ("valid", 33), ("test", 33))  # an odd eval
# split: its last batch does not divide over the ranks


def ds_save(state, path):
    """A downstream state (``FinetuneState`` or ``SEDState``) to
    ``path``: the encoder, the head (BatchNorm statistics included), the
    momentum trace and the step."""
    torch.save({"encoder": state.encoder.state_dict(),
                "head": state.head.state_dict(), "mu": state.mu,
                "step": state.step}, path)


@torch.no_grad()
def ds_load(state, path, dev):
    """``ds_save``'s file into ``state`` in place."""
    saved = torch.load(path, map_location=dev, weights_only=True)
    state.encoder.load_state_dict(saved["encoder"])
    state.head.load_state_dict(saved["head"])
    for k, v in saved["mu"].items():
        state.mu[k].copy_(v)
    state.step = saved["step"]


def ds_fingerprint(state):
    """Two int64 sums of the bits of the encoder, the head and the
    momentum trace (plain and weighted by position)."""
    out = []
    for t in (*state.encoder.state_dict().values(),
              *state.head.state_dict().values(), *state.mu.values()):
        bits = t.detach().contiguous().view(torch.int32).long().flatten()
        pos = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out += [int(bits.sum()), int((bits * pos).sum())]
    return out


def ds_task(kind, dev, arg):
    """The 1-rank and the ranks' task: for ``"finetune"`` the one
    ``train_finetune.build_task`` makes of the flags ``arg`` (4 steps an
    epoch, no warm-up: both steps move the weights); for ``"distill"`` the
    ``DistillMethod`` ``methods.distill.train`` builds of them (alike); for
    ``"sed"`` the
    DCASE task at ATST-Frame base (learning rate 0.1) on the encoder of
    the checkpoint ``arg``."""
    from audiossl_tpu_torch.datasets import get_dataset
    from audiossl_tpu_torch.downstream import train_finetune
    from audiossl_tpu_torch.downstream.train_freeze import load_encoder
    from audiossl_tpu_torch.sed.module import SEDConfig, SEDTask

    if kind == "distill":
        return distill_task(arg, dev, 4, warmup_epochs=0)[0]
    if kind == "finetune":
        args = train_finetune.build_parser().parse_args(arg)
        args.warmup_epochs = 0
        enc = load_encoder(args.pretrained_ckpt_path, args.model_type,
                           args.arch, which=args.use_encoder, device=dev)
        return train_finetune.build_task(args, get_dataset(args.dataset_name),
                                         enc, steps_per_epoch=4)
    enc = load_encoder(arg, "frame", SED_ARCH, spec_w=1001, device=dev)
    return SEDTask(enc, SEDConfig(num_labels=10, learning_rate=0.1,
                                  max_epochs=1, steps_per_epoch=4,
                                  warmup_epochs=0),
                   generator=torch.Generator().manual_seed(SEED))


def ds_step(task, state, batch, draws):
    """One step of either task; -> (loss, gradient norm or None)."""
    _, m = task.train_step(state, batch, draws)
    return float(m["loss"]), (float(m["gnorm"]) if "gnorm" in m else None)


def ds_grads(task, state, mu_before):
    """The step's gradient by leaf (clipped, for finetuning): the momentum
    trace less its decayed value before the step."""
    momentum = getattr(task.cfg, "momentum", 0.9)
    return {k: v - momentum * mu_before[k] for k, v in state.mu.items()}


def ddp_ds_rank(out_dir, kind, task_arg, cli, cli_argv, device):
    """One rank of ``ddp_finetune`` / ``ddp_sed``: each step on its rows
    of the saved global batch with the global draws, from the 1-rank
    run's state before that step, with its launches, loss, gradient norm,
    wall time, state fingerprint and (rank 0) each leaf's gradient cosine
    to the 1-rank step's; then ``cli``'s ``main`` at ``--n_devices`` the
    group's size, with the files each rank opens for writing. Writes
    ``rank<r>.json``."""
    import builtins
    import importlib

    from audiossl_tpu_torch.downstream.finetune import draws_to
    from audiossl_tpu_torch.kernels import build as kb
    from audiossl_tpu_torch.parallel.launch import rank_device
    from audiossl_tpu_torch.parallel.mesh import batch_rows, world

    record_launch_shapes()
    w = world()
    dev = rank_device(device)
    task = ds_task(kind, dev, task_arg)
    state = task.init_state()
    res = {"rank": w.rank, "steps": []}
    total = dict.fromkeys(kb.LAUNCHES, 0)
    for i in range(DDP_DS_STEPS):
        ds_load(state, os.path.join(out_dir, f"pre{i}.pt"), dev)
        inp = torch.load(os.path.join(out_dir, f"input{i}.pt"),
                         weights_only=False)
        draws = (draws_to(inp["draws"], dev) if kind == "finetune"
                 else inp["draws"].to(dev))
        mu_before = {k: v.clone() for k, v in state.mu.items()}
        torch.cuda.synchronize()
        kb.reset_launches()
        t0 = time.perf_counter()
        with batch_rows(inp["batch"]) as rows:
            loss, gnorm = ds_step(task, state, rows, draws)
        torch.cuda.synchronize()
        rec = {"loss": loss, "gnorm": gnorm, "launches": dict(kb.LAUNCHES),
               "wall_s": time.perf_counter() - t0,
               "fingerprint": ds_fingerprint(state)}
        for k, n in rec["launches"].items():
            total[k] += n
        if w.is_main:
            ref = torch.load(os.path.join(out_dir, f"ref{i}.pt"),
                             map_location=dev, weights_only=True)
            g = ds_grads(task, state, mu_before)
            top = max(float(v.norm()) for v in ref.values())
            cos = {k: float(torch.nn.functional.cosine_similarity(
                g[k].double().flatten(), v.double().flatten(), dim=0))
                for k, v in ref.items() if float(v.norm()) > FT_ZERO_REL * top}
            worst = min(cos, key=cos.get)
            small = [k for k in ref if k not in cos]
            rec.update(min_cos=cos[worst], min_cos_leaf=worst,
                       small_leaves=small, small_diff_rel=max(
                           [float((g[k] - ref[k]).norm()) / top
                            for k in small] or [0.0]))
        res["steps"].append(rec)
    del task, state
    torch.cuda.empty_cache()

    writes = []
    opened = builtins.open
    save = torch.save

    def record_open(f, mode="r", *a, **k):
        if any(c in mode for c in "wax") and isinstance(f, (str,
                                                           os.PathLike)):
            writes.append(str(f))
        return opened(f, mode, *a, **k)

    def record_save(obj, f, *a, **k):
        if isinstance(f, (str, os.PathLike)):
            writes.append(str(f))
        return save(obj, f, *a, **k)

    record = {} if w.is_main else None
    torch.cuda.synchronize()
    kb.reset_launches()
    t0 = time.perf_counter()
    builtins.open, torch.save = record_open, record_save
    try:
        result = importlib.import_module(cli).main(
            cli_argv + ["--n_devices", str(w.size), "--device", str(dev)],
            record=record)
    finally:
        builtins.open, torch.save = opened, save
    torch.cuda.synchronize()
    res["cli"] = {"result": result, "writes": writes,
                  "launches": dict(kb.LAUNCHES),
                  "wall_s": time.perf_counter() - t0}
    if record is not None:
        res["cli"]["batches"] = {
            "train": sum(len(e) for e in record["steps"]),
            "eval": sum(len(b) for b in record["evals"])
            if kind == "sed" else sum(len(b) for _, b in record["evals"]),
            "test": (len(record["test"].get("strong", []))
                     if kind == "sed" else None)}
    for k, n in res["cli"]["launches"].items():
        total[k] += n
    res["launches"] = total
    res["seen"] = {k: sorted(v) for k, v in LAUNCH_SEEN.items()}
    with open(os.path.join(out_dir, f"rank{w.rank}.json"), "w") as f:
        json.dump(res, f)


def ddp_downstream_path(dev, out_dir, kind, task_arg, batches, cli,
                        cli_argv, kept="top"):
    """A data-parallel downstream phase on this one card: the 1-rank steps
    here on the global ``batches`` (``DDP_DS_STEPS`` of ``DDP_DS_B``
    clips) with seeded draws, then 2 ranks (``parallel.launch.spawn``,
    gloo over CUDA tensors) on the same batches and draws from the 1-rank
    run's state before each step: the loss and gradient norm within
    ``F32_STEP_LOSS_REL``, every leaf's gradient at cosine >=
    ``F32_STEP_GRAD_COS`` (a leaf with a vanishing gradient, the final
    norm's bias behind the head's BatchNorm, within ``FT_ZERO_REL`` of the
    largest leaf's norm), both ranks' states bit-equal after each step and
    each rank's K1 launches equal to the 1-rank step's; then ``cli`` at
    ``--n_devices 2`` on the ranks: rank 0 alone writes ``result.json``
    and the kept states (under the folder ``kept``: the keeper's ``top``
    or the distillation drivers' ``ckpt``), the metrics finite, K1 once a
    train and eval batch on each rank. Returns the ranks' launches,
    summed, and the summary."""
    from audiossl_tpu_torch.downstream.finetune import draw_finetune, draws_to
    from audiossl_tpu_torch.kernels import build as kb
    from audiossl_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    name = f"ddp_{kind}"
    os.makedirs(out_dir)
    task = ds_task(kind, dev, task_arg)
    state = task.init_state()
    gen = torch.Generator().manual_seed(SEED + 60)
    rng = np.random.default_rng(SEED + 61)
    ref = []
    for i, batch in enumerate(batches):
        if kind == "finetune":
            draws = draw_finetune(task.cfg, DDP_DS_B, task.rows(
                DDP_DS_B, batch["wav"].shape[1]), task.encoder.depth, gen,
                rng)
            on_dev = draws_to(draws, dev)
        elif kind == "distill":  # from the state's generator
            draws = task.draw(state, DDP_DS_B,
                              batch["wav"].shape[1]).to("cpu")
            on_dev = draws.to(dev)
        else:
            draws = task.draw(gen, DDP_DS_B).cpu()
            on_dev = draws.to(dev)
        torch.save({"batch": batch, "draws": draws},
                   os.path.join(out_dir, f"input{i}.pt"))
        ds_save(state, os.path.join(out_dir, f"pre{i}.pt"))
        mu_before = {k: v.clone() for k, v in state.mu.items()}
        torch.cuda.synchronize()
        kb.reset_launches()
        t0 = time.perf_counter()
        loss, gnorm = ds_step(task, state, batch, on_dev)
        torch.cuda.synchronize()
        ref.append({"loss": loss, "gnorm": gnorm,
                    "wall_s": time.perf_counter() - t0,
                    "launches": dict(kb.LAUNCHES)})
        check(ref[-1]["launches"]["mel_db"] == 1
              and sum(ref[-1]["launches"].values()) == 1,
              f"{name} 1-rank step {i + 1}: K1 once, no other kernel "
              f"({ref[-1]['launches']})")
        torch.save(ds_grads(task, state, mu_before),
                   os.path.join(out_dir, f"ref{i}.pt"))
    del task, state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    launch.spawn(ddp_ds_rank, DDP_RANKS,
                 (out_dir, kind, task_arg, cli, cli_argv, str(dev)),
                 device=str(dev), backend="gloo", timeout_s=DDP_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    got = []
    for r in range(DDP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            got.append(json.load(f))
    for g in got:
        for k, shapes in g["seen"].items():
            LAUNCH_SEEN.setdefault(k, set()).update(map(tuple, shapes))
    summary = {"card": CARD, "ranks": DDP_RANKS, "global_batch": DDP_DS_B,
               "one_rank": ref, "ranks_s": ranks_s, "steps": []}
    for i, want in enumerate(ref):
        a, b = (g["steps"][i] for g in got)
        rel = abs(a["loss"] - want["loss"]) / abs(want["loss"])
        grel = (None if want["gnorm"] is None else
                abs(a["gnorm"] - want["gnorm"]) / abs(want["gnorm"]))
        print(f"{name} step {i + 1}: loss {a['loss']} (1-rank "
              f"{want['loss']}, rel diff {rel}); gradient norm rel diff "
              f"{grel}; leaf cosine to the 1-rank step min {a['min_cos']} "
              f"({a['min_cos_leaf']}), leaves with a vanishing gradient "
              f"{a['small_leaves']} within {a['small_diff_rel']} of the "
              f"largest leaf's norm; wall {a['wall_s']} s / {b['wall_s']} s "
              f"(1-rank {want['wall_s']} s; a correctness run on one card, "
              f"not a data-parallel rate; {CARD})")
        check(rel <= F32_STEP_LOSS_REL, f"{name} step {i + 1} loss rel "
              f"diff {rel} <= {F32_STEP_LOSS_REL}")
        check(grel is None or grel <= F32_STEP_LOSS_REL, f"{name} step "
              f"{i + 1} gradient norm rel diff {grel} <= "
              f"{F32_STEP_LOSS_REL}")
        check(a["min_cos"] >= F32_STEP_GRAD_COS, f"{name} step {i + 1}: "
              f"every leaf's gradient cosine to the 1-rank step >= "
              f"{F32_STEP_GRAD_COS}")
        check(a["small_diff_rel"] <= FT_ZERO_REL, f"{name} step {i + 1}: "
              f"the vanishing gradients within {FT_ZERO_REL}")
        check(a["fingerprint"] == b["fingerprint"] and a["loss"] == b["loss"],
              f"{name} step {i + 1}: both ranks' states and losses bit-equal")
        for r, st in enumerate((a, b)):
            check(st["launches"] == want["launches"], f"{name} rank {r} step "
                  f"{i + 1}: launches {st['launches']} == the 1-rank step's")
        summary["steps"].append({"loss": a["loss"], "loss_rel": rel,
                                 "gnorm_rel": grel, "min_leaf_cos":
                                 a["min_cos"], "wall_s": [a["wall_s"],
                                                          b["wall_s"]]})

    c0, c1 = (g["cli"] for g in got)
    save = cli_argv[cli_argv.index("--save_path") + 1]
    result_file = os.path.join(save, "result.json")
    print(f"{name}: {cli} at --n_devices {DDP_RANKS}: {c0['result']}; rank 0 "
          f"wrote {len(c0['writes'])} files, rank 1 {len(c1['writes'])}; "
          f"batches {c0['batches']}; K1 by rank "
          f"{[c['launches']['mel_db'] for c in (c0, c1)]}; "
          f"{c0['wall_s']:.1f} s")
    check(c1["writes"] == [] and result_file in c0["writes"]
          and any(os.sep + kept + os.sep in p for p in c0["writes"]),
          f"{name}: rank 0 alone writes result.json and the kept states")
    with open(result_file) as f:
        check(json.load(f) == c0["result"] == c1["result"],
              f"{name}: result.json holds both ranks' result")
    check(all(np.isfinite(v) for v in c0["result"].values()
              if isinstance(v, float)), f"{name}: finite metrics")
    n = c0["batches"]
    k1 = n["train"] + n["eval"] + (n["test"] or 0)
    check(c0["launches"]["mel_db"] == c1["launches"]["mel_db"] == k1 and
          sum(c0["launches"].values()) == k1, f"{name}: K1 once a train "
          f"and eval batch on each rank ({k1}), no other kernel")
    summary["cli"] = {"result": c0["result"], "batches": n,
                      "wall_s": [c0["wall_s"], c1["wall_s"]]}
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        nccl = list(cli_argv)
        nccl[nccl.index("--save_path") + 1] = save + "_nccl"
        summary["nccl_cli_s"] = ddp_downstream_nccl(cli, nccl, n_cards)
    else:
        print(f"{name}: {cli} over NCCL did not run: it needs 2 cards or "
              f"more and this machine has {n_cards}")
    summary["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({name: summary}))
    launches = dict.fromkeys(got[0]["launches"], 0)
    for g in got:
        for k, v in g["launches"].items():
            launches[k] += v
    return launches


def write_ddp_pack(workdir):
    """The ``ddp_finetune`` CLI's seeded ``audioset_b`` pack: 64 train
    clips, 33 validation and 33 test (tone clips of 1-12 s)."""
    from audiossl_tpu_torch.datasets import write_synthetic_pack

    data = os.path.join(workdir, "ddp_audioset_b")
    for i, (split, n) in enumerate(DDP_DS_PACK):
        write_synthetic_pack(data, split, n, min_s=1.0, max_s=12.0,
                             num_labels=527, multi_label=True,
                             seed=SEED + 62 + i, kind="tones")
    return data


def ddp_finetune_path(dev, workdir, data):
    """``ddp_finetune``: the clip base step of ``finetune_clip`` with
    mixup, SpecAugment and RandomResizeCrop on, at a global batch of 16
    from the probe pack (:func:`ddp_downstream_path`), then
    ``train_finetune`` on 2 ranks for one epoch of batches of 16 on a pack
    whose validation and test splits of 33 clips end on a ragged batch."""
    from audiossl_tpu_torch.datasets import BatchLoader, PackedAudioDataset

    ckpt = os.path.join(workdir, "finetune_clip.ckpt")
    argv = finetune_argv("clip", ckpt, data, os.path.join(workdir, "unused"),
                         dev) + ["--mask_aug", "--rrc"]
    loader = iter(BatchLoader(PackedAudioDataset(data, "train"), DDP_DS_B,
                              pad_samples=12 * 16000, shuffle=False))
    batches = [next(loader) for _ in range(DDP_DS_STEPS)]
    pack = write_ddp_pack(workdir)
    cli_argv = ["--pretrained_ckpt_path", ckpt, "--data_path", pack,
                "--dataset_name", "audioset_b", "--model_type", "clip",
                "--arch", FT_ARCH, "--n_last_blocks", str(FT_BLOCKS),
                "--batch_size", str(DDP_DS_B), "--max_epochs", "1",
                "--warmup_epochs", "0", "--train_len", "12", "--mask_aug",
                "--rrc", "--save_path", os.path.join(workdir, "ddp_ft_cli")]
    return ddp_downstream_path(
        dev, os.path.join(workdir, "ddp_finetune"), "finetune", argv,
        batches, "audiossl_tpu_torch.downstream.train_finetune", cli_argv)


def ddp_sed_path(dev, workdir, dcase, ckpt):
    """``ddp_sed``: the DCASE step at ATST-Frame base on global batches of
    8 strong then 8 weak rows (rank 0 holds the strong ones, rank 1 the
    weak), then ``train_dcase`` on 2 ranks for one epoch of such batches
    (:func:`ddp_downstream_path`)."""
    from audiossl_tpu_torch.datasets.sed import MixedBatchLoader, create_dcase

    half = DDP_DS_B // 2
    loader = iter(MixedBatchLoader(create_dcase(dcase, "train"),
                                   [half, half], shuffle=False))
    batches = [next(loader) for _ in range(DDP_DS_STEPS)]
    check(all(list(b["source"]) == [0] * half + [1] * half for b in batches),
          "ddp_sed: strong rows, then weak rows")
    cli_argv = ["--pretrained_ckpt_path", ckpt, "--data_path", dcase,
                "--arch", SED_ARCH, "--batch_size_synth", str(half),
                "--batch_size_weak", str(half), "--max_epochs", "1",
                "--warmup_epochs", "0", "--save_path",
                os.path.join(workdir, "ddp_sed_cli")]
    return ddp_downstream_path(
        dev, os.path.join(workdir, "ddp_sed"), "sed", ckpt,
        batches, "audiossl_tpu_torch.downstream.train_dcase", cli_argv)


def ddp_downstream_nccl(module, argv, n_cards):
    """A downstream driver at ``--n_devices n_cards`` (NCCL, one rank a
    card, started by the driver); -> its wall seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", module, *argv, "--n_devices", str(n_cards),
           "--device", "cuda"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=DDP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    save = argv[argv.index("--save_path") + 1]
    print(f"{module} over NCCL on {n_cards} cards: exit {r.returncode} in "
          f"{wall:.1f} s; {r.stdout.strip().splitlines()[-1:]}")
    check(r.returncode == 0 and os.path.exists(os.path.join(
        save, "result.json")), f"{module} on {n_cards} NCCL ranks wrote its "
          f"result ({r.stderr[-2000:]})")
    return wall


# Clip-to-frame distillation (``methods/distill``) at base width: a seeded
# random ATST-Clip base classifier (its encoder and a LinearHead with
# non-trivial running statistics) as a reference-layout teacher ``.ckpt``;
# the finetuning paths' ATST-Frame base ``.ckpt`` as the student (1001
# frames of position embeddings, the width JAX builds the student at; the
# probe's frame file holds 601). ``train.main`` on the probe pack: batches
# of 64 drawn by class-balanced weights, 2 epochs with 1 of warm-up (cut
# from the reference's 40 and 2), lambda_d 0.5; ``train_other.main`` on a
# seeded spcv2 tree (1 s clips in 12 s central crops, 1 epoch)
DISTILL_B, DISTILL_EPOCHS, DISTILL_CHECK_B = 64, 2, 4
SPCV2_SPLITS = (("train", 256), ("valid", 70), ("test", 70))  # ragged eval
DDP_SPCV2_SPLITS = (("train", 64), ("valid", 33), ("test", 33))


def write_distill_teacher(workdir, num_labels):
    """A seeded random ATST-Clip base encoder (1001 frames) and a LinearHead
    over its CLS and mean (1536 -> ``num_labels``: weight std 0.05, running
    means std 0.1, variances in [0.5, 1.5]) as a finetuned classifier's
    reference-layout ``.ckpt`` (``encoder.encoder.*``, ``head.*`` with the
    reference's ``num_batches_tracked``), written once; returns its path."""
    from audiossl_tpu_torch.downstream.train_freeze import _MAKERS
    from audiossl_tpu_torch.models.heads import LinearHead

    path = os.path.join(workdir, f"distill_teacher_{num_labels}.ckpt")
    if os.path.exists(path):
        return path
    enc = _MAKERS[("clip", FT_ARCH)](
        spec_w=1001, device="cpu",
        generator=torch.Generator().manual_seed(SEED + 70))
    head = LinearHead(2 * enc.embed_dim, num_labels,
                      generator=torch.Generator().manual_seed(SEED + 71))
    g = torch.Generator().manual_seed(SEED + 72)
    with torch.no_grad():
        head.linear.weight.normal_(0.0, 0.05, generator=g)
        head.norm.running_mean.normal_(0.0, 0.1, generator=g)
        head.norm.running_var.uniform_(0.5, 1.5, generator=g)
    sd = {f"encoder.encoder.{k}": v for k, v in enc.state_dict().items()}
    sd.update((f"head.{k}", v) for k, v in head.state_dict().items())
    sd["head.norm.num_batches_tracked"] = torch.tensor(1000)
    torch.save({"state_dict": sd}, path)
    return path


def write_spcv2_tree(workdir, name, splits):
    """A seeded ``spcv2`` tree (``datasets.tasks.SpeechCommandsV2``'s
    layout: a folder a label, the validation and test lists) of 1 s int16
    tone clips, one tone a label, the labels in turn; returns its path."""
    from scipy.io import wavfile

    from audiossl_tpu_torch.datasets.tasks import SpeechCommandsV2

    root = os.path.join(workdir, name)
    rng = np.random.RandomState(SEED + 73)
    t = np.arange(16000) / 16000.0
    labels = SpeechCommandsV2.LABELS
    lists, i = {"valid": [], "test": []}, 0
    for split, n in splits:
        for _ in range(n):
            lab = labels[i % len(labels)]
            rel = f"{lab}/{i:04d}.wav"
            os.makedirs(os.path.join(root, lab), exist_ok=True)
            wav = 0.3 * np.sin(2 * np.pi * (200 + 40 * (i % len(labels)))
                               * t) + 0.05 * rng.randn(16000)
            wavfile.write(os.path.join(root, rel), 16000,
                          (wav * 32767).astype(np.int16))
            if split != "train":
                lists[split].append(rel)
            i += 1
    for split, name_ in (("valid", "validation_list.txt"),
                         ("test", "testing_list.txt")):
        with open(os.path.join(root, name_), "w") as f:
            f.write("\n".join(lists[split]) + "\n")
    return root


def distill_argv(data, teacher, student, out, dev):
    """``distill_as``'s flags of ``methods.distill.train.main``."""
    return ["--data_path", data, "--teacher_ckpt_path", teacher,
            "--student_ckpt_path", student, "--save_path", out,
            "--batch_size", str(DISTILL_B), "--max_epochs",
            str(DISTILL_EPOCHS), "--warmup_epochs", "1",
            "--balanced_sampling", "--lambda_d", "0.5", "--device", str(dev),
            "--n_devices", "1"]


def distill_task(argv, dev, steps_per_epoch, warmup_epochs=None):
    """The method and state ``methods.distill.train`` builds of the flags
    ``argv`` on ``dev``, at ``steps_per_epoch`` steps an epoch."""
    from audiossl_tpu_torch.methods.distill import train as distill

    args = distill.build_parser().parse_args(argv)
    if warmup_epochs is not None:
        args.warmup_epochs = warmup_epochs
    return distill.build_method(distill.build_config(args, steps_per_epoch),
                                args, dev)


def distill_step_check(dev, argv, data):
    """One distillation step of the flags ``argv`` (one step an epoch, so
    at the base learning rate) at B = 4 from the same state and draws on
    the card and on the CPU (f32, TF32 off), held as
    :func:`finetune_step_check` holds the finetuning step: the loss within
    ``FT_LOSS_REL``, every leaf's clipped gradient (the momentum trace
    after one step) at cosine >= ``FT_LEAF_COS``, the updated parameters
    within ``FT_PARAM_ATOL``, the final norm's bias (behind the student
    head's BatchNorm) within ``FT_ZERO_REL`` of the largest leaf's norm.
    Returns the card's method and state."""
    from audiossl_tpu_torch.datasets import BatchLoader, PackedAudioDataset

    batch = next(iter(BatchLoader(PackedAudioDataset(data, "train"),
                                  DISTILL_CHECK_B, pad_samples=160000,
                                  shuffle=False)))
    out = []
    for d in (dev, torch.device("cpu")):
        method, state = distill_task(argv[:-4] + ["--device", str(d)], d, 1)
        if d == dev:
            draws = method.draw(state, DISTILL_CHECK_B,
                                batch["wav"].shape[1]).to("cpu")
        before = {k: p.detach().to("cpu", copy=True)
                  for k, p in state.params.items()}
        t0 = time.perf_counter()
        _, m = method.train_step(state, batch, draws.to(d))
        out.append(({k: float(m[k]) for k in ("loss", "loss_d", "loss_c",
                                               "gnorm")},
                    {k: v.detach().cpu() for k, v in state.mu.items()},
                    {k: p.detach().cpu() for k, p in state.params.items()},
                    before, time.perf_counter() - t0, method, state))
    (mc, gc, pc, _, tc, *card), (mh, gh, ph, before, th, *_) = out
    rel = {k: abs(mc[k] - mh[k]) / abs(mh[k]) for k in mc}
    zero = "encoder.norm_frame.bias"
    top = max(float(v.norm()) for v in gh.values())
    zero_rel = float((gc[zero] - gh[zero]).norm()) / top
    cos, worst, unused, unchanged, param_err = step_agreement(
        gc, gh, pc, ph, before, skip=zero)
    print(json.dumps({"distill_as_step_card_vs_cpu": {
        "card": CARD, "batch": DISTILL_CHECK_B, "card_metrics": mc,
        "cpu_metrics": mh, "rel": rel, "leaves_compared": len(cos),
        "lowest_cos": [worst, cos[worst]], "param_max_abs_diff": param_err,
        "no_gradient": unused, "unchanged": unchanged,
        "final_norm_bias_diff_rel": zero_rel, "card_s": tc, "cpu_s": th}}))
    for k in ("loss", "loss_d", "loss_c", "gnorm"):
        check(np.isfinite(mc[k]) and rel[k] <= FT_LOSS_REL,
              f"distill_as step: card {k} {mc[k]} vs CPU {mh[k]} (rel "
              f"{rel[k]} <= {FT_LOSS_REL})")
    check(cos[worst] >= FT_LEAF_COS,
          f"distill_as step: every leaf's clipped gradient at cosine >= "
          f"{FT_LEAF_COS} to the CPU's (lowest {worst} {cos[worst]})")
    check(param_err <= FT_PARAM_ATOL, f"distill_as step: the updated "
          f"parameters within {FT_PARAM_ATOL} of the CPU's ({param_err})")
    check(zero_rel <= FT_ZERO_REL, f"distill_as step: {zero}'s gradient "
          f"within {FT_ZERO_REL} of the largest leaf's norm ({zero_rel})")
    check(unused == ["encoder.mask_embed"],
          "distill_as step: only the unused mask_embed has no gradient")
    return card


def distill_breakdown(method, state, data):
    """Where a distillation step's time goes at B = 64
    (:func:`breakdown`): ``DistillMethod.train_step`` on the first train
    batch with fresh draws each step; the host's copy of the batch to the
    card included."""
    from audiossl_tpu_torch.datasets import BatchLoader, PackedAudioDataset

    batch = next(iter(BatchLoader(PackedAudioDataset(data, "train"),
                                  DISTILL_B, pad_samples=160000,
                                  shuffle=False)))

    def step():
        draws = method.draw(state, DISTILL_B, batch["wav"].shape[1])
        return float(method.train_step(state, batch, draws)[1]["loss"])

    breakdown(step, f"distill_as_step_of_{DISTILL_B}", top=8)


def distill_as_path(dev, workdir, data):
    """``methods.distill.train.main`` at base width on the card: the
    teacher (clip base, no gradient) and the student (frame base, drop path
    0.1) on one mel of each batch through K1, the student head's BCE to the
    teacher's sigmoid and to the labels, the clipped layer-decayed SGD, the
    epoch's save. Checks K1 once a train batch and no other kernel, finite
    losses, the checkpoint manager's one save (the first epoch's) read back
    by the ``distillatst`` adapter equal tensor for tensor to the student at
    that step; then one step on the card against the CPU and one step's
    device time by kernel. Prints train clips/s by step (the first left
    out) and peak memory. Returns the launch counts of ``main``."""
    from audiossl_tpu_torch.downstream.comparison_models import get_adapter
    from audiossl_tpu_torch.methods.distill import train as distill

    teacher = write_distill_teacher(workdir, 527)
    student = write_ft_ckpt(workdir, "frame")
    out = os.path.join(workdir, "distill_as")
    argv = distill_argv(data, teacher, student, out, dev)
    state, record, launches, peak, wall = run_timed(distill.main, argv)
    steps = [s for epoch in record["steps"] for s in epoch]
    print(f"distill_as launches: {launches}; {len(steps)} train batches; "
          f"main took {wall:.2f} s")
    check(len(steps) == DISTILL_EPOCHS * (PROBE_SPLITS[0][1] // DISTILL_B)
          and all(s[0] == DISTILL_B for s in steps),
          f"distill_as: {DISTILL_EPOCHS} epochs of full train batches")
    check(launches["mel_db"] == len(steps),
          f"distill_as: K1 launched once per train batch, the teacher's mel "
          f"the student's ({launches['mel_db']} of {len(steps)})")
    check(not any(v for k, v in launches.items() if k != "mel_db"),
          "distill_as: no other kernel launched (f32 module route)")
    check(all(np.isfinite(s[2:]).all() for s in steps),
          "distill_as: finite losses")
    train = steps[1:]
    print(json.dumps({"distill_as": {
        "card": CARD,
        "train_clips_per_s": sum(s[0] for s in train)
        / sum(s[1] for s in train),
        "by_step": [s[0] / s[1] for s in steps],
        "loss_by_step": [s[2] for s in steps], "peak_gib": peak,
        "main_s": wall, "k1_launches": launches["mel_db"]}}))
    saved = sorted(os.listdir(os.path.join(out, "ckpt")))
    first = PROBE_SPLITS[0][1] // DISTILL_B
    check(saved == [str(first)] and list(record["saved"]) == [first],
          f"distill_as: the checkpoint manager kept the first epoch's save "
          f"alone ({saved})")
    enc = get_adapter("distillatst", ckpt_path=os.path.join(
        out, "ckpt", str(first)), arch=FT_ARCH, device=dev).encoder
    want = record["saved"][first]
    got = enc.state_dict()
    check(len(got) == sum(k.startswith("encoder.") for k in want) and all(
        torch.equal(v.cpu(), want[f"encoder.{k}"]) for k, v in got.items()),
          "distill_as: the distillatst adapter reads the saved student "
          "equal tensor for tensor")
    del state, enc, got, record
    torch.cuda.empty_cache()
    method, state = distill_step_check(dev, argv, data)
    distill_breakdown(method, state, data)
    return launches


def distill_other_path(dev, workdir):
    """``methods.distill.train_other.main`` at base width on the card on a
    seeded spcv2 tree (35 labels; 256 train, 70 validation and 70 test
    clips of 1 s in 12 s central crops: the teacher's 2 chunks of 601
    frames, the student's 2 chunks of 1001, the second unmarked), batches
    of 64, 1 epoch: K1 once per train and evaluation batch and no other
    kernel, ``result.json`` with the validation and test ACC finite in
    [0, 1]; train and evaluation clips/s. Returns the launch counts."""
    from audiossl_tpu_torch.methods.distill import train_other

    tree = write_spcv2_tree(workdir, "spcv2", SPCV2_SPLITS)
    out = os.path.join(workdir, "distill_other")
    argv = ["--dataset_name", "spcv2", "--data_path", tree,
            "--teacher_ckpt_path", write_distill_teacher(workdir, 35),
            "--student_ckpt_path", write_ft_ckpt(workdir, "frame"),
            "--arch", FT_ARCH, "--max_len", "12", "--batch_size",
            str(DISTILL_B), "--max_epochs", "1", "--save_path", out,
            "--device", str(dev), "--n_devices", "1"]
    res, record, launches, peak, wall = run_timed(train_other.main, argv)
    steps = [s for epoch in record["steps"] for s in epoch]
    evals = [b for _, batches in record["evals"] for b in batches]
    print(f"distill_other launches: {launches}; {len(steps)} train and "
          f"{len(evals)} eval batches; main took {wall:.2f} s")
    check(len(steps) == SPCV2_SPLITS[0][1] // DISTILL_B
          and all(s[0] == DISTILL_B for s in steps),
          "distill_other: one epoch of full train batches")
    check(launches["mel_db"] == len(steps) + len(evals),
          f"distill_other: K1 launched once per train and eval batch "
          f"({launches['mel_db']} of {len(steps) + len(evals)})")
    check(not any(v for k, v in launches.items() if k != "mel_db"),
          "distill_other: no other kernel launched (f32 module route)")
    train = steps[1:]
    print(json.dumps({"distill_other": {
        "card": CARD,
        "train_clips_per_s": sum(s[0] for s in train)
        / sum(s[1] for s in train),
        "by_step": [s[0] / s[1] for s in steps],
        "eval_clips_per_s": sum(n for n, _ in evals)
        / sum(t for _, t in evals),
        "eval_by_batch": [n / t for n, t in evals], "peak_gib": peak,
        "result": res, "main_s": wall, "k1_launches": launches["mel_db"]}}))
    with open(os.path.join(out, "result.json")) as f:
        result = json.load(f)
    check(result == res and set(result) == {"dataset", "val", "test"},
          f"distill_other result.json {result}")
    for key in ("val", "test"):
        check(np.isfinite(result[key]) and 0.0 <= result[key] <= 1.0,
              f"distill_other {key} ACC {result[key]} finite in [0, 1]")
    return launches


def ddp_distill_path(dev, workdir, data):
    """``ddp_distill``: the ``distill_as`` step at a global batch of 16 from
    the probe pack (:func:`ddp_downstream_path`), then ``train_other`` on 2
    ranks for one epoch of batches of 16 on a spcv2 tree whose validation
    and test splits of 33 clips end on a ragged batch."""
    from audiossl_tpu_torch.datasets import BatchLoader, PackedAudioDataset

    student = write_ft_ckpt(workdir, "frame")
    argv = distill_argv(data, write_distill_teacher(workdir, 527), student,
                        os.path.join(workdir, "unused"), dev)
    loader = iter(BatchLoader(PackedAudioDataset(data, "train"), DDP_DS_B,
                              pad_samples=160000, shuffle=False))
    batches = [next(loader) for _ in range(DDP_DS_STEPS)]
    tree = write_spcv2_tree(workdir, "ddp_spcv2", DDP_SPCV2_SPLITS)
    cli_argv = ["--dataset_name", "spcv2", "--data_path", tree,
                "--teacher_ckpt_path", write_distill_teacher(workdir, 35),
                "--student_ckpt_path", student, "--arch", FT_ARCH,
                "--batch_size", str(DDP_DS_B), "--max_epochs", "1",
                "--save_path", os.path.join(workdir, "ddp_distill_cli")]
    return ddp_downstream_path(
        dev, os.path.join(workdir, "ddp_distill"), "distill", argv, batches,
        "audiossl_tpu_torch.methods.distill.train_other", cli_argv,
        kept="ckpt")


def distill_paths(dev, workdir, data, run_path):
    """The three distillation paths, each through ``run_path``."""
    for name, fn in (("distill_as", lambda: distill_as_path(dev, workdir,
                                                            data)),
                     ("distill_other", lambda: distill_other_path(dev,
                                                                  workdir)),
                     ("ddp_distill", lambda: ddp_distill_path(dev, workdir,
                                                              data))):
        torch.cuda.empty_cache()
        run_path(name, fn)


def pretrain_eval_path(dev, workdir):
    """The port's own pretraining checkpoint evaluated: the newest
    ``state.pt`` of ``pretrain_frame_cli`` (ATST-Frame base) through
    ``embedding.load_model`` (its step directory) and
    ``train_freeze.load_encoder`` (the file): every tensor of each encoder
    equal to the saved teacher encoder's, the arch read off the shapes,
    and one scene embedding (K1 once) finite; then the run's directory
    is removed. Returns its launches."""
    import shutil

    from audiossl_tpu_torch.downstream.train_freeze import load_encoder
    from audiossl_tpu_torch.embedding import get_scene_embedding, load_model
    from audiossl_tpu_torch.kernels import build as kb
    from audiossl_tpu_torch.training.checkpoint import (STATE_FILE,
                                                        CheckpointManager)

    ckpts = os.path.join(workdir, "frame_cli", "ckpt")
    step_dir = os.path.join(ckpts, str(CheckpointManager(ckpts).latest_step))
    saved = torch.load(os.path.join(step_dir, STATE_FILE), map_location="cpu",
                       weights_only=True)["teacher"]
    want = {k[len("encoder."):]: v for k, v in saved.items()
            if k.startswith("encoder.")}
    model = load_model(step_dir, device=dev)
    enc = load_encoder(os.path.join(step_dir, STATE_FILE), "frame", "base",
                       device=dev)
    for label, e in (("load_model", model.encoder), ("load_encoder", enc)):
        got = e.state_dict()
        unequal = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
        check(got.keys() == want.keys() and not unequal,
              f"pretrain_eval: {label} of {step_dir} is the saved teacher "
              f"encoder tensor for tensor ({len(want)} tensors; unequal "
              f"{unequal[:5]})")
    check((model.encoder.embed_dim, model.encoder.depth) == (768, 12),
          "pretrain_eval: the base arch read off the checkpoint")
    wav = torch.from_numpy(serving_audio()[0][:2]).to(dev)
    torch.cuda.synchronize()
    kb.reset_launches()
    emb = get_scene_embedding(wav, model)
    torch.cuda.synchronize()
    launches = dict(kb.LAUNCHES)
    check(tuple(emb.shape) == (2, 12 * 768) and bool(torch.isfinite(emb).all())
          and launches["mel_db"] == 1 and sum(launches.values()) == 1,
          f"pretrain_eval: a finite scene embedding {tuple(emb.shape)} "
          f"through K1 ({launches})")
    print(f"pretrain_eval: {step_dir} loaded by load_model and load_encoder, "
          f"{len(want)} tensors equal to the saved teacher encoder's; scene "
          f"embedding {tuple(emb.shape)}")
    del model, enc
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(workdir, "frame_cli"))
    return launches


def profile_step(step, state, batch, out_dir, label):
    """One kernel-path step under torch.profiler: a table of device time
    by kernel and a chrome trace in out_dir."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=60)
    with open(os.path.join(out_dir, f"{label}_step_profile.txt"), "w") as f:
        f.write(f"wall {wall * 1e3} ms\n{table}\n")
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"{label}_step_trace.json"))
    print(f"profile of one {label} step ({wall * 1e3} ms wall) written "
          f"to {out_dir}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="write a profile of one ATST-Frame bf16, one "
                         "ATST-Clip f32, one ATST-Frame f32 and one "
                         "ATST-Frame int8dx training step to DIR")
    args = ap.parse_args()
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "audiossl_tpu_torch", "csrc")):
        print("chip_smoke: the audiossl_tpu_torch package is not beside "
              "this script; nothing was run", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from audiossl_tpu_torch.kernels import build as kb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    # plain f32 references run in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    kb.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s")
    k1_k7_k8_build_report()
    record_launch_shapes()

    gemm_checks(dev)
    res = kernel_checks(dev)
    train_mel_check(dev)
    res.update(train_kernel_checks(dev))
    res.update(mha_kernel_checks(dev))
    t0 = time.perf_counter()
    for name, cases in k6_maeast_checks(dev).items():
        res[name].update(cases)
    print(f"K6 at MAE-AST's shapes: {time.perf_counter() - t0:.1f} s")
    res.update(ln_kernel_checks(dev))
    res["adamw_ema"] = adamw_ema_check(dev, *student_leaves(dev))
    for part in zero1_leaves(*student_leaves(dev)):  # ddp_frame's ZeRO-1
        adamw_ema_check(dev, *part, timed=False)
    odd = [(3, 5), (7,), (2049,), (1,), (33, 31), (2, 2048), (4097,)]
    adamw_ema_check(dev, odd, [i % 3 != 1 for i in range(len(odd))],
                    [len(s) >= 2 for s in odd], timed=False)
    res.update(q8_infer_checks(dev))
    res.update(train_kernel_checks(dev, quant="int8dx"))
    for n, key in ((CLIP_N, "clip"), (CLI_CLIP_N, "clip_cli")):
        for name, r in clip_block_checks(dev, n).items():
            res[name][key] = r
    for name, r in d128_checks(dev).items():
        res[name]["d128"] = r
    # the MAE and dual steps' shapes and leaves
    t_new = time.perf_counter()
    from audiossl_tpu_torch.methods.dual.method import DualMethod
    from audiossl_tpu_torch.methods.mae.method import MAEMethod

    res["mel_db"]["max_abs_err"] = max(
        res["mel_db"]["max_abs_err"],
        k1_compare(dev, (TRAIN_B, 1026, dual_recipe("float32").out_frames)))
    for name, r in train_kernel_checks(dev, DUAL_N, CLIP_C, CLIP_H,
                                       4 * CLIP_C, timed=False,
                                       S=TRAIN_B).items():
        res[name]["dual"] = r
    res["adamw_ema"]["mae_no_teacher"] = adamw_no_teacher_check(
        dev, "mae_no_teacher", lambda: MAEMethod(mae_recipe(),
                                                 device="meta"))
    res["adamw_ema"]["dual_no_teacher"] = adamw_no_teacher_check(
        dev, "dual_no_teacher", lambda: DualMethod(dual_recipe("float32"),
                                                   device="meta"))
    new_s = {"kernel checks": time.perf_counter() - t_new}
    print(f"MAE and dual kernel checks: {new_s['kernel checks']:.1f} s")
    # every launch so far was compared with its plain version at its shape
    checked = {k: set(v) for k, v in LAUNCH_SEEN.items()}
    paths, seen = {}, {}

    path_s = {}

    def run_path(name, fn):
        LAUNCH_SEEN.clear()
        t0 = time.perf_counter()
        paths[name] = fn()
        path_s[name] = time.perf_counter() - t0
        print(f"path {name}: {path_s[name]:.1f} s")
        seen[name] = {k: sorted(v) for k, v in LAUNCH_SEEN.items()}

    with tempfile.TemporaryDirectory() as workdir:
        path = write_base_ckpt(workdir)
        run_path("serving", lambda: main_path(dev, path))
        run_path("serving_int8", lambda: q8_serving_path(dev, path))
    run_path("clip_serving", lambda: clip_infer_path(dev))
    with tempfile.TemporaryDirectory() as workdir:
        data = write_probe_pack(workdir)
        for kind in ("clip", "frame"):
            run_path(f"probe_{kind}",
                     lambda: probe_path(dev, workdir, data, kind))
        for kind in ("clip", "frame"):
            torch.cuda.empty_cache()
            run_path(f"finetune_{kind}",
                     lambda: finetune_path(dev, workdir, data, kind))
        torch.cuda.empty_cache()
        run_path("ddp_finetune", lambda: ddp_finetune_path(dev, workdir, data))
        distill_paths(dev, workdir, data, run_path)
    with tempfile.TemporaryDirectory() as workdir:
        dcase, as_strong, sed_ckpt = sed_paths(dev, workdir, run_path)
        torch.cuda.empty_cache()
        run_path("ddp_sed", lambda: ddp_sed_path(dev, workdir, dcase,
                                                 sed_ckpt))
        torch.cuda.empty_cache()
        run_path("comparison_encoders",
                 lambda: comparison_encoders_path(dev))
        torch.cuda.empty_cache()
        run_path("comparison_sed", lambda: comparison_sed_path(
            dev, workdir, dcase, as_strong))
    for name, fn in (("frame_bf16", lambda: frame_bf16_path(dev, args.profile)),
                     ("clip_f32", lambda: clip_f32_path(dev, args.profile)),
                     ("clip_bf16", lambda: clip_bf16_path(dev)),
                     ("frame_f32", lambda: frame_f32_path(dev, args.profile)),
                     ("frame_int8dx",
                      lambda: frame_q8_path(dev, "int8dx", args.profile)),
                     ("frame_int8", lambda: frame_q8_path(dev, "int8")),
                     ("clip_int8dx", lambda: clip_q8_path(dev, "int8dx")),
                     ("clip_int8", lambda: clip_q8_path(dev, "int8")),
                     ("frame_bf16_d2v", lambda: frame_d2v_path(dev)),
                     ("mae_small", lambda: mae_small_path(dev)),
                     ("dual_f32", lambda: dual_f32_path(dev)),
                     ("dual_bf16", lambda: dual_bf16_path(dev))):
        torch.cuda.empty_cache()
        run_path(name, fn)
    with tempfile.TemporaryDirectory() as workdir:
        data = write_cli_pack(workdir)
        torch.cuda.empty_cache()
        run_path("pretrain_frame_cli",
                 lambda: pretrain_frame_cli_path(dev, workdir, data))
        run_path("pretrain_eval", lambda: pretrain_eval_path(dev, workdir))
        crash_restart_path(workdir, data)
        for name, recipe, extra, want in (
                ("pretrain_clip_cli", "torch_atst_clip_small.sh", [],
                 bf16_want(2)),
                ("pretrain_d2v_cli", "torch_atst_frame_base.sh",
                 ["--avg_blocks", "8"], bf16_want(1)),
                ("pretrain_frame_cli_int8dx", "torch_atst_frame_base.sh",
                 ["--teacher_quant", "int8", "--student_quant", "int8dx"],
                 q8_want("int8dx", 1))):
            torch.cuda.empty_cache()
            run_path(name, lambda: cli_untimed_path(dev, data, recipe, extra,
                                                    want))
        torch.cuda.empty_cache()
        run_path("ddp_frame", lambda: ddp_frame_path(dev, workdir, data))
        for which, extra, want in (
                ("mae", [], MAE_WANT),
                ("dual", ["--arch", "small", "--anchor_len",
                          str(DUAL_ANCHOR)], dual_want("float32"))):
            torch.cuda.empty_cache()
            run_path(f"pretrain_{which}_cli", lambda: method_cli_path(
                dev, data, workdir, which, extra, want))
        torch.cuda.empty_cache()
        run_path("ddp_dual", lambda: ddp_dual_path(dev, workdir))
    for name in ("mae_small", "dual_f32", "dual_bf16", "pretrain_mae_cli",
                 "pretrain_dual_cli", "ddp_dual"):
        new_s[name] = path_s[name]
    print(f"MAE and dual phases: {sum(new_s.values()):.1f} s "
          f"({ {k: round(v, 1) for k, v in new_s.items()} })")
    k1_seen = {p: v.get("mel_db", []) for p, v in seen.items()}
    print(f"K1 STFT shapes by path: {k1_seen}")
    for name, shape in list(K1_SHAPES.items()) + [
            (p, K1_SHAPES[q]) for p, q in K1_SAME_SHAPE.items()]:
        check(shape in k1_seen[name],
              f"K1 timed at a shape the {name} path ran, {shape}")
    for shape in sorted({s for v in k1_seen.values() for s in v}
                        - checked["mel_db"]):
        res["mel_db"]["max_abs_err"] = max(res["mel_db"]["max_abs_err"],
                                           k1_compare(dev, shape))
        checked["mel_db"].add(shape)
    res["mel_db"]["path_shapes"] = k1_seen
    print(f"launch shapes compared with the plain versions: "
          f"{ {k: sorted(v) for k, v in checked.items()} }")
    print(f"launch shapes by path: {seen}")
    unchecked = {f"{name} {kernel}": sorted(set(v) - checked.get(kernel, set()))
                 for name, by_kernel in seen.items()
                 for kernel, v in by_kernel.items()}
    unchecked = {k: v for k, v in unchecked.items() if v}
    check(not unchecked, "every launch of K1-K6 and K8 on the main paths at "
          f"a shape compared with its plain version (not: {unchecked})")

    sources = {
        "mel_db": ("mel_db.cu", "audiossl_tpu/ops/pallas_mel.py:39"),
        "attn_block": ("attn_block.cu", "audiossl_tpu/ops/pallas_block.py:282"),
        "mlp_block": ("mlp_block.cu", "audiossl_tpu/ops/pallas_block.py:360"),
        "attn_train_fwd": ("attn_train.cu",
                           "audiossl_tpu/ops/pallas_attn.py:304"),
        "attn_train_bwd": ("attn_train.cu",
                           "audiossl_tpu/ops/pallas_attn.py:396"),
        "mlp_train_fwd": ("mlp_train.cu", "audiossl_tpu/ops/pallas_mlp.py:277"),
        "mlp_train_bwd": ("mlp_train.cu", "audiossl_tpu/ops/pallas_mlp.py:350"),
        "adamw_ema": ("adamw_ema.cu", "audiossl_tpu/ops/pallas_opt.py:150"),
        "mha_fwd": ("mha.cu", "audiossl_tpu/ops/pallas_mha.py:212"),
        "mha_bwd": ("mha.cu", "audiossl_tpu/ops/pallas_mha.py:261"),
        "ln_pg_bwd": ("ln_pg.cu", "audiossl_tpu/ops/pallas_ln.py:95"),
        "attn_block_q8": ("attn_block.cu",
                          "audiossl_tpu/ops/pallas_block.py:179"),
        "mlp_block_q8": ("mlp_block.cu",
                         "audiossl_tpu/ops/pallas_block.py:223"),
        "attn_train_fwd_q8": ("attn_train.cu",
                              "audiossl_tpu/ops/pallas_attn.py:106"),
        "attn_train_bwd_q8dx": ("attn_train.cu",
                                "audiossl_tpu/ops/pallas_attn.py:252"),
        "mlp_train_fwd_q8": ("mlp_train.cu",
                             "audiossl_tpu/ops/pallas_mlp.py:120"),
        "mlp_train_bwd_q8dx": ("mlp_train.cu",
                               "audiossl_tpu/ops/pallas_mlp.py:225"),
    }
    check(set(sources) == set(kb.LAUNCHES), "every counted kernel listed")
    kernels = []
    for name, (src, rep) in sources.items():
        by_path = {p: launches.get(name, 0) for p, launches in paths.items()}
        check(sum(by_path.values()) > 0, f"{name} launched on a main path")
        missing = {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms"} - set(res[name])
        check(not missing, f"{name} measured in full (missing {missing})")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"audiossl_tpu_torch/csrc/{src}",
                        "replaces": rep, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **res[name]})
    print(f"chip_smoke: all checks passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
