#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's sampling paths and its trainers once on one GPU.

    python3 chip_smoke.py [--profile] [--kernels] [--gemm-ab] [--wan-phase2] [--wan-interp]
                          [--video-toy] [--multi-device]

Phases, each on its own lines; any failure exits non-zero:
  1. device       the card's name and power limit (nvidia-smi); CUDA required
  2. build        nvcc builds csrc/*.cu (one process per source) into
                  build/kernels/<hash>/
  3. kernels      the maze kernels against their plain PyTorch twins, bf16, at
                  the shapes the maze path gives them: the block's GEMM alone
                  (gemm_bias_act, each epilogue at the path's eight (M, N, K),
                  at M = 8, at a ragged M and at a width served by the narrower
                  tiles), the block (also at L = 4 and 3, the causal
                  sampler's per-chunk Stage 1), and small_mha_packed /
                  small_mha over L in 1..256 at both head dims
  4. main         make_pipeline at the bench configuration (384d x 12 layers x
                  12 heads, T=64, K=8, DDIM-20, 3 levels, seeded random
                  weights): requests of B in {1, 64, 1024} under attn_policy
                  "block" and B=64 under "fused"; invariants, launch counts,
                  and agreement of the kernel path with the plain-twin path
  5. timings      maze kernels vs twins (CUDA events; short ones also by graph
                  replay): the four products alone against F.linear, the block
                  at [1024,64,384], [1024,8,384] and [1024,4,384] against the same block made
                  of PyTorch's own calls (F.linear x 4,
                  scaled_dot_product_attention, layer_norm, silu), small_mha_packed
                  against scaled_dot_product_attention; then pipeline samples/s
  5a. maze grads  small_mha against its twin ([256, 64, 384] H=12 and the tiled
                  cases [64, 512, 128] H=2, [16, 1024, 64] H=1 and a ragged
                  [8, 300, 64] H=2; the tiled kernel's device time also by
                  replaying captured launches as a CUDA graph, since a loop of
                  launches this short is paced by the host), then the three
                  maze autograd
                  Functions (small_mha, small_mha_packed, fused_film_block with
                  f32 master parameters): kernel forward + twin-recompute
                  backward against the twin path, output and every input's
                  gradient, at the trainers' shapes ([256, 64, 384], [256, 8, 384])
  5b. maze train  the Stage-1 and Stage-2 trainers (train/train_keypoints,
                  train/train_interp_levels) at their defaults (384d x 12
                  layers x 12 heads, T=64, K=8, levels 3, batch 256, bf16 compute
                  over f32 masters) on ParticleMazeDataset: Stage 2 under
                  attn_policy fused and block, Stage 1 under block; loss and every
                  leaf's gradient of the kernel path against the twin path,
                  1 warm-up + timed steps through the trainer's own step, launch
                  counts, no forward twin call, every parameter changed, EMA
                  moved; a 12-block TransformerBlock(use_small_mha=True) stack
                  forward and backward; then both CLIs (main) for a few steps
                  with a checkpoint and a resume, and the trained EMA weights
                  through models/loading into make_pipeline
  5c. sample cli  the sampling CLI (sample/generate.main, --device cuda) on the
                  full-width checkpoints of 5b's CLI runs and an rf Stage-1
                  checkpoint trained here by the CLI, batch 256 x 3 batches,
                  linear DDIM-20: ddim, pfdiff, dpm (20 and 10 steps), FORA
                  interval 2, best-of-4 (dp and set), level noise with delta
                  smoothing, --compare_oracle, policy fused, rf; launches per
                  call (SAMPLE_CLI_STAGE1), no twin call, the files and their
                  columns, samples/s and the sanity verdict (not a gate); then
                  make_pipeline at B=64 with an anchor-confidence Stage 2 under
                  pfdiff, dpm, FORA 2, best-of-4 dp, rf, soft clamp + level
                  noise and logit space, kernel path against twin path
  5d. serve and   the C++ maze generator (a shard of 10000 mazes 21x21, native
      select      and numpy, two native builds bit for bit); D_phi and the
                  keypoint selector at their trainers' defaults (batch 256,
                  s/step); prepare_dp_keypoints (T=64, K=8, levels 3, 2048
                  mazes; gt, then D_phi costs) and its invariants; the DP on
                  the card against the CPU on the same cost matrix; at BENCH
                  width under block: Stage 1 with --use_kp_feat / --dphi_ckpt
                  / a dp,selector,random policy, Stage 2 with --mask_policy
                  selector_level, the sampling CLI with --kp_index_mode
                  selector --stage2_mask_policy selector (256 x 3), launches
                  per call, no twin call, and the kp_feat + selector pipeline
                  kernel path vs twin path; GenerationService (buckets 1, 4,
                  16, 64, block) on 5b's and on the kp_feat checkpoints:
                  warm-up, B = 1, 3, 64, 264 launches a dispatch, kernel path
                  vs twin path, latency per bucket over 20 calls; the HTTP
                  server with 16 concurrent clients (coalescing, p50 / p95);
                  and the service under fused (36 small_mha_packed a dispatch)
  5e. causal      the causal Stage-2 trainer CLI (train_interp_levels_causal,
                  its defaults: bench width, batch 256, levels 3, bf16) for a
                  few steps with a checkpoint and a resume (s/step, peak
                  memory, no launch of rows 1-2: causal attention takes no
                  kernel); the causal sampling CLI (sample/generate_causal)
                  on 5b's Stage 1 and that checkpoint, 256 x 3, chunk 16,
                  K_min 4, DDIM-10, under block (ddim, pfdiff, FORA 2,
                  best-of-4 dp) and fused: launches per call, no twin call,
                  the JAX CSV columns and summary keys, samples/s (and the
                  device's busy share under --profile); make_causal_pipeline
                  at B=64 kernel path vs twin path; sample_keypoints under
                  block; the JAX checkpoints runs/wansynth_debug/{p1,p2,flow}
                  through the port's msgpack reader
  6. wan kernels  the SLA, int8 SLA and flash kernels against their twins at
                  the Wan anchor path's shapes, at the 33k-token geometry of
                  scripts/bench_wan33k.py (blocks 128 and 256) and at a
                  sentinel case; the flash kernel also at head dim 64 and at
                  shapes ragged in queries and keys
  7. wan main     Phase-1 anchor sampling (sample/wan_anchors) through
                  Wan2.1-1.3B at full width, 6 of 30 layers (1536d x 12
                  heads, ffn 8960, LoRA rank 8, frame conditioning, B=4,
                  K=5 anchors of 16x60x104 latents, L=7800, 3 DDIM
                  evaluations, seeded random weights) under attn_mode sla,
                  sage_sla and flash; shapes, finiteness, launch counts and
                  agreement of the kernel path with the plain-twin path
  8. wan timings  Wan kernels vs twins (CUDA events; the SLA and int8 SLA
                  forward also by graph replay; the SLA forward beside
                  scaled_dot_product_attention under the LUT as a mask) and
                  sampler samples/s per mode (kernels, twins, twins, kernels)
  9. wan bwd      the SLA and flash backward kernels (dQ, dK/dV) against their
                  twins at the trainer's shapes ([24, 7800, 128]; SLA blocks
                  256 and 128, one LUT with duplicated ids, one with a key
                  block no query block names (dk = dv = 0 exactly), the LUT
                  walks' edges of SLA_EDGES (blocks 64 and 192, block_m !=
                  block_n, head dim 64), the 33k-token geometry (blocks 128
                  and 256), every SLA case also two calls bit for bit, and
                  the histogram of query tiles per dK/dV work item; flash
                  cross 7800 x 517 and self 7800 x 7800, also at head dim 64,
                  ragged lengths, fewer than 64 keys, and two calls bit for
                  bit), with CUDA-event times (SLA also by graph replay) and
                  the library's backward
  10. wan train   Phase-1 LoRA training (train/train_keypoints_wansynth) at
                  the trainer's defaults: Wan2.1-1.3B at full width and depth,
                  batch 2, L=7800, bf16, LoRA rank 8, frame conditioning,
                  remat, synthetic data; attn_mode sla (1 warm-up + 3 timed
                  steps), sage_sla and dense (1 warm-up + 2 timed steps each)
                  through the trainer's own step; finite loss, every trainable leaf
                  changed, frozen base bit-identical, launch counts, no twin
                  call, and loss / gradients of the kernel path against the
                  plain-twin path from the same state, batch and draws (the
                  twin path replays the kernel path's SLA LUTs: the top-k
                  block choice is discrete, so an ulp upstream can flip a
                  block on one path only; how many rows its own choice
                  differs in, and its reading on its own LUTs, are printed)
  5f. wan phase 2 the Wan Phase-2 chain through its CLIs at Wan2.1-1.3B width
                  and depth: 8 synthetic clips at the full shapes (T=21,
                  16x60x104, text 512x4096) as tar shards (data/make_synth_tars);
                  the Phase-1 trainer CLI at its defaults for 2 steps; the
                  anchor precompute CLI (batch 4, 30 layers) under ddim,
                  pfdiff and FORA 2, its shards' fields and launches per call;
                  rows 4-8 against their twins at the Phase-2 trainer's
                  shapes ([24, 32760, 128], SLA block 256, top-k 12; flash
                  cross x 533 keys and self x 32760) with their times, bounds
                  and library times; the Phase-2 loss and gradients at 4 of 30
                  layers, full width and L = 32760, kernel path vs twin path
                  (LUTs replayed), under sla, sage_sla and dense; the Phase-2
                  trainer CLI at its defaults on the anchor-joined shards: 4
                  sla steps, then resumed for 2 sage_sla and 2 dense steps
                  (launches per step, no twin call, s/step, peak memory); the
                  evaluation CLI on each mode's checkpoint (launches per
                  batch, the five MSEs, samples/s) and its MSEs on the kernel
                  path vs the twin path. Runs after phase 10; the checkpoints
                  live in a temp dir that is removed
  5g. wan interp  the rest of the Wan video chain, after 5f: 8 synthetic clips
                  at the full shapes as tar shards; the five interpolator /
                  selector trainer CLIs at their defaults (flow, straightener,
                  Sinkhorn, video D_phi, video selector; batch 8 / 8 / 4 / 8 /
                  8, 4 steps), each with s/step, peak memory, finite losses,
                  no kernel launch and a checkpoint read back, and its model's
                  f32 forward on the card against the CPU's (the Sinkhorn
                  model's SE(2) choices replayed, 1e-4); the teacher
                  precompute (lerp and the flow checkpoint) joined back by
                  key; eval_interpolators under lerp, flow and sinkhorn; full
                  fine-tuning (--lora_rank 0 --bf16 1): at 4 of 30 layers the
                  kernel path vs the twin path (LUTs replayed) over every
                  weight's gradient, then the Phase-1 trainer CLI at 30
                  layers, 2 steps each under sla and sage_sla (launches per
                  step of rows 4-8, s/step, peak memory, every weight f32
                  and moved)
  5h. video toy   the toy-video and DiDeMo slice at the JAX trainers' default
                  width (512d x 8 layers x 8 heads, d_ff 2048), after 5e
                  (`--video-toy` alone): rows 1 and 2 against their twins at
                  the slice's shapes with times, bounds and library times;
                  both toy trainers (batch 64, T 16, 16x16x3 latents; loss and
                  every leaf's gradient of the kernel path vs the twin path
                  under block, then each CLI for 4 steps under fused and
                  block: launches per step, no forward twin call, s/step,
                  peak memory, the checkpoint read back); sample_toy_video
                  (16 x 2, DDIM-20) on those checkpoints under both policies
                  (launches per call, samples/s), then its pipeline at B 16
                  with a seeded Stage-2 head, kernel path vs twin path on the
                  same draws (z_pred and each refinement's step; --profile:
                  one call's device time by kind and busy share);
                  train_video_interpolator --workload toy
                  (batch 32); the card's f32 forward against the CPU's for
                  the temporal-conv and lerp-residual interpolators, FrameVAE
                  and the full-width SDVAE (64x64 and 256x256 frames, with
                  encode / decode times); eval_interpolators --rgb 1 on 32x32
                  SD latents; both DiDeMo trainers at batch 16 on the
                  synthetic clip cache and on a cache of DiDeMo's own shapes
                  (SD latents [16, 4, 8, 8] by the seeded SDVAE, text [77,
                  512]), under fused and block, each with the gate where a
                  kernel runs and a 4-step CLI run
  5i. multi-    torch.distributed, after 5e (`--multi-device` alone, on seeded
      device      checkpoints, prints its own JSON line and the ok line). (a) One
                  process on NCCL, torchrun's variables (RANK 0, WORLD_SIZE 1, a
                  free port) set here: the maze Stage-2 trainer CLI at bench
                  width (batch 256, block) for 3 steps with --n_data_shards 1
                  against the run without it, losses and checkpoint bit for
                  bit; the Wan Phase-1 trainer with --ffn_mode moe --n_experts 8
                  --lora_rank 0 --bf16 1 at full width (batch 2, L 7800, sla):
                  at 2 of 30 layers the loss and every weight's gradient of the
                  kernel path vs the twin path (SLA LUTs and expert routes
                  replayed), then its CLI at 8 of 30 layers (what fits one
                  card: 3.83 GB of f32 state a block) for 3 steps with
                  --ckpt_async 1 (launches of rows 4-8 per step, s/step, peak
                  memory, the sharded checkpoint read back equal). (b) Two
                  processes on the one card over gloo (NCCL refuses two ranks
                  on one GPU; CUDA compute, hops staged through host memory,
                  so their times show that the path runs, not its speed):
                  ring-SLA at BH 12, L 32768, Dh 128, top-k 0.1, blocks 128
                  and 256 (row-4 launches, hops x ranks; each rank's output vs
                  one process's block_sparse_attention on the full sequence
                  with the same global LUT) and the kernel's all-sentinel lse;
                  dense ring attention, causal and not, vs plain attention;
                  the causal CLI with --seq_shard 2 vs --seq_shard 0 at bench
                  width (64 x 1, chunk 16, DDIM-10, block)
Every timing phase also times the one PyTorch library call that computes the
same function, where there is one (scaled_dot_product_attention, for SLA
under the LUT as a mask; F.linear; or for the block a chain of them), as a
yardstick that the port never calls.
--profile adds torch.profiler tables of one maze pipeline call (policy block,
B=1024), one maze Stage-2 training step, one sla-mode sampler call and one
sla-mode Wan training step, and of one sla-mode Wan Phase-2 training step
with the device's busy share. The line before the
last is a JSON summary of the kernels (time, bound, library time, launches);
the last line is {"ok": true, "device": {...}}. --kernels runs only the phases
that build, check and time the kernels alone (1-3, the kernel times of 5, 5a,
6, the kernel times of 8, and 9), drives no model and prints neither of the two JSON lines: a short
first run for a changed kernel. --gemm-ab reads what the block GEMM's
W-resident kernel buys: the maze part of phases 3 and 5 (--maze-kernels) in four
processes, two on a build that sends every product to the streaming kernel.
--wan-phase2 runs the build and phase 5f alone and prints neither JSON line,
--wan-interp the build and phase 5g alone. --video-toy runs the build and
phase 5h alone, then a JSON line of its launches and times and the
{"ok": true, ...} line; --multi-device the build, phase 3 and phase 5i, then
its JSON line of launches and the ok line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of a kernel against its plain twin on the same bf16 inputs, as
# max|kernel - twin| / max|twin|. Both compute the same f32 sums in another
# order, so a value just at a bf16 rounding boundary can round one way in one
# and the other way in the other: one bf16 ulp is 2^-8 = 3.9e-3 of the value.
ATTN_TOL = 1e-2    # output rounded once from f32 sums: within ~2 ulps of the max
BLOCK_TOL = 2e-2   # h, qkv, p, o, f each round to bf16 inside the block and a
                   # flipped ulp there moves y through the next product
# Pipeline, kernel path vs plain-twin path, max |delta| of positions in [0, 1]:
# 19 Stage-1 steps and 3 Stage-2 levels feed each model output back in, so
# per-block rounding differences compound; random weights make no attempt to
# be contractive.
PIPE_TOL = 5e-2

BENCH = dict(T=64, K=8, levels=3, K_min=8, ddim_steps=20, n_train=100,
             d_model=384, n_layers=12, n_heads=12, d_ff=1536, d_cond=128,
             maze_channels=(32, 64, 128, 128), grid=21, data_dim=2)
# Gradients of an autograd Function (kernel forward, twin-recompute backward)
# against the twin path, max|d| / max|twin| per input: both backwards
# differentiate the same twin from the same saved inputs, so they differ only
# where a test hands both the same upstream gradient (then not at all) or the
# forward outputs feed later layers.
GRAD_TOL = 2e-2
# Maze training step, kernel path vs plain-twin path from the same weights,
# batch and draws: relative difference of the loss, and max|d| / max|twin| of
# every leaf's gradient (12 bf16 layers, forward and backward, between a
# block's rounding differences and the leaf).
MAZE_LOSS_TOL, MAZE_GRAD_TOL = 1e-2, 5e-2
MAZE_TRAIN = (("stage2", "fused"), ("stage2", "block"), ("stage1", "block"))
MAZE_STEPS = (1, 8)        # (warm-up, timed) steps through the trainer's own step
MAZE_CLI_STEPS = (4, 6)    # CLI run: steps, then resumed to
MAZE_SAMPLES = 2048        # --num_samples of the procedural dataset

KERNEL_SOURCES = {
    "small_mha": ("interpolated_diffusion_tpu_torch/csrc/small_mha.cu",
                  "interpolated_diffusion_tpu/kernels/small_mha.py:54"),
    "fused_film_block": ("interpolated_diffusion_tpu_torch/csrc/fused_block.cu",
                         "interpolated_diffusion_tpu/kernels/fused_block.py:68"),
    "small_mha_packed": ("interpolated_diffusion_tpu_torch/csrc/small_mha.cu",
                         "interpolated_diffusion_tpu/kernels/small_mha.py:125"),
    "block_sparse_attention": ("interpolated_diffusion_tpu_torch/csrc/sla_fwd_sm90.cu",
                               "interpolated_diffusion_tpu/kernels/block_sparse_attention.py:46"),
    "int8_block_sparse_attention": ("interpolated_diffusion_tpu_torch/csrc/sla_fwd_sm90.cu",
                                    "interpolated_diffusion_tpu/kernels/int8_attention.py:48"),
    "flash_attention": ("interpolated_diffusion_tpu_torch/csrc/flash_fwd_sm90.cu",
                        "interpolated_diffusion_tpu/kernels/block_sparse_attention.py:174"),
    "sla_bwd_dq": ("interpolated_diffusion_tpu_torch/csrc/sla_bwd_sm90.cu",
                   "interpolated_diffusion_tpu/kernels/block_sparse_attention.py:438"),
    "sla_bwd_dkdv": ("interpolated_diffusion_tpu_torch/csrc/sla_bwd_sm90.cu",
                     "interpolated_diffusion_tpu/kernels/block_sparse_attention.py:473"),
    "flash_bwd_dq": ("interpolated_diffusion_tpu_torch/csrc/flash_bwd_sm90.cu",
                     "interpolated_diffusion_tpu/kernels/block_sparse_attention.py:214"),
    "flash_bwd_dkdv": ("interpolated_diffusion_tpu_torch/csrc/flash_bwd_sm90.cu",
                       "interpolated_diffusion_tpu/kernels/block_sparse_attention.py:248"),
}

# Times of the kernels that were redesigned (wgmma + TMA flash forward and
# backward, SLA forward and backward and block GEMM, register-resident
# small_mha kernels), as this script
# measured their first versions (mma.sync with a cp.async ring; WMMA with logits
# staged through shared memory) on an NVIDIA H100 80GB HBM3 at a 700 W limit, in
# ms. Printed on the [timing] lines beside the new times, so that one run shows
# before and after; the JSON summary holds only what this run measured.
BEFORE_REDESIGN_MS = {"flash_attention/cross": 0.737, "flash_attention/self": 8.974,
                      "small_mha/tiled": 0.2134,
                      # the WMMA GEMM chain and the shared-memory small_mha_kernel
                      "fused_film_block/1024,64": 1.936, "small_mha_packed/1024,64": 0.308,
                      "small_mha/256,64": 0.0901,
                      # the mma.sync flash backward, q [24,7800,128] x k 517 / 7800
                      "flash_bwd_dq/cross": 0.377, "flash_bwd_dkdv/cross": 0.544,
                      "flash_bwd_dq/self": 4.601, "flash_bwd_dkdv/self": 6.312,
                      # the mma.sync SLA and int8 SLA forward, [48,7800,128] block 128
                      "block_sparse_attention": 0.968, "int8_block_sparse_attention": 0.744,
                      # the mma.sync SLA backward, [24,7800,128] block 256 top-k 3
                      "sla_bwd_dq": 0.468, "sla_bwd_dkdv": 0.832}
# Flash backward cases beside the trainer's shapes, (BH, Lq, Lk, Dh): head
# dim 64, query lengths ragged against the 128-row blocks and 64-row tiles,
# key lengths ragged against both and one under a 64-key tile.
FLASH_BWD_EXTRA = ((24, 1000, 517, 64), (6, 129, 65, 128), (6, 300, 40, 64), (4, 333, 133, 128))

# Published dense peaks of one H100 SXM (NVIDIA's data sheet), for the bounds:
# the least time the card could take is the larger of operations over the peak
# rate of their type and bytes (each input read once, each output written
# once) over the memory rate.
PEAK_BF16, PEAK_INT8, PEAK_HBM = 989e12, 1979e12, 3.35e12


def bound_ms(bytes_moved, flops_bf16=0.0, ops_int8=0.0):
    """(bound in ms, "bytes" or "operations") of one call."""
    t_ops = flops_bf16 / PEAK_BF16 + ops_int8 / PEAK_INT8
    t_bytes = bytes_moved / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# Wan2.1-T2V-1.3B Phase-1 anchor sampling: the defaults of
# data/precompute_phase1_anchors.py (batch 4, ddim_steps 4, sla_block 128) and
# train/wansynth_common.py (model, LoRA, frame conditioning, latents).
WAN_SAMPLER_LAYERS = 6   # the sampler's depth here (full width); the trainer runs all 30
WAN = dict(wan_dim=1536, wan_layers=WAN_SAMPLER_LAYERS, wan_heads=12, wan_ffn=8960, latent_c=16,
           text_dim=4096, attn_mode="sla", sla_topk=0.1, sla_block=128, lora_rank=8,
           lora_alpha=16.0, lora_form="runtime", lora_targets="attn,ffn", ffn_mode="dense",
           frame_cond=1, frame_cond_dim=5)
WAN_ANCHORS = dict(T=21, K=5, latent_c=16, latent_h=60, latent_w=104, patch_size=2,
                   n_train=1000, schedule="linear", ddim_steps=4)
WAN_B, WAN_TEXT_LEN = 4, 512
WAN_33K = (12, 32760)    # (BH, L) of scripts/bench_wan33k.py, Dh 128
WAN_MODES = ("sla", "sage_sla", "flash")
WAN_KERNELS = ("block_sparse_attention", "int8_block_sparse_attention", "flash_attention")
# launches per sampler call: 3 evaluations x 6 layers, self- and cross-attention
_N = 3 * WAN_SAMPLER_LAYERS
WAN_EXPECT = {"sla": (_N, 0, _N), "sage_sla": (0, _N, _N), "flash": (0, 0, 2 * _N)}
INT8_VS_BF16_TOL = 0.08  # int8 SLA against the bf16 SLA twin (docs/kernels_tpu.json)
# Sampler, kernel path vs plain-twin path, max|d| / max|twin| of the anchors:
# the kernels round P to bf16 per 64-key tile, the twins per LUT block (or
# not at all); the difference (~1e-3 of an attention output) passes through
# the bf16 layers and 3 DDIM steps, the first of which scales eps by
# 1/sqrt(alpha_bar(999)) ~ 156 along with the anchors themselves.
WAN_TOL = 5e-2
# Backward kernels against their twins, max|d| / max|twin| of dq, dk, dv: bf16
# outputs of f32 sums over products of two factors (p or ds, and q / k / do)
# that were each rounded to bf16 from f32 sums taken in another order.
BWD_TOL = 2e-2
# Training step, kernel path vs plain-twin path from the same state, batch and
# draws: relative difference of the loss, and max|d| / max|twin| of every
# trainable leaf's gradient (30 bf16 layers, forward and backward, between the
# attention outputs and the leaf).
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-2, 5e-2
TRAIN_KERNELS = ("block_sparse_attention", "int8_block_sparse_attention", "flash_attention",
                 "sla_bwd_dq", "sla_bwd_dkdv", "flash_bwd_dq", "flash_bwd_dkdv")
TRAIN_LAYERS = 30
# Launches per training step with remat (every block's forward runs twice):
# per layer one self- and one cross-attention. sla: SLA forward 2, flash
# forward 2 (cross), each backward kernel 1. sage_sla: int8 forward 2, plus 1
# bf16 SLA forward inside the straight-through backward. dense: flash forward
# 4 (self and cross, twice), each flash backward kernel 2.
_L = TRAIN_LAYERS
TRAIN_EXPECT = {"sla": (2 * _L, 0, 2 * _L, _L, _L, _L, _L),
                "sage_sla": (_L, 2 * _L, 2 * _L, _L, _L, _L, _L),
                "dense": (0, 0, 4 * _L, 0, 0, 2 * _L, 2 * _L)}
TRAIN_STEPS = {"sla": (1, 3), "sage_sla": (1, 2), "dense": (1, 2)}   # (warm-up, timed)


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}", flush=True)
    return card


def phase_build():
    from interpolated_diffusion_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    took = time.perf_counter() - t0
    print(f"[build] {os.path.relpath(path, ROOT)} in {took:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)
    for line in _build.build_log.splitlines():
        # C7514 / C7512: ptxas serialised a wgmma chain (a wgmma under a
        # condition / too few registers for what is in flight)
        if any(word in line for word in ("registers", "spill", "error", "C7514", "C7512")):
            print(f"[build] {line.strip()}", flush=True)


def _block_inputs(B, L, D, H, F, film, gen, device):
    import torch

    def u(*shape, bound):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound

    bf = torch.bfloat16
    x = torch.randn((B, L, D), generator=gen, device=device).to(bf)
    gb = lambda: 0.1 * torch.randn((B, 2 * D), generator=gen, device=device)
    zeros = torch.zeros((B, 2 * D), device=device)
    ln = lambda mean: mean + 0.1 * torch.randn(D, generator=gen, device=device)
    args = (gb() if film else zeros, gb() if film else zeros, ln(1.0), ln(0.0), ln(1.0),
            ln(0.0), u(3 * D, D, bound=D ** -0.5), u(3 * D, bound=D ** -0.5),
            u(D, D, bound=D ** -0.5), u(D, bound=D ** -0.5),
            u(F, D, bound=D ** -0.5), u(F, bound=D ** -0.5),
            u(D, F, bound=F ** -0.5), u(D, bound=F ** -0.5))
    return x, tuple(a.to(bf) for a in args)


def _errors(out, ref):
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def _time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, launches=50):
    """Device time of one call: `launches` calls captured into a CUDA graph and
    replayed, so that the host's pace between launches does not count."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return _time_ms(graph.replay, iters=10) / launches


# The four products of the block, in chain order: (epilogue, N, K) as multiples
# of (D, F); at bench width (1152, 384), (384, 384), (1536, 384), (384, 1536).
def _gemm_shapes(D, F):
    return (("bias", 3 * D, D), ("resid_f32", D, D), ("bias_silu", F, D), ("resid_out", D, F))


def _gemm_inputs(M, N, K, epilogue, bias_dtype, gen, device):
    import torch

    bf = torch.bfloat16
    a = torch.randn((M, K), generator=gen, device=device).to(bf)
    w = ((torch.rand((N, K), generator=gen, device=device) * 2 - 1) * K ** -0.5).to(bf)
    # a bias at the products' own scale (a has unit variance and w's rows a
    # norm of ~0.58, so a @ w^T is ~0.58 an element): one that is dropped or
    # read from the wrong columns then costs far more than the tolerance
    bias = torch.randn(N, generator=gen, device=device).to(bias_dtype)
    resid = None
    if epilogue.startswith("resid"):
        resid = torch.randn((M, N), generator=gen, device=device)
        resid = resid.to(bf) if epilogue == "resid_f32" else resid
    return a, w, bias, resid


def _library_block(x, args, n_heads, film):
    """The block as PyTorch's own calls compute it (F.linear x 4,
    scaled_dot_product_attention, layer_norm, FiLM, SiLU; bf16 with the f32
    residual stream): the yardstick beside fused_film_block. Nothing on a
    kernel path calls it."""
    import torch
    import torch.nn.functional as Fn

    gb1, gb2, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wout, bout, wff1, bff1, wff2, bff2 = args
    B, L, D = x.shape
    bf = x.dtype

    def ln_film(t, scale, bias, gb):
        h = Fn.layer_norm(t.float(), (D,), scale.float(), bias.float(), 1e-6).to(bf)
        return h * (1.0 + gb[:, None, :D]) + gb[:, None, D:] if film else h

    heads = lambda t: t.reshape(B, L, n_heads, D // n_heads).transpose(1, 2)
    q, k, v = Fn.linear(ln_film(x, ln1s, ln1b, gb1), wqkv, bqkv).split(D, dim=-1)
    o = Fn.scaled_dot_product_attention(heads(q), heads(k), heads(v))
    x2 = x.float() + Fn.linear(o.transpose(1, 2).reshape(B, L, D), wout, bout)
    f = Fn.silu(Fn.linear(ln_film(x2, ln2s, ln2b, gb2), wff1, bff1))
    return (x2 + Fn.linear(f, wff2, bff2)).to(bf)


def phase_kernels(dev):
    """Each kernel against its plain twin at the main path's shapes."""
    import torch
    from interpolated_diffusion_tpu_torch.kernels.fused_block import (_torch_block, _torch_gemm,
                                                                     fused_film_block,
                                                                     gemm_bias_act)
    from interpolated_diffusion_tpu_torch.kernels.small_mha import (_torch_attention, small_mha,
                                                                   small_mha_packed)
    from interpolated_diffusion_tpu_torch.models.transformer import fused_group_b

    gen = torch.Generator(device=dev).manual_seed(0)
    D, H, F = BENCH["d_model"], BENCH["n_heads"], BENCH["d_ff"]
    results = {"fused_film_block": [], "small_mha_packed": [], "gemm": []}
    with torch.inference_mode():
        # the GEMM alone: the path's four products at Stage 2's and Stage 1's
        # row counts (B = 1024, L = 64 and 8), at M = 8, at an M that is no
        # multiple of the tile, and at a width (320 / 1280) whose products run
        # the 128- and 64-column instantiations
        gemm_cases = [(M, D, F) for M in (1024 * 64, 1024 * 8, 8, 37 * 64)] + [(37 * 64, 320, 1280)]
        for M, d, f in gemm_cases:
            for epilogue, N, K in _gemm_shapes(d, f):
                bias_dtype = torch.float32 if M in (1024 * 64, 8) else torch.bfloat16
                a, w, bias, resid = _gemm_inputs(M, N, K, epilogue, bias_dtype, gen, dev)
                out = gemm_bias_act(a, w, bias, epilogue, resid)
                ref = _torch_gemm(a, w, bias, epilogue, resid)
                torch.cuda.synchronize()
                require(out.shape == ref.shape and out.dtype == ref.dtype,
                        f"gemm_bias_act {epilogue}: {out.shape} {out.dtype}")
                require(bool(torch.isfinite(out).all()), f"gemm_bias_act {epilogue}: non-finite")
                err, rel = _errors(out, ref)
                print(f"[kernels] gemm_bias_act {epilogue} M={M} N={N} K={K} bias "
                      f"{str(bias_dtype).split('.')[-1]}: max|d|={err:.3e} "
                      f"max|d|/max|plain|={rel:.3e} (tol {BLOCK_TOL})", flush=True)
                require(rel <= BLOCK_TOL, f"gemm_bias_act {epilogue} M={M} N={N} K={K} "
                                          f"disagrees: {rel:.3e}")
                if d == D and M >= 1024 * 8:
                    results["gemm"].append(((M, N, K, epilogue), err, a, w, bias, resid))
        # (1024, 4) and (37, 3): the causal sampler's per-chunk Stage 1 (K_local
        # 4 at its CLI defaults, 3 at a chunk of K_min 3), odd and tiny L
        for B, L, film in ((1024, 8, True), (1024, 64, True), (1, 8, True), (37, 64, True),
                           (37, 8, False), (1024, 4, True), (37, 3, True)):
            x, args = _block_inputs(B, L, D, H, F, film, gen, dev)
            out = fused_film_block(x, *args, n_heads=H, group_b=fused_group_b(L),
                                   use_film=film)
            ref = _torch_block(x, *args, n_heads=H, use_film=film)
            torch.cuda.synchronize()
            require(out.shape == ref.shape and out.dtype == torch.bfloat16,
                    f"fused_film_block shape/dtype {out.shape} {out.dtype}")
            require(bool(torch.isfinite(out).all()), "fused_film_block: non-finite output")
            err, rel = _errors(out, ref)
            print(f"[kernels] fused_film_block B={B} L={L} D={D} H={H} F={F} film={film}: "
                  f"max|d|={err:.3e} max|d|/max|plain|={rel:.3e} (tol {BLOCK_TOL})",
                  flush=True)
            require(rel <= BLOCK_TOL, f"fused_film_block B={B} L={L} disagrees: {rel:.3e}")
            if B == 1024:
                lib = _library_block(x, args, H, film)
                print(f"[kernels] fused_film_block B={B} L={L}: the library chain (the "
                      f"yardstick) differs from the twin by "
                      f"{_errors(lib, ref)[1]:.3e} of max|plain|", flush=True)
            results["fused_film_block"].append(((B, L, film), err, x, args))
        for B, L in ((1024, 64), (1024, 8)):
            qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = qkv.split(D, dim=-1)   # strided views, as the model passes them
            out = small_mha_packed(q, k, v, H, max(1, 512 // L))
            ref = _torch_attention(q, k, v, H)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(out).all()), "small_mha_packed: non-finite output")
            err, rel = _errors(out, ref)
            print(f"[kernels] small_mha_packed [{B},{L},{D}] H={H}: max|d|={err:.3e} "
                  f"max|d|/max|plain|={rel:.3e} (tol {ATTN_TOL})", flush=True)
            require(rel <= ATTN_TOL, f"small_mha_packed B={B} L={L} disagrees: {rel:.3e}")
            results["small_mha_packed"].append(((B, L), err, q, k, v))
        # small_mha_kernel over its window: every strip length, a single row,
        # ragged lengths, both head dims, and head counts that leave the last
        # group of heads short (5 heads of 32, 3 of 64)
        worst = 0.0
        for L in (1, 8, 17, 64, 200, 256):
            for dh, heads in ((32, 12), (64, 6), (32, 5), (64, 3)):
                for entry in (small_mha_packed, small_mha):
                    h = heads if entry is small_mha_packed else min(heads, 1024 // L)
                    qkv = torch.randn((67, L, 3 * h * dh), generator=gen,
                                      device=dev).to(torch.bfloat16)
                    q, k, v = qkv.split(h * dh, dim=-1)
                    out, ref = entry(q, k, v, h), _torch_attention(q, k, v, h)
                    torch.cuda.synchronize()
                    rel = _errors(out, ref)[1]
                    require(bool(torch.isfinite(out).all()) and rel <= ATTN_TOL,
                            f"{entry.__name__} [67,{L},{h * dh}] H={h} disagrees: {rel:.3e}")
                    worst = max(worst, rel)
        print(f"[kernels] small_mha_packed / small_mha at L in (1, 8, 17, 64, 200, 256), head "
              f"dims 32 and 64, whole and short head groups: worst max|d|/max|plain|="
              f"{worst:.3e} (tol {ATTN_TOL})", flush=True)
    return results


@contextlib.contextmanager
def plain_twins():
    """Route the model's kernel calls to the plain twins (on CUDA tensors):
    the twin as forward, and under autograd the same twin-recompute backward."""
    from interpolated_diffusion_tpu_torch.kernels import fused_block, small_mha
    from interpolated_diffusion_tpu_torch.models import transformer

    saved = transformer.fused_film_block, transformer.small_mha_packed, transformer.small_mha
    transformer.fused_film_block = fused_block.fused_film_block_twin
    transformer.small_mha_packed = small_mha.small_mha_packed_twin
    transformer.small_mha = small_mha.small_mha_twin
    try:
        yield
    finally:
        (transformer.fused_film_block, transformer.small_mha_packed,
         transformer.small_mha) = saved


@contextlib.contextmanager
def count_maze_twin_calls():
    """Count calls of the maze kernels' plain twins: {"forward": n,
    "backward": n}. The autograd Functions recompute the twin in backward by
    design; a twin call in forward on a kernel path is a fault."""
    from interpolated_diffusion_tpu_torch.kernels import fused_block, small_mha

    calls = {"total": 0, "backward": 0}
    targets = [(fused_block, "_torch_block", "total"), (small_mha, "_torch_attention", "total"),
               (fused_block, "backward_twin", "backward"), (small_mha, "backward_twin", "backward")]
    originals = [getattr(m, n) for m, n, _ in targets]

    def counting(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    for (m, n, key), fn in zip(targets, originals):
        setattr(m, n, counting(fn, key))
    try:
        yield calls
    finally:
        for (m, n, _), fn in zip(targets, originals):
            setattr(m, n, fn)
        calls["forward"] = calls["total"] - calls["backward"]


def _maze_counts():
    from interpolated_diffusion_tpu_torch.kernels.fused_block import fused_film_block
    from interpolated_diffusion_tpu_torch.kernels.small_mha import small_mha, small_mha_packed

    return {"fused_film_block": fused_film_block.launches,
            "small_mha_packed": small_mha_packed.launches, "small_mha": small_mha.launches}


def _set_maze_counts(values):
    from interpolated_diffusion_tpu_torch.kernels.fused_block import fused_film_block
    from interpolated_diffusion_tpu_torch.kernels.small_mha import small_mha, small_mha_packed

    fused_film_block.launches = values["fused_film_block"]
    small_mha_packed.launches = values["small_mha_packed"]
    small_mha.launches = values["small_mha"]


def _requests(B, gen_cpu, device):
    import torch

    T, K, G = BENCH["T"], BENCH["K"], BENCH["grid"]
    interior = torch.stack([torch.randperm(T - 2, generator=gen_cpu)[:K - 2] + 1
                            for _ in range(B)])
    idx = torch.cat([torch.zeros((B, 1), dtype=torch.long), interior,
                     torch.full((B, 1), T - 1, dtype=torch.long)], dim=1)
    idx = torch.sort(idx, dim=1).values
    cond = {"occ": (torch.rand((B, 1, G, G), generator=gen_cpu) < 0.2).float(),
            "start_goal": torch.rand((B, 4), generator=gen_cpu)}
    return idx.to(device), {k: v.to(device) for k, v in cond.items()}


def _build_models(device):
    import torch
    from interpolated_diffusion_tpu_torch.models.denoisers import InterpLevelDenoiser, KeypointDenoiser
    from interpolated_diffusion_tpu_torch.models.init import build_model

    w = {k: BENCH[k] for k in ("d_model", "n_layers", "n_heads", "d_ff", "d_cond",
                               "maze_channels", "data_dim")}
    kp = build_model(KeypointDenoiser, generator=torch.Generator().manual_seed(1),
                     device=device, dtype=torch.bfloat16, **w)
    it = build_model(InterpLevelDenoiser, generator=torch.Generator().manual_seed(2),
                     device=device, dtype=torch.bfloat16, mask_channels=2, **w)
    _nonzero_head(it)   # the zero-init Stage-2 head would make Stage 2 the identity
    return kp.eval(), it.eval()


def _check_outputs(B, idx, cond, out):
    import torch

    T, K, Dd = BENCH["T"], BENCH["K"], BENCH["data_dim"]
    x_interp, x_ref, z_pred = out
    require(tuple(x_interp.shape) == (B, T, Dd) and tuple(x_ref.shape) == (B, T, Dd)
            and tuple(z_pred.shape) == (B, K, Dd), f"B={B}: bad output shapes")
    require(all(t.device.type == "cuda" for t in out), f"B={B}: outputs not on cuda")
    require(all(bool(torch.isfinite(t).all()) for t in out), f"B={B}: non-finite output")
    anchors = torch.gather(x_interp, 1, idx[..., None].expand(B, K, Dd))
    require(torch.equal(anchors, z_pred), f"B={B}: anchors not preserved in x_interp")
    sg = cond["start_goal"]
    require(torch.equal(x_ref[:, 0, :2], sg[:, :2]) and torch.equal(x_ref[:, -1, :2], sg[:, 2:]),
            f"B={B}: endpoints differ from start/goal")
    for name, t in (("x_interp", x_interp), ("x_refined", x_ref)):
        require(bool(((t[..., :2] >= 0) & (t[..., :2] <= 1)).all()),
                f"B={B}: {name} positions outside [0, 1]")


def phase_main(dev):
    import torch
    from interpolated_diffusion_tpu_torch.kernels.fused_block import fused_film_block
    from interpolated_diffusion_tpu_torch.kernels.small_mha import small_mha_packed
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample.generate import PipelineConfig, make_pipeline

    kp, it = _build_models(dev)
    cfg = PipelineConfig(T=BENCH["T"], K=BENCH["K"], levels=BENCH["levels"],
                         K_min=BENCH["K_min"], ddim_steps=BENCH["ddim_steps"],
                         stage2_mode="adj", clamp_policy="endpoints", pos_clip=True)
    pipe = make_pipeline(kp, it, make_schedule("linear", BENCH["n_train"], device=dev), cfg,
                         BENCH["data_dim"])
    n_evals = len(range(BENCH["ddim_steps"] - 1))
    per_block_call = (n_evals + BENCH["levels"]) * BENCH["n_layers"]     # 264
    per_fused_call = BENCH["levels"] * BENCH["n_layers"]                 # 36: Stage 2 only
    # a block-policy call by sequence length: Stage 2's levels at T, Stage 1's
    # evaluations at K
    per_block_by_len = {BENCH["T"]: per_fused_call, BENCH["K"]: n_evals * BENCH["n_layers"]}
    gen_cpu = torch.Generator().manual_seed(4)
    plan = [("block", 1), ("block", 64), ("block", 1024), ("fused", 64)]
    reqs = {(p, B): _requests(B, gen_cpu, dev) for p, B in plan}

    fused_film_block.launches = small_mha_packed.launches = 0
    by_len = fused_film_block.launches_by_len
    by_len.clear()
    outs = {}
    for policy, B in plan:
        kp.set_attn_policy(policy)
        it.set_attn_policy(policy)
        before = (fused_film_block.launches, small_mha_packed.launches)
        before_len = dict(by_len)
        idx, cond = reqs[(policy, B)]
        t0 = time.perf_counter()
        out = pipe(idx, cond, generator=torch.Generator(device=dev).manual_seed(B))
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        d_blk = fused_film_block.launches - before[0]
        d_mha = small_mha_packed.launches - before[1]
        _check_outputs(B, idx, cond, out)
        want = (per_block_call, 0) if policy == "block" else (0, per_fused_call)
        require((d_blk, d_mha) == want,
                f"{policy} B={B}: launches fused_film_block={d_blk} small_mha_packed={d_mha}, "
                f"expected {want}")
        d_len = {L: n - before_len.get(L, 0) for L, n in by_len.items() if n > before_len.get(L, 0)}
        want_len = per_block_by_len if policy == "block" else {}
        require(d_len == want_len, f"{policy} B={B}: fused_film_block launches by sequence "
                                   f"length {d_len}, expected {want_len}")
        print(f"[main] policy={policy} B={B}: {took:.3f} s (first call includes warm-up), "
              f"launches fused_film_block +{d_blk} (by sequence length {d_len}) "
              f"small_mha_packed +{d_mha}; "
              f"shapes {tuple(out[0].shape)} {tuple(out[1].shape)} {tuple(out[2].shape)}; "
              f"anchors, endpoints, [0,1] ok", flush=True)
        outs[(policy, B)] = out
    launches = {"fused_film_block": fused_film_block.launches,
                "small_mha_packed": small_mha_packed.launches,
                # the block's launches of this run as the wrapper counted them by shape
                "fused_film_block/by_shape": {f"[B,{L},{BENCH['d_model']}]": n
                                              for L, n in sorted(by_len.items(), reverse=True)}}
    print(f"[main] launches in the main-path run: {launches}", flush=True)

    # kernel path vs plain-twin path, same inputs and draws
    for policy, B in (("block", 64), ("fused", 64)):
        kp.set_attn_policy(policy)
        it.set_attn_policy(policy)
        idx, cond = reqs[(policy, B)]
        with plain_twins():
            ref = pipe(idx, cond, generator=torch.Generator(device=dev).manual_seed(B))
        for name, a, b in zip(("x_interp", "x_refined", "z_pred"), outs[(policy, B)], ref):
            err = (a - b).abs().max().item()
            print(f"[main] policy={policy} B={B} kernels vs plain twins: {name} "
                  f"max|d|={err:.3e} (tol {PIPE_TOL})", flush=True)
            require(err <= PIPE_TOL, f"{policy} B={B}: {name} kernel path disagrees ({err:.3e})")
    return kp, it, pipe, launches


def phase_timings(dev, card, kernel_cases):
    """The maze kernels alone: CUDA-event times beside the plain twins', the
    library's and the bounds; short kernels also by CUDA-graph replay."""
    import torch
    import torch.nn.functional as Fn
    from interpolated_diffusion_tpu_torch.kernels.fused_block import (_torch_block, _torch_gemm,
                                                                     fused_film_block,
                                                                     gemm_bias_act)
    from interpolated_diffusion_tpu_torch.kernels.small_mha import _torch_attention, small_mha_packed

    D, H = BENCH["d_model"], BENCH["n_heads"]
    tag = f"[{card}]"
    times = {"gemm": []}
    with torch.inference_mode():
        saved = fused_film_block.launches, small_mha_packed.launches, gemm_bias_act.launches
        # the four products alone, against F.linear on the same bf16 operands
        # (the library without bias or epilogue); at 8192 rows a launch is
        # shorter than the host's pace, so the device time by graph replay too
        for (M, N, K, epilogue), _, a, w, bias, resid in kernel_cases["gemm"]:
            k_ms = _time_ms(lambda: gemm_bias_act(a, w, bias, epilogue, resid))
            lib_ms = _time_ms(lambda: Fn.linear(a, w))
            p_ms = _time_ms(lambda: _torch_gemm(a, w, bias, epilogue, resid), iters=5)
            out_bytes = M * N * (4 if epilogue == "resid_f32" else 2)
            resid_bytes = 0 if resid is None else resid.numel() * resid.element_size()
            bound = bound_ms(2 * (M * K + N * K) + bias.numel() * bias.element_size()
                             + out_bytes + resid_bytes, 2.0 * M * N * K)
            entry = {"M": M, "N": N, "K": K, "epilogue": epilogue, "ms": k_ms,
                     "tflops": 2.0 * M * N * K / k_ms / 1e9, "plain_ms": p_ms,
                     "library_ms": lib_ms, "bound_ms": bound[0], "bound_by": bound[1]}
            line = (f"[timing] {tag} gemm_bias_act {epilogue} M={M} N={N} K={K}: kernel "
                    f"{k_ms:.4f} ms ({entry['tflops']:.0f} TFLOP/s), bound {bound[0]:.4f} ms "
                    f"({bound[1]}), plain twin {p_ms:.4f} ms, library (F.linear) {lib_ms:.4f} ms")
            if M < 65536:
                entry["device_ms"] = _graph_ms(lambda: gemm_bias_act(a, w, bias, epilogue, resid))
                entry["library_device_ms"] = _graph_ms(lambda: Fn.linear(a, w))
                line += (f"; device time by graph replay {entry['device_ms']:.4f} ms, library "
                         f"{entry['library_device_ms']:.4f} ms")
            print(line, flush=True)
            times["gemm"].append(entry)
        for (B, L, film), _, x, args in kernel_cases["fused_film_block"]:
            k_ms = _time_ms(lambda: fused_film_block(x, *args, n_heads=H, use_film=film))
            p_ms = _time_ms(lambda: _torch_block(x, *args, n_heads=H, use_film=film))
            lib_ms = _time_ms(lambda: _library_block(x, args, H, film))
            line = (f"[timing] {tag} fused_film_block [{B},{L},{D}] film={film}: "
                    f"kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms, library chain (F.linear x 4, "
                    f"scaled_dot_product_attention, layer_norm, silu) {lib_ms:.4f} ms")
            before = BEFORE_REDESIGN_MS.get(f"fused_film_block/{B},{L}")
            if before:
                line += f"; before the redesign {before:.4f} ms"
            print(line, flush=True)
            times[("fused_film_block", B, L)] = (k_ms, p_ms, lib_ms)
        # Small batches are paced by the host: a call's time here is the
        # wrapper's and the C entry's host work (checks, scratch, eight tensor
        # maps, seven launches). f32 master matrices add four casts a call.
        gen = torch.Generator(device=dev).manual_seed(7)
        for B in (1, 64):
            x, args = _block_inputs(B, 8, D, H, BENCH["d_ff"], True, gen, dev)
            masters = tuple(a if i < 2 else a.float() for i, a in enumerate(args))
            bf_ms = _time_ms(lambda: fused_film_block(x, *args, n_heads=H), iters=100)
            f32_ms = _time_ms(lambda: fused_film_block(x, *masters, n_heads=H), iters=100)
            print(f"[timing] {tag} fused_film_block [{B},8,{D}] (host-paced): bf16 parameters "
                  f"{bf_ms:.4f} ms a call, f32 masters (four casts a call) {f32_ms:.4f} ms",
                  flush=True)
            times[("fused_film_block/host", B)] = (bf_ms, f32_ms)
        for (B, L), _, q, k, v in kernel_cases["small_mha_packed"]:
            k_ms = _time_ms(lambda: small_mha_packed(q, k, v, H))
            p_ms = _time_ms(lambda: _torch_attention(q, k, v, H))
            heads = lambda t: t.reshape(B, L, H, D // H).transpose(1, 2)
            lib = lambda: Fn.scaled_dot_product_attention(heads(q), heads(k), heads(v))
            lib_ms = _time_ms(lib)
            g_ms, g_lib = _graph_ms(lambda: small_mha_packed(q, k, v, H)), _graph_ms(lib)
            line = (f"[timing] {tag} small_mha_packed [{B},{L},{D}]: kernel {k_ms:.4f} ms, "
                    f"plain twin {p_ms:.4f} ms, library (scaled_dot_product_attention) "
                    f"{lib_ms:.4f} ms; device time by graph replay {g_ms:.4f} ms, library "
                    f"{g_lib:.4f} ms")
            before = BEFORE_REDESIGN_MS.get(f"small_mha_packed/{B},{L}")
            if before:
                line += f"; before the redesign {before:.4f} ms (event loop)"
            print(line, flush=True)
            times[("small_mha_packed", B, L)] = (k_ms, p_ms, lib_ms)
            times[("small_mha_packed/graph", B, L)] = (g_ms, g_lib)
        (fused_film_block.launches, small_mha_packed.launches,
         gemm_bias_act.launches) = saved
    return times


def phase_pipeline_timings(dev, card, pipe, kp, it, profile):
    """Pipeline samples/s and ms per request: the end-to-end reading."""
    import torch

    tag = f"[{card}]"
    if profile:   # where one block-policy call at B=1024 spends its device time
        from torch.profiler import ProfilerActivity, profile as torch_profile

        kp.set_attn_policy("block")
        it.set_attn_policy("block")
        pidx, pcond = _requests(1024, torch.Generator().manual_seed(5), dev)
        pipe(pidx, pcond, generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe(pidx, pcond, generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
        what = "one maze pipeline call (policy block, B=1024)"
        _print_profile(prof, tag, what)
        for family in ("gemm_resident_kernel", "gemm_stream_kernel", "small_mha_kernel",
                       "ln_film_kernel"):
            ms = sum(_device_us(evt) for evt in prof.key_averages() if family in evt.key) / 1e3
            print(f"[profile] {tag} {what}: {family}: {ms:.1f} ms", flush=True)
    # pipeline samples/s at B=1024, kernel path vs plain-twin path, timed in
    # the order kernels, twins, twins, kernels so that clock drift cancels
    B, iters = 1024, 5
    idx, cond = _requests(B, torch.Generator().manual_seed(5), dev)

    def run(path):
        ctx = plain_twins() if path == "plain twins" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                pipe(idx, cond, generator=torch.Generator(device=dev).manual_seed(i))
            torch.cuda.synchronize()
            return B * iters / (time.perf_counter() - t0)

    for policy in ("block", "fused"):
        kp.set_attn_policy(policy)
        it.set_attn_policy(policy)
        for small in (1, 64):   # per-request latency of small batches, kernel path
            sidx, scond = _requests(small, torch.Generator().manual_seed(6), dev)
            pipe(sidx, scond, generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                pipe(sidx, scond, generator=torch.Generator(device=dev).manual_seed(i))
                torch.cuda.synchronize()
            print(f"[timing] {tag} pipeline B={small} policy={policy} kernels: "
                  f"{(time.perf_counter() - t0) / iters * 1e3:.1f} ms per request", flush=True)
        for path in ("kernels", "plain twins"):   # warm-up
            with plain_twins() if path == "plain twins" else contextlib.nullcontext():
                pipe(idx, cond, generator=torch.Generator(device=dev).manual_seed(0))
        runs = {"kernels": [], "plain twins": []}
        for path in ("kernels", "plain twins", "plain twins", "kernels"):
            runs[path].append(run(path))
        for path, vals in runs.items():
            print(f"[timing] {tag} pipeline B={B} policy={policy} {path}: "
                  f"{sum(vals) / len(vals):.1f} samples/s (runs of {iters} calls: "
                  f"{', '.join(f'{v:.1f}' for v in vals)})", flush=True)


def _grad_check(name, label, kernel_fn, twin_fn, inputs, cot, out_tol, errs):
    """One autograd Function: kernel path vs twin path, output and the
    gradient of every input that takes one."""
    import torch

    results = []
    for fn in (kernel_fn, twin_fn):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, cot, allow_unused=True)
        results.append((out.detach(), grads, leaves))
    torch.cuda.synchronize()
    (out_k, grads_k, leaves), (out_t, grads_t, _) = results
    err, rel = _errors(out_k, out_t)
    require(rel <= out_tol, f"{name} {label}: output disagrees with the twin path ({rel:.3e})")
    errs[name] = max(errs.get(name, 0.0), err)
    worst = 0.0
    for i, (gk, gt, leaf) in enumerate(zip(grads_k, grads_t, leaves)):
        require((gk is None) == (gt is None), f"{name} {label}: gradient {i} present on one path")
        if gk is None:
            continue
        require(gk.dtype == leaf.dtype and gk.shape == leaf.shape
                and bool(torch.isfinite(gk).all()),
                f"{name} {label}: gradient {i} is {gk.dtype} {tuple(gk.shape)} or not finite")
        worst = max(worst, _errors(gk, gt)[1])
    print(f"[maze grads] {name} {label}: output max|d|/max|twin|={rel:.3e} (tol {out_tol}), "
          f"worst input gradient max|d|/max|twin|={worst:.3e} (tol {GRAD_TOL})", flush=True)
    require(worst <= GRAD_TOL, f"{name} {label}: a gradient disagrees ({worst:.3e})")


def phase_maze_autograd(dev, card):
    """small_mha against its twin, its time beside its bound, the twin's and
    the library's; then the three Functions under autograd."""
    import torch
    from interpolated_diffusion_tpu_torch.kernels import fused_block as fb
    from interpolated_diffusion_tpu_torch.kernels import small_mha as sm

    gen = torch.Generator(device=dev).manual_seed(30)
    D, H, F = BENCH["d_model"], BENCH["n_heads"], BENCH["d_ff"]
    tag = f"[{card}]"
    saved = _maze_counts()
    errs, times = {}, {}
    with torch.inference_mode():
        for B, L, dm, h in ((256, 64, D, H), (64, 512, 128, 2), (16, 1024, 64, 1), (8, 300, 64, 2)):
            qkv = torch.randn((B, L, 3 * dm), generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = qkv.split(dm, dim=-1)   # strided views, as the block passes them
            out, ref = sm.small_mha(q, k, v, h), sm._torch_attention(q, k, v, h)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(out).all()), "small_mha: non-finite output")
            err, rel = _errors(out, ref)
            print(f"[maze grads] small_mha [{B},{L},{dm}] H={h}: max|d|={err:.3e} "
                  f"max|d|/max|plain|={rel:.3e} (tol {ATTN_TOL})", flush=True)
            require(rel <= ATTN_TOL, f"small_mha [{B},{L},{dm}] disagrees: {rel:.3e}")
            errs["small_mha"] = max(errs.get("small_mha", 0.0), err)
            k_ms = _time_ms(lambda: sm.small_mha(q, k, v, h))
            p_ms = _time_ms(lambda: sm._torch_attention(q, k, v, h))
            heads = lambda t: t.reshape(B, L, h, dm // h).transpose(1, 2)
            lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                heads(q), heads(k), heads(v)))
            bound = bound_ms(2 * 4 * B * L * dm, 4.0 * B * L * L * dm)
            print(f"[timing] {tag} small_mha [{B},{L},{dm}] H={h}: kernel {k_ms:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]}), plain twin {p_ms:.4f} ms, library "
                  f"(scaled_dot_product_attention) {lib_ms:.4f} ms", flush=True)
            times[(B, L)] = (k_ms, p_ms, lib_ms, bound)
            if (B, L) == (64, 512):   # the tiled kernel's shape of record
                g_ms = _graph_ms(lambda: sm.small_mha(q, k, v, h))
                g_lib = _graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v)))
                print(f"[timing] {tag} small_mha [{B},{L},{dm}] H={h} (tiled): device time by graph "
                      f"replay {g_ms:.4f} ms, library {g_lib:.4f} ms; before the redesign "
                      f"{BEFORE_REDESIGN_MS['small_mha/tiled']:.4f} ms (event loop)", flush=True)
                times["tiled_graph"] = (g_ms, g_lib)
            if (B, L) == (256, 64):   # small_mha_kernel at the Stage-2 trainer's shape
                g_ms = _graph_ms(lambda: sm.small_mha(q, k, v, h))
                g_lib = _graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v)))
                print(f"[timing] {tag} small_mha [{B},{L},{dm}] H={h}: device time by graph "
                      f"replay {g_ms:.4f} ms, library {g_lib:.4f} ms; before the redesign "
                      f"{BEFORE_REDESIGN_MS['small_mha/256,64']:.4f} ms (event loop)", flush=True)
                times["small_graph"] = (g_ms, g_lib)

    for B, L in ((256, 64), (256, 8)):
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(torch.bfloat16)
        cot = torch.randn((B, L, D), generator=gen, device=dev).to(torch.bfloat16)
        for name in ("small_mha", "small_mha_packed"):
            _grad_check(name, f"[{B},{L},{D}] H={H}",
                        lambda t, f=getattr(sm, name): f(*t.split(D, dim=-1), H),
                        lambda t, f=getattr(sm, name + "_twin"): f(*t.split(D, dim=-1), H),
                        [qkv], cot, ATTN_TOL, errs)
        x, args = _block_inputs(B, L, D, H, F, True, gen, dev)
        # f32 master parameters, bf16 x and FiLM rows: the trainers' types
        masters = tuple(a if i < 2 else a.float() for i, a in enumerate(args))
        _grad_check("fused_film_block", f"[{B},{L},{D}] f32 masters",
                    lambda *t: fb.fused_film_block(*t, n_heads=H),
                    lambda *t: fb.fused_film_block_twin(*t, n_heads=H),
                    [x, *masters], cot, BLOCK_TOL, errs)
    # a tiled-kernel case under autograd
    qkv = torch.randn((64, 512, 3 * 128), generator=gen, device=dev).to(torch.bfloat16)
    cot = torch.randn((64, 512, 128), generator=gen, device=dev).to(torch.bfloat16)
    _grad_check("small_mha", "[64,512,128] H=2 (tiled)",
                lambda t: sm.small_mha(*t.split(128, dim=-1), 2),
                lambda t: sm.small_mha_twin(*t.split(128, dim=-1), 2), [qkv], cot, ATTN_TOL, errs)
    _set_maze_counts(saved)
    return errs, times


def _maze_trainer(stage):
    from interpolated_diffusion_tpu_torch.train import train_interp_levels, train_keypoints

    return train_keypoints if stage == "stage1" else train_interp_levels


def _nonzero_head(model):
    """Stage 2's zero-initialised head would give every other leaf a zero
    gradient on the first steps: small seeded values instead."""
    import torch

    if getattr(model.out, "zero_init", False):
        with torch.no_grad():
            g = torch.Generator().manual_seed(3)
            for p in (model.out.weight, model.out.bias):
                p.copy_(((torch.rand(p.shape, generator=g) * 2 - 1) * 1e-2).to(p.device))


def phase_maze_train(dev, card, profile, workdir):
    """The two maze trainers at their defaults; see the module docstring. The
    CLI runs write their checkpoints under `workdir` (phase 5c samples them)."""
    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.models import transformer
    from interpolated_diffusion_tpu_torch.models.init import init_parameters
    from interpolated_diffusion_tpu_torch.models.loading import (load_interp_model,
                                                                  load_keypoint_model)
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample.generate import PipelineConfig, make_pipeline
    from interpolated_diffusion_tpu_torch.train.common import (make_dataset, make_loader,
                                                               to_device)

    tag = f"[{card}]"
    n_layers = BENCH["n_layers"]
    launches = dict.fromkeys(("fused_film_block", "small_mha_packed", "small_mha"), 0)
    results = {}
    for stage, policy in MAZE_TRAIN:
        trainer = _maze_trainer(stage)
        args = trainer.build_argparser().parse_args(
            ["--num_samples", str(MAZE_SAMPLES), "--attn_policy", policy, "--seed", "31"])
        require((args.d_model, args.n_layers, args.n_heads, args.d_ff, args.d_cond, args.T,
                 args.batch, args.bf16, args.maze_channels) ==
                (384, n_layers, 12, 1536, 128, 64, 256, 1, "32,64,128,128"),
                "maze trainer defaults changed")
        args.steps_per_call = 1   # one step per call, so that each step is timed
        ds, data_dim = make_dataset(args)
        loader = iter(make_loader(ds, args))
        model = trainer.build_model(args, data_dim, dev)
        _nonzero_head(model)
        state, train_step, _ = trainer.make_trainer(args, dev, data_dim, model)
        names, leaves = list(state.params), list(state.params.values())
        require(all(p.dtype == torch.float32 and p.requires_grad and p.is_cuda for p in leaves)
                and model.dtype == torch.bfloat16,
                f"{stage} {policy}: f32 masters / bf16 compute expected")
        host_rng = np.random.RandomState(1)
        if stage == "stage1":
            make_host = lambda b, i: trainer.host_batch(args, b, trainer.device_policy_of(args),
                                                        host_rng)
            loss_fn = trainer.make_loss_fn(
                model, args, make_schedule(args.schedule, args.N_train, device=dev),
                trainer.device_policy_of(args))
        else:
            make_host = lambda b, i: trainer.host_batch(args, b, i, host_rng)
            loss_fn = trainer.make_loss_fn(model, args)
        batch = to_device(make_host(next(loader), 0), dev)

        # one loss + gradients from the same weights, batch and draws on each path
        def loss_and_grads():
            rng = torch.Generator(device=dev).manual_seed(32)
            loss, _ = loss_fn(None, batch, rng)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        with count_maze_twin_calls() as calls:
            loss_k, grads_k = loss_and_grads()
        require(calls["forward"] == 0 and calls["backward"] == n_layers,
                f"{stage} {policy}: twin calls {calls} in one kernel-path loss + gradient, "
                f"expected 0 forward and {n_layers} backward")
        with plain_twins():
            loss_t, grads_t = loss_and_grads()
        rel_loss = abs(loss_k.item() - loss_t.item()) / abs(loss_t.item())
        worst = max((_errors(a, b)[1], n) for n, a, b in zip(names, grads_k, grads_t))
        zero = [n for n, g in zip(names, grads_t) if not bool(g.abs().max() > 0)]
        print(f"[maze train] {stage} policy={policy} kernels vs plain twins, same weights / "
              f"batch / draws: loss {loss_k.item():.6f} vs {loss_t.item():.6f} (rel "
              f"{rel_loss:.3e}, tol {MAZE_LOSS_TOL}); {len(names)} leaves, worst gradient "
              f"max|d|/max|twin|={worst[0]:.3e} at {worst[1]} (tol {MAZE_GRAD_TOL}); twin calls "
              f"forward 0, backward {n_layers}", flush=True)
        require(not zero, f"{stage} {policy}: identically zero gradients at {zero[:3]}")
        require(all(g.dtype == torch.float32 for g in grads_k),
                f"{stage} {policy}: gradients of the f32 masters are not f32")
        require(rel_loss <= MAZE_LOSS_TOL, f"{stage} {policy}: loss disagrees ({rel_loss:.3e})")
        require(worst[0] <= MAZE_GRAD_TOL,
                f"{stage} {policy}: gradient of {worst[1]} disagrees ({worst[0]:.3e})")
        del grads_k, grads_t

        # the trainer's own step: counts set to 0 just before, read just after
        before = [p.detach().clone() for p in leaves]
        ema0 = {n: p.clone() for n, p in state.ema_params.items()}
        rng = torch.Generator(device=dev).manual_seed(33)
        warm, timed = MAZE_STEPS
        torch.cuda.reset_peak_memory_stats()
        _set_maze_counts(dict.fromkeys(launches, 0))
        step_s = []
        with count_maze_twin_calls() as calls:
            for i in range(warm + timed):
                nxt = make_host(next(loader), i + 1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = train_step(state, batch, rng)
                loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                require(loss == loss and abs(loss) != float("inf") and gnorm == gnorm
                        and abs(gnorm) != float("inf") and gnorm > 0,
                        f"{stage} {policy} step {i}: loss {loss} grad norm {gnorm}")
                batch = to_device(nxt, dev)
        counts = _maze_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per_step = {"fused_film_block": n_layers if policy == "block" else 0,
                    "small_mha_packed": n_layers if (policy, stage) == ("fused", "stage2") else 0,
                    "small_mha": 0}
        want = {k: v * (warm + timed) for k, v in per_step.items()}
        require(counts == want and calls["forward"] == 0
                and calls["backward"] == n_layers * (warm + timed),
                f"{stage} {policy}: launches {counts}, twin calls {calls}; expected {want}, "
                f"0 forward and {n_layers} per step backward")
        same = [n for n, a, b in zip(names, before, leaves) if torch.equal(a, b)]
        require(not same, f"{stage} {policy}: parameters unchanged: {same[:3]}")
        still = [n for n, p in state.ema_params.items() if torch.equal(p, ema0[n])]
        require(not still, f"{stage} {policy}: EMA did not move: {still[:3]}")
        require(all(bool(torch.isfinite(p).all()) for p in leaves),
                f"{stage} {policy}: non-finite parameters")
        per = sum(step_s[warm:]) / timed
        print(f"[maze train] {tag} {stage} policy={policy}: loss {loss:.4f} grad_norm "
              f"{gnorm:.3e} after {warm + timed} steps; {per:.4f} s/step, "
              f"{args.batch / per:.1f} samples/s ({timed} timed steps after {warm} warm-up; "
              f"steps {', '.join(f'{x:.3f}' for x in step_s)}), peak memory {peak:.2f} GiB; "
              f"launches per step {per_step}, twin calls forward 0 / backward {n_layers} per "
              f"step; all {len(names)} parameters changed, EMA moved", flush=True)
        for k, v in counts.items():
            launches[k] += v
        results[(stage, policy)] = per
        if profile and (stage, policy) == ("stage2", "fused"):
            from torch.profiler import ProfilerActivity, profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, _ = train_step(state, batch, rng)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            _print_profile(prof, tag, f"one maze Stage-2 training step (policy fused, batch "
                                      f"{args.batch}, {wall * 1e3:.1f} ms wall under the profiler)")
        del state, train_step, model, leaves, before, ema0

    # TransformerBlock(use_small_mha=True): a stack of the trainers' width,
    # forward and backward, kernel path against twin path
    w = {k: BENCH[k] for k in ("d_model", "n_heads", "d_ff", "d_cond")}
    with torch.device("meta"):
        stack = torch.nn.ModuleList(transformer.TransformerBlock(use_small_mha=True, **w)
                                    for _ in range(n_layers))
    stack = init_parameters(stack.to_empty(device=dev),
                            torch.Generator(device=dev).manual_seed(34))
    transformer.set_compute_dtype(stack, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(35)
    x = torch.randn((256, BENCH["T"], w["d_model"]), generator=gen, device=dev)
    cond = torch.randn((256, w["d_cond"]), generator=gen, device=dev)
    params = list(stack.parameters())

    def stack_grads():
        h = x
        for blk in stack:
            h = blk(h, cond)
        loss = h.float().square().mean()
        return loss.detach(), torch.autograd.grad(loss, params)

    _set_maze_counts(dict.fromkeys(launches, 0))
    with count_maze_twin_calls() as calls:
        loss_k, grads_k = stack_grads()
        torch.cuda.synchronize()
    counts = _maze_counts()
    require(counts == {"fused_film_block": 0, "small_mha_packed": 0, "small_mha": n_layers}
            and calls["forward"] == 0 and calls["backward"] == n_layers,
            f"use_small_mha stack: launches {counts}, twin calls {calls}")
    launches["small_mha"] += counts["small_mha"]
    with plain_twins():
        loss_t, grads_t = stack_grads()
    rel_loss = abs(loss_k.item() - loss_t.item()) / abs(loss_t.item())
    worst = max(_errors(a, b)[1] for a, b in zip(grads_k, grads_t))
    ms = _time_ms(stack_grads, iters=5, warmup=1)
    print(f"[maze train] {tag} TransformerBlock(use_small_mha=True) x {n_layers}, x [256, "
          f"{BENCH['T']}, {w['d_model']}]: {n_layers} small_mha launches, twin calls forward 0 / "
          f"backward {n_layers}; loss rel {rel_loss:.3e} (tol {MAZE_LOSS_TOL}), worst gradient "
          f"max|d|/max|twin|={worst:.3e} (tol {MAZE_GRAD_TOL}); forward + backward {ms:.2f} ms",
          flush=True)
    require(rel_loss <= MAZE_LOSS_TOL and worst <= MAZE_GRAD_TOL,
            f"use_small_mha stack: kernel path disagrees ({rel_loss:.3e}, {worst:.3e})")
    del stack, params, grads_k, grads_t

    # both CLIs as a user calls them: defaults, a few steps, a checkpoint, a
    # resume; then the trained EMA weights through models/loading into the sampler
    runs = {}
    for stage, policy in (("stage1", "block"), ("stage2", "fused")):
        trainer = _maze_trainer(stage)
        out = os.path.join(workdir, stage)
        flags = ["--num_samples", str(MAZE_SAMPLES), "--attn_policy", policy, "--out_dir", out,
                 "--log_every", "1"]
        if stage == "stage2":
            flags += ["--bootstrap_ckpt", runs["stage1"], "--bootstrap_warmup_steps", "2",
                      "--pos_clip", "1"]
        first, total = MAZE_CLI_STEPS
        before = _maze_counts()
        with count_maze_twin_calls() as calls:
            t0 = time.perf_counter()
            trainer.main(flags + ["--steps", str(first), "--save_every", str(first)])
            st = trainer.main(flags + ["--steps", str(total), "--save_every", str(total),
                                       "--resume", out])
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in _maze_counts().items()}
        for name in ("run_config.json", f"ckpt_{first}/meta.json", f"ckpt_{total}/params.pt",
                     f"ckpt_{total}/ema.pt", f"ckpt_{total}/opt_state.pt"):
            require(os.path.exists(os.path.join(out, name)), f"{stage} CLI: {name} missing")
        key = "fused_film_block" if policy == "block" else "small_mha_packed"
        # Stage 2's bootstrap sampler adds Stage-1 evaluations at K=8: under
        # the fused policy they run plain attention (H*L = 96), no launch
        require(st.step == total and st.opt_state.count == total
                and delta[key] == n_layers * total and calls["forward"] == 0,
                f"{stage} CLI: step {st.step}, launches {delta}, twin calls {calls}")
        print(f"[maze train] {stage} CLI policy={policy}: {first} steps, checkpoint, resumed "
              f"to {total} in {took:.1f} s (dataset, model and both runs); launches {delta}, "
              f"forward twin calls 0", flush=True)
        for k, v in delta.items():
            launches[k] += v
        runs[stage] = out
    kp, kp_meta = load_keypoint_model(runs["stage1"], bf16=True, device=dev)
    it, it_meta = load_interp_model(runs["stage2"], bf16=True, device=dev)
    require(kp.dtype == torch.bfloat16 and kp.in_proj.weight.dtype == torch.float32,
            "loaded model: f32 weights with bf16 compute expected")
    cfg = PipelineConfig(T=BENCH["T"], K=BENCH["K"], levels=it_meta["levels"],
                         K_min=it_meta["K_min"], ddim_steps=BENCH["ddim_steps"],
                         stage2_mode=it_meta["mode"], clamp_policy="endpoints", pos_clip=True)
    pipe = make_pipeline(kp, it, make_schedule(kp_meta["schedule"], kp_meta["N_train"], device=dev),
                         cfg, kp_meta["data_dim"])
    idx, cond = _requests(64, torch.Generator().manual_seed(36), dev)
    for policy in ("block", "fused"):
        kp.set_attn_policy(policy)
        it.set_attn_policy(policy)
        before = _maze_counts()
        out = pipe(idx, cond, generator=torch.Generator(device=dev).manual_seed(37))
        torch.cuda.synchronize()
        _check_outputs(64, idx, cond, out)
        delta = {k: v - before[k] for k, v in _maze_counts().items()}
        require(delta["fused_film_block"] + delta["small_mha_packed"] > 0,
                f"sampling the trained weights under {policy}: no kernel launch")
        print(f"[maze train] trained EMA weights (f32, bf16 compute) through make_pipeline, "
              f"policy={policy} B=64: shapes, anchors, endpoints, [0,1] ok; launches {delta}",
              flush=True)
    print(f"[maze train] launches in the main-path run: {launches}", flush=True)
    return launches, results, runs



# Phase 5c: Stage-1 block launches per pipeline call under attn_policy
# "block" on the linear DDIM-20 grid (20 timesteps, 19 transitions), from the
# solvers' rules in ops/ddpm.py and ops/rectified_flow.py: ddim 19
# evaluations, dpm 19 (9 at --ddim_steps 10), pfdiff 1 + ceil(18 / 2) = 10,
# FORA interval 2 the block stack at the 10 even transitions, rf 20 Euler
# steps; 12 layers each. Best-of-N folds its candidates into the batch: the
# same launches, each over N * B rows. Stage 2 adds levels x layers = 36.
SAMPLE_CLI_STAGE1 = {"ddim": 228, "pfdiff": 120, "dpm": 228, "dpm10": 108, "fora2": 120,
                     "rf": 240}
SAMPLE_CLI_BATCH = (256, 3)      # --batch, --num_batches of each sampling CLI run
SAMPLE_METRICS = ("collision_rate", "goal_dist", "success", "path_length", "smoothness",
                  "mse_to_gt")


def _stage1_evals(solver, steps, interval=1):
    """Stage-1 model evaluations of one call on the linear grid of `steps`."""
    from interpolated_diffusion_tpu_torch.ops.ddpm import make_timesteps

    if solver == "rf":
        return steps
    S = len(make_timesteps(BENCH["n_train"], steps, "linear")) - 1
    if solver == "pfdiff":
        return S if S < 2 else 1 + -(-(S - 1) // 2)
    return -(-S // interval)


@contextlib.contextmanager
def record_block_rows():
    """{sequence length: set of batch sizes} of the model's fused_film_block
    calls (each goes on to the kernel)."""
    from interpolated_diffusion_tpu_torch.models import transformer

    rows, real = {}, transformer.fused_film_block

    def recording(x, *a, **kw):
        rows.setdefault(x.shape[1], set()).add(x.shape[0])
        return real(x, *a, **kw)

    transformer.fused_film_block = recording
    try:
        yield rows
    finally:
        transformer.fused_film_block = real


@contextlib.contextmanager
def anchor_choices(replay=None):
    """The best-of dp mix's choice [B, K] of candidate per anchor, one per
    call: recorded, or with `replay` (a kernel path's choices) imposed on this
    path's own candidates. The choice is discrete: a bf16 ulp upstream can
    move a candidate's anchor across a cell boundary and flip it on one path
    only, so the twin path replays the kernel path's choices (as the Wan
    trainer's gate replays its SLA LUTs) and the flips are counted apart."""
    import torch
    from interpolated_diffusion_tpu_torch.ops import anchor_search

    real, own = anchor_search.dp_mix_anchors, []

    def choosing(z_cands, idx, occ, T):
        mixed = real(z_cands, idx, occ, T)
        own.append((z_cands == mixed[None]).all(-1).int().argmax(0))     # [B, K]
        if replay is None:
            return mixed
        c = replay[len(own) - 1]
        return torch.gather(z_cands.permute(1, 2, 0, 3), 2,
                            c[:, :, None, None].expand(-1, -1, 1, z_cands.shape[-1]))[:, :, 0]

    anchor_search.dp_mix_anchors = choosing
    try:
        yield own
    finally:
        anchor_search.dp_mix_anchors = real


def _profile_call(call, tag, what=None):
    """Where one call of `call` spends its time: the median wall time of 5
    calls (after a first) and the device time of one more under
    torch.profiler, whose table and device time by kind of kernel are printed
    when `what` names the call. Returns (wall seconds, device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    if what:
        _print_profile(prof, tag, what)
    return sorted(walls[1:])[2], sum(_device_us(e) for e in prof.key_averages()) / 1e3


def _sample_cli_profile(dev, card, runs, cfg_of):
    """Where one CLI-shaped call (B=256, policy block, 5b's checkpoints)
    spends its time, per Stage-1 solver: the median wall time of 5 calls, and
    the device time of one more under torch.profiler."""
    import torch
    from interpolated_diffusion_tpu_torch.models.loading import (load_interp_model,
                                                                  load_keypoint_model)
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample import generate

    kp, kp_meta = load_keypoint_model(runs["stage1"], device=dev)
    it, it_meta = load_interp_model(runs["stage2"], device=dev)
    for m in (kp, it):
        m.set_attn_policy("block")
    sched = make_schedule(kp_meta["schedule"], kp_meta["N_train"], device=dev)
    idx, cond = _requests(SAMPLE_CLI_BATCH[0], torch.Generator().manual_seed(40), dev)
    for label, knob in (("ddim", {}), ("pfdiff", dict(stage1_solver="pfdiff")),
                        ("dpm10", dict(stage1_solver="dpm", ddim_steps=10)),
                        ("fora2", dict(stage1_cache_interval=2)),
                        ("best_of4-dp", dict(stage1_best_of=4, stage1_best_of_mode="dp"))):
        cfg = cfg_of(**knob)
        pipe = generate.make_pipeline(kp, it, sched, cfg, BENCH["data_dim"])
        draws = generate.make_draws(cfg, len(idx), BENCH["data_dim"],
                                    torch.Generator(device=dev).manual_seed(41))
        wall, device = _profile_call(lambda: pipe(idx, cond, **draws), f"[{card}]")
        print(f"[profile] [{card}] sampling CLI call, {label}, B={len(idx)}, block: median wall "
              f"{wall * 1e3:.1f} ms of 5 calls ({len(idx) / wall:.1f} samples/s), device time "
              f"{device:.1f} ms under the profiler: the device is busy {device / (wall * 1e3):.2f} "
              f"of the call", flush=True)


def phase_maze_sample_cli(dev, card, runs, workdir, profile=False):
    """The sampling CLI (sample/generate.main) on the full-width checkpoints
    of phase 5b's CLI runs (and an rf Stage-1 checkpoint trained here), then
    the pipeline under each knob, kernel path against twin path."""
    import csv

    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.models.denoisers import InterpLevelDenoiser
    from interpolated_diffusion_tpu_torch.models.init import build_model
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample import generate
    from interpolated_diffusion_tpu_torch.train import train_keypoints

    t_phase = time.perf_counter()
    n_layers, levels = BENCH["n_layers"], BENCH["levels"]
    s2 = levels * n_layers
    for key, (solver, steps, interval) in (("ddim", ("ddim", 20, 1)), ("pfdiff", ("pfdiff", 20, 1)),
                                           ("dpm", ("dpm", 20, 1)), ("dpm10", ("dpm", 10, 1)),
                                           ("fora2", ("ddim", 20, 2)), ("rf", ("rf", 20, 1))):
        require(_stage1_evals(solver, steps, interval) * n_layers == SAMPLE_CLI_STAGE1[key],
                f"Stage-1 launches of {key}: the solvers' rules give "
                f"{_stage1_evals(solver, steps, interval) * n_layers}")
    # an rf Stage-1 checkpoint through the trainer's CLI (full width, a few steps)
    kp_rf = os.path.join(workdir, "stage1_rf")
    before = _maze_counts()
    train_keypoints.main(["--num_samples", str(MAZE_SAMPLES), "--attn_policy", "block",
                          "--objective", "rf", "--steps", "2", "--save_every", "2",
                          "--log_every", "1", "--out_dir", kp_rf])
    launches = {k: v - before[k] for k, v in _maze_counts().items()}
    require(launches["fused_film_block"] == 2 * n_layers,
            f"rf Stage-1 CLI: launches {launches}")

    B, n_batches = SAMPLE_CLI_BATCH
    variants = ("interp", "refined")
    columns = ["batch", "sample"] + [f"{v}_{m}" for v in variants for m in SAMPLE_METRICS]
    oracle_columns = columns + [f"{v}_{m}" for v in ("oracle_interp", "oracle_refined")
                                for m in SAMPLE_METRICS]
    plan = [("ddim", [], "ddim"), ("pfdiff", ["--stage1_solver", "pfdiff"], "pfdiff"),
            ("dpm", ["--stage1_solver", "dpm"], "dpm"),
            ("dpm10", ["--stage1_solver", "dpm", "--ddim_steps", "10"], "dpm10"),
            ("fora2", ["--stage1_cache_interval", "2"], "fora2"),
            ("best_of4-dp", ["--stage1_best_of", "4", "--stage1_best_of_mode", "dp"], "ddim"),
            ("best_of4-set", ["--stage1_best_of", "4", "--stage1_best_of_mode", "set"], "ddim"),
            ("s2-level-smooth", ["--s2_noise_mode", "level", "--s2_noise_sigma", "0.02",
                                 "--s2_delta_smooth", "2"], "ddim"),
            ("oracle", ["--compare_oracle", "1"], "ddim"),
            ("fused", ["--attn_policy", "fused"], "ddim"),
            ("rf", ["--kp_ckpt", kp_rf], "rf")]
    rates, cli_launches = {}, dict.fromkeys(("fused_film_block", "small_mha_packed",
                                             "small_mha"), 0)
    for label, flags, s1_key in plan:
        out = os.path.join(workdir, f"sample_{label}")
        policy = "fused" if "--attn_policy" in flags else "block"
        argv = ["--kp_ckpt", runs["stage1"], "--interp_ckpt", runs["stage2"], "--device", "cuda",
                "--attn_policy", "block", "--batch", str(B), "--num_batches", str(n_batches),
                "--time_spacing", "linear", "--num_samples", str(MAZE_SAMPLES),
                "--cache_dir", os.path.join(workdir, "data"), "--sanity", "0",
                "--out_dir", out] + flags
        calls = n_batches * (2 if "--compare_oracle" in flags else 1)
        n_cand = int(flags[flags.index("--stage1_best_of") + 1]) if "--stage1_best_of" in flags else 1
        if policy == "block":
            want = {"fused_film_block": n_batches * SAMPLE_CLI_STAGE1[s1_key] + calls * s2,
                    "small_mha_packed": 0, "small_mha": 0}
            want_len = {BENCH["K"]: n_batches * SAMPLE_CLI_STAGE1[s1_key], BENCH["T"]: calls * s2}
        else:   # Stage 1 at K = 8 runs no kernel under fused (H * L = 96)
            want = {"fused_film_block": 0, "small_mha_packed": calls * s2, "small_mha": 0}
            want_len = {}
        from interpolated_diffusion_tpu_torch.kernels.fused_block import fused_film_block

        by_len = fused_film_block.launches_by_len
        _set_maze_counts(dict.fromkeys(want, 0))
        by_len.clear()
        with count_maze_twin_calls() as twin, record_block_rows() as rows:
            t0 = time.perf_counter()
            summary = generate.main(argv)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
        counts, got_len = _maze_counts(), dict(by_len)
        require(counts == want and got_len == want_len and twin["total"] == 0,
                f"sample CLI {label}: launches {counts} by length {got_len}, twin calls {twin}; "
                f"expected {want} by length {want_len}, no twin call")
        if policy == "block":
            require(rows[BENCH["K"]] == {n_cand * B} and rows[BENCH["T"]] == {B},
                    f"sample CLI {label}: block rows by length {rows}")
        with open(os.path.join(out, "metrics.csv")) as f:
            header = next(csv.reader(f))
        require(header == (oracle_columns if "--compare_oracle" in flags else columns),
                f"sample CLI {label}: metrics.csv columns {header}")
        with open(os.path.join(out, "summary.json")) as f:
            keys = set(json.load(f))
        require(keys == set(header[2:]) | {"samples_per_sec", "sanity"},
                f"sample CLI {label}: summary.json keys {sorted(keys)}")
        with np.load(os.path.join(out, "samples.npz")) as f:
            shapes = {k: f[k].shape for k in f.files}
            finite = all(bool(np.isfinite(f[k]).all()) for k in ("interp", "refined", "keypoints"))
        n = B * n_batches
        require(finite and shapes["refined"] == (n, BENCH["T"], 2)
                and shapes["keypoints"] == (n, BENCH["K"], 2),
                f"sample CLI {label}: samples.npz finite {finite}, shapes {shapes}")
        rates[label] = summary["samples_per_sec"]
        for k, v in counts.items():
            cli_launches[k] += v
        print(f"[sample cli] {card} {label} (policy {policy}, {n_batches} x {B}): "
              f"{summary['samples_per_sec']:.1f} samples/s (batches 1..{n_batches - 1}; the "
              f"first holds the warm-up), {took:.1f} s with model load and dataset; launches "
              f"{counts} (Stage 1 {want_len.get(BENCH['K'], 0) // n_batches} per call"
              f"{f', each over {n_cand} x {B} rows' if n_cand > 1 else ''}), twin calls 0; "
              f"refined collision {summary['refined_collision_rate']:.4f}, success "
              f"{summary['refined_success']:.3f}; sanity verdict {summary['sanity']}", flush=True)

    # kernel path against twin path at the pipeline level: seeded full-width
    # weights, a Stage 2 with the anchor-confidence channel, the same draws
    kp, _ = _build_models(dev)
    it3 = build_model(InterpLevelDenoiser, generator=torch.Generator().manual_seed(5), device=dev,
                      dtype=torch.bfloat16, mask_channels=3,
                      **{k: BENCH[k] for k in ("d_model", "n_layers", "n_heads", "d_ff",
                                               "d_cond", "maze_channels", "data_dim")})
    _nonzero_head(it3)
    it3.eval()
    for m in (kp, it3):
        m.set_attn_policy("block")
    sched = make_schedule("linear", BENCH["n_train"], device=dev)
    idx, cond = _requests(64, torch.Generator().manual_seed(38), dev)
    base = dict(T=BENCH["T"], K=BENCH["K"], levels=levels, K_min=BENCH["K_min"],
                ddim_steps=BENCH["ddim_steps"], pos_clip=True, anchor_conf=True)
    knobs = {"pfdiff": dict(stage1_solver="pfdiff"), "dpm": dict(stage1_solver="dpm"),
             "fora2": dict(stage1_cache_interval=2),
             "best_of4-dp": dict(stage1_best_of=4, stage1_best_of_mode="dp"),
             "rf": dict(stage1_objective="rf"),
             "conf-soft-s2level": dict(soft_anchor_clamp=True, s2_noise_mode="level",
                                       s2_noise_sigma=0.02, anchor_conf_anneal_mode="linear"),
             "logit_space": dict(logit_space=True)}
    worst = {}
    for label, knob in knobs.items():
        cfg = generate.PipelineConfig(**base, **knob)
        pipe = generate.make_pipeline(kp, it3, sched, cfg, BENCH["data_dim"])
        draws = generate.make_draws(cfg, 64, BENCH["data_dim"],
                                    torch.Generator(device=dev).manual_seed(39))
        _set_maze_counts(dict.fromkeys(("fused_film_block", "small_mha_packed", "small_mha"), 0))
        with anchor_choices() as chosen:
            out = pipe(idx, cond, **draws)
        k_launches = _maze_counts()["fused_film_block"]
        with plain_twins(), anchor_choices(replay=chosen) as own:
            ref = pipe(idx, cond, **draws)
        flips = "" if not chosen else (
            f"; the twin path's own dp choice differs in {int((own[0] != chosen[0]).sum())} of "
            f"{chosen[0].numel()} anchors (the kernel path's replayed)")
        require(k_launches > 0 and _maze_counts()["fused_film_block"] == k_launches,
                f"pipeline {label}: kernel launches {k_launches}, then {_maze_counts()}")
        errs = {name: (a - b).abs().max().item()
                for name, a, b in zip(("x_interp", "x_refined", "z_pred"), out, ref)}
        worst[label] = max(errs.values())
        require(all(bool(torch.isfinite(t).all()) for t in out) and worst[label] <= PIPE_TOL,
                f"pipeline {label}: kernel path disagrees with the twin path {errs}")
        print(f"[sample cli] pipeline {label}, B=64, block policy, kernels vs plain twins, same "
              f"draws: max|d| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol "
              f"{PIPE_TOL}); {k_launches} block launches{flips}", flush=True)
    took = time.perf_counter() - t_phase
    if profile:
        _sample_cli_profile(dev, card, runs, lambda **knob: generate.PipelineConfig(
            **dict(base, anchor_conf=False, **knob)))
    print(f"[sample cli] launches over the CLI runs: {cli_launches}; {card} phase 5c wall "
          f"time {took:.1f} s", flush=True)
    return cli_launches



# Phase 5d: serving and keypoint selection. The selection models at the JAX
# trainers' defaults (D_phi: d_cond 128, hidden 256, 3 layers; selector:
# d_model 256, 8 heads, d_ff 512, 2 layers, pos_dim 64; maze channels
# 32,64,128,128; T=64, K=8, levels 3 of the DP prep, so the selector trains
# with --levels 3 --k_schedule doubling to read its per-level labels), batch
# 256; the maze models at BENCH width under block. Launches of a served
# dispatch under block: 19 Stage-1 evaluations at L = K and 3 Stage-2 levels
# at L = T, 12 layers each; under fused, Stage 2's 36 small_mha_packed.
SELECT = dict(num_samples=2048, prep_batch=256, shard=10000, train_batch=256,
              train_steps=(1, 4), cli_steps=4, sel_levels=3)
SERVE_BUCKETS = (1, 4, 16, 64)
SERVE_CALLS = 20          # timed calls per bucket (each ends in a synchronize)
SERVE_CLIENTS = 16        # concurrent HTTP clients, one (start, goal) each
SERVE_LINGER_S = 0.02


def _net_flags():
    return ["--d_model", str(BENCH["d_model"]), "--n_layers", str(BENCH["n_layers"]),
            "--n_heads", str(BENCH["n_heads"]), "--d_ff", str(BENCH["d_ff"]),
            "--d_cond", str(BENCH["d_cond"]),
            "--maze_channels", ",".join(str(c) for c in BENCH["maze_channels"]),
            "--T", str(BENCH["T"]), "--maze_h", str(BENCH["grid"]),
            "--maze_w", str(BENCH["grid"])]


def _dispatch_launches():
    """(fused_film_block per dispatch by sequence length, small_mha_packed
    per fused dispatch) of a served call."""
    n_s1 = len(range(BENCH["ddim_steps"] - 1)) * BENCH["n_layers"]       # 228
    n_s2 = BENCH["levels"] * BENCH["n_layers"]                           # 36
    return {BENCH["K"]: n_s1, BENCH["T"]: n_s2}, n_s2


def _timed_steps(train_step, state, loader, host, dev, warm, timed):
    """(state, s/step over the timed steps, last loss) through the trainer's
    own step, one batch per call, each step ending in a synchronize."""
    import torch
    from interpolated_diffusion_tpu_torch.train.common import to_device

    gen = torch.Generator(device=dev).manual_seed(51)
    times, loss = [], float("nan")
    for i in range(warm + timed):
        batch = to_device(host(next(loader), i), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, gen)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        require(math.isfinite(loss), f"non-finite loss at step {i}")
    return state, sum(times[warm:]) / timed, loss


def _select_phase(dev, card, workdir):
    """Native shards, D_phi and the selector at their trainers' defaults, the
    DP prep (gt, then dphi) and the DP on the card against the CPU."""
    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.data import native
    from interpolated_diffusion_tpu_torch.data import prepare_dp_keypoints as prep
    from interpolated_diffusion_tpu_torch.data.dataset import ParticleMazeDataset
    from interpolated_diffusion_tpu_torch.ops import selection as sel
    from interpolated_diffusion_tpu_torch.ops.keyframes import compute_k_schedule
    from interpolated_diffusion_tpu_torch.train import train_keypoint_selector as tks
    from interpolated_diffusion_tpu_torch.train import train_segment_cost as tsc
    from interpolated_diffusion_tpu_torch.train.common import make_dataset, make_loader

    T, K, G, levels = BENCH["T"], BENCH["K"], BENCH["grid"], BENCH["levels"]
    # the C++ generator: a fresh g++ build of the checkout's source (the
    # datasets of 5b loaded the library already), a failed build is fatal
    # ("always"), two shard builds agree
    from pathlib import Path

    saved, native.BUILD_ROOT = native.BUILD_ROOT, Path(workdir) / "native"
    try:
        t0 = time.perf_counter()
        lib = native.build()
        build_s = time.perf_counter() - t0
    finally:
        native.BUILD_ROOT = saved
    shards, secs = {}, {}
    for mode in ("always", "never", "always"):
        ds = ParticleMazeDataset(num_samples=SELECT["shard"], h=G, w=G, T=T,
                                 shard_size=SELECT["shard"], use_native=mode)
        t0 = time.perf_counter()
        data = ds._build_shard(0)
        secs.setdefault(mode, time.perf_counter() - t0)
        if mode in shards:
            require(all(np.array_equal(shards[mode][k], data[k]) for k in data),
                    "native maze shards: two builds differ")
        shards[mode] = data
    require(shards["always"]["x"].shape == (SELECT["shard"], T, 2)
            and np.isfinite(shards["always"]["x"]).all(), "native maze shard: bad x")
    print(f"[select] {card} native maze shard of {SELECT['shard']} mazes {G}x{G}, T={T}: "
          f"{secs['always']:.3f} s native (a fresh g++ build of csrc/host/maze_gen.cpp "
          f"{build_s:.1f} s: {lib.name}), {secs['never']:.3f} s numpy; two native builds equal bit "
          f"for bit", flush=True)
    del shards

    # D_phi at its trainer's defaults
    data = ["--num_samples", str(SELECT["num_samples"]), "--T", str(T), "--maze_h", str(G),
            "--maze_w", str(G), "--batch", str(SELECT["train_batch"])]
    dphi_dir, sel_dir = os.path.join(workdir, "dphi"), os.path.join(workdir, "sel")
    args = tsc.build_argparser().parse_args(data + ["--steps_per_call", "1", "--seed", "52"])
    require((args.d_cond, args.hidden_dim, args.n_layers_mlp, args.maze_channels) ==
            (128, 256, 3, "32,64,128,128"), "D_phi trainer defaults changed")
    ds, _ = make_dataset(args)
    state, step, model, targets = tsc.make_trainer(args, dev, ds)
    warm, timed = SELECT["train_steps"]
    _, per, loss = _timed_steps(step, state, iter(make_loader(ds, args)),
                                lambda b, i: tsc.host_batch(args, b), dev, warm, timed)
    print(f"[select] {card} D_phi trainer (d_cond 128, hidden 256, 3 layers, batch "
          f"{args.batch}, {len(targets.seg_feat)} segments): {per:.4f} s/step over {timed} steps "
          f"after {warm}, loss {loss:.4f}", flush=True)
    tsc.main(data + ["--steps", "2", "--save_every", "2", "--log_every", "1",
                     "--out_dir", dphi_dir])

    # the DP prep, ground-truth costs then D_phi's, with its invariants
    out, k_list = {}, compute_k_schedule(T, K, levels)
    for source in ("gt", "dphi"):
        path = os.path.join(workdir, f"dp_{source}.npz")
        t0 = time.perf_counter()
        res = prep.main(["--out_path", path, "--T", str(T), "--K", str(K), "--levels", str(levels),
                         "--num_samples", str(SELECT["num_samples"]), "--maze_h", str(G),
                         "--maze_w", str(G), "--batch", str(SELECT["prep_batch"]),
                         "--store_kp_mask_levels", "1", "--cost_source", source]
                        + (["--dphi_ckpt", dphi_dir] if source == "dphi" else []))
        took = time.perf_counter() - t0
        idx, masks = res["kp_idx"], res["kp_mask_levels"]
        require((idx[:, 0] == 0).all() and (idx[:, -1] == T - 1).all()
                and (np.diff(idx, axis=1) > 0).all(), f"prep {source}: bad kp_idx")
        require((masks.sum(-1) == np.asarray(k_list)[None]).all()
                and masks[:, :, 0].all() and masks[:, :, -1].all(),
                f"prep {source}: a level's mask does not hold K_s anchors and the endpoints")
        out[source] = path
        print(f"[select] {card} prepare_dp_keypoints cost_source={source}: {len(idx)} mazes, "
              f"T={T}, K={K}, levels {levels} (K_s {k_list}) in {took:.2f} s; endpoints, "
              f"increasing indices, K_s anchors per level ok", flush=True)

    # the DP on the card against the DP on the CPU over the same cost matrix
    x = torch.as_tensor(np.load(out["gt"])["x"][:SELECT["prep_batch"]])
    pre = sel.build_segment_precompute(T, 16)
    c_cpu = sel.compute_segment_costs_batch(x, pre)
    c_dev = sel.compute_segment_costs_batch(x.to(dev), pre.to(dev))
    rel = float(((c_dev.cpu() - c_cpu).abs() / c_cpu.abs().clamp_min(1e-12)).max())
    C = sel.build_cost_matrix_from_segments(c_dev, pre.to(dev), T)
    for k in (K, *k_list):
        a = sel.dp_select_indices_batch(C, k)
        b = sel.dp_select_indices_batch(C.cpu(), k)
        require(torch.equal(a.cpu(), b), f"DP with K={k}: the card's indices differ from the CPU's")
    print(f"[select] DP on the card = DP on the CPU over the same cost matrix "
          f"[{len(x)}, {T}, {T}] at K in {sorted({K, *k_list})}: identical; cost matrix card vs CPU "
          f"max relative difference {rel:.2e} (tol 1e-5)", flush=True)
    require(rel <= 1e-5, f"segment costs: the card's differ from the CPU's by {rel:.2e}")

    # the selector at its trainer's defaults, on the DP prep's per-level labels
    sel_flags = ["--dataset", "prepared", "--prepared_path", out["gt"], "--T", str(T), "--K",
                 str(K), "--levels", str(levels), "--k_schedule", "doubling", "--use_level", "1",
                 "--maze_h", str(G), "--maze_w", str(G), "--batch", str(SELECT["train_batch"])]
    args = tks.build_argparser().parse_args(sel_flags + ["--steps_per_call", "1", "--seed", "53",
                                                         "--steps", str(warm + timed)])
    require((args.d_model, args.n_heads, args.d_ff, args.n_layers_sel, args.pos_dim) ==
            (256, 8, 512, 2, 64), "selector trainer defaults changed")
    ds, _ = make_dataset(args)
    state, step, _ = tks.make_trainer(args, dev, True)
    _, per, loss = _timed_steps(step, state, iter(make_loader(ds, args)),
                                lambda b, i: tks.host_batch(args, b, i, True), dev, warm, timed)
    print(f"[select] {card} selector trainer (d_model 256, 8 heads, d_ff 512, 2 layers, "
          f"pos_dim 64, batch {args.batch}): {per:.4f} s/step over {timed} steps after {warm}, "
          f"loss {loss:.4f}", flush=True)
    tks.main(sel_flags + ["--steps", "2", "--save_every", "2", "--log_every", "1",
                          "--out_dir", sel_dir])
    return dphi_dir, sel_dir, out["gt"]


def _select_modes(dev, card, workdir, dphi_dir, sel_dir, prep_path, launches):
    """The maze trainers' and the sampling CLI's selection options at BENCH
    width under block, then the kp_feat + selector pipeline, kernel path vs
    twin path."""
    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.models.loading import (load_interp_model,
                                                                  load_keypoint_model,
                                                                  load_selector_model,
                                                                  make_dphi_seg_cost_fn)
    from interpolated_diffusion_tpu_torch.models.selector import select_topk_indices
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample import generate
    from interpolated_diffusion_tpu_torch.train import train_interp_levels, train_keypoints

    n_layers, steps = BENCH["n_layers"], SELECT["cli_steps"]
    common = _net_flags() + ["--dataset", "prepared", "--prepared_path", prep_path,
                             "--attn_policy", "block", "--steps", str(steps),
                             "--save_every", str(steps), "--log_every", "1"]
    runs = {}
    for stage, trainer, flags in (
            ("kp_feat", train_keypoints, ["--K", str(BENCH["K"]), "--use_kp_feat", "1",
                                          "--kp_feat_dim", "5", "--dphi_ckpt", dphi_dir,
                                          "--idx_policy", "dp:0.4,selector:0.3,random:0.3",
                                          "--selector_ckpt", sel_dir]),
            ("selector_level", train_interp_levels, ["--K_min", str(BENCH["K_min"]),
                                                     "--levels", str(BENCH["levels"]),
                                                     "--mask_policy", "selector_level",
                                                     "--selector_ckpt", sel_dir])):
        out = os.path.join(workdir, stage)
        _set_maze_counts(dict.fromkeys(launches, 0))
        with count_maze_twin_calls() as calls:
            t0 = time.perf_counter()
            st = trainer.main(common + flags + ["--out_dir", out])
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
        delta = _maze_counts()
        require(st.step == steps and delta["fused_film_block"] == n_layers * steps
                and calls["forward"] == 0,
                f"{stage} CLI: step {st.step}, launches {delta}, twin calls {calls}")
        for k, v in delta.items():
            launches[k] += v
        runs[stage] = out
        print(f"[select] {card} {trainer.__name__.rsplit('.', 1)[-1]} CLI "
              f"{' '.join(a for a in flags if not a.startswith(workdir))} (block, full width): "
              f"{steps} steps in {took:.1f} s (with model and selector / D_phi load); launches "
              f"{delta}, forward twin calls 0", flush=True)

    # the sampling CLI with every selection flag, 256 x 3, linear DDIM-20
    B, n_batches = SAMPLE_CLI_BATCH
    per_len, _ = _dispatch_launches()
    from interpolated_diffusion_tpu_torch.kernels.fused_block import fused_film_block

    by_len = fused_film_block.launches_by_len
    _set_maze_counts(dict.fromkeys(launches, 0))
    by_len.clear()
    with count_maze_twin_calls() as twin:
        t0 = time.perf_counter()
        summary = generate.main([
            "--kp_ckpt", runs["kp_feat"], "--interp_ckpt", runs["selector_level"],
            "--device", "cuda", "--attn_policy", "block", "--batch", str(B), "--num_batches",
            str(n_batches), "--time_spacing", "linear", "--num_samples",
            str(SELECT["num_samples"]), "--kp_index_mode", "selector", "--stage2_mask_policy",
            "selector", "--selector_ckpt", sel_dir, "--dphi_ckpt", dphi_dir, "--sanity", "0",
            "--out_dir", os.path.join(workdir, "sample_select")])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
    counts, got_len = _maze_counts(), dict(by_len)
    want_len = {L: n * n_batches for L, n in per_len.items()}
    require(got_len == want_len and counts["fused_film_block"] == sum(want_len.values())
            and twin["total"] == 0,
            f"selection sampling CLI: launches {counts} by length {got_len}, twin calls {twin}; "
            f"expected {want_len}")
    for k, v in counts.items():
        launches[k] += v
    print(f"[select] {card} sampling CLI --kp_index_mode selector --stage2_mask_policy selector "
          f"--dphi_ckpt ({n_batches} x {B}, block): {summary['samples_per_sec']:.1f} samples/s "
          f"(batches 1..{n_batches - 1}), {took:.1f} s with loads and dataset; launches "
          f"{counts} (by length {got_len}), twin calls 0; refined collision "
          f"{summary['refined_collision_rate']:.4f}", flush=True)

    # the kp_feat + selector pipeline, kernel path vs twin path on the same
    # draws; the selector's top-k and D_phi run no maze kernel, so both paths
    # get the same indices and logits (the discrete choice is made once)
    kp, kp_meta = load_keypoint_model(runs["kp_feat"], device=dev)
    it, it_meta = load_interp_model(runs["selector_level"], device=dev)
    selector, _ = load_selector_model(sel_dir, device=dev)
    dphi_fn, _ = make_dphi_seg_cost_fn(dphi_dir, BENCH["T"], False, device=dev)
    for m in (kp, it):
        m.set_attn_policy("block")
    cfg = generate.PipelineConfig(T=BENCH["T"], K=BENCH["K"], levels=it_meta["levels"],
                                  K_min=it_meta["K_min"], ddim_steps=BENCH["ddim_steps"],
                                  pos_clip=True, stage2_mask_policy="selector",
                                  kp_feat_dim=int(kp_meta["kp_feat_dim"]))
    pipe = generate.make_pipeline(kp, it, make_schedule(kp_meta["schedule"], kp_meta["N_train"],
                                                        device=dev), cfg, 2, dphi_fn)
    _, cond = _requests(64, torch.Generator().manual_seed(54), dev)
    with torch.no_grad():
        logits = selector(dict(cond, level=torch.full((64, 1), BENCH["K"] / (BENCH["T"] - 1),
                                                      device=dev)))
    idx = select_topk_indices(logits, BENCH["K"])
    draws = generate.make_draws(cfg, 64, 2, torch.Generator(device=dev).manual_seed(55))
    before = _maze_counts()["fused_film_block"]
    out = pipe(idx, cond, selector_logits=logits, **draws)
    k_launches = _maze_counts()["fused_film_block"] - before
    with plain_twins():
        ref = pipe(idx, cond, selector_logits=logits, **draws)
    errs = {n: (a - b).abs().max().item() for n, a, b in zip(("x_interp", "x_refined", "z_pred"),
                                                              out, ref)}
    require(k_launches == sum(per_len.values()) and max(errs.values()) <= PIPE_TOL
            and all(bool(torch.isfinite(t).all()) for t in out),
            f"kp_feat + selector pipeline: launches {k_launches}, kernel vs twin {errs}")
    print(f"[select] kp_feat (D_phi channels) + selector pipeline, B=64, block, kernels vs "
          f"plain twins on the same draws and selector choices: max|d| "
          f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol {PIPE_TOL}); {k_launches} "
          f"block launches", flush=True)
    return runs


def _serve_phase(dev, card, kp_dir, il_dir, dphi_dir, launches, label):
    """GenerationService (block) on one pair of checkpoints: warm-up, the
    three request sizes and their launches, the kernel path against the twin
    path, latency per bucket, and the HTTP server with concurrent clients."""
    import threading

    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.kernels.fused_block import fused_film_block
    from interpolated_diffusion_tpu_torch.serve import server as srv
    from interpolated_diffusion_tpu_torch.serve.client import GenerationClient
    from interpolated_diffusion_tpu_torch.serve.service import GenerationService

    G, T, K = BENCH["grid"], BENCH["T"], BENCH["K"]
    per_len, _ = _dispatch_launches()
    svc = GenerationService(kp_dir, il_dir, dphi_ckpt=dphi_dir or "", buckets=SERVE_BUCKETS,
                            attn_policy="block", device="cuda")
    svc.set_default_grid((np.random.default_rng(56).uniform(size=(G, G)) < 0.2).astype(np.float32))
    t0 = time.perf_counter()
    svc.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(57)
    by_len = fused_film_block.launches_by_len
    for B in (1, 3, 64):
        sg = rng.uniform(0.05, 0.95, size=(B, 4)).astype(np.float32)
        occ = (rng.uniform(size=(B, 1, G, G)) < 0.2).astype(np.float32)
        _set_maze_counts(dict.fromkeys(("fused_film_block", "small_mha_packed", "small_mha"), 0))
        by_len.clear()
        timing = {}
        with count_maze_twin_calls() as twin:
            out = svc.generate(sg, occ, seed=B, timing=timing)
        counts, got_len = _maze_counts(), dict(by_len)
        nb = min(b for b in SERVE_BUCKETS if b >= B)
        require(out["served_batch"] == nb and timing["served_batch"] == nb
                and set(timing) == {"prep_s", "put_s", "dispatch_s", "pull_s", "served_batch"}
                and out["refined"].shape == (B, T, 2) and out["keypoints"].shape == (B, K, 2)
                and out["idx"].shape == (B, K) and np.isfinite(out["refined"]).all()
                and got_len == per_len and counts["fused_film_block"] == sum(per_len.values())
                and twin["total"] == 0,
                f"service {label} B={B}: served {out['served_batch']}, launches {counts} by "
                f"length {got_len}, twin calls {twin}")
        for k, v in counts.items():
            launches[k] += v
        if B == 64:   # the kernel path against the twin path on the same draws
            with plain_twins():
                ref = svc.generate(sg, occ, seed=B)
            errs = {k: float(np.abs(out[k] - ref[k]).max()) for k in ("interp", "refined",
                                                                      "keypoints")}
            require(max(errs.values()) <= PIPE_TOL, f"service {label}: kernel vs twin {errs}")
        versus = (f"; kernels vs plain twins on the same draws: max|d| "
                  f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol {PIPE_TOL})"
                  if B == 64 else "")
        print(f"[serve] {card} {label} B={B} -> bucket {nb}: shapes, timing keys ok; launches "
              f"{counts['fused_film_block']} fused_film_block (by length {got_len}), twin calls 0"
              f"{versus}", flush=True)
    # latency per bucket, each call ending in a synchronize
    lat = {}
    for nb in SERVE_BUCKETS:
        sg = rng.uniform(0.05, 0.95, size=(nb, 4)).astype(np.float32)
        walls = []
        for i in range(SERVE_CALLS):
            t0 = time.perf_counter()
            svc.generate(sg, seed=i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        walls = np.sort(np.asarray(walls) * 1e3)
        lat[nb] = (float(np.median(walls)), float(walls[0]), float(walls[-1]))
    print(f"[serve] {card} {label} latency per request over {SERVE_CALLS} calls (ms, median "
          f"[min, max]), warm-up {warm_s:.1f} s: "
          + ", ".join(f"B={nb} {m:.1f} [{lo:.1f}, {hi:.1f}]" for nb, (m, lo, hi) in lat.items()),
          flush=True)

    # the HTTP server: concurrent clients under one seed coalesce
    calls = {"n": 0}
    real = svc.generate

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    svc.generate = counting
    server, batcher = srv.serve(svc, "127.0.0.1", 0, linger_s=SERVE_LINGER_S)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = GenerationClient("127.0.0.1", server.server_address[1], timeout_s=120)
        health = client.health()
        require(health["ok"] and health["T"] == T and health["K"] == K, f"healthz {health}")
        results, errors, lock = [], [], threading.Lock()

        def post(i):
            t0 = time.perf_counter()
            try:
                res = client.generate([rng_sg[i]], seed=7)
            except Exception as e:   # noqa: BLE001 - reported below
                with lock:
                    errors.append(repr(e))
                return
            with lock:
                results.append((time.perf_counter() - t0, res))

        rng_sg = np.random.default_rng(58).uniform(0.05, 0.95, size=(SERVE_CLIENTS, 4)).tolist()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        took = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        batcher.running = False
        svc.generate = real
    keys = {"interp", "refined", "keypoints", "idx", "served_batch", "coalesced_requests"}
    require(not errors and len(results) == SERVE_CLIENTS and calls["n"] < SERVE_CLIENTS
            and max(r["coalesced_requests"] for _, r in results) >= 2
            and all(set(r) == keys and r["refined"].shape == (1, T, 2) for _, r in results),
            f"server {label}: {len(results)} answers of {SERVE_CLIENTS}, {calls['n']} dispatches, "
            f"errors {errors[:2]}")
    walls = np.sort([w for w, _ in results]) * 1e3
    print(f"[serve] {card} {label} HTTP server, {SERVE_CLIENTS} concurrent clients, linger "
          f"{SERVE_LINGER_S * 1e3:.0f} ms: all answered in {took:.2f} s by {calls['n']} "
          f"dispatches (coalesced up to {max(r['coalesced_requests'] for _, r in results)}); "
          f"latency p50 {np.percentile(walls, 50):.1f} ms, p95 {np.percentile(walls, 95):.1f} ms",
          flush=True)
    del svc
    return lat


def phase_serve_select(dev, card, runs, workdir):
    """Phase 5d; see the module docstring. Returns the launches of rows 1-2
    on the serving path and on the selection path."""
    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.serve.service import GenerationService

    t_phase = time.perf_counter()
    keys = ("fused_film_block", "small_mha_packed", "small_mha")
    select_launches, serve_launches = dict.fromkeys(keys, 0), dict.fromkeys(keys, 0)
    dphi_dir, sel_dir, prep_path = _select_phase(dev, card, workdir)
    sel_runs = _select_modes(dev, card, workdir, dphi_dir, sel_dir, prep_path, select_launches)
    torch.cuda.empty_cache()
    _serve_phase(dev, card, runs["stage1"], runs["stage2"], None, serve_launches, "5b checkpoints")
    _serve_phase(dev, card, sel_runs["kp_feat"], sel_runs["selector_level"], dphi_dir,
                 serve_launches, "kp_feat + D_phi checkpoints")
    # one more service under fused: Stage 2's attention through small_mha_packed
    _, n_mha = _dispatch_launches()
    svc = GenerationService(runs["stage1"], runs["stage2"], buckets=SERVE_BUCKETS,
                            attn_policy="fused", device="cuda")
    sg = np.random.default_rng(59).uniform(0.05, 0.95, size=(64, 4)).astype(np.float32)
    occ = (np.random.default_rng(60).uniform(size=(64, 1, BENCH["grid"], BENCH["grid"]))
           < 0.2).astype(np.float32)
    svc.generate(sg, occ, seed=0)
    torch.cuda.synchronize()
    _set_maze_counts(dict.fromkeys(keys, 0))
    with count_maze_twin_calls() as twin:
        out = svc.generate(sg, occ, seed=1)
    counts = _maze_counts()
    walls = []
    for i in range(SERVE_CALLS):
        t0 = time.perf_counter()
        svc.generate(sg, occ, seed=i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    require(counts == {"fused_film_block": 0, "small_mha_packed": n_mha, "small_mha": 0}
            and twin["total"] == 0 and np.isfinite(out["refined"]).all(),
            f"service fused: launches {counts}, twin calls {twin}")
    serve_launches["small_mha_packed"] += counts["small_mha_packed"]
    walls = np.sort(walls) * 1e3
    print(f"[serve] {card} 5b checkpoints, policy fused, B=64: {counts['small_mha_packed']} "
          f"small_mha_packed launches a dispatch, twin calls 0; latency over {SERVE_CALLS} calls "
          f"median {np.median(walls):.1f} ms [{walls[0]:.1f}, {walls[-1]:.1f}]", flush=True)
    print(f"[serve] launches in the serving run: {serve_launches}; in the selection run: "
          f"{select_launches}; {card} phase 5d wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return serve_launches, select_launches


# Phase 5e: the causal path. The causal Stage-2 trainer CLI at its defaults
# (bench width, batch 256, levels 3, bf16 over f32 masters), then the causal
# sampling CLI (sample/generate_causal.main) on 5b's Stage-1 checkpoint and
# that causal checkpoint: 256 x 3, T=64, chunk 16 (chunks of 16, 16, 16 and 15
# frames), K_min 4, linear DDIM-10 (10 timesteps, 9 transitions). Each chunk's
# Stage 1 runs fused_film_block at [B, 4, 384] under policy block (ddim 9
# evaluations, pfdiff 1 + ceil(8 / 2) = 5, FORA interval 2 the block stack at 5
# of the 9, best-of-N the same launches over N x B rows; x 12 layers x 4
# chunks); the causal Stage 2 takes no kernel (plain attention: the kernels
# take no causal mask), nor does Stage 1 at H * L = 48 under fused.
CAUSAL_CLI = dict(batch=256, n_batches=3, chunk=16, K_min=4, ddim_steps=10)
CAUSAL_CLI_STEPS = (3, 5)    # causal trainer CLI: steps, then resumed to


@contextlib.contextmanager
def _tee_stdout():
    """Capture what is printed (the trainers' log lines) while printing it."""
    import io

    buf, real = io.StringIO(), sys.stdout

    class Tee:
        def write(self, text):
            buf.write(text)
            return real.write(text)

        def flush(self):
            real.flush()

    sys.stdout = Tee()
    try:
        yield buf
    finally:
        sys.stdout = real


def _s_per_step(log: str) -> float:
    """The last s/step a maze trainer printed (`step N loss X | t s/step`:
    the mean over the run's steps so far)."""
    import re

    found = re.findall(r"step \d+ loss \S+ \| ([0-9.]+) s/step", log)
    require(bool(found), "no s/step line in the trainer's log")
    return float(found[-1])


def _causal_profile(dev, card, kp_dir, il_dir):
    """The device's busy share of one causal CLI-shaped call (B=256, block,
    ddim): the median wall time of 5 calls beside the device time of one more
    under torch.profiler."""
    import torch
    from interpolated_diffusion_tpu_torch.models.loading import (load_interp_model,
                                                                  load_keypoint_model)
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample import generate_causal

    kp, kp_meta = load_keypoint_model(kp_dir, device=dev)
    it, it_meta = load_interp_model(il_dir, device=dev)
    for m in (kp, it):
        m.set_attn_policy("block")
    c = CAUSAL_CLI
    pipe = generate_causal.make_causal_pipeline(
        kp, it, make_schedule(kp_meta["schedule"], kp_meta["N_train"], device=dev),
        T=BENCH["T"], K_min=c["K_min"], levels=it_meta["levels"], chunk=c["chunk"],
        ddim_steps=c["ddim_steps"], data_dim=BENCH["data_dim"],
        mask_channels=it_meta["mask_channels"])
    _, cond = _requests(c["batch"], torch.Generator().manual_seed(70), dev)
    draws = generate_causal.make_causal_draws(BENCH["T"], c["K_min"], c["chunk"], c["batch"],
                                              BENCH["data_dim"],
                                              torch.Generator(device=dev).manual_seed(71))
    wall, device = _profile_call(lambda: pipe(cond, draws=draws), f"[{card}]",
                                 f"one causal sampling call (ddim, B={c['batch']}, block)")
    print(f"[causal] [{card}] causal sampling call, ddim, B={c['batch']}, block: median wall "
          f"{wall * 1e3:.1f} ms of 5 calls ({c['batch'] / wall:.1f} samples/s), device time "
          f"{device:.1f} ms under the profiler: the device is busy {device / (wall * 1e3):.2f} of "
          f"the call", flush=True)


def phase_causal(dev, card, runs, workdir, profile=False):
    """Phase 5e; see the comment above CAUSAL_CLI. Returns the block launches
    of the causal sampling CLI runs and of the sample_keypoints run."""
    import csv
    import importlib.util

    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.kernels.fused_block import fused_film_block
    from interpolated_diffusion_tpu_torch.models.loading import (load_interp_model,
                                                                  load_keypoint_model)
    from interpolated_diffusion_tpu_torch.ops.ddpm import make_timesteps
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample import (generate_causal, sample_keypoints)
    from interpolated_diffusion_tpu_torch.train import train_interp_levels_causal
    from interpolated_diffusion_tpu_torch.utils import checkpoint, jax_checkpoint

    t_phase = time.perf_counter()
    tag = f"[{card}]"
    n_layers, T = BENCH["n_layers"], BENCH["T"]
    zero = dict.fromkeys(("fused_film_block", "small_mha_packed", "small_mha"), 0)

    # the causal trainer CLI at its defaults: a checkpoint, then a resume
    il_dir = os.path.join(workdir, "stage2_causal")
    flags = ["--num_samples", str(MAZE_SAMPLES), "--out_dir", il_dir, "--log_every", "1"]
    first, total = CAUSAL_CLI_STEPS
    _set_maze_counts(zero)
    torch.cuda.reset_peak_memory_stats()
    with count_maze_twin_calls() as calls, _tee_stdout() as log:
        t0 = time.perf_counter()
        train_interp_levels_causal.main(flags + ["--steps", str(first), "--save_every",
                                                 str(first)])
        st = train_interp_levels_causal.main(flags + ["--steps", str(total), "--save_every",
                                                      str(total), "--resume", il_dir])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _maze_counts()
    _, il_meta = checkpoint.read_meta(os.path.join(il_dir, f"ckpt_{total}"))
    for name in ("run_config.json", f"ckpt_{first}/meta.json", f"ckpt_{total}/params.pt",
                 f"ckpt_{total}/ema.pt", f"ckpt_{total}/opt_state.pt"):
        require(os.path.exists(os.path.join(il_dir, name)), f"causal trainer CLI: {name} missing")
    require(st.step == total and il_meta["causal"] == 1 and il_meta["levels"] == BENCH["levels"]
            and counts == zero and calls["total"] == 0,
            f"causal trainer CLI: step {st.step}, meta causal {il_meta.get('causal')}, launches "
            f"{counts}, twin calls {calls}")
    first_log, resumed_log = log.getvalue().split("resumed from")
    print(f"[causal] {tag} causal Stage-2 trainer CLI at its defaults (batch 256, levels 3, "
          f"bf16 over f32 masters, policy fused): {first} steps, checkpoint, resumed to {total} "
          f"in {took:.1f} s; {_s_per_step(first_log):.4f} s/step over the first run (its first "
          f"step warms up), {_s_per_step(resumed_log):.4f} s/step over the resumed run; peak "
          f"memory "
          f"{peak:.2f} GiB; launches of rows 1-2 {counts} (0 a step: causal attention takes no "
          f"kernel), twin calls 0", flush=True)

    # the causal sampling CLI on 5b's Stage 1 and this causal Stage 2
    c = CAUSAL_CLI
    n_chunks = len(generate_causal.chunk_plan(T, c["chunk"]))
    evals = lambda solver, interval=1: _stage1_evals(solver, c["ddim_steps"], interval)
    plan = [("ddim", [], evals("ddim")), ("pfdiff", ["--stage1_solver", "pfdiff"], evals("pfdiff")),
            ("fora2", ["--stage1_cache_interval", "2"], evals("ddim", 2)),
            ("best_of4-dp", ["--stage1_best_of", "4", "--stage1_best_of_mode", "dp"],
             evals("ddim")),
            ("fused", ["--attn_policy", "fused"], 0)]
    columns = ["batch", "sample", *SAMPLE_METRICS]
    causal_launches = 0
    for label, extra, n_evals in plan:
        out = os.path.join(workdir, f"causal_{label}")
        argv = ["--kp_ckpt", runs["stage1"], "--interp_ckpt", il_dir, "--device", "cuda",
                "--attn_policy", "block", "--batch", str(c["batch"]), "--num_batches",
                str(c["n_batches"]), "--chunk", str(c["chunk"]), "--K_min", str(c["K_min"]),
                "--ddim_steps", str(c["ddim_steps"]), "--num_samples", str(MAZE_SAMPLES),
                "--cache_dir", os.path.join(workdir, "data"), "--out_dir", out] + extra
        per_call = n_chunks * n_evals * n_layers
        n_cand = int(extra[extra.index("--stage1_best_of") + 1]) if "--stage1_best_of" in extra else 1
        want = dict(zero, fused_film_block=c["n_batches"] * per_call)
        _set_maze_counts(zero)
        fused_film_block.launches_by_len.clear()
        with count_maze_twin_calls() as twin, record_block_rows() as rows:
            t0 = time.perf_counter()
            summary = generate_causal.main(argv)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
        counts, by_len = _maze_counts(), dict(fused_film_block.launches_by_len)
        want_len = {c["K_min"]: want["fused_film_block"]} if per_call else {}
        require(counts == want and by_len == want_len and twin["total"] == 0,
                f"causal CLI {label}: launches {counts} by length {by_len}, twin calls {twin}; "
                f"expected {want} by length {want_len}, no twin call")
        if per_call:
            require(rows == {c["K_min"]: {n_cand * c["batch"]}},
                    f"causal CLI {label}: block rows by length {rows}")
        with open(os.path.join(out, "metrics.csv")) as f:
            header = next(csv.reader(f))
        with open(os.path.join(out, "summary.json")) as f:
            keys = set(json.load(f))
        require(header == columns and keys == set(SAMPLE_METRICS) | {"samples_per_sec", "sanity"},
                f"causal CLI {label}: metrics.csv columns {header}, summary keys {sorted(keys)}")
        require(summary["goal_dist"] < 1e-4, f"causal CLI {label}: the last frame is not the goal "
                                            f"({summary['goal_dist']:.3e})")
        rows_note = f", over {n_cand} x {c['batch']} rows" if n_cand > 1 else ""
        causal_launches += counts["fused_film_block"]
        print(f"[causal] {tag} generate_causal {label} ({c['n_batches']} x {c['batch']}, chunk "
              f"{c['chunk']}, K_min {c['K_min']}, DDIM-{c['ddim_steps']}): "
              f"{summary['samples_per_sec']:.1f} samples/s (batches 1..{c['n_batches'] - 1}), "
              f"{took:.1f} s with model load and dataset; fused_film_block {per_call} a call "
              + (f"({n_chunks} chunks x {n_evals} evaluations x {n_layers} layers{rows_note})"
                 if per_call else "(Stage 1 at H * L = 48 runs plain attention)")
              + f", others 0, twin calls 0; collision {summary['collision_rate']:.4f}, goal_dist "
              f"{summary['goal_dist']:.2e}", flush=True)
    if profile:
        _causal_profile(dev, card, runs["stage1"], il_dir)

    # the pipeline, kernel path against twin path on the same draws
    kp, kp_meta = load_keypoint_model(runs["stage1"], device=dev)
    it, it_meta = load_interp_model(il_dir, device=dev)
    require(it.causal and all(layer.causal for layer in it.transformer.layers),
            "the causal checkpoint did not build the causal denoiser")
    for m in (kp, it):
        m.set_attn_policy("block")
    _nonzero_head(it)   # a few steps leave the zero-init head near zero
    pipe = generate_causal.make_causal_pipeline(
        kp, it, make_schedule(kp_meta["schedule"], kp_meta["N_train"], device=dev), T=T,
        K_min=c["K_min"], levels=it_meta["levels"], chunk=c["chunk"], ddim_steps=c["ddim_steps"],
        data_dim=BENCH["data_dim"], mask_channels=it_meta["mask_channels"])
    _, cond = _requests(64, torch.Generator().manual_seed(72), dev)
    draws = generate_causal.make_causal_draws(T, c["K_min"], c["chunk"], 64, BENCH["data_dim"],
                                              torch.Generator(device=dev).manual_seed(73))
    _set_maze_counts(zero)
    out = pipe(cond, draws=draws)
    k_launches = _maze_counts()["fused_film_block"]
    with plain_twins():
        ref = pipe(cond, draws=draws)
    err = (out - ref).abs().max().item()
    require(k_launches == n_chunks * evals("ddim") * n_layers
            and _maze_counts()["fused_film_block"] == k_launches
            and bool(torch.isfinite(out).all()) and err <= PIPE_TOL,
            f"causal pipeline B=64: launches {k_launches}, kernel path vs twins {err:.3e}")
    print(f"[causal] make_causal_pipeline B=64, block, kernels vs plain twins, same draws: max|d| "
          f"{err:.3e} (tol {PIPE_TOL}); {k_launches} block launches", flush=True)

    # Stage 1 alone: sample_keypoints at its defaults (quadratic DDIM-20) under block
    out = os.path.join(workdir, "sample_keypoints")
    sk_evals = len(make_timesteps(BENCH["n_train"], 20, "quadratic")) - 1
    plots = importlib.util.find_spec("matplotlib") is not None
    _set_maze_counts(zero)
    with count_maze_twin_calls() as twin:
        t0 = time.perf_counter()
        summary = sample_keypoints.main(
            ["--kp_ckpt", runs["stage1"], "--device", "cuda", "--attn_policy", "block", "--batch",
             str(c["batch"]), "--num_batches", str(c["n_batches"]), "--num_samples",
             str(MAZE_SAMPLES), "--cache_dir", os.path.join(workdir, "data"), "--plots",
             str(int(plots)), "--out_dir", out])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
    sk_counts = _maze_counts()
    with open(os.path.join(out, "metrics.csv")) as f:
        header = next(csv.reader(f))
    with np.load(os.path.join(out, "samples.npz")) as f:
        shapes = {k: f[k].shape for k in f.files}
    n = c["batch"] * c["n_batches"]
    require(sk_counts == dict(zero, fused_film_block=c["n_batches"] * sk_evals * n_layers)
            and twin["total"] == 0 and header == columns and set(summary) == set(SAMPLE_METRICS)
            and shapes == {"keypoints": (n, BENCH["K"], 2), "interp": (n, T, 2),
                           "idx": (n, BENCH["K"]), "gt": (n, T, 2)}
            and os.path.exists(os.path.join(out, "samples.png")) == plots,
            f"sample_keypoints: launches {sk_counts}, twin calls {twin}, columns {header}, "
            f"npz {shapes}")
    print(f"[causal] {tag} sample_keypoints (block, {c['n_batches']} x {c['batch']}, quadratic "
          f"DDIM-20): {took:.1f} s with model load and dataset; fused_film_block "
          f"{sk_evals * n_layers} a call ({sk_evals} evaluations x {n_layers} layers at "
          f"[B, {BENCH['K']}, 384]), twin calls 0; collision {summary['collision_rate']:.4f}; "
          f"samples.png {'written' if plots else 'skipped (no matplotlib)'}", flush=True)

    # the JAX package's checkpoints in the repo, through the port's reader
    for name, want_leaves in (("p1", 44), ("p2", 44), ("flow", 26)):
        path = os.path.join(ROOT, "runs", "wansynth_debug", name, "ckpt_2")
        tree = jax_checkpoint.read_tree(os.path.join(path, "params.msgpack"))
        flat = {}

        def walk(t, pre=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, f"{pre}{k}/")
                else:
                    flat[pre + k] = tuple(v.shape)

        walk(tree)
        require(len(flat) == want_leaves, f"fixture {name}: {len(flat)} leaves")
        biggest = max(flat.items(), key=lambda kv: int(np.prod(kv[1])))
        print(f"[causal] JAX checkpoint {name}: {len(flat)} leaves, "
              f"{sum(int(np.prod(s)) for s in flat.values())} values, largest {biggest[0]} "
              f"{biggest[1]}", flush=True)
    _, payload = checkpoint.load_checkpoint(os.path.join(ROOT, "runs", "wansynth_debug", "p1",
                                                         "ckpt_2"), with_opt_state=False)
    require(len(payload["params"]["lora"]) == 40 and len(payload["params"]["frame_cond"]) == 4,
            "p1 through load_checkpoint: the LoRA and projector leaves")
    print(f"[causal] launches of the causal CLI runs {causal_launches}, of sample_keypoints "
          f"{sk_counts['fused_film_block']}; {card} phase 5e wall time "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return causal_launches, sk_counts["fused_film_block"]


def _sla_work(lut, L, block):
    """(rows x keys summed over the LUT's entries, the same over its distinct
    (query block, key block) pairs): what this LUT makes the forward and dQ
    kernels, and the dK/dV kernel, multiply. Ragged last blocks counted as
    they are."""
    import torch

    M = lut.shape[1]
    rows = torch.clamp(L - torch.arange(M, device=lut.device) * block, max=block)
    keys = torch.clamp(L - lut.long() * block, min=0, max=block)
    work = rows[None, :, None] * keys
    same = lut[..., :, None] == lut[..., None, :]
    first = ~torch.tril(same, diagonal=-1).any(dim=-1)
    return int(work.sum().item()), int((work * first).sum().item())


def _dkdv_item_tiles(lut, Lq, Lk, block_m, block_n):
    """[BH, ceil(Lk / 128)]: the 64-row query tiles each work item of the SLA
    dK/dV kernel walks (128 keys; a query block is walked if its LUT row names
    the key block of either 64-key half)."""
    import torch

    BH, M, _ = lut.shape
    N = -(-Lk // block_n)
    ids = lut.long()
    named = torch.zeros((BH, M, N + 1), dtype=torch.bool, device=lut.device)
    named.scatter_(2, torch.where((ids < 0) | (ids >= N), N, ids), True)
    rows = torch.clamp(Lq - torch.arange(M, device=lut.device) * block_m, max=block_m)
    key0 = torch.arange(0, Lk, 128, device=lut.device)
    nb0 = key0 // block_n
    nb1 = torch.where(key0 + 64 < Lk, (key0 + 64) // block_n, nb0)
    walked = named[:, :, nb0] | named[:, :, nb1]
    return (walked * ((rows + 63) // 64)[None, :, None]).sum(dim=1)


def _print_dkdv_histogram(label, lut, L, block):
    tiles = _dkdv_item_tiles(lut, L, L, block, block).float()
    print(f"[wan bwd] SLA dK/dV work {label} block={block} topk={lut.shape[-1]}: query tiles "
          f"per 128-key item min {tiles.min().item():.0f} mean {tiles.mean().item():.2f} max "
          f"{tiles.max().item():.0f}, items with none {int((tiles == 0).sum().item())} of "
          f"{tiles.numel()}", flush=True)


def _lut_bias(lut, Lq, Lk, block_m, block_n, dtype):
    """The LUT as an additive [BH, Lq, Lk] mask (0 where a query block names
    the key block, -inf elsewhere): with no duplicated id in a row, attention
    under it is the SLA function, which one scaled_dot_product_attention call
    then computes. Built once, outside any timed call (a boolean mask would be
    turned into this bias inside every call)."""
    import torch

    BH, M, _ = lut.shape
    N = -(-Lk // block_n)
    named = torch.zeros((BH, M, N), dtype=torch.bool, device=lut.device)
    named.scatter_(2, lut.long(), True)
    full = named.repeat_interleave(block_m, 1)[:, :Lq].repeat_interleave(block_n, 2)[:, :, :Lk]
    bias = torch.zeros((BH, Lq, Lk), dtype=dtype, device=lut.device)
    return bias.masked_fill_(~full, float("-inf"))


def _sdpa_masked(q, k, v, bias):
    """(callable, backend name) of scaled_dot_product_attention on [1, BH, L,
    D] inputs under `bias`, with the first backend that takes it, or (None,
    why) if none does."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
    except ImportError:   # an older torch: its own choice, not named
        return (lambda: sdpa(q, k, v, attn_mask=bias)), "default"
    why = []
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return sdpa(q, k, v, attn_mask=bias)
        try:
            call()
            torch.cuda.synchronize()
            return call, backend.name
        except RuntimeError as e:
            why.append(f"{backend.name}: {str(e).splitlines()[0][:80]}")
    return None, "; ".join(why)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _device_us(evt):
    """Device time of a profiler row that is a kernel (0 for an operator row:
    its device time is its kernels')."""
    if "cuda" not in str(getattr(evt, "device_type", "")).lower():
        return 0.0
    us = getattr(evt, "self_device_time_total", None)
    return getattr(evt, "self_cuda_time_total", 0.0) if us is None else us


def _print_profile(prof, tag, what):
    """The profiler's table by operator, and the device time by kind of kernel."""
    print(f"[profile] {tag} {what}:\n"
          f"{prof.key_averages().table(sort_by='cuda_time_total', row_limit=25)}", flush=True)
    kinds = {"hand-written kernels": ("sla_fwd_kernel", "flash_fwd_kernel", "flash_bwd_",
                                      "sla_bwd_", "small_mha_",
                                      "gemm_resident_kernel", "gemm_stream_kernel",
                                      "ln_film_kernel"),
             "library GEMMs (cuBLAS)": ("gemm", "nvjet", "cutlass", "cublas", "sm90_xmma",
                                        "sm80_xmma")}
    sums, total = dict.fromkeys([*kinds, "PyTorch elementwise, reductions, copies, other"], 0.0), 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        kind = next((k for k, pats in kinds.items() if any(p in evt.key for p in pats)),
                    "PyTorch elementwise, reductions, copies, other")
        sums[kind] += us
        total += us
    for kind, us in sums.items():
        print(f"[profile] {tag} {what}: {kind}: {us / 1e3:.1f} ms "
              f"({100 * us / max(total, 1e-9):.1f}% of {total / 1e3:.1f} ms of device time)",
              flush=True)


def _wan_qkv(BH, L, D, gen, dev, Lk=None):
    import torch

    q = torch.randn((BH, L, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((BH, Lk or L, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


def _check_pair(name, label, got, want, tol, errs):
    """o and lse of a kernel against a twin; records the largest |d| of o."""
    import torch

    (o, lse), (ro, rlse) = got, want
    require(bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()),
            f"{name} {label}: non-finite output")
    err, rel = _errors(o, ro)
    _, rel_lse = _errors(lse, rlse)
    print(f"[wan kernels] {name} {label}: o max|d|={err:.3e} max|d|/max|twin|={rel:.3e}, "
          f"lse max|d|/max|twin|={rel_lse:.3e} (tol {tol})", flush=True)
    require(rel <= tol and rel_lse <= tol, f"{name} {label} disagrees: {rel:.3e} {rel_lse:.3e}")
    errs.setdefault(name, []).append(err)


# Edges of the SLA forward kernels' LUT walk beside the path shapes, as
# (BH, L, Dh, block_m, block_n, top-k ratio): blocks of 64 and 192 (the two
# 64-row halves of a 128-row work item follow different LUT rows, and the last
# 128-key tile of an id is half masked), block_m != block_n both ways, and the
# int8 kernel at head dim 64 (64-byte rows, the 64-byte swizzle).
SLA_EDGES = ((12, 1000, 128, 64, 64, 0.3), (12, 1000, 128, 192, 192, 0.3),
             (12, 1000, 64, 192, 64, 0.3), (12, 1000, 128, 128, 256, 0.5),
             (12, 1000, 64, 256, 128, 0.3), (12, 1000, 64, 256, 256, 0.5))


def phase_wan_kernels(dev):
    """The three Wan attention kernels against their twins, on bf16 inputs."""
    import torch
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
    from interpolated_diffusion_tpu_torch.kernels.block_sparse_reference import (
        block_sparse_attention_reference as sla_twin)
    from interpolated_diffusion_tpu_torch.kernels.sla import get_block_map

    gen = torch.Generator(device=dev).manual_seed(10)
    errs, cases = {}, {}
    H, D = WAN["wan_heads"], WAN["wan_dim"] // WAN["wan_heads"]
    L = WAN_ANCHORS["K"] * (WAN_ANCHORS["latent_h"] // 2) * (WAN_ANCHORS["latent_w"] // 2)
    BH, Lk_cross = WAN_B * H, WAN_TEXT_LEN + WAN_ANCHORS["K"]

    def sla_and_int8(q, k, v, bm, bn, label, ratio=WAN["sla_topk"], dup=False, keep=None):
        """Both kernels on the block map's LUT (dup: every second row repeats
        its first id in its last slot) against their twins, int8 also
        against the bf16 twin; two calls of each compared bit for bit."""
        _, lut, topk = get_block_map(q, k, ratio, bm, bn)
        if dup:
            lut[:, ::2, -1] = lut[:, ::2, 0]
            lut = lut.contiguous()
        label = f"{label} block={bm}x{bn} topk={topk}" + (" duplicated ids" if dup else "")
        d = q.shape[-1]
        ref = sla_twin(q, k, v, lut, bm, bn)
        got = bsa.block_sparse_attention_fwd(q, k, v, lut, bm, bn)
        _check_pair("block_sparse_attention", label, got, ref, ATTN_TOL, errs)
        again = bsa.block_sparse_attention_fwd(q, k, v, lut, bm, bn)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"block_sparse_attention {label}: two calls differ")
        qi, ki, qs, ks = i8.quantize_qk(q, k)
        got8 = i8.int8_attention_fwd(qi, ki, v, qs, ks, lut, bm, bn, d ** -0.5)
        _check_pair("int8_block_sparse_attention", f"{label} vs int8 twin", got8,
                    i8._torch_int8_attention(qi, ki, v, qs, ks, lut, bm, bn, d ** -0.5),
                    ATTN_TOL, errs)
        again = i8.int8_attention_fwd(qi, ki, v, qs, ks, lut, bm, bn, d ** -0.5)
        require(all(torch.equal(a, b) for a, b in zip(got8, again)),
                f"int8_block_sparse_attention {label}: two calls differ")
        _, rel = _errors(got8[0], ref[0])
        print(f"[wan kernels] int8_block_sparse_attention {label} vs bf16 SLA twin: "
              f"max|d|/max|twin|={rel:.3e} (tol {INT8_VS_BF16_TOL}); both kernels: two calls "
              f"bit-identical", flush=True)
        require(rel <= INT8_VS_BF16_TOL, f"int8 vs bf16 SLA {label} disagrees: {rel:.3e}")
        if keep:
            cases[f"sla/{keep}"] = (q, k, v, lut, bm)
            cases[f"int8/{keep}"] = (qi, ki, v, qs, ks, lut, bm)

    with torch.inference_mode():
        # the anchor path's shapes: BH = 4 x 12, L = 7800, Dh = 128
        q, k, v = _wan_qkv(BH, L, D, gen, dev)
        block = WAN["sla_block"]
        sla_and_int8(q, k, v, block, block, f"path [{BH},{L},{D}]", keep="sampler")
        sla_and_int8(q, k, v, block, block, f"path [{BH},{L},{D}]", dup=True)
        kc, vc = (torch.randn((BH, Lk_cross, D), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        for label, kk, vv, bn in (("cross", kc, vc, 640), ("self", k, v, 1024)):
            _check_pair("flash_attention", f"path {label} q [{BH},{L},{D}] k [{BH},{kk.shape[1]},{D}]",
                        bsa.flash_attention_fwd(q, kk, vv), bsa._torch_flash(q, kk, vv, D ** -0.5, bn),
                        ATTN_TOL, errs)
            cases[f"flash_{label}"] = (q, kk, vv, bn)
        # the dense kernel on as many keys as SLA's rows see (6 x 128): a
        # yardstick of what the same products cost without the LUT walk
        cases["flash_768"] = (q, k[:, :768].contiguous(), v[:, :768].contiguous(), 1024)
        # head dim 64, and shapes ragged in queries (128-row blocks) and keys
        # (128-key tiles) at both head dims
        for d, lq, lk in ((64, 1001, 389), (128, 129, 131), (64, 7800, Lk_cross)):
            fq, fk, fv = _wan_qkv(12, lq, d, gen, dev, Lk=lk)
            _check_pair("flash_attention", f"q [12,{lq},{d}] k [12,{lk},{d}]",
                        bsa.flash_attention_fwd(fq, fk, fv),
                        bsa._torch_flash(fq, fk, fv, d ** -0.5, 1024), ATTN_TOL, errs)
        del fq, fk, fv
        # a sentinel case: ring SLA's primitive on the path's shapes
        _, lut, _ = get_block_map(q[:8], k[:8], WAN["sla_topk"], block, block)
        sentinel = -(-L // block)
        lut[:, 1::3, -1] = sentinel
        lut[:, 2::7, :] = sentinel
        lut = lut.contiguous()
        got = bsa.block_sparse_attention_lse(q[:8].contiguous(), k[:8].contiguous(),
                                             v[:8].contiguous(), lut, block, block)
        _check_pair("block_sparse_attention", f"lse with sentinels [8,{L},{D}]", got,
                    sla_twin(q[:8], k[:8], v[:8], lut, block, block, kv_len=L, kv_pad_blocks=1),
                    ATTN_TOL, errs)
        rows = torch.arange(L, device=dev) // block % 7 == 2
        require(bool((got[0][:, rows] == 0).all()), "sentinel rows: o is not 0")
        # kv_len < Lk (keys kv_len..Lk hold data and must not count), a LUT
        # from the first kv_len keys with sentinels, and query blocks whose
        # every entry is a sentinel (o = 0, lse = log2(1e-30))
        kv_len = 700
        sq_, sk_, sv_ = _wan_qkv(6, 1000, D, gen, dev)
        for bm, bn in ((128, 128), (192, 64)):
            _, lut, _ = get_block_map(sq_, sk_[:, :kv_len], 0.5, bm, bn)
            sentinel = -(-kv_len // bn)
            lut[:, 1::2, -1] = sentinel
            lut[:, 2, :] = sentinel
            lut = lut.contiguous()
            got = bsa.block_sparse_attention_fwd(sq_, sk_, sv_, lut, bm, bn, kv_len=kv_len,
                                                 kv_pad_blocks=1)
            _check_pair("block_sparse_attention", f"kv_len {kv_len} of [6,1000,{D}] block={bm}x{bn} "
                        "with sentinels", got,
                        sla_twin(sq_, sk_, sv_, lut, bm, bn, kv_len=kv_len, kv_pad_blocks=1),
                        ATTN_TOL, errs)
            rows = slice(2 * bm, 3 * bm)
            require(bool((got[0][:, rows] == 0).all()) and
                    (got[1][:, rows] - math.log2(1e-30)).abs().max().item() <= 1e-4,
                    "all-sentinel rows: o is not 0 or lse is not log2(1e-30)")
        del sq_, sk_, sv_
        # the LUT walk's edges beside the path shapes
        for bh, l, d, bm, bn, ratio in SLA_EDGES:
            eq, ek, ev = _wan_qkv(bh, l, d, gen, dev)
            sla_and_int8(eq, ek, ev, bm, bn, f"[{bh},{l},{d}]", ratio=ratio)
        del eq, ek, ev, q, k, v, kc, vc
        # the trainer's shape: BH = 2 x 12, L = 7800, block 256 (topk 3 of 31)
        q, k, v = _wan_qkv(24, L, D, gen, dev)
        sla_and_int8(q, k, v, 256, 256, f"trainer [24,{L},{D}]", keep="trainer")
        # scripts/bench_wan33k.py geometry: BH 12, L 32760, Dh 128, topk 0.1
        bh33, l33 = WAN_33K
        q, k, v = _wan_qkv(bh33, l33, D, gen, dev)
        for block in (128, 256):
            sla_and_int8(q, k, v, block, block, f"33k [{bh33},{l33},{D}]")
        o, lse = bsa.flash_attention_fwd(q, k, v)   # the twin's logits would be 51 GB:
        rows = slice(0, 2048)                       # compare the first 2048 rows
        _check_pair("flash_attention", f"33k rows 0:2048 of [{bh33},{l33},{D}]",
                    (o[:, rows], lse[:, rows]),
                    bsa._torch_flash(q[:, rows].contiguous(), k, v, D ** -0.5, 1024),
                    ATTN_TOL, errs)
        del q, k, v, o, lse
    torch.cuda.synchronize()
    return errs, cases


def _train_counts():
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8

    return (bsa.block_sparse_attention.launches, i8.int8_block_sparse_attention.launches,
            bsa.flash_attention.launches, bsa.sla_bwd_dq.launches, bsa.sla_bwd_dkdv.launches,
            bsa.flash_bwd_dq.launches, bsa.flash_bwd_dkdv.launches)


def _set_train_counts(values):
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8

    (bsa.block_sparse_attention.launches, i8.int8_block_sparse_attention.launches,
     bsa.flash_attention.launches, bsa.sla_bwd_dq.launches, bsa.sla_bwd_dkdv.launches,
     bsa.flash_bwd_dq.launches, bsa.flash_bwd_dkdv.launches) = values


def _wan_counts():
    """The three forward kernels' launch counts."""
    return _train_counts()[:3]


@contextlib.contextmanager
def count_twin_calls():
    """Count calls of the Wan kernels' plain twins (none on the kernel path)."""
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8

    calls = [0]
    saved = [(bsa, "block_sparse_attention_reference"), (bsa, "_torch_flash"),
             (bsa, "_torch_sla_bwd"), (bsa, "_torch_flash_bwd"), (i8, "_torch_int8_attention"),
             (i8, "block_sparse_attention_reference")]
    originals = [getattr(m, n) for m, n in saved]

    def counting(fn):
        def wrapped(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        return wrapped

    for (m, n), fn in zip(saved, originals):
        setattr(m, n, counting(fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(saved, originals):
            setattr(m, n, fn)


@contextlib.contextmanager
def wan_plain_twins():
    """Route WanDiT's attention kernels to their plain twins (on CUDA
    tensors), forward and backward."""
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
    from interpolated_diffusion_tpu_torch.kernels import sla
    from interpolated_diffusion_tpu_torch.models import wan_dit

    saved = sla.block_sparse_attention, sla.int8_block_sparse_attention, wan_dit.flash_attention
    sla.block_sparse_attention = bsa.block_sparse_attention_twin
    sla.int8_block_sparse_attention = i8.int8_block_sparse_attention_twin
    wan_dit.flash_attention = bsa.flash_attention_twin
    try:
        yield
    finally:
        sla.block_sparse_attention, sla.int8_block_sparse_attention, wan_dit.flash_attention = saved


@contextlib.contextmanager
def sla_luts(luts, replay=False):
    """Record into `luts`, in call order, the LUT (top-k key blocks of each
    query block) of every SLA call; with `replay`, hand those LUTs back in the
    same order instead of the path's own. Yields [calls, rows, rows whose own
    choice of blocks differs from the recorded one]."""
    from interpolated_diffusion_tpu_torch.kernels import sla

    own, stats = sla.get_block_map, [0, 0, 0]

    def get_block_map(*a, **kw):
        sparse_map, lut, topk = own(*a, **kw)
        if not replay:
            luts.append(lut)
            return sparse_map, lut, topk
        require(stats[0] < len(luts), "the twin path makes more SLA calls than the kernel path")
        kept = luts[stats[0]]
        stats[0] += 1
        stats[1] += lut.shape[0] * lut.shape[1]
        stats[2] += int((lut.sort(dim=-1).values != kept.sort(dim=-1).values).any(-1).sum())
        return None, kept, topk

    sla.get_block_map = get_block_map
    try:
        yield stats
    finally:
        sla.get_block_map = own


def phase_wan_main(dev):
    import types

    import torch
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample.wan_anchors import AnchorConfig, make_anchor_sampler
    from interpolated_diffusion_tpu_torch.train.wansynth_common import build_wan

    t0 = time.perf_counter()
    # zero_init_scale: LoRA B, the SLA projection and the frame-cond output
    # layer are non-zero, so that every branch of the path acts
    model, fc = build_wan(types.SimpleNamespace(**WAN), bf16=True, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(11),
                          zero_init_scale=1e-2)
    n_params = sum(p.numel() for p in model.parameters()) + sum(p.numel() for p in fc.parameters())
    print(f"[wan main] WanDiT ({WAN_SAMPLER_LAYERS} of 30 layers, full width) + "
          f"FrameCondProjector: {n_params / 1e9:.3f} B parameters (bf16), "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = AnchorConfig(**WAN_ANCHORS)
    sampler = make_anchor_sampler(cfg, model, fc, make_schedule(cfg.schedule, cfg.n_train,
                                                                device=dev))
    gen = torch.Generator(device=dev).manual_seed(12)
    hp, wp = cfg.spatial
    z_init = torch.randn((WAN_B, cfg.K, hp * wp, cfg.latent_c * cfg.patch_size ** 2),
                         generator=gen, device=dev)
    idx = torch.stack([torch.sort(torch.randperm(cfg.T, device=dev, generator=gen)[:cfg.K]).values
                       for _ in range(WAN_B)])
    text = torch.randn((WAN_B, WAN_TEXT_LEN, WAN["text_dim"]), generator=gen, device=dev)
    inputs = (z_init, idx, text)
    want_shape = (WAN_B, cfg.K, cfg.latent_c, cfg.latent_h, cfg.latent_w)

    _set_train_counts((0,) * len(TRAIN_KERNELS))
    outs = {}
    for mode in WAN_MODES:
        model.set_attn_mode(mode)
        before = _wan_counts()
        with count_twin_calls() as twin_calls:
            t0 = time.perf_counter()
            out = sampler(*inputs)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
        delta = tuple(a - b for a, b in zip(_wan_counts(), before))
        require(tuple(out.shape) == want_shape and out.dtype == torch.float32,
                f"wan {mode}: output {tuple(out.shape)} {out.dtype}, expected {want_shape}")
        require(bool(torch.isfinite(out).all()), f"wan {mode}: non-finite anchors")
        require(delta == WAN_EXPECT[mode] and twin_calls[0] == 0,
                f"wan {mode}: launches {dict(zip(WAN_KERNELS, delta))}, twin calls "
                f"{twin_calls[0]}, expected {dict(zip(WAN_KERNELS, WAN_EXPECT[mode]))} and 0")
        print(f"[wan main] attn_mode={mode}: {took:.3f} s (first call of the mode), launches "
              f"{dict(zip(WAN_KERNELS, delta))}, twin calls 0; anchors {tuple(out.shape)} "
              f"finite, max|anchor|={out.abs().max().item():.3e}", flush=True)
        outs[mode] = out
    launches = dict(zip(WAN_KERNELS, _wan_counts()))
    print(f"[wan main] launches in the main-path run: {launches}", flush=True)

    for mode in WAN_MODES:   # kernel path vs plain-twin path, same weights and inputs
        model.set_attn_mode(mode)
        with wan_plain_twins():
            ref = sampler(*inputs)
        err, rel = _errors(outs[mode], ref)
        print(f"[wan main] attn_mode={mode} kernels vs plain twins: max|d|={err:.3e} "
              f"max|d|/max|twin|={rel:.3e} (tol {WAN_TOL})", flush=True)
        require(rel <= WAN_TOL, f"wan {mode}: kernel path disagrees with twin path ({rel:.3e})")
    _, rel = _errors(outs["sage_sla"], outs["sla"])
    print(f"[wan main] sage_sla vs sla anchors (int8 vs bf16 QK^T): max|d|/max|sla|={rel:.3e}",
          flush=True)
    return model, sampler, inputs, launches


def phase_wan_kernel_timings(card, cases):
    import torch
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
    from interpolated_diffusion_tpu_torch.kernels.block_sparse_reference import (
        block_sparse_attention_reference)

    tag = f"[{card}]"
    times, bounds = {}, {}
    saved = _train_counts()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.inference_mode():
        plan, library, lib_names = [], {}, {}
        # rows 4 and 8 at the sampler's shape (block 128) and the trainer's
        # (block 256); the JSON line holds the sampler's, the trainer's beside.
        # Row 4's library call: scaled_dot_product_attention under the LUT as
        # a mask (these LUTs hold no duplicated id); row 8 has none, since no
        # PyTorch call takes int8 Q K^T.
        for where, suffix in (("sampler", ""), ("trainer", "/train")):
            q, k, v, lut, block = cases[f"sla/{where}"]
            qi, ki, vi, qs, ks, lut8, _ = cases[f"int8/{where}"]
            BH, L, D = q.shape
            scale = D ** -0.5
            shape = f"[{BH},{L},{D}] block {block} topk {lut.shape[-1]}"
            plan += [
                (f"block_sparse_attention{suffix}", shape,
                 lambda q=q, k=k, v=v, lut=lut, b=block: bsa.block_sparse_attention_fwd(
                     q, k, v, lut, b, b),
                 lambda q=q, k=k, v=v, lut=lut, b=block: block_sparse_attention_reference(
                     q, k, v, lut, b, b)),
                (f"int8_block_sparse_attention{suffix}", f"{shape}, pre-quantized q/k",
                 lambda a=(qi, ki, vi, qs, ks, lut8, block, block, scale): i8.int8_attention_fwd(*a),
                 lambda a=(qi, ki, vi, qs, ks, lut8, block, block, scale):
                     i8._torch_int8_attention(*a))]
            bias = _lut_bias(lut, L, L, block, block, q.dtype)[None]
            fn, backend = _sdpa_masked(q[None], k[None], v[None], bias)
            name = f"block_sparse_attention{suffix}"
            if fn is not None:
                library[name] = fn
            lib_names[name] = backend
            entries, _ = _sla_work(lut, L, block)
            o_lse = _nbytes(q) + 4 * BH * L   # o like q (bf16), lse f32 per row
            bounds[f"block_sparse_attention{suffix}"] = bound_ms(
                _nbytes(q, k, v, lut) + o_lse, 4.0 * entries * D)
            # int8 Q K^T at the int8 rate, bf16 P V at the bf16 rate
            bounds[f"int8_block_sparse_attention{suffix}"] = bound_ms(
                _nbytes(qi, ki, vi, qs, ks, lut8) + o_lse, 2.0 * entries * D, 2.0 * entries * D)
        for label in ("cross", "self", "768"):
            fq, fk, fv, bn = cases[f"flash_{label}"]
            name = f"flash_attention/{label}"
            plan.append((name, f"q [{fq.shape[0]},{fq.shape[1]},{fq.shape[2]}] k {fk.shape[1]} rows",
                         lambda fq=fq, fk=fk, fv=fv: bsa.flash_attention_fwd(fq, fk, fv),
                         lambda fq=fq, fk=fk, fv=fv, bn=bn: bsa._torch_flash(
                             fq, fk, fv, fq.shape[-1] ** -0.5, bn)))
            library[name] = lambda fq=fq, fk=fk, fv=fv: sdpa(fq[None], fk[None], fv[None])
            BH, L, D = fq.shape
            bounds[name] = bound_ms(_nbytes(fq, fk, fv, fq) + 4 * BH * L,
                                    4.0 * BH * L * fk.shape[1] * D)
        for name, shape, kernel, twin in plan:
            k_ms = _time_ms(kernel, iters=10, warmup=2)
            p_ms = _time_ms(twin, iters=3, warmup=1)
            lib_ms = _time_ms(library[name], iters=10, warmup=2) if name in library else None
            how = f", {lib_names[name]} backend, LUT as a mask" if name in lib_names else ""
            lib = (f"library (scaled_dot_product_attention{how}) {lib_ms:.4f} ms" if lib_ms
                   else "library: none" + (f" ({lib_names[name]})" if name in lib_names
                                           else " (no PyTorch call takes int8 Q K^T)"
                                           if name.startswith("int8") else ""))
            was = (f", before the redesign {BEFORE_REDESIGN_MS[name]:.4f} ms"
                   if name in BEFORE_REDESIGN_MS else "")
            # rows 4 and 8 also by graph replay: each call's host work (three
            # tensor maps, the checks) can pace a loop of 0.3 ms launches
            graph = ("" if name.startswith("flash")
                     else f" (by graph replay {_graph_ms(kernel, launches=20):.4f})")
            print(f"[timing] {tag} {name} {shape}: kernel {k_ms:.4f} ms{graph}, bound "
                  f"{bounds[name][0]:.4f} ms ({bounds[name][1]}), plain twin {p_ms:.4f} ms, {lib}"
                  f"{was}", flush=True)
            times[name] = (k_ms, p_ms, lib_ms)
        bounds["flash_attention"] = bounds["flash_attention/cross"]
        times["bounds"] = bounds
        del library, bias
    _set_train_counts(saved)
    return times


def phase_wan_sampler_timings(card, model, sampler, inputs, profile):
    """Sampler samples/s per mode, one call per run, kernels / twins in turns."""
    import torch

    tag = f"[{card}]"
    for mode in WAN_MODES:
        model.set_attn_mode(mode)
        runs = {"kernels": [], "plain twins": []}
        for path in ("kernels", "plain twins", "plain twins", "kernels"):
            with wan_plain_twins() if path == "plain twins" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sampler(*inputs)
                torch.cuda.synchronize()
                runs[path].append(WAN_B / (time.perf_counter() - t0))
        for path, vals in runs.items():
            print(f"[timing] {tag} wan sampler attn_mode={mode} B={WAN_B} {path}: "
                  f"{sum(vals) / len(vals):.4f} samples/s (calls: "
                  f"{', '.join(f'{x:.4f}' for x in vals)})", flush=True)
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        model.set_attn_mode("sla")
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sampler(*inputs)
            torch.cuda.synchronize()
        _print_profile(prof, tag, f"one sla-mode sampler call (B={WAN_B})")


def phase_wan_bwd_kernels(dev, card):
    """The four backward kernels against their twins at the trainer's shapes,
    then their times, the twins' and the library's."""
    import torch
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels.sla import get_block_map

    gen = torch.Generator(device=dev).manual_seed(20)
    tag = f"[{card}]"
    BH, L, D, Lk_cross = 2 * 12, 7800, 128, 512 + 5
    scale = D ** -0.5
    errs, out = {}, {}
    saved = _train_counts()

    def check(names, label, got, want):
        for name, tensor, a, b in zip(names, ("dq", "dk", "dv"), got, want):
            require(a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()),
                    f"{name} {label}: {tensor} not finite bf16")
            err, rel = _errors(a, b)
            print(f"[wan bwd] {name} {label}: {tensor} max|d|={err:.3e} "
                  f"max|d|/max|twin|={rel:.3e} (tol {BWD_TOL})", flush=True)
            require(rel <= BWD_TOL, f"{name} {label}: {tensor} disagrees ({rel:.3e})")
            errs[name] = max(errs.get(name, 0.0), err)

    sla_names = ("sla_bwd_dq", "sla_bwd_dkdv", "sla_bwd_dkdv")

    def sla_case(label, q, k, v, do, lut, bm, bn, unnamed=None):
        """Both SLA kernels against the twin and two calls bit for bit; with
        `unnamed` (a key block that no LUT row names) its dk and dv exactly 0."""
        label = f"{label} block={bm}x{bn} topk={lut.shape[-1]}"
        o, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, bm, bn)
        got = bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, bm, bn)
        check(sla_names, label, got,
              bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, bm, bn, twin=True))
        again = bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, bm, bn)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"SLA backward {label}: two calls differ")
        note = "two calls bit-identical"
        if unnamed is not None:
            keys = slice(unnamed * bn, (unnamed + 1) * bn)
            require(all(bool((t[:, keys] == 0).all()) for t in got[1:]),
                    f"SLA backward {label}: dk / dv of unnamed key block {unnamed} not 0")
            note += f", dk and dv of the unnamed key block {unnamed} exactly 0"
        print(f"[wan bwd] SLA backward {label}: {note}", flush=True)
        return o, lse

    with torch.no_grad():
        q, k, v = _wan_qkv(BH, L, D, gen, dev)
        do = torch.randn((BH, L, D), generator=gen, device=dev).to(torch.bfloat16)
        for block, dup in ((256, False), (128, False), (256, True)):
            _, lut, topk = get_block_map(q, k, 0.1, block, block)
            if dup:   # every second row repeats its first id in its last slot
                lut[:, ::2, -1] = lut[:, ::2, 0]
                lut = lut.contiguous()
            o, lse = sla_case(f"[{BH},{L},{D}]" + (" duplicated ids" if dup else ""),
                              q, k, v, do, lut, block, block)
            if not dup:
                _print_dkdv_histogram(f"trainer [{BH},{L},{D}]", lut, L, block)
            if block == 256 and not dup:
                out["sla"] = (lut, o, lse, block)
        # a key block that no query block names (5 becomes 6 wherever it
        # appears): the kernel skips nothing it must write
        lut = out["sla"][0]
        sla_case(f"[{BH},{L},{D}] key block 5 unnamed", q, k, v, do,
                 torch.where(lut == 5, 6, lut).contiguous(), 256, 256, unnamed=5)
        # the LUT walks' edges beside the path shapes (SLA_EDGES): blocks of
        # 64 and 192, block_m != block_n both ways, head dim 64; the last key
        # block unnamed
        for bh, l, d, bm, bn, ratio in SLA_EDGES:
            eq, ek, ev = _wan_qkv(bh, l, d, gen, dev)
            edo = torch.randn((bh, l, d), generator=gen, device=dev).to(torch.bfloat16)
            _, lut, _ = get_block_map(eq, ek, ratio, bm, bn)
            last = -(-l // bn) - 1
            sla_case(f"[{bh},{l},{d}]", eq, ek, ev, edo, lut, bm, bn)
            sla_case(f"[{bh},{l},{d}] last key block unnamed", eq, ek, ev, edo,
                     torch.where(lut == last, 0, lut).contiguous(), bm, bn, unnamed=last)
        del eq, ek, ev, edo
        kc, vc = (torch.randn((BH, Lk_cross, D), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        flash_names = ("flash_bwd_dq", "flash_bwd_dkdv", "flash_bwd_dkdv")
        for label, kk, vv in (("cross", kc, vc), ("self", k, v)):
            o, lse = bsa.flash_attention_fwd(q, kk, vv)
            got = bsa.flash_attention_bwd(q, kk, vv, o, lse, do)
            want = bsa.flash_attention_bwd(q, kk, vv, o, lse, do, twin=True)
            check(flash_names, f"{label} q [{BH},{L},{D}] k {kk.shape[1]} rows", got, want)
            out[label] = (kk, vv, o, lse)
            if label == "cross":   # deterministic: every output row has one writer
                again = bsa.flash_attention_bwd(q, kk, vv, o, lse, do)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                print(f"[wan bwd] flash backward {label}: two calls bit-identical: {same}",
                      flush=True)
                require(same, "flash backward: two calls differ")
        for bh, lq, lk, d in FLASH_BWD_EXTRA:
            fq, fk, fv = _wan_qkv(bh, lq, d, gen, dev, Lk=lk)
            fdo = torch.randn((bh, lq, d), generator=gen, device=dev).to(torch.bfloat16)
            o, lse = bsa.flash_attention_fwd(fq, fk, fv)
            got = bsa.flash_attention_bwd(fq, fk, fv, o, lse, fdo)
            want = bsa.flash_attention_bwd(fq, fk, fv, o, lse, fdo, twin=True)
            check(flash_names, f"q [{bh},{lq},{d}] k {lk} rows", got, want)
        del fq, fk, fv, fdo
        # scripts/bench_wan33k.py geometry: BH 12, L 32760, Dh 128, top-k 0.1
        bh33, l33 = WAN_33K
        sq, sk, sv = _wan_qkv(bh33, l33, D, gen, dev)
        sdo = torch.randn((bh33, l33, D), generator=gen, device=dev).to(torch.bfloat16)
        for block in (128, 256):
            _, lut, _ = get_block_map(sq, sk, WAN["sla_topk"], block, block)
            sla_case(f"33k [{bh33},{l33},{D}]", sq, sk, sv, sdo, lut, block, block)
            _print_dkdv_histogram(f"33k [{bh33},{l33},{D}]", lut, l33, block)
        del sq, sk, sv, sdo
        torch.cuda.synchronize()

        # times at the same shapes: each kernel alone, the twin (dq, dk, dv at once)
        times, bounds = {}, {}
        lut, o, lse, block = out["sla"]
        delta = bsa.attention_delta(o, do)
        entries, pairs = _sla_work(lut, L, block)
        rows = _nbytes(lse, delta)
        kernels = {"sla_bwd_dq": lambda: bsa.sla_bwd_dq(
                       q, k, v, lut, do, lse, delta, block, block, scale),
                   "sla_bwd_dkdv": lambda: bsa.sla_bwd_dkdv(
                       q, k, v, lut, do, lse, delta, block, block, scale)}
        for name, fn in kernels.items():
            times[name] = _time_ms(fn, iters=10, warmup=2)
            times[f"{name}_graph"] = _graph_ms(fn, launches=20)
        times["sla_twin"] = _time_ms(lambda: bsa.block_sparse_attention_bwd(
            q, k, v, lut, o, lse, do, block, block, twin=True), iters=2, warmup=1)
        # what the skew of the LUT's inverse costs dK/dV: the same shapes on a
        # LUT that names every key block equally often (row m: m + j M / topk)
        M, topk = lut.shape[1:]
        rows_m = torch.arange(M, device=dev)[:, None] + (M // topk) * torch.arange(topk, device=dev)
        even = (rows_m % M).to(torch.int32).expand(BH, M, topk).contiguous()
        o_e, lse_e = bsa.block_sparse_attention_fwd(q, k, v, even, block, block)
        delta_e = bsa.attention_delta(o_e, do)
        times["sla_bwd_dkdv_even"] = _graph_ms(lambda: bsa.sla_bwd_dkdv(
            q, k, v, even, do, lse_e, delta_e, block, block, scale), launches=20)
        work = [_dkdv_item_tiles(x, L, L, block, block).float().mean().item() for x in (lut, even)]
        print(f"[timing] {tag} SLA dK/dV by graph replay: the path's LUT "
              f"{times['sla_bwd_dkdv_graph']:.4f} ms at {work[0]:.2f} query tiles an item, a "
              f"LUT naming every key block equally often {times['sla_bwd_dkdv_even']:.4f} ms "
              f"at {work[1]:.2f}: at equal work the skew costs "
              f"{100 * (times['sla_bwd_dkdv_graph'] / work[0] / (times['sla_bwd_dkdv_even'] / work[1]) - 1):.1f}%",
              flush=True)
        del o_e, lse_e, delta_e
        # dQ: S, dP, dS K (3 products); dK/dV: S^T, P^T dO, dP^T, dS^T Q (4)
        bounds["sla_bwd_dq"] = bound_ms(_nbytes(q, k, v, do, lut) + rows + _nbytes(q),
                                        6.0 * entries * D)
        bounds["sla_bwd_dkdv"] = bound_ms(_nbytes(q, k, v, do, lut) + rows + _nbytes(k, v),
                                          8.0 * pairs * D)
    # the library's backward: autograd through scaled_dot_product_attention
    # under the LUT as a mask (this LUT holds no duplicated id), dq, dk, dv in
    # one call
    leaves = [t[None].clone().requires_grad_() for t in (q, k, v)]
    bias = _lut_bias(lut, L, L, block, block, q.dtype)[None]
    fn, backend = _sdpa_masked(*leaves, bias)
    if fn is not None:
        y = fn()
        times["sla_library"] = _time_ms(
            lambda: torch.autograd.grad(y, leaves, do[None], retain_graph=True), iters=5, warmup=1)
        lib = (f"library (scaled_dot_product_attention, {backend} backend, LUT as a mask) "
               f"backward {times['sla_library']:.4f} ms")
        del y
    else:
        lib = f"library: none ({backend})"
    del leaves, bias, fn
    print(f"[timing] {tag} SLA backward [{BH},{L},{D}] block {block} topk {lut.shape[-1]}: "
          f"dQ kernel {times['sla_bwd_dq']:.4f} ms (by graph replay "
          f"{times['sla_bwd_dq_graph']:.4f}; bound {bounds['sla_bwd_dq'][0]:.4f} ms, "
          f"{bounds['sla_bwd_dq'][1]}; before the redesign {BEFORE_REDESIGN_MS['sla_bwd_dq']:.4f} "
          f"ms), dK/dV kernel {times['sla_bwd_dkdv']:.4f} ms (by graph replay "
          f"{times['sla_bwd_dkdv_graph']:.4f}; bound {bounds['sla_bwd_dkdv'][0]:.4f} ms, "
          f"{bounds['sla_bwd_dkdv'][1]}; before the redesign "
          f"{BEFORE_REDESIGN_MS['sla_bwd_dkdv']:.4f} ms), plain twin (dq, dk, dv) "
          f"{times['sla_twin']:.4f} ms, {lib}", flush=True)
    for label in ("cross", "self"):
        kk, vv, o, lse = out[label]
        with torch.no_grad():
            delta = bsa.attention_delta(o, do)
            t_dq = _time_ms(lambda: bsa.flash_bwd_dq(q, kk, vv, do, lse, delta, scale),
                            iters=5, warmup=1)
            t_dkdv = _time_ms(lambda: bsa.flash_bwd_dkdv(q, kk, vv, do, lse, delta, scale),
                              iters=5, warmup=1)
            t_twin = _time_ms(lambda: bsa.flash_attention_bwd(q, kk, vv, o, lse, do, twin=True),
                              iters=2, warmup=1)
        # the library's backward: autograd through scaled_dot_product_attention
        # (dq, dk, dv in one call), and its forward + backward together
        leaves = [t[None].clone().requires_grad_() for t in (q, kk, vv)]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        y = sdpa(*leaves)
        t_lib_bwd = _time_ms(lambda: torch.autograd.grad(y, leaves, do[None], retain_graph=True),
                             iters=5, warmup=1)

        def fwd_bwd():
            torch.autograd.grad(sdpa(*leaves), leaves, do[None])

        t_lib_both = _time_ms(fwd_bwd, iters=5, warmup=1)
        del y, leaves
        Lk = kk.shape[1]
        rows = 8 * BH * L   # lse and delta, f32 per query row
        b_dq = bound_ms(_nbytes(q, kk, vv, do) + rows + _nbytes(q), 6.0 * BH * L * Lk * D)
        b_dkdv = bound_ms(_nbytes(q, kk, vv, do) + rows + _nbytes(kk, vv), 8.0 * BH * L * Lk * D)
        print(f"[timing] {tag} flash backward {label} q [{BH},{L},{D}] k {Lk} rows: dQ kernel "
              f"{t_dq:.4f} ms (bound {b_dq[0]:.4f} ms, {b_dq[1]}; before the redesign "
              f"{BEFORE_REDESIGN_MS[f'flash_bwd_dq/{label}']:.4f} ms), dK/dV kernel "
              f"{t_dkdv:.4f} ms (bound {b_dkdv[0]:.4f} ms, {b_dkdv[1]}; before the redesign "
              f"{BEFORE_REDESIGN_MS[f'flash_bwd_dkdv/{label}']:.4f} ms), plain twin (dq, dk, dv) "
              f"{t_twin:.4f} ms, library (scaled_dot_product_attention) backward "
              f"{t_lib_bwd:.4f} ms, forward + backward {t_lib_both:.4f} ms", flush=True)
        if label == "cross":   # the shape every training mode gives the flash kernels
            times.update(flash_bwd_dq=t_dq, flash_bwd_dkdv=t_dkdv, flash_twin=t_twin,
                         flash_library=t_lib_bwd)
            bounds.update(flash_bwd_dq=b_dq, flash_bwd_dkdv=b_dkdv)
        else:                  # the dense mode's self-attention shape
            times.update(flash_bwd_dq_self=t_dq, flash_bwd_dkdv_self=t_dkdv,
                         flash_twin_self=t_twin, flash_library_self=t_lib_bwd)
            bounds.update(flash_bwd_dq_self=b_dq, flash_bwd_dkdv_self=b_dkdv)
    _set_train_counts(saved)
    return errs, times, bounds


def phase_wan_train(dev, card, profile):
    """Phase-1 LoRA training at the trainer's defaults, three attention modes."""
    import torch
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as trainer
    from interpolated_diffusion_tpu_torch.train.state import flatten_dict, tree_leaves
    from interpolated_diffusion_tpu_torch.train.wansynth_common import (build_wan,
                                                                        make_wansynth_loader)
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.utils.prefetch import pinned_put

    tag = f"[{card}]"
    args = trainer.build_argparser().parse_args(["--num_samples", "16", "--seed", "21"])
    require((args.wan_dim, args.wan_layers, args.wan_heads, args.wan_ffn, args.batch, args.K,
             args.lora_rank, args.use_remat, args.bf16, args.attn_mode) ==
            (1536, TRAIN_LAYERS, 12, 8960, 2, 5, 8, 1, 1, "sla"), "trainer defaults changed")
    t0 = time.perf_counter()
    # zero_init_scale: LoRA B, the SLA projection and the frame-cond output are
    # non-zero, so that no trainable leaf's gradient is identically zero
    wan, fc = build_wan(args, True, device=dev, zero_init_scale=1e-2,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))
    loader = make_wansynth_loader(args, args.seed)
    put = pinned_put(dev, keys=("latents", "text_embed"))
    schedule = make_schedule(args.schedule, args.N_train, device=dev)
    print(f"[wan train] WanDiT {args.wan_dim}d x {args.wan_layers} layers + FrameCondProjector "
          f"built in {time.perf_counter() - t0:.1f} s; batch {args.batch}, "
          f"L = {args.K * (args.latent_h // 2) * (args.latent_w // 2)}, remat on", flush=True)
    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    results = {}
    for mode in ("sla", "sage_sla", "dense"):
        args.attn_mode = mode
        wan.set_attn_mode(mode)
        state, base, train_step, _, _ = trainer.make_trainer(args, dev, wan, fc)
        names = list(flatten_dict(state.params))
        leaves = tree_leaves(state.params)
        require(all(p.dtype == torch.float32 and p.requires_grad for p in leaves)
                and not any(p.requires_grad for p in base.values()),
                f"train {mode}: trainable / frozen partition is wrong")
        batch = put(next(loader))
        torch.cuda.synchronize()
        N = (args.latent_h // 2) * (args.latent_w // 2)
        draws = trainer.draw_phase1(torch.Generator(device=dev).manual_seed(22), args,
                                    args.batch, (args.batch, args.K, N, args.latent_c * 4))

        # one loss + gradient from the same state, batch and draws on each path
        def loss_and_grads():
            loss, _ = trainer.phase1_loss(wan, fc, args, schedule, batch, draws)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        # SLA's LUT is a discrete choice made in plain PyTorch on both paths: a
        # one-ulp difference upstream can flip a marginal block on one path only,
        # and the two then attend to other keys. The twin path is held to the
        # kernels on the kernel path's LUTs; its run on its own LUTs is printed.
        luts = []
        with sla_luts(luts):
            loss_k, grads_k = loss_and_grads()
        if luts:
            with wan_plain_twins():
                _, grads_own = loss_and_grads()
            own = max((_errors(a, b)[1], n) for n, a, b in zip(names, grads_k, grads_own))
            del grads_own
        with wan_plain_twins(), sla_luts(luts, replay=True) as lut_stats:
            loss_t, grads_t = loss_and_grads()
        require(lut_stats[0] == len(luts), f"train {mode}: {lut_stats[0]} SLA calls on the twin "
                f"path, {len(luts)} on the kernel path")
        if luts:
            print(f"[wan train] attn_mode={mode}: {len(luts)} SLA calls; the twin path's own "
                  f"LUTs differ from the kernel path's in {lut_stats[2]} of {lut_stats[1]} rows; "
                  f"on its own LUTs its worst gradient max|d|/max|twin|={own[0]:.3e} at {own[1]}",
                  flush=True)
        del luts
        rel_loss = abs(loss_k.item() - loss_t.item()) / abs(loss_t.item())
        worst = max((_errors(a, b)[1], n) for n, a, b in zip(names, grads_k, grads_t))
        zero = [n for n, g in zip(names, grads_t) if not bool(g.abs().max() > 0)]
        print(f"[wan train] attn_mode={mode} kernels vs plain twins, same state / batch / "
              f"draws, same LUTs: loss {loss_k.item():.6f} vs {loss_t.item():.6f} (rel {rel_loss:.3e}, tol "
              f"{TRAIN_LOSS_TOL}); {len(names)} trainable leaves, worst gradient "
              f"max|d|/max|twin|={worst[0]:.3e} at {worst[1]} (tol {TRAIN_GRAD_TOL})",
              flush=True)
        require(not zero, f"train {mode}: identically zero gradients at {zero[:3]}")
        require(rel_loss <= TRAIN_LOSS_TOL, f"train {mode}: loss disagrees ({rel_loss:.3e})")
        require(worst[0] <= TRAIN_GRAD_TOL,
                f"train {mode}: gradient of {worst[1]} disagrees ({worst[0]:.3e})")
        del grads_k, grads_t

        # the trainer's own step: counts set to 0 just before, read just after
        before_leaves = [p.detach().clone() for p in leaves]
        before_base = {n: p.detach().clone() for n, p in base.items()}
        rng = torch.Generator(device=dev).manual_seed(23)
        warm, timed = TRAIN_STEPS[mode]
        torch.cuda.reset_peak_memory_stats()
        _set_train_counts((0,) * len(TRAIN_KERNELS))
        step_s = []
        with count_twin_calls() as twin_calls:
            for i in range(warm + timed):
                nxt = put(next(loader))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = train_step(state, base, batch, rng)
                loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                require(loss == loss and abs(loss) != float("inf") and gnorm == gnorm
                        and abs(gnorm) != float("inf") and gnorm > 0,
                        f"train {mode} step {i}: loss {loss} grad norm {gnorm}")
                print(f"[wan train] attn_mode={mode} step {i}: loss {loss:.4f} grad_norm "
                      f"{gnorm:.4e} {step_s[-1]:.3f} s", flush=True)
                batch = nxt
        counts = _train_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = tuple(c * (warm + timed) for c in TRAIN_EXPECT[mode])
        require(counts == want and twin_calls[0] == 0,
                f"train {mode}: launches {dict(zip(TRAIN_KERNELS, counts))}, twin calls "
                f"{twin_calls[0]}, expected {dict(zip(TRAIN_KERNELS, want))} and 0")
        same = [n for n, a, b in zip(names, before_leaves, leaves) if torch.equal(a, b)]
        require(not same, f"train {mode}: trainable leaves unchanged: {same[:3]}")
        moved = [n for n, p in base.items() if not torch.equal(before_base[n], p)]
        require(not moved, f"train {mode}: frozen base changed: {moved[:3]}")
        require(all(bool(torch.isfinite(p).all()) for p in leaves),
                f"train {mode}: non-finite parameters")
        timed_s = step_s[warm:]
        per = sum(timed_s) / len(timed_s)
        print(f"[wan train] {tag} attn_mode={mode}: {per:.3f} s/step, {args.batch / per:.3f} "
              f"samples/s ({len(timed_s)} timed step(s) after {warm} warm-up), peak memory "
              f"{peak:.2f} GiB; launches per step {dict(zip(TRAIN_KERNELS, TRAIN_EXPECT[mode]))}, "
              f"twin calls 0; all {len(names)} trainable leaves changed, frozen base "
              f"({len(base)} tensors) bit-identical", flush=True)
        for name, c in zip(TRAIN_KERNELS, counts):
            launches[name] += c
        results[mode] = per
        del before_leaves, before_base
        if profile and mode == "sla":
            from torch.profiler import ProfilerActivity, profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, _ = train_step(state, base, batch, rng)
                torch.cuda.synchronize()
            _print_profile(prof, tag, f"one sla-mode training step (batch {args.batch})")
        del state, train_step
    print(f"[wan train] launches in the main-path run: {launches}", flush=True)
    return launches, results


# Phase 5f: Wan Phase 2 at Wan2.1-T2V-1.3B width and depth. The Phase-2
# trainer sees T = 21 latent frames of 16x60x104, 21 * 30 * 52 = 32760 tokens a
# sample (BH = 2 x 12 at batch 2), cross-attention to 512 text tokens plus 21
# frame-conditioning tokens (533 keys); SLA block 256, top-k int(0.1 * 128) = 12.
WAN2_SAMPLES = 8                # synthetic clips written as tar shards
WAN2_P1_STEPS = 2               # the Phase-1 trainer CLI at its defaults
WAN2_ANCHOR_RUNS = (("ddim", ()), ("pfdiff", ("--solver", "pfdiff")),
                    ("fora2", ("--cache_interval", "2")))
WAN2_TRAIN = (("sla", 4), ("sage_sla", 2), ("dense", 2))   # CLI runs, each resuming the last
WAN2_EVAL_BATCHES = 2
WAN2_COMPARE_LAYERS = 4         # depth of the whole-step kernel-vs-twin comparison
WAN2_BH, WAN2_L, WAN2_LK = 24, 21 * 30 * 52, 512 + 21
# Evaluation, kernel path vs plain-twin path on one batch (same masks, the
# kernel path's SLA LUTs replayed): relative difference of each MSE.
WAN2_EVAL_TOL = 5e-2


def _cli_run(main_fn, argv, maze=False):
    """main_fn(argv) with every Wan kernel's launch count (or, with `maze`,
    every maze kernel's) set to 0 just before and read just after, and the
    twins' calls counted: (result, {kernel: launches}, twin calls, the
    printed log, seconds, peak GiB). Twin calls are a count for the Wan
    kernels and {"forward", "backward", "total"} for the maze kernels."""
    import torch

    if maze:
        _set_maze_counts(dict.fromkeys(("fused_film_block", "small_mha_packed", "small_mha"), 0))
        counter, read = count_maze_twin_calls, _maze_counts
    else:
        _set_train_counts((0,) * len(TRAIN_KERNELS))
        counter, read = count_twin_calls, lambda: dict(zip(TRAIN_KERNELS, _train_counts()))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counter() as twin, _tee_stdout() as log:
        result = main_fn(list(argv))
    torch.cuda.synchronize()
    return (result, read(), dict(twin) if maze else twin[0], log.getvalue(),
            time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30)


def _wan2_kernels(dev, card):
    """Rows 4-8 against their twins at the Phase-2 trainer's shapes, then
    their times beside the bound, the twin and the library call. Returns
    ({kernel: max|d|}, {kernel or kernel/self: (ms, twin ms, bound, library
    ms or None, shape)})."""
    import torch
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels import int8_attention as i8
    from interpolated_diffusion_tpu_torch.kernels.block_sparse_reference import (
        block_sparse_attention_reference as sla_twin)
    from interpolated_diffusion_tpu_torch.kernels.sla import get_block_map

    tag = f"[{card}]"
    gen = torch.Generator(device=dev).manual_seed(40)
    BH, L, Lk, D, block = WAN2_BH, WAN2_L, WAN2_LK, 128, 256
    scale = D ** -0.5
    errs, out = {}, {}
    saved = _train_counts()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        q, k, v = _wan_qkv(BH, L, D, gen, dev)
        do = torch.randn((BH, L, D), generator=gen, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randn((BH, Lk, D), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        _, lut, topk = get_block_map(q, k, 0.1, block, block)
        require(topk == 12 and lut.shape == (BH, 128, 12), f"Phase-2 LUT {tuple(lut.shape)}")
        label = f"Phase 2 [{BH},{L},{D}] block={block} topk={topk} (last key block {L % block} of {block})"
        shape = f"[{BH},{L},{D}] block {block} topk {topk}"
        # row 4: forward, and its backward (row 5)
        o, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, block, block)
        _check_pair("block_sparse_attention", label, (o, lse), sla_twin(q, k, v, lut, block, block),
                    ATTN_TOL, errs)
        got = bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, block, block)
        want = bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, block, block, twin=True)
        for name, tensor, a, b in zip(("sla_bwd_dq", "sla_bwd_dkdv", "sla_bwd_dkdv"),
                                      ("dq", "dk", "dv"), got, want):
            err, rel = _errors(a, b)
            print(f"[wan2 kernels] {name} {label}: {tensor} max|d|={err:.3e} "
                  f"max|d|/max|twin|={rel:.3e} (tol {BWD_TOL})", flush=True)
            require(bool(torch.isfinite(a).all()) and rel <= BWD_TOL,
                    f"{name} {label}: {tensor} disagrees ({rel:.3e})")
            errs[name] = max(errs.get(name, 0.0), err)
        del got, want
        # row 8 against its twin and against the bf16 SLA twin
        qi, ki, qs, ks = i8.quantize_qk(q, k)
        got8 = i8.int8_attention_fwd(qi, ki, v, qs, ks, lut, block, block, scale)
        _check_pair("int8_block_sparse_attention", f"{label} vs int8 twin", got8,
                    i8._torch_int8_attention(qi, ki, v, qs, ks, lut, block, block, scale),
                    ATTN_TOL, errs)
        _, rel = _errors(got8[0], o)
        print(f"[wan2 kernels] int8_block_sparse_attention {label} vs the bf16 SLA kernel: "
              f"max|d|/max|bf16|={rel:.3e} (tol {INT8_VS_BF16_TOL})", flush=True)
        require(rel <= INT8_VS_BF16_TOL, f"int8 vs bf16 SLA {label}: {rel:.3e}")
        del got8
        # rows 6 and 7: cross-attention (every mode) and self-attention (dense)
        flash = {}
        for which, kk, vv in (("cross", kc, vc), ("self", k, v)):
            lab = f"Phase 2 {which} q [{BH},{L},{D}] k {kk.shape[1]} rows"
            fo, flse = bsa.flash_attention_fwd(q, kk, vv)
            _check_pair("flash_attention", lab, (fo, flse),
                        bsa._torch_flash(q, kk, vv, scale, 1024), ATTN_TOL, errs)
            got = bsa.flash_attention_bwd(q, kk, vv, fo, flse, do)
            want = bsa.flash_attention_bwd(q, kk, vv, fo, flse, do, twin=True)
            for name, tensor, a, b in zip(("flash_bwd_dq", "flash_bwd_dkdv", "flash_bwd_dkdv"),
                                          ("dq", "dk", "dv"), got, want):
                err, rel = _errors(a, b)
                print(f"[wan2 kernels] {name} {lab}: {tensor} max|d|={err:.3e} "
                      f"max|d|/max|twin|={rel:.3e} (tol {BWD_TOL})", flush=True)
                require(bool(torch.isfinite(a).all()) and rel <= BWD_TOL,
                        f"{name} {lab}: {tensor} disagrees ({rel:.3e})")
                errs[name] = max(errs.get(name, 0.0), err)
            flash[which] = (kk, vv, fo, flse)
            del got, want
        torch.cuda.synchronize()

        # times: each kernel alone (CUDA events), its twin, the bound, and one
        # PyTorch call where one computes the same function. SLA under its LUT
        # as an additive mask would need a [24, 32760, 32760] bias (51 GB), so
        # rows 4, 5 and 8 have none here.
        entries, pairs = _sla_work(lut, L, block)
        o_lse = _nbytes(q) + 4 * BH * L
        delta = bsa.attention_delta(o, do)
        rows_b = _nbytes(lse, delta)
        # (name, shape, kernel, twin key, twin or None when the key's twin was
        # timed already: the backward twins compute dq, dk and dv in one call,
        # bound, library call or ("backward", leaves) or None)
        plan = [
            ("block_sparse_attention", shape,
             lambda: bsa.block_sparse_attention_fwd(q, k, v, lut, block, block), "sla",
             lambda: sla_twin(q, k, v, lut, block, block),
             bound_ms(_nbytes(q, k, v, lut) + o_lse, 4.0 * entries * D), None),
            ("int8_block_sparse_attention", f"{shape}, pre-quantized q/k",
             lambda: i8.int8_attention_fwd(qi, ki, v, qs, ks, lut, block, block, scale), "int8",
             lambda: i8._torch_int8_attention(qi, ki, v, qs, ks, lut, block, block, scale),
             bound_ms(_nbytes(qi, ki, v, qs, ks, lut) + o_lse, 2.0 * entries * D,
                      2.0 * entries * D), None),
            ("sla_bwd_dq", shape,
             lambda: bsa.sla_bwd_dq(q, k, v, lut, do, lse, delta, block, block, scale), "sla_bwd",
             lambda: bsa.block_sparse_attention_bwd(q, k, v, lut, o, lse, do, block, block,
                                                    twin=True),
             bound_ms(_nbytes(q, k, v, do, lut) + rows_b + _nbytes(q), 6.0 * entries * D), None),
            ("sla_bwd_dkdv", shape,
             lambda: bsa.sla_bwd_dkdv(q, k, v, lut, do, lse, delta, block, block, scale),
             "sla_bwd", None,
             bound_ms(_nbytes(q, k, v, do, lut) + rows_b + _nbytes(k, v), 8.0 * pairs * D), None)]
        for which in ("cross", "self"):
            kk, vv, fo, flse = flash[which]
            fdelta = bsa.attention_delta(fo, do)
            n_k = kk.shape[1]
            fshape = f"q [{BH},{L},{D}] k {n_k} rows"
            leaves = [t[None].clone().requires_grad_() for t in (q, kk, vv)]
            io = _nbytes(q, kk, vv, do) + 8 * BH * L
            plan += [
                (f"flash_attention/{which}", fshape,
                 lambda kk=kk, vv=vv: bsa.flash_attention_fwd(q, kk, vv), f"flash/{which}",
                 lambda kk=kk, vv=vv: bsa._torch_flash(q, kk, vv, scale, 1024),
                 bound_ms(_nbytes(q, kk, vv, q) + 4 * BH * L, 4.0 * BH * L * n_k * D),
                 lambda kk=kk, vv=vv: sdpa(q[None], kk[None], vv[None])),
                (f"flash_bwd_dq/{which}", fshape,
                 lambda kk=kk, vv=vv, fl=flse, fd=fdelta: bsa.flash_bwd_dq(
                     q, kk, vv, do, fl, fd, scale), f"flash_bwd/{which}",
                 lambda kk=kk, vv=vv, fo=fo, fl=flse: bsa.flash_attention_bwd(
                     q, kk, vv, fo, fl, do, twin=True),
                 bound_ms(io + _nbytes(q), 6.0 * BH * L * n_k * D), ("backward", leaves)),
                (f"flash_bwd_dkdv/{which}", fshape,
                 lambda kk=kk, vv=vv, fl=flse, fd=fdelta: bsa.flash_bwd_dkdv(
                     q, kk, vv, do, fl, fd, scale), f"flash_bwd/{which}", None,
                 bound_ms(io + _nbytes(kk, vv), 8.0 * BH * L * n_k * D), ("backward", leaves))]
        twin_ms, lib_bwd = {}, {}
        for name, shp, kernel, twin_key, twin, bound, lib in plan:
            k_ms = _time_ms(kernel, iters=5, warmup=1)
            if twin is not None:
                twin_ms[twin_key] = _time_ms(twin, iters=1, warmup=1)
            lib_ms = None
            if isinstance(lib, tuple):      # autograd through sdpa: dq, dk, dv in one call
                if twin_key not in lib_bwd:
                    with torch.enable_grad():
                        y = sdpa(*lib[1])
                        lib_bwd[twin_key] = _time_ms(
                            lambda: torch.autograd.grad(y, lib[1], do[None], retain_graph=True),
                            iters=3, warmup=1)
                    del y
                lib_ms = lib_bwd[twin_key]
            elif lib is not None:
                lib_ms = _time_ms(lib, iters=5, warmup=1)
            out[name] = (k_ms, twin_ms[twin_key], bound, lib_ms, shp)
            lib_txt = ("library: none (no PyTorch call takes int8 Q K^T)" if name.startswith("int8")
                       else "library: none (the LUT as an additive mask would be a 51 GB bias)"
                       if lib_ms is None else
                       f"library (scaled_dot_product_attention{' backward, dq dk dv' if 'bwd' in name else ''}) "
                       f"{lib_ms:.4f} ms")
            print(f"[timing] {tag} Phase 2 {name} {shp}: kernel {k_ms:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]}), plain twin{' (dq, dk, dv)' if 'bwd' in name else ''} "
                  f"{twin_ms[twin_key]:.4f} ms, {lib_txt}", flush=True)
        del plan, flash, leaves, q, k, v, do, kc, vc, o, lse, qi, ki, qs, ks
    _set_train_counts(saved)
    torch.cuda.empty_cache()
    # _check_pair keeps a list per forward kernel; one largest |d| per kernel
    return {k: max(v) if isinstance(v, list) else v for k, v in errs.items()}, out


def _wan2_step_check(dev, data, anchors_root):
    """The Phase-2 loss and every trainable leaf's gradient, kernel path
    against twin path, from the same state, batch (an anchor-joined tar
    batch) and draws, at full width and L = 32760, WAN2_COMPARE_LAYERS
    layers, under sla, sage_sla and dense."""
    import torch
    from interpolated_diffusion_tpu_torch.train import train_interp_levels_wansynth as p2
    from interpolated_diffusion_tpu_torch.train.state import flatten_dict, tree_leaves
    from interpolated_diffusion_tpu_torch.train.wansynth_common import (build_wan,
                                                                        make_wansynth_loader)
    from interpolated_diffusion_tpu_torch.utils.prefetch import pinned_put

    args = p2.build_argparser().parse_args(
        ["--data", "tar", "--data_root", data, "--anchors_root", anchors_root,
         "--wan_layers", str(WAN2_COMPARE_LAYERS), "--seed", "41"])
    args.frame_cond, args.frame_cond_dim = 1, p2.FRAME_FEATURES + 1
    wan, fc = build_wan(args, True, device=dev, zero_init_scale=1e-2,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))
    batch = pinned_put(dev, keys=("latents", "text_embed", "anchors", "anchor_idx"))(
        next(make_wansynth_loader(args, args.seed)))
    require("anchors" in batch, "the Phase-2 tar batch has no joined anchors")
    B, T, C, H, W = batch["latents"].shape
    N, D_tok = (H // 2) * (W // 2), C * 4
    require(B * args.wan_heads == WAN2_BH and T * N == WAN2_L, "Phase-2 shapes changed")
    draws = p2.make_phase2_draws(torch.Generator(device=dev).manual_seed(42), args, B, T,
                                 N * D_tok)
    for mode in ("sla", "sage_sla", "dense"):
        args.attn_mode = mode
        wan.set_attn_mode(mode)
        state, _, _, _, _ = p2.make_trainer(args, dev, wan, fc)
        names = list(flatten_dict(state.params))
        leaves = tree_leaves(state.params)

        def loss_and_grads():
            loss, _ = p2.phase2_loss(wan, fc, args, batch, draws)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        luts = []
        with sla_luts(luts):
            loss_k, grads_k = loss_and_grads()
        note = ""
        if luts:
            with wan_plain_twins():
                _, grads_own = loss_and_grads()
            own = max((_errors(a, b)[1], n) for n, a, b in zip(names, grads_k, grads_own))
            del grads_own
        with wan_plain_twins(), sla_luts(luts, replay=True) as lut_stats:
            loss_t, grads_t = loss_and_grads()
        if luts:
            note = (f"; the twin path's own LUTs differ in {lut_stats[2]} of {lut_stats[1]} rows, "
                    f"on them its worst gradient max|d|/max|twin|={own[0]:.3e} at {own[1]}")
        rel_loss = abs(loss_k.item() - loss_t.item()) / abs(loss_t.item())
        worst = max((_errors(a, b)[1], n) for n, a, b in zip(names, grads_k, grads_t))
        zero = [n for n, g in zip(names, grads_t) if not bool(g.abs().max() > 0)]
        print(f"[wan2 step] attn_mode={mode}, {WAN2_COMPARE_LAYERS} of 30 layers, L={T * N}, "
              f"kernels vs plain twins (same state / batch / draws / LUTs): loss "
              f"{loss_k.item():.6f} vs {loss_t.item():.6f} (rel {rel_loss:.3e}, tol "
              f"{TRAIN_LOSS_TOL}); {len(names)} trainable leaves, worst gradient "
              f"max|d|/max|twin|={worst[0]:.3e} at {worst[1]} (tol {TRAIN_GRAD_TOL}){note}",
              flush=True)
        require(not zero, f"Phase 2 {mode}: identically zero gradients at {zero[:3]}")
        require(rel_loss <= TRAIN_LOSS_TOL, f"Phase 2 {mode}: loss disagrees ({rel_loss:.3e})")
        require(worst[0] <= TRAIN_GRAD_TOL,
                f"Phase 2 {mode}: gradient of {worst[1]} disagrees ({worst[0]:.3e})")
        del grads_k, grads_t, state
    del wan, fc, batch, draws
    torch.cuda.empty_cache()


_STEP_LINE = r"step (\d+) loss (\S+) \| ([0-9.]+)s/step"


def phase_wan_phase2(dev, card, profile):
    """Phase 5f: the Wan Phase-2 chain through its CLIs at Wan2.1-1.3B width
    and depth. Returns ({kernel: max|d|}, kernel times at the Phase-2 shapes,
    {kernel: {mode: launches per step}} of the trainer runs)."""
    import re
    import shutil

    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.data import make_synth_tars
    from interpolated_diffusion_tpu_torch.data import precompute_phase1_anchors as prep
    from interpolated_diffusion_tpu_torch.data.wan_synth import iter_tar_samples
    from interpolated_diffusion_tpu_torch.diagnostics import eval_wansynth_stage2 as ev
    from interpolated_diffusion_tpu_torch.train import train_interp_levels_wansynth as p2
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1
    from interpolated_diffusion_tpu_torch.train.wansynth_common import make_wansynth_loader

    t_phase = time.perf_counter()
    tag = f"[{card}]"
    work = tempfile.mkdtemp(prefix="wan_phase2_")
    try:
        # 1. inputs: synthetic clips at the full shapes as tar shards, and a
        # Phase-1 checkpoint from its trainer CLI at its defaults
        data = os.path.join(work, "data")
        make_synth_tars.main(["--out_root", data, "--num_samples", str(WAN2_SAMPLES),
                              "--shard_size", str(WAN2_SAMPLES)])
        p1_dir = os.path.join(work, "p1")
        _, counts, twin, log, secs, peak = _cli_run(p1.main, [
            "--steps", str(WAN2_P1_STEPS), "--log_every", "1", "--data", "tar",
            "--data_root", data, "--out_dir", p1_dir])
        want = {k: c * WAN2_P1_STEPS for k, c in zip(TRAIN_KERNELS, TRAIN_EXPECT["sla"])}
        require(counts == want and twin == 0, f"Phase-1 CLI: launches {counts}, twin calls "
                f"{twin}, expected {want} and 0")
        print(f"[wan2] {tag} Phase-1 trainer CLI at its defaults, {WAN2_P1_STEPS} steps on the "
              f"tar shards: {secs:.1f} s with the model build and a checkpoint, peak "
              f"{peak:.2f} GiB, launches {counts}", flush=True)

        # 2. anchors at full width and depth, batch 4: ddim, pfdiff, FORA 2
        anchor_sets, anchor_launches = {}, {}
        for label, extra in WAN2_ANCHOR_RUNS:
            out_root = os.path.join(work, f"anchors_{label}")
            res, counts, twin, log, secs, peak = _cli_run(prep.main, [
                "--ckpt", p1_dir, "--out_root", out_root, "--data", "tar", "--data_root", data,
                "--batch", "4", *extra])
            calls = -(-WAN2_SAMPLES // 4)
            require(twin == 0 and res["samples"] == WAN2_SAMPLES and res["n_shards"] == 1,
                    f"precompute {label}: {res}, twin calls {twin}")
            per_call = {k: v // calls for k, v in counts.items() if v}
            require(all(v % calls == 0 for v in counts.values()) and
                    counts["block_sparse_attention"] > 0 and counts["flash_attention"] > 0,
                    f"precompute {label}: launches {counts} over {calls} calls")
            samples = list(iter_tar_samples(os.path.join(out_root, "shard_00000.tar")))
            require(len(samples) == WAN2_SAMPLES and all(
                set(s) == {"__key__", "anchors", "anchor_idx"} and
                s["anchors"].shape == (5, 16, 60, 104) and s["anchors"].dtype == np.float32 and
                s["anchor_idx"].shape == (5,) and s["anchor_idx"].dtype == np.int32 and
                bool(np.isfinite(s["anchors"]).all()) and bool(np.all(np.diff(s["anchor_idx"]) > 0))
                for s in samples), f"precompute {label}: the shard's fields or shapes are wrong")
            anchor_sets[label] = np.stack([s["anchors"] for s in samples])
            anchor_launches[label] = per_call
            with open(os.path.join(out_root, "prep_config.json")) as f:
                sps = json.load(f)["samples_per_sec"]
            print(f"[wan2] {tag} precompute {label} (30 layers, batch 4, sla block 128, 4 "
                  f"quadratic steps): {sps:.3f} samples/s after the first batch, launches per "
                  f"call {per_call}, twin calls 0; {secs:.1f} s with the load", flush=True)
        ref = anchor_sets["ddim"]
        for label in ("pfdiff", "fora2"):
            d = np.abs(anchor_sets[label] - ref).max() / np.abs(ref).max()
            print(f"[wan2] anchors {label} vs ddim: max|d|/max|ddim| = {d:.3e} (another "
                  f"solver or cached blocks: not a gate)", flush=True)
        shutil.rmtree(p1_dir)
        anchors_root = os.path.join(work, "anchors_ddim")

        # 3. the kernels at the Phase-2 shapes, then the whole step at reduced depth
        errs, ktimes = _wan2_kernels(dev, card)
        _wan2_step_check(dev, data, anchors_root)

        # 4. the trainer CLI at its defaults: sla, then resumed under sage_sla and dense
        p2_dir = os.path.join(work, "p2")
        done, launches, results = 0, {}, {}
        for mode, n in WAN2_TRAIN:
            argv = ["--data", "tar", "--data_root", data, "--anchors_root", anchors_root,
                    "--out_dir", p2_dir, "--log_every", "1", "--attn_mode", mode,
                    "--steps", str(done + n)] + (["--resume", p2_dir] if done else [])
            _, counts, twin, log, secs, peak = _cli_run(p2.main, argv)
            steps = [(int(a), float(b), float(c)) for a, b, c in re.findall(_STEP_LINE, log)]
            require([s[0] for s in steps] == list(range(done, done + n)) and
                    all(np.isfinite(s[1]) for s in steps),
                    f"Phase-2 CLI {mode}: step lines {steps}")
            want = {k: c * n for k, c in zip(TRAIN_KERNELS, TRAIN_EXPECT[mode])}
            require(counts == want and twin == 0, f"Phase-2 CLI {mode}: launches {counts}, "
                    f"twin calls {twin}, expected {want} and 0")
            timed = [s[2] for s in steps[1:]]
            per = sum(timed) / len(timed)
            results[mode] = dict(s_per_step=per, peak_gib=peak, losses=[s[1] for s in steps])
            for name, c in zip(TRAIN_KERNELS, TRAIN_EXPECT[mode]):
                launches.setdefault(name, {})[mode] = c
            print(f"[wan2 train] {tag} attn_mode={mode}: steps {done}..{done + n - 1}"
                  f"{' (resumed)' if done else ''}: {per:.3f} s/step over {len(timed)} step(s) "
                  f"after the first ({steps[0][2]:.3f} s), {2 / per:.3f} samples/s, peak memory "
                  f"{peak:.2f} GiB, launches per step "
                  f"{dict(zip(TRAIN_KERNELS, TRAIN_EXPECT[mode]))}, twin calls 0; losses "
                  f"{[round(s[1], 4) for s in steps]}", flush=True)
            results[mode]["ckpt"] = os.path.join(p2_dir, f"ckpt_{done + n}")
            require(os.path.exists(os.path.join(results[mode]["ckpt"], "params.pt")),
                    f"Phase-2 CLI {mode}: no checkpoint")
            done += n

        # 5. the evaluation CLI on each mode's checkpoint (the checkpoint's meta
        # names its attention mode), then kernel path vs twin path under sla
        for mode, _ in WAN2_TRAIN:
            summary, counts, twin, log, secs, peak = _cli_run(ev.main, [
                "--p2_ckpt", results[mode]["ckpt"], "--data_root", data,
                "--anchors_root", anchors_root, "--num_batches", str(WAN2_EVAL_BATCHES),
                "--out_dir", os.path.join(work, f"eval_{mode}")])
            forwards = WAN2_EVAL_BATCHES * 2 * 2 * TRAIN_LAYERS   # batches x {gt, p1} x levels
            want = {"sla": ("block_sparse_attention", "flash_attention"),
                    "sage_sla": ("int8_block_sparse_attention", "flash_attention"),
                    "dense": ("flash_attention", "flash_attention")}[mode]
            want = {k: want.count(k) * forwards for k in TRAIN_KERNELS}
            require(twin == 0 and counts == want and
                    all(np.isfinite(summary[k]) for k in ev.MSE_KEYS),
                    f"eval {mode}: {summary}, launches {counts} (expected {want}), twin calls {twin}")
            results[mode]["eval"] = summary
            for name, c in want.items():
                if c:
                    launches.setdefault(name, {})[f"eval_{mode}"] = c // WAN2_EVAL_BATCHES
            print(f"[wan2 eval] {tag} {mode} checkpoint, {WAN2_EVAL_BATCHES} batches of 2: "
                  + ", ".join(f"{k} {summary[k]:.6g}" for k in ev.MSE_KEYS)
                  + f"; {summary['samples_per_sec']:.3f} samples/s; helps gt "
                  f"{summary['stage2_helps_gt']}, p1 {summary['stage2_helps_p1']}; launches per "
                  f"batch {({k: v // WAN2_EVAL_BATCHES for k, v in want.items() if v})}, twin "
                  f"calls 0, peak {peak:.2f} GiB", flush=True)
        model, fc, meta = ev.load_stage2(results["sla"]["ckpt"], True, dev)
        run = ev.make_stage2_eval(model, fc, meta)
        args = argparse.Namespace(data="tar", data_root=data, T=21, anchors_root=anchors_root,
                                  batch=2)
        batch = next(make_wansynth_loader(args, 0))
        inputs = [torch.from_numpy(batch[k]).to(dev)
                  for k in ("latents", "text_embed", "anchors", "anchor_idx")]
        mask_rand = ev.make_eval_draws(torch.Generator(device=dev).manual_seed(43), 2, 21)
        luts = []
        with sla_luts(luts):
            got = {k: float(v) for k, v in run(*inputs, mask_rand["mask_rand"]).items()}
        with wan_plain_twins(), sla_luts(luts, replay=True):
            ref = {k: float(v) for k, v in run(*inputs, mask_rand["mask_rand"]).items()}
        rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in ev.MSE_KEYS}
        print(f"[wan2 eval] kernel path vs twin path, one batch, same masks and LUTs: "
              + ", ".join(f"{k} {got[k]:.6g} vs {ref[k]:.6g}" for k in ev.MSE_KEYS)
              + f"; worst rel {max(rel.values()):.3e} (tol {WAN2_EVAL_TOL})", flush=True)
        require(max(rel.values()) <= WAN2_EVAL_TOL, f"eval kernel vs twin path: {rel}")
        del model, fc, run, inputs
        torch.cuda.empty_cache()
        if profile:
            _wan2_profile(dev, card, data, anchors_root)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[wan2] phase 5f took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return errs, ktimes, launches, results


def _wan2_profile(dev, card, data, anchors_root):
    """torch.profiler over one sla-mode Phase-2 training step at the
    trainer's defaults (full width and depth): device time by kind and the
    device's busy share of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from interpolated_diffusion_tpu_torch.train import train_interp_levels_wansynth as p2
    from interpolated_diffusion_tpu_torch.train.wansynth_common import make_wansynth_loader
    from interpolated_diffusion_tpu_torch.utils.prefetch import pinned_put

    args = p2.build_argparser().parse_args(["--data", "tar", "--data_root", data,
                                            "--anchors_root", anchors_root])
    state, base, train_step, _, _ = p2.make_trainer(args, dev)
    put = pinned_put(dev, keys=("latents", "text_embed", "anchors", "anchor_idx"))
    loader = make_wansynth_loader(args, args.seed)
    rng = torch.Generator(device=dev).manual_seed(44)
    state, _ = train_step(state, base, put(next(loader)), rng)   # warm-up
    batch = put(next(loader))
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = train_step(state, base, batch, rng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _print_profile(prof, f"[{card}]", "one sla-mode Phase-2 training step (batch 2, L 32760)")
    busy = sum(_device_us(e) for e in prof.key_averages()) / 1e6
    print(f"[profile] [{card}] the Phase-2 step: {busy:.3f} s of device time in a {wall:.3f} s "
          f"step: busy {busy / wall:.2f}", flush=True)
    del state, base, train_step
    torch.cuda.empty_cache()


# Phase 5g: the rest of the Wan video chain. The five interpolator / selector
# trainers at their defaults on 8 synthetic clips at the Wan2.1 latent shape
# (T = 21, 16x60x104, text 512x4096), each model's f32 forward on the card
# against the CPU's, the teacher precompute and its join, the interpolator
# evaluation, and full fine-tuning of WanDiT (--lora_rank 0) under bf16.
INTERP_SAMPLES = 8
INTERP_STEPS = 4
# (name, trainer module, loader in models/, extra flags): each trainer at its
# defaults (batch 8 / 8 / 4 / 8 / 8); the Sinkhorn validation and the
# selector's top-K evaluation run at the last step
INTERP_TRAINERS = (
    ("flow", "train_flow_interpolator_wansynth", "loading.load_flow_interpolator", ()),
    ("straightener", "train_latent_straightener_wansynth",
     "straightener.load_latent_straightener", ()),
    ("sinkhorn", "train_sinkhorn_interp_wansynth", "loading.load_sinkhorn_interp",
     ("--val_every", str(INTERP_STEPS), "--val_batches", "1")),
    ("segment_cost", "train_segment_cost_wansynth", "loading.load_video_segment_cost", ()),
    ("video_selector", "train_video_selector_wansynth", "loading.load_video_selector",
     ("--eval_every", str(INTERP_STEPS))),
)
# card against CPU, f32 forward of the same weights and inputs, TF32 off:
# max|d| / max|cpu| of each output
INTERP_CARD_TOL = 1e-4
SINKHORN_WELL_POSED = 1e-2
FULL_FT_STEPS = 2               # CLI steps per mode at full width and depth
FULL_FT_MODES = ("sla", "sage_sla")
FULL_FT_GRAD_FLOOR = 1e-3      # of the largest leaf gradient, in the 4-layer gate
_INTERP_STEP = r"step (\d+) loss (\S+).*?\| ([0-9.]+) s/step"


@contextlib.contextmanager
def se2_choices(model, choices, replay=False):
    """Record into `choices`, in call order, the global SE(2) (theta, dx, dy)
    that the Sinkhorn interpolator's phase correlation picks for each pair;
    with `replay`, hand those back (on this model's device) instead of its
    own. The argmax of a correlation peak and the best angle are discrete: an
    FFT rounding difference can flip them on one device only. Yields [calls,
    pairs, pairs whose own choice differs from the recorded one by more than
    1e-4]."""
    own, stats = model._global_se2, [0, 0, 0]

    def global_se2(f0, f1):
        got = own(f0, f1)
        if not replay:
            choices.append(tuple(t.detach().cpu() for t in got))
            return got
        kept = choices[stats[0]]
        stats[0] += 1
        stats[1] += kept[0].numel()
        stats[2] += int(sum(((a.cpu() - b).abs() > 1e-4).int() for a, b in zip(got, kept))
                        .gt(0).sum())
        return tuple(t.to(f0.device, f0.dtype) for t in kept)

    model._global_se2 = global_se2
    try:
        yield stats
    finally:
        del model._global_se2


def _interp_forward(name, model, batch, dev, dtype=None):
    """The model's outputs (a tuple) on `dev` for one batch of two clips
    (the latents in `dtype`, f32 by default)."""
    import torch

    lat = torch.from_numpy(batch["latents"][:2]).to(dev, dtype or torch.float32)
    idx = torch.tensor([[0, 5, 10, 15, 20], [0, 3, 9, 14, 20]], device=dev)
    with torch.no_grad():
        if name in ("flow", "sinkhorn"):
            return tuple(model(lat, idx))
        if name == "straightener":
            alpha = torch.tensor([0.5, 0.25], device=dev)
            return tuple(model.interpolate_pair(lat[:, 0], lat[:, 20], alpha)) + (
                model(lat[:, 10]),)
        text = torch.from_numpy(batch["text_embed"][:2]).to(dev)
        if name == "segment_cost":
            from interpolated_diffusion_tpu_torch.ops.oracle_segment_cost import (
                build_oracle_seg_precompute)
            from interpolated_diffusion_tpu_torch.ops.selection import build_segment_features

            pre = build_oracle_seg_precompute(21)
            feat = build_segment_features(21, pre.seg_i, pre.seg_j).to(dev)
            return (model({"text_embed": text}, feat),)
        return (model({"text_embed": text}),)


def _full_ft_check(dev, data):
    """--lora_rank 0 --bf16 1 at full width, 4 of 30 layers: the loss and every
    WanDiT weight's gradient on the kernel path against the twin path (the
    kernel path's SLA LUTs replayed), under sla and sage_sla."""
    import torch
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1
    from interpolated_diffusion_tpu_torch.train.state import flatten_dict, tree_leaves
    from interpolated_diffusion_tpu_torch.train.wansynth_common import (build_wan,
                                                                        make_wansynth_loader)
    from interpolated_diffusion_tpu_torch.utils.prefetch import pinned_put

    args = p1.build_argparser().parse_args(["--lora_rank", "0", "--wan_layers",
                                            str(WAN2_COMPARE_LAYERS), "--data", "tar",
                                            "--data_root", data, "--seed", "31"])
    wan, fc = build_wan(args, True, device=dev, zero_init_scale=1e-2,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))
    batch = pinned_put(dev, keys=("latents", "text_embed"))(
        next(make_wansynth_loader(args, args.seed)))
    schedule = make_schedule(args.schedule, args.N_train, device=dev)
    N = (args.latent_h // 2) * (args.latent_w // 2)
    for mode in FULL_FT_MODES:
        args.attn_mode = mode
        wan.set_attn_mode(mode)
        state, base, _, _, _ = p1.make_trainer(args, dev, wan, fc)
        names, leaves = list(flatten_dict(state.params)), tree_leaves(state.params)
        require(base is None and all(p.dtype == torch.float32 and p.requires_grad
                                     for p in leaves),
                f"full fine-tune {mode}: the trainable leaves are not all f32 masters")
        draws = p1.draw_phase1(torch.Generator(device=dev).manual_seed(32), args, args.batch,
                               (args.batch, args.K, N, args.latent_c * 4))

        def loss_and_grads():
            loss, _ = p1.phase1_loss(wan, fc, args, schedule, batch, draws)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        luts = []
        with sla_luts(luts):
            loss_k, grads_k = loss_and_grads()
        with wan_plain_twins(), sla_luts(luts, replay=True) as lut_stats:
            loss_t, grads_t = loss_and_grads()
        rel_loss = abs(loss_k.item() - loss_t.item()) / abs(loss_t.item())
        # Each weight's gradient is held to 5e-2 of its own max|twin|, or of
        # FULL_FT_GRAD_FLOOR x the largest leaf's where its own is smaller. The
        # floor is for gradients that are the remainder of a cancellation: the
        # cross-attention key projection's is sum_j dK_j x_j^T over text tokens
        # x_j that are nearly alike, and sum_j dK_j vanishes with softmax's zero
        # row sums of dS (bf16 rounds dS, one ulp at other elements on each
        # path), so the remainder is orders of magnitude below the other
        # leaves' gradients and rounding is a large share of it.
        top = max(float(b.abs().max()) for b in grads_t)
        scale = lambda b: max(float(b.abs().max()), FULL_FT_GRAD_FLOOR * top)
        worst = max((float((a - b).abs().max()) / scale(b), n)
                    for n, a, b in zip(names, grads_k, grads_t))
        floored = sorted(((_errors(a, b)[1], n, float(b.abs().max()))
                          for n, a, b in zip(names, grads_k, grads_t)
                          if float(b.abs().max()) < FULL_FT_GRAD_FLOOR * top), reverse=True)
        print(f"[wan interp] full fine-tune, {WAN2_COMPARE_LAYERS} of 30 layers, attn_mode="
              f"{mode}: kernels vs plain twins, same state / batch / draws, same LUTs "
              f"({lut_stats[0]} SLA calls; the twin path's own LUTs differ in {lut_stats[2]} of "
              f"{lut_stats[1]} rows): loss {loss_k.item():.6f} vs {loss_t.item():.6f} (rel "
              f"{rel_loss:.3e}, tol {TRAIN_LOSS_TOL}); {len(names)} weights, worst gradient "
              f"max|d|/max|twin| = {worst[0]:.3e} at {worst[1]} (tol {TRAIN_GRAD_TOL}; largest "
              f"leaf gradient {top:.3e}, {len(floored)} leaves under {FULL_FT_GRAD_FLOOR} of it "
              f"held to that floor, {sum(e > TRAIN_GRAD_TOL for e, _, _ in floored)} of which "
              f"beyond the tol against their own max: "
              + (", ".join(f"{e:.3e} at {n} (max {m:.3e})" for e, n, m in floored[:4]) or "-")
              + ")", flush=True)
        require(rel_loss <= TRAIN_LOSS_TOL, f"full fine-tune {mode}: loss disagrees ({rel_loss})")
        require(worst[0] <= TRAIN_GRAD_TOL,
                f"full fine-tune {mode}: gradient of {worst[1]} disagrees ({worst[0]:.3e})")
        del state, grads_k, grads_t, luts
    del wan, fc, batch
    torch.cuda.empty_cache()


def _full_ft_cli(dev, card, data, work):
    """The Phase-1 trainer CLI at Wan2.1-1.3B width and depth with every weight
    trained (--lora_rank 0 --bf16 1, batch 2, L = 7800, remat), FULL_FT_STEPS
    steps under each of FULL_FT_MODES: launches per step of rows 4-8 as the
    LoRA step's, no twin call, s/step, peak memory; every weight stays an f32
    master and moves. Returns {kernel: {mode: launches per step}}."""
    import re
    import shutil

    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1
    from interpolated_diffusion_tpu_torch.train.wansynth_common import build_wan

    launches = {}
    for mode in FULL_FT_MODES:
        out = os.path.join(work, f"full_{mode}")
        argv = ["--lora_rank", "0", "--data", "tar", "--data_root", data, "--attn_mode", mode,
                "--steps", str(FULL_FT_STEPS), "--log_every", "1", "--out_dir", out]
        state, counts, twin, log, secs, peak = _cli_run(p1.main, argv)
        steps = [(int(a), float(b), float(c)) for a, b, c in re.findall(_STEP_LINE, log)]
        want = {k: c * FULL_FT_STEPS for k, c in zip(TRAIN_KERNELS, TRAIN_EXPECT[mode])}
        require([s[0] for s in steps] == list(range(FULL_FT_STEPS)) and
                all(np.isfinite(s[1]) for s in steps), f"full fine-tune {mode}: steps {steps}")
        require(counts == want and twin == 0, f"full fine-tune {mode}: launches {counts}, twin "
                f"calls {twin}, expected {want} and 0")
        leaves = state.params["wan"]
        require(set(state.params) == {"wan", "frame_cond"} and
                all(p.dtype == torch.float32 for p in leaves.values()),
                f"full fine-tune {mode}: the WanDiT weights are not f32 masters")
        args = p1.build_argparser().parse_args(argv)
        init, _ = build_wan(args, True, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(args.seed))
        still = [n for n, p in init.named_parameters() if torch.equal(p, leaves[n].detach())]
        n_weights = len(leaves)
        del init, state, leaves
        torch.cuda.empty_cache()
        shutil.rmtree(out, ignore_errors=True)   # ~5.6 GB of f32 weights
        require(not still, f"full fine-tune {mode}: weights unchanged {still[:3]}")
        for name, c in zip(TRAIN_KERNELS, TRAIN_EXPECT[mode]):
            launches.setdefault(name, {})[mode] = c
        per = sum(s[2] for s in steps[1:]) / max(1, len(steps) - 1)
        print(f"[wan interp] {card} full fine-tune (--lora_rank 0 --bf16 1, 30 layers, batch 2, "
              f"L = 7800, remat) attn_mode={mode}: {per:.3f} s/step after the first "
              f"({steps[0][2]:.3f} s), peak memory {peak:.2f} GiB, launches per step "
              f"{dict(zip(TRAIN_KERNELS, TRAIN_EXPECT[mode]))}, twin calls 0; all {n_weights} "
              f"WanDiT weights f32 and moved; losses {[round(s[1], 4) for s in steps]}; "
              f"{secs:.1f} s with the build and a checkpoint", flush=True)
    return launches


def phase_wan_interp(dev, card):
    """Phase 5g. Returns {kernel: {mode: launches per step}} of the full
    fine-tune runs (rows 4-8)."""
    import importlib
    import re
    import shutil

    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.data import make_synth_tars
    from interpolated_diffusion_tpu_torch.data import precompute_teacher as prep
    from interpolated_diffusion_tpu_torch.data.wan_synth import WanSynthTarDataset
    from interpolated_diffusion_tpu_torch.diagnostics import eval_interpolators as ev

    t_phase = time.perf_counter()
    tag = f"[{card}]"
    work = tempfile.mkdtemp(prefix="wan_interp_")
    try:
        data = os.path.join(work, "data")
        make_synth_tars.main(["--out_root", data, "--num_samples", str(INTERP_SAMPLES),
                              "--shard_size", str(INTERP_SAMPLES)])
        batch = next(WanSynthTarDataset(data, T=21, shuffle_shards=False).batches(2))

        # 1. the five trainers at their defaults, then each model on the card vs the CPU
        ckpts = {}
        for name, module, loader, extra in INTERP_TRAINERS:
            main_fn = importlib.import_module(
                f"interpolated_diffusion_tpu_torch.train.{module}").main
            out = os.path.join(work, name)
            _set_maze_counts(dict.fromkeys(_maze_counts(), 0))
            state, counts, twin, log, secs, peak = _cli_run(main_fn, [
                "--data", "tar", "--data_root", data, "--steps", str(INTERP_STEPS),
                "--log_every", "1", "--out_dir", out, *extra])
            maze = _maze_counts()
            steps = [(int(a), float(b), float(c)) for a, b, c in re.findall(_INTERP_STEP, log)]
            require([s[0] for s in steps] == list(range(INTERP_STEPS)) and
                    all(np.isfinite(s[1]) for s in steps), f"{name} trainer: steps {steps}")
            require(not any(counts.values()) and not any(maze.values()) and twin == 0,
                    f"{name} trainer: kernel launches {counts} {maze} (none expected)")
            module_name, fn = loader.split(".")
            load = getattr(importlib.import_module(
                f"interpolated_diffusion_tpu_torch.models.{module_name}"), fn)
            model, _ = load(out, device=dev)
            got = dict(model.named_parameters())
            require(got.keys() == state.params.keys() and all(
                torch.equal(got[k], state.params[k].detach()) for k in got),
                f"{name}: the checkpoint does not read back into the trained weights")
            ckpts[name] = os.path.join(out, f"ckpt_{INTERP_STEPS}")
            per = sum(s[2] for s in steps[1:]) / (len(steps) - 1)
            n_params = sum(p.numel() for p in got.values())
            with open(os.path.join(out, "run_config.json")) as f:
                batch_n = json.load(f)["args"]["batch"]
            extra_lines = [l for l in log.splitlines() if l.startswith(("[val]", "[eval]"))]
            print(f"[wan interp] {tag} {name} trainer at its defaults (batch {batch_n}, "
                  f"{n_params / 1e6:.3f}M parameters): {per:.4f} s/step over steps 1.."
                  f"{INTERP_STEPS - 1} (step 0 {steps[0][2]:.3f} s), peak memory {peak:.2f} GiB, "
                  f"losses {[round(s[1], 5) for s in steps]}, no kernel launch; checkpoint "
                  f"read back" + "".join(f"; {l}" for l in extra_lines), flush=True)
            # the card's f32 forward against the CPU's, same weights and inputs
            cpu, _ = load(out, device="cpu")
            choices, note = [], ""
            if name == "sinkhorn":
                with se2_choices(model, choices):
                    on_card = _interp_forward(name, model, batch, dev)
                with se2_choices(cpu, choices, replay=True) as stats:
                    on_cpu = _interp_forward(name, cpu, batch, "cpu")
                with se2_choices(cpu.double(), choices, replay=True):
                    on_f64 = _interp_forward(name, cpu, batch, "cpu", torch.float64)
                note = (f"; the card's SE(2) choices replayed ({stats[0]} calls), the CPU's own "
                        f"differ in {stats[2]} of {stats[1]} pairs")
            else:
                on_card = _interp_forward(name, model, batch, dev)
                on_cpu = _interp_forward(name, cpu, batch, "cpu")
            errs = []
            for k, (a, b) in enumerate(zip(on_card, on_cpu)):
                a, b = a.double().cpu(), b.double()
                d = (a - b).abs()
                if name == "sinkhorn" and k == 0:
                    # Where both warped confidences are small, the Sinkhorn blend
                    # (w0 z0 + w1 z1) / (w0 + w1) divides the rounding noise of
                    # 1 - p (p the dustbin mass) and picks the mix or the lerp at
                    # denom > 1e-6: there the two devices' f32 roundings part
                    # without either being wrong. Held are the pixels whose
                    # confidence (a lower bound of the blend's denominator) is at
                    # least SINKHORN_WELL_POSED, and the confidence everywhere;
                    # the rest is printed beside the CPU's f32-vs-f64 distance.
                    held = (on_cpu[1].double() >= SINKHORN_WELL_POSED)[:, :, None].expand_as(d)
                    f64_gap = float((b - on_f64[0].double()).abs().max() / b.abs().max())
                    note += (f"; output held on {float(held.float().mean()):.4f} of its elements "
                             f"(confidence >= {SINKHORN_WELL_POSED}), elsewhere max|d|/max|cpu| "
                             f"{float((d * ~held).max()) / float(b.abs().max()):.2e} "
                             f"(the CPU's own f32 vs f64, all elements: {f64_gap:.2e})")
                    d = d * held
                errs.append(float(d.max()) / float(b.abs().max()))
            print(f"[wan interp] {name}: f32 forward on the card vs the CPU, same weights and "
                  f"inputs (2 clips), max|d|/max|cpu| {['%.2e' % e for e in errs]} (tol "
                  f"{INTERP_CARD_TOL}){note}", flush=True)
            require(max(errs) <= INTERP_CARD_TOL, f"{name}: card vs CPU forward {errs}")
            del model, cpu, state

        # 2. the teacher precompute from the flow checkpoint and from lerp, joined back
        for teacher in ("lerp", f"model:{ckpts['flow']}"):
            label = teacher.split(":")[0]
            out = os.path.join(work, f"teacher_{label}")
            t0 = time.perf_counter()
            n = prep.main(["--data_root", data, "--out_root", out, "--teacher", teacher])
            took = time.perf_counter() - t0
            joined = list(WanSynthTarDataset(data, T=21, shuffle_shards=False, shuffle_buffer=1,
                                             teacher_root=out))
            require(n == INTERP_SAMPLES and len(joined) == INTERP_SAMPLES and all(
                s["teacher_latents"].shape == (10, *s["latents"].shape[1:]) and
                bool(np.isfinite(s["teacher_latents"]).all()) for s in joined),
                f"teacher {label}: {n} clips, joined shapes "
                f"{[s.get('teacher_latents', np.zeros(0)).shape for s in joined]}")
            lat_shape = joined[0]["latents"].shape[1:]
            if label == "lerp":
                lat = joined[0]["latents"]
                require(np.allclose(joined[0]["teacher_latents"][0], 0.5 * (lat[0] + lat[2]),
                                    atol=1e-6), "lerp teacher: the mid-frame is not the lerp")
            print(f"[wan interp] {tag} teacher precompute --teacher {label}: {n} clips, "
                  f"{n * 10} mid-frames of {'x'.join(map(str, lat_shape))} in {took:.2f} s "
                  f"({n / took:.2f} clips/s with the tar I/O); joined back by key", flush=True)

        # 3. eval_interpolators on the shards: lerp, flow, sinkhorn
        for interp in ("lerp", "flow", "sinkhorn"):
            argv = ["--interpolator", interp, "--data", "tar", "--data_root", data,
                    "--batch", "4", "--num_batches", "2", "--latent_h", "60", "--latent_w", "104"]
            if interp != "lerp":
                argv += ["--ckpt", ckpts[interp]]
            report = ev.main(argv)
            require(report["n_samples"] == 8 and all(
                np.isfinite(v) for v in report.values() if isinstance(v, float)),
                f"eval {interp}: {report}")
            print(f"[wan interp] {tag} eval_interpolators {interp}: latent_l1 "
                  f"{report['latent_l1']:.5f} (lerp {report['lerp_l1']:.5f}, "
                  f"{report['l1_vs_lerp_pct']:+.2f}%), psnr {report['psnr']:.3f}, ssim "
                  f"{report['ssim']:.4f}, outliers {report['outliers_worse_than_lerp']} of "
                  f"{report['n_samples']}; {report['samples_per_sec']:.2f} samples/s", flush=True)
        for name in list(ckpts):
            shutil.rmtree(os.path.join(work, name), ignore_errors=True)
        torch.cuda.empty_cache()

        # 4. full fine-tuning under bf16: the 4-layer gate, then the CLI at depth 30
        _full_ft_check(dev, data)
        launches = _full_ft_cli(dev, card, data, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[wan interp] phase 5g took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# Phase 5h: the toy-video and DiDeMo slice at the JAX trainers' default width
# (512d x 8 layers x 8 heads of 64, d_ff 2048). Toy video: T 16, 16x16x3 flat
# latents (768), K 4, levels 2; the trainers at batch 64, the sampler at 16
# x 2 batches with DDIM-20, the temporal-conv interpolator at batch 32 (T 21).
# DiDeMo: batch 16 on two caches of 32 clips, the synthetic one of
# precompute_clip_cache (T 16, [3, 16, 16] latents: 64 tokens a frame at
# patch 2, so K * N = 256 and T * N = 1024) and one of DiDeMo's own shapes
# (T 16, frame size 64: SD latents [4, 8, 8], 16 tokens a frame, K * N = 64,
# T * N = 256; CLIP ViT-B/32 unpooled text [77, 512]) built by the full-width
# SDVAE (seeded) from the toy frames. Each block takes fused_film_block under
# policy block where L <= 256, and under fused its attention takes
# small_mha_packed where 256 < H * L and L <= 256 (models/transformer.py):
# toy video (H * L = 32 and 128) then runs plain attention, as JAX does.
VTOY = dict(d_model=512, n_layers=8, n_heads=8, d_ff=2048, T=16, K=4, levels=2, batch=64)
VTOY_STEPS = 4                  # CLI steps per run
VTOY_SAMPLE = dict(batch=16, ddim_steps=20, n_batches=2)
DIDEMO_BATCH, DIDEMO_CLIPS = 16, 32
DIDEMO_SD = dict(T=16, frame_size=64, text_len=77, text_dim=512)
VIDEO_POLICIES = ("fused", "block")
# the block at the slice's shapes [B, L, 512] (toy Stage 1 / 2 at the trainers'
# batch and at the sampler's, DiDeMo's K * N and T * N at batch 16);
# small_mha_packed at DiDeMo's
VIDEO_BLOCK_SHAPES = ((64, 4), (64, 16), (16, 4), (16, 16), (16, 64), (16, 256))
VIDEO_PACKED_SHAPES = ((16, 64), (16, 256))


def _video_rule(policy, L):
    """Launches of each maze kernel in one forward of one block at length L."""
    from interpolated_diffusion_tpu_torch.models.transformer import (_use_fused_block_policy,
                                                                      _use_fused_packed)

    H = VTOY["n_heads"]
    return {"fused_film_block": int(_use_fused_block_policy(policy, H, L, False)),
            "small_mha_packed": int(_use_fused_packed(policy, H, L, False)), "small_mha": 0}


def _video_block_bound(B, L):
    D, F = VTOY["d_model"], VTOY["d_ff"]
    flops = B * L * (2 * D * 3 * D + 4 * L * D + 2 * D * D + 4 * D * F)
    return bound_ms(2 * (2 * B * L * D + 4 * B * D + 4 * D * D + 2 * D * F + 9 * D + F), flops)


def _video_kernel_times(dev, card):
    """Rows 1 and 2 at the slice's shapes against their twins (BLOCK_TOL /
    ATTN_TOL), with times beside the twins', the library's and the bounds."""
    import torch
    import torch.nn.functional as Fn
    from interpolated_diffusion_tpu_torch.kernels.fused_block import _torch_block, fused_film_block
    from interpolated_diffusion_tpu_torch.kernels.small_mha import (_torch_attention,
                                                                   small_mha_packed)

    D, H, F = VTOY["d_model"], VTOY["n_heads"], VTOY["d_ff"]
    gen = torch.Generator(device=dev).manual_seed(80)
    out = {"fused_film_block": {}, "small_mha_packed": {}}
    saved = fused_film_block.launches, small_mha_packed.launches
    with torch.inference_mode():
        for B, L in VIDEO_BLOCK_SHAPES:
            x, args = _block_inputs(B, L, D, H, F, True, gen, dev)
            err = _errors(fused_film_block(x, *args, n_heads=H),
                          _torch_block(x, *args, n_heads=H, use_film=True))[1]
            require(err <= BLOCK_TOL, f"fused_film_block [{B},{L},{D}]: {err:.3e} from its twin")
            k_ms = _time_ms(lambda: fused_film_block(x, *args, n_heads=H))
            p_ms = _time_ms(lambda: _torch_block(x, *args, n_heads=H, use_film=True), iters=5)
            lib_ms = _time_ms(lambda: _library_block(x, args, H, True))
            bound = _video_block_bound(B, L)
            dev_ms = _graph_ms(lambda: fused_film_block(x, *args, n_heads=H), launches=20)
            lib_dev = _graph_ms(lambda: _library_block(x, args, H, True), launches=20)
            out["fused_film_block"][f"[{B},{L},{D}]"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound[0],
                bound_by=bound[1], max_abs_err=err, device_ms=dev_ms, library_device_ms=lib_dev)
            print(f"[video] [{card}] fused_film_block [{B},{L},{D}] H={H} F={F}: kernel "
                  f"{k_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), plain twin {p_ms:.4f} "
                  f"ms, library chain {lib_ms:.4f} ms; device time by graph replay "
                  f"{dev_ms:.4f} ms, library chain {lib_dev:.4f} ms; max|d|/max|twin| {err:.2e} "
                  f"(tol {BLOCK_TOL})", flush=True)
        for B, L in VIDEO_PACKED_SHAPES:
            q, k, v = (torch.randn((B, L, D), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(3))
            err = _errors(small_mha_packed(q, k, v, H), _torch_attention(q, k, v, H))[1]
            require(err <= ATTN_TOL, f"small_mha_packed [{B},{L},{D}]: {err:.3e} from its twin")
            heads = lambda t: t.reshape(B, L, H, D // H).transpose(1, 2)
            k_ms = _time_ms(lambda: small_mha_packed(q, k, v, H))
            p_ms = _time_ms(lambda: _torch_attention(q, k, v, H))
            lib_ms = _time_ms(lambda: Fn.scaled_dot_product_attention(heads(q), heads(k),
                                                                      heads(v)))
            bound = bound_ms(2 * 4 * B * L * D, 4.0 * B * L * L * D)
            dev_ms = _graph_ms(lambda: small_mha_packed(q, k, v, H))
            lib_dev = _graph_ms(lambda: Fn.scaled_dot_product_attention(heads(q), heads(k),
                                                                        heads(v)))
            out["small_mha_packed"][f"[{B},{L},{D}]"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound[0],
                bound_by=bound[1], max_abs_err=err, device_ms=dev_ms, library_device_ms=lib_dev)
            print(f"[video] [{card}] small_mha_packed [{B},{L},{D}] H={H}: kernel {k_ms:.4f} ms, "
                  f"bound {bound[0]:.4f} ms ({bound[1]}), plain twin {p_ms:.4f} ms, library "
                  f"(scaled_dot_product_attention) {lib_ms:.4f} ms; device time by graph "
                  f"replay {dev_ms:.4f} ms, library {lib_dev:.4f} ms; max|d|/max|twin| "
                  f"{err:.2e} (tol {ATTN_TOL})", flush=True)
    fused_film_block.launches, small_mha_packed.launches = saved
    return out


def _video_gate(label, loss_of, leaves, names, per_layer, zero_ok=()):
    """One loss + every leaf's gradient from the same weights, batch and
    draws on the kernel path and on the twin path (MAZE_LOSS_TOL /
    MAZE_GRAD_TOL); the kernel path's launches and twin calls. Leaves named
    in `zero_ok` may have a zero gradient (those that read the toy models'
    zero condition vector)."""
    import torch

    n = VTOY["n_layers"]

    def loss_and_grads():
        loss = loss_of()
        return loss.detach(), torch.autograd.grad(loss, leaves)

    _set_maze_counts(dict.fromkeys(per_layer, 0))
    with count_maze_twin_calls() as calls:
        loss_k, grads_k = loss_and_grads()
    counts = _maze_counts()
    with plain_twins():
        loss_t, grads_t = loss_and_grads()
    rel_loss = abs(loss_k.item() - loss_t.item()) / abs(loss_t.item())
    worst = max((_errors(a, b)[1], nm) for nm, a, b in zip(names, grads_k, grads_t))
    zero = [nm for nm, g in zip(names, grads_t)
            if nm not in zero_ok and not bool(g.abs().max() > 0)]
    want = {k: v * n for k, v in per_layer.items()}
    print(f"[video] {label}: kernels vs plain twins, same weights / batch / draws: loss "
          f"{loss_k.item():.6f} vs {loss_t.item():.6f} (rel {rel_loss:.3e}, tol "
          f"{MAZE_LOSS_TOL}); worst gradient of {len(names)} leaves {worst[0]:.3e} at "
          f"{worst[1]} (tol {MAZE_GRAD_TOL}); launches {counts}", flush=True)
    require(counts == want and calls["forward"] == 0 and calls["backward"] == n,
            f"{label}: launches {counts}, twin calls {dict(calls)}; expected {want}, forward 0, "
            f"backward {n}")
    require(not zero, f"{label}: identically zero gradients at {zero[:3]}")
    require(rel_loss <= MAZE_LOSS_TOL, f"{label}: loss disagrees ({rel_loss:.3e})")
    require(worst[0] <= MAZE_GRAD_TOL, f"{label}: gradient of {worst[1]} ({worst[0]:.3e})")


def _video_trainer_cli(label, main_fn, argv, per_layer, out_dir, load):
    """A trainer CLI for VTOY_STEPS steps: finite losses, launches per step,
    no forward twin call, s/step, peak memory; the checkpoint read back."""
    import numpy as np

    state, counts, calls, log, secs, peak = _cli_run(main_fn, argv + [
        "--steps", str(VTOY_STEPS), "--log_every", "1", "--save_every", str(VTOY_STEPS),
        "--out_dir", out_dir], maze=True)
    n = VTOY["n_layers"]
    losses = [float(x) for x in __import__("re").findall(r"step \d+ loss (\S+)", log)]
    want = {k: per_layer.get(k, 0) * n * VTOY_STEPS for k in _maze_counts()}
    backward = n * VTOY_STEPS if any(per_layer.values()) else 0
    require(len(losses) == VTOY_STEPS and all(np.isfinite(losses)),
            f"{label}: losses {losses}")
    require(counts == want and calls["forward"] == 0 and calls["backward"] == backward,
            f"{label}: launches {counts}, twin calls {calls}; expected {want}")
    model, _ = load(out_dir)
    got = dict(model.named_parameters())
    require(all(bool((got[k].float() == state.params[k].detach().float()).all())
                for k in state.params), f"{label}: the checkpoint does not read back")
    per = {k: v // VTOY_STEPS for k, v in counts.items() if v}
    print(f"[video] {label}: {VTOY_STEPS} steps, {_s_per_step(log):.4f} s/step (mean with the "
          f"first), peak memory {peak:.2f} GiB, losses {[round(x, 4) for x in losses]}, "
          f"launches per step {per or 0}, no forward twin call; checkpoint read back; "
          f"{secs:.1f} s", flush=True)
    return per, _s_per_step(log)


def _card_vs_cpu(label, dev, build, inputs, forward):
    """The f32 forward of one seeded model on the card and on the CPU, same
    weights and inputs (TF32 off): max|d| / max|cpu| of each output."""
    import copy

    import torch

    cpu = build()
    card = copy.deepcopy(cpu).to(dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        on_card = forward(card, *(x.to(dev) for x in inputs))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        on_cpu = forward(cpu, *inputs)
    errs = [_errors(a.cpu(), b)[1] for a, b in zip(on_card, on_cpu)]
    print(f"[video] {label}: f32 forward on the card vs the CPU, max|d|/max|cpu| "
          f"{['%.2e' % e for e in errs]} (tol {INTERP_CARD_TOL}); first call on the card "
          f"{card_s * 1e3:.1f} ms", flush=True)
    require(max(errs) <= INTERP_CARD_TOL, f"{label}: card vs CPU {errs}")
    return card


def _toy_frames(n, T, size, seed):
    """RGB frames [n, T, 3, size, size] in [0, 1] of the moving-shapes videos."""
    import numpy as np
    from interpolated_diffusion_tpu_torch.data.toy_video import MovingShapesVideoDataset

    ds = MovingShapesVideoDataset(T=T, H=size, seed=seed)
    return np.stack([np.transpose(ds._simulate(np.random.RandomState(seed + i)), (0, 3, 1, 2))
                     for i in range(n)]).astype(np.float32)


def _sd_cache(dev, card, root):
    """A cache of DiDeMo's own shapes: toy frames (T 16, 64x64) through the
    full-width SDVAE (seeded) to [16, 4, 8, 8] latents, unpooled text [77,
    512], written by data/didemo.write_clip_cache."""
    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.data.didemo import write_clip_cache
    from interpolated_diffusion_tpu_torch.models.init import build_model
    from interpolated_diffusion_tpu_torch.models.sd_vae import SDVAE

    c = DIDEMO_SD
    frames = _toy_frames(DIDEMO_CLIPS, c["T"], c["frame_size"], seed=90)
    vae = build_model(SDVAE, generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev).eval()
    t0 = time.perf_counter()
    with torch.no_grad():
        lat = torch.cat([vae.encode(torch.from_numpy(frames[i:i + 8]).to(dev))
                         for i in range(0, DIDEMO_CLIPS, 8)]).cpu().numpy()
    took = time.perf_counter() - t0
    require(lat.shape == (DIDEMO_CLIPS, c["T"], 4, 8, 8) and bool(np.isfinite(lat).all()),
            f"SD cache: latents {lat.shape}")
    r = np.random.RandomState(91)
    write_clip_cache(root, "train", [
        {"latents": lat[i], "text_embed": (r.randn(c["text_len"], c["text_dim"]) * 0.02)
         .astype(np.float32)} for i in range(DIDEMO_CLIPS)], shard_size=DIDEMO_CLIPS)
    print(f"[video] [{card}] SD cache: {DIDEMO_CLIPS} clips x {c['T']} frames of "
          f"{c['frame_size']}x{c['frame_size']} through the full-width SDVAE to latents "
          f"{list(lat.shape[1:])} in {took:.2f} s (first calls included); text "
          f"[{c['text_len']}, {c['text_dim']}]", flush=True)
    del vae
    torch.cuda.empty_cache()


def phase_video_toy(dev, card, profile=False):
    """Phase 5h. Returns (launches {kernel: {what: launches per step or
    call}}, times {kernel: {shape: {...}}})."""
    import shutil

    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.data import precompute_clip_cache
    from interpolated_diffusion_tpu_torch.data.dataset import BatchLoader
    from interpolated_diffusion_tpu_torch.data.didemo import CachedClipDataset
    from interpolated_diffusion_tpu_torch.data.toy_video import MovingShapesVideoDataset
    from interpolated_diffusion_tpu_torch.diagnostics import eval_interpolators as ev
    from interpolated_diffusion_tpu_torch.models import loading
    from interpolated_diffusion_tpu_torch.models.frame_vae import FrameVAE
    from interpolated_diffusion_tpu_torch.models.init import build_model
    from interpolated_diffusion_tpu_torch.models.interpolators import (
        LatentLerpResidualInterpolator)
    from interpolated_diffusion_tpu_torch.models.sd_vae import SDVAE
    from interpolated_diffusion_tpu_torch.ops.ddpm import make_timesteps
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.sample import sample_toy_video as sampler
    from interpolated_diffusion_tpu_torch.train import (train_interp_levels_didemo as il_dd,
                                                        train_interp_levels_toy_video as il_toy,
                                                        train_keypoints_didemo as kp_dd,
                                                        train_keypoints_toy_video as kp_toy,
                                                        train_video_interpolator as vi)
    from interpolated_diffusion_tpu_torch.train.common import to_device

    t_phase = time.perf_counter()
    tag = f"[{card}]"
    n, T, K, levels = VTOY["n_layers"], VTOY["T"], VTOY["K"], VTOY["levels"]
    launches = {"fused_film_block": {}, "small_mha_packed": {}}

    def record(what, per):
        for k in launches:
            launches[k][what] = per.get(k, 0)

    times = _video_kernel_times(dev, card)
    work = tempfile.mkdtemp(prefix="video_toy_")
    try:
        # 1. the toy trainers: the gate under block at batch 64, then the CLIs
        ds = MovingShapesVideoDataset(T=T)
        toy_batch = to_device({"x": ds.get_batch(np.arange(VTOY["batch"]))["x"]}, dev)
        toy = (("toy stage 1", kp_toy, K, "keypoints_toy_video"),
               ("toy stage 2", il_toy, T, "interp_levels_toy_video"))
        ckpts = {}
        for label, mod, L, stage in toy:
            args = mod.build_argparser().parse_args(["--attn_policy", "block", "--seed", "81"])
            require((args.d_model, args.n_layers, args.n_heads, args.d_ff, args.T,
                     args.batch, args.bf16) == (512, n, 8, 2048, T, VTOY["batch"], 1),
                    f"{label}: trainer defaults changed")
            model = mod.build_model(args, 768, dev)
            _nonzero_head(model)
            leaves = dict(model.named_parameters())
            if mod is kp_toy:
                sched = make_schedule(args.schedule, args.N_train, device=dev)
                loss_of = lambda: kp_toy.keypoint_loss(
                    model, args, sched, toy_batch, torch.Generator(device=dev).manual_seed(82))[0]
            else:
                loss_of = lambda: il_toy.interp_loss(
                    model, args, toy_batch, torch.Generator(device=dev).manual_seed(82))[0]
            # no maze encoder: the condition vector is zero, and so are the
            # gradients of the weights that read it (cond_proj, film1, film2)
            zero_ok = {k for k in leaves if k == "cond_proj.weight" or
                       (".film" in k and k.endswith(".weight"))}
            _video_gate(f"{tag} {label} [{VTOY['batch']},{L},512] loss + gradients", loss_of,
                        list(leaves.values()), list(leaves), _video_rule("block", L), zero_ok)
            del model, leaves
            for policy in VIDEO_POLICIES:
                out = os.path.join(work, f"{stage}_{policy}")
                per, _ = _video_trainer_cli(
                    f"{tag} {label} CLI at its defaults (batch {VTOY['batch']}) policy {policy}",
                    mod.main, ["--attn_policy", policy], _video_rule(policy, L), out,
                    lambda d: loading.load_toy_video_model(d, stage, True, False, dev))
                record(f"toy_{stage.split('_')[0]}_train_{policy}_per_step", per)
                ckpts[stage] = out
            torch.cuda.empty_cache()

        # 2. the toy sampler on the block runs' checkpoints, both policies
        s = VTOY_SAMPLE
        evals = len(make_timesteps(100, s["ddim_steps"], "linear")) - 1
        argv = ["--kp_ckpt", ckpts["keypoints_toy_video"], "--interp_ckpt",
                ckpts["interp_levels_toy_video"], "--batch", str(s["batch"]), "--num_batches",
                str(s["n_batches"]), "--ddim_steps", str(s["ddim_steps"])]
        for policy in VIDEO_POLICIES:
            summ, counts, calls, log, secs, peak = _cli_run(sampler.main, argv + [
                "--attn_policy", policy, "--out_dir", os.path.join(work, f"sample_{policy}")],
                maze=True)
            per_call = {k: v // s["n_batches"] for k, v in counts.items()}
            want = {k: (evals * r * n + 2 * levels * n * _video_rule(policy, T)[k])
                    for k, r in _video_rule(policy, K).items()}
            require(per_call == want and calls["total"] == 0,
                    f"toy sampler {policy}: launches per call {per_call}, twin calls {calls}; "
                    f"expected {want}")
            require(all(np.isfinite(v) for v in summ.values()), f"toy sampler: {summ}")
            record(f"toy_sample_{policy}_per_call", per_call)
            print(f"[video] {tag} sample_toy_video policy {policy} (B {s['batch']} x "
                  f"{s['n_batches']}, ddim-{s['ddim_steps']}: {evals} Stage-1 evaluations, "
                  f"{levels} levels x 2 refinements): launches per call "
                  f"{ {k: v for k, v in per_call.items() if v} or 0}, no twin call; "
                  f"{summ.get('samples_per_sec', 0):.1f} samples/s, peak {peak:.2f} GiB; "
                  + ", ".join(f"{k} {v:.5f}" for k, v in summ.items() if k.endswith("_gt")),
                  flush=True)
        # the pipeline on the block runs' checkpoints at the CLI's batch, kernel
        # path against twin path on the same clips and draws; Stage 2's
        # zero-initialised head (still ~0 after 4 steps) gets small seeded
        # values, so that its blocks move each refinement
        kp, kp_meta = loading.load_toy_video_model(ckpts["keypoints_toy_video"],
                                                   "keypoints_toy_video", device=dev)
        il, il_meta = loading.load_toy_video_model(ckpts["interp_levels_toy_video"],
                                                   "interp_levels_toy_video", device=dev)
        _nonzero_head(il)
        for m in (kp, il):
            m.set_attn_policy("block")
        pipe = sampler.make_toy_pipeline(kp, kp_meta, il, il_meta, "ddim", s["ddim_steps"])
        x0 = torch.as_tensor(ds.get_batch(np.arange(s["batch"]))["x"]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(92)
        draws = {"noise": torch.randn((s["batch"], K, 768), generator=gen, device=dev),
                 "mask_rand": torch.rand((s["batch"], T), generator=gen, device=dev)}
        want = {k: evals * r * n + 2 * levels * n * _video_rule("block", T)[k]
                for k, r in _video_rule("block", K).items()}
        _set_maze_counts(dict.fromkeys(want, 0))
        with count_maze_twin_calls() as calls:
            out_k = pipe(x0, draws)
        counts = _maze_counts()
        with plain_twins():
            out_t = pipe(x0, draws)
        require(counts == want and calls["total"] == 0 and _maze_counts() == counts,
                f"toy pipeline: launches {counts} then {_maze_counts()}, twin calls {calls}; "
                f"expected {want}, none on the twin path")
        _, z_k, xi_k, xr_k, xoi_k, xor_k = out_k
        _, z_t, xi_t, xr_t, xoi_t, xor_t = out_t
        pairs = {"z_pred": (z_k, z_t), "refined - interp": (xr_k - xi_k, xr_t - xi_t),
                 "oracle_refined - oracle_interp": (xor_k - xoi_k, xor_t - xoi_t)}
        errs = {name: _errors(a, b)[1] for name, (a, b) in pairs.items()}
        scale = {name: b.abs().max().item() for name, (_, b) in pairs.items()}
        require(all(bool(torch.isfinite(t).all()) for t in out_k[1:]) and
                min(scale.values()) > 0 and max(errs.values()) <= PIPE_TOL,
                f"toy pipeline: kernel path vs twin path {errs}, twin max|.| {scale}")
        print(f"[video] {tag} toy pipeline B {s['batch']} ddim-{s['ddim_steps']} block, Stage-2 "
              f"head seeded, kernels vs plain twins on the same clips and draws: max|d|/max|twin| "
              + ", ".join(f"{k} {v:.3e} (twin max {scale[k]:.3e})" for k, v in errs.items())
              + f" (tol {PIPE_TOL}); launches {counts}, none on the twin path", flush=True)
        if profile:
            what = f"one toy sampler call (ddim-{s['ddim_steps']}, B={s['batch']}, block)"
            wall, device = _profile_call(lambda: pipe(x0, draws), tag, what)
            print(f"[video] {tag} {what}: median wall {wall * 1e3:.1f} ms of 5 calls "
                  f"({s['batch'] / wall:.1f} samples/s), device time {device:.1f} ms under the "
                  f"profiler: the device is busy {device / (wall * 1e3):.2f} of the call",
                  flush=True)
        del kp, il, pipe

        # 3. the temporal-conv interpolator (toy, batch 32) and the VAEs / the
        # residual interpolator: the card's f32 forward against the CPU's
        out = os.path.join(work, "video_interp")
        per, _ = _video_trainer_cli(f"{tag} train_video_interpolator --workload toy (batch 32)",
                                    vi.main, ["--workload", "toy"], {}, out,
                                    lambda d: loading.load_video_interpolator(d, device=dev))
        z = torch.as_tensor(MovingShapesVideoDataset(T=21).get_batch(range(2))["x"])
        _card_vs_cpu(f"{tag} TinyTemporalInterpolator [2, 21, 768]", dev,
                     lambda: loading.load_video_interpolator(out, device="cpu")[0], (z,),
                     lambda m, x: (m(x),))
        g = torch.Generator().manual_seed(83)
        za, zb = torch.randn((2, 16, 768), generator=g), torch.randn((2, 16, 768), generator=g)
        alpha = torch.rand((2, 16), generator=g)
        _card_vs_cpu(f"{tag} LatentLerpResidualInterpolator (768, hidden 256)", dev,
                     lambda: build_model(LatentLerpResidualInterpolator, data_dim=768,
                                         generator=torch.Generator().manual_seed(84),
                                         zero_init_scale=0.05).eval(),
                     (za, zb, alpha), lambda m, a, b, al: m(a, b, al))
        frames64 = torch.from_numpy(_toy_frames(1, 2, 64, seed=85))
        _card_vs_cpu(f"{tag} FrameVAE (base 32) encode + decode [1, 2, 3, 64, 64]", dev,
                     lambda: build_model(FrameVAE, generator=torch.Generator().manual_seed(86))
                     .eval(), (frames64,), lambda m, f: (m.encode(f), m.decode(m.encode(f))))
        for frames in (frames64, torch.from_numpy(_toy_frames(1, 1, 256, seed=87))):
            shp = list(frames.shape)
            vae = _card_vs_cpu(f"{tag} SDVAE (SD 1.x widths) encode + decode {shp}", dev,
                               lambda: build_model(SDVAE, generator=torch.Generator()
                                                   .manual_seed(0)).eval(), (frames,),
                               lambda m, f: (m.encode(f), m.decode(m.encode(f))))
            f_dev = frames.to(dev)
            with torch.no_grad():
                enc_ms = _time_ms(lambda: vae.encode(f_dev), iters=5, warmup=1)
                lat = vae.encode(f_dev)
                dec_ms = _time_ms(lambda: vae.decode(lat), iters=5, warmup=1)
            print(f"[video] {tag} SDVAE {shp} f32: encode {enc_ms:.2f} ms, decode {dec_ms:.2f} "
                  f"ms", flush=True)
            del vae
        torch.cuda.empty_cache()

        # 4. eval_interpolators --rgb: SD latents 32x32 (256x256 RGB), batch 1
        t0 = time.perf_counter()
        report = ev.main(["--rgb", "1", "--latent_c", "4", "--latent_h", "32", "--latent_w",
                          "32", "--batch", "1", "--num_batches", "2"])
        require(all(k in report and np.isfinite(report[k]) for k in
                    ("rgb_psnr", "rgb_psnr_lerp", "rgb_ssim", "rgb_ssim_lerp")),
                f"eval --rgb: {report}")
        print(f"[video] {tag} eval_interpolators --rgb 1 --latent_c 4 (T 21, 32x32 latents, "
              f"batch 1 x 2, seeded SDVAE): rgb_psnr {report['rgb_psnr']:.3f} (lerp "
              f"{report['rgb_psnr_lerp']:.3f}), rgb_ssim {report['rgb_ssim']:.4f}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # 5. DiDeMo: the synthetic cache and one of DiDeMo's own shapes
        caches = {"synthetic": os.path.join(work, "cache_synth"),
                  "sd": os.path.join(work, "cache_sd")}
        precompute_clip_cache.main(["--cache_dir", caches["synthetic"], "--synthetic", "1",
                                    "--max_samples", str(DIDEMO_CLIPS), "--shard_size",
                                    str(DIDEMO_CLIPS)])
        _sd_cache(dev, card, caches["sd"])
        for cname, root in caches.items():
            batch0 = next(iter(BatchLoader(CachedClipDataset(root), DIDEMO_BATCH, seed=0)))
            b = to_device({k: batch0[k] for k in ("latents", "text_embed")}, dev)
            Tc, C, Hh, W = batch0["latents"].shape[1:]
            N = (Hh // 2) * (W // 2)
            for label, mod, L in (("stage 1", kp_dd, K * N), ("stage 2", il_dd, Tc * N)):
                stage = "keypoints_didemo" if mod is kp_dd else "interp_levels_didemo"
                what = f"didemo {cname} cache {label} [{DIDEMO_BATCH},{L},512]"
                for policy in VIDEO_POLICIES:
                    rule = _video_rule(policy, L)
                    if any(rule.values()):
                        args = mod.build_argparser().parse_args(
                            ["--cache_dir", root, "--attn_policy", policy, "--seed", "88"])
                        _, _, model = mod.make_trainer(args, dev, batch0)
                        _nonzero_head(model)
                        leaves = dict(model.named_parameters())
                        gen_of = lambda: torch.Generator(device=dev).manual_seed(89)
                        if mod is kp_dd:
                            sched = make_schedule(args.schedule, args.N_train, device=dev)
                            loss_of = lambda: kp_dd.keypoint_loss(model, args, sched, b,
                                                                  gen_of())[0]
                        else:
                            loss_of = lambda: il_dd.interp_loss(model, args, b, gen_of())[0]
                        _video_gate(f"{tag} {what} policy {policy} loss + gradients", loss_of,
                                    list(leaves.values()), list(leaves), rule)
                        del model, leaves
                    per, _ = _video_trainer_cli(
                        f"{tag} {what} CLI (batch {DIDEMO_BATCH}) policy {policy}", mod.main,
                        ["--cache_dir", root, "--batch", str(DIDEMO_BATCH), "--attn_policy",
                         policy], rule, os.path.join(work, f"{cname}_{stage}_{policy}"),
                        lambda d, st=stage: loading.load_didemo_model(d, st, True, False, dev))
                    record(f"didemo_{cname}_{stage.split('_')[0]}_train_{policy}_per_step", per)
                    torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[video] phase 5h took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, times


def gemm_ab(card) -> int:
    """`--gemm-ab`: what the W-resident GEMM kernel buys over the streaming one.
    Four runs of this script's `--maze-kernels` part in processes of their own,
    in the order default, stream-only, stream-only, default: the second build
    sends every product to the streaming kernel (-DID_GEMM_STREAM_ONLY, through
    kernels/_build.py's ID_KERNELS_NVCC_FLAGS). Each run holds its build against
    the plain twins first. ff2 (K = 1536) streams in both and reads the spread."""
    runs = []
    for variant in ("default", "stream-only", "stream-only", "default"):
        env = dict(os.environ)
        env.pop("ID_KERNELS_NVCC_FLAGS", None)
        if variant == "stream-only":
            env["ID_KERNELS_NVCC_FLAGS"] = "-DID_GEMM_STREAM_ONLY"
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--maze-kernels"],
                               env=env, capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            print(child.stdout[-4000:] + child.stderr[-4000:], flush=True)
            print(f"FAIL: the {variant} build's run exited {child.returncode}", flush=True)
            return 1
        runs.append((variant, json.loads(child.stdout.strip().splitlines()[-1])))
    tag = f"[{card}]"
    for i, entry in enumerate(runs[0][1]["gemm"]):
        what = f"{entry['epilogue']} M={entry['M']} N={entry['N']} K={entry['K']}"
        key = "device_ms" if "device_ms" in entry else "ms"
        cells = ", ".join(f"{variant} {run['gemm'][i][key]:.4f}" for variant, run in runs)
        print(f"[gemm-ab] {tag} gemm_bias_act {what} "
              f"({'graph replay' if key == 'device_ms' else 'events'}), ms: {cells}", flush=True)
    for shape in runs[0][1]["block"]:
        cells = ", ".join(f"{variant} {run['block'][shape]:.4f}" for variant, run in runs)
        print(f"[gemm-ab] {tag} fused_film_block {shape}, ms: {cells}", flush=True)
    return 0


# Phase 5i: multi-device (torch.distributed). (a) one process on NCCL with
# torchrun's variables set here (world 1): the maze Stage-2 trainer CLI with
# --n_data_shards 1 against the run without it, and the Wan Phase-1 trainer
# with Switch-MoE blocks; (b) two processes on the one card over gloo (NCCL
# refuses two ranks on one GPU), CUDA compute with host-staged hops:
# ring-SLA, dense ring attention and the causal CLI with --seq_shard 2.
# Host-staged gloo times show that the path runs; they are not the speed of
# the port's multi-GPU path (NCCL over NVLink).
MD_MAZE_STEPS = 3
# The MoE trainer's depth on one card: each MoE block holds 2 x 8 x 1536 x 8960
# = 220.2 M expert weights beside ~19 M attention weights; with f32 masters,
# gradients and Adam's two moments (16 B a weight) that is 3.83 GB a block,
# 30.6 GB at 8 blocks (30 would need ~115 GB), leaving room for a step's
# activations at L = 7800, batch 2 (remat) and the 7.7 GB checkpoint's host copy.
MD_MOE_LAYERS = 8
MD_MOE_GATE_LAYERS = 2
MD_MOE_STEPS = 3
MD_MOE_ARGS = ["--ffn_mode", "moe", "--n_experts", "8", "--lora_rank", "0", "--bf16", "1",
               "--attn_mode", "sla"]
# launches of rows 4-8 per MoE step under sla at MD_MOE_LAYERS (TRAIN_EXPECT's per-layer counts)
MD_MOE_EXPECT = tuple(c // TRAIN_LAYERS * MD_MOE_LAYERS for c in TRAIN_EXPECT["sla"])
MD_WORLD = 2
# ring-SLA at the 33k geometry of scripts/bench_wan33k.py (BH 12, Dh 128), L
# rounded up from 32760 so that each rank's shard divides both block sizes
MD_RING_SLA = dict(BH=12, L=32768, D=128, topk=0.1, blocks=(128, 256))
MD_RING = dict(B=1, H=12, L=4096, D=128)      # dense ring attention, f32
MD_RING_TOL = 1e-4                             # f32 ring vs f32 plain attention (TF32 off)
MD_CAUSAL = dict(batch=64, n_batches=1, chunk=16, K_min=4, ddim_steps=10)
MD_CAUSAL_TOL = 5e-2                           # positions in [0, 1], as PIPE_TOL
MD_TIMEOUT = 900


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _torchrun_world1():
    """torchrun's variables for one process (RANK 0, WORLD_SIZE 1, a free
    port on 127.0.0.1): the port's CLIs bring up NCCL from them. The group
    is destroyed and the variables removed on the way out."""
    import torch.distributed as dist

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def moe_routes(routes, replay=False):
    """Record into `routes`, in call order, every SwitchFFN's choice of
    expert per token; with `replay`, hand those back instead of the path's
    own argmax. Top-1 routing is discrete: an ulp upstream flips a token whose
    two best experts are near, on one path only. Yields [calls, tokens,
    tokens whose own choice differs]."""
    from interpolated_diffusion_tpu_torch.models.moe import SwitchFFN

    own, stats = SwitchFFN.route, [0, 0, 0]

    def route(self, probs):
        got = own(self, probs)
        if not replay:
            routes.append(got)
            return got
        kept = routes[stats[0] % len(routes)]   # remat recomputes a block: same order again
        stats[0] += 1
        stats[1] += kept.numel()
        stats[2] += int((got != kept).sum())
        return kept

    SwitchFFN.route = route
    try:
        yield stats
    finally:
        SwitchFFN.route = own


def _md_maze_dp(dev, card, workdir):
    """The maze Stage-2 trainer CLI at bench width (batch 256, policy block),
    MD_MAZE_STEPS steps: twice without --n_data_shards, then on NCCL at world
    1 with --n_data_shards 1. Where the two plain runs agree bit for bit, the
    NCCL run must too; where they do not (atomic adds in a backward sum in
    another order from run to run), its distance from the first plain run
    must not exceed theirs, and the script says so."""
    import re

    import torch
    from interpolated_diffusion_tpu_torch.train import train_interp_levels
    from interpolated_diffusion_tpu_torch.utils.checkpoint import load_checkpoint

    flags = ["--num_samples", str(MAZE_SAMPLES), "--attn_policy", "block", "--steps",
             str(MD_MAZE_STEPS), "--save_every", str(MD_MAZE_STEPS), "--log_every", "1",
             "--steps_per_call", "1", "--cache_dir", os.path.join(workdir, "data")]
    out = {}
    for name, extra in (("plain", []), ("again", []), ("dp1", ["--n_data_shards", "1"])):
        run_dir = os.path.join(workdir, f"md_maze_{name}")
        ctx = _torchrun_world1() if name == "dp1" else contextlib.nullcontext()
        with ctx, _tee_stdout() as log:
            t0 = time.perf_counter()
            train_interp_levels.main(flags + ["--out_dir", run_dir] + extra)
            torch.cuda.synchronize()
            if name == "dp1":
                import torch.distributed as dist

                backend = dist.get_backend()
                require(backend == "nccl" and dist.get_world_size() == 1,
                        f"--n_data_shards 1: backend {backend}, world {dist.get_world_size()}")
        losses = re.findall(r"step \d+ loss (\S+)", log.getvalue())
        _, payload = load_checkpoint(os.path.join(run_dir, f"ckpt_{MD_MAZE_STEPS}"))
        out[name] = (losses, payload["params"], time.perf_counter() - t0)
    (l0, p0, s0), (la, pa, _), (l1, p1, s1) = out["plain"], out["again"], out["dp1"]

    def distance(p):
        differ = [k for k in p0 if not torch.equal(p0[k], p[k])]
        return differ, max((float((p0[k].float() - p[k].float()).abs().max()) for k in differ),
                           default=0.0)

    differ_a, d_a = distance(pa)
    differ, d = distance(p1)
    why = (f"; the device run is not bitwise reproducible: {', '.join(differ_a[:3])}"
           if differ_a else "")
    print(f"[multi] {card} maze Stage-2 trainer CLI at bench width (384d x 12 x 12, batch 256, "
          f"block), {MD_MAZE_STEPS} steps: without --n_data_shards losses {l0} ({s0:.1f} s), "
          f"again {la}: {len(differ_a)} of {len(p0)} parameters differ between the two (max |d| "
          f"{d_a:.3e}{why}); "
          f"with --n_data_shards 1 on NCCL, world 1 (torchrun's variables set here) losses {l1} "
          f"({s1:.1f} s): {len(differ)} parameters differ from the first run (max |d| {d:.3e})",
          flush=True)
    if not differ_a:
        require(l0 == l1 and not differ, "--n_data_shards 1 on NCCL at world 1 changed a "
                f"bitwise-reproducible run: losses {l0} vs {l1}, parameters {differ[:3]}")
    else:
        require(d <= d_a and set(differ) <= set(differ_a),
                f"--n_data_shards 1 on NCCL at world 1: {differ[:3]} differ by {d:.3e}, more "
                f"than the run-to-run {d_a:.3e} of {differ_a[:3]}")


def _md_moe_gate(dev):
    """At MD_MOE_GATE_LAYERS of 30 layers, full width, the MoE Phase-1 loss
    and every weight's gradient, kernel path vs twin path (the kernel path's
    SLA LUTs and expert routes replayed)."""
    import torch
    from interpolated_diffusion_tpu_torch.ops.schedules import make_schedule
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1
    from interpolated_diffusion_tpu_torch.train.state import flatten_dict, tree_leaves
    from interpolated_diffusion_tpu_torch.train.wansynth_common import (build_wan,
                                                                        make_wansynth_loader)
    from interpolated_diffusion_tpu_torch.utils.prefetch import pinned_put

    args = p1.build_argparser().parse_args(MD_MOE_ARGS + [
        "--wan_layers", str(MD_MOE_GATE_LAYERS), "--num_samples", "8", "--seed", "61"])
    wan, fc = build_wan(args, True, device=dev, zero_init_scale=1e-2,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))
    batch = pinned_put(dev, keys=("latents", "text_embed"))(
        next(make_wansynth_loader(args, args.seed)))
    schedule = make_schedule(args.schedule, args.N_train, device=dev)
    N = (args.latent_h // 2) * (args.latent_w // 2)
    state, base, _, _, _ = p1.make_trainer(args, dev, wan, fc)
    names, leaves = list(flatten_dict(state.params)), tree_leaves(state.params)
    draws = p1.draw_phase1(torch.Generator(device=dev).manual_seed(62), args, args.batch,
                           (args.batch, args.K, N, args.latent_c * 4))

    def loss_and_grads():
        loss, _ = p1.phase1_loss(wan, fc, args, schedule, batch, draws)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    luts, routes = [], []
    with sla_luts(luts), moe_routes(routes):
        loss_k, grads_k = loss_and_grads()
    with wan_plain_twins(), sla_luts(luts, replay=True) as lut_stats, \
            moe_routes(routes, replay=True) as route_stats:
        loss_t, grads_t = loss_and_grads()
    rel_loss = abs(loss_k.item() - loss_t.item()) / abs(loss_t.item())
    top = max(float(b.abs().max()) for b in grads_t)
    scale = lambda b: max(float(b.abs().max()), FULL_FT_GRAD_FLOOR * top)
    worst = max((float((a - b).abs().max()) / scale(b), n)
                for n, a, b in zip(names, grads_k, grads_t))
    n_moe = sum(".moe_ffn." in n for n in names)
    print(f"[multi] MoE Phase-1 step (--ffn_mode moe, 8 experts, --lora_rank 0 --bf16 1, "
          f"{MD_MOE_GATE_LAYERS} of 30 layers, full width, batch 2, L = 7800, sla): kernels vs "
          f"plain twins, same state / batch / draws, the kernel path's LUTs and routes replayed "
          f"({lut_stats[0]} SLA calls, own LUTs differ in {lut_stats[2]} of {lut_stats[1]} rows; "
          f"{route_stats[0]} routings, own routes differ in {route_stats[2]} of "
          f"{route_stats[1]} tokens): loss {loss_k.item():.6f} vs {loss_t.item():.6f} (rel "
          f"{rel_loss:.3e}, tol {TRAIN_LOSS_TOL}); {len(names)} weights ({n_moe} of the MoE "
          f"FFNs), worst gradient max|d|/max|twin| = {worst[0]:.3e} at {worst[1]} (tol "
          f"{TRAIN_GRAD_TOL}, floor {FULL_FT_GRAD_FLOOR} of the largest leaf's {top:.3e})",
          flush=True)
    require(base is None and n_moe == 5 * MD_MOE_GATE_LAYERS,
            f"MoE gate: base {base is None}, {n_moe} MoE leaves")
    require(rel_loss <= TRAIN_LOSS_TOL, f"MoE gate: loss disagrees ({rel_loss})")
    require(worst[0] <= TRAIN_GRAD_TOL, f"MoE gate: gradient of {worst[1]} disagrees "
            f"({worst[0]:.3e})")
    del state, grads_k, grads_t, wan, fc, batch, luts, routes
    torch.cuda.empty_cache()


def _md_moe_cli(dev, card, workdir):
    """The MoE Phase-1 trainer CLI at MD_MOE_LAYERS of 30 layers, full width,
    on NCCL at world 1 with --ckpt_async 1: launches per step of rows 4-8, no
    twin call, s/step, peak memory, the sharded checkpoint read back equal.
    Returns {kernel: launches per step}."""
    import re
    import shutil

    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.train import train_keypoints_wansynth as p1
    from interpolated_diffusion_tpu_torch.train.state import flatten_dict
    from interpolated_diffusion_tpu_torch.utils.checkpoint import load_checkpoint

    out = os.path.join(workdir, "md_moe")
    argv = MD_MOE_ARGS + ["--wan_layers", str(MD_MOE_LAYERS), "--num_samples", "8",
                          "--steps", str(MD_MOE_STEPS), "--save_every", str(MD_MOE_STEPS),
                          "--log_every", "1", "--ckpt_async", "1", "--n_data_shards", "1",
                          "--out_dir", out]
    with _torchrun_world1():
        state, counts, twin, log, secs, peak = _cli_run(p1.main, argv)
    steps = [(int(a), float(b), float(c)) for a, b, c in re.findall(_STEP_LINE, log)]
    want = {k: c * MD_MOE_STEPS for k, c in zip(TRAIN_KERNELS, MD_MOE_EXPECT)}
    require([s[0] for s in steps] == list(range(MD_MOE_STEPS)) and
            all(np.isfinite(s[1]) for s in steps), f"MoE trainer CLI: steps {steps}")
    require(counts == want and twin == 0,
            f"MoE trainer CLI: launches {counts}, twin calls {twin}, expected {want} and 0")
    ckpt = os.path.join(out, f"ckpt_{MD_MOE_STEPS}")
    header = json.load(open(os.path.join(ckpt, "meta.json")))
    t0 = time.perf_counter()
    _, payload = load_checkpoint(ckpt)
    t_read = time.perf_counter() - t0
    saved, live = flatten_dict(payload["params"]), flatten_dict(state.params)
    differ = [k for k, p in live.items() if not torch.equal(saved[k], p.detach().cpu())]
    n_weights = sum(p.numel() for p in live.values())
    n_expert = sum(p.numel() for k, p in live.items() if ".moe_ffn.ffn_" in k)
    meta = header["meta"]
    del state, payload, saved, live
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    per = sum(s[2] for s in steps[1:]) / max(1, len(steps) - 1)
    print(f"[multi] {card} MoE Phase-1 trainer CLI on NCCL, world 1 (--ffn_mode moe, 8 experts, "
          f"capacity factor 1.25, --lora_rank 0 --bf16 1, {MD_MOE_LAYERS} of 30 layers at full "
          f"width, batch 2, L = 7800, sla, remat; {n_weights / 1e6:.1f} M weights, "
          f"{n_expert / 1e6:.1f} M of them experts): {per:.3f} s/step after the first "
          f"({steps[0][2]:.3f} s), peak memory {peak:.2f} GiB, launches per step "
          f"{dict(zip(TRAIN_KERNELS, MD_MOE_EXPECT))}, twin calls 0; losses "
          f"{[round(s[1], 4) for s in steps]}; --ckpt_async 1 checkpoint format "
          f"{header['format']} ({header['n_shards']} shard), meta ffn_mode {meta['ffn_mode']} "
          f"n_experts {meta['n_experts']} capacity_factor {meta['capacity_factor']}, read back "
          f"in {t_read:.1f} s: {len(differ)} leaves differ; {secs:.1f} s in all", flush=True)
    require(header["format"] == "torch_sharded" and meta["ffn_mode"] == "moe" and
            meta["n_experts"] == 8 and not differ,
            f"MoE trainer CLI checkpoint: {header['format']}, meta {meta.get('ffn_mode')}, "
            f"leaves that differ {differ[:3]}")
    return dict(zip(TRAIN_KERNELS, MD_MOE_EXPECT))


def _seeded_causal_ckpts(dev, workdir):
    """Bench-width Stage-1 and causal Stage-2 checkpoints from seeded weights
    (the Stage-2 head made non-zero), for --multi-device alone."""
    import torch
    from interpolated_diffusion_tpu_torch.train import train_interp_levels as ps2
    from interpolated_diffusion_tpu_torch.train import train_keypoints as ps1
    from interpolated_diffusion_tpu_torch.utils.checkpoint import save_checkpoint

    paths = []
    for name, mod, flags in (("kp", ps1, []), ("ilc", ps2, ["--causal", "1"])):
        args = mod.build_argparser().parse_args(flags + ["--device", "cuda", "--seed", "71"])
        model = mod.build_model(args, BENCH["data_dim"], dev)
        if name == "ilc":
            _nonzero_head(model)
        params = {k: v.detach() for k, v in model.named_parameters()}
        path = os.path.join(workdir, f"md_{name}")
        save_checkpoint(os.path.join(path, "ckpt_1"), params, None, 1, params,
                        mod.make_meta(args, BENCH["data_dim"]))
        paths.append(path)
    return paths


def _md_spawn(jobs, workdir, world=MD_WORLD):
    """`world` processes of this script on the one card (gloo), each running
    `jobs` [(name, payload)]; returns each rank's {name: result}. A rank's
    non-zero exit or a run past MD_TIMEOUT fails the phase (the others are
    killed)."""
    import torch

    job_file = os.path.join(workdir, "md_jobs.pt")
    torch.save(jobs, job_file)
    init = os.path.join(workdir, f"md_store_{os.getpid()}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env["LOCAL_RANK"] = "0"       # every rank computes on the one card
    procs = []
    for r in range(world):
        out = os.path.join(workdir, f"md_out_{r}.pt")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), "--md-worker",
                                        str(r), str(world), init, job_file, out], env=env,
                                       cwd=ROOT), out))
    failed = None
    try:
        for r, (p, _) in enumerate(procs):
            if p.wait(timeout=MD_TIMEOUT) != 0 and failed is None:
                failed = f"rank {r} exited with {p.returncode}"
    except subprocess.TimeoutExpired:
        failed = f"ranks still running after {MD_TIMEOUT} s"
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(failed is None, f"multi-device ranks: {failed}")
    return [torch.load(out, weights_only=False) for _, out in procs]


def md_worker(argv) -> int:
    """One rank of _md_spawn: gloo over a file store, CUDA compute on the card."""
    import torch
    import torch.distributed as dist

    rank, world, init, job_file, out = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    sys.path.insert(0, ROOT)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank)
    results = {name: MD_JOBS[name](rank, world, payload)
               for name, payload in torch.load(job_file, weights_only=False)}
    torch.save(results, out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _md_job_ring_sla(rank, world, payload):
    """Ring-SLA on this rank's shard: the global LUT from the ring, the
    hops through the row-4 kernel (launches counted), against one process's
    block_sparse_attention on the full sequence with the same global LUT
    (kernel against kernel); the kernel's all-sentinel lse."""
    import torch
    import torch.distributed as dist
    from interpolated_diffusion_tpu_torch.kernels import block_sparse_attention as bsa
    from interpolated_diffusion_tpu_torch.kernels.sla import get_block_map
    from interpolated_diffusion_tpu_torch.parallel.collectives import all_gather
    from interpolated_diffusion_tpu_torch.parallel.ring_sla import (ring_block_sparse_attention,
                                                                     ring_sla_block_map)

    c = MD_RING_SLA
    group = dist.group.WORLD
    res = {}
    for block in c["blocks"]:
        g = torch.Generator(device="cuda").manual_seed(80 + block)
        q, k, v = (torch.randn((c["BH"], c["L"], c["D"]), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        n = c["L"] // world
        mine = slice(rank * n, (rank + 1) * n)
        ql, kl, vl = (x[:, mine].contiguous() for x in (q, k, v))
        with torch.no_grad():
            lut = ring_sla_block_map(ql, kl, group, c["topk"], block, block)
            bsa.block_sparse_attention.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = ring_block_sparse_attention(ql, kl, vl, lut, group, block, block)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = bsa.block_sparse_attention.launches
            lut_full = all_gather(lut, group, dim=1).contiguous()
            ref = bsa.block_sparse_attention(q, k, v, lut_full, block, block)[:, mine]
            _, own, _ = get_block_map(q, k, c["topk"], block, block)
        err = float((o.float() - ref.float()).abs().max()) / float(ref.float().abs().max())
        differ = int((own.sort(-1).values != lut_full.sort(-1).values).any(-1).sum())
        res[block] = dict(err=err, launches=launches, ms=ms, topk=lut.shape[-1],
                          lut_rows=lut_full.shape[0] * lut_full.shape[1], lut_differ=differ,
                          finite=bool(torch.isfinite(o.float()).all()))
    # a row of sentinels only, on the kernel: o = 0 and an lse far below any real one
    n_loc = n // 128
    sent = torch.full((1, n // 128, 3), n_loc, dtype=torch.int32, device="cuda")
    o_s, lse_s = bsa.block_sparse_attention_lse(ql[:1], kl[:1], vl[:1], sent, 128, 128)
    res["sentinel"] = dict(o_max=float(o_s.float().abs().max()), lse_max=float(lse_s.max()))
    return res


def _md_job_ring(rank, world, payload):
    """Dense ring attention (f32) on this rank's chunk, causal and not,
    against plain full attention on the card."""
    import torch
    import torch.distributed as dist
    from interpolated_diffusion_tpu_torch.parallel.ring import ring_self_attention

    c = MD_RING
    g = torch.Generator(device="cuda").manual_seed(90)
    q, k, v = (torch.randn((c["B"], c["H"], c["L"], c["D"]), generator=g, device="cuda")
               for _ in range(3))
    n = c["L"] // world
    mine = slice(rank * n, (rank + 1) * n)
    res = {}
    for causal in (False, True):
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = ring_self_attention(q[:, :, mine].contiguous(), k[:, :, mine].contiguous(),
                                    v[:, :, mine].contiguous(), dist.group.WORLD, causal)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            s = q[:, :, mine] @ k.transpose(-1, -2) * c["D"] ** -0.5
            if causal:
                keep = (torch.arange(c["L"], device="cuda")[None, :]
                        <= torch.arange(c["L"], device="cuda")[mine, None])
                s = s.masked_fill(~keep, float("-inf"))
            ref = torch.softmax(s, dim=-1) @ v
        res[causal] = dict(err=float((o - ref).abs().max()) / float(ref.abs().max()), ms=ms)
    return res


@contextlib.contextmanager
def _record_causal_outputs(outs):
    """Append every x_gen the causal CLI's pipeline returns to `outs`."""
    from interpolated_diffusion_tpu_torch.sample import generate_causal

    real = generate_causal.make_causal_pipeline

    def making(*a, **kw):
        pipe = real(*a, **kw)

        def recorded(*pa, **pkw):
            out = pipe(*pa, **pkw)
            outs.append((out[0] if isinstance(out, tuple) else out).detach().cpu())
            return out

        return recorded

    generate_causal.make_causal_pipeline = making
    try:
        yield outs
    finally:
        generate_causal.make_causal_pipeline = real


def _md_job_causal_cli(rank, world, payload):
    """The causal sampling CLI with --seq_shard `world` (Stage 2's delta as
    causal ring attention over the ranks): x_gen and the row-1 launches."""
    from interpolated_diffusion_tpu_torch.kernels.fused_block import fused_film_block
    from interpolated_diffusion_tpu_torch.sample import generate_causal

    fused_film_block.launches = 0
    outs = []
    t0 = time.perf_counter()
    with _record_causal_outputs(outs):
        generate_causal.main(payload["argv"] + ["--seq_shard", str(world)])
    return dict(x_gen=outs, launches=fused_film_block.launches,
                secs=time.perf_counter() - t0)


MD_JOBS = {"ring_sla": _md_job_ring_sla, "ring": _md_job_ring, "causal_cli": _md_job_causal_cli}


def phase_multi_device(dev, card, workdir, causal_ckpts=None):
    """Phase 5i. `causal_ckpts` (Stage 1, causal Stage 2): 5e's checkpoints in
    the full run, seeded ones under --multi-device. Returns {kernel:
    {what: launches}} of the phase's runs."""
    import numpy as np
    import torch
    from interpolated_diffusion_tpu_torch.kernels.fused_block import fused_film_block
    from interpolated_diffusion_tpu_torch.sample import generate_causal

    t_phase = time.perf_counter()
    tag = f"[{card}]"
    # (a) one process on NCCL
    _md_maze_dp(dev, card, workdir)
    _md_moe_gate(dev)
    moe_launches = _md_moe_cli(dev, card, workdir)

    # (b) two processes on the one card over gloo
    if causal_ckpts is None:
        causal_ckpts = _seeded_causal_ckpts(dev, workdir)
    kp_dir, il_dir = causal_ckpts
    c = MD_CAUSAL
    argv = ["--kp_ckpt", kp_dir, "--interp_ckpt", il_dir, "--device", "cuda", "--attn_policy",
            "block", "--batch", str(c["batch"]), "--num_batches", str(c["n_batches"]),
            "--chunk", str(c["chunk"]), "--K_min", str(c["K_min"]), "--ddim_steps",
            str(c["ddim_steps"]), "--num_samples", str(MAZE_SAMPLES), "--cache_dir",
            os.path.join(workdir, "data"), "--out_dir", os.path.join(workdir, "md_causal")]
    outs = []
    fused_film_block.launches = 0
    with _record_causal_outputs(outs):     # one process, --seq_shard 0 (also builds the data)
        generate_causal.main(argv + ["--seq_shard", "0"])
    one_launches = fused_film_block.launches
    t0 = time.perf_counter()
    ranks = _md_spawn([("ring_sla", None), ("ring", None), ("causal_cli", {"argv": argv})],
                      workdir)
    secs = time.perf_counter() - t0
    print(f"[multi] {tag} {MD_WORLD} processes on one card, torch.distributed backend gloo "
          f"(NCCL refuses two ranks on one GPU), CUDA compute, hops staged through host memory "
          f"(these times show the path runs; they are not the port's multi-GPU speed): "
          f"{secs:.1f} s for the three jobs with the ranks' start", flush=True)

    sla_launches = 0
    for block in MD_RING_SLA["blocks"]:
        per = [r["ring_sla"][block] for r in ranks]
        sla_launches += sum(p["launches"] for p in per)
        worst = max(p["err"] for p in per)
        print(f"[multi] ring-SLA, BH {MD_RING_SLA['BH']}, L {MD_RING_SLA['L']} over "
              f"{MD_WORLD} ranks ({MD_RING_SLA['L'] // MD_WORLD} a rank), Dh 128, top-k "
              f"{MD_RING_SLA['topk']} ({per[0]['topk']} blocks), block {block}: row-4 launches "
              f"{[p['launches'] for p in per]} (hops x ranks), each rank's output vs one "
              f"process's block_sparse_attention on the full sequence with the same global LUT "
              f"max|d|/max|ref| = {worst:.3e} (tol {ATTN_TOL}); the single-device block map "
              f"differs from the ring's in {per[0]['lut_differ']} of {per[0]['lut_rows']} rows "
              f"(smooth-k mean and pooling rounded per shard in bf16); ring call "
              f"{[round(p['ms'], 2) for p in per]} ms (host-staged gloo)", flush=True)
        require(all(p["launches"] == MD_WORLD and p["finite"] for p in per) and
                worst <= ATTN_TOL, f"ring-SLA block {block}: launches "
                f"{[p['launches'] for p in per]}, err {worst:.3e}")
    sent = ranks[0]["ring_sla"]["sentinel"]
    print(f"[multi] the SLA kernel on a LUT of sentinels only: max|o| = {sent['o_max']:.1e}, "
          f"max lse = {sent['lse_max']:.4g} (base 2; the twin gives log2(1e-30) = -99.66)",
          flush=True)
    require(sent["o_max"] == 0.0 and sent["lse_max"] <= -99.0,
            f"all-sentinel hop: max|o| {sent['o_max']}, max lse {sent['lse_max']}")
    for causal in (False, True):
        per = [r["ring"][causal] for r in ranks]
        worst = max(p["err"] for p in per)
        print(f"[multi] dense ring attention, causal={causal}, [{MD_RING['B']}, {MD_RING['H']}, "
              f"{MD_RING['L']}, {MD_RING['D']}] f32 over {MD_WORLD} ranks vs plain full "
              f"attention: max|d|/max|ref| = {worst:.3e} (tol {MD_RING_TOL}); "
              f"{[round(p['ms'], 2) for p in per]} ms (host-staged gloo)", flush=True)
        require(worst <= MD_RING_TOL, f"dense ring attention causal={causal}: {worst:.3e}")
    got = [r["causal_cli"] for r in ranks]
    ref = outs[0]
    d = max(float((g["x_gen"][0] - ref).abs().max()) for g in got)
    print(f"[multi] causal CLI (generate_causal.main) at bench width, {c['batch']} x "
          f"{c['n_batches']}, chunk {c['chunk']}, K_min {c['K_min']}, DDIM-{c['ddim_steps']}, "
          f"block: --seq_shard {MD_WORLD} (Stage 2 as causal ring attention over the ranks) vs "
          f"--seq_shard 0 on the same checkpoints and seed: max |d| of positions = {d:.3e} (tol "
          f"{MD_CAUSAL_TOL}); row-1 launches {one_launches} alone, {[g['launches'] for g in got]}"
          f" a rank; {[round(g['secs'], 1) for g in got]} s a rank", flush=True)
    require(all(len(g["x_gen"]) == c["n_batches"] and
                bool(torch.isfinite(g["x_gen"][0]).all()) for g in got) and
            d <= MD_CAUSAL_TOL and all(g["launches"] == one_launches for g in got),
            f"causal CLI --seq_shard {MD_WORLD}: max |d| {d}, launches "
            f"{[g['launches'] for g in got]} vs {one_launches}")
    print(f"[multi] phase 5i passed in {time.perf_counter() - t_phase:.1f} s", flush=True)
    launches = {name: {"multi_device_moe_step": n} for name, n in moe_launches.items()}
    launches["block_sparse_attention"]["ring_sla"] = sla_launches
    launches["fused_film_block"] = {"causal_seq_shard_rank": got[0]["launches"]}
    return launches


def main() -> int:
    if sys.argv[1:2] == ["--md-worker"]:   # one rank of phase 5i's gloo processes
        return md_worker(sys.argv[2:])
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script needs a GPU", flush=True)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import interpolated_diffusion_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port package is not next to this script ({e})", flush=True)
        return 1
    try:
        card = phase_device()
        if "--gemm-ab" in sys.argv[1:]:
            return gemm_ab(card)
        phase_build()
        dev = torch.device("cuda")
        # the plain twins are the f32 references: no TF32 in their products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        profile = "--profile" in sys.argv[1:]
        cases = phase_kernels(dev)
        if "--maze-kernels" in sys.argv[1:]:   # one run of --gemm-ab: checks, times, one JSON line
            times = phase_timings(dev, card, cases)
            print(json.dumps({"gemm": times["gemm"], "block": {
                f"[{k[1]},{k[2]},{BENCH['d_model']}]": v[0] for k, v in times.items()
                if k[0] == "fused_film_block" and k[1] == 1024}}), flush=True)
            return 0
        if "--wan-phase2" in sys.argv[1:]:   # phase 5f alone: no other phase, no summary
            phase_wan_phase2(dev, card, profile)
            print("[wan2] phase 5f passed", flush=True)
            return 0
        if "--wan-interp" in sys.argv[1:]:   # phase 5g alone: no other phase, no summary
            phase_wan_interp(dev, card)
            print("[wan interp] phase 5g passed", flush=True)
            return 0
        if "--multi-device" in sys.argv[1:]:  # phase 5i alone: its own summary, the last line
            with tempfile.TemporaryDirectory() as workdir:
                md_launches = phase_multi_device(dev, card, workdir)
            print(json.dumps({"multi_device": {"launches": md_launches}}), flush=True)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}), flush=True)
            return 0
        if "--video-toy" in sys.argv[1:]:    # phase 5h alone: its own summary, the last line
            video_launches, video_times = phase_video_toy(dev, card, profile)
            print(json.dumps({"video_toy": {"launches": video_launches, "times": video_times}}),
                  flush=True)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}), flush=True)
            return 0
        if "--kernels" in sys.argv[1:]:   # the kernels alone: no model, no summary
            phase_timings(dev, card, cases)
            del cases
            torch.cuda.empty_cache()
            phase_maze_autograd(dev, card)
            _, wan_cases = phase_wan_kernels(dev)
            phase_wan_kernel_timings(card, wan_cases)
            del wan_cases
            torch.cuda.empty_cache()
            phase_wan_bwd_kernels(dev, card)
            print("[kernels] every kernel agrees with its plain twin", flush=True)
            return 0
        kp, it, pipe, launches = phase_main(dev)
        times = phase_timings(dev, card, cases)
        # the summary needs the GEMM cases' errors only: free their 0.6 GB of
        # operands, so that the trainers' peak memory reads as it would alone
        cases["gemm"] = [case[:2] for case in cases["gemm"]]
        phase_pipeline_timings(dev, card, pipe, kp, it, profile)
        del kp, it, pipe
        torch.cuda.empty_cache()
        grad_errs, mha_times = phase_maze_autograd(dev, card)
        with tempfile.TemporaryDirectory() as workdir:
            maze_train_launches, _, runs = phase_maze_train(dev, card, profile, workdir)
            torch.cuda.empty_cache()
            cli_launches = phase_maze_sample_cli(dev, card, runs, workdir, profile)
            torch.cuda.empty_cache()
            serve_launches, select_launches = phase_serve_select(dev, card, runs, workdir)
            torch.cuda.empty_cache()
            causal_launches, sk_launches = phase_causal(dev, card, runs, workdir, profile)
            torch.cuda.empty_cache()
            md_launches = phase_multi_device(
                dev, card, workdir, (runs["stage1"], os.path.join(workdir, "stage2_causal")))
        torch.cuda.empty_cache()
        video_launches, video_times = phase_video_toy(dev, card, profile)
        torch.cuda.empty_cache()
        wan_errs, wan_cases = phase_wan_kernels(dev)
        model, sampler, inputs, wan_launches = phase_wan_main(dev)
        wan_times = phase_wan_kernel_timings(card, wan_cases)
        phase_wan_sampler_timings(card, model, sampler, inputs, profile)
        del model, sampler, inputs, wan_cases
        torch.cuda.empty_cache()
        bwd_errs, bwd_times, bwd_bounds = phase_wan_bwd_kernels(dev, card)
        torch.cuda.empty_cache()
        train_launches, _ = phase_wan_train(dev, card, profile)
        torch.cuda.empty_cache()
        wan2_errs, wan2_times, wan2_launches, _ = phase_wan_phase2(dev, card, profile)
        torch.cuda.empty_cache()
        full_ft_launches = phase_wan_interp(dev, card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1

    # Bounds of the maze kernels at [B, L, D] = [1024, 64, 384] (Stage 2) and
    # [1024, 8, 384] (Stage 1), from the shapes: the block does the qkv,
    # attention, output and two FFN products on bf16 tensor cores and must move
    # x, y, its weights and the FiLM vectors once. (The chain's intermediates,
    # which a one-kernel block would not move, are not in the bound.)
    B, D, H, F = 1024, BENCH["d_model"], BENCH["n_heads"], BENCH["d_ff"]

    def block_bound(L):
        flops = B * L * (2 * D * 3 * D + 4 * L * D + 2 * D * D + 4 * D * F)
        return bound_ms(2 * (2 * B * L * D + 4 * B * D + 4 * D * D + 2 * D * F + 9 * D + F), flops)

    L = 64
    maze_bounds = {"fused_film_block": block_bound(L),
                   "small_mha_packed": bound_ms(2 * 4 * B * L * D, 4.0 * B * L * L * D)}
    summary = []

    def row(name, n_launches, err, ms, plain_ms, bound, library_ms, **extra):
        src, replaces = KERNEL_SOURCES[name]
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": n_launches, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": library_ms, **extra})

    # `launches` from the sampling pipeline's run, `train_launches` from the
    # maze trainers' run (steps, the CLIs, the use_small_mha stack),
    # `sample_cli_launches` from the sampling CLI's runs (phase 5c). The block's
    # row also holds its Stage-1 shape, the same run's launches by shape as the
    # wrapper counted them (three block-policy calls), and its four products
    # alone; small_mha_packed's its time by graph replay.
    s1_ms, s1_plain, s1_lib = times[("fused_film_block", B, 8)]
    g_ms, g_lib = times[("small_mha_packed/graph", B, L)]
    c_ms, c_plain, c_lib = times[("fused_film_block", B, CAUSAL_CLI["K_min"])]
    extras = {"fused_film_block": dict(
                  stage1_ms=s1_ms, stage1_plain_ms=s1_plain, stage1_library_ms=s1_lib,
                  stage1_bound_ms=block_bound(8)[0],
                  causal_stage1_ms=c_ms, causal_stage1_plain_ms=c_plain,
                  causal_stage1_library_ms=c_lib,
                  causal_stage1_bound_ms=block_bound(CAUSAL_CLI["K_min"])[0],
                  causal_launches=causal_launches, sample_keypoints_launches=sk_launches,
                  launches_by_shape=launches["fused_film_block/by_shape"],
                  host_paced_ms={f"[{b},8,384]": dict(zip(("bf16_parameters", "f32_masters"),
                                                          times[("fused_film_block/host", b)]))
                                 for b in (1, 64)},
                  gemm=times["gemm"],
                  gemm_max_abs_err=max(c[1] for c in cases["gemm"])),
              "small_mha_packed": dict(device_ms=g_ms, library_device_ms=g_lib)}
    for name in extras:      # phase 5h: the toy-video and DiDeMo shapes and launches
        extras[name].update(video_launches=video_launches[name], video_shapes=video_times[name])
    extras["fused_film_block"]["multi_device_launches"] = md_launches["fused_film_block"]
    for name in ("fused_film_block", "small_mha_packed"):
        k_ms, p_ms, lib_ms = times[(name, B, L)]
        row(name, launches[name], max(grad_errs[name], *(c[1] for c in cases[name])), k_ms, p_ms,
            maze_bounds[name], lib_ms, train_launches=maze_train_launches[name],
            sample_cli_launches=cli_launches[name], serve_launches=serve_launches[name],
            select_launches=select_launches[name], **extras[name])
    # small_mha at the Stage-2 trainer's shape [256, 64, 384]; its main path is
    # the maze training phase (TransformerBlock(use_small_mha=True))
    k_ms, p_ms, lib_ms, mha_bound = mha_times[(256, 64)]
    t_ms, t_plain, t_lib, t_bound = mha_times[(64, 512)]   # the tiled kernel, [64, 512, 128] H=2
    row("small_mha", maze_train_launches["small_mha"], grad_errs["small_mha"], k_ms, p_ms,
        mha_bound, lib_ms, train_launches=maze_train_launches["small_mha"],
        device_ms=mha_times["small_graph"][0], library_device_ms=mha_times["small_graph"][1],
        tiled_ms=t_ms, tiled_plain_ms=t_plain, tiled_bound_ms=t_bound[0], tiled_library_ms=t_lib,
        tiled_device_ms=mha_times["tiled_graph"][0],
        tiled_library_device_ms=mha_times["tiled_graph"][1])
    # Wan forward kernels: times at the anchor path's shapes (flash: its
    # cross-attention; SLA and int8 SLA also at the trainer's); `launches`
    # from the sampler's run, `train_launches` from the trainer's
    # rows 4-8 also at the Wan Phase-2 trainer's shapes (phase 5f), with their
    # launches per training step and per evaluation batch in its CLI runs
    def phase2(name, *shapes):
        out = {}
        for which in shapes or ("",):
            k_ms, p_ms, bound, lib_ms, shp = wan2_times[f"{name}/{which}" if which else name]
            out[f"phase2_{which}" if which else "phase2"] = dict(
                shape=shp, ms=k_ms, plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=lib_ms, launches=wan2_launches.get(name, {}))
        return out

    for name in WAN_KERNELS:
        k_ms, p_ms, lib_ms = wan_times[name if name != "flash_attention"
                                       else "flash_attention/cross"]
        if name == "flash_attention":   # its self-attention shape, and q x 768 keys
            s_ms, s_plain, s_lib = wan_times["flash_attention/self"]
            y_ms, y_plain, y_lib = wan_times["flash_attention/768"]
            extra = dict(self_ms=s_ms, self_plain_ms=s_plain, self_library_ms=s_lib,
                         self_bound_ms=wan_times["bounds"]["flash_attention/self"][0],
                         k768_ms=y_ms, k768_plain_ms=y_plain, k768_library_ms=y_lib,
                         k768_bound_ms=wan_times["bounds"]["flash_attention/768"][0])
        else:                           # the trainer's shape too
            t_ms, t_plain, t_lib = wan_times[f"{name}/train"]
            extra = dict(train_ms=t_ms, train_plain_ms=t_plain, train_library_ms=t_lib,
                         train_bound_ms=wan_times["bounds"][f"{name}/train"][0])
        extra.update(phase2(name, *(("cross", "self") if name == "flash_attention" else ())))
        row(name, wan_launches[name], max(*wan_errs[name], wan2_errs.get(name, 0.0)), k_ms, p_ms,
            wan_times["bounds"][name], lib_ms, train_launches=train_launches[name],
            full_ft_launches=full_ft_launches.get(name, {}),
            multi_device_launches=md_launches.get(name, {}), **extra)
    # backward kernels: times at the trainer's shapes (flash: cross-attention,
    # and its self-attention shape too; SLA also by graph replay); the twin and
    # the library call compute dq, dk and dv in one call
    for name in ("sla_bwd_dq", "sla_bwd_dkdv", "flash_bwd_dq", "flash_bwd_dkdv"):
        kind = name.split("_")[0]
        extra = {}
        if kind == "sla":     # also by graph replay (dK/dV also on an even LUT)
            extra = dict(device_ms=bwd_times[f"{name}_graph"])
            if name == "sla_bwd_dkdv":
                extra["even_lut_device_ms"] = bwd_times["sla_bwd_dkdv_even"]
        if kind == "flash":
            extra = dict(self_ms=bwd_times[f"{name}_self"],
                         self_plain_ms=bwd_times["flash_twin_self"],
                         self_library_ms=bwd_times["flash_library_self"],
                         self_bound_ms=bwd_bounds[f"{name}_self"][0])
        extra.update(phase2(name, *(("cross", "self") if kind == "flash" else ())))
        row(name, train_launches[name], max(bwd_errs[name], wan2_errs.get(name, 0.0)),
            bwd_times[name], bwd_times[f"{kind}_twin"], bwd_bounds[name],
            bwd_times.get(f"{kind}_library"), full_ft_launches=full_ft_launches.get(name, {}),
            multi_device_launches=md_launches.get(name, {}), **extra)
    idle = [r["name"] for r in summary if r["launches"] <= 0]
    if idle:
        print(f"FAIL: kernels never launched on their main path: {idle}", flush=True)
        return 1
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
