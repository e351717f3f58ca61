#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

It builds the six hand-written kernels from the checkout's sources (one
``nvcc`` per source, in parallel; phase ``device`` reports each
instantiation's registers, shared memory and spills) and drives each
execution path of the port at MinkUNet-large's full published widths and
depth (seeded random weights), on a 65,536-voxel bucket, SECOND-large
on two LiDAR scans in a 131,072-row bucket, then the dense-decoder
serving path at TinyLlama-1.1B's and the MoE decoder at Mixtral-8x7B's
(depth cut to 8 layers), decoder-LM training, the Mamba2,
RecurrentGemma, HuBERT and LLaVA families served and trained, and
Qwen3-1.7B, Yi-9B, DeepSeek-67B and Mixtral-8x22B served and trained:

* ``octent_query`` and ``spconv_gemm_fused`` (both modes): each kernel
  against its plain PyTorch version at the shapes the serving path gives
  it (for kernel 2 also its planning kernel, bit for bit, and each
  shape's CTAs and split blocks), then MinkUNet-large served through
  ``ServeEngine`` (4 requests, then the first one re-submitted, which
  must hit the engine's content-keyed plan cache: no search, no kernel-1
  launch, the same logits), the launch counts (a CUDA graph's replays
  counted), one executable a bucket class in each of its two engines,
  each request's logits bit-equal to an eager forward of its tensors and
  plans, a tick of two scenes bit-equal to their solo servings, forward
  ms eager against replayed and the graphs' memory, and the logits
  against the plain-version forward;
* ``spconv_gemm``: the materialized backend at the 20 distinct layer
  shapes, the kernel against its plain version, then ``apply_kmap``
  against the fused ``apply_tiles`` and run twice, bit-equal (its scatter
  adds each row in slot order: one segment-sum launch a shape), with
  peak device memory per shape, and the segment-sum kernel held
  bit-equal to its plain version and timed at each shape's scatter
  beside the one-``index_add`` form it replaced;
* ``masked_matmul``: one dense GEMM per layer shape through
  ``sparse_dense_matmul``, the kernel against its plain version and
  ``torch.matmul`` (a shape where the kernel is slower is reported, not
  fatal);
* ``scan_forward``: one forward through the tap-scan oracle
  (``impl="scan"``) against the kernel forward, unfused and fused;
* ``train``: MinkUNet-large trained for 3 steps through ``run_spconv_demo``
  on one indoor scene (kernel 1 five times, kernel 2 75 times, 9 map
  searches, finite losses, no recovery), each step's plan build,
  forward, backward, optimizer and checkpoint ms and the peak memory; one
  step's loss and gradients through the kernels against the plain
  versions (gradients with the ReLU masks pinned; loss, ReLU flips and
  gradient norms left free), and a control, the plain step in TF32, that
  must fail that gate; one step under ``torch.profiler`` (device busy,
  idle share, the 10 longest device ops, kernel 2's own time); the
  plain versions' step (``impl="ref"``) captured and replayed, each
  replay bit-equal to an eager step;
* ``second``: SECOND-large (the detection path: Gconv3 in both
  dataflows, Subm3 blocks, BEV densification, the RPN head) forward
  through kernels 1 and 2 (3 and 8 launches, 6 map searches plus one
  probe per overflowing Gconv3 budget), its ``cls`` / ``box`` against
  the plain-version forward (whole grid, and the interior that the
  clipped edge does not reach against its own max), every kmap, budget
  and true output count against the plain search's, kernel 1 at its 3
  and kernel 2 at its 8 layer shapes against their plain versions, plan
  build and forward ms, one profiled forward, and one ``detection_loss``
  step held to the plain versions by the training gate, with the TF32
  control that must fail it; then the fixed-order sums: the forward's
  ``cls`` / ``box`` digests equal across three kernel and two plain
  forwards, two loss steps each way bit-equal in the loss and every
  gradient, the segment-sum kernel (2 launches a forward) held bit-equal
  to its plain version at ``to_bev`` and the stage-0 Gconv3's two
  indexes and timed, and ``to_bev`` and the stage-0
  ``apply_maps_scatter`` (forward and backward) timed against the
  one-``index_add`` forms they replaced;
* ``stream``: a moving-sensor sequence (12 frames of a 512-voxel window
  stepping 32, then the last frame again) through MinkUNet-large by a
  delta session (dirty rows searched by kernel 1 in row-list mode) and a
  scratch session, bit-equal at every level of every frame and at the
  logits; every kmap equals the plain search, the logits the plain
  forward; row-list launches on every steady frame, 25 kernel-2 launches
  a frame, under half the scratch rows searched, none on the repeated
  frame; kernel 1's row-list launch against its plain version and a full
  launch; one profiled delta frame;
* ``chaos``: the serve replay of ``benchmarks/serve_replay.py`` on the
  card: the four scenes of ``serve``, each again in fresh buffers, a
  NaN-coordinate and an oversize cloud (rejected by the strict policy),
  two requests past their deadline (shed) and a victim of a persistent
  ``admit`` fault, replayed clean and under a fault plan with a one-shot
  fault at each of ``search``, ``gemm``, ``plan``, ``fingerprint`` and
  ``batch`` (the fallback chain off, the port's default): every clean
  request completes in both with the same sha256 digest, equal to phase
  ``serve``'s, the victim alone is isolated, the result ledger equals the
  ``serve.*`` / ``admit.*`` health deltas, the faulted health delta is
  the clean one plus exactly the faults and their retries, and a fresh
  geometry launches kernel 1 five and kernel 2 25 times, a repeat kernel
  1 never. Then the degradation ladder (persistent ``plan`` faults climb
  it to level 2, where a request is flagged and still served by the
  kernels at the halved batch, bit-equal, since the plain versions never
  stand in for a kernel on the card, then to level 3, which sheds;
  healthy ticks walk it back to 0) and the empty fallback chain of the
  card (``REPRO_GUARD_FALLBACK=1``: a persistent ``gemm`` fault on the
  stem quarantines the kernel and isolates the request, the quarantine's
  second call makes the next request's first try raise and its retry
  launch the kernel, bit-equal, and no plain version is served; unset,
  the same fault isolates the request), each health delta held
  exactly;
* ``restart``: the serving side of ``benchmarks/restart_replay.py``:
  ``--worker-serve`` processes of this script serve the four scenes
  with a persist dir (an explicit byte budget): an uninterrupted one (its
  digests equal phase ``serve``'s; snapshot bytes and write ms per
  request, latency beside phase ``serve``'s), a warm one over its
  directory (no map search, no kernel-1 launch), one SIGKILLed by the
  ``kill`` site at its first tick and one in the middle of a snapshot
  write (a torn temporary file left), each restarted (``recover`` queues
  the journaled requests again; the same digests), and a warm one after
  one plan snapshot was truncated and another bit-flipped (both dropped
  and counted, the same digests); each process's time to its first
  result, cold and warm;
* ``paper``: the paper's own measurements on the card. Fig. 9(a): on
  the four workloads of ``benchmarks/common.py`` (Seg(i), Seg(o), Det(k),
  Det(n)) and phase ``serve``'s first LiDAR scene, kernel 1 (its table
  build included), the dense-table search (``impl="dense"``), the sorted
  search where its key fits and the serial host hash, every kmap
  bit-equal to the hash's, with times, peak memory and the cycle model's
  savings beside the measured ratios. Fig. 9(b): post-ReLU features with
  structured dead regions at Cin 16-128 on Seg(i), the MAC grains read
  off the masks (ordered, the block grain's reduction at least 0.02) and
  ``apply_tiles`` through kernel 2 with SPAC on and off (bit-equal where
  both runs share a split plan). Fig. 8(a)/9(c): the delta_z = 0 share
  of kernel 1's Seg(o) taps, the caching model's saving and a Subm3
  plan's tier bytes at the bucket. MinkUNet-large with
  ``map_method="sorted"`` (at a 5-bit grid, on an indoor scene) and with
  the dense search (at its own settings, on a LiDAR scene), each bit-equal
  to the kernel-1 forward with 25 kernel-2 launches; and the replan gate:
  ``run_spconv_demo(max_blocks=4)`` replans and reaches the default run's
  digest;
* ``sharded``: the sharded OCTENT search under ``torch.distributed``
  device meshes (``launch/spconv_sharded.py``'s ``spawn_ranks`` workers,
  after the parent built the kernels): one NCCL rank on a ``(1,)`` data
  mesh (``auto`` keeps kernel 1; the sharded search forced gives its
  kmaps), two ranks on ``(2,)`` data and four on ``(4,)`` model and
  ``(2, 2)`` data x model, sharing the card over gloo (which takes the
  merges' CUDA tensors as they are). MinkUNet-large serves the four scenes of
  ``serve`` (two on the 4-rank meshes) through ``forward_multicloud``:
  every Subm3 kmap on every rank bit-equal to the same worker's kernel-1
  kmap, the logits to its meshless forward (and their digests to phase
  ``serve``'s), 9 searches and 25 kernel-2 launches a cloud; each rank
  holds ``n_pad/S`` table slots and ``mb/S`` directory entries, every
  query is answered once a stage by the owner of its key range, and a
  scene planned under a 2-rank mesh misses the plan cache under the same
  shape over the other two ranks.
  Printed, not gated: the sharded search's ms a call, its two merges',
  kernel 1's path in the same worker and the table bytes a rank;
* ``flash_attention``: the kernel (both routes on the tensor cores: bf16
  through ``wgmma``, float32 as 3xTF32 ``mma.sync``) against its plain
  version at the attention shapes of the repo's configs (TinyLlama's
  served prefill, in bf16 and float32, a 4,096-token prompt, Mixtral's
  windowed attention, HuBERT's, RecurrentGemma's, a ragged Sq < Skv
  case, and the 4 x 512 prefills of Qwen3-1.7B, Yi-9B, DeepSeek-67B and
  Mixtral-8x22B, D 128), each bf16 shape also
  checked in float32, with ``scaled_dot_product_attention`` timed beside
  it, the kernel's share of its bound and its time over SDPA's;
* ``lm_serve``: TinyLlama-1.1B at full width and depth (bf16, seeded
  random weights) serving 4 x 512-token prompts for 32 generated tokens
  through ``generate``, 22 flash launches per prefill, the decode step
  replayed from a CUDA graph; its tokens equal to an eager
  ``decode_step`` loop's and ``generate``'s, the per-step max |logit
  difference|, and decode ms a token eager against replayed (every
  family's ``generate`` below replays its step too);
* ``lm_reference``: the kernel prefill's logits against the plain-version
  prefill in bf16 and float32, and the first decode step against a
  teacher-forced prefill;
* ``moe_serve``: Mixtral-8x7B at full width, 8 of its 32 layers (bf16,
  seeded random weights), serving 4 x 512-token prompts for 32 tokens
  and one 6,144-token prompt (past its 4,096-token window) for 16, one
  flash launch a layer a prefill; prefill logits against the plain
  version (routing flips counted) and, drop-free, the first decode step
  against the teacher-forced prefill;
* ``lm_train``: TinyLlama-1.1B trained 3 steps in bf16 (4 x 512 tokens
  of ``TokenStream``) through the training CLI's ``run_lm`` (a
  ``TrainRunner`` over ``make_train_step``),
  44 flash launches a step (remat ``full``); the same bf16 steps again
  through the plain attention (their losses gated) and in float32
  (reported); one float32 step's loss and
  gradients through the kernel against the plain version; Mixtral-8x7B
  at 2 of 32 layers trained 2 steps (finite, the router's gradient
  nonzero);
* ``mamba2``: Mamba2-2.7B at full width and depth (64 layers, bf16)
  served through ``generate`` (4 x 512 prompts for 32 tokens, a 700-token
  prompt that is not a multiple of the 256-token chunk, a 2-token prompt
  decoded 4 steps), the first decode step against the teacher-forced
  prefill in bf16 and float32, and 2 training steps (finite losses, the
  first moments of ``A_log``, ``dt_bias``, ``D_skip`` nonzero); no kernel
  launch: the SSD scan is plain PyTorch, as the reference's is XLA;
* ``rglru``: RecurrentGemma-2B at full width and depth (26 layers, bf16)
  served over 4 x 512 prompts and one 3,072-token prompt past its
  2,048-token window, one kernel-5 launch a group a prefill (D 256, MQA),
  the kernel prefill against the plain one in bf16 and float32, decode
  against the teacher-forced prefill, 2 training steps (16 launches a
  step);
* ``hubert``: HuBERT-XLarge at full width and depth (48 layers, bf16):
  ``encode`` of 4 x 1,024 frames (48 non-causal launches at D 80), kernel
  against plain in bf16 and float32, 2 ``masked_prediction_loss`` steps
  on ``FrameStream``'s float32 frames (the float32 route, as the
  reference promotes);
* ``llava``: LLaVA-NeXT (Mistral-7B) at full width and depth (32 layers,
  bf16) served over 2 x (2,880 bf16 patch embeddings + 512 tokens), 32
  launches a prefill over 3,392 positions, kernel against plain and
  decode against the teacher-forced prefill; 2 training steps at 4 of
  its 32 layers on the VLM stream's float32 patches;
* ``lm_configs``: Qwen3-1.7B (qk-norm, tied embeddings, GQA 16/8),
  Yi-9B (GQA 32/4), DeepSeek-67B (GQA 64/8) and Mixtral-8x22B (48/8, 8
  experts top-2, a 4,096-token window), all D 128, at their published
  widths (bf16, seeded), depth cut only where 80 GB forces it (LMC_RUNS,
  sized by ``scripts/lm_config_depths.py``; each cut under ``reduced``):
  ``generate`` of 4 x 512 prompts for 16 tokens, one kernel-5 launch a
  layer a prefill, the decode step replayed from a graph; the dense three
  held kernel against plain and decode against teacher-forced prefill in
  float32 and by the bf16 ratio gate (DeepSeek's on a 4-layer model
  beside which the float32 copy fits), Mixtral-8x22B by ``moe_serve``'s
  MoE gates; 2 donated training steps each (finite losses, 2 launches a
  layer a step); every peak under 80 GB;
* ``moe_ragged``: kernel 3 on the router's rulebook
  (``examples/moe_ragged_torch.py``) at the example's sizes and at one
  Mixtral-8x7B ``w_gate`` product, against the dense per-expert loop and
  its plain version, timed against its bound;
* ``gloo_probe``: each collective DTensor and the pipeline issue
  (``all_reduce``: float32 SUM and MAX, int32 SUM;
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single``: even splits and a ``permute_tensor``) on CUDA
  tensors over a 2-rank gloo world of its own, recorded as it runs or
  fails;
* ``lm_sharded``: the LM's tensor sharding. TinyLlama-1.1B at full width,
  float32 weights from the seed, with DTensor parameters placed by
  ``param_shardings``, on one NCCL rank (``data`` 1, ``model`` 1; full
  depth) and on two gloo ranks sharing the card (``model`` 2; at 4 of 22
  layers; the kinds of collective that ``gloo_probe`` saw refused staged
  through host memory, since gloo crashes in ``all_gather_into_tensor``
  on CUDA tensors, and that world's times marked host-staged): a 4 x 512
  prefill with kernel 5 on each rank's own heads (one launch a layer a
  rank) and one training step, logits within 1e-3 x max |logit|, loss
  within 2e-3, parameters within ``allclose(3e-2)``, the gradient norm
  within 1e-5 and each tensor's change within 1e-3 (relative) of the
  single-device kernel path on the same card; Mixtral-8x7B at 2 of 32
  layers on the two ranks, its ``shard_map`` dispatch held to ``einsum``
  (logits, loss, each gradient; routing pinned, flips counted);
* ``lm_pipeline``: in the same two gloo ranks, over a 2-way ``pod`` mesh,
  TinyLlama-1.1B at full width and depth (float32, seeded), its 22 layers
  in 2 GPipe stages of 11 (``runtime/pipeline.py``), each rank holding its
  stage plus the embedding and head: the 4 x 512 batch as 4 microbatches
  of 1 x 512 (kernel 5 44 times a rank), logits within 1e-3 x max |logit|
  of the single-device kernel path; the pipelined loss (2e-3 relative),
  gradient norm (1e-5) and each gradient (1e-3 of its norm) against one
  device's; then data parallel over ``pod``: each rank's 2 x 512 half of
  the batch through kernel 5, its gradients averaged by
  ``compress.grad_allreduce_compressed`` within scale / 2 of the exact
  mean, which is held to one device's gradient (1e-3 of each norm);
  prefill and step ms (host-staged where anything was), the bubble
  share, bytes a hand-off and a compressed all-reduce, peak memory;
* ``dryrun``: the dry run of every (arch x shape x mesh) cell on both
  production meshes, on ``meta`` tensors in fake worlds of 256 and 512
  ranks, run on all the host's cores after the card's phases, so that
  none of their host-paced readings shares the host: each cell's
  status, ``fits`` (arguments plus temporaries), bytes a device,
  temporaries and seconds, each cell copying (the CLI's ``--donate``
  counts the train cells donated); every applicable cell must be
  ``ok``. With it, TinyLlama-1.1B's 4 x 512 prefill cell at a (1, 1)
  mesh, checked on the card before any other phase: its argument bytes
  equal to ``torch.cuda.memory_allocated``'s growth once they are placed,
  its FLOPs to ``FlopCounterMode``'s count of the same step run through
  the plain versions, and its ``temp_bytes`` to the growth of
  ``torch.cuda.max_memory_allocated`` over the placed arguments in that
  run, within the allocator's rounding (:data:`TEMP_SLACK_BLOCK`); and
  its donated 2 x 512 train cell the same way (the argument bytes those
  of the placed state, the growth them rounded to 512-byte blocks), one
  step of ``make_train_step(impl="ref", donate=True)`` run on the card.

Each path runs with its launch counts set to 0 just before and read just
after (phase ``restart`` reads its workers' counts). The bound of kernels
2-4 and of kernel 5's float32 route is float32-accurate work at the
3xTF32 tensor-core rate (495 / 3 TFLOP/s) or bytes at HBM's rate,
whichever is longer; ``bound_ms_f32_cores`` beside it is the bound at the
CUDA cores' 67 TFLOP/s; the segment sum's is its adds at those 67
TFLOP/s or its bytes at HBM's rate. Output is one JSON object per line;
the last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no last line. It also exits non-zero when no
CUDA device is visible or when ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
BUCKET = 65536                 # padding bucket of the served requests
SECOND_BUCKET = 131072         # two LiDAR scans of phase second
# the same scans in buckets whose Gconv3 budgets overflow: at 98,304 rows
# stage 1 (kernel 2) replans from 98,304 output rows to 196,608; at 89,812
# stage 0 replans to 179,624, which is not a multiple of 128
SECOND_REPLAN_BUCKETS = (98304, 89812)
# segment-sum launches a SECOND forward: to_bev and the stage-0 Gconv3's
# input-stationary scatter
SECOND_SUMS = 2
LIDAR_VOXEL = 0.0125           # make_batch lidar voxel: 4 x this = 5 cm
TOL_KERNEL = 1e-4              # f32, another summation order than plain
TOL_LOGITS = 1e-3              # 25 layers of it, relative to max |logit|
DEAD_SHARE = 0.125             # of rows (and per Cin block) zeroed by tile
# published peaks of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores
# float32-exact products on the tensor cores: 3 TF32 products each (3xTF32)
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES_S = 3.35e12         # HBM3
OCTENT_SRC = "src/repro_torch/csrc/octent_query.cu"
GEMM_SRC = "src/repro_torch/csrc/spconv_gemm_fused.cu"
MAT_SRC = "src/repro_torch/csrc/spconv_gemm.cu"
# kernel 3's earlier form is not in the checkout: this script prints no
# time of it, and the A/B script times it beside this one in one process
K3_AB_SCRIPT = "scripts/spconv_gemm_ab.py"
MM_SRC = "src/repro_torch/csrc/masked_matmul.cu"
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
SEG_SRC = "src/repro_torch/csrc/segment_sum.cu"
PEAK_BF16_FLOPS = 989e12       # bf16 on the tensor cores, float32 sum
# (rel, abs) of |kernel - plain| <= rel * |plain| + abs. Both sides sum in
# float32 from the same inputs: bf16 allows one ulp of the bf16 output
# (2^-7 relative) plus the float32 summation order; float32 is the
# reference's own 2e-5.
TOL_FLASH = {"bfloat16": (2.0 ** -7, 2e-3), "float32": (2e-5, 2e-5)}
TOL_LM_BF16 = 2e-2             # x max|logit|: the reference's prefill/decode
TOL_LM_F32 = 1e-3              # x max|logit|: f32 order through 22 layers
# the families' bf16 gate: the kernel (decode) side's distance to the
# float32 function of the same weights, over the plain (teacher-forced)
# side's. Each bf16 side rounds on its own path, so at full depth the two
# distances differ by their rounding alone (0.83-1.22 on an H100), while
# bf16 rounding itself moves either side 1-6 % of max |logit| off the
# float32 function, past the 2e-2 that phase lm_reference holds at 22
# layers
TOL_BF16_RATIO = 1.5
# a training step, kernels against plain versions: 3xTF32 through 25
# layers, then training BatchNorm, so wider than the forward's 1e-3. The
# gradients are held with the plain run's ReLU masks pinned to the kernel
# run's: at full size a few pre-activations within rounding of zero take
# the other side of the ReLU (13 of about 2.5e7 outputs over 25 layers at
# this phase's scene on an H100) and move the weight gradients by up to
# about 5e-3 of their max, a property of the input, not of either
# implementation. What the pins take away is gated on its own: the loss
# and the ReLU flips come from the unpinned run, and so does the largest
# relative norm of a weight gradient's difference (3.45e-3 there)
TOL_TRAIN_LOSS = 1e-4          # relative, unpinned
TOL_TRAIN_GRAD = 1e-3          # x each gradient tensor's own max |g|, pinned
TOL_TRAIN_NORM = 1e-2          # |gk - gr| / |gr| per weight tensor, unpinned
TOL_TRAIN_FLIPS = (1e-4, 1e-5)  # flipped ReLU outputs: share of a layer's
#                                 valid outputs, share of all of them
# every conv bias feeds a training BatchNorm, which subtracts the batch
# mean: its gradient is zero in exact arithmetic, so both sides are
# rounding noise, held below this share of the model's largest |g|
TOL_TRAIN_ZERO = 1e-5
TRAIN_STEPS = 3
# phase stream: a moving sensor over MinkUNet-large, 12 frames of a
# 512-voxel window stepping 32 voxels (6.25 % turnover), then the last
# frame again
STREAM_FRAMES, STREAM_WINDOW, STREAM_STEP = 12, 512, 32
STREAM_DEPTH, STREAM_DENSITY = 256, 0.35
SMOKE_RATIO_GATE = 0.5         # delta / scratch rows searched, steady frames
# phases chaos and restart
CHAOS_DEADLINE_S = 600.0       # generous: the replay is about faults
CHAOS_COOLDOWN = 2             # REPRO_GUARD_COOLDOWN of the fallback
                               # check, whose counts assume 2
PERSIST_BUDGET = 16 * 2 ** 30  # REPRO_PERSIST_MAX_BYTES of the workers
RESTART_TIMEOUT_S = 600        # each worker process
STREAM_CHECK_FRAME = 6         # kernel 1's row-list launch held and timed
STREAM_PROFILE_FRAME = 7       # the delta frame under torch.profiler
# phase paper: the four workloads of benchmarks/common.py (scene, rows,
# batch; seed 0) and the hash probe factors of benchmarks/search_speedup.py
PAPER_WORKLOADS = {"Seg(i)": ("indoor", 16384, 1),
                   "Seg(o)": ("lidar", 16384, 1),
                   "Det(k)": ("lidar", 8192, 1),
                   "Det(n)": ("lidar", 12288, 1)}
PAPER_PROBE = {"Seg(i)": 6.0, "Seg(o)": 3.4, "Det(k)": 2.6, "Det(n)": 3.0}
PAPER_CINS = (16, 48, 96, 128)     # benchmarks/sparsity_saving.py
MAC_REDUCTION_FLOOR = 0.02         # block grain, as sparsity_saving's gate
MAC_GRAIN = 16                     # the paper's 16-wide MAC-array grain
CACHE_CAPACITY = 27 * 32 * 32      # tests/test_paper_bands.py, Fig. 9(c)
PAPER_SEARCH_ITERS = 10            # calls a search timing averages
PAPER_GRID_BITS = 5                # the sorted key's widest grid (512)
# phase sharded: (world, backend, scenes, meshes). NCCL takes one rank a
# card, so two and four ranks share the one card over gloo; the 4-rank
# meshes run on 2 of the 4 scenes to keep the phase near a minute
SHARDED_WORLDS = (
    (1, "nccl", 4, [((1,), ("data",))]),
    (2, "gloo", 4, [((2,), ("data",))]),
    (4, "gloo", 2, [((4,), ("model",)), ((2, 2), ("data", "model"))]),
)
SHARDED_TIMEOUT_S = 300        # each world's spawn
SHARDED_ITERS = 5              # calls a timing averages
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "tinyllama-1.1b", 4, 512, 32
# phase moe_serve: Mixtral-8x7B at full width, 8 of its 32 layers (about
# 24 GB of bf16 weights), plus one request past its 4,096-token window
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 8
MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 512, 32
MOE_LONG_PROMPT, MOE_LONG_GEN = 6144, 16
# phase lm_train: TinyLlama-1.1B whole, Mixtral-8x7B at 2 of 32 layers
# (bf16 parameters and gradients, float32 AdamW moments: about 38 GB)
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 512, 3
LM_TRAIN_LR = 3e-4             # the training CLI's default
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 2, 2, 2
# float32 step, kernel vs plain: the forwards differ by the kernel's 2e-5
# through 22 layers; both backwards are the plain version's VJP
TOL_LM_TRAIN_LOSS = 1e-4       # relative
TOL_LM_TRAIN_GRAD = 1e-3       # |g_kernel - g_plain| / |g_plain|, each
# bf16 loss path, each of the steps: kernel vs plain attention, and
# run_lm's against the same steps outside the runner (relative; set after
# the first reading, 2.0e-4 and 0 at step 3)
TOL_LM_TRAIN_PATH = 1e-3
# the families of phases mamba2, rglru, hubert and llava, each at its full
# published width and depth (LLaVA's training at LLAVA_TRAIN_LAYERS)
MAMBA2_ARCH, MAMBA2_BATCH, MAMBA2_PROMPT, MAMBA2_GEN = "mamba2-2.7b", 4, 512, 32
MAMBA2_ODD_PROMPT, MAMBA2_ODD_GEN = 700, 16      # not a multiple of 256
MAMBA2_TRAIN_BATCH, MAMBA2_TRAIN_STEPS = 2, 2
RGLRU_ARCH, RGLRU_BATCH, RGLRU_PROMPT, RGLRU_GEN = ("recurrentgemma-2b", 4,
                                                    512, 32)
RGLRU_LONG_PROMPT, RGLRU_LONG_GEN = 3072, 16     # past the 2,048 window
RGLRU_TRAIN_BATCH, RGLRU_TRAIN_STEPS = 2, 2
HUBERT_ARCH, HUBERT_BATCH, HUBERT_SEQ = "hubert-xlarge", 4, 1024
HUBERT_TRAIN_BATCH, HUBERT_TRAIN_STEPS = 2, 2
LLAVA_ARCH, LLAVA_BATCH, LLAVA_PROMPT, LLAVA_GEN = ("llava-next-mistral-7b",
                                                    2, 512, 32)
LLAVA_TRAIN_LAYERS, LLAVA_TRAIN_BATCH, LLAVA_TRAIN_STEPS = 4, 1, 2
# phase lm_configs: the LM configs no other phase runs, at their published
# widths (bf16, seeded). Depth is cut only where 80 GB forces it, each cut
# the deepest whose arguments plus temporaries stay under 72 GB in the
# port's dry run at the run's batch (scripts/lm_config_depths.py: serve a
# 4 x 528 prefill, train a donated 2 x 512 step). (arch, serve layers,
# train layers, gate layers): the float32 gates need a float32 copy of the
# weights beside the bf16 ones; where that does not fit beside the served
# model they run on a second model of the gate layers, at full width
LMC_RUNS = (("qwen3-1.7b", 28, 28, None),
            ("yi-9b", 48, 29, None),
            ("deepseek-67b", 47, 4, 4),
            ("mixtral-8x22b", 13, 1, None))
LMC_BATCH, LMC_PROMPT, LMC_GEN = 4, 512, 16
LMC_TRAIN_BATCH, LMC_TRAIN_STEPS = 2, 2
LMC_PEAK_BYTES = 80e9              # one H100's memory, the datasheet's
# phase lm_sharded: TinyLlama-1.1B (float32) under DTensor parameters on
# one NCCL rank ((data 1, model 1), all 22 layers) and two gloo ranks
# sharing the card ((data 1, model 2), at LM_SHARDED_GLOO_LAYERS: that
# world is host-staged and paced by its staged all-gathers, which grow
# with depth, ROADMAP §3 item 13); Mixtral-8x7B at 2 of 32 layers on
# the two ranks, its shard_map dispatch held to einsum. (world, backend,
# mesh, TinyLlama layers)
LM_SHARDED_GLOO_LAYERS = 4
LM_SHARDED_WORLDS = ((1, "nccl", (1, 1), 22),
                     (2, "gloo", (1, 2), LM_SHARDED_GLOO_LAYERS))
# phase lm_pipeline, in the gloo world: TinyLlama-1.1B whole in 2 stages
# over ("pod",), the 4 x 512 batch in LM_PIPE_MICRO microbatches
LM_PIPE_MICRO = 4

LM_SHARDED_TIMEOUT_S = 600
MOE_SHARDED_LAYERS, MOE_SHARDED_BATCH = 2, 2
TOL_SHARDED_LOGITS = 1e-3      # x max |logit|, the families' float32 gate
TOL_SHARDED_LOSS = 2e-3        # relative: the reference's sharded-step test
TOL_SHARDED_PARAMS = 3e-2      # its assert_allclose(rtol, atol)
TOL_SHARDED_GRAD_NORM = 1e-5   # relative, against one device's
TOL_SHARDED_UPDATE = 1e-3      # |dp_shard - dp_one| / |dp_one|, each tensor
TOL_SHARDED_GRAD = 1e-3        # |g_shard_map - g_einsum| / |g_einsum|, each
# phase dryrun: the cross-check cells on the card (TinyLlama-1.1B, (1, 1)):
# its prefill, and a donated train step cut to a batch of 2 x 512
DRYRUN_CHECK = ("tinyllama-1.1b", "prefill", 4, 512)
DRYRUN_TRAIN_CHECK = ("tinyllama-1.1b", "train", 2, 512)
# the caching allocator's most over the walk's exact bytes, a block live
# at the peak: each block rounded up to 512 B, and a cached block handed
# out whole when cutting it would leave under 1 MiB (the large pool's
# split rule); plus op-internal scratch (reductions) at most TEMP_SLACK
TEMP_SLACK_BLOCK = 2 ** 20 + 512
TEMP_SLACK = 32 * 2 ** 20
DRYRUN_TIMEOUT_S = 600         # the grid, on the host after the card phases
# phase moe_ragged: (tokens, d, f, experts, top-k, bm) of one Mixtral-8x7B
# w_gate product (the example's own sizes are its constants)
MOE_RAGGED = (2048, 4096, 14336, 8, 2, 128)
#: (name, b, hq, hkv, sq, skv, d, causal, window, dtype)
FLASH_SHAPES = [
    ("tinyllama_prefill", 4, 32, 4, 512, 512, 64, True, 0, "bfloat16"),
    ("tinyllama_prefill_f32", 4, 32, 4, 512, 512, 64, True, 0, "float32"),
    ("long_prompt", 1, 32, 4, 4096, 4096, 64, True, 0, "bfloat16"),
    ("mixtral", 1, 32, 8, 8192, 8192, 128, True, 4096, "bfloat16"),
    ("hubert", 1, 16, 16, 1024, 1024, 80, False, 0, "bfloat16"),
    ("recurrentgemma", 1, 10, 1, 2048, 2048, 256, True, 2048, "bfloat16"),
    ("ragged", 2, 8, 2, 500, 700, 128, True, 0, "bfloat16"),
    # phase lm_configs' prefills: 4 x 512, D 128, causal
    ("qwen3", 4, 16, 8, 512, 512, 128, True, 0, "bfloat16"),
    ("yi", 4, 32, 4, 512, 512, 128, True, 0, "bfloat16"),
    ("deepseek", 4, 64, 8, 512, 512, 128, True, 0, "bfloat16"),
    ("mixtral_8x22b", 4, 48, 8, 512, 512, 128, True, 4096, "bfloat16"),
]


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after one warm-up call). The card first spins for about 10 ms,
    so that the host queues every call before the first event: a call
    whose host side takes longer than its kernel is timed by its kernel,
    not by the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)          # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int) -> float:
    """Mean host-clock time of ``fn`` followed by a device sync, over
    ``iters`` calls after one warm-up call: what a caller waits for,
    host launch work included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of an Itanium-mangled kernel name (the innermost
    name and its integer template arguments), e.g.
    ``flash_attention_wgmma<80>``."""
    i, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I((?:L[a-z]-?\d+E)+)E", mangled[i:])
    if args:
        name += "<" + ",".join(re.findall(r"L[a-z](-?\d+)E",
                                          args.group(1))) + ">"
    return name


def _ptxas(log: str) -> list:
    """Registers, static shared memory and spill bytes of each kernel in a
    ``ptxas -v`` log."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            out.append({"kernel": _kernel_name(m.group(1))})
        elif out and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                     r"bytes spill loads", ln)):
            out[-1]["spill_stores"], out[-1]["spill_loads"] = map(
                int, m.groups())
        elif out and (m := re.search(r"Used (\d+) registers", ln)):
            smem = re.search(r"(\d+) bytes smem", ln)
            out[-1]["registers"] = int(m.group(1))
            out[-1]["static_smem"] = int(smem.group(1)) if smem else 0
    return out


def phase_device():
    """The card, the parallel build of every kernel with each
    instantiation's registers, shared memory and spills, no spill in
    either flash-attention route (bf16 ``wgmma``, float32 3xTF32) at any
    head dim, and no spill and at most 128 registers a thread in the
    3xTF32 tile loops of kernels 2, 3 and 4, and none in the segment
    sum."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: _ptxas(build.ptxas_log(n)) for n in build.SOURCES}
    smem_fn = build.load("flash_attention").flash_attention_smem
    smem_fn.argtypes, smem_fn.restype = [ctypes.c_int, ctypes.c_int], \
        ctypes.c_int
    for rep in ptxas["flash_attention"]:
        route, d = re.match(r"flash_attention_(\w+)<(\d+)>",
                            rep["kernel"]).groups()
        rep["dynamic_smem"] = smem_fn(int(d), int(route == "wgmma"))
        check(rep["spill_stores"] == rep["spill_loads"] == 0,
              f"{rep['kernel']} spills: {rep}")
    check(len(ptxas["flash_attention"]) == 2 * len(HEAD_DIMS) and
          sorted(r["kernel"] for r in ptxas["flash_attention"])
          == sorted(f"flash_attention_{route}<{d}>" for d in HEAD_DIMS
                    for route in ("tf32x3", "wgmma")),
          f"flash_attention.cu built {ptxas['flash_attention']}")
    oct_smem = build.load("octent_query").octent_query_smem
    oct_smem.argtypes, oct_smem.restype = [ctypes.c_int], ctypes.c_int
    for rep in ptxas["octent_query"]:
        if rep["kernel"].startswith("octent_query_kernel"):
            rep["dynamic_smem"] = oct_smem(27)
    check(sorted(r["kernel"] for r in ptxas["octent_query"])
          == ["octent_index_kernel", "octent_query_kernel<0>",
              "octent_query_kernel<27>"],
          f"octent_query.cu built {ptxas['octent_query']}")
    gemm_smem = build.load("spconv_gemm_fused").spconv_gemm_fused_smem
    gemm_smem.argtypes, gemm_smem.restype = [ctypes.c_int], ctypes.c_int
    ring_smem = {}
    for name in ("masked_matmul", "spconv_gemm"):
        fn = getattr(build.load(name), f"{name}_smem")
        fn.argtypes, fn.restype = [], ctypes.c_int
        ring_smem[f"{name}_kernel"] = fn()
    check([r["kernel"] for r in ptxas["spconv_gemm"]]
          == ["spconv_gemm_kernel"], f"spconv_gemm.cu built "
          f"{ptxas['spconv_gemm']}")
    for name in ("spconv_gemm_fused", "masked_matmul", "spconv_gemm"):
        for rep in ptxas[name]:
            m = re.match(r"spconv_gemm_fused_kernel<(\d+)>", rep["kernel"])
            if m:
                rep["dynamic_smem"] = gemm_smem(int(m.group(1)))
            elif rep["kernel"] in ring_smem:
                rep["dynamic_smem"] = ring_smem[rep["kernel"]]
            else:
                continue
            # the 3xTF32 tile loops are held to two CTAs per SM
            check(rep["spill_stores"] == rep["spill_loads"] == 0
                  and rep["registers"] <= 128,
                  f"{rep['kernel']} spills or exceeds 128 registers: {rep}")
    # the segment sum (float4 and float) keeps its batch of upcoming
    # values in registers
    check([r["kernel"] for r in ptxas["segment_sum"]]
          == ["segment_sum_kernel"] * 2 and all(
              r["spill_stores"] == r["spill_loads"] == 0
              for r in ptxas["segment_sum"]),
          f"segment_sum.cu built {ptxas['segment_sum']}")
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s, ptxas=ptxas)
    return smi


def _octent_shape(c, b, v, max_blocks, kw, where):
    """Kernel 1 at one coordinate set, the 27 Subm3 queries against a
    ``max_blocks`` directory: its kmap, bit-equal to the plain version's,
    and the shape's ms, plain ms and bytes bound."""
    import torch
    from repro_torch.core import morton
    from repro_torch.kernels.octent import kernel as oct_kernel
    from repro_torch.kernels.octent import ops as oct_ops
    from repro_torch.kernels.octent.ref import octent_query_ref
    offs = torch.as_tensor(morton.subm3_offsets(), device=c.device)
    qt = oct_ops.build_query_table(c, b, v, max_blocks=max_blocks, **kw)
    args = (c, b, v, offs, qt.ublocks, qt.tkey, qt.tval, qt.n_blocks)
    got = oct_kernel.octent_query(*args, **kw)
    want = octent_query_ref(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f"octent_query differs from its plain version at {where}")
    ms = time_ms(lambda: oct_kernel.octent_query(*args, **kw), 50)
    plain_ms = time_ms(lambda: octent_query_ref(*args, **kw), 5)
    # bytes the function needs: every valid flag, coords and batch of the
    # valid rows only, the live prefix of ublocks, the non-sentinel table
    # entries, the offsets and n_blocks, and the whole (N, K) kmap out
    n, k = c.shape[0], offs.shape[0]
    n_valid = int(v.sum())
    live_blocks = min(int(qt.n_blocks), qt.ublocks.numel())
    n_table = int((qt.tkey < max_blocks * morton.TABLE_SIZE).sum())
    nbytes = (n + 16 * n_valid + 4 * live_blocks + 8 * n_table
              + k * 3 * 4 + 4 + n * k * 4)
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    return got, {"rows": n, "voxels": n_valid, "blocks": int(qt.n_blocks),
                 "hits": int((got >= 0).sum()), "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bytes": nbytes, "share_of_bound": bound_ms / ms}


def phase_octent(dev, scene, cfg):
    """Kernel 1 at the 5 query shapes of one served request, one per
    resolution, from the plans ``build_plans`` builds: each bit-equal to
    its plain version and to the plan's kmap, res 0 also to the host hash
    oracle; each shape's time, bytes bound and share of it, and their sum a
    request."""
    import torch
    from repro_torch.core import mapsearch, morton
    from repro_torch.models import minkunet
    plans = minkunet.build_plans(scene.coords, scene.batch, scene.valid, cfg,
                                 device=dev)
    levels = [tuple(torch.as_tensor(a, device=dev) for a in (
        scene.coords, scene.batch, scene.valid))] + [
        (d.out_coords, d.out_batch, d.out_valid) for d in plans.down]
    check(len(levels) == len(plans.subm) == 5,
          f"{len(levels)} resolutions, {len(plans.subm)} Subm3 plans")
    kw = dict(grid_bits=cfg.grid_bits, batch_bits=cfg.batch_bits)
    shapes = []
    for res, (c, b, v) in enumerate(levels):
        got, rec = _octent_shape(c, b, v, BUCKET, kw, f"res {res}")
        check(torch.equal(got, plans.subm[res].kmap),
              f"octent_query differs from the plan's kmap at res {res}")
        if res == 0:
            rng = np.random.default_rng(SEED)
            rows = rng.choice(np.flatnonzero(scene.valid), 2000,
                              replace=False)
            host = mapsearch.build_kmap_hash(scene.coords, scene.batch,
                                             scene.valid,
                                             morton.subm3_offsets())
            check(np.array_equal(got.cpu().numpy()[rows], host[rows]),
                  "octent_query differs from the host hash oracle")
        shapes.append({"res": res, **rec})
    tot = {key: sum(sh[key] for sh in shapes)
           for key in ("ms", "plain_ms", "bound_ms")}
    emit(phase="octent_query", equal_to_plain=True,
         hash_rows_checked=int(rows.size), shapes=shapes,
         ms_per_request=tot["ms"], plain_ms_per_request=tot["plain_ms"],
         bound_ms_per_request=tot["bound_ms"],
         share_of_bound_per_request=tot["bound_ms"] / tot["ms"])
    return {"name": "octent_query", "route": "cuda", "source": OCTENT_SRC,
            "replaces": "src/repro/kernels/octent/kernel.py:122",
            "max_abs_err": 0, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "timing": "sum of the 5 launches of one request, one per "
                      "resolution (res 0 first in phase octent_query)"}


def model_layers(cfg, plans, valids):
    """The 25 SpConv layers of one MinkUNet forward as (name, plan,
    in_valid, out_valid, Cin, Cout, is_subm), in forward order."""
    n_enc = len(cfg.enc)
    layers = [("stem", plans.subm[0], valids[0], valids[0], cfg.in_ch,
               cfg.stem, True)]
    c_prev, skips = cfg.stem, [cfg.stem]
    for i, c in enumerate(cfg.enc):
        layers.append((f"enc{i}.down", plans.down[i], valids[i],
                       valids[i + 1], c_prev, c, False))
        layers += [(f"enc{i}.block{b}", plans.subm[i + 1], valids[i + 1],
                    valids[i + 1], c, c, True) for b in range(cfg.blocks)]
        c_prev = c
        skips.append(c)
    for i, c in enumerate(cfg.dec):
        r = n_enc - 1 - i
        layers.append((f"dec{i}.up", plans.up[i], valids[r + 1], valids[r],
                       c_prev, c, False))
        layers += [(f"dec{i}.block{b}", plans.subm[r], valids[r], valids[r],
                    c + skips[-(i + 2)] if b == 0 else c, c, True)
                   for b in range(cfg.blocks)]
        c_prev = c
    return layers


def _kill_tiles(f, tiles, bk, rng):
    """Zero features so that whole tiles and whole (tile, Cin-block) pairs
    are dead, as post-ReLU activations make them: first the rows gathered
    by seeded live tiles, up to DEAD_SHARE of the nonzero rows, then, for
    each bk-wide Cin block, that block alone on the rows of further seeded
    tiles that are still live. Without this, relu(randn) features leave no
    tile and no block dead, and the kernel's two skip branches would never
    be held against the plain version at full size."""
    import torch
    from repro_torch.core import sparsity
    g = tiles.gather_idx.reshape(-1, tiles.bm).cpu().numpy()
    sv = tiles.slot_valid.reshape(-1, tiles.bm).cpu().numpy()
    rows_of = {t: np.unique(g[t][sv[t]]) for t in np.flatnonzero(sv.any(1))}
    share = int(DEAD_SHARE * int(sparsity.row_nonzero(f).sum()))

    def pick(tiles_left):
        """Rows of seeded tiles, whole tiles only, up to the share (or the
        smallest tile, so that at least one is taken), and those tiles."""
        budget = max(share, min(rows_of[t].size for t in tiles_left))
        mask, used, taken = np.zeros(f.shape[0], bool), 0, set()
        for t in rng.permutation(tiles_left):
            new = rows_of[t][~mask[rows_of[t]]]
            if used + new.size <= budget:
                mask[new], used = True, used + new.size
                taken.add(t)
        return mask, taken

    dead, _ = pick(list(rows_of))
    f = f.clone()
    f[torch.as_tensor(dead, device=f.device)] = 0
    # each block on other tiles, so that no tile loses all its blocks
    alive = [t for t, r in rows_of.items() if not dead[r].all()]
    for b in range(f.shape[1] // bk):
        rows, taken = pick(alive)
        f[torch.as_tensor(rows, device=f.device), b * bk:(b + 1) * bk] = 0
        alive = [t for t in alive if t not in taken] or alive
    return f


def _bound(flops, nbytes):
    """The least time for float32-accurate work: the operations at the
    float32-exact tensor-core rate (3xTF32) against the bytes at HBM's
    rate; beside it the bound at the CUDA cores' float32 rate, the rate
    of the kernels' first, CUDA-core forms, so that shares measured
    against it stay comparable."""
    t_ops, t_bytes = flops / PEAK_TF32X3_FLOPS, nbytes / PEAK_BYTES_S
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3,
            "bound_ms_f32_cores": max(flops / PEAK_F32_FLOPS, t_bytes) * 1e3}


def layer_shapes(dev, scene, cfg):
    """The scene's plans, the 25 layers of one forward, and the seeded
    inputs of each distinct layer shape (``seeded_shapes``, with an
    epilogue for the Subm3 shapes)."""
    import torch
    from repro_torch.models import minkunet
    plans = minkunet.build_plans(scene.coords, scene.batch, scene.valid, cfg,
                                 device=dev)
    valids = [torch.as_tensor(scene.valid, device=dev)] + [
        d.out_valid for d in plans.down]
    layers = model_layers(cfg, plans, valids)
    check(len(layers) == 25, f"expected 25 layers, got {len(layers)}")
    return layers, seeded_shapes(dev, layers, epilogue=True)


def seeded_shapes(dev, layers, *, epilogue: bool):
    """The seeded inputs of each distinct shape of ``layers`` ((name, plan,
    in_valid, out_valid, Cin, Cout, is_subm), in forward order): features
    with dead tiles and dead Cin blocks, weights, and with ``epilogue`` an
    epilogue for the Subm3 shapes. Deterministic: every call draws the
    same inputs."""
    import torch
    from repro_torch.kernels.spconv_gemm import ops as sg_ops
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    shapes = {}
    for name, plan, vin, vout, cin, cout, subm in layers:
        key = (id(plan), cin, cout)
        if key in shapes:
            shapes[key]["layers"].append(name)
            continue
        k, bk = plan.n_taps, sg_ops.pick_bk(cin)
        f = torch.relu(torch.randn((vin.shape[0], cin), generator=gen,
                                   device=dev))
        f = torch.where(vin[:, None], f, 0.0)
        f = _kill_tiles(f, plan.tiles, bk, rng)
        w = torch.randn((k, cin, cout), generator=gen, device=dev) \
            * (2.0 / (k * cin)) ** 0.5
        epi = None
        if subm and epilogue:
            epi = sg_ops.FusedEpilogue(
                scale=torch.rand(cout, generator=gen, device=dev) + 0.5,
                shift=torch.rand(cout, generator=gen, device=dev) - 0.5,
                valid=vout)
        shapes[key] = {"layers": [name], "plan": plan, "vout": vout,
                       "cin": cin, "cout": cout, "k": k, "bk": bk, "f": f,
                       "w": w, "epi": epi}
    return list(shapes.values())


def _gemm_shape(dev, shp):
    """Kernel 2 at one layer shape (``layer_shapes``' record), in both
    modes where the shape has an epilogue, against its plain version: the
    error, ms, plain ms, the bound of the work this data needs, and the
    work plan (CTAs, split blocks) with the planning kernel held to its
    plain version bit for bit."""
    import torch
    from repro_torch.core import sparsity
    from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
    from repro_torch.kernels.spconv_gemm import ops as sg_ops
    from repro_torch.kernels.spconv_gemm.kernel import spconv_gemm_fused
    from repro_torch.kernels.spconv_gemm.ref import spconv_gemm_fused_ref
    name, plan, vout = shp["layers"][0], shp["plan"], shp["vout"]
    cin, cout, k, bk = shp["cin"], shp["cout"], shp["k"], shp["bk"]
    f, w = shp["f"], shp["w"]
    row_nz = sparsity.row_nonzero(f)
    blk_nz = sparsity.row_block_nonzero(f, bk) & row_nz[:, None]
    gidx = plan.tiles.gather_idx.long()
    live_slot = plan.tiles.slot_valid & row_nz[gidx]
    live = int(live_slot.sum())
    # work this data needs: the live Cin blocks of each live map, and
    # the live blocks of the feature rows read once
    live_blocks = int((blk_nz[gidx] & live_slot[:, None]).sum())
    flops = 2.0 * live_blocks * bk * cout
    nbytes = 4.0 * (int(blk_nz.sum()) * bk + k * cin * cout
                    + int(vout.sum()) * cout) + 8.0 * live
    rec = {"layers": shp["layers"], "cin": cin, "cout": cout, "taps": k,
           "bk": bk, "live_maps": live, **_bound(flops, nbytes)}
    modes = [("plain", None)]
    if shp["epi"] is not None:
        modes.append(("epilogue", shp["epi"]))
    for mode, epi in modes:
        args, kw = sg_ops.kernel_inputs(f, w, plan.tiles,
                                        n_out=plan.n_out, row_nz=row_nz,
                                        epilogue=epi)
        tile_nz, tile_bk_nz = args[5], args[7]
        # the wrapper's work plan at this shape, the planning kernel
        # held to its plain version
        n_blocks, n_slabs = kw["n_out_pad"] // kw["bo"], -(-cout // 128)
        n_ctas, busy_min = sg_kernel.plan_shape(
            n_blocks, n_slabs, sg_kernel.sm_count(dev),
            sg_kernel.MAX_SPLITS)
        pkw = dict(n_blocks=n_blocks, n_ctas=n_ctas, busy_min=busy_min,
                   max_splits=sg_kernel.MAX_SPLITS)
        work, blk = sg_kernel.split_plan(plan.tiles.tile_ob, tile_nz,
                                         **pkw)
        want_work, want_blk = sg_kernel.split_plan_ref(
            plan.tiles.tile_ob, tile_nz, **pkw)
        check(torch.equal(work, want_work) and torch.equal(blk, want_blk),
              f"{name}: split_plan differs from its plain version")
        busy = (work[:, 0] >= 0) & (work[:, 2] > work[:, 1])
        rec["plan"] = {
            "ctas_launched": n_ctas * n_slabs,
            "ctas_with_tiles": int(busy.sum()) * n_slabs,
            "live_blocks": int(torch.unique(work[busy, 0]).numel()),
            "split_blocks": int((blk[:, 1] > 1).sum()),
            "most_ctas_per_block": int(blk[:, 1].max())}
        rec["dead_tiles"] = int(((plan.tiles.tile_nz != 0)
                                 & (tile_nz == 0)).sum())
        rec["dead_blocks_in_live_tiles"] = int(
            ((tile_nz != 0)[:, None] & (tile_bk_nz == 0)).sum())
        check(rec["dead_tiles"] > 0,
              f"{name}: no dead tile, the tile skip is not exercised")
        check(cin == bk or rec["dead_blocks_in_live_tiles"] > 0,
              f"{name}: no dead Cin block in a live tile, the block "
              f"skip is not exercised")
        got = spconv_gemm_fused(*args, **kw)
        want = spconv_gemm_fused_ref(*args, **kw)
        torch.cuda.synchronize()
        if epi is not None:
            (got, nz), (want, _) = got, want
            sweep = (got.reshape(got.shape[0], -1, 128) != 0).any(-1)
            check(torch.equal(nz, sweep.int()),
                  f"{name}: epilogue liveness is not a sweep of the "
                  f"kernel's own output")
        err = (got - want).abs().max().item()
        ref_max = want.abs().max().item()
        check(err <= TOL_KERNEL * max(ref_max, 1e-30),
              f"{name} ({mode}): max|k-p| {err} > {TOL_KERNEL} * "
              f"{ref_max}")
        rec[mode] = {
            "max_abs_err": err, "ref_max": ref_max,
            "ms": time_ms(lambda: spconv_gemm_fused(*args, **kw), 10),
            "plain_ms": time_ms(
                lambda: spconv_gemm_fused_ref(*args, **kw), 3)}
    rec["tflops"] = rec["flops"] / rec["plain"]["ms"] / 1e9
    rec["share_of_bound"] = rec["bound_ms"] / rec["plain"]["ms"]
    return rec


def phase_gemm(dev, scene, cfg):
    """Kernel 2 at every distinct layer shape of the model on the scene's
    plans, in both modes, against its plain version, on features with
    dead tiles and dead Cin blocks so that both skip branches run."""
    layers, shapes = layer_shapes(dev, scene, cfg)
    per_shape = {}
    for shp in shapes:
        rec = _gemm_shape(dev, shp)
        per_shape[shp["layers"][0]] = rec
        emit(phase="spconv_gemm_fused", **rec)
    # per request: every layer of one forward at its shape's time
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
             "bytes_ms": 0.0, "bound_ms_f32_cores": 0.0}
    for rec in per_shape.values():
        n = len(rec["layers"])
        total["ms"] += n * rec["plain"]["ms"]
        total["plain_ms"] += n * rec["plain"]["plain_ms"]
        for key in ("bound_ms", "ops_ms", "bytes_ms", "bound_ms_f32_cores"):
            total[key] += n * rec[key]
    err = max(r[m]["max_abs_err"] for r in per_shape.values()
              for m in ("plain", "epilogue") if m in r)
    emit(phase="spconv_gemm_fused.per_request", shapes=len(per_shape),
         layers=len(layers), **total)
    return {"name": "spconv_gemm_fused", "route": "cuda", "source": GEMM_SRC,
            "replaces": "src/repro/kernels/spconv_gemm/kernel.py:287",
            "max_abs_err": err, "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": ("operations" if total["ops_ms"] >= total["bytes_ms"]
                         else "bytes"),
            "library_ms": None,
            "bound_ms_f32_cores": total["bound_ms_f32_cores"],
            "timing": "sum over the 25 layers of one forward, unfused mode"}


def _kernel_entry(name, src, replaces, per_shape, launches, *,
                  library: bool, **extra):
    """One kernel's line of the ``kernels`` JSON: per-shape numbers summed
    over the 25 layers of one forward, each shape weighted by its layers."""
    keys = ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms",
            "bound_ms_f32_cores") + (("library_ms",) if library else ())
    tot = {key: sum(len(r["layers"]) * r[key] for r in per_shape)
           for key in keys}
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                         else "bytes"),
            "library_ms": tot.get("library_ms"),
            "bound_ms_f32_cores": tot["bound_ms_f32_cores"],
            "timing": "sum over the 25 layers of one forward", **extra}


def materialized_args(shp):
    """Kernel 3's inputs at one layer shape (``layer_shapes``' record): the
    tiles built with row elision, the gathered lhs with its invalid slots
    zeroed, and the weights padded to 128-column slabs."""
    from repro_torch.core import sparsity
    from repro_torch.kernels.spconv_gemm import ops as sg_ops
    from repro_torch.kernels.spconv_gemm.ref import BN
    plan, f = shp["plan"], shp["f"]
    tiles = sg_ops.build_tap_tiles(plan.kmap, sparsity.row_nonzero(f),
                                   bm=plan.tiles.bm, bo=plan.tiles.bo)
    lhs = f[tiles.gather_idx.long()]
    lhs.masked_fill_(~tiles.slot_valid[:, None], 0.0)
    return tiles, lhs, sg_ops._pad_cout(shp["w"], BN)


def _sha256(*tensors) -> str:
    """sha256 over the bytes of ``tensors``, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _scatter_valid_unordered(ps, tiles, n_out):
    """The form ``scatter_valid`` replaced: the valid slots' rows added by
    one ``index_add_``, in an order the card does not fix. Timed beside
    it here; the port never runs it."""
    import torch
    keep = torch.nonzero(tiles.slot_valid).squeeze(1)
    out = torch.zeros((n_out, ps.shape[1]), dtype=ps.dtype, device=ps.device)
    return out.index_add_(0, tiles.scatter_idx[keep].long(), ps[keep])


def _sum_times(vals, dst, n_rows, iters):
    """One fixed-order sum of ``vals`` by ``dst`` into ``n_rows`` rows: the
    segment-sum kernel held bit-equal to its plain version on the card
    over the same index, then device ms (CUDA events) of the kernel, of
    the plain version (its column layout built beforehand) and of one
    ``index_add_`` of the same kept values (the library call), beside the
    bound: the kept rows read, the output written and the index read at
    HBM's rate, against the adds at the CUDA cores' float32 rate. Then
    wall ms (host clock, device synced) of index build and sum, the sum
    alone over an index built beforehand, its backward and the bare call.
    With the index's shape: its widest row (from ``starts``), the sources
    kept and the channels."""
    import torch
    from repro_torch.core import segment
    from repro_torch.kernels.segment_sum import kernel as ss_kernel
    from repro_torch.kernels.segment_sum.ref import (segment_sum_ref,
                                                     with_layout)
    seg = segment.segments((dst, n_rows))[0]
    laid = with_layout(seg)
    got = ss_kernel.segment_sum(vals, seg)
    want = segment_sum_ref(vals, laid)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"segment_sum differs from its plain version over {n_rows} rows: "
          f"max |k - p| {err}")
    del got, want
    widest = int((seg.starts[1:] - seg.starts[:-1]).max()) if n_rows else 0
    keep = torch.nonzero(seg.key < n_rows).squeeze(1)
    kd, kv = seg.key[keep], vals[keep]
    kept, c = int(keep.numel()), int(np.prod(vals.shape[1:]))
    v = vals.detach().requires_grad_()
    y = segment.ordered_sum(v, seg)
    g = torch.ones_like(y)

    def lib():
        return torch.zeros_like(y).index_add_(0, kd, kv)

    lib_err = float((y.detach() - lib()).abs().max()) if y.numel() else 0.0
    nbytes = 4.0 * (kept + n_rows) * c + 8.0 * (kept + n_rows + 1)
    t_ops, t_bytes = kept * c / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return {"rows": n_rows, "sources": int(dst.shape[0]), "kept": kept,
            "channels": c, "widest_row": widest,
            "kernel_vs_plain": "bit-equal", "max_abs_err": err,
            "adds": kept * c, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3,
            "kernel_ms": time_ms(lambda: ss_kernel.segment_sum(vals, seg),
                                 max(iters, 10)),
            # a wide row's column loop is host-paced: one call is enough
            "plain_ms": time_ms(lambda: segment_sum_ref(vals, laid),
                                iters if widest < 1000 else 1),
            "library_ms": time_ms(lib, max(iters, 10)),
            "ordered_vs_index_add_max_abs_err": lib_err,
            "ordered_ms": wall_ms(lambda: segment.ordered_sum(
                vals, segment.segments((dst, n_rows))[0]), iters),
            "ordered_sum_only_ms": wall_ms(
                lambda: segment.ordered_sum(vals, seg), iters),
            "ordered_backward_ms": wall_ms(lambda: torch.autograd.grad(
                y, v, g, retain_graph=True), iters),
            "index_add_ms": wall_ms(lib, iters)}


#: the keys of a ``_sum_times`` record that the ``kernels`` line sums
SUM_KEYS = ("kernel_ms", "plain_ms", "bound_ms", "library_ms", "ops_ms",
            "bytes_ms")


def _sum_totals(recs) -> dict:
    """``SUM_KEYS`` summed over ``_sum_times`` records, with the bound's
    side and the largest kernel-vs-plain difference."""
    tot = {k: sum(r[k] for r in recs) for k in SUM_KEYS}
    tot["bound_by"] = ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                       else "bytes")
    tot["max_abs_err"] = max(r["max_abs_err"] for r in recs)
    tot["widest_row"] = max(r["widest_row"] for r in recs)
    return tot


def phase_materialized(dev, scene, cfg):
    """Kernel 3 at every distinct layer shape, on the same seeded inputs as
    phase_gemm, against its plain version; then the main path of this
    backend, ``apply_kmap`` at every shape with the launch counts set to 0
    just before and read just after, held against the fused ``apply_tiles``
    output, and run again: the two outputs must be bit-equal (the scatter
    adds each row's slots in slot order). Buffers are freed between
    shapes; the peak device memory of each shape's ``apply_kmap`` is
    printed, and its fixed-order scatter timed against the
    one-``index_add`` form it replaced and the bare library call."""
    import torch
    from repro_torch.core import sparsity
    from repro_torch.kernels.segment_sum import kernel as ss_kernel
    from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
    from repro_torch.kernels.spconv_gemm import ops as sg_ops
    from repro_torch.kernels.spconv_gemm.ref import BN, spconv_gemm_ref
    _, shapes = layer_shapes(dev, scene, cfg)
    per_shape = []
    for shp in shapes:
        cin, cout, k = shp["cin"], shp["cout"], shp["k"]
        bm = shp["plan"].tiles.bm
        tiles, lhs, wp = materialized_args(shp)
        args = (lhs, wp, tiles.tile_tap, tiles.tile_nz)
        got = sg_kernel.spconv_gemm(*args, bm=bm)
        want = spconv_gemm_ref(*args, bm=bm)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref_max = want.abs().max().item()
        del want
        name = shp["layers"][0]
        check(err <= TOL_KERNEL * max(ref_max, 1e-30),
              f"{name}: spconv_gemm max|k-p| {err} > {TOL_KERNEL} * "
              f"{ref_max}")
        n_tiles = tiles.n_tiles
        live_tiles = int(tiles.tile_nz.sum())
        check(live_tiles < n_tiles, f"{name}: no dead tile")
        # every dead tile of the layout has all-zero lhs rows, so mark every
        # third live tile dead as well: the kernel must give zeros there,
        # not the product, and leave the other tiles as they were
        killed = torch.nonzero(tiles.tile_nz).squeeze(1)[::3]
        check(bool((lhs.view(n_tiles, bm, cin)[killed].abs().amax(dim=(1, 2))
                    > 0).all()), f"{name}: a killed tile has zero lhs")
        nz = tiles.tile_nz.clone()
        nz[killed] = 0
        got_killed = sg_kernel.spconv_gemm(lhs, wp, tiles.tile_tap, nz, bm=bm)
        got.view(n_tiles, bm, -1)[killed] = 0
        check(torch.equal(got_killed, got),
              f"{name}: spconv_gemm with {killed.numel()} live tiles marked "
              f"dead is not the kernel's output with those tiles zeroed")
        del got, got_killed, nz
        m_pad, c_out_pad = lhs.shape[0], wp.shape[-1]
        # live lhs tiles read, the whole output written (zeros included),
        # the weights and the two per-tile streams
        nbytes = 4.0 * (live_tiles * bm * cin + m_pad * c_out_pad
                        + k * cin * c_out_pad) + 8.0 * n_tiles
        rec = {"layers": shp["layers"], "cin": cin, "cout": cout,
               "m_pad": m_pad, "tiles": n_tiles, "live_tiles": live_tiles,
               "dead_tiles": n_tiles - live_tiles,
               "killed_live_tiles": int(killed.numel()), "max_abs_err": err,
               "ref_max": ref_max,
               **_bound(2.0 * live_tiles * bm * cin * c_out_pad, nbytes),
               "ms": time_ms(lambda: sg_kernel.spconv_gemm(*args, bm=bm), 5),
               "plain_ms": time_ms(lambda: spconv_gemm_ref(*args, bm=bm), 2)}
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        del args, lhs
        per_shape.append(rec)

    # the main path of this backend: apply_kmap over every shape
    sg_kernel.materialized_launches = ss_kernel.launches = 0
    outs = []
    for shp, rec in zip(shapes, per_shape):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        outs.append(sg_ops.apply_kmap(shp["f"], shp["w"], shp["plan"].kmap,
                                      bm=shp["plan"].tiles.bm,
                                      bo=shp["plan"].tiles.bo))
        torch.cuda.synchronize()
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["peak_above_inputs_gb"] = (torch.cuda.max_memory_allocated()
                                       - held) / 1e9
    launches, ss_launches = sg_kernel.materialized_launches, \
        ss_kernel.launches
    check(launches == len(shapes) and ss_launches == len(shapes),
          f"apply_kmap launched spconv_gemm {launches} and segment_sum "
          f"{ss_launches} times over {len(shapes)} shapes")

    for shp, rec, out in zip(shapes, per_shape, outs):
        plan, f, w = shp["plan"], shp["f"], shp["w"]
        bm, bo = plan.tiles.bm, plan.tiles.bo
        row_nz = sparsity.row_nonzero(f)

        def fused():
            return sg_ops.apply_tiles(f, w, plan.tiles, n_out=plan.n_out,
                                      row_nz=row_nz)

        want = fused()
        err = (out - want).abs().max().item()
        ref_max = want.abs().max().item()
        check(err <= TOL_KERNEL * max(ref_max, 1e-30),
              f"{rec['layers'][0]}: apply_kmap vs apply_tiles {err} > "
              f"{TOL_KERNEL} * {ref_max}")
        rec["apply_kmap_vs_apply_tiles_err"] = err
        again = sg_ops.apply_kmap(f, w, plan.kmap, bm=bm, bo=bo)
        rec["apply_kmap_sha256"] = [_sha256(out), _sha256(again)]
        check(torch.equal(out, again),
              f"{rec['layers'][0]}: two apply_kmap runs differ in "
              f"{int((out != again).sum())} values")
        del again
        rec["apply_kmap_ms"] = time_ms(lambda: sg_ops.apply_kmap(
            f, w, plan.kmap, bm=bm, bo=bo), 3)
        rec["apply_tiles_ms"] = time_ms(fused, 3)
        # apply_kmap's steps apart: tile build, gather, kernel, scatter-add
        tiles = sg_ops.build_tap_tiles(plan.kmap, row_nz, bm=bm, bo=bo)
        gidx, dead = tiles.gather_idx.long(), ~tiles.slot_valid[:, None]

        def gather():
            return f[gidx].masked_fill_(dead, 0.0)

        ps = sg_kernel.spconv_gemm(gather(), sg_ops._pad_cout(w, BN),
                                   tiles.tile_tap, tiles.tile_nz, bm=bm)
        rec["valid_slots"] = int(tiles.slot_valid.sum())
        rec["apply_kmap_steps_ms"] = {
            "tile_build": time_ms(lambda: sg_ops.build_tap_tiles(
                plan.kmap, row_nz, bm=bm, bo=bo), 3),
            "gather": time_ms(gather, 3), "kernel": rec["ms"],
            "scatter_add": time_ms(lambda: sg_ops.scatter_valid(
                ps, tiles, plan.n_out), 3)}
        # the scatter apart: the segment-sum kernel against its plain
        # version and the bare library call; wall ms of scatter_valid and
        # of the one-index_add form it replaced
        dst = torch.where(tiles.slot_valid, tiles.scatter_idx.long(),
                          plan.n_out)
        rec["scatter_sum"] = {
            "after_ms": wall_ms(lambda: sg_ops.scatter_valid(
                ps, tiles, plan.n_out), 3),
            "before_ms": wall_ms(lambda: _scatter_valid_unordered(
                ps, tiles, plan.n_out), 3),
            **_sum_times(ps, dst, plan.n_out, 3)}
        del ps, tiles, gidx, dead, dst
        emit(phase="spconv_gemm", **rec)
    del outs
    tot = {key: sum(len(r["layers"]) * r[key] for r in per_shape)
           for key in ("apply_kmap_ms", "apply_tiles_ms")}
    # kernel 3's sum over the shapes, each once: one apply_kmap launch a
    # shape on the path above
    path = {key: sum(r[key] for r in per_shape)
            for key in ("ms", "bound_ms", "plain_ms")}
    path["share_of_bound"] = path["bound_ms"] / path["ms"]
    emit(phase="spconv_gemm.per_request", shapes=len(per_shape),
         peak_mem_gb=max(r["peak_mem_gb"] for r in per_shape),
         apply_kmap_path=path, **tot)
    entry = _kernel_entry(
        "spconv_gemm", MAT_SRC, "src/repro/kernels/spconv_gemm/kernel.py:68",
        per_shape, launches, library=False,
        apply_kmap_ms=tot["apply_kmap_ms"],
        apply_tiles_ms=tot["apply_tiles_ms"], apply_kmap_path=path)
    entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
    scatter = {"launches": ss_launches,
               **_sum_totals([r["scatter_sum"] for r in per_shape])}
    emit(phase="spconv_gemm.scatter_sum", shapes=len(per_shape), **scatter)
    return entry, scatter


def phase_masked(dev, scene, cfg):
    """Kernel 4 on one dense GEMM per layer shape: A = that layer's
    valid-masked input features (the phase_gemm inputs, with their dead
    tiles), B = its centre-tap weight. The kernel against its plain
    version and ``torch.matmul`` on the same padded operands; then the
    main path, ``sparse_dense_matmul`` at every shape, with the launch
    count set to 0 just before and read just after."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import sparsity
    from repro_torch.kernels.masked_matmul import kernel as mm_kernel
    from repro_torch.kernels.masked_matmul import ops as mm_ops
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    _, shapes = layer_shapes(dev, scene, cfg)
    t = 128                                   # bm = bn = bk, the defaults
    per_shape = []
    for shp in shapes:
        a, b = shp["f"], shp["w"][shp["k"] // 2]
        (m, kd), n = a.shape, b.shape[1]
        mp, kp, np_ = (-(-x // t) * t for x in (m, kd, n))
        ap = F.pad(a, (0, kp - kd, 0, mp - m)).contiguous()
        bp = F.pad(b, (0, np_ - n, 0, kp - kd)).contiguous()
        mask = sparsity.block_mask(ap, t, t).to(torch.int32)
        got = mm_kernel.masked_matmul(ap, bp, mask)
        want = masked_matmul_ref(ap, bp, mask)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref_max = want.abs().max().item()
        name = shp["layers"][0]
        check(err <= TOL_KERNEL * max(ref_max, 1e-30),
              f"{name}: masked_matmul max|k-p| {err} > {TOL_KERNEL} * "
              f"{ref_max}")
        live = int(mask.sum())
        check(live < mask.numel(), f"{name}: no dead tile in A")
        nbytes = 4.0 * (live * t * t + kp * np_ + mp * np_ + mask.numel())
        rec = {"layers": shp["layers"], "m": m, "k": kd, "n": n,
               "tiles": mask.numel(), "live_tiles": live,
               "dead_share": 1.0 - live / mask.numel(), "max_abs_err": err,
               "ref_max": ref_max,
               **_bound(2.0 * live * t * t * np_, nbytes),
               "ms": time_ms(lambda: mm_kernel.masked_matmul(ap, bp, mask),
                             10),
               "plain_ms": time_ms(lambda: masked_matmul_ref(ap, bp, mask),
                                   3),
               "library_ms": time_ms(lambda: torch.matmul(ap, bp), 10)}
        rec["tflops"] = rec["flops"] / rec["ms"] / 1e9
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["vs_library"] = rec["ms"] / rec["library_ms"]
        per_shape.append(rec)
        emit(phase="masked_matmul", **rec)
        if rec["ms"] > rec["library_ms"]:
            # the target is no shape slower than torch.matmul; a miss is
            # reported, not fatal
            emit(phase="masked_matmul.slower_than_library", layer=name,
                 ms=rec["ms"], library_ms=rec["library_ms"])
    emit(phase="masked_matmul.per_forward",
         shapes=len(per_shape),
         slower_than_library=[r["layers"][0] for r in per_shape
                              if r["ms"] > r["library_ms"]],
         **{key: sum(len(r["layers"]) * r[key] for r in per_shape)
            for key in ("ms", "library_ms", "plain_ms", "bound_ms",
                        "bound_ms_f32_cores")})

    # the main path of this backend: sparse_dense_matmul over every shape
    mm_kernel.launches = 0
    outs = [mm_ops.sparse_dense_matmul(shp["f"], shp["w"][shp["k"] // 2])
            for shp in shapes]
    torch.cuda.synchronize()
    launches = mm_kernel.launches
    check(launches == len(shapes),
          f"sparse_dense_matmul launched masked_matmul {launches} times "
          f"over {len(shapes)} shapes")
    for shp, out in zip(shapes, outs):
        want = shp["f"] @ shp["w"][shp["k"] // 2]
        err = (out - want).abs().max().item()
        check(err <= TOL_KERNEL * max(want.abs().max().item(), 1e-30),
              f"{shp['layers'][0]}: sparse_dense_matmul vs A @ B {err}")
    return _kernel_entry(
        "masked_matmul", MM_SRC,
        "src/repro/kernels/masked_matmul/kernel.py:45", per_shape, launches,
        library=True)


def phase_scan(dev, cfg, scene, model):
    """One MinkUNet-large forward of the scene through the tap-scan oracle
    (``impl="scan"``) against the kernel forward, unfused and with the
    fused epilogue, on the same plans."""
    import torch
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.models import minkunet
    fused = _seeded_model(dataclasses.replace(cfg, fused_epilogue=True), dev)
    fused.load_state_dict(model.state_dict())
    st = SparseTensor(*(torch.as_tensor(a, device=dev) for a in (
        scene.coords, scene.batch, scene.valid, scene.feats)))
    plans = minkunet.build_plans(st.coords, st.batch, st.valid, cfg,
                                 n_max=BUCKET, device=dev)
    res = {}
    for label, m in (("unfused", model), ("fused_epilogue", fused)):
        times = {}
        outs = {}
        for impl in (None, "scan"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[impl] = minkunet.forward(m, st, plans=plans, impl=impl)
            torch.cuda.synchronize()
            times[impl or "kernel"] = (time.perf_counter() - t0) * 1e3
        want, got = outs[None], outs["scan"]
        check(bool(torch.isfinite(got).all()), f"scan {label}: non-finite")
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        check(err <= TOL_LOGITS * scale,
              f"scan {label}: max|scan - kernel| {err} > {TOL_LOGITS} * "
              f"{scale}")
        res[label] = {"max_abs_err": err, "max_abs_logit": scale,
                      "scan_forward_ms": times["scan"],
                      "kernel_forward_ms": times["kernel"]}
    emit(phase="scan_forward", config=cfg.name,
         voxels=int(scene.valid.sum()),
         tolerance=f"{TOL_LOGITS} * max|logit|", **res)


def _flash_bound(b, hq, hkv, sq, skv, d, causal, window, elt):
    """The least time for one attention call: the live (q, k) pairs' 4 * D
    FLOPs each at the peak rate of the input type, against q, k, v read
    once and o written once. bf16 (``elt`` 2) counts at the bf16
    tensor-core rate; float32 at the float32-exact 3xTF32 rate, as
    ``_bound`` counts kernels 2-4, with ``bound_ms_f32_cores`` (the CUDA
    cores' 67 TFLOP/s, the rate of the route's first form) beside it."""
    q_pos = np.arange(sq) + skv - sq
    hi = q_pos if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, q_pos - window + 1) if window > 0 else 0 * q_pos
    pairs = b * hq * int((hi - lo + 1).sum())
    flops = 4.0 * d * pairs
    nbytes = float(elt * (2 * b * hq * sq * d + 2 * b * hkv * skv * d))
    if elt != 2:
        return {"live_pairs": pairs, **_bound(flops, nbytes)}
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return {"live_pairs": pairs, "flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def sdpa_call(q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call of kernel 5's function on
    these inputs (a yardstick, never called by the port), and its label.
    SDPA's ``is_causal`` is top-left aligned, so a window or Sq < Skv goes
    in as an explicit boolean band mask."""
    import torch
    import torch.nn.functional as F
    sq, skv = q.shape[2], k.shape[2]
    if window == 0 and (sq == skv or not causal):
        label, mask = f"sdpa(is_causal={causal}, enable_gqa=True)", None
    else:
        label = "sdpa(attn_mask=<bool band>, enable_gqa=True)"
        q_pos = torch.arange(sq, device=q.device)[:, None] + skv - sq
        k_pos = torch.arange(skv, device=q.device)[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window > 0:
            mask &= k_pos > q_pos - window

    def library():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
    return library, label


def phase_flash(dev):
    """Kernel 5 against its plain version at each of FLASH_SHAPES, with
    one ``scaled_dot_product_attention`` call of the same function timed
    beside it (``sdpa_call``). A bf16 shape is also checked (not timed) in
    float32 on the same values, which holds the float32 route at every D,
    window and ragged edge to 2e-5."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def held(name, q, k, v, kw, dt):
        """Max |kernel - plain|, after checking it against TOL_FLASH[dt]."""
        got = fa_kernel.flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw).float()
        check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite")
        diff = (got.float() - want).abs()
        rel, tol = TOL_FLASH[dt]
        worst = (diff - rel * want.abs()).max().item()
        check(worst <= tol, f"flash {name} ({dt}): |k-p| > {rel} |p| + {tol} "
                            f"(excess {worst})")
        return diff.max().item(), want

    per_shape = {}
    for name, b, hq, hkv, sq, skv, d, causal, window, dt in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window)
        f32_err = None
        if dt != "float32":
            f32_err, _ = held(name, q.float(), k.float(), v.float(), kw,
                              "float32")
        err, want = held(name, q, k, v, kw, dt)
        rel, tol = TOL_FLASH[dt]
        library, lib_call = sdpa_call(q, k, v, causal, window)
        lib_err = (library().float() - want).abs().max().item()
        del want
        rec = {"shape": [b, hq, hkv, sq, skv, d], "causal": causal,
               "window": window, "dtype": dt, "max_abs_err": err,
               "tolerance": f"{rel} * |plain| + {tol}",
               "f32_max_abs_err": f32_err,
               **_flash_bound(b, hq, hkv, sq, skv, d, causal, window,
                              q.element_size()),
               "ms": time_ms(lambda: fa_kernel.flash_attention(q, k, v, **kw),
                             10),
               "plain_ms": time_ms(lambda: attention_ref(q, k, v, **kw), 3),
               "library_ms": time_ms(library, 10), "library_call": lib_call,
               "library_vs_plain_max_abs_err": lib_err}
        rec["tflops"] = rec["flops"] / rec["ms"] / 1e9
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["vs_library"] = rec["ms"] / rec["library_ms"]
        per_shape[name] = rec
        emit(phase="flash_attention", name=name, **rec)
        del q, k, v, library
        torch.cuda.empty_cache()
    return per_shape


def phase_lm_serve(dev):
    """The main path of the dense decoder: TinyLlama-1.1B at full width and
    depth (bf16, seeded random weights) serving LM_BATCH prompts of
    LM_PROMPT tokens for LM_GEN tokens through ``generate``, after one
    warm-up call, with the flash launch count set to 0 just before and read
    just after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import serve
    from repro_torch.models import api
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model = api.build_model(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    batch = {"tokens": prompts}
    max_ctx = LM_PROMPT + LM_GEN
    serve.generate(model, params, batch, max_context=max_ctx, n_steps=2,
                   device=dev)                     # cuBLAS init, not measured
    fa_kernel.launches = 0
    toks, stats = serve.generate(model, params, batch, max_context=max_ctx,
                                 n_steps=LM_GEN, device=dev)
    launches = fa_kernel.launches
    check(launches == cfg.n_layers,
          f"one prefill launched flash_attention {launches} times, want "
          f"{cfg.n_layers}")
    check(stats["graphed"], "lm_serve: the decode step was not replayed "
                            "from a graph")
    decode_graph = _decode_graph_check(model, params, batch, max_ctx, toks)
    check(stats["nonfinite_stops"] == 0,
          f"{stats['nonfinite_stops']} sequences went non-finite")
    check(tuple(toks.shape) == (LM_BATCH, LM_GEN)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"generated tokens {tuple(toks.shape)} out of range")
    wall = stats["prefill_s"] + stats["decode_s_per_tok"] * (LM_GEN - 1)
    prof = _profile_lm(model, params, batch, max_ctx, stats)
    emit(phase="lm_serve", config=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, batch=LM_BATCH, prompt_len=LM_PROMPT,
         generated=LM_GEN, prefill_ms=stats["prefill_s"] * 1e3,
         decode_ms_per_token=stats["decode_s_per_tok"] * 1e3,
         generated_tokens_per_s=LM_BATCH * LM_GEN / wall,
         decode_tokens_per_s=LM_BATCH / stats["decode_s_per_tok"],
         prefill_tokens_per_s=LM_BATCH * LM_PROMPT / stats["prefill_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         flash_launches_per_prefill=launches,
         nonfinite_stops=stats["nonfinite_stops"],
         capture_ms=stats["capture_s"] * 1e3, decode_graph=decode_graph,
         first_tokens=toks[0, :8].tolist(), profile=prof,
         seconds=time.perf_counter() - t_phase)
    return cfg, params, launches


def _decode_graph_check(model, params, batch, max_ctx, served):
    """The decode step replayed from a CUDA graph against an eager
    ``decode_step`` loop, greedy from the same prefill: the tokens of
    each, and of ``generate`` (``served``), equal, with the largest
    per-step |logit difference| (expected 0: the same ops on the same
    card); decode ms a token of each, the capture left out."""
    import torch
    from repro_torch.runtime import graph
    dev = model.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    n_steps = served.shape[1]

    def run(graphed):
        logits, cache = model.prefill(params, b, max_ctx)
        tok = logits.argmax(-1)[:, None].int()
        toks, outs, g, t_cap = [tok], [], None, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps - 1):
            if not graphed:
                logits, cache = model.decode_step(params, cache, tok)
            elif g is None:
                g = graph.Graph(
                    lambda t: model.decode_step(params, cache, t)[0], dev)
                logits = g.warm_up(tok)
                t1 = time.perf_counter()
                g.capture(tok)
                t_cap = time.perf_counter() - t1
            else:
                logits = g(tok)
            outs.append(logits[:, -1].float())
            tok = logits[:, -1].argmax(-1)[:, None].int()
            toks.append(tok)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0 - t_cap) * 1e3 / (n_steps - 1)
        return torch.cat(toks, 1), outs, ms

    eager_toks, eager_logits, eager_ms = run(False)
    graph_toks, graph_logits, graph_ms = run(True)
    diffs = [float((a - e).abs().max())
             for a, e in zip(graph_logits, eager_logits)]
    check(torch.equal(graph_toks, eager_toks),
          f"lm_serve: graphed decode tokens differ from the eager loop's "
          f"(max |logit diff| {max(diffs)})")
    check(torch.equal(served.to(dev).int(), eager_toks),
          "lm_serve: generate's tokens differ from the eager loop's")
    return {"steps": n_steps - 1, "tokens_equal": True,
            "max_logit_diff_per_step": diffs,
            "eager_ms_per_token": eager_ms, "replayed_ms_per_token": graph_ms}


def _profile_lm(model, params, batch, max_ctx, stats):
    """Device time of one prefill and one decode step under
    ``torch.profiler`` (device-side events only), the number of device
    operations each runs, the top kernels, and the idle share against the
    unprofiled times of the served run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = {k: torch.as_tensor(v, device=model.device)
             for k, v in batch.items()}
    logits, cache = model.prefill(params, batch, max_ctx)
    tok = logits.argmax(-1)[:, None].int()
    torch.cuda.synchronize()
    out = {}
    for label, fn, wall_ms in (
            ("prefill", lambda: model.prefill(params, batch, max_ctx),
             stats["prefill_s"] * 1e3),
            ("decode_step", lambda: model.decode_step(params, cache, tok),
             stats["decode_s_per_tok"] * 1e3)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        out[label] = {"device_busy_ms": busy,
                      "device_ops": sum(r[2] for r in rows),
                      "served_ms": wall_ms, "idle_share": 1 - busy / wall_ms,
                      "top": [{"name": n[:60], "device_ms": ms, "calls": c}
                              for n, ms, c in rows[:6]]}
    return out


def phase_lm_reference(dev, cfg, params):
    """The kernel prefill's last-token logits against the plain-version
    prefill (``impl="ref"``), in bf16 and, on a float32 copy of the model,
    in float32; the first decode step against a teacher-forced prefill of
    prompt + token (513 tokens: a ragged block for the kernel)."""
    import torch
    from repro_torch.models import transformer
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)), device=dev)
    mc = LM_PROMPT + LM_GEN

    def compare(label, got, want, tol):
        g = _logit_gate(label, got, want, tol)
        check(g["ok"], f"{label}: {g}")
        return g

    res = {}
    lk, cache = transformer.prefill(params, tokens, cfg, max_context=mc)
    lr, _ = transformer.prefill(params, tokens, cfg, max_context=mc,
                                impl="ref")
    res["bf16_prefill"] = compare("bf16 prefill", lk, lr, TOL_LM_BF16)
    res["bf16_prefill"]["greedy_agreement"] = int(
        (lk.float().argmax(-1) == lr.float().argmax(-1)).sum())
    nxt = lk.float().argmax(-1)[:, None].int()
    ld, _ = transformer.decode_step(params, cache, nxt, cfg)
    full, _ = transformer.prefill(params, torch.cat([tokens, nxt], 1), cfg,
                                  max_context=mc + 1)
    res["bf16_decode_vs_prefill"] = compare("bf16 decode", ld[:, 0], full,
                                            TOL_LM_BF16)
    del cache, lk, lr, ld, full
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = transformer.DecoderLM(
        cfg32, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED)).params()
    lk, _ = transformer.prefill(p32, tokens, cfg32, max_context=mc)
    lr, _ = transformer.prefill(p32, tokens, cfg32, max_context=mc,
                                impl="ref")
    res["f32_prefill"] = compare("f32 prefill", lk, lr, TOL_LM_F32)
    # device ms of a whole float32 prefill (22 layers, one kernel-5 launch
    # each), kernel and plain attention, warm
    res["f32_prefill"]["ms"] = {impl: time_ms(
        lambda impl=impl: transformer.prefill(p32, tokens, cfg32,
                                              max_context=mc, impl=impl), 3)
        for impl in ("kernel", "ref")}
    res["f32_prefill"]["greedy_agreement"] = int(
        (lk.argmax(-1) == lr.argmax(-1)).sum())
    emit(phase="lm_reference", config=cfg.name, batch=LM_BATCH,
         prompt_len=LM_PROMPT, **res)
    del p32
    torch.cuda.empty_cache()


def _routing(fn, pin=None):
    """``(fn(), choices)``: ``fn`` run with ``moe.top_k`` recording each
    call's expert choice (one a layer a forward) or, given ``pin`` (such a
    list), returning the pinned choice with the gates read off the run's
    own logits, as phase ``train`` pins ReLU masks."""
    from repro_torch.models import moe
    orig, rec = moe.top_k, []
    pinned = iter(pin) if pin is not None else None

    def hook(logits, k):
        if pinned is None:
            vals, idx = orig(logits, k)
        else:
            idx = next(pinned)
            vals = logits.gather(-1, idx)
        rec.append(idx)
        return vals, idx

    moe.top_k = hook
    try:
        return fn(), rec
    finally:
        moe.top_k = orig


def _flips(a, b) -> int:
    """(token, layer) routing decisions whose expert sets differ."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))


def _logit_gate(label, got, want, tol):
    """Max |got - want| against ``tol`` x max |want|, not yet checked."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    check(bool(got.isfinite().all()), f"{label}: non-finite")
    return {"max_abs_err": err, "max_abs_logit": scale,
            "tolerance": f"{tol} * max|logit|", "ok": err <= tol * scale}


def phase_moe_serve(dev):
    """The MoE decoder served: Mixtral-8x7B at full width with its depth
    cut to MOE_LAYERS of 32 (:func:`_moe_serve`, with the long request and
    a profile). Returns the flash launches."""
    launches, rec = _moe_serve(dev, MOE_ARCH, MOE_LAYERS, MOE_GEN, long=True,
                               profile=True)
    emit(phase="moe_serve", **rec)
    return launches


def _moe_serve(dev, arch, layers, gen, *, long, profile):
    """An MoE decoder served: ``arch`` at full width with its depth cut to
    ``layers`` (bf16, seeded random weights), ``generate`` over MOE_BATCH
    prompts of MOE_PROMPT tokens for ``gen`` tokens after one warm-up,
    then, with ``long``, one MOE_LONG_PROMPT-token request for
    MOE_LONG_GEN (past the 4,096-token window: the kernel's window and the
    rolling cache on the path), each with the flash count set to 0 just
    before and read just after: one launch a layer a prefill. Gates, at phase
    ``lm_reference``'s bf16 tolerance: each request's prefill logits
    against the ``impl="ref"`` prefill (the routing decisions that differ
    between the two are counted; should they break the gate, the plain
    run's routing is pinned to the kernel run's and gated), and the first
    decode step against the teacher-forced prefill (the new token's
    routing decisions counted the same way; should they break the gate,
    the prefill's routing of that token is pinned to the decode step's).
    That check holds only where no copy is dropped (a 1-token decode step
    never drops one; a prefill of 512 or 513 tokens at capacity factor
    1.25 does), so it runs on a drop-free copy of the config (capacity
    factor E / k, the reference's own drop-free setting for it); the
    served capacity's drop fraction is that of the timed prefills
    (``runs``). With ``profile``,
    one prefill and one decode step under the profiler. Returns the flash
    launches and the record, the model freed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import serve
    from repro_torch.models import api, transformer
    t_phase = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    model = api.build_model(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    weights_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(SEED)
    requests = {
        "batch": ({"tokens": rng.integers(0, cfg.vocab,
                                          (MOE_BATCH, MOE_PROMPT))}, gen),
        "long": ({"tokens": rng.integers(0, cfg.vocab,
                                         (1, MOE_LONG_PROMPT))},
                 MOE_LONG_GEN)}
    if not long:
        del requests["long"]
    batch = requests["batch"][0]
    serve.generate(model, params, batch, max_context=MOE_PROMPT + gen,
                   n_steps=2, device=dev)          # cuBLAS init, not measured
    runs, launches = {}, 0
    for label, (b, gen) in requests.items():
        n_b, s = b["tokens"].shape
        fa_kernel.launches = 0
        toks, stats = serve.generate(model, params, b, max_context=s + gen,
                                     n_steps=gen, device=dev)
        n = fa_kernel.launches
        launches += n
        check(n == cfg.n_layers, f"moe_serve {label}: one prefill launched "
                                 f"flash_attention {n} times, want "
                                 f"{cfg.n_layers}")
        check(stats["graphed"], f"moe_serve {label}: the decode step was "
                                f"not replayed from a graph")
        check(stats["nonfinite_stops"] == 0,
              f"moe_serve {label}: {stats['nonfinite_stops']} sequences "
              f"went non-finite")
        check(tuple(toks.shape) == (n_b, gen)
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"moe_serve {label}: tokens {tuple(toks.shape)} out of range")
        wall = stats["prefill_s"] + stats["decode_s_per_tok"] * (gen - 1)
        with torch.no_grad():
            _, aux, _ = transformer.forward_embeds(
                params, params["embed"][torch.as_tensor(b["tokens"],
                                                        device=dev)], cfg)
        runs[label] = {
            "batch": n_b, "prompt_len": s, "generated": gen,
            "cache_slots": transformer.cache_capacity(cfg, s + gen),
            "prefill_ms": stats["prefill_s"] * 1e3,
            "decode_ms_per_token": stats["decode_s_per_tok"] * 1e3,
            "generated_tokens_per_s": n_b * gen / wall,
            "prefill_tokens_per_s": n_b * s / stats["prefill_s"],
            "flash_launches_per_prefill": n,
            "moe_drop_frac": aux["moe_drop_frac"].item(),
            "moe_aux": aux["moe_aux"].item(),
            "first_tokens": toks[0, :8].tolist()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile_lm(model, params, batch, MOE_PROMPT + gen, {
        "prefill_s": runs["batch"]["prefill_ms"] / 1e3,
        "decode_s_per_tok": runs["batch"]["decode_ms_per_token"] / 1e3}) \
        if profile else None

    # kernel prefill against the plain one, routing flips counted
    gates = {}
    for label, (b, gen) in requests.items():
        tokens = torch.as_tensor(b["tokens"], device=dev)
        mc = tokens.shape[1] + gen
        (lk, _), rk = _routing(lambda: transformer.prefill(
            params, tokens, cfg, max_context=mc))
        (lr, _), rr = _routing(lambda: transformer.prefill(
            params, tokens, cfg, max_context=mc, impl="ref"))
        g = _logit_gate(f"moe {label} prefill", lk, lr, TOL_LM_BF16)
        g["routing_flips"] = _flips(rk, rr)
        g["routing_decisions"] = cfg.n_layers * tokens.numel()
        if not g["ok"] and g["routing_flips"]:
            (lp, _), _ = _routing(lambda: transformer.prefill(
                params, tokens, cfg, max_context=mc, impl="ref"), pin=rk)
            g["pinned"] = _logit_gate(f"moe {label} prefill, pinned", lk,
                                      lp, TOL_LM_BF16)
            check(g["pinned"]["ok"], f"moe {label} prefill with the plain "
                                     f"routing pinned: {g['pinned']}")
        else:
            check(g["ok"], f"moe {label} prefill vs plain: {g}")
        g["greedy_agreement"] = int((lk.float().argmax(-1)
                                     == lr.float().argmax(-1)).sum())
        gates[f"{label}_prefill"] = g
        del lk, lr, rk, rr

    # first decode step against the teacher-forced prefill, drop-free
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    mc = MOE_PROMPT + gen
    free = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k)
    lk, cache = transformer.prefill(params, tokens, free, max_context=mc)
    nxt = lk.float().argmax(-1)[:, None].int()
    (ld, _), rd = _routing(lambda: transformer.decode_step(
        params, cache, nxt, free))
    forced = torch.cat([tokens, nxt], 1)
    (full_logits, _), rf = _routing(lambda: transformer.prefill(
        params, forced, free, max_context=mc + 1))
    g = _logit_gate("moe decode (drop-free)", ld[:, 0], full_logits,
                    TOL_LM_BF16)
    # the new token's routing, decode step against the prefill's last row
    g["routing_flips"] = _flips([r[:, -1:] for r in rf], rd)
    g["routing_decisions"] = cfg.n_layers * tokens.shape[0]
    if not g["ok"] and g["routing_flips"]:
        pin = [torch.cat([r[:, :-1], d], 1) for r, d in zip(rf, rd)]
        (lp, _), _ = _routing(lambda: transformer.prefill(
            params, forced, free, max_context=mc + 1), pin=pin)
        g["pinned"] = _logit_gate("moe decode (drop-free), pinned",
                                  ld[:, 0], lp, TOL_LM_BF16)
        check(g["pinned"]["ok"], f"moe decode vs teacher-forced prefill "
                                 f"(drop-free) with the decode's routing "
                                 f"pinned: {g['pinned']}")
        del lp
    else:
        check(g["ok"], f"moe decode vs teacher-forced prefill (drop-free): "
                       f"{g}")
    gates["decode_vs_prefill_drop_free"] = g
    gates_peak = torch.cuda.max_memory_allocated() / 1e9
    del lk, cache, ld, full_logits, rd, rf, params, model
    _free()
    rec = {"config": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
           "weights_gb": weights_gb, "peak_mem_gb": peak,
           "gates_peak_mem_gb": gates_peak, "runs": runs,
           "flash_launches": launches, "profile": prof, **gates,
           "seconds": time.perf_counter() - t_phase}
    return launches, rec


def _lm_loss_path(model, params, opt_cfg, stream, steps, impl):
    """``make_train_step``'s steps from ``params`` (its two calls inline,
    to keep the gradients): each step's loss, ``grad_norm`` and learning
    rate, the share of parameter elements the update changed, and the
    update's first-order loss change on its own batch (the sum of g . dp,
    with the unclipped gradients)."""
    import torch
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    state = (params, adamw.init(params))
    path = {key: [] for key in ("losses", "grad_norm", "lr", "moved",
                                "first_order")}
    for i in range(steps):
        old = state[0]
        loss, _, grads = train.lm_loss_and_grads(model, old,
                                                 stream.batch_at(i),
                                                 impl=impl)
        new, opt, om = adamw.update(opt_cfg, grads, state[1], old)
        state = (new, opt)
        with torch.no_grad():
            moved = sum(int((new[k] != p).sum()) for k, p in old.items())
            lin = sum(torch.sum(grads[k].float()
                                * (new[k].float() - p.float())).item()
                      for k, p in old.items())
        path["losses"].append(loss.item())
        path["grad_norm"].append(om["grad_norm"].item())
        path["lr"].append(om["lr"].item())
        path["moved"].append(moved / sum(p.numel() for p in old.values()))
        path["first_order"].append(lin)
        del grads, old
    return path


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_clone(v) for v in tree)
    return tree.clone()


def _lm_graph_gate(dev, model, opt_cfg, stream):
    """TinyLlama-1.1B's donated step as ``run_lm`` runs it
    (``train.CompiledStep``: eager once, captured and replayed at the
    second call, replayed after), each of the LM_TRAIN_STEPS - 1 replays
    against an eager step from the same state and batch (a copy of the
    state taken before the replay). The gate: every leaf of the
    state and the loss bit-equal; else the loss within TOL_LM_TRAIN_LOSS
    and each leaf's difference within TOL_LM_TRAIN_GRAD of the norm of
    the eager step's change to it. Then AdamW alone (``adamw.update_``)
    timed eagerly and replayed from its own donated graph. Returns the
    record."""
    import torch
    from repro_torch.checkpoint import checkpoint
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.runtime import graph

    step = train.make_train_step(model, opt_cfg, donate=True)
    compiled = train.CompiledStep(step, dev)
    state = train.init_state(model, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compiled(state, _device_batch(dev, stream.batch_at(0)))
    torch.cuda.synchronize()
    rec = {"warm_up_ms": (time.perf_counter() - t0) * 1e3, "steps": []}
    broken = []
    for i in range(1, LM_TRAIN_STEPS):
        b = _device_batch(dev, stream.batch_at(i))
        pre, twin = _tree_clone(state), _tree_clone(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = compiled(state, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        twin, tm = step(twin, b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        worst, equal = 0.0, 0
        leaves = list(zip(checkpoint.tree_leaves(state),
                          checkpoint.tree_leaves(twin),
                          checkpoint.tree_leaves(pre)))
        for a, e, p in leaves:
            if torch.equal(a, e):
                equal += 1
                continue
            moved = (e.float() - p.float()).norm().clamp(min=1e-30)
            worst = max(worst, ((a.float() - e.float()).norm()
                                / moved).item())
        loss_rel = abs(m["loss"].item() - tm["loss"].item()) / abs(
            tm["loss"].item())
        bit = equal == len(leaves) and loss_rel == 0.0
        if not bit and (loss_rel > TOL_LM_TRAIN_LOSS
                        or worst > TOL_LM_TRAIN_GRAD):
            broken.append(f"step {i}: loss {loss_rel}, update {worst}")
        rec["steps"].append({"step": i, "graph": compiled.last,
                             "replay_ms": (t1 - t0) * 1e3,
                             "eager_ms": (t2 - t1) * 1e3,
                             "loss": m["loss"].item(),
                             "eager_loss": tm["loss"].item(),
                             "bit_equal": bit, "leaves_equal": equal,
                             "leaves": len(leaves),
                             "loss_rel_err": loss_rel,
                             "worst_update_rel_err": worst})
        del pre, twin
    check(not broken, f"lm_train graph against eager: {'; '.join(broken)}")
    rec["pool_bytes"] = compiled.graph.pool_bytes
    compiled.release()

    # AdamW alone over the 201 tensors, eager and replayed
    params, opt_state = state
    _, _, grads = train.lm_loss_and_grads(
        model, params, _device_batch(dev, stream.batch_at(0)))

    def update(st, gr):
        return st, adamw.update_(opt_cfg, gr, st[1], st[0])

    eager = [wall_ms(lambda: update((params, opt_state), grads), 1)
             for _ in range(3)]
    g = graph.Graph(update, dev, donate=True)
    g.warm_up((params, opt_state), grads)
    g.capture((params, opt_state), grads)
    replay = [wall_ms(lambda: g((params, opt_state), grads), 1)
              for _ in range(3)]
    rec["adamw"] = {"tensors": len(params), "eager_ms": eager,
                    "replay_ms": replay, "pool_bytes": g.pool_bytes}
    g.release()
    del state, params, opt_state, grads, g
    return rec


def phase_lm_train(dev):
    """Decoder-LM training on the card through ``make_train_step``.
    TinyLlama-1.1B at full width and depth (bf16) takes LM_TRAIN_STEPS
    steps of LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens from ``TokenStream(seed
    0)`` through ``run_lm``, the training CLI's loop (a ``TrainRunner``
    with its baseline and final checkpoint saves; the CLI's schedule,
    warmup 5 steps; the first step eager, the second captured and
    replayed, the others replayed from its CUDA graph), with the flash
    count set to 0 just before and read just after: 2 launches a layer a
    step under remat ``full`` (the forward and its recomputation in the
    backward; the backward itself is the plain version's VJP), replays
    counted. Each replay is then held to an eager step from the same state
    and batch (``_lm_graph_gate``), and AdamW is timed alone, eager and
    replayed. A witness for that loss path takes the same steps from the
    same state and batches again (``_lm_loss_path``): in bf16 through the
    kernel and through the plain attention, whose losses must agree with
    each other and with ``run_lm``'s (TOL_LM_TRAIN_PATH), and in float32,
    reported. The gate runs in float32 on the same
    config: one step's loss (TOL_LM_TRAIN_LOSS relative) and each gradient
    (its difference's norm within TOL_LM_TRAIN_GRAD of its norm) through
    the kernel against the plain version. Then Mixtral-8x7B at full width,
    MOE_TRAIN_LAYERS of 32 layers (bf16), MOE_TRAIN_STEPS steps of
    MOE_TRAIN_BATCH x LM_TRAIN_SEQ, captured and replayed as TinyLlama's
    (AdamW in place: one state): finite losses, the router's gradient
    nonzero (AdamW's first moment of every router is), the kernel's
    launches. Returns the launches of each run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import train
    from repro_torch.models import api, common
    from repro_torch.optim import adamw
    out = {}

    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.launches = 0
    res = train.run_lm(LM_ARCH, steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
                       seq=LM_TRAIN_SEQ, lr=LM_TRAIN_LR,
                       ckpt_every=LM_TRAIN_STEPS + 1, full_config=True,
                       seed=SEED, device=dev)
    launches = fa_kernel.launches
    want = 2 * cfg.n_layers
    losses = res["losses"]
    check(len(losses) == LM_TRAIN_STEPS and all(np.isfinite(losses)),
          f"lm_train: losses {losses}")
    check(res["recoveries"] == 0 and res["ckpt_failures"] == 0,
          f"lm_train: {res['recoveries']} recoveries, "
          f"{res['ckpt_failures']} checkpoint failures")
    check(launches == want * LM_TRAIN_STEPS,
          f"lm_train: {launches} flash launches in {LM_TRAIN_STEPS} steps, "
          f"want {want} a step")
    modes = [t["graph"] for t in res["timings"]]
    check(modes == ["warm-up", "capture"] + ["replay"] * (LM_TRAIN_STEPS - 2),
          f"lm_train: run_lm's steps ran {modes}, want a warm-up, a "
          f"capture, then replays")
    out["tinyllama"] = launches
    emit(phase="lm_train", config=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
         steps=LM_TRAIN_STEPS, lr=LM_TRAIN_LR, losses=losses,
         step_ms=res["timings"], pool_bytes=res["pool_bytes"],
         save_ms=res["save_ms"],
         flash_launches=launches,
         flash_launches_per_step=launches / LM_TRAIN_STEPS,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         remat="full", digest=res["state_digest"])
    del res
    torch.cuda.empty_cache()
    stream = train.make_stream(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=SEED)
    model16 = api.build_model(cfg, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=LM_TRAIN_LR, total_steps=LM_TRAIN_STEPS,
                                warmup_steps=max(LM_TRAIN_STEPS // 20, 5))
    gate = _lm_graph_gate(dev, model16, opt_cfg, stream)
    emit(phase="lm_train.graph", config=cfg.name, dtype=cfg.dtype, **gate,
         tolerance={"bit_equal": "wanted",
                    "else_loss": f"{TOL_LM_TRAIN_LOSS} relative",
                    "else_update": f"{TOL_LM_TRAIN_GRAD} x |eager update|"})
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = api.build_model(cfg32, device=dev)

    # a witness for the bf16 loss path: the same steps from the same state
    # (run_lm's) and batches, through the plain attention and in float32
    init16, _ = train.init_state(model16, seed=SEED)
    paths = {}
    for label, model, impl in (("bf16_kernel", model16, "kernel"),
                               ("bf16_plain", model16, "ref"),
                               ("f32_kernel", model32, "kernel")):
        dt = common.dtype_of(model.cfg)
        paths[label] = _lm_loss_path(
            model, {k: v.to(dt) for k, v in init16.items()}, opt_cfg,
            stream, LM_TRAIN_STEPS, impl)
        torch.cuda.empty_cache()
    del init16
    emit(phase="lm_train.loss_path", config=cfg.name, run_lm_losses=losses,
         tolerance=f"{TOL_LM_TRAIN_PATH} relative", **paths)
    path_k, path_r = paths["bf16_kernel"]["losses"], \
        paths["bf16_plain"]["losses"]
    for path, base, what in ((path_k, path_r, "kernel vs plain attention"),
                             (losses, path_k, "run_lm vs the same steps")):
        check(all(abs(x - y) <= TOL_LM_TRAIN_PATH * abs(y)
                  for x, y in zip(path, base)),
              f"lm_train bf16 loss path, {what}: {path} vs {base}")

    # the gate: one step's loss and gradients, kernel vs plain, float32
    params, _ = train.init_state(model32, seed=SEED)
    b = stream.batch_at(0)
    fa_kernel.launches = 0
    step_ms = {}
    t0 = time.perf_counter()
    lk, mk, gk = train.lm_loss_and_grads(model32, params, b)
    torch.cuda.synchronize()
    step_ms["kernel"] = (time.perf_counter() - t0) * 1e3
    n_kernel = fa_kernel.launches
    t0 = time.perf_counter()
    lr, _, gr = train.lm_loss_and_grads(model32, params, b, impl="ref")
    torch.cuda.synchronize()
    step_ms["plain"] = (time.perf_counter() - t0) * 1e3
    check(n_kernel == want and fa_kernel.launches == want,
          f"lm_train f32: {n_kernel} kernel launches, "
          f"{fa_kernel.launches - n_kernel} in the plain step")
    loss_rel = abs(lk.item() - lr.item()) / abs(lr.item())
    rel = {k: ((gk[k].float() - g.float()).norm()
               / g.float().norm().clamp(min=1e-30)).item()
           for k, g in gr.items()}
    worst = max(rel, key=rel.get)
    check(loss_rel <= TOL_LM_TRAIN_LOSS,
          f"lm_train f32: loss {lk.item()} vs plain {lr.item()}")
    check(rel[worst] <= TOL_LM_TRAIN_GRAD,
          f"lm_train f32: gradient {worst} differs by {rel[worst]} of its "
          f"norm")
    emit(phase="lm_train.gate", config=cfg32.name, dtype="float32",
         loss=lk.item(), plain_loss=lr.item(), loss_rel_err=loss_rel,
         worst_grad=worst, worst_grad_rel_err=rel[worst],
         median_grad_rel_err=float(np.median(list(rel.values()))),
         step_ms=step_ms,
         tolerance={"loss": f"{TOL_LM_TRAIN_LOSS} relative",
                    "grad": f"{TOL_LM_TRAIN_GRAD} x |g_plain|"})
    del params, gk, gr, model32
    torch.cuda.empty_cache()

    # Mixtral-8x7B at full width, its depth cut: parameters, gradients and
    # one AdamW state (the donated step updates in place), replayed
    full = get_config(MOE_ARCH)
    mcfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    model = api.build_model(mcfg, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    state = train.init_state(model, seed=SEED)
    stream = train.make_stream(mcfg, MOE_TRAIN_BATCH, LM_TRAIN_SEQ,
                               seed=SEED)
    timings = []
    step = train.CompiledStep(train.make_train_step(
        model, adamw.AdamWConfig(lr=LM_TRAIN_LR, total_steps=MOE_TRAIN_STEPS,
                                 warmup_steps=5), donate=True), dev)
    metrics = []
    fa_kernel.launches = 0
    for i in range(MOE_TRAIN_STEPS):
        b = _device_batch(dev, stream.batch_at(i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        timings.append({"step_ms": (time.perf_counter() - t0) * 1e3,
                        "graph": step.last})
        metrics.append({k: v.item() for k, v in m.items()})
    launches = fa_kernel.launches
    want = 2 * mcfg.n_layers * MOE_TRAIN_STEPS
    check(launches == want, f"lm_train mixtral: {launches} flash launches, "
                            f"want {want}")
    modes = [t["graph"] for t in timings]
    check(modes == ["warm-up", "capture"] + ["replay"] * (MOE_TRAIN_STEPS
                                                          - 2),
          f"lm_train mixtral: the steps ran {modes}")
    check(all(np.isfinite(m["loss"]) for m in metrics),
          f"lm_train mixtral: losses {[m['loss'] for m in metrics]}")
    router_m = [state[1]["m"][f"layers.{i}.moe.router"].abs().max().item()
                for i in range(mcfg.n_layers)]
    check(all(r > 0 for r in router_m),
          f"lm_train mixtral: router first moments {router_m}")
    out["mixtral"] = launches
    emit(phase="lm_train.moe", config=mcfg.name, dtype=mcfg.dtype,
         layers=mcfg.n_layers, reduced={"n_layers": [full.n_layers,
                                                     mcfg.n_layers]},
         batch=MOE_TRAIN_BATCH, seq=LM_TRAIN_SEQ, metrics=metrics,
         step_ms=timings, pool_bytes=step.graph.pool_bytes,
         router_first_moment_max=router_m,
         flash_launches=launches, held_before_gb=held_gb,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    step.release()
    del state, model, step
    torch.cuda.empty_cache()
    return out


def _family_model(arch, dev):
    """``(cfg, model, params)``: ``arch``'s full config built on the card,
    weights seeded SEED."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config(arch)
    model = api.build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    return cfg, model, params


def _served(dev, model, params, batch, gen, label, want_launches):
    """One ``generate`` of ``batch`` for ``gen`` tokens with the flash
    count set to 0 just before and read just after: its times, launches
    and first tokens, after the launches, the non-finite stops and the
    tokens' range are checked."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import serve
    n_b, s = batch["tokens"].shape
    extra = batch["patches"].shape[1] if "patches" in batch else 0
    fa_kernel.launches = 0
    toks, stats = serve.generate(model, params, batch,
                                 max_context=extra + s + gen, n_steps=gen,
                                 device=dev)
    n = fa_kernel.launches
    check(n == want_launches, f"{label}: one prefill launched "
                              f"flash_attention {n} times, want "
                              f"{want_launches}")
    check(stats["graphed"] or gen < 2,
          f"{label}: the decode step was not replayed from a graph")
    check(stats["nonfinite_stops"] == 0,
          f"{label}: {stats['nonfinite_stops']} sequences went non-finite")
    check(tuple(toks.shape) == (n_b, gen)
          and bool(((toks >= 0) & (toks < model.cfg.vocab)).all()),
          f"{label}: tokens {tuple(toks.shape)} out of range")
    wall = stats["prefill_s"] + stats["decode_s_per_tok"] * (gen - 1)
    return {"batch": n_b, "prompt_len": s, "patches": extra,
            "generated": gen, "prefill_ms": stats["prefill_s"] * 1e3,
            "decode_ms_per_token": stats["decode_s_per_tok"] * 1e3,
            "generated_tokens_per_s": n_b * gen / wall,
            "prefill_tokens_per_s": n_b * (extra + s) / stats["prefill_s"],
            "flash_launches_per_prefill": n,
            "first_tokens": toks[0, :8].tolist()}


def _device_batch(dev, batch):
    import torch
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _upcast(model, params):
    """``(model32, params32)``: the model's functions in float32 over its
    (bf16) weights cast exactly to float32, the function a bf16 run
    rounds."""
    from repro_torch.models import api, common
    m32 = api.build_model(dataclasses.replace(model.cfg, dtype="float32"),
                          device=model.device)
    flat = common.ParamTree(params).state_dict()
    return m32, m32.nest({k: v.float() for k, v in flat.items()})


def _as_f32(batch):
    return {k: v.float() if v.is_floating_point() else v
            for k, v in batch.items()}


def _bf16_gate(label, got, want, exact):
    """The families' bf16 gate: ``got`` (the kernel's or the decode's
    values) no farther from ``exact``, the same function in float32 over
    the same weights cast exactly, than TOL_BF16_RATIO x ``want``'s (the
    plain or the teacher-forced side's) distance, each a share of max
    |exact|. ``vs_plain``, |got - want| over max |want|, is printed and
    not gated. The gate, checked."""
    exact = exact.float()
    scale = exact.abs().max().item()
    e_got = (got.float() - exact).abs().max().item() / scale
    e_want = (want.float() - exact).abs().max().item() / scale
    g = {"got_rel": e_got, "want_rel": e_want,
         "ratio": e_got / e_want if e_want else None,
         "vs_plain": (got.float() - want.float()).abs().max().item()
         / want.float().abs().max().item(),
         "tolerance": f"got_rel <= {TOL_BF16_RATIO} * want_rel",
         "ok": e_got <= TOL_BF16_RATIO * e_want}
    check(g["ok"], f"{label}: {g}")
    return g


def _f32_gate(label, got, want):
    g = _logit_gate(label, got, want, TOL_LM_F32)
    check(g["ok"], f"{label}: {g}")
    return g


def _decode_gates(model, params, exact, batch, label, steps=1):
    """Decode ``steps`` greedy tokens after the prefill of ``batch`` in
    bf16 and, on the same tokens, in ``exact`` (the model's ``_upcast``),
    each step's logits held against a teacher-forced prefill of the prompt
    and the tokens so far: float32 at TOL_LM_F32 x max |logit|, bf16 by
    ``_bf16_gate`` against the float32 teacher-forced prefill. The gates,
    checked: ``{"bf16": ..., "f32": ...}``, a list of ``steps`` each where
    ``steps`` > 1."""
    import torch
    m32, p32 = exact
    b = _device_batch(model.device, batch)
    extra = b["patches"].shape[1] if "patches" in b else 0
    mc = extra + b["tokens"].shape[1] + steps
    logits, cache = model.prefill(params, b, mc)
    _, c32 = m32.prefill(p32, _as_f32(b), mc)
    gates = {"bf16": [], "f32": []}
    for i in range(steps):
        nxt = logits.reshape(logits.shape[0], -1).float().argmax(-1)[
            :, None].int()
        b["tokens"] = torch.cat([b["tokens"], nxt.to(b["tokens"].dtype)], 1)
        logits, cache = model.decode_step(params, cache, nxt)
        l32, c32 = m32.decode_step(p32, c32, nxt)
        full = model.prefill(params, b, mc)[0]
        full32 = m32.prefill(p32, _as_f32(b), mc)[0]
        what = f"{label} decode step {i} vs teacher-forced prefill"
        gates["f32"].append(_f32_gate(f"{what}, float32", l32[:, 0],
                                      full32))
        gates["bf16"].append(_bf16_gate(f"{what}, bf16", logits[:, 0], full,
                                        full32))
        del full, full32
    return gates if steps > 1 else {k: v[0] for k, v in gates.items()}


def _impl_gates(model, params, exact, batch, label):
    """The kernel prefill (the encoder's encode) against ``impl="ref"`` on
    the same inputs, in bf16 and in ``exact`` (the model's ``_upcast``, on
    the inputs cast exactly): float32 at TOL_LM_F32 x max |value|, bf16 by
    ``_bf16_gate`` against the float32 plain prefill. The gates, checked:
    ``{"bf16": ..., "f32": ...}``."""
    m32, p32 = exact
    b = _device_batch(model.device, batch)
    extra = b["patches"].shape[1] if "patches" in b else 0
    mc = extra + b["tokens"].shape[1] + 1 if "tokens" in b else 0

    def run(m, p, inputs, impl):
        out = m.prefill(p, inputs, mc, impl=impl)
        return out[0] if isinstance(out, tuple) else out

    want32 = run(m32, p32, _as_f32(b), "ref")
    g32 = _f32_gate(f"{label} kernel vs plain, float32",
                    run(m32, p32, _as_f32(b), "kernel"), want32)
    return {"bf16": _bf16_gate(f"{label} kernel vs plain, bf16",
                               run(model, params, b, "kernel"),
                               run(model, params, b, "ref"), want32),
            "f32": g32}


def _train_steps(model, stream, steps, label, want_launches, donate=False):
    """``steps`` steps of ``make_train_step`` (AdamW in place on the state
    with ``donate``) from a state seeded SEED on ``stream``'s batches, with
    the flash count set to 0 just before and read just after
    (``want_launches`` a step); finite losses checked. Returns (final
    state, per-step metrics, timings, launches)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    state = train.init_state(model, seed=SEED)
    timings = []
    step = train.make_train_step(
        model, adamw.AdamWConfig(lr=LM_TRAIN_LR, total_steps=steps,
                                 warmup_steps=5), donate=donate)
    metrics = []
    fa_kernel.launches = 0
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, stream.batch_at(i))
        torch.cuda.synchronize()
        timings.append({"step_ms": (time.perf_counter() - t0) * 1e3,
                        "graph": "eager"})
        metrics.append({k: v.item() for k, v in m.items()})
    launches = fa_kernel.launches
    check(launches == want_launches * steps,
          f"{label} training: {launches} flash launches in {steps} steps, "
          f"want {want_launches} a step")
    check(all(np.isfinite(m["loss"]) for m in metrics),
          f"{label} training: losses {[m['loss'] for m in metrics]}")
    return state, metrics, timings, launches


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_mamba2(dev):
    """Mamba2-2.7B at full width and depth (64 layers, bf16, seeded): no
    kernel of the port runs (the SSD scan is plain PyTorch, as the
    reference's is XLA), so the flash count must stay 0. ``generate`` of
    MAMBA2_BATCH x MAMBA2_PROMPT tokens for MAMBA2_GEN after one warm-up,
    and of one MAMBA2_ODD_PROMPT-token prompt (not a multiple of the
    256-token chunk); for both and for a 2-token prompt (shorter than the
    conv window, which the reference's cache cannot decode; 4 steps), the
    decode steps against the teacher-forced prefill in bf16
    (``_bf16_gate``) and on the weights cast to float32 (TOL_LM_F32,
    ``_decode_gates``); then MAMBA2_TRAIN_STEPS
    ``make_train_step`` steps of 2 x 512 tokens of ``TokenStream(seed 0)``
    (no checkpoint): finite losses and AdamW's first moments of every
    layer's ``A_log``, ``dt_bias`` and ``D_skip`` nonzero."""
    import torch
    from repro_torch.launch import serve, train
    from repro_torch.models import api
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = _family_model(MAMBA2_ARCH, dev)
    weights_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (MAMBA2_BATCH, MAMBA2_PROMPT))}
    odd = {"tokens": rng.integers(0, cfg.vocab, (1, MAMBA2_ODD_PROMPT))}
    short = {"tokens": rng.integers(0, cfg.vocab, (MAMBA2_BATCH, 2))}
    serve.generate(model, params, batch, max_context=MAMBA2_PROMPT + 2,
                   n_steps=2, device=dev)              # warm-up
    runs = {"batch": _served(dev, model, params, batch, MAMBA2_GEN,
                             "mamba2 batch", 0),
            "odd": _served(dev, model, params, odd, MAMBA2_ODD_GEN,
                           "mamba2 odd prompt", 0)}
    prof = _profile_lm(model, params, batch, MAMBA2_PROMPT + MAMBA2_GEN, {
        "prefill_s": runs["batch"]["prefill_ms"] / 1e3,
        "decode_s_per_tok": runs["batch"]["decode_ms_per_token"] / 1e3})
    exact = _upcast(model, params)
    gates = {"decode_vs_prefill": _decode_gates(
                 model, params, exact, batch, "mamba2"),
             "odd_decode_vs_prefill": _decode_gates(
                 model, params, exact, odd, "mamba2 odd prompt"),
             "short_prompt_decode": _decode_gates(
                 model, params, exact, short, "mamba2 2-token prompt",
                 steps=4)}
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del params, model, exact
    _free()
    model = api.build_model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    stream = train.make_stream(cfg, MAMBA2_TRAIN_BATCH, LM_TRAIN_SEQ,
                               seed=SEED)
    state, metrics, timings, _ = _train_steps(model, stream,
                                              MAMBA2_TRAIN_STEPS, "mamba2", 0)
    moments = {key: min(state[1]["m"][f"layers.{i}.{key}"].abs().max().item()
                        for i in range(cfg.n_layers))
               for key in ("A_log", "dt_bias", "D_skip")}
    check(all(v > 0 for v in moments.values()),
          f"mamba2 training: a zero first moment {moments}")
    emit(phase="mamba2", config=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, weights_gb=weights_gb,
         serve_peak_mem_gb=serve_peak, runs=runs, profile=prof,
         flash_launches=0, **gates,
         train={"batch": MAMBA2_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
                "metrics": metrics, "step_ms": timings,
                "min_first_moment": moments,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9},
         seconds=time.perf_counter() - t0)
    del state
    _free()


def phase_rglru(dev):
    """RecurrentGemma-2B at full width and depth (26 layers: 8 (rec, rec,
    attn) groups and 2 tail layers; bf16, seeded): ``generate`` of
    RGLRU_BATCH x RGLRU_PROMPT tokens for RGLRU_GEN after one warm-up,
    and of one RGLRU_LONG_PROMPT-token prompt for RGLRU_LONG_GEN, past the
    2,048-token local window (the kernel's window and the rolling cache on
    the path), each with the flash count set to 0 just before and read
    just after: one launch a group a prefill (D 256, MQA 10/1). Gates, for
    both requests, in bf16 (``_bf16_gate``) and on the weights cast to
    float32 (TOL_LM_F32): the kernel prefill against ``impl="ref"``
    (``_impl_gates``; the long one masks keys by the window) and the first
    decode step against the teacher-forced prefill (``_decode_gates``).
    Then RGLRU_TRAIN_STEPS steps of 2 x 512 tokens: finite losses, 2 launches a
    group a step under remat ``full``. Returns the launches a prefill and
    a training step."""
    import torch
    from repro_torch.launch import serve, train
    from repro_torch.models import api
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = _family_model(RGLRU_ARCH, dev)
    n_groups = cfg.n_layers // 3
    weights_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (RGLRU_BATCH, RGLRU_PROMPT))}
    long = {"tokens": rng.integers(0, cfg.vocab, (1, RGLRU_LONG_PROMPT))}
    serve.generate(model, params, batch, max_context=RGLRU_PROMPT + 2,
                   n_steps=2, device=dev)              # warm-up
    runs = {"batch": _served(dev, model, params, batch, RGLRU_GEN,
                             "rglru batch", n_groups),
            "long": _served(dev, model, params, long, RGLRU_LONG_GEN,
                            "rglru long prompt", n_groups)}
    prof = _profile_lm(model, params, batch, RGLRU_PROMPT + RGLRU_GEN, {
        "prefill_s": runs["batch"]["prefill_ms"] / 1e3,
        "decode_s_per_tok": runs["batch"]["decode_ms_per_token"] / 1e3})
    exact = _upcast(model, params)
    gates = {"prefill": _impl_gates(model, params, exact, batch, "rglru"),
             "long_prefill": _impl_gates(model, params, exact, long,
                                         "rglru long prompt"),
             "decode_vs_prefill": _decode_gates(model, params, exact, batch,
                                                "rglru"),
             "long_decode_vs_prefill": _decode_gates(
                 model, params, exact, long, "rglru long prompt")}
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del params, model, exact
    _free()
    model = api.build_model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    stream = train.make_stream(cfg, RGLRU_TRAIN_BATCH, LM_TRAIN_SEQ,
                               seed=SEED)
    state, metrics, timings, launches = _train_steps(
        model, stream, RGLRU_TRAIN_STEPS, "rglru", 2 * n_groups)
    emit(phase="rglru", config=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, groups=n_groups, weights_gb=weights_gb,
         serve_peak_mem_gb=serve_peak, runs=runs, profile=prof, **gates,
         train={"batch": RGLRU_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
                "metrics": metrics, "step_ms": timings,
                "flash_launches": launches,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9},
         seconds=time.perf_counter() - t0)
    del state
    _free()
    return {"prefill": n_groups, "train_step": launches // RGLRU_TRAIN_STEPS}


def phase_hubert(dev):
    """HuBERT-XLarge at full width and depth (48 layers, bf16, seeded):
    ``encode`` of HUBERT_BATCH x HUBERT_SEQ bf16 frames once to warm up,
    then timed with the flash count set to 0 just before and read just
    after (one non-causal launch a layer, D 80); the kernel encode against
    ``impl="ref"`` (``_bf16_gate`` over max |h|) and, on the weights and
    frames cast to float32, TOL_LM_F32 (``_impl_gates``). Then
    HUBERT_TRAIN_STEPS
    ``masked_prediction_loss`` steps of 2 x HUBERT_SEQ frames of
    ``FrameStream(seed 0)``, whose float32 frames compute in float32 (the
    kernel's float32 route), as the reference's type promotion does:
    finite losses, 2 launches a layer a step. Returns the launches an
    encode and a training step."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import train
    from repro_torch.models import api, encoder
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = _family_model(HUBERT_ARCH, dev)
    weights_gb = torch.cuda.memory_allocated() / 1e9
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f16 = torch.randn((HUBERT_BATCH, HUBERT_SEQ, cfg.frontend_dim),
                      generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        encoder.encode(params, f16, cfg)               # warm-up
        torch.cuda.synchronize()
        fa_kernel.launches = 0
        t1 = time.perf_counter()
        h = encoder.encode(params, f16, cfg)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t1) * 1e3
    launches = fa_kernel.launches
    check(launches == cfg.n_layers, f"hubert: one encode launched "
                                    f"flash_attention {launches} times, "
                                    f"want {cfg.n_layers}")
    check(tuple(h.shape) == (HUBERT_BATCH, HUBERT_SEQ, cfg.d_model)
          and h.dtype == torch.bfloat16 and bool(h.isfinite().all()),
          f"hubert encode: {tuple(h.shape)} {h.dtype}")
    del h
    exact = _upcast(model, params)
    gates = {"encode": _impl_gates(model, params, exact, {"frames": f16},
                                   "hubert")}
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del params, model, exact, f16
    _free()
    model = api.build_model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    stream = train.make_stream(cfg, HUBERT_TRAIN_BATCH, HUBERT_SEQ,
                               seed=SEED)
    state, metrics, timings, train_launches = _train_steps(
        model, stream, HUBERT_TRAIN_STEPS, "hubert", 2 * cfg.n_layers)
    emit(phase="hubert", config=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, weights_gb=weights_gb, batch=HUBERT_BATCH,
         seq=HUBERT_SEQ, encode_ms=encode_ms,
         encode_frames_per_s=HUBERT_BATCH * HUBERT_SEQ / encode_ms * 1e3,
         flash_launches_per_encode=launches, serve_peak_mem_gb=serve_peak,
         **gates,
         train={"batch": HUBERT_TRAIN_BATCH, "seq": HUBERT_SEQ,
                "frames_dtype": "float32", "metrics": metrics,
                "step_ms": timings, "flash_launches": train_launches,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9},
         seconds=time.perf_counter() - t0)
    del state
    _free()
    return {"encode": launches,
            "train_step": train_launches // HUBERT_TRAIN_STEPS}


def phase_llava(dev):
    """LLaVA-NeXT (Mistral-7B) at full width and depth (32 layers, bf16,
    seeded): ``generate`` of LLAVA_BATCH x (n_patches bf16 patch
    embeddings + LLAVA_PROMPT tokens) for LLAVA_GEN after one warm-up,
    with the flash count set to 0 just before and read just after (one
    launch a layer a prefill over 3,392 positions, D 128, GQA 32/8); the
    kernel prefill against ``impl="ref"`` (``_impl_gates``) and the first
    decode step against the teacher-forced prefill (``_decode_gates``), in
    bf16 (``_bf16_gate``) and on the weights cast to float32
    (TOL_LM_F32). Then, at
    LLAVA_TRAIN_LAYERS of its 32 layers at full width, LLAVA_TRAIN_STEPS
    steps of 1 x (n_patches + 512) from the VLM stream, whose float32
    patches compute in float32 as the reference's do: finite losses, 2
    launches a layer a step. Returns the launches a prefill and a step."""
    import torch
    from repro_torch.launch import serve, train
    from repro_torch.models import api
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = _family_model(LLAVA_ARCH, dev)
    weights_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (LLAVA_BATCH, LLAVA_PROMPT)),
             "patches": torch.randn(
                 (LLAVA_BATCH, cfg.n_patches, cfg.vision_dim),
                 generator=gen, device=dev).to(torch.bfloat16)}
    serve.generate(model, params, batch,
                   max_context=cfg.n_patches + LLAVA_PROMPT + 2, n_steps=2,
                   device=dev)                          # warm-up
    runs = {"batch": _served(dev, model, params, batch, LLAVA_GEN,
                             "llava", cfg.n_layers)}
    prof = _profile_lm(model, params, batch,
                       cfg.n_patches + LLAVA_PROMPT + LLAVA_GEN, {
                           "prefill_s": runs["batch"]["prefill_ms"] / 1e3,
                           "decode_s_per_tok":
                               runs["batch"]["decode_ms_per_token"] / 1e3})
    exact = _upcast(model, params)
    gates = {"prefill": _impl_gates(model, params, exact, batch, "llava"),
             "decode_vs_prefill": _decode_gates(model, params, exact, batch,
                                                "llava")}
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del params, model, batch, exact
    _free()
    tcfg = dataclasses.replace(cfg, n_layers=LLAVA_TRAIN_LAYERS)
    model = api.build_model(tcfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    stream = train.make_stream(tcfg, LLAVA_TRAIN_BATCH, LLAVA_PROMPT,
                               seed=SEED)
    state, metrics, timings, launches = _train_steps(
        model, stream, LLAVA_TRAIN_STEPS, "llava", 2 * tcfg.n_layers)
    emit(phase="llava", config=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, weights_gb=weights_gb,
         serve_peak_mem_gb=serve_peak, runs=runs, profile=prof, **gates,
         train={"layers": tcfg.n_layers,
                "reduced": {"n_layers": [cfg.n_layers, tcfg.n_layers]},
                "batch": LLAVA_TRAIN_BATCH,
                "positions": cfg.n_patches + LLAVA_PROMPT - 1,
                "patches_dtype": "float32", "metrics": metrics,
                "step_ms": timings, "flash_launches": launches,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9},
         seconds=time.perf_counter() - t0)
    del state, model
    _free()
    return {"prefill": cfg.n_layers,
            "train_step": launches // LLAVA_TRAIN_STEPS}


def _lmc_serve(dev, full, layers, gate_layers):
    """A dense config of phase ``lm_configs`` served: ``full`` at its
    published width and ``layers`` deep (bf16, seeded), ``generate`` of
    LMC_BATCH x LMC_PROMPT tokens for LMC_GEN after one warm-up, one
    kernel-5 launch a layer a prefill, the decode step replayed from a
    graph (``_served``); then the kernel prefill against ``impl="ref"``
    and the first decode step against the teacher-forced prefill, each in
    float32 (the weights cast exactly) and by the bf16 ratio gate
    (``_impl_gates``, ``_decode_gates``), on the served model or, with
    ``gate_layers``, on a second one that deep. Returns the record."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import api
    cfg = dataclasses.replace(full, n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = api.build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    weights_gb = torch.cuda.memory_allocated() / 1e9
    batch = {"tokens": np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LMC_BATCH, LMC_PROMPT))}
    serve.generate(model, params, batch, max_context=LMC_PROMPT + 2,
                   n_steps=2, device=dev)              # warm-up
    run = _served(dev, model, params, batch, LMC_GEN, cfg.name, layers)
    serve_peak = torch.cuda.max_memory_allocated()
    if gate_layers is not None:
        del params, model
        _free()
        model = api.build_model(
            dataclasses.replace(full, n_layers=gate_layers), device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.reset_peak_memory_stats()
    exact = _upcast(model, params)
    gates = {"prefill": _impl_gates(model, params, exact, batch, cfg.name),
             "decode_vs_prefill": _decode_gates(model, params, exact, batch,
                                                cfg.name)}
    gates_peak = torch.cuda.max_memory_allocated()
    del params, model, exact
    _free()
    for what, peak in (("serving", serve_peak), ("the gates", gates_peak)):
        check(peak < LMC_PEAK_BYTES, f"{cfg.name} {what}: peak "
                                     f"{peak / 1e9:.2f} GB")
    return {"layers": layers, "weights_gb": weights_gb,
            "peak_mem_gb": serve_peak / 1e9, "run": run,
            "gate_layers": layers if gate_layers is None else gate_layers,
            "gates_peak_mem_gb": gates_peak / 1e9, **gates}


def phase_lm_configs(dev):
    """The four LM configs that no other phase runs, at their published
    widths (bf16, seeded, built through ``api.build_model``), each served
    and trained in turn (LMC_RUNS; depth cut only where 80 GB forces it,
    every cut under ``reduced``): Qwen3-1.7B (qk-norm, tied embeddings,
    GQA 16/8), Yi-9B (GQA 32/4), DeepSeek-67B (GQA 64/8), all D 128, by
    ``_lmc_serve``; Mixtral-8x22B (48/8, 8 experts top-2, a 4,096-token
    window) by ``_moe_serve``'s MoE gates (routing flips counted, the plain
    routing pinned where they break the gate, decode at the drop-free
    capacity). Then LMC_TRAIN_STEPS donated ``make_train_step`` steps of
    LMC_TRAIN_BATCH x 512 tokens (no checkpoint): finite losses, 2 kernel-5
    launches a layer a step. Every peak under 80 GB. Returns each config's
    launches a prefill and a training step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import api
    t_phase = time.perf_counter()
    launches = {}
    for arch, layers, train_layers, gate_layers in LMC_RUNS:
        t0 = time.perf_counter()
        full = get_config(arch)
        reduced = {}
        if layers < full.n_layers:
            reduced["serve_layers"] = [full.n_layers, layers]
        if full.n_experts:
            _, serving = _moe_serve(dev, arch, layers, LMC_GEN, long=False,
                                    profile=False)
            for key in ("peak_mem_gb", "gates_peak_mem_gb"):
                check(serving[key] * 1e9 < LMC_PEAK_BYTES,
                      f"{arch} serving: {key} {serving[key]}")
        else:
            serving = _lmc_serve(dev, full, layers, gate_layers)
            if gate_layers is not None:
                reduced["gate_layers"] = [full.n_layers, gate_layers]
        if train_layers < full.n_layers:
            reduced["train_layers"] = [full.n_layers, train_layers]
        tcfg = dataclasses.replace(full, n_layers=train_layers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = api.build_model(tcfg, device=dev)
        stream = train.make_stream(tcfg, LMC_TRAIN_BATCH, LM_TRAIN_SEQ,
                                   seed=SEED)
        state, metrics, timings, n_train = _train_steps(
            model, stream, LMC_TRAIN_STEPS, arch, 2 * train_layers,
            donate=True)
        train_peak = torch.cuda.max_memory_allocated()
        del state, model
        _free()
        check(train_peak < LMC_PEAK_BYTES,
              f"{arch} training: peak {train_peak / 1e9:.2f} GB")
        launches[arch] = {"prefill": layers,
                          "train_step": n_train // LMC_TRAIN_STEPS}
        emit(phase="lm_configs.config", config=arch, dtype=full.dtype,
             published_layers=full.n_layers, reduced=reduced,
             serve=serving,
             train={"layers": train_layers, "batch": LMC_TRAIN_BATCH,
                    "seq": LM_TRAIN_SEQ, "donate": True, "metrics": metrics,
                    "step_ms": timings, "flash_launches": n_train,
                    "peak_mem_gb": train_peak / 1e9},
             seconds=time.perf_counter() - t0)
    emit(phase="lm_configs", configs=[r[0] for r in LMC_RUNS],
         flash_launches=launches, seconds=time.perf_counter() - t_phase)
    return launches


def _moe_ragged_example():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "moe_ragged_torch", ROOT / "examples" / "moe_ragged_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def w_gate_inputs(dev):
    """The router input, router weights and expert weights of one
    Mixtral-8x7B ``w_gate`` product (MOE_RAGGED), seeded, drawn on the
    card."""
    import torch
    t, d, f, e, _, _ = MOE_RAGGED
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((t, d), generator=gen, device=dev)
    w_router = torch.randn((d, e), generator=gen, device=dev) * d ** -0.5
    w_in = torch.randn((e, d, f), generator=gen, device=dev) * d ** -0.5
    return x, w_router, w_in


def phase_moe_ragged(dev):
    """Kernel 3 on the router's rulebook (``examples/moe_ragged_torch.py``)
    at the example's sizes (its numpy draws) and at one Mixtral-8x7B
    ``w_gate`` product (MOE_RAGGED; inputs drawn on the card): the kernel
    launched once a product (the count set to 0 just before, read just
    after), its valid rows against the dense per-expert loop and its
    output against its plain version (TOL_KERNEL x max abs), timed against
    its bytes and operations bound as phase ``spconv_gemm`` times it."""
    import torch
    from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
    from repro_torch.kernels.spconv_gemm.ref import spconv_gemm_ref
    ex = _moe_ragged_example()
    per_shape, launches = {}, 0
    example = (ex.T, ex.D, ex.F, ex.E, ex.K, ex.BM)
    for name, (t, d, f, e, k, bm) in (("example", example),
                                      ("mixtral_w_gate", MOE_RAGGED)):
        if name == "example":
            x, w_router, w_in = ex.make_inputs(t, d, f, e, device=dev)
        else:
            x, w_router, w_in = w_gate_inputs(dev)
        sg_kernel.materialized_launches = 0
        res = ex.run(x, w_router, w_in, k=k, bm=bm)
        torch.cuda.synchronize()
        n = sg_kernel.materialized_launches
        launches += n
        check(n == 1, f"moe_ragged {name}: {n} kernel-3 launches, want 1")
        tiles = res["tiles"]
        lhs = x[tiles.gather_idx.long()]
        lhs.masked_fill_(~tiles.slot_valid[:, None], 0.0)
        args = (lhs, w_in, tiles.tile_tap, tiles.tile_nz)
        plain = spconv_gemm_ref(*args, bm=bm)
        err = (res["h"] - plain).abs().max().item()
        ref_max = plain.abs().max().item()
        check(err <= TOL_KERNEL * ref_max,
              f"moe_ragged {name}: kernel vs plain {err} > {TOL_KERNEL} * "
              f"{ref_max}")
        dense_err = (res["got"] - res["want"]).abs().max().item()
        dense_max = res["want"].abs().max().item()
        check(dense_err <= TOL_KERNEL * dense_max,
              f"moe_ragged {name}: kernel vs dense loop {dense_err} > "
              f"{TOL_KERNEL} * {dense_max}")
        n_tiles = tiles.n_tiles
        live = int(tiles.tile_nz.sum())
        m_pad = lhs.shape[0]
        nbytes = 4.0 * (live * bm * d + m_pad * f + e * d * f) + 8.0 * n_tiles
        rec = {"tokens": t, "d": d, "f": f, "experts": e, "top_k": k,
               "bm": bm, "m_pad": m_pad, "tiles": n_tiles,
               "live_tiles": live,
               "valid_slots": int(tiles.slot_valid.sum()),
               "max_abs_err": err, "ref_max": ref_max,
               "dense_loop_err": dense_err,
               **_bound(2.0 * live * bm * d * f, nbytes),
               "ms": time_ms(lambda: sg_kernel.spconv_gemm(*args, bm=bm), 5),
               "plain_ms": time_ms(lambda: spconv_gemm_ref(*args, bm=bm), 2)}
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        if name == "mixtral_w_gate":
            # the 3xTF32 kernel against one cuBLAS SGEMM a tap
            check(rec["ms"] < rec["plain_ms"],
                  f"moe_ragged {name}: kernel {rec['ms']} ms is not faster "
                  f"than its plain version {rec['plain_ms']} ms")
        per_shape[name] = rec
        emit(phase="moe_ragged", name=name,
             tolerance=f"{TOL_KERNEL} * max|plain|", **rec)
        del x, w_router, w_in, res, lhs, args, plain
        torch.cuda.empty_cache()
    return per_shape, launches


def _seed_bn(model, gen):
    """Seeded batch-norm scales, biases and running statistics."""
    import torch
    from repro_torch.models import minkunet
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, minkunet.BatchNorm):
                c = mod.scale.shape[0]
                for t, lo, hi in ((mod.scale, 0.5, 1.5), (mod.bias, -0.2, 0.2),
                                  (mod.mean, -0.2, 0.2), (mod.var, 0.5, 2.0)):
                    t.copy_(torch.empty(c).uniform_(lo, hi, generator=gen))
    return model


def _seeded_model(cfg, dev):
    """MinkUNet with seeded random weights and batch-norm statistics."""
    import torch
    from repro_torch.models import minkunet
    gen = torch.Generator().manual_seed(SEED)
    return _seed_bn(minkunet.MinkUNet(cfg, device=dev, generator=gen), gen)


def _counts():
    from repro_torch.core import plan as planlib
    from repro_torch.kernels.octent import kernel as oct_kernel
    from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
    return (oct_kernel.launches, sg_kernel.launches,
            sg_kernel.epilogue_launches, planlib.MAPSEARCH_CALLS[0],
            sg_kernel.reduce_launches, sg_kernel.plan_launches,
            oct_kernel.row_launches)


def _reset_counts():
    from repro_torch.core import plan as planlib
    from repro_torch.kernels.octent import kernel as oct_kernel
    from repro_torch.kernels.segment_sum import kernel as ss_kernel
    from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
    oct_kernel.launches = oct_kernel.row_launches = 0
    ss_kernel.launches = 0
    sg_kernel.launches = sg_kernel.epilogue_launches = 0
    sg_kernel.reduce_launches = sg_kernel.plan_launches = 0
    planlib.MAPSEARCH_CALLS[0] = 0


def _n_layers(cfg) -> int:
    """Kernel-2 layers of one MinkUNet forward."""
    return 1 + len(cfg.enc) + len(cfg.dec) \
        + cfg.blocks * (len(cfg.enc) + len(cfg.dec))


def phase_serve(dev, cfg, scenes, warm):
    """The main path: ServeEngine over MinkUNet-large, one request per
    tick, then one request with the fused epilogue. Returns the launch
    counts of the whole run and the results."""
    import torch
    from repro_torch.launch.spconv_serve import ServeEngine
    from repro_torch.runtime import admission
    t_phase = time.perf_counter()
    model = _seeded_model(cfg, dev)
    fused = _seeded_model(dataclasses.replace(cfg, fused_epilogue=True), dev)
    fused.load_state_dict(model.state_dict())
    engines = [ServeEngine(m, queue=admission.AdmissionQueue(
        buckets=(BUCKET,)), max_batch=1) for m in (model, fused)]
    for eng in engines:                    # CUDA/cuBLAS init, not measured
        eng.submit("warmup", *warm)
        eng.step()
    n_layers = _n_layers(cfg)
    n_subm = 1 + cfg.blocks * (len(cfg.enc) + len(cfg.dec))
    want_per_req = (len(cfg.enc) + 1, n_layers, 2 * len(cfg.enc) + 1)
    _reset_counts()
    results = []
    for (rid, sc), eng in [(s, engines[0]) for s in scenes] + \
            [(("fused-" + scenes[0][0], scenes[0][1]), engines[1])]:
        before = _counts()
        eng.submit(rid, sc.coords, sc.batch, sc.valid, sc.feats)
        (res,) = eng.step()
        after = _counts()
        d = [a - b for a, b in zip(after, before)]
        check(res.status == "completed", f"{rid}: {res.status} {res.reason}")
        check(bool(np.isfinite(res.logits).all()), f"{rid}: non-finite logit")
        check((d[0], d[1], d[3]) == want_per_req,
              f"{rid}: (octent, gemm, searches) = {(d[0], d[1], d[3])}, "
              f"want {want_per_req}")
        check(d[2] == (n_subm if eng is engines[1] else 0),
              f"{rid}: {d[2]} epilogue launches")
        check(d[5] == n_layers, f"{rid}: {d[5]} planning launches")
        results.append((rid, sc, res, d[4]))
    # the first scene again, in fresh buffers: the engine's long-lived
    # cache hits by content, so no search and no kernel-1 launch
    rid, sc = scenes[0]
    before = _counts()
    engines[0].submit(rid + "-again", sc.coords.copy(), sc.batch.copy(),
                      sc.valid.copy(), sc.feats.copy())
    (again,) = engines[0].step()
    d = [a - b for a, b in zip(_counts(), before)]
    check(again.status == "completed" and (d[0], d[1], d[3]) ==
          (0, n_layers, 0), f"{rid} re-submitted: (octent, gemm, searches)"
          f" = {(d[0], d[1], d[3])}, want (0, {n_layers}, 0)")
    check(again.digest == results[0][2].digest,
          f"{rid} re-submitted: logits differ from the first serving")
    counts = _counts()
    # one executable a bucket class: serve_replay's compiled gate
    for name, eng in zip(("unfused", "fused"), engines):
        check(eng.compiled == 1 and eng.stats()["compiled"] == 1,
              f"serve {name}: {eng.compiled} executables for one bucket")
    graphs = _serve_graphs(dev, engines, results, scenes)
    lat = [r.latency_s for _, _, r, _ in results[:len(scenes)]]
    vox = sum(int(sc.valid.sum()) for _, sc, _, _ in results[:len(scenes)])
    emit(phase="serve", config=cfg.name, bucket=BUCKET,
         requests=[{"rid": rid, "voxels": int(sc.valid.sum()),
                    "latency_ms": r.latency_s * 1e3, "digest": r.digest,
                    "split_reduce_launches": n_red}
                   for rid, sc, r, n_red in results],
         resubmitted={"rid": rid + "-again",
                      "latency_ms": again.latency_s * 1e3,
                      "octent_launches": d[0], "searches": d[3],
                      "cache": engines[0].cache.stats()},
         latency_p50_ms=float(np.percentile(lat, 50)) * 1e3,
         voxels_per_s=vox / sum(lat),
         launches_per_request={"octent_query": want_per_req[0],
                               "spconv_gemm_fused": want_per_req[1],
                               "mapsearch": want_per_req[2]},
         compiled=[eng.compiled for eng in engines], graphs=graphs,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds=time.perf_counter() - t_phase)
    return model, [r[:3] for r in results], counts


def _served_request(dev, sc):
    """The request's tensors as the engine serves them: the queue's
    quantization of the scene into BUCKET, on the card."""
    import torch
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.runtime import admission
    arrays = admission.quantize_to_bucket(sc.coords, sc.batch, sc.valid,
                                          sc.feats, BUCKET)[:4]
    return SparseTensor(*(torch.as_tensor(a, device=dev) for a in arrays))


def _serve_graphs(dev, engines, results, scenes):
    """The engines' CUDA graphs against eager forwards with the same
    kernels: each served request's logits bit-equal to an eager
    ``minkunet.forward`` of its tensors and its cached plans; one tick of
    two scenes (``max_batch`` 2, both replays before either copy-out) each
    equal to its solo digest; a request's forward ms eager against
    replayed (host clock with a sync, and device time); the memory the
    graphs hold (static buffers and private pools), freed at the end."""
    import gc
    import torch
    from repro_torch.models import minkunet
    for rid, sc, res, _ in results:
        eng = engines[1] if rid.startswith("fused-") else engines[0]
        st = _served_request(dev, sc)
        plans = minkunet.build_plans(st.coords, st.batch, st.valid, eng.cfg,
                                     cache=eng.cache, n_max=BUCKET,
                                     device=dev)
        want = minkunet.forward(eng.model, st, plans=plans).cpu().numpy()
        check(np.array_equal(res.logits, want),
              f"{rid}: replayed logits differ from the eager forward, max "
              f"{float(np.abs(res.logits - want).max())}")
    eng = engines[0]
    solo = {rid: res.digest for rid, _, res, _ in results}
    eng.max_batch = 2
    for rid, sc in scenes[:2]:
        eng.submit(rid + "-pair", *(np.array(a) for a in (
            sc.coords, sc.batch, sc.valid, sc.feats)))
    pair = eng.step()
    eng.max_batch = 1
    check([r.rid for r in pair] == [rid + "-pair" for rid, _ in scenes[:2]]
          and all(r.status == "completed" and
                  r.digest == solo[r.rid[:-len("-pair")]] for r in pair),
          f"a tick of two scenes: {[(r.rid, r.status) for r in pair]} "
          f"differ from their solo digests")
    check(eng.compiled == 1, f"serve: {eng.compiled} executables after the "
                             f"batched tick")
    st = _served_request(dev, scenes[0][1])
    plans = minkunet.build_plans(st.coords, st.batch, st.valid, eng.cfg,
                                 cache=eng.cache, n_max=BUCKET, device=dev)

    def eager():
        return minkunet.forward(eng.model, st, plans=plans)

    def replayed():
        return eng._forward_fn(eng.model, st, plans)

    (entry,) = eng._exec.values()
    check(entry.graph is not None and entry.graph.launches, "serve: the "
          "entry holds no captured graph")
    per_replay = {f"{mod.__name__.split('.')[-2]}.{c}": n
                  for (mod, c), n in entry.graph.launches.items()}
    times = {"eager_wall_ms": wall_ms(eager, 5),
             "replayed_wall_ms": wall_ms(replayed, 5),
             "eager_device_ms": time_ms(eager, 5),
             "replayed_device_ms": time_ms(replayed, 5)}
    times["replayed_wall_ms_2"] = wall_ms(replayed, 5)
    times["eager_wall_ms_2"] = wall_ms(eager, 5)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    for e in engines:
        e._exec.clear()
    del entry
    gc.collect()
    torch.cuda.empty_cache()
    freed = (held[0] - torch.cuda.memory_allocated(),
             held[1] - torch.cuda.memory_reserved())
    return {"bit_equal_to_eager": len(results),
            "pair_tick": {r.rid: r.digest[:16] for r in pair},
            "launches_per_replay": per_replay, **times,
            "graphs_allocated_gb": freed[0] / 1e9,
            "graphs_reserved_gb": freed[1] / 1e9}


def phase_reference(dev, cfg, model, results):
    """Served logits against the same forward through the plain versions
    (search and gather-GEMM), and the fused-epilogue request against the
    unfused one."""
    import torch
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.models import minkunet
    errs = {}
    by_rid = {rid: res for rid, _, res in results}
    for rid, sc, res in results:
        if rid.startswith("fused-"):
            want = by_rid[rid[len("fused-"):]].logits
        else:
            st = SparseTensor(*(torch.as_tensor(a, device=dev) for a in (
                sc.coords, sc.batch, sc.valid, sc.feats)))
            plans = minkunet.build_plans(st.coords, st.batch, st.valid, cfg,
                                         n_max=BUCKET, search_impl="ref",
                                         device=dev)
            want = minkunet.forward(model, st, plans=plans,
                                    impl="ref").cpu().numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(res.logits - want).max())
        check(err <= TOL_LOGITS * scale,
              f"{rid}: max|served - plain| {err} > {TOL_LOGITS} * {scale}")
        errs[rid] = {"max_abs_err": err, "max_abs_logit": scale}
    emit(phase="reference", tolerance=f"{TOL_LOGITS} * max|logit|", **errs)


def _grad_check(gk, gr):
    """Worst kernel-vs-plain ratio over the gradient tensors: |gk - gr|
    over the tensor's own max |gr|, and for the tensors whose gradient is
    zero in exact arithmetic (conv biases, BatchNorm statistics) the larger
    side's max |g| over the model's largest |gr|."""
    gmax = max(float(g.abs().max()) for g in gr.values())
    worst, worst_zero = ("", -1.0), ("", -1.0)
    for k in gr:
        if k.endswith((".conv.b", ".mean", ".var")):
            r = max(float(gk[k].abs().max()), float(gr[k].abs().max())) / gmax
            worst_zero = max(worst_zero, (k, r), key=lambda t: t[1])
        else:
            scale = float(gr[k].abs().max())
            check(scale > 0, f"train: gradient of {k} is all zero")
            r = float((gk[k] - gr[k]).abs().max()) / scale
            worst = max(worst, (k, r), key=lambda t: t[1])
    return worst, worst_zero, gmax


def _train_gate(lk, gk, k_masks, sizes, plain, pinned):
    """The kernel step against a plain one: ``plain`` is ``(loss, grads,
    relu masks)`` of the plain step run free, ``pinned`` its grads with
    the ReLU masks pinned to the kernel run's (``k_masks``). Returns the
    readings and the limits they break."""
    lu, gu, u_masks = plain
    flips = [int((a != b).sum()) for a, b in zip(k_masks, u_masks)]
    loss_err = abs(float(lk) - float(lu)) / abs(float(lu))
    norm_name, norm = max(
        ((k, float((gk[k] - gu[k]).norm() / gu[k].norm())) for k in gu
         if not k.endswith((".conv.b", ".mean", ".var"))),
        key=lambda t: t[1])
    (uname, uratio), _, _ = _grad_check(gk, gu)
    (gname, gratio), (zname, zratio), gmax = _grad_check(gk, pinned)
    r = {"loss_kernel": float(lk), "loss_plain": float(lu),
         "loss_rel_err": loss_err, "relu_flips": flips,
         "worst_layer_flip_share": max(f / n for f, n in zip(flips, sizes)),
         "flip_share": sum(flips) / sum(sizes),
         "worst_norm_grad": norm_name, "worst_norm_ratio": norm,
         "unpinned_worst_grad": uname, "unpinned_worst_grad_ratio": uratio,
         "worst_grad": gname, "worst_grad_ratio": gratio,
         "worst_zero_grad": zname, "worst_zero_grad_ratio": zratio,
         "max_abs_grad": gmax}
    limits = {"loss_rel_err": TOL_TRAIN_LOSS,
              "worst_layer_flip_share": TOL_TRAIN_FLIPS[0],
              "flip_share": TOL_TRAIN_FLIPS[1],
              "worst_norm_ratio": TOL_TRAIN_NORM,
              "worst_grad_ratio": TOL_TRAIN_GRAD,
              "worst_zero_grad_ratio": TOL_TRAIN_ZERO}
    return r, [f"{k} {r[k]} > {lim}" for k, lim in limits.items()
               if not r[k] <= lim]


def _relu_hooks(masks, sizes=None):
    """``(sparse, dense)`` ReLUs that record each output's nonzero mask
    (and, with ``sizes``, the valid outputs of a sparse layer and all of a
    dense one) in call order."""
    from repro_torch.core import spconv
    from repro_torch.models import second
    sparse_relu, dense_relu = spconv.relu, second.rpn_relu

    def sparse(st):
        out = sparse_relu(st)
        masks.append(out.feats != 0)
        if sizes is not None:
            sizes.append(int(st.valid.sum()) * st.feats.shape[1])
        return out

    def dense(x):
        out = dense_relu(x)
        masks.append(out != 0)
        if sizes is not None:
            sizes.append(out.numel())
        return out

    return sparse, dense


@contextlib.contextmanager
def _relus(hooks):
    """Run with ``(sparse, dense)`` in place of ``spconv.relu`` and
    ``second.rpn_relu``."""
    from repro_torch.core import spconv
    from repro_torch.models import second
    saved = spconv.relu, second.rpn_relu
    spconv.relu, second.rpn_relu = hooks
    try:
        yield
    finally:
        spconv.relu, second.rpn_relu = saved


def _pinned_relus(masks):
    """``(sparse, dense)`` ReLUs that apply the recorded masks in order."""
    import torch
    it = iter(masks)
    return (lambda st: st.replace_feats(torch.where(next(it), st.feats,
                                                    0.0)),
            lambda x: torch.where(next(it), x, 0.0))


def _leaves(tree):
    from repro_torch.checkpoint import checkpoint
    return checkpoint.tree_leaves(tree)


def _train_resume(dev, cfg, want_digest):
    """Phase ``train``'s run again, SIGKILLed in its third checkpoint save
    (a ``FaultPlan`` in a subprocess, whose steps therefore run eagerly)
    and then resumed here from its newest verified checkpoint, step 1: the
    resumed run computes steps 2 and 3 on the card again (a warm-up, then
    a capture and replay) and must reach the first run's digest, with no
    determinism switch set. That run is the first run's clean witness
    (phase ``paper.replan`` holds two clean demo runs equal as well).
    Returns the record."""
    import os
    import shutil
    import tempfile
    from repro_torch.launch import train
    d = tempfile.mkdtemp(prefix="chip-smoke-resume-")
    try:
        # kill-site calls: each save's write, then each step; call 4 is
        # the save after step 2, between its temporary write and the rename
        code = (f"import sys\nsys.path.insert(0, {str(ROOT / 'src')!r})\n"
                "from repro_torch.launch.train import run_spconv_demo\n"
                "from repro_torch.models import minkunet\n"
                "from repro_torch.runtime import fault\n"
                f"run_spconv_demo({TRAIN_STEPS}, voxels={BUCKET}, "
                f"cfg=minkunet.{cfg!r}, seed={SEED}, scene='indoor', "
                f"ckpt_dir={d!r}, "
                f"total_steps={TRAIN_STEPS}, device='cuda', "
                "faults=fault.FaultPlan(schedule={fault.KILL_SITE: [4]}))\n")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True,
                              timeout=RESTART_TIMEOUT_S)
        killed_s = time.perf_counter() - t0
        check(proc.returncode == -9, f"train resume: the killed run "
              f"exited {proc.returncode}: {proc.stderr[-2000:]}")
        left = any(n.startswith(".tmp-") for n in os.listdir(d))
        t0 = time.perf_counter()
        rest = train.run_spconv_demo(TRAIN_STEPS, voxels=BUCKET, cfg=cfg,
                                     seed=SEED, scene="indoor",
                                     ckpt_dir=d, resume=True,
                                     total_steps=TRAIN_STEPS, device=dev)
        resumed_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rec = {"killed_run_s": killed_s, "resumed_run_s": resumed_s,
           "tmp_file_left": left,
           "resumed_from": rest["resumed_from"],
           "resumed_steps": [t["graph"] for t in rest["timings"]],
           "resumed_digest": rest["state_digest"],
           "resumed_equal": rest["state_digest"] == want_digest}
    check(rec["resumed_from"] == 1 and rec["resumed_equal"],
          f"train: the killed and resumed run's digest differs: {rec}")
    return rec


def phase_train(dev, cfg):
    """The training path: ``run_spconv_demo`` over MinkUNet-large on one
    indoor scene of the bucket (the kernels, a checkpoint after every
    step into a temporary directory), with the launch counts set to 0 just
    before and read just after; then one step's loss and gradients through
    the kernels against the plain versions on the same plans, weights and
    batch: the gradients with the plain run's ReLU masks pinned to the
    kernel run's, the loss, the ReLU outputs whose sign differs and the
    gradients' norms from the plain run left free (``_train_gate``); a
    control, the plain step in TF32, must break those limits; then the
    step eager, captured and replayed, each replay bit-equal to an eager
    step, and one step under ``torch.profiler``; then the plain versions'
    step (``impl="ref"``) captured and replayed the same way, bit-equal
    too (``train.plain_graph``). Returns the demo's launches of kernels
    1 and 2 and kernel 2's device ms a step."""
    import shutil
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import pointcloud
    from repro_torch.launch import train
    from repro_torch.models import minkunet
    from repro_torch.optim import adamw
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-train-")
    try:
        _reset_counts()
        t0 = time.perf_counter()
        res = train.run_spconv_demo(TRAIN_STEPS, voxels=BUCKET, cfg=cfg,
                                    impl=None, seed=SEED, scene="indoor",
                                    ckpt_dir=ckpt, device=dev)
        demo_s = time.perf_counter() - t0
        counts = _counts()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_layers = 1 + (1 + cfg.blocks) * (len(cfg.enc) + len(cfg.dec))
    check(len(res["losses"]) == TRAIN_STEPS
          and all(np.isfinite(res["losses"])),
          f"train: losses {res['losses']}")
    check(res["mapsearch_calls"] == res["searches_per_cloud"]
          == 2 * len(cfg.enc) + 1,
          f"train: {res['mapsearch_calls']} map searches over "
          f"{TRAIN_STEPS} steps")
    check(res["recoveries"] == 0 and res["skipped_batches"] == 0,
          f"train: {res['recoveries']} recoveries, "
          f"{res['skipped_batches']} skipped batches")
    check(counts[0] == len(cfg.enc) + 1 and counts[1] == TRAIN_STEPS
          * n_layers and counts[2] == 0,
          f"train: (octent, gemm, epilogue) launches = {counts[:3]}, want "
          f"({len(cfg.enc) + 1}, {TRAIN_STEPS * n_layers}, 0)")
    modes = [t["graph"] for t in res["timings"]]
    check(res["compiled_steps"] == 1
          and modes == ["warm-up", "capture"] + ["replay"] * (TRAIN_STEPS
                                                              - 2),
          f"train: {res['compiled_steps']} compiled steps, the steps ran "
          f"{modes}; want one: eager, captured, then replayed")
    resume = _train_resume(dev, cfg, res["state_digest"])

    # kernels against plain versions on one step
    model = minkunet.MinkUNet(cfg, device=dev,
                              generator=torch.Generator().manual_seed(SEED))
    vb = pointcloud.make_batch(np.random.default_rng(SEED), "indoor", 1,
                               BUCKET)
    batch = {k: torch.as_tensor(np.array(v), device=dev)
             for k, v in vb._asdict().items()}
    batch["labels"] = batch["labels"].clamp(0, cfg.classes - 1)
    plans = minkunet.build_plans(batch["coords"], batch["batch"],
                                 batch["valid"], cfg, device=dev)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def run(impl, hooks, tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with _relus(hooks):
                loss, _, grads = train.loss_and_grads(model, params, batch,
                                                      plans=plans, impl=impl)
            return loss, grads
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def plain(tf32=False):
        masks = []
        lu, gu = run("ref", _relu_hooks(masks), tf32)
        return (lu, gu, masks), run("ref", _pinned_relus(k_masks), tf32)[1]

    k_masks, sizes = [], []
    lk, gk = run("kernel", _relu_hooks(k_masks, sizes))
    check(len(k_masks) == n_layers,
          f"train: {len(k_masks)} ReLU calls, want {n_layers}")
    gate, broken = _train_gate(lk, gk, k_masks, sizes, *plain())
    check(not broken, f"train: kernel against plain: {'; '.join(broken)}")
    # the control: a plain step with TF32 matmuls must fail the same gate
    control, control_broken = _train_gate(lk, gk, k_masks, sizes,
                                          *plain(tf32=True))
    check(bool(control_broken), "train: the gate passed a plain step in "
          f"TF32 (control): {control}")
    del gk, k_masks

    # the step as the demo runs it: eager once, then captured and
    # replayed, then replayed, each replay held bit for bit to an eager
    # step from the same state and batch; then an eager step and a
    # replay, each profiled
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=TRAIN_STEPS,
                                warmup_steps=1)
    step = train.make_spconv_step(model, opt_cfg, plans, donate=True)
    state = (params, adamw.init(params))
    # the plain versions' step the same way, from a copy of the state:
    # every sum of it runs in a fixed order too
    plain_state = _tree_clone(state)
    compiled, state, twin, graph_steps = _replays_vs_eager(
        dev, step, state, batch, "train")
    step_ms = graph_steps[-1]["eager_ms"]

    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda r: -r[1])
        return rows, wall

    rows_r, replay_wall = profiled(lambda: compiled(state, batch))
    busy_r = sum(r[1] for r in rows_r)
    rows, profiled_ms = profiled(lambda: step(twin, batch))
    busy = sum(r[1] for r in rows)
    k2 = [r for r in rows if "spconv_" in r[0]]
    k2_ms = sum(r[1] for r in k2)
    check(sum(r[2] for r in k2 if "spconv_gemm_fused_kernel" in r[0])
          == n_layers,
          f"train: profiled step ran kernel 2 {k2} times, want {n_layers}")
    saves = res["save_ms"]
    emit(phase="train", config=cfg.name, scene="indoor",
         voxels=int(vb.valid.sum()), bucket=BUCKET, steps=TRAIN_STEPS,
         losses=res["losses"], mapsearch_calls=res["mapsearch_calls"],
         compiled_steps=res["compiled_steps"], pool_bytes=res["pool_bytes"],
         digest=res["state_digest"], resume=resume,
         graph_vs_eager=graph_steps, cache=res["cache"],
         launches={"octent_query": counts[0], "spconv_gemm_fused": counts[1],
                   "split_plan": counts[5], "split_reduce": counts[4]},
         recoveries=res["recoveries"], demo_s=demo_s,
         step_ms=[{**t, "save_ms": saves[i + 1]}
                  for i, t in enumerate(res["timings"])],
         baseline_save_ms=saves[0], final_save_ms=saves[-1],
         peak_mem_gb=peak_gb, held_before_gb=held / 1e9,
         kernel_vs_plain={
             **gate,
             "limits": {"loss_rel_err": TOL_TRAIN_LOSS,
                        "worst_layer_flip_share": TOL_TRAIN_FLIPS[0],
                        "flip_share": TOL_TRAIN_FLIPS[1],
                        "worst_norm_ratio": TOL_TRAIN_NORM,
                        "worst_grad_ratio": f"{TOL_TRAIN_GRAD} x its max "
                                            "|g|, pinned",
                        "worst_zero_grad_ratio": f"{TOL_TRAIN_ZERO} x max "
                                                 "|g|"},
             "relu_outputs": sizes,
             "control_tf32": {**control, "broken": control_broken}},
         profile={"step_ms": step_ms, "profiled_wall_ms": profiled_ms,
                  "device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
                  "device_ops": sum(r[2] for r in rows),
                  "kernel2_ms": k2_ms,
                  "kernel2": [{"name": n[:80], "device_ms": ms, "calls": c}
                              for n, ms, c in k2],
                  "top10": [{"name": n[:80], "device_ms": ms, "calls": c}
                            for n, ms, c in rows[:10]]},
         profile_replay={"step_ms": graph_steps[-1]["replay_ms"],
                         "profiled_wall_ms": replay_wall,
                         "device_busy_ms": busy_r,
                         "idle_share": 1 - busy_r / graph_steps[-1][
                             "replay_ms"],
                         "device_ops": sum(r[2] for r in rows_r),
                         "top10": [{"name": n[:80], "device_ms": ms,
                                    "calls": c}
                                   for n, ms, c in rows_r[:10]]})
    compiled.release()
    del state, twin, compiled
    plain_compiled, *_, plain_steps = _replays_vs_eager(
        dev, train.make_spconv_step(model, opt_cfg, plans, impl="ref",
                                    donate=True),
        plain_state, batch, "train, impl=\"ref\"")
    plain_compiled.release()
    emit(phase="train.plain_graph", config=cfg.name,
         graph_vs_eager=plain_steps)
    del plain_state, plain_compiled, params, model, plans, batch
    torch.cuda.empty_cache()
    return counts[0], counts[1], k2_ms


def _replays_vs_eager(dev, step, state, batch, label):
    """``step`` (a donated training step) as ``CompiledStep`` runs it:
    eager once, then captured and replayed, then replayed, each replay
    held bit for bit (loss and every state tensor) to an eager ``step``
    from a copy of the same state and batch. Returns the compiled step,
    the state, the last eager copy and each replay's record."""
    import torch
    from repro_torch.launch import train
    compiled = train.CompiledStep(step, dev)
    compiled(state, batch)
    records = []
    for _ in range(2):
        twin = _tree_clone(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = compiled(state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        twin, tm = step(twin, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        equal = torch.equal(m["loss"], tm["loss"]) and all(
            torch.equal(a, b) for a, b in zip(_leaves(state), _leaves(twin)))
        records.append({"graph": compiled.last,
                        "replay_ms": (t1 - t0) * 1e3,
                        "eager_ms": (t2 - t1) * 1e3, "bit_equal": equal})
        check(equal, f"{label}: a replayed step differs from the eager step "
                     f"from the same state and batch")
    return compiled, state, twin, records


def _second_layers(cfg, st, gconv3, subm):
    """The kernel-2 layers of one SECOND forward as (name, plan, in_valid,
    out_valid, Cin, Cout, is_subm): the output-stationary Gconv3 of every
    stage after the first, then the stage's Subm3 blocks."""
    layers, vin, c_prev = [], st.valid, cfg.in_ch
    for i, c in enumerate(cfg.channels):
        g, vout = gconv3[i], gconv3[i].out_valid
        if i > 0:
            layers.append((f"stage{i}.down", g, vin, vout, c_prev, c, False))
        layers += [(f"stage{i}.block{b}", subm[i], vout, vout, c, c, True)
                   for b in range(cfg.blocks)]
        vin, c_prev = vout, c
    return layers


def _to_bev_unordered(st, cfg):
    """The form ``second.to_bev`` replaced: the kept voxels added into the
    grid by one ``index_add``, in an order the card does not fix. Timed
    beside it here; the port never runs it."""
    import torch
    hw, z = cfg.bev_hw, cfg.bev_z
    size = cfg.n_batch * hw * hw * z
    x = st.coords[:, 0].clamp(0, hw - 1).long()
    y = st.coords[:, 1].clamp(0, hw - 1).long()
    zz = st.coords[:, 2].clamp(0, z - 1).long()
    flat = ((st.batch.long() * hw + x) * hw + y) * z + zz
    keep = torch.nonzero(st.valid & (flat < size)).squeeze(1)
    bev = torch.zeros((size, st.feats.shape[-1]), dtype=st.feats.dtype,
                      device=st.feats.device)
    bev = bev.index_add(0, flat[keep], st.feats[keep])
    return bev.reshape(cfg.n_batch, hw, hw, z * st.feats.shape[-1])


def _apply_maps_scatter_unordered(feats, weights, maps, bias, *, n_out,
                                  n_taps):
    """The form ``rulebook.apply_maps_scatter`` replaced: the partial sums
    added by one ``index_add`` into an ``(n_out + 1)``-row buffer, and
    the input gather's backward left to autograd's indexing backward,
    both in an order the card does not fix. Timed beside it here; the
    port never runs it."""
    import torch
    key = torch.where(maps.mvalid, maps.tap, n_taps).long()
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n_taps + 1)[:n_taps].tolist()
    live = order[:sum(counts)]
    rows = feats[maps.in_idx[live].long()].to(weights.dtype)
    parts, start = [], 0
    for t, c in enumerate(counts):
        if c:
            parts.append(rows[start:start + c] @ weights[t])
        start += c
    dst = maps.out_idx[live].long()
    dst = torch.where((dst >= 0) & (dst < n_out), dst, n_out)
    acc = torch.zeros((n_out + 1, weights.shape[-1]), dtype=weights.dtype,
                      device=weights.device)
    if parts:
        acc = acc.index_add(0, dst, torch.cat(parts))
    acc = acc[:n_out]
    if bias is not None:
        acc = acc + bias
    return torch.where(maps.out_valid[:n_out, None], acc, 0.0)


def _second_sums(dev, model, st, g0):
    """SECOND-large's two fixed-order sums of the forward, wall ms (host
    reads included), each against the one-``index_add`` form it replaced
    (``before``), and the segment-sum kernel at each index, held bit-equal
    to its plain version and timed (``_sum_times``): ``to_bev`` on the
    middle extractor's output, and the stage-0 Gconv3's
    ``apply_maps_scatter`` (plan ``g0``) forward and backward (its output
    and input indexes); and the
    RPN head's forward and backward with its deterministic backward
    against cuDNN's default one, each run twice."""
    import torch
    from repro_torch.core import rulebook, spconv
    from repro_torch.models import second
    cfg = model.cfg
    with torch.no_grad():
        mid = second.middle_extractor(model, st)
    hw, z = cfg.bev_hw, cfg.bev_z
    x = mid.coords[:, 0].clamp(0, hw - 1).long()
    y = mid.coords[:, 1].clamp(0, hw - 1).long()
    zz = mid.coords[:, 2].clamp(0, z - 1).long()
    size = cfg.n_batch * hw * hw * z
    flat = torch.where(mid.valid,
                       ((mid.batch.long() * hw + x) * hw + y) * z + zz, size)
    # the two forms take turns, each call timed on its own
    turns = [(wall_ms(lambda: second.to_bev(mid, cfg), 1),
              wall_ms(lambda: _to_bev_unordered(mid, cfg), 1))
             for _ in range(3)]
    bev = {"after_ms": [a for a, _ in turns],
           "before_ms": [b for _, b in turns],
           **_sum_times(mid.feats, flat, size, 3)}
    check(bev["ordered_vs_index_add_max_abs_err"]
          <= TOL_KERNEL * float(mid.feats.abs().sum(0).max()),
          f"second: to_bev ordered vs index_add {bev}")

    f = spconv.mask_feats(st._replace(feats=st.feats.float())).feats
    conv = model.stage0["down"].conv
    kw = dict(n_out=g0.n_out, n_taps=27)
    fr = f.detach().requires_grad_()
    wr = conv.w.detach().requires_grad_()
    sides = {}
    for name, fn in (("after", rulebook.apply_maps_scatter),
                     ("before", _apply_maps_scatter_unordered)):
        with torch.no_grad():
            fwd = wall_ms(lambda: fn(f, conv.w, g0.maps, conv.b, **kw), 3)
        out = fn(fr, wr, g0.maps, conv.b, **kw)
        gout = torch.ones_like(out)
        sides[name] = {"forward_ms": fwd, "backward_ms": wall_ms(
            lambda: torch.autograd.grad(out, (fr, wr), gout,
                                        retain_graph=True), 3)}
        del out
    live = g0.maps.mvalid
    vals = torch.randn((int(live.sum()), conv.w.shape[-1]), device=dev,
                       generator=torch.Generator(dev).manual_seed(SEED))
    amsc = {**sides, "sum": _sum_times(vals, g0.maps.out_idx[live],
                                       g0.n_out, 3),
            "input_gather_backward": _sum_times(
                vals[:, :f.shape[1]].contiguous(), g0.maps.in_idx[live],
                f.shape[0], 3)}
    # the RPN head's forward and backward at the BEV grid: its convolutions
    # with the backward held to cuDNN's deterministic algorithms (the
    # port's), against F.conv2d's autograd (cuDNN's default algorithms)
    grid = second.to_bev(mid, cfg).permute(0, 3, 1, 2).contiguous()

    def head(conv):
        xg = grid.detach().requires_grad_()
        ws = [model.rpn[k].detach().requires_grad_()
              for k in ("conv1", "conv2", "cls", "box")]
        h = torch.relu(conv(xg, ws[0], 1))
        h = torch.relu(conv(h, ws[1], 1))
        loss = conv(h, ws[2], 0).square().sum() + conv(
            h, ws[3], 0).square().sum()
        return torch.autograd.grad(loss, [xg, *ws])

    rpn = {}
    for name, conv in (
            ("deterministic", second._Conv.apply),
            ("default", lambda a, w, p: torch.nn.functional.conv2d(
                a, w, padding=p))):
        first, again = head(conv), head(conv)
        rpn[name] = {"forward_backward_ms": wall_ms(lambda: head(conv), 3),
                     "bit_equal_twice": all(torch.equal(a, b)
                                            for a, b in zip(first, again))}
    check(rpn["deterministic"]["bit_equal_twice"],
          "second: the RPN head's pinned backward differs between runs")
    return {"to_bev": bev, "apply_maps_scatter": amsc, "rpn_head": rpn,
            "timing": "wall ms (host clock, device synced, host reads "
                      "included), mean of 3 after one warm-up; to_bev's "
                      "after_ms / before_ms: 3 turns of one call each"}


def phase_second(dev):
    """The detection path: SECOND-large (``second.LARGE``, seeded weights
    and batch-norm statistics) on two LiDAR scans in one bucket of
    SECOND_BUCKET rows. Its first forward is the main path, with the
    launch counts set to 0 just before and read just after: kernel 1 once
    a stage, kernel 2 at the 6 Subm3 layers and the output-stationary
    Gconv3 of stages 1 and 2, 6 map searches plus one probe for each
    stage whose output budget overflows (a second forward starts at the
    memoized budgets: 6). Then: ``cls`` / ``box`` against an
    ``impl="ref"`` forward (plain search and plain gather-GEMM) from the
    same empty capacity memo, over the whole grid and over its interior,
    the same budgets tried and replans, every plan's kmap, budget and true
    output count against the plain forward's; the voxels ``to_bev``
    clips; kernel 1 at the 3 Subm3 coordinate sets and kernel 2 at the 8
    layer shapes against their plain versions; plan build and forward ms
    (one warm forward, three timed); one forward under ``torch.profiler``;
    one ``detection_loss`` step through the kernels against the plain
    versions under ``_train_gate``, which a plain step in TF32 must fail;
    the fixed-order sums: three kernel forwards and two plain ones, each
    kind one ``cls`` / ``box`` digest, and two loss steps each way, the
    loss and every gradient bit-equal; ``to_bev`` and the stage-0
    ``apply_maps_scatter`` timed against the one-``index_add`` forms they
    replaced (``_second_sums``); peak device memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import plan as planlib
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.data import pointcloud
    from repro_torch.kernels.segment_sum import kernel as ss_kernel
    from repro_torch.models import second
    from repro_torch.runtime import guard
    t_phase = time.perf_counter()
    cfg = second.LARGE
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vb = pointcloud.make_batch(np.random.default_rng(SEED), "lidar",
                               cfg.n_batch, SECOND_BUCKET,
                               voxel_size=LIDAR_VOXEL)
    st = SparseTensor(*(torch.as_tensor(a, device=dev) for a in (
        vb.coords, vb.batch, vb.valid, vb.feats)))
    gen = torch.Generator().manual_seed(SEED)
    model = _seed_bn(second.SECOND(cfg, device=dev, generator=gen), gen)
    n_stages = len(cfg.channels)
    n_gemm = n_stages * cfg.blocks + n_stages - 1

    # every Subm3 and Gconv3 plan the forwards build or fetch, and each
    # Gconv3 build tried: (input rows, budget, rows needed on overflow)
    built, tried = {"subm3": [], "gconv3": []}, []
    orig = {k: getattr(planlib, f"{k}_plan") for k in built}

    def recording(kind):
        def fn(*args, **kw):
            try:
                plan = orig[kind](*args, **kw)
            except planlib.CapacityOverflow as e:
                tried.append((args[0].shape[0], kw["out_budget"], e.needed))
                raise
            if kind == "gconv3":
                tried.append((args[0].shape[0], kw["out_budget"], None))
            built[kind].append(plan)
            return plan
        return fn

    def unique(plans):
        return list({id(p): p for p in plans}.values())

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def kernel_and_plain(s):
        """The first kernel forward of ``s``, with the counts set to 0 just
        before and read just after; a plain forward from the same empty
        capacity memo; then a second kernel forward, which starts at the
        memoized budgets. Outputs, plans, counts and the Gconv3 builds
        each of the first two tried."""
        def first(impl):
            tried.clear()
            for v in built.values():
                v.clear()
            guard._CAPACITY_HINTS.clear()
            _reset_counts()
            h0 = guard.health().get("replan.overflow")
            ms, out = sync_ms(lambda: model(s, impl=impl))
            return {"ms": ms, "out": out, "counts": _counts(),
                    "segment_sum": ss_kernel.launches,
                    "replans": guard.health().get("replan.overflow") - h0,
                    "tried": list(tried),
                    "plans": {k: unique(v) for k, v in built.items()}}

        res, ref = first(None), first("ref")
        searches = planlib.MAPSEARCH_CALLS[0]
        model(s)
        res.update(kplans=res.pop("plans"), rplans=ref["plans"],
                   ref_ms=ref["ms"], ref_out=ref["out"],
                   ref_counts=ref["counts"], ref_replans=ref["replans"],
                   ref_segment_sum=ref["segment_sum"],
                   ref_tried=ref["tried"],
                   again_searches=planlib.MAPSEARCH_CALLS[0] - searches)
        return res

    def held(label, res):
        """The launches, searches and replans of the kernel forward; every
        kmap, budget and true output count against the plain forward's;
        ``cls`` / ``box`` within TOL_LOGITS of the plain max over the whole
        grid, and over the interior cells (those the RPN's two 3x3
        convolutions carry no clipped edge row or column into) within
        TOL_LOGITS of the interior's own max: ``to_bev`` piles every voxel
        beyond the grid onto the edge, whose logits set the whole grid's
        max. Returns the stages' records and the errors."""
        counts, kplans, rplans = res["counts"], res["kplans"], res["rplans"]
        probes = sum(1 for t in res["tried"] if t[2] is not None)
        check(counts[0] == n_stages and counts[1] == n_gemm
              and counts[2] == 0,
              f"{label}: (octent, gemm, epilogue) launches = {counts[:3]}, "
              f"want ({n_stages}, {n_gemm}, 0)")
        # the segment sums: to_bev and the stage-0 Gconv3's scatter, on
        # the card in both forwards (it replaces an op of the reference,
        # not a Pallas kernel, and equals its plain version bit for bit)
        check(res["segment_sum"] == res["ref_segment_sum"] == SECOND_SUMS,
              f"{label}: segment_sum launched {res['segment_sum']} times "
              f"(plain forward {res['ref_segment_sum']}), want "
              f"{SECOND_SUMS}")
        check(counts[3] == 2 * n_stages + probes
              and res["replans"] == probes
              and res["again_searches"] == 2 * n_stages,
              f"{label}: {counts[3]} searches and {res['replans']} replans "
              f"with {probes} probes, then {res['again_searches']} searches")
        check(res["ref_tried"] == res["tried"]
              and res["ref_replans"] == res["replans"]
              and res["ref_counts"][3] == counts[3],
              f"{label}: the plain forward tried {res['ref_tried']}, the "
              f"kernel forward {res['tried']}")
        check(all(len(p) == n_stages for p in (*kplans.values(),
                                               *rplans.values())),
              f"{label}: plans {[len(p) for p in kplans.values()]}")
        for kind in ("gconv3", "subm3"):
            for i, (pk, pr) in enumerate(zip(kplans[kind], rplans[kind])):
                check(torch.equal(pk.kmap, pr.kmap) and pk.n_out == pr.n_out,
                      f"{label}: stage {i} {kind} kmap or budget differs "
                      f"from the plain search's")
        stages = []
        for i, (g, pr) in enumerate(zip(kplans["gconv3"], rplans["gconv3"])):
            rows = g.maps.in_idx.shape[0] // 8
            check(int(g.maps.n_true) == int(pr.maps.n_true),
                  f"{label}: stage {i} n_true differs")
            stages.append({
                "stage": i, "rows_in": rows, "budget": g.n_out,
                "n_true": int(g.maps.n_true),
                "voxels_out": int(g.out_valid.sum()),
                "replans": sum(1 for t in res["tried"]
                               if t[0] == rows and t[2] is not None),
                "dataflow": "input_stationary" if i == 0
                else "output_stationary"})
        errs = {}
        for name, got, want in zip(("cls", "box"), res["out"],
                                   res["ref_out"]):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and scale > 0
                  and err <= TOL_LOGITS * scale,
                  f"{label}: max|{name} kernel - plain| {err} > "
                  f"{TOL_LOGITS} * {scale}")
            inner = cfg.bev_hw - 3
            gi, wi = got[:, :inner, :inner], want[:, :inner, :inner]
            iscale = float(wi.abs().max())
            ierr = float((gi - wi).abs().max())
            nz = wi.abs()[wi != 0]
            check(iscale > 0 and ierr <= TOL_LOGITS * iscale,
                  f"{label}: interior max|{name} kernel - plain| {ierr} > "
                  f"{TOL_LOGITS} * {iscale}")
            errs[name] = {"max_abs_err": err, "max_abs": scale,
                          "interior_cells": f"[:, :{inner}, :{inner}]",
                          "interior_max_abs_err": ierr,
                          "interior_max_abs": iscale,
                          "interior_limit": TOL_LOGITS * iscale,
                          "interior_median_abs_nonzero":
                              float(nz.median()) if nz.numel() else 0.0,
                          "interior_nonzero_share": nz.numel() / wi.numel()}
        return probes, stages, errs

    planlib.subm3_plan = recording("subm3")
    planlib.gconv3_plan = recording("gconv3")
    try:
        main = kernel_and_plain(st)
        probes, stages, errs = held("second", main)
        # buckets whose Gconv3 budgets overflow: the replan on the card
        replan = []
        for rows in SECOND_REPLAN_BUCKETS:
            vr = pointcloud.make_batch(np.random.default_rng(SEED), "lidar",
                                       cfg.n_batch, rows,
                                       voxel_size=LIDAR_VOXEL)
            res = kernel_and_plain(SparseTensor(*(torch.as_tensor(
                a, device=dev) for a in (vr.coords, vr.batch, vr.valid,
                                         vr.feats))))
            n_probes, r_stages, r_errs = held(f"second bucket {rows}", res)
            check(n_probes > 0, f"second: bucket {rows} never replanned")
            replan.append({"bucket": rows, "probes": n_probes,
                           "searches": res["counts"][3],
                           "plain_searches": res["ref_counts"][3],
                           "searches_again": res["again_searches"],
                           "stages": r_stages, "kernel_vs_plain": r_errs,
                           "builds_tried": [
                               {"rows": r, "budget": b, "overflow_needed": n}
                               for r, b, n in res["tried"]]})
            del res, vr
    finally:
        planlib.subm3_plan, planlib.gconv3_plan = (orig["subm3"],
                                                   orig["gconv3"])
    counts, kplans = main["counts"], main["kplans"]
    first_ms, ref_ms = main["ms"], main["ref_ms"]
    first_tried = main["tried"]
    # what to_bev clips: the last stage's voxels beyond the BEV grid
    last = kplans["gconv3"][-1]
    oc, ov = last.out_coords, last.out_valid
    edge = ov & ((oc[:, 0] > cfg.bev_hw - 1) | (oc[:, 1] > cfg.bev_hw - 1))
    bev_clip = {"voxels": int(ov.sum()),
                "clipped_onto_edge": int(edge.sum()),
                "clipped_in_z": int((ov & (oc[:, 2] > cfg.bev_z - 1)).sum())}

    # plan build and forward: fresh caches, then one holding the plans.
    # The fresh forwards, and two plain ones, must each give one digest
    fresh_runs = [sync_ms(lambda: model(st)) for _ in range(3)]
    fresh = [ms for ms, _ in fresh_runs]
    digests = {"kernel": [_sha256(*out) for _, out in fresh_runs],
               "ref": [_sha256(*model(st, impl="ref")) for _ in range(2)]}
    del fresh_runs
    for impl, ds in digests.items():
        check(len(set(ds)) == 1,
              f"second: {len(ds)} impl={impl} forwards give the cls/box "
              f"digests {ds}")
    cache = planlib.PlanCache()
    model(st, cache=cache)
    searches = planlib.MAPSEARCH_CALLS[0]
    cached = [sync_ms(lambda: model(st, cache=cache))[0] for _ in range(3)]
    check(planlib.MAPSEARCH_CALLS[0] == searches,
          "second: a forward through a full cache searched")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms, _ = sync_ms(lambda: model(st))
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    k2_prof = sum(r[1] for r in rows if "spconv_" in r[0])
    check(sum(r[2] for r in rows if "spconv_gemm_fused_kernel" in r[0])
          == n_gemm, f"second: the profiled forward ran kernel 2 "
                     f"{[r for r in rows if 'spconv_' in r[0]]}")

    # kernel 1 at the 3 Subm3 coordinate sets, kernel 2 at the 8 layers
    kw = dict(grid_bits=cfg.grid_bits, batch_bits=cfg.batch_bits)
    k1_shapes = []
    for i, (g, s) in enumerate(zip(kplans["gconv3"], kplans["subm3"])):
        got, rec = _octent_shape(g.out_coords, g.out_batch, g.out_valid,
                                 g.n_out, kw, f"second stage {i}")
        check(torch.equal(got, s.kmap),
              f"second: octent_query differs from stage {i}'s kmap")
        k1_shapes.append({"stage": i, **rec})
    layers = _second_layers(cfg, st, kplans["gconv3"], kplans["subm3"])
    check(len(layers) == n_gemm, f"second: {len(layers)} kernel-2 layers")
    k2_shapes = []
    for shp in seeded_shapes(dev, layers, epilogue=False):
        rec = _gemm_shape(dev, shp)
        emit(phase="second.spconv_gemm_fused", **rec)
        k2_shapes.append(rec)

    # one detection_loss step, kernels against plain versions
    hw, g2 = cfg.bev_hw, torch.Generator(device=dev).manual_seed(SEED)
    batch = {"coords": st.coords, "batch": st.batch, "valid": st.valid,
             "feats": st.feats,
             "objectness": (torch.rand((cfg.n_batch, hw, hw), generator=g2,
                                       device=dev) < 0.05).float(),
             "boxes": torch.randn((cfg.n_batch, hw, hw, cfg.box_dim),
                                  generator=g2, device=dev)}
    def run(impl, hooks, tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            with _relus(hooks):
                loss, _, grads = second.loss_and_grads(model, batch,
                                                       impl=impl)
            return loss, grads
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def plain(tf32=False):
        masks = []
        lu, gu = run("ref", _relu_hooks(masks), tf32)
        return (lu, gu, masks), run("ref", _pinned_relus(k_masks), tf32)[1]

    k_masks, sizes = [], []
    _reset_counts()
    step_ms, (lk, gk) = sync_ms(lambda: run("kernel",
                                            _relu_hooks(k_masks, sizes)))
    step_counts, step_sums = _counts(), ss_kernel.launches
    check(step_counts[0] == n_stages and step_counts[1] == n_gemm
          and step_sums >= SECOND_SUMS,
          f"second: loss step launches {step_counts[:2]}, segment_sum "
          f"{step_sums}")
    n_relu = n_stages * (1 + cfg.blocks) + 2
    check(len(k_masks) == n_relu,
          f"second: {len(k_masks)} ReLU calls, want {n_relu}")
    gate, broken = _train_gate(lk, gk, k_masks, sizes, *plain())
    check(not broken, f"second: loss step kernel against plain: "
                      f"{'; '.join(broken)}")
    # the control: the plain step in TF32 (matmuls and the RPN's cuDNN
    # convolutions) must fail the same gate
    control, control_broken = _train_gate(lk, gk, k_masks, sizes,
                                          *plain(tf32=True))
    check(bool(control_broken), "second: the gate passed a plain step in "
          f"TF32 (control): {control}")
    del gk, k_masks
    # two more loss steps each way: the loss and every gradient bit-equal
    step_digests = {}
    for impl in ("kernel", "ref"):
        runs = [second.loss_and_grads(model, batch, impl=impl)
                for _ in range(2)]
        (l0, _, g0), (l1, _, g1) = runs
        differ = [k for k in g0 if not torch.equal(g0[k], g1[k])]
        step_digests[impl] = [_sha256(l, *(g[k] for k in sorted(g)))
                              for l, _, g in runs]
        check(torch.equal(l0, l1) and not differ,
              f"second: two impl={impl} loss steps differ: loss "
              f"{float(l0)} vs {float(l1)}, gradients {differ}")
        del runs, g0, g1
    sums = _second_sums(dev, model, st, kplans["gconv3"][0])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    k1_ms = sum(r["ms"] for r in k1_shapes)
    k2_tot = {key: sum(len(r["layers"]) * (r["plain"][key] if key in (
        "ms", "plain_ms") else r[key]) for r in k2_shapes)
              for key in ("ms", "plain_ms", "bound_ms", "ops_ms",
                          "bytes_ms")}
    emit(phase="second", config=cfg.name, bucket=SECOND_BUCKET,
         voxels=int(vb.valid.sum()),
         voxels_per_scan=[int((vb.valid & (vb.batch == b)).sum())
                          for b in range(cfg.n_batch)],
         launches={"octent_query": counts[0], "spconv_gemm_fused": counts[1],
                   "mapsearch": counts[3], "split_plan": counts[5],
                   "split_reduce": counts[4],
                   "segment_sum": main["segment_sum"]},
         probes=probes, replans=main["replans"], stages=stages,
         builds_tried=[{"rows": r, "budget": b, "overflow_needed": n}
                       for r, b, n in first_tried],
         kernel_vs_plain={"tolerance": f"{TOL_LOGITS} * max|plain|, whole "
                                       "grid and interior", **errs},
         to_bev=bev_clip,
         digests={"forward_cls_box": digests, "loss_and_grads": step_digests},
         fixed_order_sums=sums,
         replan=replan,
         first_forward_ms=first_ms, plain_forward_ms=ref_ms,
         forward_ms=fresh, forward_cached_plans_ms=cached,
         plan_build_ms=float(np.mean(fresh) - np.mean(cached)),
         profile={"wall_ms": prof_ms, "device_busy_ms": busy,
                  "idle_share": 1 - busy / prof_ms,
                  "device_ops": sum(r[2] for r in rows),
                  "kernel2_ms": k2_prof,
                  "top10": [{"name": n[:80], "device_ms": ms, "calls": c}
                            for n, ms, c in rows[:10]]},
         octent_query={"shapes": k1_shapes, "ms_per_forward": k1_ms,
                       "plain_ms_per_forward": sum(
                           r["plain_ms"] for r in k1_shapes),
                       "bound_ms_per_forward": sum(
                           r["bound_ms"] for r in k1_shapes)},
         spconv_gemm_fused_per_forward={"layers": n_gemm, **k2_tot},
         loss_step={"ms": step_ms, "kernel_vs_plain": gate,
                    "limits": {"loss_rel_err": TOL_TRAIN_LOSS,
                               "worst_layer_flip_share": TOL_TRAIN_FLIPS[0],
                               "flip_share": TOL_TRAIN_FLIPS[1],
                               "worst_norm_ratio": TOL_TRAIN_NORM,
                               "worst_grad_ratio": f"{TOL_TRAIN_GRAD} x its "
                                                   "max |g|, pinned",
                               "worst_zero_grad_ratio": f"{TOL_TRAIN_ZERO} x "
                                                        "max |g|"},
                    "control_tf32": {**control, "broken": control_broken},
                    "relu_outputs": sizes,
                    "launches": {"octent_query": step_counts[0],
                                 "spconv_gemm_fused": step_counts[1],
                                 "segment_sum": step_sums}},
         peak_mem_gb=peak_gb, seconds=time.perf_counter() - t_phase)
    del model, batch, st
    torch.cuda.empty_cache()
    fwd_sums = (sums["to_bev"], sums["apply_maps_scatter"]["sum"])
    return {"octent_query": counts[0], "spconv_gemm_fused": counts[1],
            "octent_ms": k1_ms, "gemm_ms": k2_tot["ms"],
            "segment_sum": {
                "launches": main["segment_sum"],
                "loss_step_launches": step_sums,
                **_sum_totals(fwd_sums),
                "shapes": {name: {k: r[k] for k in (
                    "rows", "kept", "channels", "widest_row", *SUM_KEYS)}
                    for name, r in (
                        ("to_bev", fwd_sums[0]),
                        ("gconv3_stage0_out", fwd_sums[1]),
                        ("gconv3_stage0_in", sums["apply_maps_scatter"][
                            "input_gather_backward"]))}}}


def _profile_rows(prof):
    """(name, device ms, calls) of each device op under ``prof``, longest
    first."""
    import torch
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])


def _row_list_shape(dev, st, prev_kmap, rows, kw):
    """Kernel 1 in row-list mode at one steady frame's level 0 (the new
    frame's canonical rows and spliced table, the previous kmap, the dirty
    rows): bit-equal to its plain version and to the session's kmap; its
    ms, plain ms and bytes bound beside a full launch on the same table."""
    import torch
    from repro_torch.core import morton
    from repro_torch.kernels.octent import kernel as oct_kernel
    from repro_torch.kernels.octent.ref import octent_query_ref
    offs = torch.as_tensor(morton.subm3_offsets(), device=dev)
    qt = st.table
    args = (st.coords, st.batch, st.valid, offs, qt.ublocks, qt.tkey,
            qt.tval, qt.n_blocks)
    got = oct_kernel.octent_query(*args, **kw, rows=rows, prev=prev_kmap)
    want = octent_query_ref(*args, **kw, rows=rows, prev=prev_kmap)
    full = oct_kernel.octent_query(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and torch.equal(got, st.kmap)
          and torch.equal(full, st.kmap),
          "stream: kernel 1's row-list launch differs from its plain "
          "version or the session's kmap")
    ms = time_ms(lambda: oct_kernel.octent_query(
        *args, **kw, rows=rows, prev=prev_kmap), 50)
    plain_ms = time_ms(lambda: octent_query_ref(
        *args, **kw, rows=rows, prev=prev_kmap), 5)
    full_ms = time_ms(lambda: oct_kernel.octent_query(*args, **kw), 50)
    # bytes the function needs: the row list, each listed valid row's
    # coords, batch and flag, the live directory and table entries, the
    # offsets and n_blocks, the unlisted rows of the previous kmap read
    # and the whole kmap written
    n, k = st.coords.shape[0], offs.shape[0]
    q = rows.shape[0]
    listed = rows[rows >= 0].long()
    n_listed = listed.numel()
    n_valid = int(st.valid[listed].sum())
    max_blocks = qt.ublocks.numel()
    live_blocks = min(int(qt.n_blocks), max_blocks)
    n_table = int((qt.tkey < max_blocks * morton.TABLE_SIZE).sum())
    table_bytes = 4 * live_blocks + 8 * n_table + k * 3 * 4 + 4
    nbytes = (4 * q + n_listed + 16 * n_valid + table_bytes
              + (n - n_listed) * k * 4 + n * k * 4)
    full_bytes = (n + 16 * int(st.valid.sum()) + table_bytes + n * k * 4)
    return {"rows": n, "q": q, "dirty_rows": n_listed, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
            "bytes": nbytes, "full_ms": full_ms,
            "full_bound_ms": full_bytes / PEAK_BYTES_S * 1e3}


def phase_stream(dev, cfg):
    """The streaming path: a moving-sensor sequence (STREAM_FRAMES frames,
    then the last one again) through MinkUNet-large (seeded weights) on
    BUCKET-row frames, by a delta session and a scratch session (delta
    path off, content keys off), each with its own pinned store. The
    delta session is the main path: its launches are counted frame by
    frame (kernel 1, its row-list launches, kernel 2), the scratch
    session's are not. Every frame, at every level, the two sessions'
    canonical arrays, kmaps and tables are equal, and so are their
    logits; every level's kmap equals the plain search over its table;
    the logits match a plain-version forward (``impl="ref"``) over the
    same plans within TOL_LOGITS of its max. Kernel 1 runs in row-list
    mode on every steady frame and kernel 2 25 times a frame; the steady
    frames search under SMOKE_RATIO_GATE of the scratch rows and the
    repeated frame no query row. Kernel 1's row-list launch at one steady
    frame's level 0 is held to its plain version and timed beside a full
    launch; one delta frame is profiled; peak device memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import plan as planlib
    from repro_torch.core import stream
    from repro_torch.data import pointcloud
    from repro_torch.kernels.octent import ops as oct_ops
    from repro_torch.runtime import feature_cache
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frames = pointcloud.moving_sensor_sequence(
        np.random.default_rng(SEED), STREAM_FRAMES, BUCKET,
        window=STREAM_WINDOW, step=STREAM_STEP, depth=STREAM_DEPTH,
        density=STREAM_DENSITY)
    frames.append(frames[-1])               # the empty delta
    model = _seeded_model(cfg, dev)
    sessions = {
        "delta": stream.StreamSession(
            cfg, BUCKET, enabled=True, device=dev,
            cache=planlib.PlanCache(pinned=feature_cache.PinnedStore())),
        "scratch": stream.StreamSession(
            cfg, BUCKET, enabled=False, device=dev,
            cache=planlib.PlanCache(content=False,
                                    pinned=feature_cache.PinnedStore()))}
    d_sess, s_sess = sessions["delta"], sessions["scratch"]
    n_layers = 1 + len(cfg.enc) + len(cfg.dec) \
        + cfg.blocks * (len(cfg.enc) + len(cfg.dec))
    kw = dict(grid_bits=cfg.grid_bits, batch_bits=cfg.batch_bits)

    def run(sess, f):
        before, q0, c0 = sess.stats(), oct_ops.QUERY_ROWS[0], _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        delta = sess.advance(f.coords, f.batch, f.valid)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = sess.forward(model, f.feats[:, :cfg.in_ch])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        c = [a - b for a, b in zip(_counts(), c0)]
        inc = {k: v - before[k] for k, v in sess.stats().items()}
        return delta, logits, {
            "advance_ms": (t1 - t0) * 1e3, "forward_ms": (t2 - t1) * 1e3,
            "levels": [inc["delta_levels"], inc["full_levels"],
                       inc["content_hit_levels"]],
            "rows_searched": inc["rows_searched"],
            "rows_scratch": inc["rows_scratch"],
            "query_rows": oct_ops.QUERY_ROWS[0] - q0,
            "launches": {"octent_query": c[0], "octent_row_list": c[6],
                         "spconv_gemm_fused": c[1]}}

    _reset_counts()
    main_launches = {"octent_query": 0, "octent_row_list": 0,
                     "spconv_gemm_fused": 0}
    per_frame, steady, row_list, prof_rec = [], [0, 0], None, None
    for t, f in enumerate(frames):
        prev0 = d_sess.states[0]
        if t == STREAM_PROFILE_FRAME:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                delta, logits, rec = run(d_sess, f)
            rows = _profile_rows(prof)
            busy = sum(r[1] for r in rows)
            wall = rec["advance_ms"] + rec["forward_ms"]
            prof_rec = {"frame": t, "wall_ms": wall, "device_busy_ms": busy,
                        "idle_share": 1 - busy / wall,
                        "device_ops": sum(r[2] for r in rows),
                        "top10": [{"name": n[:80], "device_ms": ms,
                                   "calls": c} for n, ms, c in rows[:10]]}
        else:
            delta, logits, rec = run(d_sess, f)
        for key in main_launches:
            main_launches[key] += rec["launches"][key]
        _, s_logits, s_rec = run(s_sess, f)
        # the two sessions, level by level, and the plain search
        for r in range(d_sess.levels):
            a, b = d_sess.states[r], s_sess.states[r]
            for name, x, y in [("coords", a.coords, b.coords),
                               ("batch", a.batch, b.batch),
                               ("valid", a.valid, b.valid),
                               ("kmap", a.kmap, b.kmap)] + [
                    (f"table.{n}", x, y) for n, x, y in zip(
                        oct_ops.QueryTable._fields, a.table, b.table)]:
                check(torch.equal(x, y), f"stream: frame {t} level {r} "
                      f"{name} differs between delta and scratch")
            plain, _ = oct_ops.build_kmap(a.coords, a.batch, a.valid,
                                          max_blocks=d_sess.mb[r], **kw,
                                          impl="ref", table=a.table)
            check(torch.equal(plain, a.kmap), f"stream: frame {t} level "
                  f"{r} kmap differs from the plain search")
        check(torch.equal(logits, s_logits),
              f"stream: frame {t} logits differ between delta and scratch")
        ref = d_sess.forward(model, f.feats[:, :cfg.in_ch], impl="ref")
        scale = ref.abs().max().item()
        err = (logits - ref).abs().max().item()
        check(np.isfinite(err) and err <= TOL_LOGITS * scale,
              f"stream: frame {t} logits vs plain {err} (max {scale})")
        check(rec["launches"]["spconv_gemm_fused"] == n_layers,
              f"stream: frame {t} launched kernel 2 "
              f"{rec['launches']['spconv_gemm_fused']} times")
        if t == STREAM_CHECK_FRAME:
            n_dirty = int(delta.n_dirty_rows)
            row_list = _row_list_shape(
                dev, d_sess.states[0], prev0.kmap, stream.pack_dirty_rows(
                    delta.dirty_rows, stream.row_budget(n_dirty, BUCKET)),
                kw)
        if 0 < t < len(frames) - 1:
            check(rec["launches"]["octent_row_list"] > 0,
                  f"stream: steady frame {t} ran no row-list launch")
            steady[0] += rec["rows_searched"]
            steady[1] += s_rec["rows_searched"]
        line = {"frame": t, "voxels": int(f.valid.sum()),
                "dirty_rows": int(delta.n_dirty_rows),
                "logits_vs_plain": err / scale, "delta": rec,
                "scratch": {k: s_rec[k] for k in (
                    "advance_ms", "forward_ms", "levels", "rows_searched")}}
        emit(phase="stream.frame", **line)
        per_frame.append(line)
    last = per_frame[-1]["delta"]
    check(last["query_rows"] == 0 and last["launches"]["octent_query"] == 0,
          f"stream: the repeated frame searched {last['query_rows']} rows")
    ratio = steady[0] / steady[1]
    check(ratio < SMOKE_RATIO_GATE,
          f"stream: steady frames searched {ratio} of the scratch rows")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = {name: s.stats() for name, s in sessions.items()}
    pinned = {name: s.cache.pinned.stats() for name, s in sessions.items()}
    for s in sessions.values():
        s.close()

    def mean(sess, key):            # steady frames, the profiled one out
        return float(np.mean([fr[sess][key] for fr in per_frame[1:-1]
                              if fr["frame"] != STREAM_PROFILE_FRAME]))
    emit(phase="stream", config=cfg.name, bucket=BUCKET,
         frames=len(frames), window=STREAM_WINDOW, step=STREAM_STEP,
         depth=STREAM_DEPTH, density=STREAM_DENSITY,
         steady_search_ratio=ratio, ratio_gate=SMOKE_RATIO_GATE,
         launches=main_launches, launches_per_frame={
             "spconv_gemm_fused": n_layers},
         steady_means={"delta_advance_ms": mean("delta", "advance_ms"),
                       "delta_forward_ms": mean("delta", "forward_ms"),
                       "scratch_advance_ms": mean("scratch", "advance_ms"),
                       "scratch_forward_ms": mean("scratch", "forward_ms")},
         row_list=row_list, profile=prof_rec, stats=stats, pinned=pinned,
         tolerance=f"{TOL_LOGITS} * max|plain logit|",
         peak_mem_gb=peak_gb, seconds=time.perf_counter() - t_phase)
    del sessions, d_sess, s_sess, model
    torch.cuda.empty_cache()
    return {"octent_query": main_launches["octent_query"],
            "octent_row_list": main_launches["octent_row_list"],
            "spconv_gemm_fused": main_launches["spconv_gemm_fused"],
            "row_list": row_list}


# ---------------------------------------------------------------------------
# Phase chaos: the serve replay under injected faults, the ladder, fallback
# ---------------------------------------------------------------------------

def _oversize_cloud(n: int):
    """``n`` distinct valid voxels in a 64 x 64 x k block: more than a
    BUCKET-row bucket admits."""
    lin = np.arange(n)
    coords = np.stack([lin % 64, (lin // 64) % 64, lin // 4096],
                      -1).astype(np.int32)
    return (coords, np.zeros(n, np.int32), np.ones(n, bool),
            np.zeros((n, 4), np.float32))


def _chaos_mix(scenes, victim):
    """The replay's submissions ``(rid, arrays, deadline_s)``, as
    ``benchmarks/serve_replay.py`` builds its mix: the scenes, then each
    again in fresh buffers (content hits), a cloud with NaN coordinates
    and an oversize one (the strict policy rejects both), two requests
    already past their deadline (shed at dequeue), and a fresh geometry
    last: the victim of a persistent ``admit`` fault."""
    def arrays(sc):
        return tuple(np.array(a) for a in (sc.coords, sc.batch, sc.valid,
                                            sc.feats))
    subs = [(rid, arrays(sc), CHAOS_DEADLINE_S) for rid, sc in scenes]
    subs += [(rid + "-again", arrays(sc), CHAOS_DEADLINE_S)
             for rid, sc in scenes]
    c, b, v, f = arrays(scenes[0][1])
    cf = c.astype(np.float32)
    cf[:3] = np.nan
    subs.append(("bad-nan", (cf, b, v, f), CHAOS_DEADLINE_S))
    subs.append(("bad-oversize", _oversize_cloud(BUCKET + 4096),
                 CHAOS_DEADLINE_S))
    subs += [(f"late-{i}", arrays(scenes[2][1]), -1.0) for i in range(2)]
    subs.append(("victim", arrays(victim), CHAOS_DEADLINE_S))
    return subs


def _replay(dev, model, subs, plan):
    """One engine lifecycle over ``subs`` with ``plan`` installed (its
    counts of site calls per tick recorded), one request a tick. Returns
    the results by rid, the engine's stats, the health delta, each
    completed request's launches ``(kernel 1, kernel 2)`` and searches,
    and the site calls each tick's request made, by rid."""
    from repro_torch.launch.spconv_serve import ServeEngine
    from repro_torch.runtime import admission, fault, guard
    cfg = model.cfg
    eng = ServeEngine(model, device=dev, max_batch=1,
                      queue=admission.AdmissionQueue(
                          capacity=64, buckets=(BUCKET,),
                          grid_bits=cfg.grid_bits,
                          batch_bits=cfg.batch_bits))
    h0 = guard.health().snapshot()
    launches, calls = {}, {}
    with fault.inject(plan):
        for rid, arrs, dl in subs:
            eng.submit(rid, *arrs, deadline_s=dl)
        while len(eng.queue):
            before, c0 = _counts(), dict(plan.calls)
            tick = eng.step()
            d = [a - b for a, b in zip(_counts(), before)]
            for r in tick:
                if r.status == "completed":
                    launches[r.rid] = (d[0], d[1], d[3])
                    calls[r.rid] = c0
    out = {"results": {r.rid: r for r in eng.results},
           "stats": eng.stats(), "health": guard.health().delta(h0),
           "launches": launches, "calls_before": calls}
    del eng
    return out


def _ledger_errors(rep) -> list:
    """The engine's result ledger against its ``serve.*`` and ``admit.*``
    health deltas (``benchmarks/serve_replay.py``'s accounting)."""
    from repro_torch.runtime import admission
    s, h, bad = rep["stats"], rep["health"], []
    for status in ("completed", "shed", "rejected", "isolated", "degraded"):
        if s[status] != h.get(f"serve.{status}", 0):
            bad.append(f"{status}={s[status]} != serve.{status}="
                       f"{h.get(f'serve.{status}', 0)}")
    # admitted: completed, or shed after admission
    admitted = sum(r.status == "completed" or (
        r.status == "shed" and r.reason != admission.SHED_QUEUE_FULL)
        for r in rep["results"].values())
    if h.get("admit.ok", 0) != admitted:
        bad.append(f"admit.ok={h.get('admit.ok', 0)} != {admitted}")
    return bad


def _no_validate(delta: dict) -> dict:
    return {k: v for k, v in delta.items() if not k.startswith("validate.")}


def _chaos_schedule(clean, rids):
    """One fault at each serving site, each recovered by the engine's
    retry: ``batch`` on the first tick, ``fingerprint`` on the first
    request's level-1 coordinates (a level that a repeat reaches by
    identity, so the corrupt key costs nothing later), ``plan`` on the
    second request's first plan build, ``search`` on the third request's
    first search, ``gemm`` on the fourth request's first layer, and
    ``admit``: a transient on the first submission and a persistent pair
    on the victim's (the last). Indices come from the clean replay's site
    calls before each request; no fault precedes the first request's
    level 1 but the batch site's, which fingerprints nothing, and a
    repeat fingerprints level 0 alone, so the first request's level 1
    starts at its calls before plus a repeat's."""
    before = clean["calls_before"]
    n_subs = len(clean["results"])

    def fp(rid):
        return before[rid].get("fingerprint", 0)

    level0 = fp(rids[1] + "-again") - fp(rids[0] + "-again")
    return {"batch": [0], "fingerprint": [fp(rids[0]) + level0],
            "plan": [before[rids[1]].get("plan", 0)],
            "search": [before[rids[2]].get("search", 0)],
            "gemm": [before[rids[3]].get("gemm", 0)],
            "admit": [0, n_subs, n_subs + 1]}


def phase_chaos(dev, cfg, scenes, victim, serve_digests):
    """The serve replay under faults (``benchmarks/serve_replay.py``'s
    gate), then the degradation ladder and the fallback chain, each with
    its health counters held exactly. Returns the launches of kernels 1
    and 2 over the phase."""
    import os
    import torch
    from repro_torch.runtime import admission, fault, guard
    from repro_torch.launch.spconv_serve import ServeEngine
    t_phase = time.perf_counter()
    model = _seeded_model(cfg, dev)
    rids = [rid for rid, _ in scenes]
    subs = _chaos_mix(scenes, victim)
    n_layers = _n_layers(cfg)
    # (kernel-1, kernel-2) launches of a fresh geometry and of a repeat
    fresh, repeat = (len(cfg.enc) + 1, n_layers), (0, n_layers)
    _reset_counts()
    clean = _replay(dev, model, subs, fault.FaultPlan())
    schedule = _chaos_schedule(clean, rids)
    faulted = _replay(dev, model, subs, fault.FaultPlan(schedule=schedule))

    for name, rep in (("clean", clean), ("faulted", faulted)):
        res = rep["results"]
        for rid, _, _ in subs:
            want = {"bad-nan": ("rejected", admission.REJECT_INVALID),
                    "bad-oversize": ("rejected", admission.REJECT_OVERSIZE),
                    "late-0": ("shed", admission.SHED_DEADLINE),
                    "late-1": ("shed", admission.SHED_DEADLINE),
                    "victim": ("completed", None) if name == "clean" else
                    ("isolated", admission.ISOLATED_FAULT)}.get(
                        rid, ("completed", None))
            got = (res[rid].status, res[rid].reason)
            check(got == want, f"chaos {name}: {rid} {got}, want {want}")
            check(not res[rid].degraded, f"chaos {name}: {rid} degraded "
                  f"without a cause")
        bad = _ledger_errors(rep)
        check(not bad, f"chaos {name}: ledger != health: {bad}")
        for rid in rids + [r + "-again" for r in rids]:
            check(res[rid].digest == clean["results"][rid].digest,
                  f"chaos {name}: {rid} digest differs from the clean "
                  f"replay")
            if dev.type == "cuda":
                got = rep["launches"][rid][:2]
                want = repeat if rid.endswith("-again") else fresh
                check(got == want, f"chaos {name}: {rid} launched (kernel "
                      f"1, kernel 2) {got}, want {want}")
    for rid, _ in scenes:
        check(clean["results"][rid].digest == serve_digests[rid],
              f"chaos: {rid} digest differs from phase serve's")
    # every serving site fired, and nothing else moved
    h_clean, h_fault = _no_validate(clean["health"]), \
        _no_validate(faulted["health"])
    want = dict(h_clean)
    for k, n in (("admit.ok", -1), ("serve.completed", -1),
                 ("serve.isolated", 1), ("admit.isolated_fault", 1),
                 ("admit.retry", 2), ("fault.admit", 3), ("fault.batch", 1),
                 ("serve.batch_retry", 1), ("fault.plan", 1),
                 ("fault.search", 1), ("serve.build_retry", 2),
                 ("fault.gemm", 1), ("serve.exec_retry", 1),
                 ("fault.fingerprint", 1)):
        want[k] = want.get(k, 0) + n
    check(h_fault == want, f"chaos faulted health {h_fault}, want {want}")
    check(set(h_fault) >= {f"fault.{s}" for s in fault.SERVE_FAULT_SITES},
          "chaos: a serving fault site never fired")

    # -- the ladder: persistent plan faults climb it, healthy ticks descend
    first_rid, first = scenes[0]
    clean_digest = clean["results"][first_rid].digest
    eng = ServeEngine(model, device=dev, max_batch=1, recover_after=2,
                      queue=admission.AdmissionQueue(
                          buckets=(BUCKET,), grid_bits=cfg.grid_bits,
                          batch_bits=cfg.batch_bits))

    def serve(rid, sc):
        before = _counts()
        eng.submit(rid, *(np.array(a) for a in (sc.coords, sc.batch,
                                                 sc.valid, sc.feats)),
                   deadline_s=CHAOS_DEADLINE_S)
        (res,) = eng.step()
        d = [a - b for a, b in zip(_counts(), before)]
        return res, (d[0], d[1])

    h0 = guard.health().snapshot()
    res, _ = serve(first_rid, first)
    check(res.digest == clean_digest,
          "ladder: the first request differs from the clean replay")
    levels, ladder = [], {}
    with fault.inject(fault.FaultPlan(rate=1.0, sites=("plan",))):
        for rid, sc in scenes[1:3]:
            res, _ = serve(rid, sc)
            check(res.status == "isolated", f"ladder: {rid} {res.status}")
            levels.append(eng.level)
        # level 2 keeps the kernels on the card: flagged, bit-equal
        res, ln = serve(first_rid + "-level2", first)
        check(res.status == "completed" and res.degraded and
              eng.level == 2, f"ladder: level-2 request {res.status} "
              f"degraded={res.degraded} level={eng.level}")
        check((ln == repeat or dev.type != "cuda")
              and res.digest == clean_digest,
              f"ladder: level-2 request launched (kernel 1, kernel 2) "
              f"{ln}, want {repeat}, bit-equal to the clean replay")
        ladder["level2"] = {"launches": ln, "bit_equal": True}
        res, _ = serve(scenes[3][0], scenes[3][1])
        check(res.status == "isolated" and eng.level == 3,
              f"ladder: {res.status} at level {eng.level}, want 3")
        levels.append(eng.level)
        res, ln = serve(first_rid + "-level3", first)
        check(res.status == "shed" and res.reason == admission.SHED_OVERLOAD
              and ln == (0, 0), f"ladder: level 3 served {res.status}")
    for _ in range(5):
        eng.step()
        levels.append(eng.level)
    check(levels == [1, 2, 3, 2, 2, 1, 1, 0],
          f"ladder: levels {levels}")
    res, ln = serve(first_rid + "-level0", first)
    check(res.status == "completed" and not res.degraded
          and res.digest == clean_digest,
          "ladder: back at level 0 the logits differ from the clean replay")
    if dev.type == "cuda":
        check(ln == repeat, f"ladder: level-0 request launched {ln}")
    # serve.compile: the engine's one entry, made at its first request
    want = {"admit.ok": 7, "fault.plan": 6, "serve.isolated": 3,
            "serve.compile": 1,
            "serve.completed": 3, "serve.degraded": 1, "serve.shed": 1,
            "admit.shed.overload": 1, "serve.degrade.enter": 3,
            "serve.degrade.level1": 1, "serve.degrade.level2": 1,
            "serve.degrade.level3": 1, "serve.degrade.exit": 3}
    got = _no_validate(guard.health().delta(h0))
    check(got == want, f"ladder: health {got}, want {want}")
    ladder["levels"] = levels
    ladder["health"] = got

    # -- the fallback chain: empty on the card, flag or no flag, so a
    # persistent kernel fault never serves the plain version
    fb = {}
    env = {k: os.environ.get(k) for k in ("REPRO_GUARD_FALLBACK",
                                          "REPRO_GUARD_COOLDOWN")}
    try:
        os.environ["REPRO_GUARD_FALLBACK"] = "1"
        os.environ["REPRO_GUARD_COOLDOWN"] = str(CHAOS_COOLDOWN)
        h0 = guard.health().snapshot()
        # two failed tries quarantine the stem's kernel for two calls: the
        # engine's retry of this request takes the first and raises, and
        # the next request's first try the second, its retry the kernel
        with fault.inject(fault.FaultPlan(schedule={"gemm": [0, 1]})):
            res, ln = serve(first_rid + "-fallback", first)
        check(res.status == "isolated" and ln == (0, 0),
              f"fallback on: {res.status}, launches {ln}, want isolated "
              f"and (0, 0)")
        for i in range(2):
            res, ln = serve(f"{first_rid}-cooldown-{i}", first)
            check(res.status == "completed" and res.digest == clean_digest
                  and (ln == repeat or dev.type != "cuda"),
                  f"cooldown {i}: {res.status}, launches {ln}, bit-equal "
                  f"{res.digest == clean_digest}")
        got = _no_validate(guard.health().delta(h0))
        want = {"admit.ok": 3, "fault.gemm": 2, "fallback.error.gemm": 2,
                "quarantine.enter.gemm": 1,
                "quarantine.skip.gemm": CHAOS_COOLDOWN,
                "serve.isolated": 1, "serve.exec_retry": 1,
                "serve.completed": 2, "serve.degraded": 2,
                "serve.degrade.enter": 1, "serve.degrade.level1": 1,
                "serve.degrade.exit": 1}
        check(got == want, f"fallback on: health {got}, want {want}")
        fb["on"] = got
        del os.environ["REPRO_GUARD_FALLBACK"]
        h0 = guard.health().snapshot()
        with fault.inject(fault.FaultPlan(schedule={"gemm": [0, 1]})):
            res, ln = serve(first_rid + "-nofallback", first)
        got = _no_validate(guard.health().delta(h0))
        want = {"admit.ok": 1, "fault.gemm": 2, "serve.isolated": 1,
                "serve.degrade.enter": 1, "serve.degrade.level1": 1}
        check(res.status == "isolated" and got == want and ln == (0, 0),
              f"fallback off: {res.status}, health {got}, launches {ln}")
        fb["off"] = got
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counts = _counts()
    del eng, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    emit(phase="chaos", config=cfg.name, bucket=BUCKET,
         requests=len(subs), schedule=schedule,
         clean={"stats": {k: v for k, v in clean["stats"].items()
                          if k != "cache"},
                "health": _no_validate(clean["health"]),
                "launches": clean["launches"]},
         faulted={"stats": {k: v for k, v in faulted["stats"].items()
                            if k != "cache"},
                  "health": _no_validate(faulted["health"]),
                  "launches": faulted["launches"]},
         ladder=ladder, fallback=fb,
         seconds=time.perf_counter() - t_phase)
    return {"octent_query": counts[0], "spconv_gemm_fused": counts[1]}


# ---------------------------------------------------------------------------
# Phase restart: SIGKILL a persisted serving worker, restart it
# ---------------------------------------------------------------------------

def _device_busy(fn, iters: int):
    """Device time of one call of ``fn`` under ``torch.profiler``: the sum
    of its device ops over ``iters`` calls, after a warm-up call, divided
    by ``iters``; the device ops a call, and the rows of
    ``_profile_rows``. The profile is taken again until two agree on the
    number of device ops (a trace that lost events reads short), at most
    three times; ``consistent`` says whether two agreed, else the fullest
    trace is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = _profile_rows(prof)
        rec = {"device_ms": sum(r[1] for r in rows) / iters,
               "device_ops": sum(r[2] for r in rows) / iters, "rows": rows}
        if seen and rec["device_ops"] == seen[-1]["device_ops"]:
            return {**rec, "consistent": True}
        seen.append(rec)
    return {**max(seen, key=lambda r: r["device_ops"]), "consistent": False}


def _paper_search(dev, name, vb, probe):
    """Fig. 9(a) on one workload: kernel 1 (its table build included), the
    dense table (``impl="dense"``, ``max_blocks`` the row count, as the
    reference's benchmark sets it), the sorted search where its key fits
    and the serial host hash (once), every kmap bit-equal to the hash's;
    each call's time back to back (``ms``: CUDA events around calls that
    the host may not queue as fast as the card runs them, so it is the
    host's pace where that is slower) and its device time
    (``device_ms``), peak memory, and the cycle model beside the measured
    ratios."""
    import torch
    from repro_torch.core import cyclemodel, mapsearch, morton
    from repro_torch.kernels.octent import ops as oct_ops
    c, b, v = (torch.as_tensor(a, device=dev) for a in (vb.coords, vb.batch,
                                                        vb.valid))
    rows, n_vox = c.shape[0], int(vb.valid.sum())
    offs = torch.as_tensor(morton.subm3_offsets(), device=dev)
    t0 = time.perf_counter()
    host = mapsearch.build_kmap_hash(vb.coords, vb.batch, vb.valid,
                                     morton.subm3_offsets())
    hash_ms = (time.perf_counter() - t0) * 1e3
    # the narrowest grid holding the scene: the sorted key fits it or not
    gb = max(int(vb.coords.max()) // 16, 1).bit_length()
    runs = {"kernel": lambda: oct_ops.build_kmap(c, b, v, max_blocks=rows)[0],
            "dense": lambda: oct_ops.build_kmap(c, b, v, max_blocks=rows,
                                                impl="dense")[0]}
    if mapsearch.sorted_key_fits(gb, 4):
        runs["sorted"] = lambda: mapsearch.build_kmap_sorted(
            c, b, v, offs, grid_bits=gb)
    rec = {"workload": name, "rows": rows, "voxels": n_vox, "grid_bits": gb,
           "hash_ms": hash_ms, "sorted_key_fits": "sorted" in runs}
    kmaps = {}
    for method, fn in runs.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kmaps[method] = fn()
        torch.cuda.synchronize()
        check(np.array_equal(kmaps[method].cpu().numpy(), host),
              f"{name}: the {method} kmap differs from the host hash's")
        rec[f"{method}_peak_mb"] = (torch.cuda.max_memory_allocated()
                                    - base) / 2 ** 20
        rec[f"{method}_ms"] = time_ms(fn, PAPER_SEARCH_ITERS)
        busy = _device_busy(fn, PAPER_SEARCH_ITERS)
        for key in ("device_ms", "device_ops", "consistent"):
            rec[f"{method}_{key}"] = busy[key]
    rec["dense_table_mb"] = rows * morton.TABLE_SIZE * 4 / 2 ** 20
    for method in runs:
        if method != "kernel":
            for key in ("ms", "device_ms"):
                rec[f"{method}_over_kernel_{key}"] = rec[f"{method}_{key}"] \
                    / rec[f"kernel_{key}"]
    rec["hash_over_kernel_ms"] = hash_ms / rec["kernel_ms"]
    rec["hash_over_kernel_device_ms"] = hash_ms / rec["kernel_device_ms"]
    lat = cyclemodel.search_cycles(n_vox, probe_factor=probe) \
        if probe is not None else None
    if lat is not None:
        rec["cycle_model"] = {"probe_factor": probe,
                              "algo_saving": lat.serial_algo_saving,
                              "arch_saving": lat.parallel_arch_saving,
                              "total_speedup": lat.total_speedup}
    emit(phase="paper.search", **rec)
    return rec, kmaps["kernel"]


def _kill_structure(feats, tiles, bk, stride=4):
    """``benchmarks/sparsity_saving.py``'s dead regions: zero the rows
    gathered by every ``stride``-th geometry-live tile (a dead spatial
    region) and, on the next one's other rows, every Cin block but the
    first (dead feature blocks)."""
    feats = np.array(feats)
    gidx = tiles.gather_idx.reshape(tiles.n_tiles, tiles.bm).cpu().numpy()
    sval = tiles.slot_valid.reshape(tiles.n_tiles, tiles.bm).cpu().numpy()
    live = np.flatnonzero(tiles.tile_nz.cpu().numpy())
    kill_rows = np.unique(np.concatenate(
        [gidx[t][sval[t]] for t in live[::stride]]))
    feats[kill_rows] = 0.0
    for t in live[1::stride]:
        rows = gidx[t][sval[t]]
        feats[rows[~np.isin(rows, kill_rows)], bk:] = 0.0
    return feats


def _split_counts(tiles, tile_nz, n_out, c_out, dev):
    """Kernel 2's device-side work plan for these liveness flags:
    ``(work, blk)`` from the planning kernel, as the wrapper makes it."""
    from repro_torch.kernels.spconv_gemm import kernel as sg_kernel
    n_blocks = -(-n_out // tiles.bo)
    n_ctas, busy_min = sg_kernel.plan_shape(
        n_blocks, -(-c_out // 128), sg_kernel.sm_count(dev),
        sg_kernel.MAX_SPLITS)
    return sg_kernel.split_plan(tiles.tile_ob, tile_nz, n_blocks=n_blocks,
                                n_ctas=n_ctas, busy_min=busy_min,
                                max_splits=sg_kernel.MAX_SPLITS)


def _paper_spac(dev, vb, st, plan, c_in):
    """Fig. 9(b) at one Cin on the Seg(i) plan: post-ReLU features (a
    seeded Subm3 through kernel 2, training BatchNorm, ReLU) with the
    benchmark's dead regions; the MAC grains read off the masks at the
    paper's 16-wide grain and at the kernel's Cin block; ``apply_tiles``
    through kernel 2 with SPAC on and off, timed and compared; the cycle
    model's compute cycles beside the measured saving."""
    import torch
    from repro_torch.core import cyclemodel, sparsity, spconv
    from repro_torch.kernels.spconv_gemm import ops as sg_ops
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, tiles = st.n_max, plan.tiles
    x = torch.randn((n, c_in), generator=gen, device=dev)
    st = st.replace_feats(torch.where(st.valid[:, None], x, 0.0))
    w0 = torch.randn((27, c_in, c_in), generator=gen, device=dev) \
        * (2.0 / (27 * c_in)) ** 0.5
    st = spconv.subm_conv3(st, w0, None, max_blocks=n, spac=False, plan=plan)
    ones, zeros = torch.ones(c_in, device=dev), torch.zeros(c_in, device=dev)
    st, _ = spconv.batch_norm(st, {"scale": ones, "bias": zeros,
                                   "mean": zeros, "var": ones},
                              training=True)
    f = _kill_structure(spconv.relu(st).feats.cpu().numpy(), tiles,
                        MAC_GRAIN)
    f[~vb.valid] = 0.0
    f = torch.as_tensor(f, device=dev)
    w = torch.randn((27, c_in, c_in), generator=gen, device=dev) * 0.05

    row_nz = sparsity.row_nonzero(f)
    c_out_pad = -(-c_in // 128) * 128

    def grains(bk):
        blk_nz = sparsity.row_block_nonzero(f, bk) & row_nz[:, None]
        live_tiles = sg_ops.tile_liveness(tiles, row_nz)
        return (int(tiles.tile_nz.sum()), int(live_tiles.sum()),
                int(sg_ops.tile_block_liveness(tiles, blk_nz).sum()),
                live_tiles)

    geo, live, blocks, live_tiles = grains(MAC_GRAIN)
    macs = {"macs_geo": geo * tiles.bm * c_in * c_out_pad,
            "macs_tile": live * tiles.bm * c_in * c_out_pad,
            "macs_block": blocks * tiles.bm * MAC_GRAIN * c_out_pad}
    check(macs["macs_block"] <= macs["macs_tile"] <= macs["macs_geo"],
          f"spac cin {c_in}: MAC grains out of order {macs}")
    reduction = {"tile": 1 - macs["macs_tile"] / macs["macs_geo"],
                 "block": 1 - macs["macs_block"] / macs["macs_geo"]}
    check(reduction["block"] >= MAC_REDUCTION_FLOOR,
          f"spac cin {c_in}: block-grain MAC reduction "
          f"{reduction['block']} < {MAC_REDUCTION_FLOOR}")
    # the kernel splits Cin only into blocks of a multiple of 32
    kbk = 32 if c_in % 32 == 0 and c_in > 32 else sg_ops.pick_bk(c_in)
    _, _, kblocks, _ = grains(kbk)

    def on():
        return sg_ops.apply_tiles(f, w, tiles, n_out=n, row_nz=row_nz,
                                  bk=kbk)

    def off():
        return sg_ops.apply_tiles(f, w, tiles, n_out=n, bk=kbk)

    out_on, out_off = on(), off()
    plain = sg_ops.apply_tiles(f, w, tiles, n_out=n, bk=kbk, impl="ref")
    torch.cuda.synchronize()
    scale = float(plain.abs().max())
    err_plain = float((out_on - plain).abs().max())
    check(err_plain <= TOL_KERNEL * scale,
          f"spac cin {c_in}: kernel vs plain {err_plain} > {TOL_KERNEL} * "
          f"{scale}")
    plan_on = _split_counts(tiles, live_tiles, n, c_in, dev)
    plan_off = _split_counts(tiles, tiles.tile_nz, n, c_in, dev)
    same_split = all(torch.equal(a, b) for a, b in zip(plan_on, plan_off))
    err = float((out_on - out_off).abs().max())
    if same_split:
        check(torch.equal(out_on, out_off),
              f"spac cin {c_in}: SPAC on and off share a split plan but "
              f"differ by {err}")
    else:
        check(err <= TOL_KERNEL * scale,
              f"spac cin {c_in}: SPAC on vs off {err} > {TOL_KERNEL} * "
              f"{scale}")
    on_ms, off_ms = time_ms(on, 10), time_ms(off, 10)
    dev_ms = {}
    for tag, fn in (("on", on), ("off", off)):
        busy = _device_busy(fn, 10)
        dev_ms[tag] = {"device_ms": busy["device_ms"],
                       "device_ops": busy["device_ops"],
                       "consistent": busy["consistent"],
                       "fused_kernel_ms": sum(
                           r[1] for r in busy["rows"]
                           if "spconv_gemm_fused_kernel" in r[0]) / 10}
    stats = sparsity.sparsity_stats(f, plan.kmap, c_in)
    n_maps = int((plan.kmap >= 0).sum())
    vs = float(stats.element_sparsity)
    lat = cyclemodel.layer_latency(int(vb.valid.sum()), n_maps, c_in, c_in,
                                   vs)
    model_saving = 1 - cyclemodel.compute_cycles(n_maps, c_in, c_in, vs) \
        / cyclemodel.dense_compute_cycles(n_maps, c_in, c_in)
    rec = {"c_in": c_in, "bm": tiles.bm, "mac_grain": MAC_GRAIN,
           "kernel_bk": kbk, "tiles_geo": geo, "tiles_live": live,
           "blocks_live": blocks, "kernel_blocks_live": kblocks, **macs,
           "mac_reduction": reduction, "value_sparsity": vs,
           "row_elision": float(stats.map_elision), "n_maps": n_maps,
           "spac_on_ms": on_ms, "spac_off_ms": off_ms,
           "measured_saving": 1 - on_ms / off_ms, "device": dev_ms,
           "measured_device_saving": 1 - dev_ms["on"]["device_ms"]
           / dev_ms["off"]["device_ms"],
           "measured_kernel_saving": 1 - dev_ms["on"]["fused_kernel_ms"]
           / dev_ms["off"]["fused_kernel_ms"],
           "split_blocks": {"on": int((plan_on[1][:, 1] > 1).sum()),
                            "off": int((plan_off[1][:, 1] > 1).sum())},
           "same_split_plan": same_split, "on_vs_off_max_abs": err,
           "kernel_vs_plain_max_abs": err_plain, "max_abs_plain": scale,
           "model": {"compute_saving": model_saving,
                     "spac_saving": 1 - lat.fine_spac / lat.fine,
                     "pipeline_gain": lat.coarse / lat.fine}}
    emit(phase="paper.spac", **rec)
    return rec


def _paper_forwards(dev, cfg, indoor, lidar):
    """MinkUNet-large through kernel 2 with ``map_method="sorted"`` (at
    ``grid_bits`` 5, the sorted key's widest grid; the indoor scene fits
    it) against the octree forward at the same settings, and a
    ``search_impl="dense"`` forward at LARGE's own settings on the LiDAR
    scene against the kernel-1 forward: every kmap and the logits
    bit-equal, 25 kernel-2 launches a forward, kernel 1 only in the octree
    forwards. Returns the kernel-1 and kernel-2 launches of the four
    forwards."""
    import torch
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.models import minkunet
    n_layers, n_levels = _n_layers(cfg), len(cfg.enc) + 1
    launches, rec = [0, 0], {}

    def run(tag, c, sc, **kw):
        st = SparseTensor(*(torch.as_tensor(a, device=dev) for a in (
            sc.coords, sc.batch, sc.valid, sc.feats)))
        model = _seeded_model(c, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        plans = minkunet.build_plans(st.coords, st.batch, st.valid, c,
                                     device=dev, **kw)
        torch.cuda.synchronize()
        plan_ms = (time.perf_counter() - t0) * 1e3
        logits = minkunet.forward(model, st, plans=plans)
        torch.cuda.synchronize()
        d = _counts()
        launches[0] += d[0]
        launches[1] += d[1]
        tabled = c.map_method == "octree" and kw.get("search_impl") is None
        check((d[0], d[1], d[3]) == (n_levels if tabled else 0, n_layers,
                                     2 * len(cfg.enc) + 1),
              f"{tag}: (octent, gemm, searches) = {(d[0], d[1], d[3])}")
        check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logit")
        rec[tag] = {"voxels": int(sc.valid.sum()), "plan_ms": plan_ms,
                    "octent_launches": d[0], "gemm_launches": d[1],
                    "searches": d[3],
                    "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
        return plans, logits

    check(int(indoor.coords.max()) < 16 << PAPER_GRID_BITS,
          "the indoor scene leaves the sorted search's grid")
    small = dataclasses.replace(cfg, grid_bits=PAPER_GRID_BITS)
    pairs = [("octree_gb5", small, "sorted_gb5",
              dataclasses.replace(small, map_method="sorted"), {}, indoor),
             ("kernel", cfg, "dense", cfg, {"search_impl": "dense"}, lidar)]
    for base_tag, base_cfg, tag, other_cfg, kw, sc in pairs:
        want_plans, want = run(base_tag, base_cfg, sc)
        plans, got = run(tag, other_cfg, sc, **kw)
        for i, (p, q) in enumerate(zip(plans.subm, want_plans.subm)):
            check(torch.equal(p.kmap, q.kmap),
                  f"{tag}: the Subm3 kmap at res {i} differs from {base_tag}")
        for kind in ("down", "up"):
            for p, q in zip(getattr(plans, kind), getattr(want_plans, kind)):
                check(torch.equal(p.kmap, q.kmap),
                      f"{tag}: a {kind} kmap differs from {base_tag}")
        check(torch.equal(got, want),
              f"{tag}: logits differ from the {base_tag} forward by "
              f"{float((got - want).abs().max())}")
        del plans, want_plans, got, want
        torch.cuda.empty_cache()
    emit(phase="paper.forward", config=cfg.name, bucket=BUCKET,
         logits_bit_equal=True, **rec)
    return launches


def _paper_replan(dev):
    """``chaos``'s replan gate on the card: the demo at ``max_blocks=4``
    replans every Subm3 build and reaches the default run's digest, and a
    second default run reaches it too, with no determinism switch set:
    every sum of the step runs in a fixed order."""
    from repro_torch.launch import train
    from repro_torch.runtime import guard
    runs = {}
    for tag, mb in (("clean", None), ("again", None), ("tight", 4)):
        with guard.scoped_health():
            runs[tag] = train.run_spconv_demo(2, max_blocks=mb, seed=SEED,
                                              device=dev)
    tight, clean = runs["tight"], runs["clean"]
    rec = {"max_blocks": 4, "clean_digest": clean["state_digest"],
           "replan_digest": tight["state_digest"],
           "bit_identical": tight["state_digest"] == clean["state_digest"],
           "clean_runs_equal":
               runs["again"]["state_digest"] == clean["state_digest"],
           "replan_overflow": tight["health"].get("replan.overflow", 0),
           "replan_recovered": tight["health"].get("replan.recovered", 0),
           "mapsearch_calls": tight["mapsearch_calls"],
           "clean_mapsearch_calls": clean["mapsearch_calls"]}
    emit(phase="paper.replan", **rec)
    check(rec["bit_identical"], "replan: the max_blocks=4 demo's digest "
          "differs from the default run's")
    check(rec["clean_runs_equal"], "replan: two default demo runs reach "
          "different digests")
    check(rec["replan_overflow"] > 0 and rec["replan_recovered"] > 0,
          f"replan: no overflow or no recovery: {tight['health']}")


def phase_paper(dev, cfg, scenes):
    """The paper's own measurements on the card: Fig. 9(a) on the four
    workloads of ``benchmarks/common.py`` and phase serve's LiDAR scene
    (``_paper_search``), Fig. 9(b) on Seg(i) at Cin 16-128
    (``_paper_spac``), Fig. 8(a)/9(c) from kernel 1's Seg(o) kmap and the
    tiers of a Subm3 plan at the serving bucket, the sorted and dense
    MinkUNet-large forwards (``_paper_forwards``) and the replan gate.
    Returns the kernel-1 and kernel-2 launches of its forwards."""
    import torch
    from repro_torch.core import caching, plan as planlib, rulebook
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.data import pointcloud
    from repro_torch.kernels.octent import ops as oct_ops
    from repro_torch.runtime import feature_cache
    t0 = time.perf_counter()
    searches, kmaps, loads = [], {}, {}
    for name, (kind, rows, batch) in PAPER_WORKLOADS.items():
        loads[name] = pointcloud.make_batch(np.random.default_rng(SEED), kind,
                                            batch, rows)
        rec, kmaps[name] = _paper_search(dev, name, loads[name],
                                         PAPER_PROBE[name])
        searches.append(rec)
    by_rid = dict(scenes)
    rec, _ = _paper_search(dev, "serve:lidar-0", by_rid["lidar-0"], None)
    searches.append(rec)

    seg_i = loads["Seg(i)"]
    st = SparseTensor(*(torch.as_tensor(a, device=dev) for a in (
        seg_i.coords, seg_i.batch, seg_i.valid, seg_i.feats)))
    plan = planlib.subm3_plan(st.coords, st.batch, st.valid,
                              max_blocks=st.n_max)
    spac = [_paper_spac(dev, seg_i, st, plan, c_in) for c_in in PAPER_CINS]
    del plan

    counts = rulebook.tap_counts(kmaps["Seg(o)"]).cpu().numpy()
    parts = {"center": 0, "mid": 0, "up": 0, "down": 0}
    for t, n in enumerate(counts):
        parts[caching.tap_partition(t)] += int(n)
    dz0 = (parts["center"] + parts["mid"]) / max(int(counts.sum()), 1)
    savings = {c_in: caching.saving(counts, c_in, c_in, CACHE_CAPACITY)
               for c_in in (16, 48, 96, 128)}
    lidar = by_rid["lidar-0"]
    c, b, v = (torch.as_tensor(a, device=dev) for a in (
        lidar.coords, lidar.batch, lidar.valid))
    qt = oct_ops.build_query_table(c, b, v, max_blocks=BUCKET)
    plan = planlib.subm3_plan(c, b, v, max_blocks=BUCKET)
    tiers = {"plan": plan.residency,
             "plan_and_table": feature_cache.plan_tier_bytes(plan, qt)}
    emit(phase="paper.caching", workload="Seg(o)",
         tap_partitions=parts, delta_z0_share=dz0,
         paper_delta_z0_band=[0.45, 0.83], capacity_bytes=CACHE_CAPACITY,
         saving_by_cin=savings, subm3_tiers_at_bucket=tiers, bucket=BUCKET)
    check(0.0 < dz0 <= 1.0, f"caching: delta_z = 0 share {dz0}")
    del plan, qt, kmaps
    torch.cuda.empty_cache()

    launches = _paper_forwards(dev, cfg, by_rid["indoor-0"], lidar)
    _paper_replan(dev)
    emit(phase="paper", seconds=time.perf_counter() - t0,
         workloads=[r["workload"] for r in searches],
         spac_cins=[r["c_in"] for r in spac])
    return launches


def _serve_scenes(rows: int = BUCKET):
    """The four scenes of phase serve at ``rows`` rows, made from SEED
    (two LiDAR scenes at LIDAR_VOXEL, two indoor ones)."""
    from repro_torch.launch.spconv_sharded import serve_scenes
    return serve_scenes(rows, SEED, LIDAR_VOXEL)


def _routing_errors(sqt, pranks, partials, kmap, coords, batch, valid,
                    offs, grid_bits):
    """Queries whose stages were not answered by exactly one rank, the
    owner of ``bounds`` (stage 1) or of ``tbounds`` (stage 2)."""
    from repro_torch.core import morton
    from repro_torch.kernels.octent import sharded
    from repro_torch.kernels.octent.ref import encode_queries
    _, bkey, bank, row = encode_queries(coords, batch, valid, offs,
                                        grid_bits=grid_bits)
    hit, ans1, ans2 = kmap >= 0, pranks >= 0, partials >= 0
    errs = int((ans2.sum(0) != hit).sum()) + int((ans1.sum(0) > 1).sum())
    found = ans1.any(0)
    own1 = sharded.owner_shard(sqt.bounds, bkey)
    errs += int((ans1.int().argmax(0)[found] != own1[found]).sum())
    key2 = (pranks.max(0).values * morton.TABLE_SIZE
            + bank * morton.BANK_ROWS + row)
    own2 = sharded.owner_shard(sqt.tbounds, key2)
    return errs + int((ans2.int().argmax(0)[hit] != own2[hit]).sum())


def _sharded_rank(rank, world, n_scenes, meshes, device, rows):
    """One rank of phase sharded (``spawn_ranks`` starts ``world`` of
    them): MinkUNet-large on ``n_scenes`` serve scenes at ``rows`` rows,
    first meshless (kernel 1's plans, the kmaps and logits to hold), then
    under each mesh of ``meshes``: ``forward_multicloud`` with ``auto``
    search (sharded on a 2-way or wider mesh, kernel 1 on a 1-way one,
    where the sharded search is also forced), the replayed plans, every
    Subm3 kmap and the logits bit-equal, the flat searches and 25
    kernel-2 launches a cloud, the slices each rank holds and the routing
    of every query at the finest level of the first scene. On a 4-rank
    world, a scene planned under a 2-rank mesh misses the cache under the
    same shape over the other two ranks. Then, ungated, the sharded
    search's and its merges' ms and kernel 1's path ms in this process.
    Returns the launches of kernels 1 and 2 over the gated work."""
    import hashlib
    import torch
    import torch.distributed as dist
    from repro_torch.core import morton
    from repro_torch.core import plan as planlib
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.kernels.octent import ops as oct_ops
    from repro_torch.kernels.octent import sharded
    from repro_torch.kernels.octent.kernel import LANE
    from repro_torch.launch.spconv_sharded import make_mesh
    from repro_torch.models import minkunet
    from repro_torch.runtime import sharding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cfg = minkunet.LARGE
    model = _seeded_model(cfg, dev)
    scenes = _serve_scenes(rows)[:n_scenes]
    clouds = [SparseTensor(*(torch.as_tensor(a, device=dev) for a in (
        sc.coords, sc.batch, sc.valid, sc.feats))) for _, sc in scenes]
    n_cl, per_cloud, n_layers = len(clouds), 2 * len(cfg.enc) + 1, \
        _n_layers(cfg)
    offs = torch.as_tensor(morton.subm3_offsets(), device=dev)
    # every mesh first: a mesh's groups are created by all ranks together
    built = [(tuple(shape), tuple(names), make_mesh(shape, names, device))
             for shape, names in meshes]
    others = [make_mesh((2,), ("data",), device, ranks=r)
              for r in ((0, 1), (2, 3))] if world == 4 else []
    launches = [0, 0]

    def segment():
        c = _counts()
        launches[0] += c[0]
        launches[1] += c[1]
        _reset_counts()
        return c

    def plans_of(cache=None, **kw):
        return [minkunet.build_plans(st.coords, st.batch, st.valid, cfg,
                                     cache=cache, device=dev, **kw)
                for st in clouds]

    def same_kmaps(plans, label):
        for i, (p, q) in enumerate(zip(plans, ref_plans)):
            for r, (a, b) in enumerate(zip(p.subm, q.subm)):
                check(torch.equal(a.kmap, b.kmap),
                      f"sharded {label}: scene {i} level {r} kmap differs "
                      f"from kernel 1's on rank {rank}")

    _reset_counts()
    ref_plans = plans_of(search_impl="kernel")
    ref_logits = minkunet.forward_multicloud(model, clouds, plans=ref_plans)
    c = segment()
    on_card = dev.type == "cuda"    # the plain versions launch nothing
    check(not on_card or (c[0] == n_cl * (len(cfg.enc) + 1)
                          and c[1] == n_cl * n_layers),
          f"sharded: meshless launches {c[:2]}")
    out = {"rank": rank, "rids": [rid for rid, _ in scenes], "meshes": []}
    for shape, names, mesh in built:
        label = "x".join(f"{a}{e}" for a, e in zip(names, shape))
        s_n = sharding.blockkey_shards(mesh)
        cache = planlib.PlanCache(capacity=64)
        with sharding.set_mesh(mesh):
            impl = oct_ops.search_impl()
            mode = dist.get_backend(mesh.get_group(0))
            outs = minkunet.forward_multicloud(model, clouds, cache=cache)
            c = segment()
            plans = plans_of(cache)
            replay = segment()
        check(impl == ("sharded" if s_n > 1 else "kernel"),
              f"sharded {label}: auto resolved to {impl}")
        check(c[3] == per_cloud * n_cl and replay[3] == 0,
              f"sharded {label}: {c[3]} searches, {replay[3]} on replay")
        check(not on_card or (c[1] == n_layers * n_cl and c[0] == (
            0 if s_n > 1 else n_cl * (len(cfg.enc) + 1))),
            f"sharded {label}: launches {c[:2]}")
        check(all(torch.equal(a, b) for a, b in zip(outs, ref_logits)),
              f"sharded {label}: logits differ from the meshless forward")
        same_kmaps(plans, label)
        rec = {"mesh": label, "impl": impl, "collective": mode,
               "searches": c[3], "launches": list(c[:2]),
               "digests": [hashlib.sha256(o.cpu().numpy().tobytes())
                           .hexdigest() for o in outs]}
        if s_n == 1:
            with sharding.set_mesh(mesh):
                same_kmaps(plans_of(search_impl="sharded"), label +
                           " forced")
            segment()

        st = clouds[0]
        n = st.coords.shape[0]
        with sharding.set_mesh(mesh):
            sqt = sharded.build_query_table_sharded(
                st.coords, st.batch, st.valid, max_blocks=n)
            km, nb, pr, pa = sharded.octent_query_sharded(
                st.coords, st.batch, st.valid, offs, sqt,
                return_partials=True)
        mb = -(-n // s_n) * s_n
        n_pad = -(-(-(-n // LANE) * LANE) // (s_n * LANE)) * s_n * LANE
        check((sqt.ublocks.numel(), sqt.tkey.numel(), sqt.tval.numel())
              == (mb // s_n, n_pad // s_n, n_pad // s_n),
              f"sharded {label}: rank {rank} holds {sqt.ublocks.numel()} "
              f"directory entries and {sqt.tkey.numel()} slots")
        check(torch.equal(km, ref_plans[0].subm[0].kmap),
              f"sharded {label}: the table's kmap differs")
        errs = _routing_errors(sqt, pr, pa, km, st.coords, st.batch,
                               st.valid, offs, cfg.grid_bits)
        check(errs == 0, f"sharded {label}: {errs} misrouted answers")
        rec.update(shard=sqt.shard, dir_entries=sqt.ublocks.numel(),
                   slots=sqt.tkey.numel(), n_blocks=int(nb),
                   bytes_per_rank=4 * (sqt.ublocks.numel()
                                       + 2 * sqt.tkey.numel()),
                   queries=km.numel(), hits=int((km >= 0).sum()))
        del pr, pa
        segment()
        if on_card:
            grp = sharded.shard_group(mesh, sharding.blockkey_axes(mesh))
            t = km.clone()
            with sharding.set_mesh(mesh):
                rec["sharded_ms"] = time_ms(lambda: sharded.build_kmap_sharded(
                    st.coords, st.batch, st.valid, max_blocks=n),
                    SHARDED_ITERS)
            rec["merges_ms"] = 2 * time_ms(
                lambda: sharded.all_reduce_max(t, grp.group), SHARDED_ITERS)
            rec["kernel1_ms"] = time_ms(lambda: oct_ops.build_kmap(
                st.coords, st.batch, st.valid, max_blocks=n,
                impl="kernel"), SHARDED_ITERS)
            _reset_counts()
        out["meshes"].append(rec)

    if others:
        cache = planlib.PlanCache(capacity=64)
        st = clouds[0]
        seen = []
        for m in (others[0], others[1], others[0]):
            with sharding.set_mesh(m):
                minkunet.build_plans(st.coords, st.batch, st.valid, cfg,
                                     cache=cache, search_impl="kernel",
                                     device=dev)
            seen.append((cache.misses, cache.hits, segment()[3]))
        fps = [sharding.mesh_fingerprint(m) for m in others]
        check(fps[0] != fps[1] and seen[1] == (2 * seen[0][0], 0,
                                               per_cloud)
              and seen[2] == (seen[1][0], seen[0][0], 0),
              f"sharded: same-shape meshes over other ranks: {seen}")
        out["other_ranks"] = {"fingerprints": fps, "misses_hits": seen}
    out["launches"] = launches
    return out


def phase_sharded(serve_digests):
    """The sharded OCTENT search under ``torch.distributed`` meshes:
    ``spawn_ranks`` workers over :data:`SHARDED_WORLDS` (one NCCL rank;
    two and four ranks sharing the card over gloo), each
    :func:`_sharded_rank`, every rank's logits digests equal to phase
    serve's for the same scenes. The parent built the kernels: the workers
    only load them. Returns the launches of kernels 1 and 2 over the
    workers."""
    import os
    import shutil
    import tempfile
    from repro_torch.launch.spconv_sharded import spawn_ranks
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-sharded-")
    launches, worlds = [0, 0], []
    try:
        for world, backend, n_scenes, meshes in SHARDED_WORLDS:
            t0 = time.perf_counter()
            ranks = spawn_ranks(
                _sharded_rank, world, backend=backend,
                init_file=os.path.join(root, f"rendezvous-{world}"),
                args=(world, n_scenes, meshes, "cuda", BUCKET),
                timeout_s=SHARDED_TIMEOUT_S)
            for r in ranks:
                launches[0] += r["launches"][0]
                launches[1] += r["launches"][1]
                want = [serve_digests[rid] for rid in r["rids"]]
                check(all(m["digests"] == want for m in r["meshes"]),
                      f"sharded: rank {r['rank']} served other logits than "
                      f"phase serve")
            worlds.append({"world": world, "backend": backend,
                           "scenes": n_scenes,
                           "seconds": time.perf_counter() - t0,
                           "ranks": ranks})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(phase="sharded", bucket=BUCKET, launches=launches, worlds=worlds,
         seconds=time.perf_counter() - t_phase)
    return {"octent_query": launches[0], "spconv_gemm_fused": launches[1]}


def _close_params(got: dict, want: dict, start: dict) -> tuple:
    """The sharded step's parameters ``got`` (DTensors, gathered here: a
    collective every rank joins) against one device's ``want`` from the
    same ``start`` (both on the host). Returns (the max over tensors of
    max |got - want| / (atol + rtol |want|) at TOL_SHARDED_PARAMS, <= 1
    passing as ``assert_allclose``; the max over tensors of |dg - dw| /
    |dw|, the norms of the two steps' changes dg = got - start and dw =
    want - start). The first bound is wider than a whole AdamW step of
    LM_TRAIN_LR; the second fails a step whose gradients are zero or
    wrong."""
    import torch
    worst = update = 0.0
    for k, w in want.items():
        g = got[k].full_tensor().float()
        w = w.to(g.device).float()
        tol = TOL_SHARDED_PARAMS * (1 + w.abs())
        worst = max(worst, float(((g - w).abs() / tol).max()))
        z = start[k].to(g.device).float()
        dw = w - z
        update = max(update, float((g - w).norm())
                     / max(float(dw.norm()), 1e-30))
        del g, w, z, dw
    torch.cuda.empty_cache()
    return worst, update


def _lm_sharded_tinyllama(dev, mesh, rank, n_layers):
    """TinyLlama-1.1B (float32) at ``n_layers`` of its 22 under ``mesh``:
    one prefill of LM_BATCH x LM_PROMPT tokens and one
    ``make_train_step``, parameters placed by ``param_shardings``, against
    the single-device kernel path on the same card (rank 0 computes it
    first, the others wait)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import shardings
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as rs
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32",
                              n_layers=n_layers)
    model = api.build_model(cfg, device=dev)
    flat = dict(model.module(torch.Generator(dev).manual_seed(SEED))
                .state_dict())
    tokens, tb = _lm_batches(cfg, dev)
    opt_cfg = adamw.AdamWConfig(lr=LM_TRAIN_LR)
    step = make_train_step(model, opt_cfg)
    base = None
    if rank == 0:
        start = {k: v.cpu() for k, v in flat.items()}
        logits, _ = model.prefill(model.nest(flat), {"tokens": tokens},
                                  LM_PROMPT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (p1, _), m1 = step((flat, adamw.init(flat)), tb)
        torch.cuda.synchronize()
        base = {"logits": logits, "loss": float(m1["loss"]),
                "grad_norm": float(m1["grad_norm"]),
                "step_ms": (time.perf_counter() - t0) * 1e3,
                "params": {k: v.cpu() for k, v in p1.items()}}
        del p1, m1
        torch.cuda.empty_cache()
    dist.barrier()
    psh = shardings.param_shardings(flat, mesh)
    params = shardings.distribute(flat, psh)
    opt = adamw.init(flat)
    opt = shardings.distribute(opt, shardings.opt_state_shardings(opt, mesh))
    del flat
    db = shardings.distribute({"tokens": tokens}, shardings.batch_shardings(
        {"tokens": tokens}, mesh))
    dtb = shardings.distribute(tb, shardings.batch_shardings(tb, mesh))
    torch.cuda.empty_cache()
    with rs.set_mesh(mesh):
        model.prefill(model.nest(params), db, LM_PROMPT)     # warm-up
        torch.cuda.synchronize()
        fa_kernel.launches = 0
        t0 = time.perf_counter()
        logits, _ = model.prefill(model.nest(params), db, LM_PROMPT)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = fa_kernel.launches
        logits = logits.full_tensor()
        t0 = time.perf_counter()
        (p2, _), m2 = step((params, opt), dtb)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        train_launches = fa_kernel.launches - launches
    local_heads = tuple(params["layers.0.attn.wq"].to_local().shape)
    rec = {"n_layers": n_layers, "flash_launches_prefill": launches,
           "flash_launches_step": train_launches,
           "prefill_ms": prefill_ms, "step_ms": step_ms,
           "wq_local_shape": local_heads,
           "loss": float(m2["loss"].full_tensor()),
           "grad_norm": float(m2["grad_norm"].full_tensor())}
    if rank == 0:
        worst, update = _close_params(p2, base["params"], start)
        scale = float(base["logits"].abs().max())
        rec.update(
            logits_err=float((logits - base["logits"]).abs().max()),
            max_abs_logit=scale,
            loss_rel=abs(rec["loss"] - base["loss"]) / abs(base["loss"]),
            grad_norm_rel=abs(rec["grad_norm"] - base["grad_norm"])
            / base["grad_norm"], params_worst=worst, update_rel=update,
            single_step_ms=base["step_ms"])
    else:
        _gather_only(p2)
    return rec


def _lm_batches(cfg, dev):
    """The LM phases' batches: LM_BATCH x LM_PROMPT prompt tokens and the
    first LM_TRAIN_BATCH x LM_TRAIN_SEQ ``TokenStream`` training batch,
    from SEED, on ``dev``."""
    import torch
    from repro_torch.data.tokens import TokenStream
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)), dtype=torch.int32, device=dev)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in TokenStream(
        vocab=cfg.vocab, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
        seed=SEED).batch_at(0).items()}
    return tokens, tb


def _grad_rel(got, want) -> float:
    """|got - want| / |want| (norms, in float32 on the card)."""
    return float((got.float() - want.float()).norm()) / max(
        float(want.float().norm()), 1e-30)


def _lm_pipeline(dev, mesh, rank, cfg, n_micro):
    """TinyLlama (``cfg``) in S = 2 GPipe stages over ``mesh``'s ``pod``
    dimension, and data parallel over it with the int8-compressed
    gradient mean, each against this rank's own single-device kernel path
    (every rank builds the whole model from SEED, computes that path, then
    keeps only its stage's layers). Returns the record and the errors
    the phase gates."""
    import torch
    import torch.distributed._functional_collectives as funcol
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.train import lm_loss_and_grads
    from repro_torch.models import api, common, transformer
    from repro_torch.runtime import compress
    from repro_torch.runtime import pipeline as pp
    t_start = time.perf_counter()
    group = mesh.get_group("pod")
    s = mesh.size(0)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    model = api.build_model(cfg, device=dev)
    flat = dict(model.module(torch.Generator(dev).manual_seed(SEED))
                .state_dict())
    tokens, tb = _lm_batches(cfg, dev)
    # one device: the whole forward's logits, the loss and gradients
    with torch.no_grad():
        p = model.nest(flat)
        h, _, _ = transformer.forward_embeds(
            p, common.embed(p["embed"], tokens), cfg)
        want_logits = transformer.logits_fn(p, h, cfg)
        del p, h
    loss1, _, g1 = lm_loss_and_grads(model, flat, tb)
    loss1 = float(loss1)
    norm_1 = sum(float(v.float().square().sum()) for v in g1.values()) ** 0.5
    # data parallel over pod: this rank's rows, the compressed mean
    rows = tb["tokens"].shape[0] // s
    half = {k: v[rank * rows:(rank + 1) * rows] for k, v in tb.items()}
    sync()
    t0 = time.perf_counter()
    _, _, gh = lm_loss_and_grads(model, flat, half)
    sync()
    dp_grad_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mean = compress.grad_allreduce_compressed(gh, mesh, "pod")
    sync()
    dp_comp_ms = (time.perf_counter() - t0) * 1e3
    eps = float(torch.finfo(torch.float32).eps)
    q_worst = dp_single = 0.0
    for k in list(gh):
        exact = funcol.wait_tensor(funcol.all_reduce(gh[k], "sum", group)) / s
        scale = funcol.wait_tensor(funcol.all_reduce(
            compress.scale_of(gh[k]).reshape(1), "max", group))[0]
        # each rank's rounding is at most scale / 2; float32 rounding of
        # values up to 127 x scale on top
        bound = float(scale) * (0.5 + 4 * 127 * eps)
        q_worst = max(q_worst, float((mean[k] - exact).abs().max()) / bound)
        dp_single = max(dp_single, _grad_rel(exact, g1[k]))
        del exact, gh[k], mean[k]
    comp_bytes = sum(compress.payload_bytes(v) for v in flat.values())
    # the pipeline: this rank keeps its stage's layers and the shared ones
    params, keys = pp.lm_stage_params(flat, cfg.n_layers, mesh)
    own = set(keys.values())
    flat = {k: v for k, v in flat.items() if k in own}
    g1 = {k: v for k, v in g1.items() if k in own}
    del model
    if cuda:
        torch.cuda.empty_cache()
    fa_kernel.launches = 0
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = pp.lm_pipeline_logits(params, tokens, cfg, mesh=mesh,
                                       n_micro=n_micro)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    fwd_launches = fa_kernel.launches
    # a hand-off carries one microbatch's hidden states; the hand-back
    # all-reduces all M
    handoff = tokens.numel() // n_micro * cfg.d_model \
        * flat["embed"].element_size()
    logits_err = float((logits - want_logits).abs().max())
    max_abs = float(want_logits.abs().max())
    del logits, want_logits
    fa_kernel.launches = 0
    sync()
    t0 = time.perf_counter()
    loss_p, gp = pp.lm_pipeline_loss_and_grads(flat, tb, cfg, mesh=mesh,
                                                n_micro=n_micro)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_launches = fa_kernel.launches
    grad_worst = max(_grad_rel(gp[k], g1[k]) for k in gp)
    shared = [k for k in gp if not k.startswith("layers.")]
    sq_shared = sum(float(gp[k].float().square().sum()) for k in shared)
    sq_own = torch.tensor([sum(float(gp[k].float().square().sum())
                               for k in gp if k not in shared)],
                          dtype=torch.float64, device=dev)
    sq_layers = float(funcol.wait_tensor(funcol.all_reduce(
        sq_own, "sum", group))[0])
    norm_p = (sq_shared + sq_layers) ** 0.5
    rec = {"stage": pp.stage_index(mesh), "stages": s, "n_micro": n_micro,
           "layers_held": len({k.split(".")[1] for k in own
                               if k.startswith("layers.")}),
           "flash_launches_forward": fwd_launches,
           "flash_launches_step": step_launches,
           "prefill_ms": prefill_ms, "step_ms": step_ms,
           "bubble_share": pp.bubble_share(n_micro, s),
           "handoff_bytes": handoff,
           "handoff_bytes_forward": handoff * (n_micro + s - 1),
           "hand_back_bytes": handoff * n_micro,
           "logits_err": logits_err, "max_abs_logit": max_abs,
           "loss": float(loss_p), "single_loss": loss1,
           "loss_rel": abs(float(loss_p) - loss1) / abs(loss1),
           "grad_norm": norm_p, "single_grad_norm": norm_1,
           "grad_norm_rel": abs(norm_p - norm_1) / norm_1,
           "grad_worst": grad_worst,
           "dp": {"rows": rows, "grad_ms": dp_grad_ms,
                  "compressed_allreduce_ms": dp_comp_ms,
                  "compressed_bytes": comp_bytes,
                  "compressed_of_bound": q_worst,
                  "exact_vs_single": dp_single},
           "seconds": time.perf_counter() - t_start}
    return rec


def _gather_only(params: dict) -> None:
    """A non-zero rank's side of :func:`_close_params`' gathers."""
    for v in params.values():
        v.full_tensor()


def _lm_sharded_mixtral(dev, mesh, rank):
    """Mixtral-8x7B at MOE_SHARDED_LAYERS layers (float32) under ``mesh``:
    a prefill and the loss and gradients of one training batch through
    the ``einsum`` and the ``shard_map`` dispatch; the second run's
    routing pinned to the first's (``moe.top_k`` hooked), flips counted
    unpinned."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import shardings
    from repro_torch.launch.train import lm_loss_and_grads
    from repro_torch.models import api, moe
    from repro_torch.runtime import sharding as rs
    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32",
                              n_layers=MOE_SHARDED_LAYERS)
    model = api.build_model(cfg, device=dev)
    flat = dict(model.module(torch.Generator(dev).manual_seed(SEED))
                .state_dict())
    params = shardings.distribute(flat, shardings.param_shardings(flat,
                                                                  mesh))
    del flat
    torch.cuda.empty_cache()
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (MOE_SHARDED_BATCH, LM_PROMPT)), dtype=torch.int32,
        device=dev)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in TokenStream(
        vocab=cfg.vocab, batch=MOE_SHARDED_BATCH, seq=LM_TRAIN_SEQ,
        seed=SEED).batch_at(0).items()}
    db = shardings.distribute({"tokens": tokens}, shardings.batch_shardings(
        {"tokens": tokens}, mesh))
    dtb = shardings.distribute(tb, shardings.batch_shardings(tb, mesh))
    out, choices = {}, None
    for impl in ("einsum", "shard_map"):
        moe.set_moe_impl(impl)
        try:
            with rs.set_mesh(mesh):
                def run():
                    lg, _ = model.prefill(model.nest(params), db, LM_PROMPT)
                    loss, _, grads = lm_loss_and_grads(model, params, dtb)
                    return lg, loss, grads
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (lg, loss, grads), rec = _routing(run, pin=choices)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if choices is None:
                    choices = rec
                    flips = 0
                else:
                    (_, _, _), free = _routing(run)
                    flips = _flips(free, choices)
        finally:
            moe.set_moe_impl("einsum")
        out[impl] = {"logits": lg.full_tensor(),
                     "loss": float(loss.full_tensor()),
                     "grads": grads, "ms": ms, "flips": flips}
    a, b = out["einsum"], out["shard_map"]
    scale = float(a["logits"].abs().max())
    grad_worst = 0.0
    for k, g in a["grads"].items():
        ga, gb = g.full_tensor().float(), b["grads"][k].full_tensor().float()
        grad_worst = max(grad_worst, float((gb - ga).norm())
                         / max(float(ga.norm()), 1e-30))
    return {"logits_err": float((b["logits"] - a["logits"]).abs().max()),
            "max_abs_logit": scale,
            "loss": {i: out[i]["loss"] for i in out},
            "loss_rel": abs(b["loss"] - a["loss"]) / abs(a["loss"]),
            "grad_worst": grad_worst, "unpinned_flips": b["flips"],
            "ms": {i: out[i]["ms"] for i in out}}


def _host_staged(kinds):
    """A dispatch mode that runs the ``c10d_functional`` collectives of
    ``kinds`` (op-name prefixes) on CUDA tensors through host memory: the
    buffer copied to the host, the collective run there by gloo, the
    result copied back to the card, each staged call counted by kind.
    Only the gloo world of phase lm_sharded uses it, for the kinds phase
    ``gloo_probe`` saw gloo refuse on CUDA tensors in the same run (under
    torch 2.11.0+cu128: ``all_gather_into_tensor``, a SIGSEGV); NCCL takes
    one rank a card. Every other collective, and every op of the model,
    kernel 5 included, runs on the card."""
    import collections
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    class HostStaged(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.staged = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch.distributed.tensor import DTensor
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            name = getattr(func, "_opname", "")
            if getattr(func, "namespace", "") != "_c10d_functional" \
                    or not name.startswith(tuple(kinds)):
                return func(*args, **kwargs)
            dev = next((a.device for a in args if isinstance(a, torch.Tensor)
                        and a.is_cuda), None)
            if dev is None:
                return func(*args, **kwargs)
            self.staged[name] += 1
            out = func(*tree_map(lambda a: a.cpu() if isinstance(
                a, torch.Tensor) else a, args), **kwargs)
            out = tree_map(lambda o: torch.ops._c10d_functional.wait_tensor(o)
                           if isinstance(o, torch.Tensor) else o, out)
            return tree_map(lambda o: o.to(dev) if isinstance(
                o, torch.Tensor) else o, out)

    return HostStaged()


def _lm_sharded_rank(rank, world, mesh_shape, staged, n_layers):
    """One rank of phase lm_sharded: TinyLlama at ``n_layers`` under
    ``mesh_shape`` (``data`` x ``model``), and on a 2-way ``model`` mesh
    Mixtral, then phase lm_pipeline's work (:func:`_lm_pipeline`) over a
    ``pod`` mesh of the same ranks; the collectives of ``staged`` (kinds)
    through host memory (:func:`_host_staged`)."""
    import collections
    import contextlib
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.spconv_sharded import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = meshlib.make_test_mesh(*mesh_shape, device_type="cuda")
    mode = _host_staged(staged) if staged else contextlib.nullcontext()
    with mode:
        rec = {"rank": rank, "mesh": mesh_shape,
               "tinyllama": _lm_sharded_tinyllama(dev, mesh, rank,
                                                  n_layers)}
        torch.cuda.empty_cache()
        if mesh_shape[1] == 2:
            rec["mixtral"] = _lm_sharded_mixtral(dev, mesh, rank)
        rec["staged_collectives"] = dict(mode.staged) if staged else None
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if mesh_shape[1] == 2:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = collections.Counter(mode.staged) if staged else None
            pod = make_mesh((world,), ("pod",), device="cuda")
            cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
            pipe = _lm_pipeline(dev, pod, rank, cfg, LM_PIPE_MICRO)
            pipe["staged_collectives"] = dict(mode.staged - before) \
                if staged else None
            pipe["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rec["pipeline"] = pipe
    return rec


def _gloo_probe_rank(rank, kind):
    """The collectives of ``kind`` on CUDA tensors over gloo, as DTensor,
    the pipeline and the compressed all-reduce issue them
    (``_functional_collectives``): ``all_reduce`` as float32 SUM and MAX
    and int32 SUM, ``all_to_all_single`` with even splits and as
    ``permute_tensor`` (one peer's whole buffer)."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    group = dist.group.WORLD
    if kind == "all_reduce":
        outs = [funcol.all_reduce(x, "sum", group),
                funcol.all_reduce(x, "max", group),
                funcol.all_reduce(x.to(torch.int32), "sum", group)]
    elif kind == "all_gather_into_tensor":
        outs = [funcol.all_gather_tensor(x, 0, group)]
    elif kind == "reduce_scatter_tensor":
        outs = [funcol.reduce_scatter_tensor(x, "sum", 0, group)]
    else:
        outs = [funcol.all_to_all_single(x, None, None, group),
                funcol.permute_tensor(x, [1, 0], group)]
    return [funcol.wait_tensor(o).cpu().tolist() for o in outs]


def phase_gloo_probe():
    """Which collectives gloo runs on CUDA tensors on this torch: each
    kind in a 2-rank world of its own, the four at once (a crash kills
    only its world). Returns ``{kind: "ok" or the failure}``."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.spconv_sharded import spawn_ranks
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-gloo-probe-")

    def probe(kind):
        try:
            spawn_ranks(_gloo_probe_rank, 2, backend="gloo",
                        init_file=os.path.join(root, kind), args=(kind,),
                        timeout_s=120)
            return "ok"
        except Exception as e:                          # noqa: BLE001
            return f"{type(e).__name__}: {e}"[:200]

    kinds = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single")
    try:
        with ThreadPoolExecutor(len(kinds)) as pool:
            res = dict(zip(kinds, pool.map(probe, kinds)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(phase="gloo_probe", torch=torch.__version__, cuda_tensors=res,
         seconds=time.perf_counter() - t0)
    return res


def phase_lm_sharded(refused):
    """The LM's tensor sharding on the card: ``spawn_ranks`` workers over
    LM_SHARDED_WORLDS, each :func:`_lm_sharded_rank`; the gloo world
    stages the collective kinds of ``refused`` (phase ``gloo_probe``)
    through host memory. TinyLlama-1.1B's
    sharded prefill logits within TOL_SHARDED_LOGITS x max |logit| of the
    single-device kernel path, the step's loss within TOL_SHARDED_LOSS,
    its parameters within TOL_SHARDED_PARAMS, its gradient norm within
    TOL_SHARDED_GRAD_NORM and each tensor's change within
    TOL_SHARDED_UPDATE of one device's; kernel 5 launched on each
    rank's own heads, once a layer a prefill. Mixtral's ``shard_map``
    dispatch held to ``einsum``. The gloo world's ranks then run phase
    lm_pipeline (:func:`_lm_pipeline`, gated by
    :func:`_lm_pipeline_gates`). Returns kernel 5's launches on the
    sharded prefills and on the pipelined forward, each summed over the
    ranks. The gloo world's times are marked host-staged in the record: a
    departure from the rule that a refused collective fails the phase,
    which would leave this card no two-rank world (NCCL takes one rank a
    card)."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.spconv_sharded import spawn_ranks
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-lm-sharded-")
    worlds, launches, pipeline = [], 0, None
    try:
        for world, backend, shape, n_layers in LM_SHARDED_WORLDS:
            t0 = time.perf_counter()
            try:
                ranks = spawn_ranks(
                    _lm_sharded_rank, world, backend=backend,
                    init_file=os.path.join(root, f"rendezvous-{world}"),
                    args=(world, shape,
                          tuple(refused) if backend == "gloo" else (),
                          n_layers),
                    timeout_s=LM_SHARDED_TIMEOUT_S)
            except Exception as e:                      # noqa: BLE001
                check(False, f"lm_sharded: {world} {backend} rank(s) failed "
                      f"(torch {torch.__version__}): {e}")
            for r in ranks:
                t = r["tinyllama"]
                check(t["flash_launches_prefill"] == n_layers,
                      f"lm_sharded {shape} rank {r['rank']}: "
                      f"{t['flash_launches_prefill']} flash launches a "
                      f"prefill, want {n_layers}")
                launches += t["flash_launches_prefill"]
            t0r = ranks[0]["tinyllama"]
            check(t0r["logits_err"] <= TOL_SHARDED_LOGITS
                  * t0r["max_abs_logit"],
                  f"lm_sharded {shape}: logits {t0r['logits_err']} vs "
                  f"{TOL_SHARDED_LOGITS} x {t0r['max_abs_logit']}")
            check(t0r["loss_rel"] <= TOL_SHARDED_LOSS,
                  f"lm_sharded {shape}: loss rel {t0r['loss_rel']}")
            check(t0r["params_worst"] <= 1.0,
                  f"lm_sharded {shape}: params {t0r['params_worst']} of "
                  f"the allclose bound")
            check(t0r["grad_norm_rel"] <= TOL_SHARDED_GRAD_NORM,
                  f"lm_sharded {shape}: grad_norm rel "
                  f"{t0r['grad_norm_rel']}")
            check(t0r["update_rel"] <= TOL_SHARDED_UPDATE,
                  f"lm_sharded {shape}: the step's parameter change "
                  f"{t0r['update_rel']} off one device's, relative")
            for r in ranks:
                m = r.get("mixtral")
                if m is None:
                    continue
                check(m["logits_err"] <= TOL_SHARDED_LOGITS
                      * m["max_abs_logit"] and m["loss_rel"]
                      <= TOL_SHARDED_LOSS and m["grad_worst"]
                      <= TOL_SHARDED_GRAD,
                      f"lm_sharded mixtral rank {r['rank']}: shard_map vs "
                      f"einsum {m}")
            staged = backend == "gloo" and bool(refused)
            worlds.append({"world": world, "backend": backend,
                           "mesh": shape, "ranks": ranks,
                           "times": (f"host-staged: each rank's "
                                     f"{', '.join(sorted(refused))} calls "
                                     f"ran through host memory "
                                     f"(staged_collectives), so these are "
                                     f"not tensor-parallel times")
                           if staged else "card",
                           "seconds": time.perf_counter() - t0})
            if backend == "gloo":
                pipeline = [r.pop("pipeline") for r in ranks]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(phase="lm_sharded", arch=LM_ARCH, dtype="float32",
         gloo_staged=sorted(refused),
         batch=LM_BATCH, prompt_len=LM_PROMPT, worlds=worlds,
         flash_launches=launches, torch=torch.__version__,
         seconds=time.perf_counter() - t_phase)
    check(pipeline is not None, "lm_pipeline: the gloo world never ran")
    return launches, _lm_pipeline_gates(pipeline)


def _lm_pipeline_gates(ranks) -> int:
    """Phase lm_pipeline's gates on the records of :func:`_lm_pipeline`,
    one a rank of the gloo world; emits the phase. Returns kernel 5's
    launches in the pipelined forward, summed over the ranks."""
    n_layers = 22                          # TinyLlama-1.1B
    s = len(ranks)
    want = LM_PIPE_MICRO * n_layers // s
    check(sorted(r["stage"] for r in ranks) == list(range(s)),
          f"lm_pipeline: stages {[r['stage'] for r in ranks]}")
    for r in ranks:
        tag = f"lm_pipeline stage {r['stage']}"
        check(r["layers_held"] == n_layers // s,
              f"{tag}: holds {r['layers_held']} layers")
        check(r["flash_launches_forward"] == want,
              f"{tag}: {r['flash_launches_forward']} flash launches a "
              f"forward, want {want}")
        check(r["flash_launches_step"] == 2 * want,
              f"{tag}: {r['flash_launches_step']} flash launches a step "
              f"(forward and the backward's recompute), want {2 * want}")
        check(r["logits_err"] <= TOL_SHARDED_LOGITS * r["max_abs_logit"],
              f"{tag}: logits {r['logits_err']} vs {TOL_SHARDED_LOGITS} x "
              f"{r['max_abs_logit']}")
        check(r["loss_rel"] <= TOL_SHARDED_LOSS,
              f"{tag}: loss rel {r['loss_rel']}")
        check(r["grad_norm_rel"] <= TOL_SHARDED_GRAD_NORM,
              f"{tag}: grad_norm rel {r['grad_norm_rel']}")
        check(r["grad_worst"] <= TOL_SHARDED_GRAD,
              f"{tag}: a gradient {r['grad_worst']} of its norm off one "
              f"device's")
        check(r["dp"]["compressed_of_bound"] <= 1.0,
              f"{tag}: the compressed mean {r['dp']['compressed_of_bound']}"
              f" of its scale / 2 bound off the exact mean")
        check(r["dp"]["exact_vs_single"] <= TOL_SHARDED_GRAD,
              f"{tag}: the exact data-parallel mean "
              f"{r['dp']['exact_vs_single']} of a norm off one device's "
              f"gradient")
    staged = {k: v for r in ranks
              for k, v in (r["staged_collectives"] or {}).items()}
    emit(phase="lm_pipeline", arch=LM_ARCH, dtype="float32", stages=s,
         microbatches=LM_PIPE_MICRO, batch=LM_BATCH, prompt_len=LM_PROMPT,
         ranks=ranks,
         times=("host-staged: " + ", ".join(sorted(staged))
                + " ran through host memory") if staged else
         "card (gloo's collectives on CUDA tensors, two ranks sharing "
         "the card)",
         seconds=max(r["seconds"] for r in ranks))
    return sum(r["flash_launches_forward"] for r in ranks)


def _dryrun_cross_check(dev):
    """TinyLlama-1.1B's prefill cell (DRYRUN_CHECK) at a (1, 1) mesh: the
    dry run's argument bytes against ``torch.cuda.memory_allocated``'s
    growth once the parameters and tokens are placed on the card, its
    FLOP count against ``FlopCounterMode`` of the same step run on the
    card through the plain versions, and its ``temp_bytes`` against the
    growth of ``torch.cuda.max_memory_allocated`` in that run over the
    placed arguments: at least the walk's bytes less 1 MiB, at most
    TEMP_SLACK_BLOCK more a storage live at the walk's peak plus
    TEMP_SLACK (the allocator's rounding)."""
    import dataclasses
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import SHAPE_CELLS, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import api, common
    arch, kind, b, s = DRYRUN_CHECK
    cfg = get_config(arch)
    cell = dataclasses.replace(SHAPE_CELLS["prefill_32k"], seq_len=s,
                               global_batch=b)
    rec = dryrun.run_cell(arch, "prefill_32k", "one", cell=cell)
    check(rec["status"] == "ok", f"dryrun cross-check cell: {rec}")
    model = api.build_model(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = dict(model.module(torch.Generator(dev).manual_seed(SEED))
                  .state_dict())
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (b, s)), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - before
    # cuBLAS (and cuBLASLt) allocate their workspaces at a handle's first
    # product and keep them: taken here, outside the measured growth
    for dt in (common.dtype_of(cfg), torch.float32):
        a = torch.ones(8, 8, dtype=dt, device=dev)
        (a @ a, torch.bmm(a[None], a[None]), torch.addmm(a, a, a))
    torch.cuda.synchronize()
    del a
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        out = model.prefill(model.nest(params), {"tokens": tokens}, s,
                            impl="ref")
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    del out
    card_flops = fc.get_total_flops()
    want = rec["argument_bytes"]
    check(placed == want, f"dryrun: {want} argument bytes, the card grew "
          f"{placed}")
    check(card_flops == rec["hlo_flops"], f"dryrun: {rec['hlo_flops']} "
          f"FLOPs counted, the card's run {card_flops}")
    temp = rec["temp_bytes"]
    slack = rec["temp_storages"] * TEMP_SLACK_BLOCK + TEMP_SLACK
    check(temp - 2 ** 20 <= growth <= temp + slack,
          f"dryrun: {temp} bytes of temporaries ({rec['temp_storages']} "
          f"storages at the peak), the card's peak grew {growth} over the "
          f"placed arguments (allowed -1 MiB to +{slack})")
    del params, tokens
    torch.cuda.empty_cache()
    arch, kind, tb, ts = DRYRUN_TRAIN_CHECK
    return {"cell": f"{arch} {kind} {b}x{s} (1, 1)",
            "argument_bytes": want, "memory_allocated_growth": placed,
            "bytes_per_device": rec["bytes_per_device"],
            "flops": rec["hlo_flops"], "card_flops": card_flops,
            "temp_bytes": temp, "temp_storages": rec["temp_storages"],
            "max_memory_allocated_growth": growth,
            "growth_over_temp": growth - temp, "allowed_over": slack,
            "train": _dryrun_train_check(dev, arch, cfg, tb, ts)}


def _warm_blas(dev, dtypes):
    """cuBLAS (and cuBLASLt) allocate a workspace at a handle's first
    product and keep it, a handle per thread: each product kind once in
    each of ``dtypes``, forward and, on autograd's device thread, backward,
    so that no later growth counts them."""
    import torch
    for dt in dtypes:
        a = torch.ones(8, 8, dtype=dt, device=dev, requires_grad=True)
        out = (a @ a).sum() + torch.bmm(a[None], a[None]).sum() \
            + torch.addmm(a, a, a).sum()
        torch.autograd.grad(out, a)
    torch.cuda.synchronize()


def _dryrun_train_check(dev, arch, cfg, b, s):
    """A donated train cell (``cfg``, ``b`` x ``s`` tokens, a (1, 1) mesh)
    against the card: the dry run's argument bytes equal to the exact
    bytes of the state and batch placed on the card, and
    ``torch.cuda.memory_allocated``'s growth to those bytes rounded up to
    the allocator's 512-byte blocks (AdamW's int32 ``count`` takes one),
    plus at most the split rule's 1 MiB a tensor of over 1 MiB (a block
    is handed out whole when cutting it would leave 1 MiB or less:
    TinyLlama's two 125 MiB bf16 tables in fresh 126 MiB segments);
    its ``temp_bytes`` against the growth of
    ``torch.cuda.max_memory_allocated`` over the placed state while one
    ``make_train_step(impl="ref", donate=True)`` step runs on the card,
    within the prefill check's slack. The step writes the state's own
    tensors. Returns the record."""
    import torch
    from repro_torch.configs import SHAPE_CELLS
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import api, common
    from repro_torch.optim import adamw
    cell = dataclasses.replace(SHAPE_CELLS["train_4k"], seq_len=s,
                               global_batch=b)
    rec = dryrun.run_cell(arch, "train_4k", "one", cfg=cfg, cell=cell,
                          donate=True)
    check(rec["status"] == "ok" and rec["donate"] is True,
          f"dryrun train cross-check cell: {rec}")
    model = api.build_model(cfg, device=dev)
    _free()
    before = torch.cuda.memory_allocated()
    params = dict(model.module(torch.Generator(dev).manual_seed(SEED))
                  .state_dict())
    opt = adamw.init(params)
    rng = np.random.default_rng(SEED)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, tuple(v.shape)),
                                dtype=v.dtype, device=dev)
             for k, v in model.input_specs(cell).items()}
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - before
    tensors = [*params.values(), *opt["m"].values(), *opt["v"].values(),
               opt["count"], *batch.values()]
    exact = sum(t.numel() * t.element_size() for t in tensors)
    rounded = sum(-(-t.numel() * t.element_size() // 512) * 512
                  for t in tensors)
    split = 2 ** 20 * sum(t.numel() * t.element_size() > 2 ** 20
                          for t in tensors)
    want = rec["argument_bytes"]
    check(want == exact, f"dryrun train: {want} argument bytes, the state "
                         f"and batch hold {exact}")
    check(rounded <= placed <= rounded + split,
          f"dryrun train: the card grew {placed} placing {exact} bytes, "
          f"want {rounded} to {rounded + split}")
    _warm_blas(dev, (common.dtype_of(cfg), torch.float32))
    step = make_train_step(model, adamw.AdamWConfig(), impl="ref",
                           donate=True)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step((params, opt), batch)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    check(state[0] is params and state[1] is opt,
          "dryrun train: the donated step made a new state")
    loss = metrics["loss"].item()
    check(np.isfinite(loss), f"dryrun train: loss {loss}")
    temp = rec["temp_bytes"]
    slack = rec["temp_storages"] * TEMP_SLACK_BLOCK + TEMP_SLACK
    check(temp - 2 ** 20 <= growth <= temp + slack,
          f"dryrun train: {temp} bytes of temporaries "
          f"({rec['temp_storages']} storages at the peak), the card's peak "
          f"grew {growth} over the placed state (allowed -1 MiB to "
          f"+{slack})")
    del state, metrics, params, opt, batch, tensors
    _free()
    return {"cell": f"{arch} train {b}x{s} (1, 1), donated",
            "argument_bytes": want, "memory_allocated_growth": placed,
            "allocator_rounding": rounded - exact,
            "allocator_split_over": placed - rounded,
            "bytes_per_device": rec["bytes_per_device"],
            "temp_bytes": temp, "temp_storages": rec["temp_storages"],
            "max_memory_allocated_growth": growth,
            "growth_over_temp": growth - temp, "allowed_over": slack,
            "loss": loss}


def phase_dryrun(cross):
    """The dry run of every (arch x shape x mesh) cell, single- and
    multi-pod, after the card's phases: ``launch.dryrun.run_job`` on
    ``meta`` tensors in fake worlds of 256 and 512 ranks, in a pool of
    host processes, one a core, each copying (the donated train cells are
    the CLI's ``--donate``). Each cell's status, ``fits``, bytes a device
    and wall time; every applicable cell must be ``ok``. ``cross``
    is the card's cross-check (:func:`_dryrun_cross_check`), run first of
    all phases: the caching allocator's growth is exact only before other
    phases leave cached segments whose free blocks a new tensor can take
    whole."""
    import multiprocessing as mp
    import os
    from repro_torch.configs import SHAPE_CELLS, list_archs
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    knobs = {"remat": None, "moe_impl": None, "strategy": "tp",
             "cache_shard": "kv", "donate": False}
    # longest first (the train cells count a backward, the multi-pod mesh
    # twice the ranks), so the pool's last jobs are short ones
    jobs = sorted(((a, s, m, knobs) for a in list_archs()
                   for s in SHAPE_CELLS for m in ("single", "multi")),
                  key=lambda j: (not j[1].startswith("train"),
                                 not j[1].startswith("prefill"),
                                 j[2] != "multi"))
    n_proc = os.cpu_count() or 1
    pool = mp.get_context("spawn").Pool(n_proc)
    try:
        recs = pool.map_async(dryrun.run_job, jobs, chunksize=1).get(
            timeout=DRYRUN_TIMEOUT_S)
    finally:
        pool.terminate()
        pool.join()
    grid_s = time.perf_counter() - t_phase
    for rec in recs:
        emit(phase="dryrun.cell", **{k: rec.get(k) for k in (
            "arch", "shape", "mesh", "donate", "status", "skip_reason",
            "error",
            "fits", "bytes_per_device", "argument_bytes", "temp_bytes",
            "build_s",
            "count_s", "hlo_flops", "hlo_bytes", "collective_bytes",
            "collective_count_by_kind", "model_flops",
            "useful_flops_ratio", "compute_s", "memory_s", "collective_s",
            "dominant") if k in rec})
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error"),
            r.get("traceback", "")[-800:])
           for r in recs if r["status"] == "fail"]
    check(not bad, f"dryrun: cells failed: {bad}")
    emit(phase="dryrun", cells=len(recs),
         ok=sum(r["status"] == "ok" for r in recs),
         skip=sum(r["status"] == "skip" for r in recs),
         fit=sum(bool(r.get("fits")) for r in recs),
         unfit=[{k: r[k] for k in ("arch", "shape", "mesh",
                                   "argument_bytes", "temp_bytes")}
                for r in recs if r["status"] == "ok" and not r["fits"]],
         processes=n_proc,
         grid_seconds=grid_s,
         cell_seconds=sum(r.get("build_s", 0) + r.get("count_s", 0)
                          for r in recs), cross_check=cross,
         seconds=time.perf_counter() - t_phase)


def worker_serve(argv) -> int:
    """``chip_smoke.py --worker-serve``: one serving process over a
    persist dir, the body that phase restart SIGKILLs. It builds the
    seeded MinkUNet-large, queues the journaled requests again
    (``recover``), then (unless ``--restart-only``) serves the four scenes
    of phase serve: one at a time (submit, then a tick), or with
    ``--kill-at K`` all submitted first and drained, the ticks under a
    fault plan whose ``kill`` site fires at call K. Submissions run
    outside the plan, so both modes make the same kill-site calls, and
    the uninterrupted one records the call index at each tick's start.
    Writes its results as JSON to ``--out``."""
    import argparse
    t_start = time.time()
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker-serve", action="store_true")
    ap.add_argument("--persist-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--kill-at", type=int, default=-1)
    ap.add_argument("--restart-only", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import plan as planlib
    from repro_torch.launch.spconv_serve import ServeEngine
    from repro_torch.models import minkunet
    from repro_torch.runtime import admission, fault, guard
    dev = torch.device("cuda", 0)
    cfg = minkunet.LARGE
    model = _seeded_model(cfg, dev)
    eng = ServeEngine(model, device=dev, max_batch=1,
                      persist_dir=args.persist_dir,
                      queue=admission.AdmissionQueue(
                          buckets=(BUCKET,), grid_bits=cfg.grid_bits,
                          batch_bits=cfg.batch_bits))
    h0 = guard.health().snapshot()
    recovery = eng.recover()
    planlib.reset_mapsearch_counter()
    _reset_counts()
    done_at, tick_ms, tick_kill_calls = {}, {}, []
    plan = fault.FaultPlan(schedule={fault.KILL_SITE: [args.kill_at]}
                           if args.kill_at >= 0 else None)

    def tick():
        tick_kill_calls.append(plan.calls.get(fault.KILL_SITE, 0))
        t0 = time.perf_counter()
        with fault.inject(plan):
            for r in eng.step():
                if r.status == "completed":
                    done_at[r.rid] = time.time()
                    tick_ms[r.rid] = (time.perf_counter() - t0) * 1e3

    scenes = [] if args.restart_only else _serve_scenes()
    for rid, sc in scenes:
        eng.submit(rid, sc.coords, sc.batch, sc.valid, sc.feats,
                   deadline_s=CHAOS_DEADLINE_S)
        if args.kill_at < 0:
            tick()
    while len(eng.queue):
        tick()
    counts = _counts()
    s = eng.stats()
    out = {"completed": {r.rid: r.digest for r in eng.results
                         if r.status == "completed"},
           "statuses": {r.rid: [r.status, r.reason] for r in eng.results},
           "latency_ms": {r.rid: r.latency_s * 1e3 for r in eng.results
                          if r.status == "completed"},
           "tick_ms": tick_ms, "done_at": done_at, "t_start": t_start,
           "tick_kill_calls": tick_kill_calls,
           "recovery": recovery, "searches": planlib.mapsearch_call_count(),
           "octent_query": counts[0], "spconv_gemm_fused": counts[1],
           "persist": s["persist"], "journal": s["journal"],
           "journal_entries": len(eng.journal),
           "health": guard.health().delta(h0)}
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


def _spawn_worker(persist_dir, out, *, kill_at=-1, restart_only=False):
    """Run one ``--worker-serve`` process to its end (at most
    RESTART_TIMEOUT_S); returns ``(returncode, spawn wall time, stderr
    tail, its JSON or None)``."""
    import os
    import subprocess
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker-serve",
           "--persist-dir", persist_dir, "--out", out]
    if kill_at >= 0:
        cmd += ["--kill-at", str(kill_at)]
    if restart_only:
        cmd.append("--restart-only")
    env = dict(os.environ, REPRO_PERSIST_MAX_BYTES=str(PERSIST_BUDGET))
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=RESTART_TIMEOUT_S)
    res = None
    if proc.returncode == 0:
        with open(out) as f:
            res = json.load(f)
    return proc.returncode, t0, proc.stderr[-3000:], res


def _snap_entries(snap_dir, kind):
    """Paths of the snapshot entries whose key starts with ``kind``."""
    from repro_torch.runtime import persist
    return [path for key, path in persist.SnapshotStore(snap_dir).entries()
            if key[0] == kind]


def phase_restart(dev, cfg, serve_latency_ms, serve_digests):
    """The kill-and-restart gate of ``benchmarks/restart_replay.py``'s
    serving side, on the card: an uninterrupted persisted worker (the
    digests to match, its bytes and write time per request, its latency
    against phase serve's without persistence), a warm worker over its
    directory (no map search, no kernel-1 launch), a worker SIGKILLed at
    its first tick and one in the middle of a snapshot write, each
    restarted over its directory (``recover`` queues the journaled
    requests again and they complete with the same digests), and a warm
    worker after one plan snapshot was truncated and another bit-flipped
    (both dropped and counted, the same digests). Returns the launches of
    kernels 1 and 2 over its workers."""
    import os
    import shutil
    import signal
    import tempfile
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-restart-")
    launches = [0, 0]
    rec = {}

    def run(tag, persist_dir, **kw):
        rc, t0, err, res = _spawn_worker(
            persist_dir, os.path.join(root, f"{tag}.json"), **kw)
        if res is not None:
            launches[0] += res["octent_query"]
            launches[1] += res["spconv_gemm_fused"]
        return rc, t0, err, res

    def first_result_s(t0, res):
        return min(res["done_at"].values()) - t0

    try:
        warm_dir = os.path.join(root, "warm")
        rc, t0, err, cold = run("cold", warm_dir)
        check(rc == 0, f"restart: the uninterrupted worker failed rc={rc}:"
              f"\n{err}")
        ref = cold["completed"]
        check(sorted(ref) == sorted(serve_digests) and all(
            ref[k] == serve_digests[k] for k in ref),
            "restart: persisted digests differ from phase serve's")
        n = len(ref)
        per_fresh = cold["octent_query"] // n, cold["spconv_gemm_fused"] // n
        n_layers = _n_layers(cfg)
        check((per_fresh == (len(cfg.enc) + 1, n_layers)
               or dev.type != "cuda")
              and cold["searches"] == n * (2 * len(cfg.enc) + 1),
              f"restart: cold worker launches {per_fresh}, searches "
              f"{cold['searches']}")
        rec["cold"] = {
            "first_result_s": first_result_s(t0, cold),
            "bytes_per_request": cold["persist"]["bytes_written"] / n,
            "write_ms_per_request": cold["persist"]["write_ms"] / n,
            "journal_bytes_per_request":
                cold["journal"]["bytes_written"] / n,
            "journal_write_ms_per_request":
                cold["journal"]["write_ms"] / n,
            "latency_ms": cold["latency_ms"], "tick_ms": cold["tick_ms"],
            "serve_latency_ms": serve_latency_ms,
            "snap_entries": cold["persist"]["entries"],
            "snap_bytes": cold["persist"]["resident_bytes"]}

        rc, t0, err, warm = run("warm", warm_dir)
        check(rc == 0, f"restart: the warm worker failed rc={rc}:\n{err}")
        check(warm["completed"] == ref, "restart: warm digests differ")
        check(warm["searches"] == 0 and warm["octent_query"] == 0,
              f"restart: warm worker searched {warm['searches']} times, "
              f"kernel 1 launched {warm['octent_query']} times")
        rec["warm"] = {"first_result_s": first_result_s(t0, warm),
                       "latency_ms": warm["latency_ms"],
                       "tick_ms": warm["tick_ms"],
                       "persist_hits": warm["persist"]["hits"]}

        # the kill-site calls between two ticks' starts are the snapshot
        # writes of one request: the second request's middle write
        at = cold["tick_kill_calls"]
        check(len(at) == n and at[2] - at[1] >= 2,
              f"restart: kill-site calls at the ticks {at}")
        kills = {"mid_tick": at[0], "mid_snapshot": (at[1] + at[2]) // 2}
        for tag, k in kills.items():
            pdir = os.path.join(root, tag)
            rc, _, err, _ = run(f"{tag}-killed", pdir, kill_at=k)
            check(rc == -signal.SIGKILL, f"restart {tag}: worker rc={rc}, "
                  f"want SIGKILL:\n{err}")
            snap = os.path.join(pdir, "snap")
            torn = [x for x in os.listdir(snap) if x.startswith(".tmp-")] \
                if os.path.isdir(snap) else []
            check(bool(torn) == (tag == "mid_snapshot"),
                  f"restart {tag}: torn temporary files {torn}")
            journaled = len(os.listdir(os.path.join(pdir, "journal")))
            rc, t0, err, res = run(f"{tag}-restarted", pdir,
                                   restart_only=True)
            check(rc == 0, f"restart {tag}: restart failed rc={rc}:\n{err}")
            check(res["recovery"] == {"recovered": journaled, "shed": 0}
                  and journaled > 0, f"restart {tag}: recovery "
                  f"{res['recovery']} of {journaled} journaled")
            check(all(ref[k] == v for k, v in res["completed"].items())
                  and len(res["completed"]) == journaled,
                  f"restart {tag}: recovered digests differ")
            check(res["journal_entries"] == 0,
                  f"restart {tag}: journal not empty")
            rec[tag] = {"kill_at": k, "torn_files": len(torn),
                        "journaled": journaled,
                        "recovered": sorted(res["completed"]),
                        "first_result_s": first_result_s(t0, res),
                        "searches": res["searches"],
                        "persist_hits": res["persist"]["hits"]}
            shutil.rmtree(pdir, ignore_errors=True)

        plans = _snap_entries(os.path.join(warm_dir, "snap"), "plan")
        with open(plans[0], "rb") as f:
            blob = f.read()
        with open(plans[0], "wb") as f:
            f.write(blob[:len(blob) // 2])
        with open(plans[1], "rb") as f:
            body = bytearray(f.read())
        body[-max(4, len(body) // 8)] ^= 0x40
        with open(plans[1], "wb") as f:
            f.write(bytes(body))
        rc, t0, err, res = run("corrupt", warm_dir)
        check(rc == 0, f"restart corrupt: worker failed rc={rc}:\n{err}")
        check(res["completed"] == ref, "restart corrupt: digests differ")
        check(res["persist"]["dropped"] == 2 and
              res["health"].get("persist.dropped") == 2,
              f"restart corrupt: dropped {res['persist']['dropped']}, "
              f"health {res['health'].get('persist.dropped')}, want 2")
        rec["corrupt"] = {"dropped": res["persist"]["dropped"],
                          "searches": res["searches"],
                          "octent_query": res["octent_query"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(phase="restart", config=cfg.name, bucket=BUCKET,
         budget_bytes=PERSIST_BUDGET, launches=launches, **rec,
         seconds=time.perf_counter() - t_phase)
    return {"octent_query": launches[0], "spconv_gemm_fused": launches[1]}


#: each phase of :func:`main` in the order they ran: its wall seconds,
#: this process's CPU seconds in it and the card memory this process
#: held reserved at its end
PHASE_S: dict = {}


def timed_phase(name, fn, *args):
    """``fn(*args)``, its record kept in :data:`PHASE_S`."""
    import torch
    t0, c0 = time.perf_counter(), time.process_time()
    try:
        return fn(*args)
    finally:
        PHASE_S[name] = {"s": time.perf_counter() - t0,
                         "cpu_s": time.process_time() - c0,
                         "reserved_gb": torch.cuda.memory_reserved() / 1e9}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data import pointcloud
    from repro_torch.models import minkunet
    dev = torch.device("cuda", 0)
    cfg = minkunet.LARGE

    t0 = time.perf_counter()
    cross = timed_phase("dryrun_cross_check", _dryrun_cross_check, dev)
    timed_phase("device", phase_device)
    scenes = _serve_scenes()
    lidar0 = scenes[0][1]
    warm = pointcloud.make_batch(np.random.default_rng(SEED + 99), "lidar",
                                 1, BUCKET, voxel_size=LIDAR_VOXEL)
    k1 = timed_phase("octent", phase_octent, dev, lidar0, cfg)
    k2 = timed_phase("gemm", phase_gemm, dev, lidar0, cfg)
    model, results, counts = timed_phase(
        "serve", phase_serve, dev, cfg, scenes,
        (warm.coords, warm.batch, warm.valid, warm.feats))
    timed_phase("reference", phase_reference, dev, cfg, model, results)
    serve_digests = {rid: res.digest for rid, _, res in results
                     if not rid.startswith("fused-")}
    serve_latency_ms = {rid: res.latency_s * 1e3 for rid, _, res in results
                        if not rid.startswith("fused-")}
    k1["launches"], k2["launches"] = counts[0], counts[1]
    k2["epilogue_launches"], k2["split_reduce_launches"] = counts[2], counts[4]
    k2["plan_launches"] = counts[5]
    check(counts[4] > 0, "the split-sum kernel never ran on the served path")
    k3, ss_apply_kmap = timed_phase("materialized", phase_materialized, dev,
                                    lidar0, cfg)
    k4 = timed_phase("masked", phase_masked, dev, lidar0, cfg)
    timed_phase("scan", phase_scan, dev, cfg, lidar0, model)
    del model, results
    k1["train_launches"], k2["train_launches"], k2["train_ms_per_step"] = \
        timed_phase("train", phase_train, dev, cfg)
    sec = timed_phase("second", phase_second, dev)
    k1["second_launches"], k2["second_launches"] = (sec["octent_query"],
                                                    sec["spconv_gemm_fused"])
    k1["second_ms_per_forward"] = sec["octent_ms"]
    k2["second_ms_per_forward"] = sec["gemm_ms"]
    strm = timed_phase("stream", phase_stream, dev, cfg)
    k1["stream_launches"] = strm["octent_query"]
    k1["stream_update_launches"] = strm["octent_row_list"]
    k1["stream_update"] = {key: strm["row_list"][key] for key in (
        "q", "rows", "ms", "plain_ms", "bound_ms", "full_ms")}
    k2["stream_launches"] = strm["spconv_gemm_fused"]
    chaos = timed_phase("chaos", phase_chaos, dev, cfg, scenes, warm,
                        serve_digests)
    k1["chaos_launches"] = chaos["octent_query"]
    k2["chaos_launches"] = chaos["spconv_gemm_fused"]
    restart = timed_phase("restart", phase_restart, dev, cfg,
                          serve_latency_ms, serve_digests)
    k1["restart_launches"] = restart["octent_query"]
    k2["restart_launches"] = restart["spconv_gemm_fused"]
    k1["paper_launches"], k2["paper_launches"] = timed_phase(
        "paper", phase_paper, dev, cfg, scenes)
    sharded = timed_phase("sharded", phase_sharded, serve_digests)
    k1["sharded_launches"] = sharded["octent_query"]
    k2["sharded_launches"] = sharded["spconv_gemm_fused"]
    flash = timed_phase("flash", phase_flash, dev)
    lm_cfg, lm_params, fa_launches = timed_phase("lm_serve", phase_lm_serve,
                                                 dev)
    timed_phase("lm_reference", phase_lm_reference, dev, lm_cfg, lm_params)
    del lm_params
    torch.cuda.empty_cache()
    moe_launches = timed_phase("moe_serve", phase_moe_serve, dev)
    train_launches = timed_phase("lm_train", phase_lm_train, dev)
    timed_phase("mamba2", phase_mamba2, dev)
    family_launches = {
        "recurrentgemma": timed_phase("rglru", phase_rglru, dev),
        "hubert": timed_phase("hubert", phase_hubert, dev),
        "llava": timed_phase("llava", phase_llava, dev),
        **timed_phase("lm_configs", phase_lm_configs, dev)}
    ragged, k3["moe_ragged_launches"] = timed_phase(
        "moe_ragged", phase_moe_ragged, dev)
    probe = timed_phase("gloo_probe", phase_gloo_probe)
    sharded_launches, pipeline_launches = timed_phase(
        "lm_sharded", phase_lm_sharded,
        [k for k, v in probe.items() if v != "ok"])
    timed_phase("dryrun", phase_dryrun, cross)
    k3["moe_ragged"] = {name: {key: r[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_f32_cores",
        "share_of_bound", "max_abs_err", "dense_loop_err")}
        for name, r in ragged.items()}
    k3["old_form_ab"] = K3_AB_SCRIPT
    served = flash["tinyllama_prefill"]
    served_f32 = flash["tinyllama_prefill_f32"]
    n = lm_cfg.n_layers
    k5 = {"name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
          "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
          "launches": fa_launches,
          "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
          "ms": n * served["ms"], "plain_ms": n * served["plain_ms"],
          "bound_ms": n * served["bound_ms"], "bound_by": served["bound_by"],
          "library_ms": n * served["library_ms"],
          "f32": {"ms": n * served_f32["ms"],
                  "bound_ms": n * served_f32["bound_ms"],
                  "bound_by": served_f32["bound_by"],
                  "bound_ms_f32_cores": n * served_f32["bound_ms_f32_cores"],
                  "library_ms": n * served_f32["library_ms"],
                  "plain_ms": n * served_f32["plain_ms"],
                  "max_abs_err": served_f32["max_abs_err"],
                  "share_of_bound": served_f32["share_of_bound"]},
          "moe_serve_launches": moe_launches,
          "lm_train_launches": train_launches,
          "family_launches": family_launches,
          "lm_sharded_launches": sharded_launches,
          "lm_pipeline_launches": pipeline_launches,
          "timing": f"{n} launches of one {lm_cfg.name} prefill "
                    f"({LM_BATCH} x {LM_PROMPT} tokens, bf16), one per "
                    f"layer; max_abs_err over all shapes, bf16 and f32; "
                    f"f32: the same prefill's {n} launches in float32 "
                    f"(3xTF32 route), bound at 495 / 3 TFLOP/s"}
    ss = sec["segment_sum"]
    k6 = {"name": "segment_sum", "route": "cuda", "source": SEG_SRC,
          "replaces": "src/repro/models/second.py:116",
          "launches": ss["launches"], "max_abs_err": max(
              ss["max_abs_err"], ss_apply_kmap["max_abs_err"]),
          "ms": ss["kernel_ms"], "plain_ms": ss["plain_ms"],
          "bound_ms": ss["bound_ms"], "bound_by": ss["bound_by"],
          "library_ms": ss["library_ms"],
          "widest_row": ss["widest_row"], "shapes": ss["shapes"],
          "loss_step_launches": ss["loss_step_launches"],
          "apply_kmap_launches": ss_apply_kmap["launches"],
          "apply_kmap": {k: ss_apply_kmap[k] for k in (
              *SUM_KEYS, "bound_by", "widest_row")},
          "timing": f"the {SECOND_SUMS} sums of one SECOND-large forward "
                    "(to_bev and the stage-0 Gconv3's scatter), device ms; "
                    "apply_kmap: its 20 shapes, one sum each; plain: the "
                    "column loop on the card, its layout built beforehand; "
                    "library: one index_add_ of the kept rows; "
                    "max_abs_err 0 is bit-equal"}
    for k in (k1, k2, k3, k4, k5, k6):
        check(k["launches"] > 0, f"{k['name']} never launched on the path")
    emit(phase="done", seconds=time.perf_counter() - t0,
         phases=PHASE_S)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--worker-serve" in sys.argv[1:]:
        if not (ROOT / "src" / "repro_torch").is_dir():
            sys.exit(2)
        sys.exit(worker_serve(sys.argv[1:]))
    sys.exit(main())
