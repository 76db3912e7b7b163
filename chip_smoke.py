"""Drive the PyTorch port on one NVIDIA GPU, end to end: the 1->N serving
path, the discriminator phase of training, the fused training step, the
training run (the Trainer: data, logs, checkpoints, resume) and the
production config's training options (EMA, lazy R1, split phases, the
2x supersampled ADA warp, rematerialisation, the C++ image loader), int8
serving, the spatial axis on one card and evaluation with InceptionV3.

    python3 chip_smoke.py

Run it from the repository root on a host with one CUDA card (an H100:
the kernels are built for sm_90a). It builds every CUDA kernel of the
port from ``one_to_many_gan_torch/csrc/`` (one nvcc per source, all
started together), then runs, in order:

1. environment: the card's name and power limit, torch and CUDA
   versions, the kernel build time;
2. the instance-norm kernel against its plain PyTorch version at the
   serving shapes, at the 12 sites of one D phase (phase 8), at the 30
   of one fused step (phase 11) and at the 32 of one step of the
   production config (phase 15), float32 and bfloat16, with the
   kernel's plan, a second launch that must be bitwise equal, the
   kernel's, the plain version's, the library call's and the memory
   bound's times, and their sums per encode, per D step, per fused step
   and per production step; and a bfloat16 site of |mean| / std ~ 10^3,
   where the moment and the centred variance give different outputs, in
   every block layout;
3. the HTTP server of ``configs/default.toml`` at full width (512x256,
   float32, fresh weights from seed 0): ``/generate`` at n = 8, 32, 64,
   zip and npy, a concurrent burst, ``/healthz`` and ``/stats``, with the
   launch count of every kernel read around it;
4. the card against the CPU on the same weights and draws;
5. the same path in bfloat16;
6. where the time goes: one n=64 request of each precision under
   ``torch.profiler``, its kernels ranked by device time and the share
   of the request's wall time the device was busy;
7. the warp kernel against its plain version at the D phase's
   [16, 256, 256], the default config's [4, 512, 256] and the production
   config's [8, 512, 512], float32 and
   bfloat16, antialias on and off, on the coordinates and widths of
   ADA draws at p = 0.9, with the kernel's, the plain version's,
   ``F.grid_sample``'s (antialias off, float32) and the bound's times;
8. the D phase of training at the bench config (256x256, batch 16,
   bfloat16, 7 resnet blocks, buffer 8, fresh weights from seed 0, ADA p
   set to 0.6, synthetic batches): 3 warm-up and 20 timed steps, with the
   launch counts per step (2 warps, 12 instance norms), the checks that
   the losses are finite, the discriminator moved, the buffer filled and
   the ADA window advanced, and one step under ``torch.profiler``;
9. the card against the CPU: the discriminator's inputs, loss, scores
   and gradients of one float32 D phase (TF32 off) at 256x256, batch 4, on
   the same weights, batches and draws; the CPU's gradients on the card's
   inputs; and, on the CPU's inputs, the card's gradients (as configured,
   with cuDNN deterministic, without cuDNN, with TF32 on) and the CPU's
   against a float64 pass on the CPU;
10. the warp backward (a pre-pass and a gather) against its plain
   version at the same shapes, dtypes and antialias modes as phase 7,
   with a normal cotangent, through the wrapper and through autograd,
   two launches bitwise equal, with the kernel's, the plain version's,
   ``grid_sampler_2d_backward``'s (antialias off, float32) and the
   bound's times; then on rotations by multiples of 90 degrees and flips,
   4x magnification, tents at the width cap and random non-affine
   coordinates; under ``torch.use_deterministic_algorithms(True)``; its
   NaN contract; and the pre-pass's share of its device time;
11. the fused training step (D phase, then G phase) at the bench config
   with the lazy path term every 8th step: 3 warm-up and 16 timed steps,
   with the launch counts per step (3 warp forwards, 1 warp backward, 30
   instance norms), the checks that the seven G metrics are finite, that
   the path loss is positive on path steps and 0 on the others, that the
   generator, mapping and extractor moved and that the step counter
   advanced; path and other steps timed apart, their peak memory, and
   one of each under ``torch.profiler``, with the device time of the
   replication and reflection pads (forward kernels and the
   deterministic backward's);
12. the card against the CPU: one float32 fused path step (TF32 off) at
   256x256, batch 4, on the same weights, batches and draws: the G
   metrics and the gradients of generator, mapping and extractor, and
   both sides' gradients against a float64 pass of the G phase on the CPU
   on the CPU's inputs (the card's on those inputs too);
13. the fused step of phase 11 with ``training.deterministic_cuda_kernels
   = true``, twice from seed 0 for 3 steps: every parameter, Adam moment,
   ADA and buffer tensor and every metric bitwise equal between the two
   runs, the steps timed beside phase 11's;
14. the training run through the ``Trainer``, at phase 11's config on
   image folders (64 train images a domain), in groups of 8 steps: (a)
   16 steps, a server started on the run's checkpoint, then a new
   Trainer that prints ``Resumed from checkpoint at step 16`` and trains
   to 32: the log lines in the ``Logger``'s format, the FID/KID lines,
   the grids, 64 validation images, one checkpoint kept, exactly 3 warp
   forwards, 1 warp backward and 30 instance norms in every step, the
   loop's step time beside phase 11's bare step, the device's idle share
   over 8 steps under ``torch.profiler``, the checkpoint's parts timed,
   the bytes sent to the card, and ``POST /reload`` answering step 32;
   (c) the run's artifact and its checkpoint behind two engines give the
   same images bitwise; (b) under ``deterministic_cuda_kernels``, 16
   steps in one run and as 8 + a resume to 16: the two checkpoints
   bitwise equal;
15. the production config, ``configs/tpu_v5e8_512.toml`` (512x512, EMA,
   lazy R1, split phases), as one data-parallel replica on one card
   (``presets.write_card_config``; each override printed), its
   schedule cut to 32 steps: (a) 18 bare steps on synthetic batches
   without deterministic kernels, each phase timed and its peak memory
   read, the launches of each phase exact (D: 2 warps and 13 instance
   norms, 16 on an R1 step; G: 1 warp, 1 warp backward, 19 instance
   norms), then ``g_loss_split``'s G phase on a path step (29 instance
   norms) and another, and the EMA update's device time; (b) one float32
   R1 term at 256x256, batch 4, card and CPU against float64 with the
   kinks pinned; (c) under deterministic kernels, the ``Trainer`` on
   512x512 folders: 16 steps, a server, a resume to 32 with ``/reload``
   and ``/healthz`` (``"ema": true``), the launches of every step exact,
   the log, FID/KID lines, grids and 64 validation images; the artifact
   (``__ema__`` true, its generator the checkpoint's EMA bitwise, its
   engine's images the checkpoint's); the training CLI on the config's
   copy for 32 uninterrupted steps, its ``32.tar`` bitwise the resumed
   run's; and the fused step in groups of 8 for 16 steps, its ``16.tar``
   bitwise the split run's;
16. the slice's training options at phase 15's config: (a) the warp
   forward and backward at the supersampled warp's [8, 1024, 1024]
   (antialias off, on its 2x coordinates), float32 and bfloat16, against
   their plain versions with phases 7 and 10's tolerances, two launches
   bitwise equal, with the kernel's, plain version's, library call's
   (float32) and bound's times; (b) the supersampled ``augment`` of two
   512x512 images, card against CPU; (c) 4 steps with
   ``ada_supersample = true``: every warp on the 2x grid, the launches of
   each phase phase 15's, the step times beside phase 15's; (d) under
   deterministic kernels, a path (and R1) step and another step under
   ``remat`` none, conv and full: every metric, gradient leaf and
   parameter bitwise equal to none's, each phase's time, peak memory and
   exact launches (a recomputed pass launches its instance norms again);
   (e) where the C++ image loader builds on the host (libjpeg and libpng
   headers), its decode of the 512x512 folders and ``assemble_batch``
   byte-equal to the PIL and numpy paths and a Trainer with
   ``native_loader = true``; else it says why, and phases 15 and 16 run
   with ``native_loader = false``;
17. the data-parallel step (``parallel.DataParallel``) with a world of one
   card over NCCL, at phase 11's config in float32 (TF32 off,
   deterministic kernels), 3 steps, each from the state of the same steps
   without a group: every metric, gradient and parameter against them
   (the step tolerance; the parameters wherever Adam must move them
   alike), the launches of
   each step phase 11's (3 warp forwards, 1 warp backward, 30 instance
   norms), the collectives' device time in one step's profile, and the
   all-reduce of each optimiser's gradient buffer timed with its bytes;
18. int8 serving (``--int8``) at ``configs/default.toml``: (a) the int8
   pre-pass and the fused modulated int8 conv at the 10 sites of an
   n = 64 decode (their real inputs: unpadded activations, style, weight
   codes, demodulation, pad mode) in float32 and bfloat16, and at ragged
   shapes in both pad modes (and unmodulated, unpadded), bitwise equal to
   their plain versions and to a second launch, with the kernels', the
   plain versions', the yardstick's (the site as torch passes, im2col and
   ``torch._int_mm``), the bound's and the codes-only bound's times per
   site type and per decode, and a bfloat16 cuDNN conv's of the codes
   (not the same function); (b) int8 engines in float32 and bfloat16 over
   HTTP (n = 8, 32, 64, npy, median of 3) beside the float engines, 10
   pre-pass, 10 fused conv and 9 instance-norm launches a device call,
   ``/healthz`` ``"int8": true``, images against the float32 engine's
   (mean |delta| in uint8 levels, tanh PSNR); (c) the int8 engine on the
   card against the CPU at n = 8: the card's int8 kernels on the CPU's
   inputs of every site bitwise the CPU's, the images as far apart as
   int8 and float32 may be, the flipped codes of every site counted;
19. the spatial axis on one card: (a) the split instance norm (a band's
   partials, then the bands' statistics combined and applied) at the 32
   sites of a 512x512 step of the production config as data 2 x spatial 2
   runs it, cut into 2 and 4 bands of rows, against its plain version and
   the whole-plane kernel, with the kernels', plain versions', library
   calls' and bounds' times; (b) banded fused steps at phase 11's config in
   a spatial group of one card, against the steps without a group;
20. evaluation with InceptionV3: random torchvision-format weights from
   seed 0 written to a temporary ``.pt`` and named by
   ``OTM_INCEPTION_WEIGHTS``; the validation checkpoint of
   ``configs/default.toml`` (512x256, 1 channel) under
   ``require_inception_fid = true``: 64 generated images (the generator's
   instance-norm kernel launched for each encode) scored against 64 reals,
   the ``[inception_v3_pool3]`` tag in the log and ``metrics.jsonl``, the
   FID's and KID's times; the extractor's features on the card against the
   CPU (float32, TF32 off), its images/s at batch 32, the 299x299 resize's
   time, and a ``utils.profiling.trace`` of one extractor call;
21. the 2x upsample kernel (``ops/cuda/upsample.py``) at the serving
   decode's two sites (a chunk of 86 images), bfloat16 and float32,
   against its plain version, a second launch bitwise equal, with the
   kernel's, the plain version's (the library path it replaced: per axis
   an edge pad and cuDNN's transposed conv) and the bound's times, cold
   L2; and the launches of one bfloat16 engine call of 4 requests at
   n = 64: 6.
   Four cards: ``scripts/multi_card_smoke.py``.

Any failed check raises, and the script exits non-zero. Before its last
line it prints one JSON line ``{"kernels": [...]}``; its last line is
``{"ok": true, "device": {...}}``. Every number it prints is measured in
this run; a copy of them goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import zipfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "default.toml"
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# H100 SXM device memory rate and dense int8 tensor-core rate (NVIDIA data
# sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# The JAX package's own instance-norm tolerances (tests/test_pallas_kernels.py).
IN_TOL = {"float32": 2e-5, "bfloat16": 0.05}
# Card against CPU, float32 with TF32 off, on the tanh output in [-1, 1]:
# cuDNN and oneDNN pick different convolution algorithms and summation
# orders. 1e-3 is an eighth of one uint8 output level (2 / 255).
CARD_VS_CPU_TOL = 1e-3
# bfloat16 against float32: mean abs error on the tanh output, the JAX
# package's own bound (tests/test_bf16.py).
BF16_MEAN_TOL = 0.05
BUCKETS = (8, 32, 64)
REPS = 3  # timed requests per bucket
# The instance norms of one encode at the shipped config, per source
# image: (C, H, W, relu). Stem, 2 down convs, 3 resnet blocks x 2.
ENCODE_SITES = (
    [(64, 512, 256, True), (128, 512, 256, True), (256, 256, 128, True)]
    + [(256, 128, 64, True), (256, 128, 64, False)] * 3
)
IN_SHAPES = sorted({site[:3] for site in ENCODE_SITES})
# The TPU kernel it replaces, in the JAX package: its pl.pallas_call.
IN_REPLACES = "ops/pallas/instance_norm.py:72"
WARP_REPLACES = "ops/pallas/warp.py:177"
WARP_BWD_REPLACES = "ops/pallas/warp.py:209"
# The warp's plain version in float32: the JAX package's warp tolerance
# (tests/test_pallas_kernels.py). bfloat16: one bf16 ulp of the output plus
# 2^-19 of the largest |image| value, under the JAX package's 0.05. Both
# sides use the same weights and form the same exact products (bf16 weight
# times bf16 pixel). The plain version sums them in float64 and rounds once
# to bf16, so no GEMM's summation order enters it; the kernel sums in
# float32, which errs by at most (nx + ny) * 2^-24 * max|x| * 1.03 for
# nx, ny <= 12 taps per axis whose weights sum to at most 1.03:
# 25 * 2^-24 < 2^-19. Where the taps cancel to an output near 0 that
# term is more than a bf16 ulp.
WARP_TOL_F32 = 2e-6
WARP_TOL_BF16_SUM = 2.0**-19
WARP_TOL_BF16_ABS = 0.05
# The warp's shapes: the D phase's (bench config), the default config's and
# the production config's on one card (phase 15: every warp of its step,
# forward and backward, is [8, 512, 512]).
WARP_SHAPES = ((16, 256, 256), (4, 512, 256), (8, 512, 512))
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet), for
# the warp's operations bound.
F32_FLOP_PER_S = 67e12
# The D phase: the bench config of the JAX package (256x256, batch 16,
# bf16, min_latent 64, 7 resnet blocks, w_dim 6, buffer 8, antialiased
# ADA), ADA p set to 0.6 so that transforms and wide tents occur.
D_SIZE, D_BATCH, D_ADA_P = 256, 16, 0.6
D_WARMUP, D_STEPS = 3, 20
D_WARPS_PER_STEP = 2
# The instance norms of one D phase, (B, C, H, W, relu): the generator's
# encode at B = 16 (its 9 sites at 256x256) and the discriminator's trunk
# on the packed batch of 32 (no ReLU: a LeakyReLU follows). The trunk's
# planes (126^2, 62^2, 30^2) are no multiple of 8 elements, so in
# bfloat16 a plane starts mid-vector: the kernel's bulk copies take the
# plane's range rounded out to 16 bytes.
_ENCODE_256 = ([(64, 256, 256, True), (128, 256, 256, True), (256, 128, 128, True)]
               + [(256, 64, 64, True), (256, 64, 64, False)] * 3)
_TRUNK = [(128, 126, 126, False), (256, 62, 62, False), (512, 30, 30, False)]
D_IN_SITES = (
    [(D_BATCH, *site) for site in _ENCODE_256] + [(2 * D_BATCH, *site) for site in _TRUNK]
)
D_IN_PER_STEP = len(D_IN_SITES)  # 12
# The instance norms of one fused step (core/train_step.py): the D phase's
# 12; make_g_loss's gen.encode of the packed prints and marks, 9 sites at
# 2B = 32; and three trunk passes at B = 16: the extractor on the marks,
# the discriminator on the augmented translations and the extractor on
# the translations (the style cycle). The path term's gen.extract takes
# latents and runs no instance norm.
FUSED_IN_SITES = (
    D_IN_SITES + [(2 * D_BATCH, *site) for site in _ENCODE_256]
    + [(D_BATCH, *site) for site in _TRUNK] * 3
)
# Card against CPU, one float32 D phase with TF32 off (phase 9). Readings
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, PR 3). cuDNN and oneDNN
# pick different algorithms and summation orders through the generator,
# the warp and the discriminator:
# - the discriminator's inputs: 6.0e-5 apart; limit CARD_VS_CPU_TOL.
# - loss: 9.3e-8 relative; limit 1e-4. Scores: 4.2e-5; limit 1e-3.
# - gradients on the same inputs, against a float64 pass, per leaf
#   relative to its norm: card 1.9e-7 (head) to 1.06e-4, CPU 1.2e-6 to
#   6.2e-5; with TF32 on the card reads 2.2e-4 (head) and 4.3e-3 to 6.0e-3
#   (trunk). Limit 5e-4: 4.7x the card's reading, 8.6x below TF32's trunk.
# - gradients end to end, each side on its own inputs: 1.6e-4 to 5.2e-4
#   (6.1e-4 in an earlier run). The inputs' 6e-5 difference moves them
#   more than either side's rounding does. Limit 2e-3: 3.3x the largest
#   reading, below TF32's.
# The biases of the convs an instance norm follows have gradient 0 in
# exact arithmetic: those are held below 1e-4 of the whole gradient's norm.
D_CPU_BATCH = 4
D_LOSS_RTOL = 1e-4
D_SCORE_ATOL = 1e-3
D_GRAD_RTOL = 2e-3
D_GRAD_F64_RTOL = 5e-4
# The fused step (phase 11): the D phase's config with the lazy path term
# every 8th step (the JAX package's bench default); 3 warm-up steps and
# 16 timed, two whole intervals. Per step: 3 warp forwards (2 in D, 1 in
# G), 1 warp backward, and 30 instance norms: 12 in D (9 + 3), 9 in the G
# phase's 2B encode, 3 in D's scoring of the augmented translations and
# 3 + 3 in the two extractor passes.
G_INTERVAL = 8
G_WARMUP, G_STEPS = 3, 16
G_WARPS_PER_STEP, G_WARP_BWDS_PER_STEP, G_IN_PER_STEP = 3, 1, 30
G_METRICS = ("total_gen_loss", "gan_loss", "reconstruction_loss", "identity_loss",
             "kl_loss", "style_loss", "path_loss")
# Card against CPU, one float32 fused path step with TF32 off (phase 12),
# read against a float64 pass of the G phase on the CPU on the CPU's
# inputs (batch 4: the float64 pass takes 101 s on the host). The float64
# pass records the side of 0 each ReLU and LeakyReLU input took
# (ops/activations.py); each float32 pass is then also run with that
# pattern pinned, and counts the inputs whose own side differed. An input
# within float32 rounding of 0 that lands on the other side, where the
# derivative is 0 or 0.2 instead of 1, moves every gradient upstream of it
# by up to ~1e-3. Readings on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
# PR 4), of 4.27e8 activation inputs:
# - G metrics: <= 2.4e-6 relative; limit 1e-4.
# - flips against float64: card 244, CPU 94, card with TF32 on 115698.
#   Limit: 3e-6 of the inputs (1281), 5.2x the card's count.
# - gradients per leaf relative to its norm, kinks pinned, against
#   float64 on the same inputs: card 3.7e-5, CPU 1.3e-5, card with TF32
#   on 6.1e-3. Limit 2e-4: 5.4x the card's reading, 30x below TF32's.
# - unpinned, the flips' reach: card 5.5e-3 and CPU 6.3e-3 against
#   float64, 8.7e-3 against each other. Limits 1.5e-2 and 2e-2.
G_CPU_BATCH = 4
G_METRIC_RTOL = 1e-4
G_GRAD_RTOL = 2e-2
G_GRAD_F64_RTOL = 1.5e-2
G_GRAD_PINNED_RTOL = 2e-4
G_MAX_FLIP_SHARE = 3e-6
# Phase 13: fused steps per run, two runs from one seed under
# training.deterministic_cuda_kernels = true; step 0 is a path step.
DET_STEPS = 3
# Phase 14: the Trainer at the fused step's config (phase 11) on image
# folders of 64 train and 16 test images per domain, 32 steps in groups of
# 8 (logs every 8, checkpoints every 16 with grids and 64 validation
# images at batch 32, one checkpoint kept), run as 16 + a resume to 32; the
# group of steps 24-31 under torch.profiler. The exact-resume check runs
# 16 steps once and as 8 + a resume to 16 with a checkpoint every 8.
T_STEPS, T_LOG, T_CKPT, T_GROUP, T_PROFILE_STEP = 32, 8, 16, 8, 24
T_TRAIN_IMAGES, T_TEST_IMAGES = 64, 16
T_EVAL_IMAGES, T_EVAL_BATCH = 64, 32
T_ENGINE_N = 8
# Phase 17: the data-parallel step with a world of one card, at phase 11's
# config in float32 (a whole-step tolerance exists for it), 3 steps beside
# the same steps without a group, each from the same state.
DP_STEPS = 3
STEP_RTOL, STEP_ATOL = 2e-4, 2e-5  # the JAX package's step tolerance
# Phase 15: the production config, configs/tpu_v5e8_512.toml (512x512,
# 1 channel, min_latent 64: 3 downsamples, channels 64 -> 512, 7 resnet
# and 7 style blocks, w_dim 6, bf16, path interval 8, EMA 0.999, R1
# gamma 10 every 16 steps, split phases), as one data-parallel replica on
# one card (presets.write_card_config: data_parallel 4 -> 1,
# spatial_parallel 2 -> 1, batch 32 -> 8, native_loader -> false), on
# image folders of 64 train and 16 test images a domain, with its schedule
# cut to 32 steps (logs every 8, checkpoints every 16 with 64 validation
# images), so that R1 runs at steps 0 and 16 and the path term at 0, 8,
# 16 and 24. Its instance norms, (B, C, H, W, relu): the encoder's 10
# sites (stem, 3 down convs at their input's size, 3 resnet blocks x 2),
# the trunk's 3 (254^2, 126^2, 62^2; LeakyReLU follows).
PROD_CONFIG = ROOT / "configs" / "tpu_v5e8_512.toml"
P_SIZE, P_BATCH, P_INTERVAL, P_R1_INTERVAL = 512, 8, 8, 16
_ENCODE_512 = ([(64, 512, 512, True), (128, 512, 512, True), (256, 256, 256, True),
                (512, 128, 128, True)] + [(512, 64, 64, True), (512, 64, 64, False)] * 3)
_TRUNK_512 = [(128, 254, 254, False), (256, 126, 126, False), (512, 62, 62, False)]
# D phase: the generator's encode at B, the discriminator on the packed 2B.
P_D_IN_SITES = ([(P_BATCH, *s) for s in _ENCODE_512]
                + [(2 * P_BATCH, *s) for s in _TRUNK_512])
# G phase: the encode at 2B; the extractor on the marks, D on the augmented
# translations and the extractor on the translations, at B.
P_G_IN_SITES = ([(2 * P_BATCH, *s) for s in _ENCODE_512]
                + [(P_BATCH, *s) for s in _TRUNK_512] * 3)
# An R1 step adds D on the reals at B; a path step under g_loss_split adds
# the path leg's encode at 2B.
P_R1_IN_SITES = [(P_BATCH, *s) for s in _TRUNK_512]
P_SPLIT_IN_SITES = [(2 * P_BATCH, *s) for s in _ENCODE_512]
P_STEP_IN_SITES = P_D_IN_SITES + P_G_IN_SITES
P_D_WARPS, P_G_WARPS, P_G_WARP_BWDS = 2, 1, 1
# Bare steps (phase 15a): 18 from seed 0 at ADA p 0.6, steps 0 and 1 warm
# the card; steps 2-17 are two path intervals with one R1 step (16).
P_BARE_STEPS, P_BARE_WARMUP = 18, 2
P_STEPS, P_LOG, P_CKPT, P_EVAL_IMAGES = 32, 8, 16, 64
P_EMA_REPS = 20
# Phase 19: the split instance norm at the 32 IN sites of a 512^2 step of
# the production config as data 2 x spatial 2 runs it (16 images a data
# row: the D phase's encode at 16 and trunk at 32; the G phase's encode at
# 32 and three trunk passes at 16), cut into S = 2 and 4 bands of rows
# (the trunk's 254, 126 and 62 rows give bands of 127, 63 and 31 rows, and
# of 63/64, 31/32 and 15/16), the bands' partials combined on one card in
# place of the all-gather; then 2 banded fused steps (a path step and
# another) at phase 11's config.
SP_SPLITS = (2, 4)
SP_IN_SITES = ([(16, *s) for s in _ENCODE_512] + [(32, *s) for s in _TRUNK_512]
               + [(32, *s) for s in _ENCODE_512] + [(16, *s) for s in _TRUNK_512] * 3)
SP_IN_REPS = 10
SP_STEPS = 2
# 19b's gradients against the step without a group, kinks pinned: the
# banded convs run on windows of padded rows whose shapes differ from the
# whole pass's, so cuDNN sums them in other orders (the zero-padded convs
# take their H padding as rows, their W padding as the conv's). Read on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6): 3.54e-4 of a
# leaf's largest entry (the encoder's stem weight, a sum over every pixel
# of the batch). Limit 1e-3.
SP_GRAD_RTOL = 1e-3
# Phase 20: evaluation with InceptionV3 at CONFIG (512x256, 1 channel), on
# random torchvision-format weights from seed 0 (the repository ships
# none): 64 validation images at the config's inference batch of 32
# against 64 reals; the extractor's rate over 128 images at batch 32; its
# features on the card against the CPU on 8 generated images, float32 with
# TF32 off, at tests/test_torch_inception.py's graph tolerance (rtol 1e-3,
# atol 1e-3 of the mean |feature|: the JAX package's own for its graph).
I_EVAL_IMAGES = 64
I_RATE_IMAGES, I_BATCH = 128, 32
I_CARD_CPU_IMAGES = 8
INCEPTION_CARD_CPU_TOL = 1e-3
# Card against CPU, one float32 R1 term (batch 4, 256x256, TF32 off) and
# its gradient in every discriminator parameter, against a float64 pass on
# the CPU with the float64 pass's kink pattern pinned (as phase 12). The
# penalty is a sum of squared input gradients: limit 1e-4 relative (phase
# 9's D loss read 9.3e-8). Its parameter gradients are second derivatives,
# each a sum of products of first-order terms: limit 1e-3 of each leaf's
# norm, twice phase 9's first-order limit (5e-4).
R1_CPU_BATCH, R1_SIZE, R1_GAMMA = 4, 256, 10.0
R1_LOSS_RTOL = 1e-4
R1_GRAD_PINNED_RTOL = 1e-3
R1_MAX_FLIP_SHARE = 3e-6
# Phase 16: the slice's options at phase 15's config. (a) The supersampled
# ADA warp runs the warp kernels without antialiasing on the 2x grid, at
# 512^2 and batch 8 [8, 1024, 1024], held to the plain versions with
# phases 7 and 10's tolerances; the plain backward (a dense contraction,
# ~1 s a call there) is timed over fewer rounds.
S_SHAPE = (P_BATCH, 2 * P_SIZE, 2 * P_SIZE)
S_PLAIN_REPS = 3
# (b) The supersampled augment, card against CPU, float32 (TF32 off), of 2
# synthetic 512^2 images at p 0.9: the coordinates reach 1024, where a
# float32 ulp is 6.1e-5 px, and the two sides' coordinate einsums may
# differ by one; that moves a sample by up to the image's step between
# neighbours times as much: limit CARD_VS_CPU_TOL.
S_CPU_BATCH = 2
# (c) Steps with ada_supersample = true from seed 0 at ADA p 0.6: step 0
# an R1 and path step, 1-3 other steps; the launches per phase phase 15's.
S_BARE_STEPS = 4
# (d) One path (and R1) step and one other step from seed 0 under each
# remat mode, remat_d "same", with deterministic kernels.
REMAT_MODES = ("none", "conv", "full")
# (e) Steps of the Trainer with native_loader = true, where it builds.
S_NATIVE_STEPS = 2

# Phase 18, int8 serving at CONFIG. The decoder's int8 convs of one decode
# chunk: 4 modulated resnet blocks x 2 convs, then 2 upsample convs; the
# index of each site type's first site in call order.
INT8_SITES_PER_DECODE = 10
INT8_SITE_TYPES = {"resnet": 0, "up1": 8, "up2": 9}
INT8_REPLACES = ("no Pallas kernel: XLA's int8 conv_general_dilated at ops/quantize.py:79-89 "
                 "of the JAX package, with the modulation, pad and quantisation before it "
                 "(ops/modulated.py:105-106, ops/quantize.py:53-64) and the cast and "
                 "demodulation after it (ops/modulated.py:111, 129)")
INT8_PREPASS_REPLACES = ("no Pallas kernel: the per-sample amax and scale of XLA's "
                         "quantize_activations at ops/quantize.py:58-60 of the JAX package")
INT8_TIMING_REPS = 5
# Ragged shapes (B, C, H, W, O), unpadded: odd H and W, rows and columns
# off the fused kernel's tiles (2, 4 or 8 rows of 64 columns), O off its N
# tiles (64, 128, 256; 300 takes two), C = 32 to 128.
INT8_RAGGED = ((1, 32, 3, 5, 8), (2, 64, 17, 21, 70), (3, 32, 9, 38, 129), (1, 128, 32, 16, 64),
               (2, 32, 9, 131, 40), (2, 64, 12, 128, 300))
# int8 against float32 images: mean |delta| in uint8 levels, the JAX
# package's bound (tests/test_int8.py).
INT8_MEAN_LEVELS = 4.0
# The int8 engine on the card against the CPU (f32, TF32 off, n = 8). The
# float parts differ as phase 4's do (1e-3 on the output), so a value that
# lies within that of a rounding tie takes the neighbouring code on one
# side: a few in 10^5 at the first int8 site (at most
# INT8_FIRST_SITE_FLIPS of its codes). A flipped code moves the conv's
# outputs around it by a code's step, which flips codes of the next site,
# and so on: by the last site some 15 % of the codes differ (measured),
# and the two images are two samples of the int8 path's rounding, each as
# far from the float32 one. So the images are held as int8 is held to
# float32: mean |delta| under INT8_MEAN_LEVELS uint8 levels and a tanh
# PSNR above INT8_PSNR_FLOOR (the JAX package's tests/test_int8.py); and
# the card's int8 kernels (pre-pass, fused conv) on the CPU's inputs of
# every site are bitwise the CPU's.
INT8_FIRST_SITE_FLIPS = 1e-3
INT8_PSNR_FLOOR = 30.0
INT8_CPU_N = 8

# Phase 21, the 2x upsample kernel at the serving decode's two sites: the
# input (B, C, H, W) of each for a chunk of 86 images (an engine call of 4
# requests at n = 64 decodes 256 in chunks of 86, 85, 85).
UP_SITES = {"site1": (86, 256, 128, 64), "site2": (86, 128, 256, 128)}
UP_REPLACES = ("no Pallas kernel: XLA's lhs-dilated conv (ops/resample.py::_double_blur_axis "
               "of the JAX package) along H and W; in the port, ops/resample.py::_double_blur's "
               "two F.conv_transpose2d (cuDNN dgrad2d_grouped_direct_kernel) and their "
               "_edge_pad replication pads")
# The kernel sums the nine taps in float32 and rounds once. Against the
# plain version in float32 (TF32 off): float32 within UP_TOL32 of the
# largest |x| (two float32 sums of the taps in other orders: each pass errs
# by at most 3 * 2^-24 of it); bfloat16 within half a bf16 ulp of each
# output, 2^-8 |y|, plus that. Against the plain version in the input's
# dtype (what the port ran before), of the largest |x|: bfloat16 3 * 2^-8,
# since the plain version rounds between its passes too (each rounding
# errs by at most 2^-8 of the values it rounds, all within the largest |x|).
UP_TOL32 = 1e-6
UP_TOL = {"float32": UP_TOL32, "bfloat16": 3 * 2**-8}
UP_REPS = 10
UP_REQUESTS, UP_N = 4, 64
UP_LAUNCHES_PER_CALL = 6  # 3 decode chunks x 2 sites


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- phase 1


def phase_environment(torch, build) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    infos = build.build_kernels()  # one nvcc per csrc/<name>.cu, all started together
    seconds = time.perf_counter() - t0
    for name, info in infos.items():
        log(f"built {name}.cu in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"phase 1 ok: kernels built in {seconds:.2f} s")
    return {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": seconds}


# ---------------------------------------------------------------- phase 2


def time_cold_ms(torch, fns: dict, x, flush, reps: int = 30) -> dict:
    """Median device time of each ``fns[name](x)`` over ``reps`` rounds.
    A round launches every function once, in turns, each launch after a
    read of ``flush`` that evicts ``x`` from the 50 MB L2. A read, not a
    write: a written flush leaves the L2 full of dirty lines, whose
    write-back would be charged to the timed launch."""
    for fn in fns.values():
        fn(x)
        fn(x)
    times: dict[str, list[float]] = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def phase_kernels(torch) -> dict:
    import torch.nn.functional as F

    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, instance_norm_plain
    from one_to_many_gan_torch.ops.cuda.instance_norm import plan

    check(len(FUSED_IN_SITES) == G_IN_PER_STEP,
          f"{len(FUSED_IN_SITES)} fused-step IN sites, phase 11 counts {G_IN_PER_STEP}")
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    serve_sites = [(b, c, h, w, relu) for b in (1, 4) for c, h, w in IN_SHAPES
                   for relu in (False, True)]
    sites = serve_sites + sorted(set(FUSED_IN_SITES + P_STEP_IN_SITES) - set(serve_sites))
    cases = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for b, c, h, w, relu in sites:
            x = torch.randn((b, c, h, w), generator=gen, device="cuda") * 2 + 0.5
            x = x.to(dtype)
            nbytes = 2 * x.numel() * x.element_size()
            got = fused_instance_norm(x, relu=relu)
            again = fused_instance_norm(x, relu=relu)
            want = instance_norm_plain(x, relu=relu)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = IN_TOL[dtype_name]
            layout = plan(b * c, h * w, dtype)
            case = {
                "dtype": dtype_name, "b": b, "c": c, "h": h, "w": w, "relu": relu,
                "plan": layout.__dict__, "max_abs_err": err, "tol": tol,
                "repeat_bitwise_equal": torch.equal(got, again),
                **time_cold_ms(torch, {
                    "kernel_ms": lambda t, r=relu: fused_instance_norm(t, relu=r),
                    "plain_ms": lambda t, r=relu: instance_norm_plain(t, relu=r),
                    "library_ms": F.instance_norm,
                }, x, flush),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            }
            case["over_library"] = case["kernel_ms"] / case["library_ms"]
            case["over_bound"] = case["kernel_ms"] / case["bound_ms"]
            cases.append(case)
            log(f"IN {dtype_name:8s} B={b} [{c},{h},{w}] relu={int(relu)} "
                f"{layout.variant}/{layout.planes_per_block}/{layout.cluster}: "
                f"max_abs_err {err:.3g} (tol {tol}) kernel {case['kernel_ms']:.4f} ms "
                f"plain {case['plain_ms']:.4f} ms library {case['library_ms']:.4f} ms "
                f"bound {case['bound_ms']:.4f} ms; kernel/library {case['over_library']:.2f} "
                f"kernel/bound {case['over_bound']:.2f}")
            check(err <= tol, f"IN kernel disagrees with its plain version: {case}")
            check(case["repeat_bitwise_equal"], f"two IN launches differ: {case}")
            del x, got, again, want
    del flush
    torch.cuda.empty_cache()
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")

    def per_sites(dtype_name: str, sites: list, label: str) -> dict:
        table = {(k["b"], k["c"], k["h"], k["w"], k["relu"]): k for k in cases
                 if k["dtype"] == dtype_name}
        sums = {key: sum(table[site][key] for site in sites) for key in keys}
        sums["over_bound"] = sums["kernel_ms"] / sums["bound_ms"]
        log(f"IN per {label} ({dtype_name}, {len(sites)} sites): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sums.items()))
        return sums

    encode = {f"{dtype_name}_b{b}": per_sites(
        dtype_name, [(b, *site) for site in ENCODE_SITES], f"encode at B={b}")
        for dtype_name in IN_TOL for b in (1, 4)}
    d_step = {dtype_name: per_sites(dtype_name, D_IN_SITES, "D step")
              for dtype_name in IN_TOL}
    fused = {dtype_name: per_sites(dtype_name, FUSED_IN_SITES, "fused step")
             for dtype_name in IN_TOL}
    prod = {dtype_name: per_sites(dtype_name, P_STEP_IN_SITES, f"{P_SIZE}^2 step")
            for dtype_name in IN_TOL}
    slower = [{k: c[k] for k in ("dtype", "b", "c", "h", "w", "relu", "over_library")}
              for c in cases if c["over_library"] > 1]
    log(f"IN sites slower than F.instance_norm: {len(slower)} of {len(cases)} {slower}")
    high_mean = _in_high_mean(torch)
    log(f"phase 2 ok: {len(cases)} kernel cases and the bf16 high-|mean| site in "
        f"{len(high_mean['layouts'])} layouts within tolerance, repeats bitwise equal")
    return {"cases": cases, "per_encode": encode, "per_d_step": d_step,
            "per_fused_step": fused, "per_production_step": prod, "slower_than_library": slower,
            "high_mean_bf16": high_mean}


def high_mean_planes(torch, planes: int, device, seed: int = 0):
    """[1, planes, 16, 16] bfloat16 planes of 255 with 11 pixels at 256
    (at seeded random places): |mean| / std = 1258. Every sum and sum of
    squares of such a plane is exact in float32, in any order, so any
    summation gives the same moment statistics; and there the moment
    variance max(E[x^2] - E[x]^2, 0) gives another bf16 rstd than the
    centred one (4.8125 against 4.9375), so the two formulas' outputs
    differ by 0.125, beyond the 0.05 tolerance."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.full((planes, 256), 255.0)
    for k in range(planes):
        x[k, torch.randperm(256, generator=gen)[:11]] = 256.0
    return x.view(1, planes, 16, 16).to(device=device, dtype=torch.bfloat16)


def centred_bf16_plain(torch, x):
    """The bf16 instance norm with the centred variance in place of the
    moment form: what the kernel computed in bfloat16 before it followed
    its plain version."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean.to(torch.bfloat16)) * torch.rsqrt(var + 1e-5).to(torch.bfloat16)


def _in_high_mean(torch) -> dict:
    """The bf16 high-|mean| site (``high_mean_planes``) through the plan's
    layout and every other: packed at 1, 2, 4 and 8 planes a block,
    resident, clusters of 2, 4 and 8; each held to the plain version within
    IN_TOL, and the centred formula shown to lie beyond it."""
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, instance_norm_plain
    from one_to_many_gan_torch.ops.cuda import instance_norm as m

    x = high_mean_planes(torch, 64, "cuda")
    planes, hw = x.shape[1], x.shape[2] * x.shape[3]
    want = instance_norm_plain(x)
    layouts = {"plan": None, "resident": m.Plan("resident", 1, 1, 256, m._range_smem(hw, 2),
                                                planes)}
    for ppb in (2, 4, 8):
        layouts[f"packed{ppb}"] = m.Plan("packed", ppb, 1, 256, m._range_smem(ppb * hw, 2),
                                         -(-planes // ppb))
    for cluster in (2, 4, 8):
        layouts[f"cluster{cluster}"] = m.Plan("cluster", 1, cluster, 256,
                                              m._range_smem(-(-hw // cluster), 2),
                                              planes * cluster)
    errs = {}
    for name, layout in layouts.items():
        got = (fused_instance_norm(x) if layout is None
               else m._launch(x, False, 1e-5, layout))
        errs[name] = (got.float() - want.float()).abs().max().item()
    centred = (centred_bf16_plain(torch, x).float() - want.float()).abs().max().item()
    stats = x.float().view(planes, -1)
    ratio = (stats.mean(1).abs() / stats.std(1, unbiased=False)).min().item()
    log(f"IN bf16 high-|mean| site [1,{planes},16,16], |mean|/std >= {ratio:.0f}: max abs err "
        f"per layout " + " ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {IN_TOL['bfloat16']}); the centred formula lies {centred:.3g} away")
    for name, err in errs.items():
        check(err <= IN_TOL["bfloat16"], f"IN high-|mean| site, layout {name}: {err}")
    check(centred > IN_TOL["bfloat16"], f"the high-|mean| site does not tell the formulas "
          f"apart: the centred one lies {centred} from the plain version")
    return {"layouts": errs, "centred_vs_plain": centred, "mean_over_std": ratio}


# ---------------------------------------------------------------- phase 3


def _png(image_u8: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image_u8.squeeze(-1)).save(buf, format="PNG")
    return buf.getvalue()


def _source_image(seed: int, h: int, w: int) -> np.ndarray:
    """A smooth random grey image [H, W, 1] uint8 (low-frequency noise)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 16 + 1, w // 16 + 1))
    img = np.kron(coarse, np.ones((16, 16)))[:h, :w]
    return img.astype(np.uint8)[:, :, None]


def _post(port: int, body: bytes, **query) -> tuple[bytes, float]:
    url = f"http://127.0.0.1:{port}/generate?" + "&".join(f"{k}={v}" for k, v in query.items())
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "image/png"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        payload = resp.read()
    return payload, (time.perf_counter() - t0) * 1e3


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


def _npy(payload: bytes) -> np.ndarray:
    return np.load(io.BytesIO(payload))


def _check_out(out: np.ndarray, n: int, h: int, w: int) -> None:
    check(out.shape == (n, h, w, 1), f"output shape {out.shape}, want {(n, h, w, 1)}")
    check(out.dtype == np.uint8, f"output dtype {out.dtype}")
    if n > 1:
        check(not np.array_equal(out[0], out[1]), "styles do not differ within a request")


def phase_serve(torch, config, source: np.ndarray) -> tuple[dict, object]:
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm
    from one_to_many_gan_torch.ops.cuda import upsample as upsample_kernel
    from one_to_many_gan_torch.serve import InferenceEngine, make_server

    h, w = config["data"]["image_size"]
    engine = InferenceEngine(config, buckets=BUCKETS)
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    warm_s = engine.warmup()
    log(f"engine warm in {warm_s:.2f} s on {engine.device}")
    server = make_server(engine, "127.0.0.1", 0, max_batch=4)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    body = _png(source)
    result = {"warmup_s": warm_s, "buckets": {}}
    try:
        fused_instance_norm.launches = 0
        upsample_kernel.upsample2x.launches = 0
        engine.device_calls = 0
        # the main path: HTTP requests through the batcher to the card
        for n in BUCKETS:
            npy_ms, zip_ms = [], []
            for rep in range(REPS):
                payload, ms = _post(port, body, n=n, seed=rep, format="npy")
                _check_out(_npy(payload), n, h, w)
                npy_ms.append(ms)
                payload, ms = _post(port, body, n=n, seed=rep)
                with zipfile.ZipFile(io.BytesIO(payload)) as zf:
                    names = zf.namelist()
                check(len(names) == n and names[0] == "shoemark_0000.png", f"zip {names[:3]}")
                zip_ms.append(ms)
            med = statistics.median(npy_ms)
            result["buckets"][n] = {"npy_ms": npy_ms, "zip_ms": zip_ms,
                                    "npy_images_per_s": n / med * 1e3}
            log(f"n={n}: npy latency median {med:.2f} ms ({n / med * 1e3:.1f} images/s), "
                f"zip median {statistics.median(zip_ms):.2f} ms")
        same_a = _npy(_post(port, body, n=8, seed=7, theta=1.0, format="npy")[0])
        same_b = _npy(_post(port, body, n=8, seed=7, theta=1.0, format="npy")[0])
        theta0 = _npy(_post(port, body, n=8, seed=7, theta=0.0, format="npy")[0])
        check(np.array_equal(same_a, same_b), "the same seed gave different outputs")
        check(not np.array_equal(same_a, theta0), "theta=0 equals theta=1")
        # a concurrent burst of 4 for the batcher
        burst: dict[int, np.ndarray] = {}
        barrier = threading.Barrier(4)

        def client(i: int) -> None:
            barrier.wait()
            burst[i] = _npy(_post(port, body, n=8, seed=100 + i, format="npy")[0])

        clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        check(sorted(burst) == [0, 1, 2, 3], f"burst answered {sorted(burst)}")
        for out in burst.values():
            _check_out(out, 8, h, w)
        health = _get(port, "/healthz")
        stats = _get(port, "/stats")
        launches, calls = fused_instance_norm.launches, engine.device_calls
        up_launches = upsample_kernel.upsample2x.launches
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(timeout=30)
    log(f"/healthz {json.dumps(health)}")
    log(f"/stats {json.dumps(stats)}")
    check(health["status"] == "ok" and health["device"].startswith("cuda"), "healthz")
    check(stats["errors"] == 0, f"server errors: {stats}")
    check(calls > 0 and launches == 9 * calls,
          f"IN launches {launches} for {calls} device calls (want 9 per call)")
    log(f"IN kernel launches on the main path: {launches} for {calls} device calls "
        f"({launches // calls} per call); upsample kernel launches {up_launches}")
    check(up_launches >= 2 * calls, f"{up_launches} upsample launches for {calls} device calls")
    # batch equals solo on the card: one coalesced call against solo calls
    imgs = [_source_image(10 + i, h, w) for i in range(3)]
    batched = engine.generate_batch(imgs, [8, 8, 8], [1, 2, 3], [1.0, 0.5, 1.0])
    for i in range(3):
        solo = engine.generate(imgs[i], 8, seed=i + 1, theta=[1.0, 0.5, 1.0][i])
        diff = np.abs(batched[i].astype(int) - solo.astype(int)).max()
        check(diff <= 1, f"coalesced request {i} differs from solo by {diff} levels")
    result.update({"launches": launches, "upsample_launches": up_launches,
                   "device_calls": calls, "stats": stats,
                   "coalesced_requests": stats["batching"]["coalesced_requests"]})
    log("phase 3 ok: server answered every request; batch equals solo")
    return result, engine


# ---------------------------------------------------------------- phase 4/5


def _fixed_inputs(torch, source: np.ndarray, w_dim: int, n: int = 2):
    from one_to_many_gan_torch.data.pipeline import normalize_u8

    image = torch.from_numpy(normalize_u8(source[None]))
    z = torch.from_numpy(np.random.default_rng(5).standard_normal((1, n, w_dim)).astype(np.float32))
    return image, z, torch.ones(1)


def phase_card_vs_cpu(torch, config, engine, source: np.ndarray) -> tuple[dict, np.ndarray]:
    from one_to_many_gan_torch.core import Models, make_inference_fns

    args = _fixed_inputs(torch, source, engine.models.w_dim)
    card = make_inference_fns(engine.models)[2](*args).float().cpu().numpy()
    cpu_models = Models(config, device="cpu", seed=0)
    t0 = time.perf_counter()
    cpu = make_inference_fns(cpu_models)[2](*args).float().numpy()
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(card - cpu).max())
    log(f"card vs CPU (B=1, n=2, float32, TF32 off): max_abs_err {err:.3g} "
        f"(tol {CARD_VS_CPU_TOL}); CPU pass {cpu_s:.1f} s")
    check(np.isfinite(card).all() and card.shape == (2, *config["data"]["image_size"], 1),
          f"card output {card.shape}")
    check(err <= CARD_VS_CPU_TOL, f"card disagrees with the CPU: {err}")
    log("phase 4 ok")
    return {"max_abs_err": err, "tol": CARD_VS_CPU_TOL}, card


def phase_bf16(torch, config, source: np.ndarray, card_f32: np.ndarray):
    from one_to_many_gan_torch.core import make_inference_fns
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm
    from one_to_many_gan_torch.ops.cuda import upsample as upsample_kernel
    from one_to_many_gan_torch.serve import InferenceEngine

    cfg = copy.deepcopy(config)
    cfg["tpu"]["precision"] = "bfloat16"
    engine = InferenceEngine(cfg, buckets=BUCKETS)
    warm_s = engine.warmup(batched=False)
    out = make_inference_fns(engine.models)[2](*_fixed_inputs(torch, source, engine.models.w_dim))
    check(out.dtype == torch.bfloat16, f"bf16 output dtype {out.dtype}")
    diff = np.abs(out.float().cpu().numpy() - card_f32)
    log(f"bf16 vs f32 on the card: mean abs {diff.mean():.4g} (tol {BF16_MEAN_TOL}), "
        f"max abs {diff.max():.4g}; warm in {warm_s:.2f} s")
    check(np.isfinite(diff).all() and diff.mean() < BF16_MEAN_TOL, "bf16 drifted from f32")
    h, w = cfg["data"]["image_size"]
    latency = {}
    fused_instance_norm.launches = 0
    upsample_kernel.upsample2x.launches = 0
    engine.device_calls = 0
    for n in BUCKETS:
        times = []
        for rep in range(REPS):
            t0 = time.perf_counter()
            res = engine.generate(source, n, seed=rep)
            times.append((time.perf_counter() - t0) * 1e3)
            _check_out(res, n, h, w)
        med = statistics.median(times)
        latency[n] = {"engine_ms": times, "images_per_s": n / med * 1e3}
        log(f"bf16 n={n}: engine.generate median {med:.2f} ms ({n / med * 1e3:.1f} images/s)")
    check(fused_instance_norm.launches == 9 * engine.device_calls,
          f"bf16 IN launches {fused_instance_norm.launches} for {engine.device_calls} calls")
    # one decode chunk a call at these batches (B = 1, n <= 64): 2 upsamples
    up_launches = upsample_kernel.upsample2x.launches
    check(up_launches == 2 * engine.device_calls,
          f"bf16 upsample launches {up_launches} for {engine.device_calls} calls")
    log("phase 5 ok")
    return {"mean_abs_vs_f32": float(diff.mean()), "max_abs_vs_f32": float(diff.max()),
            "latency": latency, "upsample_launches": up_launches}, engine


# ---------------------------------------------------------------- phase 6


def profile_call(torch, fn, label: str, ranges: tuple = (), select=None) -> dict:
    """The device operations of one ``fn()`` (kernels, copies, memsets:
    the trace's, so the device side of a ``record_function`` range is
    none) ranked by device time, and the device's busy share of its wall
    time (``fn`` ends in a host read or a sync): the union of their
    intervals (``utils.profiling.device_busy_s``), so overlapping
    operations count once; for each ``torch.profiler.record_function``
    range named in ``ranges``, the device time of the kernels launched
    inside it; every operation whose name ``select`` accepts."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from one_to_many_gan_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    in_ranges = dict.fromkeys(ranges, 0.0)
    for evt in prof.key_averages():
        if evt.key in in_ranges and evt.device_type == DeviceType.CPU:
            us = getattr(evt, "device_time_total", None)
            in_ranges[evt.key] = (us if us is not None else evt.cuda_time_total) / 1e3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = profiling.trace_events(path)
    by_name: dict[str, dict] = {}
    for e in events:
        if e.get("cat") in profiling.DEVICE_CATS:
            k = by_name.setdefault(e["name"], {"name": e["name"], "calls": 0, "ms": 0.0})
            k["calls"] += 1
            k["ms"] += float(e["dur"]) / 1e3
    kernels = sorted(by_name.values(), key=lambda k: -k["ms"])
    busy_ms = profiling.device_busy_s(profiling.device_intervals(events)) * 1e3
    check(busy_ms > 0, f"the profiler saw no device time in {label}")
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%}; idle {1 - busy_ms / wall_ms:.1%}), "
        f"{len(kernels)} kernel names")
    for k in kernels[:12]:
        log(f"  {k['ms']:9.3f} ms {k['ms'] / busy_ms:6.1%} x{k['calls']:<4d} {k['name'][:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernels": kernels[:40], "ranges_ms": in_ranges,
            "selected": [k for k in kernels if select is not None and select(k["name"])]}


def phase_profile(torch, engine, source: np.ndarray, label: str, n: int = 64) -> dict:
    """Kernels of one ``engine.generate`` at ``n`` ranked by device time,
    and the device's busy share of the request's wall time."""
    return profile_call(torch, lambda: engine.generate(source, n, seed=0), f"{label} n={n}")


# ---------------------------------------------------------------- phase 7


def _warp_inputs(torch, gen, b: int, h: int, w: int, dtype, antialias: bool):
    """Images and the coordinates and widths of ADA draws at p = 0.9."""
    from one_to_many_gan_torch.augment.pipeline import (
        draw_augment,
        geometric_matrix,
        source_coords,
        tent_widths,
    )

    draws = draw_augment(gen, b, "cuda")
    g = geometric_matrix(draws.geom, h, w, torch.tensor(0.9, device="cuda"))
    sx, sy = source_coords(g, h, w)
    wx, wy = tent_widths(g, antialias=antialias)
    x = (torch.rand((b, h, w), generator=gen, device="cuda") * 2 - 1).to(dtype)
    return x, sx.contiguous(), sy.contiguous(), wx, wy


def _taps(torch, c, width, n: int, antialias: bool):
    """In-frame taps per output pixel on one axis: the integer positions
    within (c - width, c + width) of [0, n) (width 1 without antialias)."""
    wd = width[:, None, None] if antialias else 1.0
    lo = torch.clamp(torch.floor(c - wd) + 1, min=0)
    hi = torch.clamp(torch.ceil(c + wd) - 1, max=n - 1)
    return torch.clamp(hi - lo + 1, min=0)


def phase_warp(torch) -> dict:
    import torch.nn.functional as F

    from one_to_many_gan_torch.ops.cuda import warp, warp_plain

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on: the plain warp needs f32")
    gen = torch.Generator("cuda").manual_seed(7)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for b, h, w in WARP_SHAPES:
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for aa in (False, True):
                x, sx, sy, wx, wy = _warp_inputs(torch, gen, b, h, w, dtype, aa)
                got = warp(x, sx, sy, wx, wy, antialias=aa)
                want = warp_plain(x, sx, sy, wx, wy, antialias=aa)
                torch.cuda.synchronize()
                diff = (got.double() - want.double()).abs()
                err = diff.max().item()
                mag = torch.maximum(got.double().abs(), want.double().abs()).clamp_min(2.0**-126)
                ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
                ulps = (diff / ulp).max().item()
                # bf16: one ulp is the two roundings; what exceeds it is the
                # kernel's float32 summation error, held to its bound
                sum_bound = WARP_TOL_BF16_SUM * x.abs().max().item()
                excess = ((diff - ulp).clamp_min(0) / sum_bound).max().item()
                fns = {
                    "kernel_ms": lambda t, a=(sx, sy, wx, wy, aa): warp(t, *a[:4], antialias=a[4]),
                    "plain_ms": lambda t, a=(sx, sy, wx, wy, aa): warp_plain(
                        t, *a[:4], antialias=a[4]),
                }
                lib_err = None
                if not aa and dtype == torch.float32:
                    # grid_sample, align_corners=True: pixel = (g + 1) / 2 * (n - 1)
                    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], dim=-1)

                    def lib(t, grid=grid):
                        return F.grid_sample(t[:, None], grid, mode="bilinear",
                                             padding_mode="zeros", align_corners=True)[:, 0]

                    fns["library_ms"] = lib
                    lib_err = (lib(x) - want).abs().max().item()
                times = time_cold_ms(torch, fns, x, flush)
                px = b * h * w
                nbytes = px * (2 * x.element_size() + 8) + 2 * b * 4
                taps = (_taps(torch, sx, wx, w, aa) * _taps(torch, sy, wy, h, aa)).sum().item()
                ops_ms = 2 * taps / F32_FLOP_PER_S * 1e3
                case = {
                    "b": b, "h": h, "w": w, "dtype": dtype_name, "antialias": aa,
                    "max_abs_err": err, "max_bf16_ulps": ulps, "bf16_excess_of_sum_bound": excess,
                    "grid_sample_err": lib_err,
                    "widths": [wx.min().item(), wx.max().item(), wy.min().item(), wy.max().item()],
                    "taps_per_pixel": taps / px, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "ops_ms": ops_ms, **times, "library_ms": times.get("library_ms"),
                }
                case["bound_ms"] = max(case["bytes_ms"], ops_ms)
                case["bound_by"] = "bytes" if case["bytes_ms"] >= ops_ms else "operations"
                cases.append(case)
                lib_txt = (f"grid_sample {case['library_ms']:.4f} ms (err {lib_err:.3g})"
                           if lib_err is not None else "grid_sample none" if aa else
                           "grid_sample n/a (a bf16 grid cannot hold pixel coordinates)")
                log(f"warp [{b},{h},{w}] {dtype_name:8s} aa={int(aa)}: max_abs_err {err:.3g} "
                    f"(bf16: {ulps:.2f} ulps, beyond one ulp {excess:.3f} of the sum bound) kernel {case['kernel_ms']:.4f} ms plain "
                    f"{case['plain_ms']:.4f} ms {lib_txt} bound {case['bound_ms']:.4f} ms "
                    f"({case['bound_by']}); {case['taps_per_pixel']:.1f} taps/pixel, widths "
                    + "/".join(f"{v:.2f}" for v in case["widths"]))
                check(torch.isfinite(got).all().item(), f"warp output not finite: {case}")
                if dtype == torch.float32:
                    check(err <= WARP_TOL_F32, f"warp kernel disagrees with its plain version: {case}")
                else:
                    check(excess <= 1.0 and err <= WARP_TOL_BF16_ABS,
                          f"bf16 warp kernel disagrees with its plain version: {case}")
                if lib_err is not None:
                    # grid_sample's normalised grid re-derives each coordinate
                    # (a few ulps of 255: ~1e-4 px), times the image's step
                    # between neighbours (up to 2 here)
                    check(lib_err <= 1e-3, f"grid_sample is not the same function: {case}")
    del flush
    torch.cuda.empty_cache()
    log(f"phase 7 ok: {len(cases)} warp cases within tolerance")
    return {"cases": cases}


# ---------------------------------------------------------------- phase 8


def d_phase_config(precision: str, batch: int, path_interval: int = 1):
    from one_to_many_gan_torch.presets import tiny_config

    return tiny_config(
        (D_SIZE, D_SIZE), batch, min_latent=64, w_dim=6, n_resnet_blocks=7, buffer_size=8,
        tpu={"precision": precision, "ada_pallas": True, "ada_antialias": True,
             "path_interval": path_interval},
    )


def phase_d_phase(torch) -> dict:
    from one_to_many_gan_torch import train_d
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp

    config = d_phase_config("bfloat16", D_BATCH)
    models, state, d_phase, gen = train_d.setup(config, seed=0, ada_p=D_ADA_P, device="cuda")
    check(models.device.type == "cuda", f"models on {models.device}")
    d0 = [p.detach().clone() for p in state.discriminator.parameters()]
    warp.launches = 0
    fused_instance_norm.launches = 0
    # the main path: D phases through the entry points a trainer calls
    step_ms, metrics_log, counts = [], [], []
    for step in range(D_WARMUP + D_STEPS):
        w0, i0 = warp.launches, fused_instance_norm.launches
        t0 = time.perf_counter()
        state, metrics = train_d.run_step(config, models, state, d_phase, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = {k: v.item() for k, v in metrics.items()}
        counts.append((warp.launches - w0, fused_instance_norm.launches - i0))
        metrics_log.append({**m, "buffer_count": state.buffer.count.item(),
                            "ada_count": state.ada.count.item(), "ms": ms})
        if step >= D_WARMUP:
            step_ms.append(ms)
    warps, ins = warp.launches, fused_instance_norm.launches
    n = D_WARMUP + D_STEPS
    for k, (nw, ni) in enumerate(counts):
        check(nw == D_WARPS_PER_STEP and ni == D_IN_PER_STEP,
              f"step {k}: {nw} warp and {ni} IN launches (want {D_WARPS_PER_STEP}, {D_IN_PER_STEP})")
    check(all(np.isfinite(m["disc_loss"]) for m in metrics_log), "a D loss is not finite")
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(state.discriminator.parameters(), d0, strict=True))
    check(moved > 0, "the discriminator's parameters did not change")
    fill = [m["buffer_count"] for m in metrics_log]
    size = config["training"]["image_buffer_size"]
    check(fill == [min(size, D_BATCH * (k + 1)) for k in range(n)], f"buffer counts {fill}")
    ada_counts = [m["ada_count"] for m in metrics_log]
    check(all(a != b for a, b in zip(ada_counts, ada_counts[1:])), f"ADA window {ada_counts}")
    med = statistics.median(step_ms)
    log(f"D phase ({D_SIZE}x{D_SIZE}, batch {D_BATCH}, bf16): median step {med:.2f} ms over {D_STEPS} "
        f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}) = {D_BATCH / med * 1e3:.1f} images/s")
    log(f"  launches on the main path: {warps} warp, {ins} IN over {n} steps "
        f"({warps // n} and {ins // n} per step); losses {metrics_log[0]['disc_loss']:.4f} -> "
        f"{metrics_log[-1]['disc_loss']:.4f}; ADA p {metrics_log[-1]['ada_p']:.4f}, window "
        f"counts {ada_counts[:8]}...; D moved by up to {moved:.3g}")
    profile = profile_call(
        torch, lambda: train_d.run_step(config, models, state, d_phase, gen),
        f"D phase step ({D_SIZE}x{D_SIZE}, batch {D_BATCH}, bf16)")
    log("phase 8 ok")
    return {"step_ms": step_ms, "median_step_ms": med, "images_per_s": D_BATCH / med * 1e3,
            "warp_launches": warps, "in_launches": ins, "steps": n, "metrics": metrics_log,
            "profile": profile, "max_abs_move": moved}


# ---------------------------------------------------------------- phase 9


def _to(tree, device):
    """Move every tensor of nested NamedTuples to ``device``."""
    if isinstance(tree, tuple):
        return type(tree)(*(_to(t, device) for t in tree))
    return None if tree is None else tree.to(device)


@contextlib.contextmanager
def _cudnn_flags(torch, **flags):
    """``torch.backends.cudnn`` flags set inside the block, restored after."""
    cudnn = torch.backends.cudnn
    old = {k: getattr(cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(cudnn, k, v)


def _d_grads(disc) -> dict:
    return {n: p.grad.double().cpu() for n, p in disc.named_parameters()}


def _zero_grad_leaf(name: str) -> bool:
    """The biases of the convs an instance norm follows: gradient 0 in exact
    arithmetic, so rounding noise on every side."""
    return name.endswith("bias") and name.startswith(("trunk.1", "trunk.2", "trunk.3"))


def _grad_rel(grads: dict, ref: dict) -> dict:
    """Per leaf: |grads - ref| / |ref| (Frobenius norms)."""
    return {n: ((g - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)).item()
            for n, g in grads.items()}


def _exact_zeros(torch, disc, inputs) -> list:
    """Share of each trunk conv's outputs that is exactly 0 in one forward
    pass, where LeakyReLU's derivative jumps (1 at 0, 0.2 below)."""
    shares = []
    hooks = [conv.register_forward_hook(
        lambda _m, _i, out: shares.append((out == 0).double().mean().item()))
        for conv in disc.trunk]
    try:
        with torch.no_grad():
            disc(inputs)
    finally:
        for h in hooks:
            h.remove()
    return shares


def phase_d_card_vs_cpu(torch) -> dict:
    from one_to_many_gan_torch.core import train_step
    from one_to_many_gan_torch.core.state import Models, init_train_state
    from one_to_many_gan_torch.models import Discriminator

    config = d_phase_config("float32", D_CPU_BATCH)
    cpu_gen = torch.Generator().manual_seed(3)
    draws = train_step.draw_d_phase(cpu_gen, config, Models(config, device="cpu"))
    prints = train_step.synthetic_batch(cpu_gen, D_CPU_BATCH, (D_SIZE, D_SIZE), 1)
    marks = train_step.synthetic_batch(cpu_gen, D_CPU_BATCH, (D_SIZE, D_SIZE), 1)
    # The D pass of one phase, as d_phase runs it: its inputs (generator,
    # buffer, augment), then the loss and gradients on the packed batch.
    runs = {}
    for device in ("cuda", "cpu"):
        models = Models(config, device=device, seed=0)  # float32 on CUDA: TF32 off
        state = init_train_state(config, models, seed=0)
        state.ada = state.ada._replace(p=torch.tensor(D_ADA_P, device=device))
        t0 = time.perf_counter()
        aug_fake, aug_real, _ = train_step.make_d_inputs(config, models)(
            state, prints, marks, _to(draws, device))
        loss, real, fake = train_step.d_loss_and_grad(state.discriminator, aug_fake, aug_real)
        runs[device] = {
            "seconds": time.perf_counter() - t0, "loss": loss.item(),
            "scores": (real.cpu(), fake.cpu()), "inputs": (aug_fake.cpu(), aug_real.cpu()),
            "grads": _d_grads(state.discriminator), "disc": state.discriminator,
        }
    check(not torch.backends.cudnn.allow_tf32, "TF32 is on for the float32 card run")
    card, cpu = runs["cuda"], runs["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    input_err = max((a - b).abs().max().item()
                    for a, b in zip(card["inputs"], cpu["inputs"], strict=True))
    score_err = max((a - b).abs().max().item()
                    for a, b in zip(card["scores"], cpu["scores"], strict=True))
    total = torch.sqrt(sum(g.square().sum() for g in cpu["grads"].values())).item()
    card_vs_cpu = _grad_rel(card["grads"], cpu["grads"])

    # Where the card's gradient error comes from: one float64 pass on the
    # CPU (plain ops, the same weights) on the CPU's inputs, against the
    # CPU's float32 gradients and the card's, on the same inputs, as
    # configured, with cuDNN restricted to deterministic algorithms,
    # without cuDNN (PyTorch's own CUDA convolutions) and with TF32 on.
    packed = train_step.batch_pack(list(cpu["inputs"])).permute(0, 3, 1, 2)
    disc64 = Discriminator(1, dtype=torch.float64)
    disc64.load_state_dict(cpu["disc"].state_dict())
    t0 = time.perf_counter()
    train_step.d_loss_and_grad(disc64, *(t.double() for t in cpu["inputs"]))
    f64_s = time.perf_counter() - t0
    ref = _d_grads(disc64)
    vs_f64 = {"cpu": _grad_rel(cpu["grads"], ref)}
    # how far the inputs' difference alone moves the CPU's gradients
    train_step.d_loss_and_grad(cpu["disc"], *card["inputs"])
    input_effect = _grad_rel(_d_grads(cpu["disc"]), cpu["grads"])
    zeros = {"float64, CPU": _exact_zeros(torch, disc64, packed.double()),
             "cpu": _exact_zeros(torch, cpu["disc"], packed)}
    inputs = [t.cuda() for t in cpu["inputs"]]
    modes = {"card": {}, "card, cuDNN deterministic": {"deterministic": True},
             "card, no cuDNN": {"enabled": False}, "card, TF32 on": {"allow_tf32": True}}
    for label, flags in modes.items():
        with _cudnn_flags(torch, **flags):
            train_step.d_loss_and_grad(card["disc"], *inputs)
            vs_f64[label] = _grad_rel(_d_grads(card["disc"]), ref)
            zeros[label] = _exact_zeros(torch, card["disc"], packed.cuda())
    check(not torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.enabled,
          "cuDNN flags were not restored")
    precision = {name: getattr(obj, "fp32_precision", None) for name, obj in (
        ("cudnn.conv", getattr(torch.backends.cudnn, "conv", None)),
        ("cuda.matmul", torch.backends.cuda.matmul))}

    names = list(ref)
    log(f"D phase card vs CPU ({D_SIZE}x{D_SIZE}, batch {D_CPU_BATCH}, float32, TF32 off; "
        f"fp32_precision {precision}): inputs max abs {input_err:.3g}; loss {card['loss']:.6f} "
        f"vs {cpu['loss']:.6f} (rel {loss_rel:.3g}, tol {D_LOSS_RTOL}); scores max abs "
        f"{score_err:.3g} (tol {D_SCORE_ATOL}); CPU pass {cpu['seconds']:.1f} s, float64 "
        f"pass {f64_s:.1f} s")
    log("  gradient error per leaf, relative to its norm (leaves with gradient 0 in exact "
        "arithmetic: absolute, relative to the whole gradient's norm):")
    log(f"  {'':38s}" + "".join(f"{n:>15s}" for n in names))
    rows = {"card vs CPU (own inputs)": card_vs_cpu,
            "CPU on the card's inputs vs CPU": input_effect,
            **{f"{k} vs float64": v for k, v in vs_f64.items()}}
    for label, rel in rows.items():
        log(f"  {label:38s}" + "".join(
            f"{rel[n] * ref[n].norm().item() / total if _zero_grad_leaf(n) else rel[n]:15.3g}"
            for n in names))
    log("  share of exact zeros at the trunk convs' outputs: " + "; ".join(
        f"{k} " + "/".join(f"{z:.4f}" for z in v) for k, v in zeros.items()))

    check(input_err <= CARD_VS_CPU_TOL, f"D inputs: card disagrees with CPU by {input_err}")
    check(np.isfinite(card["loss"]) and loss_rel <= D_LOSS_RTOL, "D loss: card disagrees with CPU")
    check(score_err <= D_SCORE_ATOL, f"D scores: card disagrees with CPU by {score_err}")
    for n in names:
        if _zero_grad_leaf(n):
            worst = max(card["grads"][n].norm().item(), cpu["grads"][n].norm().item())
            check(worst <= 1e-4 * total, f"{n}: gradient {worst:.3g} is not ~0")
            continue
        check(card_vs_cpu[n] <= D_GRAD_RTOL,
              f"{n}: card gradient off the CPU's by {card_vs_cpu[n]:.3g} of its norm")
        for label in ("cpu", "card"):
            check(vs_f64[label][n] <= D_GRAD_F64_RTOL,
                  f"{n}: {label} gradient off float64 by {vs_f64[label][n]:.3g} of its norm")
    log("phase 9 ok")
    return {"loss_card": card["loss"], "loss_cpu": cpu["loss"], "loss_rel": loss_rel,
            "input_max_abs": input_err, "score_max_abs": score_err,
            "grad_rel_card_vs_cpu": card_vs_cpu, "grad_rel_input_effect": input_effect,
            "grad_rel_vs_float64": vs_f64,
            "grad_norm_total": total, "exact_zero_shares": zeros, "fp32_precision": precision,
            "cpu_s": cpu["seconds"], "float64_s": f64_s}


# ---------------------------------------------------------------- phase 10


def phase_warp_bwd(torch) -> dict:
    from one_to_many_gan_torch.ops.cuda import warp, warp_bwd, warp_bwd_plain, warp_bwd_sum_bound

    gen = torch.Generator("cuda").manual_seed(11)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for b, h, w in WARP_SHAPES:
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for aa in (False, True):
                x, sx, sy, wx, wy = _warp_inputs(torch, gen, b, h, w, dtype, aa)
                dout = torch.randn((b, h, w), generator=gen, device="cuda").to(dtype)
                coords = (sx, sy, wx, wy)
                got = warp_bwd(dout, *coords, antialias=aa)
                again = warp_bwd(dout, *coords, antialias=aa)
                want = warp_bwd_plain(dout, *coords, antialias=aa)
                # the card's autograd path: the forward kernel, then the
                # backward kernel on the cotangent
                xr = x.clone().requires_grad_(True)
                out = warp(xr, *coords, antialias=aa)
                check(out.grad_fn is not None, "the warp's output has no grad_fn on the card")
                out.backward(dout)
                torch.cuda.synchronize()
                diff = (got.double() - want.double()).abs()
                auto_diff = (xr.grad.double() - want.double()).abs()
                err, auto_err = diff.max().item(), auto_diff.max().item()
                excess = 0.0
                if dtype == torch.bfloat16:
                    # beyond one bf16 ulp, each pixel's error over its proven
                    # bound on the kernel's float32 sums
                    mag = torch.maximum(got.double().abs(), want.double().abs())
                    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0**-126))) - 7)
                    bound = warp_bwd_sum_bound(dout, *coords, antialias=aa).clamp_min(1e-300)
                    excess = max(((d - ulp).clamp_min(0) / bound).max().item()
                                 for d in (diff, auto_diff))
                fns = {
                    "kernel_ms": lambda t, c=coords, a=aa: warp_bwd(t, *c, antialias=a),
                    "plain_ms": lambda t, c=coords, a=aa: warp_bwd_plain(t, *c, antialias=a),
                }
                lib_err = None
                if not aa and dtype == torch.float32:
                    # grid_sample's input gradient, align_corners=True:
                    # pixel = (g + 1) / 2 * (n - 1)
                    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], dim=-1)
                    img = x[:, None]

                    def lib(t, grid=grid, img=img):
                        return torch.ops.aten.grid_sampler_2d_backward(
                            t[:, None], img, grid, 0, 0, True, [True, False])[0][:, 0]

                    fns["library_ms"] = lib
                    lib_err = (lib(dout) - want).abs().max().item()
                times = time_cold_ms(torch, fns, dout, flush)
                px = b * h * w
                esize = dout.element_size()
                # the function's bytes: dout, sx, sy and the widths read once,
                # dimg written once
                nbytes = px * (2 * esize + 8) + 2 * b * 4
                taps = (_taps(torch, sx, wx, w, aa) * _taps(torch, sy, wy, h, aa)).sum().item()
                ops_ms = 2 * taps / F32_FLOP_PER_S * 1e3
                case = {
                    "b": b, "h": h, "w": w, "dtype": dtype_name, "antialias": aa,
                    "max_abs_err": err, "autograd_max_abs_err": auto_err,
                    "bf16_excess_of_sum_bound": excess, "library_err": lib_err,
                    "repeat_bitwise_equal": torch.equal(got, again),
                    "max_abs_dimg": want.abs().max().item(),
                    "taps_per_pixel": taps / px, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "ops_ms": ops_ms, **times, "library_ms": times.get("library_ms"),
                }
                case["bound_ms"] = max(case["bytes_ms"], ops_ms)
                case["bound_by"] = "bytes" if case["bytes_ms"] >= ops_ms else "operations"
                cases.append(case)
                lib_txt = "library none" if lib_err is None else (
                    f"grid_sampler_2d_backward {case['library_ms']:.4f} ms (err {lib_err:.3g})")
                log(f"warp_bwd [{b},{h},{w}] {dtype_name:8s} aa={int(aa)}: max_abs_err {err:.3g} "
                    f"(autograd {auto_err:.3g}; bf16 beyond one ulp {excess:.3f} of the sum bound; "
                    f"max |dimg| {case['max_abs_dimg']:.3g}) kernel {case['kernel_ms']:.4f} ms "
                    f"plain {case['plain_ms']:.4f} ms {lib_txt} bound {case['bound_ms']:.4f} ms "
                    f"({case['bound_by']}); {case['taps_per_pixel']:.1f} taps/pixel")
                check(torch.isfinite(got).all().item(), f"warp_bwd output not finite: {case}")
                check(case["repeat_bitwise_equal"], f"two warp_bwd launches differ: {case}")
                if dtype == torch.float32:
                    check(max(err, auto_err) <= WARP_TOL_F32,
                          f"warp_bwd kernel disagrees with its plain version: {case}")
                else:
                    check(excess <= 1.0 and max(err, auto_err) <= WARP_TOL_BF16_ABS,
                          f"bf16 warp_bwd kernel disagrees with its plain version: {case}")
                lost = ((xr.grad == 0) & (want.abs() > 1e-3)).sum().item()
                check(lost == 0, f"the card's gradient is 0 at {lost} pixels where the plain "
                                 f"version's is not: {case}")
                if lib_err is not None:
                    # grid_sample re-derives each coordinate from its normalised
                    # grid (~1e-4 px), times |dout| summed over a pixel's terms
                    check(lib_err <= 1e-3 * case["max_abs_dimg"],
                          f"grid_sampler_2d_backward is not the same function: {case}")
                del x, dout, got, again, want, xr, out
    draws = _gather_draw_cases(torch, gen, flush)
    modes = _gather_modes(torch, gen)
    shares = _gather_prepass_share(torch, gen)
    del flush
    torch.cuda.empty_cache()
    log(f"phase 10 ok: {len(cases)} + {len(draws)} warp backward cases within tolerance, "
        "two launches bitwise equal in each")
    return {"cases": cases, "draw_cases": draws, "modes": modes, "prepass_share": shares}


def _check_bwd(torch, got, want, dout, coords, aa: bool, label: str) -> dict:
    """The gather against its plain version. bfloat16: one bf16 ulp +
    ``warp_bwd_sum_bound`` per pixel, as phase 10's main cases. float32:
    2e-6 + ``warp_bwd_sum_bound`` per pixel: under a 4x magnification a
    pixel sums ~16-64 terms to |dimg| ~ 20, whose float32 rounding in any
    order (the bound) exceeds 2e-6 alone; ``over_2e-6`` says whether the
    error did."""
    from one_to_many_gan_torch.ops.cuda import warp_bwd_sum_bound

    diff = (got.double() - want.double()).abs()
    err = diff.max().item()
    check(torch.isfinite(got).all().item(), f"{label}: warp_bwd output not finite")
    bound = warp_bwd_sum_bound(dout, *coords, antialias=aa).clamp_min(1e-300)
    if got.dtype == torch.float32:
        excess = ((diff - WARP_TOL_F32).clamp_min(0) / bound).max().item()
    else:
        mag = torch.maximum(got.double().abs(), want.double().abs())
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0**-126))) - 7)
        excess = ((diff - ulp).clamp_min(0) / bound).max().item()
    check(excess <= 1.0 and err <= WARP_TOL_BF16_ABS,
          f"{label}: warp_bwd off its plain version ({err}, {excess} of the sum bound)")
    return {"max_abs_err": err, "excess_of_sum_bound": excess,
            "over_2e-6": got.dtype == torch.float32 and err > WARP_TOL_F32}


def gather_transforms(torch, gen, b: int, h: int, w: int, device="cuda") -> dict:
    """Inverse transforms [b, 3, 3] that the warp backward's gather finds
    hardest: rotations by multiples of 90 degrees with and without the
    x-flip (the hint's inverse swaps and negates axes), ADA draws at p = 1
    magnified 4x (a tile's region outgrows a block's shared memory:
    chunks) and minified 4x (tents to the width cap, 9 taps a side)."""
    import math

    from one_to_many_gan_torch.augment.pipeline import draw_augment, geometric_matrix

    k = torch.arange(b, device=device)
    ang = (k % 4).float() * (math.pi / 2)
    c, s = torch.cos(ang).round(), torch.sin(ang).round()
    flip = 1.0 - 2.0 * (k // 4 % 2).float()
    rot = torch.zeros((b, 3, 3), device=device)
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = c * flip, -s, s * flip, c
    rot[:, 2, 2] = 1.0
    ada = geometric_matrix(draw_augment(gen, b, device).geom, h, w,
                           torch.tensor(1.0, device=device))

    def scale(f: float):
        return torch.diag(torch.tensor([f, f, 1.0], device=device))

    return {"rot90_flip": rot, "magnify_4x": ada @ scale(0.25), "minify_4x": ada @ scale(4.0)}


def _gather_draw_cases(torch, gen, flush) -> list:
    """The gather at [16, 256, 256] on ``gather_transforms``, both
    dtypes, antialias on (the width-cap case with widths of exactly
    AA_MAX_WIDTH), and on random, non-affine coordinates at [4, 8, 8]: each
    held to the plain version, two launches bitwise equal, timed."""
    from one_to_many_gan_torch.augment.pipeline import source_coords, tent_widths
    from one_to_many_gan_torch.ops.cuda import warp_bwd, warp_bwd_plain
    from one_to_many_gan_torch.ops.cuda.warp import AA_MAX_WIDTH

    b, h, w = WARP_SHAPES[0]
    inputs = []
    for label, g in gather_transforms(torch, gen, b, h, w).items():
        sx, sy = source_coords(g, h, w)
        wx, wy = tent_widths(g, antialias=True)
        if label == "minify_4x":  # the width cap
            label, wx, wy = "width_cap", *(torch.full((b,), AA_MAX_WIDTH, device="cuda"),) * 2
        inputs.append((label, (b, h, w), (sx.contiguous(), sy.contiguous(), wx, wy)))
    rb, rh, rw = 4, 8, 8
    rand = [torch.rand((rb, rh, rw), generator=gen, device="cuda") * (n + 4) - 2
            for n in (rw, rh)]
    widths = torch.full((rb,), 1.5, device="cuda")
    inputs.append(("random_8x8", (rb, rh, rw), (*rand, widths, widths)))
    cases = []
    for label, shape, coords in inputs:
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            dout = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            got = warp_bwd(dout, *coords, antialias=True)
            again = warp_bwd(dout, *coords, antialias=True)
            want = warp_bwd_plain(dout, *coords, antialias=True)
            torch.cuda.synchronize()
            case = {"case": label, "shape": list(shape), "dtype": dtype_name,
                    **_check_bwd(torch, got, want, dout, coords, True, f"warp_bwd {label}"),
                    "repeat_bitwise_equal": torch.equal(got, again),
                    "widths": [coords[2].min().item(), coords[2].max().item(),
                               coords[3].min().item(), coords[3].max().item()],
                    **time_cold_ms(torch, {"kernel_ms": lambda t, c=coords: warp_bwd(
                        t, *c, antialias=True)}, dout, flush, reps=10)}
            check(case["repeat_bitwise_equal"], f"two warp_bwd launches differ: {case}")
            cases.append(case)
            log(f"warp_bwd {label} {list(shape)} {dtype_name:8s}: max_abs_err "
                f"{case['max_abs_err']:.3g} (beyond 2e-6 in f32 / one ulp in bf16: "
                f"{case['excess_of_sum_bound']:.3f} of the sum bound), repeat bitwise "
                f"equal, kernel {case['kernel_ms']:.4f} ms, widths "
                + "/".join(f"{v:.2f}" for v in case["widths"]))
    return cases


def _gather_modes(torch, gen) -> dict:
    """The gather under ``torch.use_deterministic_algorithms(True)`` (it
    runs, with the same bits as outside it), and its NaN contract: with
    antialias, an image with one NaN coordinate, or one whose width the
    dispatch refuses, comes out NaN over the whole image, the others
    finite and unchanged."""
    from one_to_many_gan_torch.ops.cuda import warp_bwd
    from one_to_many_gan_torch.ops.cuda.warp import AA_MAX_WIDTH

    b, h, w = 4, 64, 64
    x, sx, sy, wx, wy = _warp_inputs(torch, gen, b, h, w, torch.bfloat16, True)
    dout = torch.randn((b, h, w), generator=gen, device="cuda").to(torch.bfloat16)
    plain = warp_bwd(dout, sx, sy, wx, wy, antialias=True)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det = warp_bwd(dout, sx, sy, wx, wy, antialias=True)
    finally:
        torch.use_deterministic_algorithms(was)
    check(torch.equal(plain, det), "warp_bwd under deterministic algorithms differs")
    nan_sx = sx.clone()
    nan_sx[1, 5, 7] = float("nan")
    wide = wx.clone()
    wide[2] = torch.nextafter(torch.tensor(AA_MAX_WIDTH), torch.tensor(5.0)).item()
    out = warp_bwd(dout, nan_sx, sy, wide, wy, antialias=True)
    torch.cuda.synchronize()
    check(out[1].isnan().all().item() and out[2].isnan().all().item(),
          "warp_bwd: a NaN coordinate or a refused width did not give a NaN image")
    check(torch.equal(out[0], plain[0]) and torch.equal(out[3], plain[3]),
          "warp_bwd: a NaN image changed another image's cotangent")
    log("warp_bwd: runs under torch.use_deterministic_algorithms(True) with the same bits; "
        "a NaN coordinate or a refused width gives that image a NaN cotangent, the others "
        "unchanged")
    return {"deterministic_mode_bitwise_equal": True, "nan_contract": True}


def _gather_prepass_share(torch, gen) -> dict:
    """Device time of the pre-pass and of the gather over 20 calls at the
    fused step's [16, 256, 256], bf16, antialias on, ADA draws at p = 0.9
    (torch.profiler, warm L2)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from one_to_many_gan_torch.ops.cuda import warp_bwd

    b, h, w = WARP_SHAPES[0]
    x, sx, sy, wx, wy = _warp_inputs(torch, gen, b, h, w, torch.bfloat16, True)
    dout = torch.randn((b, h, w), generator=gen, device="cuda").to(torch.bfloat16)
    warp_bwd(dout, sx, sy, wx, wy, antialias=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            warp_bwd(dout, sx, sy, wx, wy, antialias=True)
        torch.cuda.synchronize()
    us = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and "warp_bwd" in evt.key:
            t = getattr(evt, "self_device_time_total", None)
            us["hint" if "hint" in evt.key else "gather"] = (
                t if t is not None else evt.self_cuda_time_total) / 20
    check(set(us) == {"hint", "gather"}, f"the profiler saw {sorted(us)} of the backward")
    share = us["hint"] / (us["hint"] + us["gather"])
    log(f"warp_bwd [16,256,256] bf16 aa=1, warm L2: pre-pass {us['hint'] / 1e3:.4f} ms, gather "
        f"{us['gather'] / 1e3:.4f} ms per call; the pre-pass's share {share:.1%}")
    return {"hint_ms": us["hint"] / 1e3, "gather_ms": us["gather"] / 1e3, "share": share}


# ---------------------------------------------------------------- phase 11


PAD_FOLD_RANGE = "pad_fold"


def _is_pad_kernel(name: str) -> bool:
    """PyTorch's replication and reflection pad kernels, by name."""
    return "pad" in name and ("replication" in name or "reflection" in name)


@contextlib.contextmanager
def _pad_fold_range(torch):
    """Inside the block, every backward of the deterministic pads
    (``ops/pad.py::_fold``) runs in a ``record_function`` range named
    PAD_FOLD_RANGE, so that a profile can sum the device time of its
    kernels (plain copies, sums and adds, which carry no name of their
    own)."""
    from one_to_many_gan_torch.ops import pad as pad_module

    fold = pad_module._fold

    def ranged(*args):
        with torch.profiler.record_function(PAD_FOLD_RANGE):
            return fold(*args)

    pad_module._fold = ranged
    try:
        yield
    finally:
        pad_module._fold = fold


def _params_of(state) -> list:
    return [p.detach().clone() for m in (state.generator, state.mapping, state.extractor)
            for p in m.parameters()]


def phase_fused_step(torch) -> dict:
    from one_to_many_gan_torch import train
    from one_to_many_gan_torch.core.train_step import make_train_step
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd

    config = d_phase_config("bfloat16", D_BATCH, path_interval=G_INTERVAL)
    models, state, gen = train.setup(config, seed=0, ada_p=D_ADA_P, device="cuda")
    train_step = make_train_step(config, models)
    before = _params_of(state)
    counters = (warp, warp_bwd, fused_instance_norm)
    for c in counters:
        c.launches = 0
    # the main path: fused steps through the entry points a trainer calls
    log_, step_ms = [], {"path": [], "off": []}
    peak = {"path": 0, "off": 0}
    n = G_WARMUP + G_STEPS
    for step in range(n):
        kind = "path" if state.step % G_INTERVAL == 0 else "off"
        c0 = [c.launches for c in counters]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = train.run_step(config, models, state, train_step, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated())
        counts = [c.launches - k for c, k in zip(counters, c0, strict=True)]
        m = {k: v.item() for k, v in metrics.items()}
        log_.append({**m, "kind": kind, "ms": ms, "launches": counts})
        if step >= G_WARMUP:
            step_ms[kind].append(ms)
        check(counts == [G_WARPS_PER_STEP, G_WARP_BWDS_PER_STEP, G_IN_PER_STEP],
              f"step {step}: {counts} warp, warp_bwd and IN launches (want "
              f"{[G_WARPS_PER_STEP, G_WARP_BWDS_PER_STEP, G_IN_PER_STEP]})")
        check(all(np.isfinite(m[k]) for k in G_METRICS + ("disc_loss",)),
              f"step {step}: a loss is not finite: {m}")
        check(m["path_loss"] > 0 if kind == "path" else m["path_loss"] == 0,
              f"step {step} ({kind}): path_loss {m['path_loss']}")
    launches = dict(zip(("warp_fwd", "warp_bwd", "instance_norm"),
                        (c.launches for c in counters), strict=True))
    check(state.step == n, f"step counter {state.step} after {n} steps")
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(_params_of(state), before, strict=True))
    check(all((p - q).abs().max().item() > 0 for p, q in zip(_params_of(state), before,
                                                               strict=True)),
          "a parameter tensor of the generator, mapping or extractor did not change")
    all_ms = step_ms["path"] + step_ms["off"]
    mean = statistics.fmean(all_ms)
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    log(f"fused step ({D_SIZE}x{D_SIZE}, batch {D_BATCH}, bf16, path interval {G_INTERVAL}): "
        f"median path step {med['path']:.2f} ms ({len(step_ms['path'])} steps), median other "
        f"step {med['off']:.2f} ms ({len(step_ms['off'])}), mean {mean:.2f} ms over {G_STEPS} "
        f"= {D_BATCH / mean * 1e3:.1f} images/s; peak memory {peak['path'] / 2**30:.2f} GiB "
        f"(path) / {peak['off'] / 2**30:.2f} GiB (other)")
    log(f"  launches on the main path over {n} steps: {launches}; total_gen_loss "
        f"{log_[0]['total_gen_loss']:.4f} -> {log_[-1]['total_gen_loss']:.4f}; parameters moved "
        f"by up to {moved:.3g}")

    def at_step(k):
        def fn():
            state.step = k
            train.run_step(config, models, state, train_step, gen)
        return fn

    with _pad_fold_range(torch):
        profiles = {kind: profile_call(torch, at_step(k), f"fused {kind} step ({D_SIZE}x{D_SIZE}, "
                                       f"batch {D_BATCH}, bf16)", ranges=(PAD_FOLD_RANGE,),
                                       select=_is_pad_kernel)
                    for kind, k in (("path", G_INTERVAL), ("off", G_INTERVAL + 1))}
    for kind, prof in profiles.items():
        pads = prof["selected"]
        fwd = sum(k["ms"] for k in pads if "backward" not in k["name"])
        atomic = [k["name"] for k in pads if "backward" in k["name"]]
        check(not atomic, f"PyTorch's own pad backward still runs in the {kind} step: {atomic}")
        bwd = prof["ranges_ms"][PAD_FOLD_RANGE]
        prof["pads_ms"] = {"forward": fwd, "backward_fold": bwd}
        log(f"  pads in the {kind} step: forward kernels {fwd:.2f} ms, deterministic backward "
            f"(the fold's kernels) {bwd:.2f} ms; {(fwd + bwd) / prof['busy_ms']:.1%} of the "
            "device's busy time")
    log("phase 11 ok")
    return {"step_ms": step_ms, "median_ms": med, "mean_ms": mean,
            "images_per_s": D_BATCH / mean * 1e3, "peak_bytes": peak, "launches": launches,
            "steps": n, "metrics": log_, "profiles": profiles, "max_abs_move": moved}


# ---------------------------------------------------------------- phase 12


def _g_grads(state) -> dict:
    return {f"{name}.{n}": p.grad.double().cpu()
            for name in ("generator", "mapping", "extractor")
            for n, p in getattr(state, name).named_parameters()}


def _g_zero_grad_leaf(name: str) -> bool:
    """The biases of the convs an instance norm follows (the encoder's stem
    and down convs, the extractor trunk's last three): gradient 0 in exact
    arithmetic."""
    return name.endswith("bias") and name.startswith(
        ("generator.enc_stem", "generator.enc_down", "extractor.trunk.1",
         "extractor.trunk.2", "extractor.trunk.3"))


def _float64(torch, module):
    """A float64 copy of ``module``: its parameters and its compute dtype."""
    module = copy.deepcopy(module).double()
    for sub in module.modules():
        if hasattr(sub, "dtype"):
            sub.dtype = torch.float64
    return module


def phase_g_card_vs_cpu(torch) -> dict:
    from one_to_many_gan_torch.core import train_step
    from one_to_many_gan_torch.core.state import Models, init_train_state
    from one_to_many_gan_torch.ops import activations

    config = d_phase_config("float32", G_CPU_BATCH, path_interval=G_INTERVAL)
    cpu_gen = torch.Generator().manual_seed(5)
    draws = train_step.draw_step(cpu_gen, config, Models(config, device="cpu"))
    batches = train_step.Batches(*(train_step.synthetic_batch(
        cpu_gen, G_CPU_BATCH, (D_SIZE, D_SIZE), 1) for _ in range(4)))
    # One fused step, as make_train_step composes it, on each device; the
    # state entering the G phase is kept for the passes below.
    runs = {}
    for device in ("cuda", "cpu"):
        models = Models(config, device=device, seed=0)  # float32 on CUDA: TF32 off
        state = init_train_state(config, models, seed=0)
        state.ada = state.ada._replace(p=torch.tensor(D_ADA_P, device=device))
        d_phase = train_step.make_d_phase(config, models)
        g_phase = train_step.make_g_phase(config, models)
        dev_draws = _to(draws, device)
        t0 = time.perf_counter()
        p_used = state.ada.p
        state, _ = d_phase(state, batches.d_shoeprints, batches.d_shoemarks, dev_draws.d)
        entering = {n: copy.deepcopy(getattr(state, n).state_dict())
                    for n in ("generator", "mapping", "extractor", "discriminator")}
        state, metrics = g_phase(state, batches, dev_draws.g, p_used)
        if device == "cuda":
            torch.cuda.synchronize()
        runs[device] = {"seconds": time.perf_counter() - t0, "state": state, "models": models,
                        "metrics": {k: v.item() for k, v in metrics.items()},
                        "grads": _g_grads(state), "entering": entering, "p_used": p_used}
    check(not torch.backends.cudnn.allow_tf32, "TF32 is on for the float32 card run")
    card, cpu = runs["cuda"], runs["cpu"]
    check(card["metrics"]["path_loss"] > 0, "phase 12's step is not a path step")
    metric_rel = {k: abs(card["metrics"][k] - cpu["metrics"][k]) / max(abs(cpu["metrics"][k]),
                                                                     1e-30)
                  for k in G_METRICS}
    card_vs_cpu = _grad_rel(card["grads"], cpu["grads"])

    # The float64 pass: the G phase (without its Adams) on the CPU, on the
    # state that entered the CPU's G phase, in float64, recording the side
    # each activation input took.
    cpu_state = cpu["state"]
    for n, sd in cpu["entering"].items():
        getattr(cpu_state, n).load_state_dict(sd)
    state64 = copy.copy(cpu_state)
    for n in ("generator", "mapping", "extractor", "discriminator"):
        setattr(state64, n, _float64(torch, getattr(cpu_state, n)))
    g_loss = train_step.make_g_loss(config, cpu["models"])
    t0 = time.perf_counter()
    with activations.record() as kinks64:
        g_loss(state64, batches, draws.g, cpu["p_used"], True)
    f64_s = time.perf_counter() - t0
    ref = _g_grads(state64)
    n_inputs = sum(m.numel() for m in kinks64.masks)
    vs_f64 = {"cpu": _grad_rel(cpu["grads"], ref)}
    flips = {}
    with activations.pin(kinks64.masks) as pinned:
        g_loss(cpu_state, batches, draws.g, cpu["p_used"], True)
    vs_f64["cpu, pinned"], flips["cpu"] = _grad_rel(_g_grads(cpu_state), ref), pinned.n_flips()
    # the card on the CPU's inputs: its modules set to the state that
    # entered the CPU's G phase (the CPU's discriminator after its update)
    card_state = card["state"]
    for n, sd in cpu["entering"].items():
        getattr(card_state, n).load_state_dict(sd)
    card_g_loss = train_step.make_g_loss(config, card["models"])
    card_draws = _to(draws.g, "cuda")
    card_g_loss(card_state, batches, card_draws, card["p_used"], True)
    vs_f64["card"] = _grad_rel(_g_grads(card_state), ref)
    with activations.pin(kinks64.masks) as pinned:
        card_g_loss(card_state, batches, card_draws, card["p_used"], True)
    vs_f64["card, pinned"], flips["card"] = _grad_rel(_g_grads(card_state), ref), pinned.n_flips()
    # the same with TF32 on, for scale: TF32 keeps ~3 decimal digits
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with activations.pin(kinks64.masks) as pinned:
            card_g_loss(card_state, batches, card_draws, card["p_used"], True)
        vs_f64["card, TF32 on, pinned"] = _grad_rel(_g_grads(card_state), ref)
        flips["card, TF32 on"] = pinned.n_flips()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    names = [n for n in ref if not _g_zero_grad_leaf(n)]
    total = torch.sqrt(sum(g.square().sum() for g in cpu["grads"].values())).item()
    worst = {label: max(rel[n] for n in names) for label, rel in
             (("card vs CPU", card_vs_cpu), *((f"{k} vs float64", v) for k, v in vs_f64.items()))}
    log(f"fused step card vs CPU ({D_SIZE}x{D_SIZE}, batch {G_CPU_BATCH}, float32, TF32 off, "
        f"path step): CPU step {cpu['seconds']:.1f} s, float64 G pass {f64_s:.1f} s")
    log("  G metrics, relative: " + ", ".join(f"{k} {v:.3g}" for k, v in metric_rel.items()))
    log(f"  kink flips against float64, of {n_inputs} activation inputs: " + ", ".join(
        f"{k} {v}" for k, v in flips.items()))
    log("  gradient error per leaf relative to its norm, largest: " + "; ".join(
        f"{k} {v:.3g}" for k, v in worst.items()))
    for label, rel in (("card vs CPU", card_vs_cpu), *vs_f64.items()):
        top = sorted(names, key=lambda n, r=rel: -r[n])[:4]
        log(f"  {label:24s} " + ", ".join(f"{n} {rel[n]:.3g}" for n in top))
    for k, v in metric_rel.items():
        check(np.isfinite(card["metrics"][k]) and v <= G_METRIC_RTOL,
              f"{k}: card {card['metrics'][k]} vs CPU {cpu['metrics'][k]}")
    for label in ("cpu", "card"):
        check(flips[label] <= G_MAX_FLIP_SHARE * n_inputs,
              f"{label}: {flips[label]} of {n_inputs} activation inputs off float64's side")
    for n in ref:
        if _g_zero_grad_leaf(n):
            worst_zero = max(card["grads"][n].norm().item(), cpu["grads"][n].norm().item())
            check(worst_zero <= 1e-4 * total, f"{n}: gradient {worst_zero:.3g} is not ~0")
            continue
        check(card_vs_cpu[n] <= G_GRAD_RTOL,
              f"{n}: card gradient off the CPU's by {card_vs_cpu[n]:.3g} of its norm")
        for label in ("cpu", "card"):
            check(vs_f64[label][n] <= G_GRAD_F64_RTOL,
                  f"{n}: {label} gradient off float64 by {vs_f64[label][n]:.3g} of its norm")
            pinned_rel = vs_f64[f"{label}, pinned"][n]
            check(pinned_rel <= G_GRAD_PINNED_RTOL,
                  f"{n}: {label} gradient, kinks pinned, off float64 by {pinned_rel:.3g}")
    log("phase 12 ok")
    return {"metrics_card": card["metrics"], "metrics_cpu": cpu["metrics"],
            "metric_rel": metric_rel, "grad_rel_card_vs_cpu": card_vs_cpu,
            "grad_rel_vs_float64": vs_f64, "worst": worst, "cpu_s": cpu["seconds"],
            "float64_s": f64_s, "batch": G_CPU_BATCH, "kink_flips": flips,
            "activation_inputs": n_inputs}


# ---------------------------------------------------------------- phase 13


def _train_state_tensors(state) -> dict:
    """Copies of every tensor of a TrainState: the four modules' parameters,
    the four Adams' moments and step counts, the ADA state and the replay
    buffer."""
    out = {}
    for name in ("generator", "mapping", "discriminator", "extractor"):
        for n, p in getattr(state, name).named_parameters():
            out[f"{name}.{n}"] = p.detach().clone()
    for name in ("opt_d", "opt_g", "opt_m", "opt_s"):
        opt = getattr(state, name)
        params = [p for group in opt.param_groups for p in group["params"]]
        for k, p in enumerate(params):
            for key, value in opt.state[p].items():
                out[f"{name}.{k}.{key}"] = value.clone()  # torch keeps Adam's step a tensor
    for key, value in state.ada._asdict().items():
        out[f"ada.{key}"] = value.clone()
    for key, value in state.buffer._asdict().items():
        out[f"buffer.{key}"] = value.clone()
    return out


def phase_deterministic(torch, fused: dict) -> dict:
    """Two runs of DET_STEPS fused steps from seed 0 at phase 11's config
    with ``training.deterministic_cuda_kernels = true``: every tensor of
    the training state and every metric bitwise equal between them; the
    steps timed beside phase 11's. The process-wide flags are set back
    afterwards."""
    from one_to_many_gan_torch import train
    from one_to_many_gan_torch.core.train_step import make_train_step
    from one_to_many_gan_torch.device import CUBLAS_WORKSPACE_CONFIG
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd

    config = d_phase_config("bfloat16", D_BATCH, path_interval=G_INTERVAL)
    config["training"]["deterministic_cuda_kernels"] = True
    cudnn = torch.backends.cudnn
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(), cudnn.deterministic,
             cudnn.benchmark)
    counters = (warp, warp_bwd, fused_instance_norm)
    runs = []
    try:
        for _ in range(2):
            models, state, gen = train.setup(config, seed=0, ada_p=D_ADA_P, device="cuda")
            check(torch.are_deterministic_algorithms_enabled() and cudnn.deterministic
                  and not cudnn.benchmark
                  and os.environ.get("CUBLAS_WORKSPACE_CONFIG") == CUBLAS_WORKSPACE_CONFIG,
                  "Models did not set the deterministic flags")
            train_step = make_train_step(config, models)
            metrics, ms = [], []
            for step in range(DET_STEPS):
                c0 = [c.launches for c in counters]
                t0 = time.perf_counter()
                state, m = train.run_step(config, models, state, train_step, gen)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                counts = [c.launches - k for c, k in zip(counters, c0, strict=True)]
                check(counts == [G_WARPS_PER_STEP, G_WARP_BWDS_PER_STEP, G_IN_PER_STEP],
                      f"deterministic step {step}: {counts} warp, warp_bwd and IN launches")
                metrics.append({k: v.detach().clone() for k, v in m.items()})
            check(metrics[0]["path_loss"].item() > 0, "deterministic step 0 is no path step")
            runs.append({"state": _train_state_tensors(state), "metrics": metrics, "ms": ms})
            del models, state, train_step, gen
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        cudnn.deterministic, cudnn.benchmark = flags[2], flags[3]
    a, b = runs
    check(a["state"].keys() == b["state"].keys(), "the two runs hold different state")
    differ = [k for k in a["state"] if not torch.equal(a["state"][k], b["state"][k])]
    differ += [f"step {i} {k}" for i, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"],
                                                               strict=True))
               for k in ma if not torch.equal(ma[k], mb[k])]
    n_elems = sum(v.numel() for v in a["state"].values())
    log(f"deterministic fused steps ({D_SIZE}x{D_SIZE}, batch {D_BATCH}, bf16, path interval "
        f"{G_INTERVAL}): two runs of {DET_STEPS} steps from seed 0; {len(a['state'])} state "
        f"tensors ({n_elems} elements) and {len(a['metrics'][0])} metrics per step compared, "
        f"{len(differ)} differ {differ[:8]}")
    log("  step ms (step 0 a path step): run 1 " + ", ".join(f"{t:.2f}" for t in a["ms"])
        + "; run 2 " + ", ".join(f"{t:.2f}" for t in b["ms"])
        + f"; phase 11 (not deterministic): median path {fused['median_ms']['path']:.2f}, "
        f"other {fused['median_ms']['off']:.2f}")
    check(not differ, f"two deterministic runs differ: {differ[:20]}")
    log("phase 13 ok")
    return {"step_ms": [a["ms"], b["ms"]], "state_tensors": len(a["state"]),
            "state_elements": n_elems, "differ": differ,
            "metrics": [{k: v.item() for k, v in m.items()} for m in a["metrics"]]}


# ---------------------------------------------------------------- phase 14


class _Tee(io.TextIOBase):
    """A text stream that writes to several."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self) -> None:
        for stream in self.streams:
            stream.flush()


def trainer_config(root: Path, run: str, **overrides):
    """Phase 11's config as a Trainer's: the folders under ``root``, the
    run ``run``, phase 14's schedule; ``overrides`` by section."""
    config = d_phase_config("bfloat16", D_BATCH, path_interval=G_INTERVAL)
    config["training"].update(checkpoint_directory=root, training_run=run,
                              training_steps=T_STEPS)
    config["data"].update(shoeprint_data_dir=root / "prints", shoemark_data_dir=root / "marks")
    config["evaluation"].update(log_interval=T_LOG, checkpoint_interval=T_CKPT,
                                n_evaluation_images=T_EVAL_IMAGES,
                                inference_batch_size=T_EVAL_BATCH)
    config["tpu"].update(keep_checkpoints=1, prefetch=2, steps_per_call=T_GROUP)
    for section, values in overrides.items():
        config[section].update(values)
    return config


def log_line_pattern(torch, training_steps: int):
    """The Logger's line as a regex: a line of its own format with every
    number replaced by a number pattern."""
    import re

    from one_to_many_gan_torch.core.evaluation import Logger

    logger = Logger(training_steps)
    logger.append_metrics({k: torch.tensor(0.25) for k in Logger.METRICS})
    line, _ = logger.summary(7)
    number = r"[-+0-9.eEnaif]+"
    pattern = re.escape(line).replace(re.escape("0.25"), number)
    return re.compile(pattern.replace("Step:\\ 7/", r"Step:\ \d+/"))


def _load_ckpt(torch, path: Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _ckpt_differences(torch, a, b, where: str = "") -> tuple[list, int, int]:
    """(paths that differ, tensors compared, their elements) of two
    checkpoint dicts, bitwise."""
    if torch.is_tensor(a):
        same = torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
        return ([] if same else [where]), 1, a.numel()
    if isinstance(a, dict) or isinstance(a, list):
        keys = list(a) if isinstance(a, dict) else range(len(a))
        if (list(a) != list(b)) if isinstance(a, dict) else len(a) != len(b):
            return [f"{where} (keys)"], 0, 0
        out = ([], 0, 0)
        for k in keys:
            d, n, e = _ckpt_differences(torch, a[k], b[k], f"{where}.{k}")
            out = (out[0] + d, out[1] + n, out[2] + e)
        return out
    return ([] if a == b else [where]), 0, 0


def _trainer_with_taps(torch, config, counters, per_step: list, summaries: list, h2d: list):
    """A Trainer whose fused step records each step's launches, whose
    logger records when each log line was ready (synchronised: the
    summary reads the metrics back), and whose groups record their bytes."""
    from one_to_many_gan_torch.core.trainer import Trainer

    trainer = Trainer(config)
    step_fn = trainer.train_step

    def counted(*args):
        c0 = [c.launches for c in counters]
        out = step_fn(*args)
        per_step.append([c.launches - k for c, k in zip(counters, c0, strict=True)])
        return out

    summary = trainer.logger.summary

    def timed(step):
        out = summary(step)
        summaries.append((step, time.perf_counter()))
        return out

    make_group = trainer._make_group

    def measured(k):
        group = make_group(k)
        h2d.append((k, group[0].nbytes))
        return group

    trainer.train_step = counted
    trainer.logger.summary = timed
    trainer._make_group = measured
    return trainer


def _post_reload(port: int) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/reload", data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def phase_trainer(torch, fused: dict) -> dict:
    """The training run through its entry points: ``Trainer`` on image
    folders at phase 11's config; (a) 16 steps, then a new Trainer that
    resumes to 32, with a server started between the two; (b) under
    ``deterministic_cuda_kernels``, 16 steps against 8 + a resume to 16,
    their checkpoints bitwise equal; (c) the artifact of (a)'s run served
    beside its checkpoint, and the server's ``/reload``."""
    import tempfile

    from one_to_many_gan_torch import serve
    from one_to_many_gan_torch.data import _load_image, write_synthetic_dataset_dirs
    from one_to_many_gan_torch.export import export_inference_artifact
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd

    t_phase = time.perf_counter()
    counters = (warp, warp_bwd, fused_instance_norm)
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        root = Path(tmp)
        for domain, seed in (("prints", 0), ("marks", 9)):
            write_synthetic_dataset_dirs(root / domain, n_train=T_TRAIN_IMAGES,
                                         n_test=T_TEST_IMAGES, image_size=(D_SIZE, D_SIZE),
                                         seed=seed)
        config = trainer_config(root, "a", tpu={"profile_step": T_PROFILE_STEP})
        run_dir = root / "a"
        per_step, summaries, h2d = [], [], []
        printed = io.StringIO()

        # (a) the main path: 16 steps, a server, a resume to 32
        for c in counters:
            c.launches = 0
        with contextlib.redirect_stdout(_Tee(sys.stdout, printed)):
            first = _trainer_with_taps(torch, config, counters, per_step, summaries, h2d)
            check(first.start_step == 0, f"a fresh run starts at {first.start_step}")
            t0 = time.perf_counter()
            first.run(max_steps=T_CKPT)
            first_s = time.perf_counter() - t0
            timings_16 = dict(first.timings)
            engine = serve.InferenceEngine(config, buckets=(T_ENGINE_N,))
            check(engine.step == T_CKPT, f"the server restored step {engine.step}")
            httpd = serve.make_server(engine, host="127.0.0.1", port=0)
            server = threading.Thread(target=httpd.serve_forever, daemon=True)
            server.start()
            try:
                second = _trainer_with_taps(torch, config, counters, per_step, summaries, h2d)
                check(second.start_step == T_CKPT, f"the resume starts at {second.start_step}")
                t0 = time.perf_counter()
                second.run()
                second_s = time.perf_counter() - t0
                launches = dict(zip(("warp_fwd", "warp_bwd", "instance_norm"),
                                    (c.launches for c in counters), strict=True))
                reload = _post_reload(httpd.server_address[1])
            finally:
                httpd.shutdown()
                httpd.server_close()
                httpd.batcher.close()
                server.join(timeout=60)
        check(not server.is_alive(), "the server thread did not stop")
        check(reload == {"status": "ok", "step": T_STEPS}, f"/reload answered {reload}")
        check(engine.step == T_STEPS, f"the server serves step {engine.step}")
        text = printed.getvalue()
        check(f"Resumed from checkpoint at step {T_CKPT}" in text.splitlines(),
              "the resumed Trainer did not print 'Resumed from checkpoint at step 16'")
        want = [G_WARPS_PER_STEP, G_WARP_BWDS_PER_STEP, G_IN_PER_STEP]
        bad = [(k, n) for k, n in enumerate(per_step) if n != want]
        check(len(per_step) == T_STEPS and not bad,
              f"{len(per_step)} Trainer steps; launches off {want} at {bad[:4]}")
        pattern = log_line_pattern(torch, T_STEPS)
        lines = (run_dir / "log").read_text().splitlines()
        train_lines = [ln for ln in lines if ln.startswith("Step:")]
        fid_lines = [ln for ln in lines if ln.startswith("Step ")]
        check([ln.split("/")[0] for ln in train_lines]
              == [f"Step: {s}" for s in range(T_LOG, T_STEPS + 1, T_LOG)]
              and all(pattern.fullmatch(ln) for ln in train_lines),
              f"training log lines {train_lines}")
        check(len(fid_lines) == 2 and all(
            ln.startswith(f"Step {s} | fid: ") and ln.endswith("[random_projection_v1]")
            for ln, s in zip(fid_lines, (T_CKPT, T_STEPS), strict=True)),
            f"FID/KID log lines {fid_lines}")
        records = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
        fids = [r for r in records if "fid" in r]
        check([r["step"] for r in records if "fid" not in r] == [8, 16, 24, 32]
              and [(r["step"], r["fid_extractor"]) for r in fids]
              == [(T_CKPT, "random_projection_v1"), (T_STEPS, "random_projection_v1")]
              and all(np.isfinite(r["fid"]) and np.isfinite(r["kid"]) for r in fids),
              f"metrics.jsonl {records}")
        means = [r for r in records if "fid" not in r]
        check(all(np.isfinite(v) for r in means for v in r.values()),
              "a logged mean is not finite")
        grids = sorted(p.name for p in (run_dir / "images").iterdir())
        check(grids == [f"{kind}_{s}.png" for kind in ("decoding", "translation")
                        for s in (T_CKPT, T_STEPS)], f"grids {grids}")
        n_val = len(list((run_dir / "val").glob("*.png")))
        check(n_val == T_EVAL_IMAGES, f"{n_val} validation images")
        kept = sorted(p.name for p in (run_dir / "models").iterdir())
        check(kept == [f"{T_STEPS}.tar"], f"checkpoints kept: {kept}")
        tar_mb = (run_dir / "models" / f"{T_STEPS}.tar").stat().st_size / 2**20
        check(all(nbytes == 4 * k * D_BATCH * D_SIZE * D_SIZE for k, nbytes in h2d),
              f"groups' bytes {h2d[:3]}")
        h2d_step = h2d[0][1] / h2d[0][0]

        # the loop's speed: log line to log line, 8 steps, both ends synchronised
        at = dict(summaries)
        window_ms = (at[2 * T_LOG] - at[T_LOG]) * 1e3 / T_LOG
        overhead = window_ms / fused["mean_ms"] - 1.0
        prof = second.profile
        check(prof is not None and prof["steps"] == T_GROUP and prof["device_busy_ms"] > 0,
              f"profile {prof}")
        profiled_ms = prof["wall_ms"] / prof["steps"]
        timings_32 = dict(second.timings)
        log(f"Trainer ({D_SIZE}x{D_SIZE}, batch {D_BATCH}, bf16, path interval {G_INTERVAL}, "
            f"groups of {T_GROUP}): steps 8-15 {window_ms:.2f} ms a step = "
            f"{D_BATCH / window_ms * 1e3:.1f} images/s against phase 11's bare-step mean "
            f"{fused['mean_ms']:.2f} ms ({D_BATCH / fused['mean_ms'] * 1e3:.1f} images/s): "
            f"loop overhead {overhead:+.1%}; steps 24-31 under torch.profiler "
            f"{profiled_ms:.2f} ms a step")
        log(f"  device idle over steps 24-31: {prof['idle_share']:.1%} (busy "
            f"{prof['device_busy_ms']:.2f} of {prof['wall_ms']:.2f} ms)")
        log(f"  checkpoint at 16: image grids {timings_16['image'] * 1e3:.1f} ms, "
            f"val_checkpoint ({T_EVAL_IMAGES} images, FID/KID) {timings_16['val'] * 1e3:.1f} ms, "
            f"save {timings_16['save'] * 1e3:.1f} ms; at 32: {timings_32['image'] * 1e3:.1f}, "
            f"{timings_32['val'] * 1e3:.1f}, {timings_32['save'] * 1e3:.1f} ms; "
            f"{T_STEPS}.tar {tar_mb:.2f} MiB")
        log(f"  H2D {h2d_step:.0f} bytes a step (uint8); launches over the two runs' "
            f"{T_STEPS} steps and 2 checkpoints: {launches} ({want} in every step); "
            f"runs {first_s:.1f} + {second_s:.1f} s; /reload -> {reload}")
        out["a"] = {
            "window_ms": window_ms, "images_per_s": D_BATCH / window_ms * 1e3,
            "fused_mean_ms": fused["mean_ms"], "overhead": overhead,
            "profiled_ms": profiled_ms, "profile": prof, "timings_16": timings_16,
            "timings_32": timings_32, "tar_mib": tar_mb, "h2d_bytes_per_step": h2d_step,
            "launches": launches, "per_step": per_step[:2], "run_s": [first_s, second_s],
            "log": lines, "reload": reload,
        }

        # (b) and (c) under deterministic_cuda_kernels; the flags set back after
        cudnn = torch.backends.cudnn
        flags = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled(), cudnn.deterministic,
                 cudnn.benchmark)
        try:
            out["c"] = _artifact_and_checkpoint_serve_alike(
                torch, config, root, serve, export_inference_artifact, _load_image)
            out["b"] = _exact_resume(torch, root)
        finally:
            torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
            cudnn.deterministic, cudnn.benchmark = flags[2], flags[3]
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 14 ok in {out['wall_s']:.1f} s")
    return out


def _artifact_and_checkpoint_serve_alike(torch, config, root, serve, export, load_image):
    """(c): the artifact of (a)'s run and its checkpoint, each behind an
    engine (deterministic kernels), give the same n = 8 images bitwise."""
    det = copy.deepcopy(config)
    det["training"]["deterministic_cuda_kernels"] = True
    t0 = time.perf_counter()
    path = export(config, root / "model.npz")
    export_s = time.perf_counter() - t0
    from_art = serve.InferenceEngine(det, buckets=(T_ENGINE_N,), artifact=path)
    from_ckpt = serve.InferenceEngine(det, buckets=(T_ENGINE_N,))
    check(from_art.step == from_ckpt.step == T_STEPS,
          f"artifact step {from_art.step}, checkpoint step {from_ckpt.step}")
    source = load_image(root / "prints" / "test" / "00000.png", (D_SIZE, D_SIZE), 1)
    for seed in (0, 1):
        a = from_art.generate(source, T_ENGINE_N, seed=seed)
        b = from_ckpt.generate(source, T_ENGINE_N, seed=seed)
        check(a.shape == (T_ENGINE_N, D_SIZE, D_SIZE, 1) and np.array_equal(a, b),
              f"seed {seed}: the artifact's engine and the checkpoint's differ")
    mb = path.stat().st_size / 2**20
    log(f"  artifact {mb:.2f} MiB written in {export_s * 1e3:.1f} ms; its engine and the "
        f"checkpoint's give the same {T_ENGINE_N} images bitwise (2 seeds)")
    return {"artifact_mib": mb, "export_s": export_s}


def _exact_resume(torch, root: Path) -> dict:
    """(b): under deterministic_cuda_kernels, 16 steps in one run and as
    8 + a resume to 16 (a full checkpoint at 8 in both): every tensor of
    the two 16.tar files bitwise equal."""
    from one_to_many_gan_torch.core.trainer import Trainer

    overrides = {"training": {"training_steps": T_CKPT, "deterministic_cuda_kernels": True},
                 "evaluation": {"checkpoint_interval": T_LOG}}
    full = trainer_config(root, "b_full", **overrides)
    split = trainer_config(root, "b_split", **overrides)
    t0 = time.perf_counter()
    Trainer(full, verbose=False).run()
    full_s = time.perf_counter() - t0
    Trainer(split, verbose=False).run(max_steps=T_LOG)
    resumed = Trainer(split, verbose=False)
    check(resumed.start_step == T_LOG, f"(b) resumed at {resumed.start_step}")
    resumed.run()
    check(torch.are_deterministic_algorithms_enabled(), "(b) ran without deterministic kernels")
    a = _load_ckpt(torch, root / "b_full" / "models" / f"{T_CKPT}.tar")
    b = _load_ckpt(torch, root / "b_split" / "models" / f"{T_CKPT}.tar")
    differ, n_tensors, n_elems = _ckpt_differences(torch, a, b)
    log(f"  exact resume (deterministic kernels): 16 steps against 8 + a resume to 16: "
        f"{n_tensors} tensors ({n_elems} elements) of {T_CKPT}.tar compared, {len(differ)} "
        f"differ {differ[:8]}; the uninterrupted run took {full_s:.1f} s")
    # each parameter with its Adam step and moments, the buffer's images, the ADA window
    n_params = sum(len(list(getattr(resumed.state, m).parameters()))
                   for m in ("generator", "discriminator", "mapping", "extractor"))
    want = 4 * n_params + len(b["image_buffer_images"]) + 2
    check(n_tensors == want and not differ,
          f"{n_tensors} tensors compared (want {want}); differ: {differ[:20]}")
    return {"tensors": n_tensors, "elements": n_elems, "differ": differ, "full_run_s": full_s}


# ---------------------------------------------------------------- phase 15


@contextlib.contextmanager
def _determinism_restored(torch):
    """The process's deterministic-kernel flags, restored after the block
    (``Models`` sets them for ``deterministic_cuda_kernels``)."""
    cudnn = torch.backends.cudnn
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(), cudnn.deterministic,
             cudnn.benchmark)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        cudnn.deterministic, cudnn.benchmark = flags[2], flags[3]


def production_config(root: Path, run: str, **values):
    """Phase 15's config: ``configs/tpu_v5e8_512.toml`` as one card's copy
    (``presets.write_card_config``), on the folders under ``root``, run
    ``run``, with phase 15's schedule and ``values`` (other keys of the
    file). -> (config, the keys changed with their new values)."""
    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.presets import write_card_config

    path = root / f"{run}.toml"
    schedule = {"shoeprint_data_dir": str(root / "prints"),
                "shoemark_data_dir": str(root / "marks"), "checkpoint_directory": str(root),
                "training_run": run, "training_steps": P_STEPS, "log_interval": P_LOG,
                "checkpoint_interval": P_CKPT, "n_evaluation_images": P_EVAL_IMAGES}
    native = {} if _native_reason() is None else {"native_loader": False}
    changes = write_card_config(PROD_CONFIG, path, **{**native, **schedule, **values})
    return load_config(path), changes


@functools.cache
def _native_reason() -> str | None:
    """None where the C++ image loader builds on this host, else why not
    (the compiler's message): there phases 15 and 16 run the production
    config with native_loader = false."""
    from one_to_many_gan_torch.data import native

    return native.available()


def _cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _phase_counts(counters, c0) -> list:
    return [c.launches - k for c, k in zip(counters, c0, strict=True)]


def _production_bare_steps(torch, config) -> dict:
    """(a) P_BARE_STEPS steps of the production config on synthetic batches
    (ADA p 0.6), without deterministic kernels, each phase synchronised
    and timed on its own: step ms of the R1 step (16, also a path step),
    the path step (8) and the other steps; each phase's peak memory; the
    exact launches of each phase; then one G phase on a path step and one
    on another step with ``g_loss_split``, their peaks beside the joint
    backward's; and the EMA update's device time."""
    from one_to_many_gan_torch import train
    from one_to_many_gan_torch.core.train_step import (
        Batches,
        draw_step,
        ema_update,
        make_d_phase,
        make_g_phase,
        synthetic_batch,
    )
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd

    counters = (warp, warp_bwd, fused_instance_norm)
    models, state, gen = train.setup(config, seed=0, ada_p=D_ADA_P, device="cuda")
    check(state.ema_generator is not None, "the production config's state has no EMA")
    d_phase, g_phase = make_d_phase(config, models), make_g_phase(config, models)

    def batches():
        return Batches(*(synthetic_batch(gen, P_BATCH, (P_SIZE, P_SIZE), 1) for _ in range(4)))

    def run_g(g_fn, step):
        """One G phase at ``step``: -> (ms, peak bytes, launches, metrics)."""
        b, draws = batches(), draw_step(gen, config, models)
        state.step = step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = [c.launches for c in counters]
        t0 = time.perf_counter()
        _, m = g_fn(state, b, draws.g, state.ada.p)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated(),
                _phase_counts(counters, c0), m)

    rows = []
    for step in range(P_BARE_STEPS):
        r1, path = step % P_R1_INTERVAL == 0, step % P_INTERVAL == 0
        b, draws = batches(), draw_step(gen, config, models)
        p_used = state.ada.p
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = [c.launches for c in counters]
        t0 = time.perf_counter()
        state, dm = d_phase(state, b.d_shoeprints, b.d_shoemarks, draws.d)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d_peak = torch.cuda.max_memory_allocated()
        d_counts = _phase_counts(counters, c0)
        torch.cuda.reset_peak_memory_stats()
        c0 = [c.launches for c in counters]
        state, gm = g_phase(state, b, draws.g, p_used)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        g_counts = _phase_counts(counters, c0)
        m = {k: v.item() for k, v in {**dm, **gm}.items()}
        rows.append({"step": step, "r1": r1, "path": path, "d_ms": (t1 - t0) * 1e3,
                     "g_ms": (t2 - t1) * 1e3, "ms": (t2 - t0) * 1e3, "d_peak": d_peak,
                     "g_peak": torch.cuda.max_memory_allocated(), "d_launches": d_counts,
                     "g_launches": g_counts, **m})
        want_d = [P_D_WARPS, 0, len(P_D_IN_SITES) + (len(P_R1_IN_SITES) if r1 else 0)]
        want_g = [P_G_WARPS, P_G_WARP_BWDS, len(P_G_IN_SITES)]
        check(d_counts == want_d and g_counts == want_g,
              f"bare step {step}: D launches {d_counts} (want {want_d}), G {g_counts} "
              f"(want {want_g})")
        check(all(np.isfinite(v) for k, v in m.items() if k != "ada_p"),
              f"bare step {step}: a metric is not finite: {m}")
        check(m["path_loss"] > 0 if path else m["path_loss"] == 0,
              f"bare step {step}: path_loss {m['path_loss']}")
    timed = rows[P_BARE_WARMUP:]
    kinds = {"r1_path": [r for r in timed if r["r1"]],
             "path": [r for r in timed if r["path"] and not r["r1"]],
             "other": [r for r in timed if not r["path"]]}
    med = {k: {f: statistics.median(r[f] for r in v) for f in ("ms", "d_ms", "g_ms")}
           for k, v in kinds.items()}
    mean = statistics.fmean(r["ms"] for r in timed)
    peaks = {"d_r1": max(r["d_peak"] for r in kinds["r1_path"]),
             "d": max(r["d_peak"] for r in timed if not r["r1"]),
             "g_path_joint": max(r["g_peak"] for r in timed if r["path"]),
             "g_other": max(r["g_peak"] for r in kinds["other"])}

    # g_loss_split: the same state, a path step and another step
    split_config = copy.deepcopy(config)
    split_config["tpu"]["g_loss_split"] = True
    g_split = make_g_phase(split_config, models)
    split = {}
    for kind, step in (("path", 3 * P_INTERVAL), ("other", 3 * P_INTERVAL + 1)):
        ms, peak, counts, m = run_g(g_split, step)
        want = [P_G_WARPS, P_G_WARP_BWDS,
                len(P_G_IN_SITES) + (len(P_SPLIT_IN_SITES) if kind == "path" else 0)]
        check(counts == want, f"g_loss_split {kind} step: launches {counts} (want {want})")
        check(all(np.isfinite(v.item()) for v in m.values()), f"g_loss_split {kind}: {m}")
        split[kind] = {"ms": ms, "peak": peak, "launches": counts}
    peaks["g_path_split"] = split["path"]["peak"]

    def r1_d_phase():
        b, draws = batches(), draw_step(gen, config, models)
        state.step = 2 * P_R1_INTERVAL
        d_phase(state, b.d_shoeprints, b.d_shoemarks, draws.d)

    r1_profile = profile_call(torch, r1_d_phase, f"D phase of an R1 step ({P_SIZE}x{P_SIZE}, "
                              f"batch {P_BATCH}, bf16)")
    ema_ms = _cuda_ms(torch, lambda: ema_update(state.ema_generator, state.generator,
                                                config["tpu"]["ema_decay"]), P_EMA_REPS)
    # e and p read once, e written once (the three ops move 7x the parameters)
    ema_bytes = 3 * sum(p.numel() * p.element_size() for p in state.generator.parameters())
    gib = {k: v / 2**30 for k, v in peaks.items()}
    log(f"production steps ({P_SIZE}x{P_SIZE}, batch {P_BATCH}, bf16, path interval "
        f"{P_INTERVAL}, R1 every {P_R1_INTERVAL}, EMA, not deterministic; steps "
        f"{P_BARE_WARMUP}-{P_BARE_STEPS - 1}): median step ms R1 + path "
        f"{med['r1_path']['ms']:.2f} (D {med['r1_path']['d_ms']:.2f}, G "
        f"{med['r1_path']['g_ms']:.2f}), path {med['path']['ms']:.2f} (D "
        f"{med['path']['d_ms']:.2f}, G {med['path']['g_ms']:.2f}), other "
        f"{med['other']['ms']:.2f} (D {med['other']['d_ms']:.2f}, G {med['other']['g_ms']:.2f}); "
        f"mean {mean:.2f} ms = {P_BATCH / mean * 1e3:.2f} images/s")
    log("  peak memory GiB: " + ", ".join(f"{k} {v:.2f}" for k, v in gib.items())
        + f"; g_loss_split G phase ms: path {split['path']['ms']:.2f}, other "
        f"{split['other']['ms']:.2f} (joint: {med['path']['g_ms']:.2f}, "
        f"{med['other']['g_ms']:.2f})")
    log(f"  EMA update {ema_ms:.4f} ms ({ema_bytes / 2**20:.1f} MiB read and written; bound "
        f"{ema_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); launches per phase: D "
        f"{rows[P_BARE_WARMUP]['d_launches']} (R1 step {rows[P_R1_INTERVAL]['d_launches']}), "
        f"G {rows[P_BARE_WARMUP]['g_launches']}, split path G {split['path']['launches']}")
    return {"rows": rows, "median": med, "mean_ms": mean, "images_per_s": P_BATCH / mean * 1e3,
            "peak_bytes": peaks, "g_loss_split": split, "r1_d_profile": r1_profile,
            "ema_ms": ema_ms,
            "ema_bound_ms": ema_bytes / HBM_BYTES_PER_S * 1e3}


def _r1_card_vs_cpu(torch) -> dict:
    """(b) One float32 R1 term and its gradients in D's parameters, card and
    CPU, against a float64 pass on the CPU whose kink pattern both float32
    passes then also run pinned."""
    from one_to_many_gan_torch.device import disable_tf32
    from one_to_many_gan_torch.losses import r1_penalty
    from one_to_many_gan_torch.models import Discriminator
    from one_to_many_gan_torch.ops import activations

    disable_tf32()
    gen = torch.Generator().manual_seed(5)
    reals = torch.rand((R1_CPU_BATCH, 1, R1_SIZE, R1_SIZE), generator=gen) * 2 - 1
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        disc = Discriminator(1)
    disc64 = Discriminator(1, dtype=torch.float64)
    disc64.load_state_dict(disc.state_dict())
    names = [n for n, _ in disc.named_parameters()]

    def run(d, x, pin=None):
        params = list(d.parameters())
        block = activations.pin(pin) if pin is not None else activations.record()
        with block as pattern:
            loss = (R1_GAMMA / 2.0) * r1_penalty(d, x)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        return {"loss": loss.item(), "pattern": pattern, "grads": {
            n: None if g is None else g.double().cpu() for n, g in zip(names, grads, strict=True)}}

    t0 = time.perf_counter()
    ref = run(disc64, reals.double())
    f64_s = time.perf_counter() - t0
    masks = ref["pattern"].masks
    n_inputs = sum(m.numel() for m in masks)
    card_disc = copy.deepcopy(disc).cuda()
    runs = {"card": run(card_disc, reals.cuda(), masks), "cpu": run(disc, reals, masks)}
    unpinned = {"card": run(card_disc, reals.cuda()), "cpu": run(disc, reals)}
    check(not torch.backends.cudnn.allow_tf32, "TF32 is on for the float32 card run")
    live = [n for n in names if ref["grads"][n] is not None]
    check(set(names) - set(live) == {"head.bias"},
          f"R1 gradients: {sorted(set(names) - set(live))} have none (want only head.bias)")
    total = torch.sqrt(sum(ref["grads"][n].square().sum() for n in live)).item()

    def rel(a):
        return {n: ((a["grads"][n] - ref["grads"][n]).norm()
                    / ref["grads"][n].norm().clamp_min(1e-30)).item() for n in live}

    out = {"loss_float64": ref["loss"], "float64_s": f64_s, "activation_inputs": n_inputs}
    for label, r in runs.items():
        out[label] = {"loss": r["loss"], "loss_rel": abs(r["loss"] - ref["loss"]) / ref["loss"],
                      "flips": r["pattern"].n_flips(), "grad_rel_pinned": rel(r),
                      "grad_rel_unpinned": rel(unpinned[label])}
    log(f"R1 card vs CPU ({R1_SIZE}x{R1_SIZE}, batch {R1_CPU_BATCH}, float32, TF32 off, gamma "
        f"{R1_GAMMA}): term float64 {ref['loss']:.6g}, card {runs['card']['loss']:.6g} (rel "
        f"{out['card']['loss_rel']:.3g}), CPU {runs['cpu']['loss']:.6g} (rel "
        f"{out['cpu']['loss_rel']:.3g}; tol {R1_LOSS_RTOL}); flips against float64 of "
        f"{n_inputs} activation inputs: card {out['card']['flips']}, CPU "
        f"{out['cpu']['flips']}; float64 pass {f64_s:.1f} s")
    log("  gradient error per leaf against float64, relative to its norm (leaves with "
        "gradient 0 in exact arithmetic: absolute, relative to the whole gradient's norm):")
    log(f"  {'':38s}" + "".join(f"{n:>15s}" for n in live))
    for label in runs:
        for kind in ("pinned", "unpinned"):
            rel = out[label]["grad_rel_" + kind]
            log(f"  {label + ', ' + kind:38s}" + "".join(
                f"{rel[n] * ref['grads'][n].norm().item() / total if _zero_grad_leaf(n) else rel[n]:15.3g}"
                for n in live))
    for label in runs:
        check(out[label]["loss_rel"] <= R1_LOSS_RTOL, f"R1 term: {label} {out[label]}")
        check(out[label]["flips"] <= R1_MAX_FLIP_SHARE * n_inputs,
              f"R1: {label} flips {out[label]['flips']} of {n_inputs}")
        for n in live:
            err = out[label]["grad_rel_pinned"][n]
            if _zero_grad_leaf(n):  # 0 in exact arithmetic: absolute, of the whole norm
                worst = runs[label]["grads"][n].norm().item()
                check(worst <= 1e-4 * total, f"R1 {label} {n}: gradient {worst:.3g} is not ~0")
                continue
            check(err <= R1_GRAD_PINNED_RTOL, f"R1 {label} {n}: {err:.3g} of its norm off float64")
    return out


def _production_run(torch, root: Path) -> dict:
    """(c) The main path: the Trainer on the production config with
    deterministic kernels: 16 steps, a server on the checkpoint, a new
    Trainer that resumes to 32 (``/reload`` then answers 32), the launches
    of every step exact; the artifact's ``__ema__`` and bits against the
    checkpoint's EMA generator; the training CLI on the config's copy for
    32 uninterrupted steps, its ``32.tar`` bitwise equal to the resumed
    run's, EMA included; and the config without ``split_phases`` (groups
    of 8 fused steps) for 16 steps, its ``16.tar`` bitwise the split run's."""
    from one_to_many_gan_torch import serve
    from one_to_many_gan_torch.convert import from_jax_params
    from one_to_many_gan_torch.core.state import Models
    from one_to_many_gan_torch.core.trainer import Trainer
    from one_to_many_gan_torch.data import _load_image
    from one_to_many_gan_torch.export import export_inference_artifact, load_inference_artifact
    from one_to_many_gan_torch.migrate import EMA_KEY, load_inference_weights
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd

    counters = (warp, warp_bwd, fused_instance_norm)
    config, _ = production_config(root, "a", deterministic_cuda_kernels=True)
    run_dir = root / "a"
    per_step, summaries, h2d = [], [], []
    step_ms = []
    printed = io.StringIO()

    def tapped(trainer):
        step_fn = trainer.train_step

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        trainer.train_step = timed
        return trainer

    for c in counters:
        c.launches = 0
    with contextlib.redirect_stdout(_Tee(sys.stdout, printed)):
        first = tapped(_trainer_with_taps(torch, config, counters, per_step, summaries, h2d))
        check(first.steps_per_call == 1, f"split_phases ran groups of {first.steps_per_call}")
        t0 = time.perf_counter()
        first.run(max_steps=P_CKPT)
        first_s = time.perf_counter() - t0
        timings_16 = dict(first.timings)
        del first
        torch.cuda.empty_cache()
        engine = serve.InferenceEngine(config, buckets=(T_ENGINE_N,))
        check(engine.step == P_CKPT and engine.ema, f"the server restored step {engine.step}, "
              f"EMA {engine.ema}")
        httpd = serve.make_server(engine, host="127.0.0.1", port=0)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        try:
            second = tapped(_trainer_with_taps(torch, config, counters, per_step, summaries,
                                               h2d))
            check(second.start_step == P_CKPT, f"the resume starts at {second.start_step}")
            t0 = time.perf_counter()
            second.run()
            second_s = time.perf_counter() - t0
            launches = dict(zip(("warp_fwd", "warp_bwd", "instance_norm"),
                                (c.launches for c in counters), strict=True))
            reload = _post_reload(httpd.server_address[1])
            health = _get(httpd.server_address[1], "/healthz")
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.batcher.close()
            server.join(timeout=60)
    check(not server.is_alive(), "the server thread did not stop")
    check(reload == {"status": "ok", "step": P_STEPS}, f"/reload answered {reload}")
    check(health.get("ema") is True and health.get("step") == P_STEPS, f"/healthz {health}")
    text = printed.getvalue()
    check(f"Resumed from checkpoint at step {P_CKPT}" in text.splitlines(),
          "the resumed Trainer did not print 'Resumed from checkpoint at step 16'")
    want = [[P_D_WARPS + P_G_WARPS, P_G_WARP_BWDS,
             len(P_STEP_IN_SITES) + (len(P_R1_IN_SITES) if s % P_R1_INTERVAL == 0 else 0)]
            for s in range(P_STEPS)]
    bad = [(k, n, w) for k, (n, w) in enumerate(zip(per_step, want, strict=False)) if n != w]
    check(len(per_step) == P_STEPS and not bad,
          f"{len(per_step)} Trainer steps; launches off the reckoning at {bad[:4]}")
    pattern = log_line_pattern(torch, P_STEPS)
    lines = (run_dir / "log").read_text().splitlines()
    train_lines = [ln for ln in lines if ln.startswith("Step:")]
    fid_lines = [ln for ln in lines if ln.startswith("Step ")]
    check([ln.split("/")[0] for ln in train_lines]
          == [f"Step: {s}" for s in range(P_LOG, P_STEPS + 1, P_LOG)]
          and all(pattern.fullmatch(ln) for ln in train_lines), f"log lines {train_lines}")
    check(len(fid_lines) == 2 and all(
        ln.startswith(f"Step {s} | fid: ") and ln.endswith("[random_projection_v1]")
        for ln, s in zip(fid_lines, (P_CKPT, P_STEPS), strict=True)), f"FID lines {fid_lines}")
    records = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
    check(all(np.isfinite(v) for r in records for k, v in r.items()
              if k not in ("step", "fid_extractor")), "a logged value is not finite")
    grids = sorted(p.name for p in (run_dir / "images").iterdir())
    check(grids == [f"{kind}_{s}.png" for kind in ("decoding", "translation")
                    for s in (P_CKPT, P_STEPS)], f"grids {grids}")
    n_val = len(list((run_dir / "val").glob("*.png")))
    check(n_val == P_EVAL_IMAGES, f"{n_val} validation images")
    tar = run_dir / "models" / f"{P_STEPS}.tar"
    tar_mib = tar.stat().st_size / 2**20
    ckpt = _load_ckpt(torch, tar)
    check(EMA_KEY in ckpt, "the checkpoint carries no EMA generator")
    ema_moved = max((ckpt[EMA_KEY][k] - ckpt["generator_state_dict"][k]).abs().max().item()
                    for k in ckpt[EMA_KEY])

    # the artifact: the EMA weights, and the same bits as the checkpoint's EMA
    t0 = time.perf_counter()
    art = export_inference_artifact(config, root / "model.npz")
    export_s = time.perf_counter() - t0
    params_g, params_m, step, ema = load_inference_artifact(art)
    check(ema and step == P_STEPS, f"the artifact says step {step}, __ema__ {ema}")
    from_art = from_jax_params(Models(config, device="cpu"), params_g, params_m)
    from_ckpt = Models(config, device="cpu")
    check(load_inference_weights(ckpt, from_ckpt), "the checkpoint served no EMA")
    same = all(torch.equal(p, q) for p, q in zip(from_art.generator.parameters(),
                                                 from_ckpt.generator.parameters(), strict=True))
    check(same, "the artifact's generator is not the checkpoint's EMA generator")
    engines = [serve.InferenceEngine(config, buckets=(T_ENGINE_N,), artifact=art),
               serve.InferenceEngine(config, buckets=(T_ENGINE_N,))]
    source = _load_image(root / "prints" / "test" / "00000.png", (P_SIZE, P_SIZE), 1)
    outs = [e.generate(source, T_ENGINE_N, seed=0) for e in engines]
    check(outs[0].shape == (T_ENGINE_N, P_SIZE, P_SIZE, 1) and np.array_equal(*outs),
          "the artifact's engine and the checkpoint's differ")
    del engines

    # the CLI on the production config's copy, 32 uninterrupted steps: its
    # 32.tar bitwise the paused and resumed run's, EMA included
    from one_to_many_gan_torch import train as train_cli

    cli_path = root / "b.toml"
    _, cli_changes = production_config(root, "b", deterministic_cuda_kernels=True)
    t0 = time.perf_counter()
    train_cli.main([str(cli_path)])
    cli_s = time.perf_counter() - t0
    other = _load_ckpt(torch, root / "b" / "models" / f"{P_STEPS}.tar")
    differ, n_tensors, n_elems = _ckpt_differences(torch, ckpt, other)
    # split_phases against the fused step: 16 steps in groups of 8
    fused_config, _ = production_config(root, "c", deterministic_cuda_kernels=True,
                                        split_phases=False, steps_per_call=P_LOG,
                                        training_steps=P_CKPT)
    t0 = time.perf_counter()
    fused = Trainer(fused_config, verbose=False)
    check(fused.steps_per_call == P_LOG, f"the fused run's groups: {fused.steps_per_call}")
    fused.run()
    fused_s = time.perf_counter() - t0
    del fused
    split_differ, split_tensors, _ = _ckpt_differences(
        torch, _load_ckpt(torch, run_dir / "models" / f"{P_CKPT}.tar"),
        _load_ckpt(torch, root / "c" / "models" / f"{P_CKPT}.tar"))
    check(torch.are_deterministic_algorithms_enabled(), "the runs had no deterministic kernels")

    at = dict(summaries)
    window_ms = (at[P_STEPS] - at[P_STEPS - P_LOG]) * 1e3 / P_LOG
    log(f"production Trainer (deterministic kernels, split phases): steps {P_STEPS - P_LOG}-"
        f"{P_STEPS - 1} {window_ms:.2f} ms a step = {P_BATCH / window_ms * 1e3:.2f} images/s "
        f"(log line to log line); per step (synchronised) R1 + path "
        + ", ".join(f"{step_ms[s]:.1f}" for s in (0, P_R1_INTERVAL))
        + f"; path {step_ms[P_INTERVAL]:.1f}, {step_ms[3 * P_INTERVAL]:.1f}; other median "
        f"{statistics.median(step_ms[s] for s in range(P_STEPS) if s % P_INTERVAL):.1f} ms; "
        f"runs {first_s:.1f} + {second_s:.1f} s")
    log(f"  checkpoint at 16: grids {timings_16['image'] * 1e3:.1f} ms, val_checkpoint "
        f"{timings_16['val'] * 1e3:.1f} ms, save {timings_16['save'] * 1e3:.1f} ms; at 32: "
        f"{second.timings['image'] * 1e3:.1f}, {second.timings['val'] * 1e3:.1f}, "
        f"{second.timings['save'] * 1e3:.1f} ms; {P_STEPS}.tar {tar_mib:.2f} MiB; EMA off the "
        f"generator by up to {ema_moved:.3g}")
    log(f"  artifact {art.stat().st_size / 2**20:.2f} MiB in {export_s * 1e3:.1f} ms, "
        f"__ema__ {ema}, its generator the checkpoint's EMA bitwise, its engine's {T_ENGINE_N} "
        f"images the checkpoint's bitwise; /reload -> {reload}; /healthz ema "
        f"{health.get('ema')}; launches {launches}")
    log(f"  exact resume: 16 + a resume to 32 against `python -m one_to_many_gan_torch.train` "
        f"on the config's copy ({', '.join(cli_changes)} changed), 32 uninterrupted steps in "
        f"{cli_s:.1f} s: {n_tensors} tensors ({n_elems} elements) of {P_STEPS}.tar compared, "
        f"{len(differ)} differ {differ[:8]}")
    log(f"  split phases (groups of 1) against the fused step (groups of {P_LOG}, {fused_s:.1f} "
        f"s): {split_tensors} tensors of {P_CKPT}.tar compared, {len(split_differ)} differ "
        f"{split_differ[:8]}")
    n_params = sum(len(list(getattr(second.state, m).parameters()))
                   for m in ("generator", "discriminator", "mapping", "extractor"))
    want_tensors = (4 * n_params + len(ckpt["image_buffer_images"]) + 2
                    + len(list(second.state.generator.parameters())))
    check(n_tensors == want_tensors and not differ,
          f"{n_tensors} tensors compared (want {want_tensors}); differ: {differ[:20]}")
    check(split_tensors > 0 and not split_differ,
          f"split phases against the fused step: {split_tensors} tensors, differ "
          f"{split_differ[:20]}")
    return {"launches": launches, "per_step": per_step, "step_ms": step_ms,
            "window_ms": window_ms, "images_per_s": P_BATCH / window_ms * 1e3,
            "run_s": [first_s, second_s], "cli_run_s": cli_s, "fused_run_s": fused_s,
            "split_differ": split_differ, "timings_16": timings_16,
            "timings_32": dict(second.timings), "tar_mib": tar_mib, "ema_moved": ema_moved,
            "artifact_mib": art.stat().st_size / 2**20, "export_s": export_s,
            "reload": reload, "healthz": health, "compared_tensors": n_tensors,
            "compared_elements": n_elems, "differ": differ, "log": lines}


def phase_production(torch) -> dict:
    """The production config on one card (module docstring, phase 15)."""
    import tempfile

    from one_to_many_gan_torch.data import write_synthetic_dataset_dirs

    t_phase = time.perf_counter()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_production_") as tmp:
        root = Path(tmp)
        config, changes = production_config(root, "a")
        from one_to_many_gan_torch.config import load_config

        source = load_config(PROD_CONFIG)
        flat = {k: v for sec in source.values() if isinstance(sec, dict) for k, v in sec.items()}
        out["overrides"] = {k: [str(flat.get(k)), str(v)] for k, v in changes.items()}
        for key, (old, new) in out["overrides"].items():
            log(f"production config override {key}: {old} -> {new}")
        if _native_reason() is not None:
            log("production config: native_loader = false, because the C++ image loader does "
                "not build on this host (phase 16e): "
                + " | ".join(_native_reason().splitlines()[:3]))
        check(config["tpu"]["ema_decay"] > 0 and config["tpu"]["r1_gamma"] > 0
              and config["tpu"]["split_phases"] and not config["tpu"]["g_loss_split"]
              and config["tpu"]["path_interval"] == P_INTERVAL
              and config["tpu"]["r1_interval"] == P_R1_INTERVAL
              and config["training"]["batch_size"] == P_BATCH
              and tuple(config["data"]["image_size"]) == (P_SIZE, P_SIZE),
              f"the production config is not the one phase 15 reckons with: {config['tpu']}")
        out["bare"] = _production_bare_steps(torch, config)
        torch.cuda.empty_cache()
        out["r1"] = _r1_card_vs_cpu(torch)
        for domain, seed in (("prints", 0), ("marks", 9)):
            write_synthetic_dataset_dirs(root / domain, n_train=T_TRAIN_IMAGES,
                                         n_test=T_TEST_IMAGES, image_size=(P_SIZE, P_SIZE),
                                         seed=seed)
        with _determinism_restored(torch):
            out["run"] = _production_run(torch, root)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 15 ok in {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 16


def _bf16_excess(torch, got, want, bound) -> float:
    """The largest error beyond one bf16 ulp, over ``bound`` (a number or a
    per-pixel tensor): at most 1 where the kernel is within one ulp plus
    its float32 summation bound."""
    diff = (got.double() - want.double()).abs()
    mag = torch.maximum(got.double().abs(), want.double().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0**-126))) - 7)
    return ((diff - ulp).clamp_min(0) / bound).max().item()


def _ss_warp_sites(torch) -> list:
    """(a) The warp forward and backward at the supersampled path's shape
    and coordinates (S_SHAPE, antialias off, widths 1), float32 and
    bfloat16, against their plain versions; two launches bitwise equal;
    the kernel's, plain version's, library call's (float32) and bound's
    times."""
    import torch.nn.functional as F

    from one_to_many_gan_torch.augment.pipeline import (
        draw_augment,
        geometric_matrix,
        supersampled_coords,
    )
    from one_to_many_gan_torch.ops.cuda import (
        warp,
        warp_bwd,
        warp_bwd_plain,
        warp_bwd_sum_bound,
        warp_plain,
    )

    b, h, w = S_SHAPE
    gen = torch.Generator("cuda").manual_seed(16)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    draws = draw_augment(gen, b, "cuda")
    g_inv = geometric_matrix(draws.geom, P_SIZE, P_SIZE, torch.tensor(0.9, device="cuda"))
    sx, sy = supersampled_coords(g_inv, P_SIZE, P_SIZE)
    ones = torch.ones(b, device="cuda")
    coords = (sx, sy, ones, ones)
    taps = (_taps(torch, sx, ones, w, False) * _taps(torch, sy, ones, h, False)).sum().item()
    # grid_sample, align_corners=True: pixel = (g + 1) / 2 * (n - 1)
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], dim=-1)
    cases = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x = (torch.rand(S_SHAPE, generator=gen, device="cuda") * 2 - 1).to(dtype)
        dout = torch.randn(S_SHAPE, generator=gen, device="cuda").to(dtype)
        esize = x.element_size()
        # each function reads its image (or cotangent) and both coordinate
        # planes once and writes its output once
        nbytes = b * h * w * (2 * esize + 8) + 2 * b * 4
        bound = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "ops_ms": 2 * taps / F32_FLOP_PER_S * 1e3}
        bound["bound_ms"] = max(bound.values())
        bound["bound_by"] = "bytes" if bound["bytes_ms"] >= bound["ops_ms"] else "operations"
        for fn_name, kernel, plain, arg in (("warp_fwd", warp, warp_plain, x),
                                            ("warp_bwd", warp_bwd, warp_bwd_plain, dout)):
            got = kernel(arg, *coords, antialias=False)
            again = kernel(arg, *coords, antialias=False)
            want = plain(arg, *coords, antialias=False)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            fns = {"kernel_ms": lambda t, k=kernel: k(t, *coords, antialias=False)}
            lib_err = None
            if dtype == torch.float32:
                if fn_name == "warp_fwd":
                    def lib(t):
                        return F.grid_sample(t[:, None], grid, mode="bilinear",
                                             padding_mode="zeros", align_corners=True)[:, 0]
                else:
                    def lib(t, img=x[:, None]):
                        return torch.ops.aten.grid_sampler_2d_backward(
                            t[:, None], img, grid, 0, 0, True, [True, False])[0][:, 0]
                fns["library_ms"] = lib
                lib_err = (lib(arg) - want).abs().max().item()
            times = time_cold_ms(torch, fns, arg, flush)
            # the plain versions are dense contractions here (the backward's
            # 1 s a call): fewer rounds
            times.update(time_cold_ms(torch, {"plain_ms": lambda t, p=plain: p(
                t, *coords, antialias=False)}, arg, flush, reps=S_PLAIN_REPS))
            case = {"fn": fn_name, "dtype": dtype_name, "shape": list(S_SHAPE),
                    "max_abs_err": err, "library_err": lib_err,
                    "repeat_bitwise_equal": torch.equal(got, again),
                    "taps_per_pixel": taps / (b * h * w), **bound, **times,
                    "library_ms": times.get("library_ms")}
            if dtype == torch.bfloat16:
                sum_bound = (WARP_TOL_BF16_SUM * x.abs().max().item() if fn_name == "warp_fwd"
                             else warp_bwd_sum_bound(dout, *coords, antialias=False)
                             .clamp_min(1e-300))
                case["bf16_excess_of_sum_bound"] = _bf16_excess(torch, got, want, sum_bound)
            cases.append(case)
            lib_txt = ("library n/a (a bf16 grid cannot hold pixel coordinates)"
                       if lib_err is None else
                       f"library {case['library_ms']:.4f} ms (err {lib_err:.3g})")
            log(f"{fn_name} [{b},{h},{w}] {dtype_name:8s} aa=0 (supersampled): max_abs_err "
                f"{err:.3g} (bf16 beyond one ulp "
                f"{case.get('bf16_excess_of_sum_bound', 0.0):.3f} of the sum bound) kernel "
                f"{case['kernel_ms']:.4f} ms plain {case['plain_ms']:.4f} ms {lib_txt} bound "
                f"{case['bound_ms']:.4f} ms ({case['bound_by']}); {case['taps_per_pixel']:.2f} "
                "taps/pixel")
            check(torch.isfinite(got).all().item(), f"{fn_name} output not finite: {case}")
            check(case["repeat_bitwise_equal"], f"two {fn_name} launches differ: {case}")
            if dtype == torch.float32:
                check(err <= WARP_TOL_F32, f"{fn_name} disagrees with its plain version: {case}")
            else:
                check(case["bf16_excess_of_sum_bound"] <= 1.0 and err <= WARP_TOL_BF16_ABS,
                      f"bf16 {fn_name} disagrees with its plain version: {case}")
            del got, again, want
        del x, dout
    del flush
    torch.cuda.empty_cache()
    return cases


def _ss_card_vs_cpu(torch) -> dict:
    """(b) The supersampled ``augment`` of S_CPU_BATCH synthetic 512^2
    images at p 0.9, float32, on the card and on the CPU, same draws."""
    from one_to_many_gan_torch.augment.pipeline import augment, draw_augment
    from one_to_many_gan_torch.data import normalize_u8, synthetic_images

    images = torch.from_numpy(normalize_u8(synthetic_images(S_CPU_BATCH, (P_SIZE, P_SIZE),
                                                            seed=16)))
    draws = draw_augment(torch.Generator().manual_seed(16), S_CPU_BATCH, "cpu")
    t0 = time.perf_counter()
    cpu = augment(images, 0.9, draws, supersample=True)
    cpu_s = time.perf_counter() - t0
    card = augment(images.cuda(), 0.9, _to(draws, "cuda"), supersample=True).cpu()
    err = (card - cpu).abs().max().item()
    moved = (cpu - images).abs().max().item()
    log(f"supersampled augment [{S_CPU_BATCH},{P_SIZE},{P_SIZE}] f32, card against CPU: max "
        f"abs {err:.3g} (limit {CARD_VS_CPU_TOL}); the transform moved pixels by up to "
        f"{moved:.3g}; the CPU took {cpu_s:.2f} s")
    check(card.shape == images.shape and torch.isfinite(card).all().item(),
          "the card's supersampled augment is not finite or has another shape")
    check(moved > 0.1, "the supersampled augment left the images in place")
    check(err <= CARD_VS_CPU_TOL, f"supersampled augment card against CPU: {err}")
    return {"max_abs_err": err, "moved": moved, "cpu_s": cpu_s}


def _timed_phases(torch, counters, run_d, run_g) -> dict:
    """One D phase and one G phase, each synchronised: their ms, peak
    bytes and launches."""
    out = {}
    for name, fn in (("d", run_d), ("g", run_g)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = [c.launches for c in counters]
        t0 = time.perf_counter()
        out[f"{name}_metrics"] = fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{name}_peak"] = torch.cuda.max_memory_allocated()
        out[f"{name}_launches"] = _phase_counts(counters, c0)
    return out


def _want_launches(step: int, mode: str = "none") -> tuple[list, list]:
    """The exact launches (warp, warp backward, instance norm) of one D and
    one G phase of the production config at ``step``: under remat the G
    phase's every instance norm runs again in the backward's recompute and
    the D phase's discriminator pass's (the trunk on the packed batch)."""
    again = mode != "none"
    d_in = (len(P_D_IN_SITES) + (len(P_R1_IN_SITES) if step % P_R1_INTERVAL == 0 else 0)
            + (len(_TRUNK_512) if again else 0))
    return ([P_D_WARPS, 0, d_in], [P_G_WARPS, P_G_WARP_BWDS, len(P_G_IN_SITES) * (1 + again)])


def _steps(torch, config, n: int, counters, collect=None) -> list:
    """``n`` steps of ``config`` from seed 0 at ADA p D_ADA_P on synthetic
    batches, each phase timed (``_timed_phases``) and its launches checked;
    ``collect(state, phase, metrics)`` sees each phase's results."""
    from one_to_many_gan_torch import train
    from one_to_many_gan_torch.core.train_step import (
        Batches,
        draw_step,
        make_d_phase,
        make_g_phase,
        synthetic_batch,
    )

    mode = config["tpu"]["remat"]
    models, state, gen = train.setup(config, seed=0, ada_p=D_ADA_P, device="cuda")
    d_phase, g_phase = make_d_phase(config, models), make_g_phase(config, models)
    rows = []
    for step in range(n):
        b = Batches(*(synthetic_batch(gen, P_BATCH, (P_SIZE, P_SIZE), 1) for _ in range(4)))
        draws = draw_step(gen, config, models)
        p_used = state.ada.p

        def run_d(b=b, draws=draws):
            _, m = d_phase(state, b.d_shoeprints, b.d_shoemarks, draws.d)
            if collect is not None:
                collect(state, "d", m)
            return m

        def run_g(b=b, draws=draws, p_used=p_used):
            _, m = g_phase(state, b, draws.g, p_used)
            if collect is not None:
                collect(state, "g", m)
            return m

        row = _timed_phases(torch, counters, run_d, run_g)
        m = {k: v.item() for k, v in {**row.pop("d_metrics"), **row.pop("g_metrics")}.items()}
        row = {"step": step, **row, "ms": row["d_ms"] + row["g_ms"], **m}
        rows.append(row)
        want_d, want_g = _want_launches(step, mode)
        check(row["d_launches"] == want_d and row["g_launches"] == want_g,
              f"step {step} (remat {mode}): D launches {row['d_launches']} (want {want_d}), "
              f"G {row['g_launches']} (want {want_g})")
        check(all(np.isfinite(v) for k, v in m.items() if k != "ada_p"),
              f"step {step}: a metric is not finite: {m}")
        check(m["path_loss"] > 0 if step % P_INTERVAL == 0 else m["path_loss"] == 0,
              f"step {step}: path_loss {m['path_loss']}")
    return rows


def _ss_bare_steps(torch, config, bare15: dict) -> dict:
    """(c) S_BARE_STEPS steps with ``ada_supersample``: every warp on the
    [8, 1024, 1024] grid, the launches per phase phase 15's, the step
    times beside phase 15's."""
    from one_to_many_gan_torch.augment import pipeline
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd

    counters = (warp, warp_bwd, fused_instance_norm)
    shapes = []
    kernel = pipeline.warp

    def spy(images, *args, **kwargs):
        shapes.append(tuple(images.shape))
        return kernel(images, *args, **kwargs)

    pipeline.warp = spy
    try:
        for c in counters:
            c.launches = 0
        rows = _steps(torch, config, S_BARE_STEPS, counters)
        launches = dict(zip(("warp_fwd", "warp_bwd", "instance_norm"),
                            (c.launches for c in counters), strict=True))
    finally:
        pipeline.warp = kernel
    check(shapes == [S_SHAPE] * (P_D_WARPS + P_G_WARPS) * S_BARE_STEPS,
          f"the supersampled steps warped {shapes}")
    other = statistics.fmean(r["ms"] for r in rows[1:])
    base = bare15["median"]
    log(f"supersampled ADA steps ({P_SIZE}x{P_SIZE}, batch {P_BATCH}, bf16; every warp "
        f"[{','.join(map(str, S_SHAPE))}]): step 0 (R1 + path) {rows[0]['ms']:.2f} ms (D "
        f"{rows[0]['d_ms']:.2f}, G {rows[0]['g_ms']:.2f}; phase 15's median "
        f"{base['r1_path']['ms']:.2f}), other steps mean {other:.2f} ms (D "
        f"{statistics.fmean(r['d_ms'] for r in rows[1:]):.2f}, G "
        f"{statistics.fmean(r['g_ms'] for r in rows[1:]):.2f}; phase 15's median "
        f"{base['other']['ms']:.2f}, x{other / base['other']['ms']:.3f}); G peak "
        f"{max(r['g_peak'] for r in rows) / 2**30:.2f} GiB; launches {launches}")
    return {"rows": rows, "other_mean_ms": other, "over_phase15_other": other / base["other"]["ms"],
            "launches": launches}


def _remat_steps(torch, base) -> dict:
    """(d) Under deterministic kernels, a path (and R1) step and another
    step from seed 0 under each remat mode (remat_d same): every metric,
    every gradient leaf of both phases and the parameters after them
    bitwise equal to "none"'s; each phase's ms, peak and exact launches."""
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd

    counters = (warp, warp_bwd, fused_instance_norm)
    out: dict = {"modes": {}}
    ref = None
    with _determinism_restored(torch):
        for mode in REMAT_MODES:
            config = copy.deepcopy(base)
            config["training"]["deterministic_cuda_kernels"] = True
            config["tpu"]["remat"], config["tpu"]["remat_d"] = mode, "same"
            seen = []
            last = {}

            def collect(state, phase, metrics, seen=seen, last=last):
                nets = ((state.discriminator,) if phase == "d"
                        else (state.generator, state.mapping, state.extractor))
                seen.extend(v.detach().cpu() for v in metrics.values())
                seen.extend(p.grad.cpu() for net in nets for p in net.parameters())
                last["state"] = state

            for c in counters:
                c.launches = 0
            rows = _steps(torch, config, 2, counters, collect)
            check(torch.are_deterministic_algorithms_enabled(), "remat ran without determinism")
            state = last.pop("state")
            seen.extend(p.detach().cpu() for net in (state.discriminator, state.generator,
                                                    state.mapping, state.extractor)
                        for p in net.parameters())
            del state
            launches = dict(zip(("warp_fwd", "warp_bwd", "instance_norm"),
                                (c.launches for c in counters), strict=True))
            if ref is None:
                ref = seen
                differ = []
            else:
                check(len(seen) == len(ref), f"remat {mode}: {len(seen)} tensors, none "
                      f"{len(ref)}")
                differ = [i for i, (a, b) in enumerate(zip(seen, ref, strict=True))
                          if not torch.equal(a, b)]
            out["modes"][mode] = {"rows": rows, "launches": launches, "differ": differ,
                                  "compared": len(seen)}
            gib = [(r["d_peak"] / 2**30, r["g_peak"] / 2**30) for r in rows]
            log(f"remat {mode} (remat_d same, deterministic; {P_SIZE}x{P_SIZE}, batch "
                f"{P_BATCH}, bf16): path + R1 step D {rows[0]['d_ms']:.2f} ms G "
                f"{rows[0]['g_ms']:.2f} ms, other step D {rows[1]['d_ms']:.2f} ms G "
                f"{rows[1]['g_ms']:.2f} ms; peak GiB D {gib[0][0]:.2f}/{gib[1][0]:.2f} G path "
                f"{gib[0][1]:.2f} other {gib[1][1]:.2f}; launches D {rows[0]['d_launches']} "
                f"{rows[1]['d_launches']}, G {rows[0]['g_launches']}; {len(seen)} tensors "
                f"against none's, {len(differ)} differ")
            check(not differ, f"remat {mode}: tensors {differ[:10]} differ from none's")
            torch.cuda.empty_cache()
    out["launches"] = {k: sum(m["launches"][k] for m in out["modes"].values())
                       for k in ("warp_fwd", "warp_bwd", "instance_norm")}
    return out


def _native_loader(torch, root: Path) -> dict:
    """(e) Where the C++ loader builds on this host: its decode of the
    512^2 folders (written at that size) against the PIL path, byte for
    byte, and its seconds against PIL's; ``assemble_batch`` against the
    numpy gather, flip and ``x * (1 / 127.5) - 1``; then S_NATIVE_STEPS
    steps of the Trainer with ``native_loader = true``."""
    from one_to_many_gan_torch.core.trainer import Trainer
    from one_to_many_gan_torch.data import ShoeDataset, native, write_synthetic_dataset_dirs
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd

    reason = _native_reason()
    if reason is not None:
        log("phase 16e: the native loader does not build on this host, so phases 15 and 16 "
            "keep native_loader = false: " + " | ".join(reason.splitlines()[:3]))
        return {"built": False, "reason": reason}
    for domain, seed in (("prints", 0), ("marks", 9)):
        write_synthetic_dataset_dirs(root / domain, n_train=T_TRAIN_IMAGES,
                                     n_test=T_TEST_IMAGES, image_size=(P_SIZE, P_SIZE),
                                     seed=seed)
    kw = {"mode": "train", "image_size": (P_SIZE, P_SIZE), "channels": 1}
    t0 = time.perf_counter()
    pil = ShoeDataset(root / "prints", **kw).images
    pil_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = ShoeDataset(root / "prints", native=True, **kw).images
    native_s = time.perf_counter() - t0
    check(np.array_equal(pil, nat), "the native decode differs from PIL's at the images' size")
    rng = np.random.default_rng(16)
    idx, flips = rng.permutation(len(nat))[:P_BATCH], rng.random(P_BATCH) < 0.5
    batch = nat[idx]
    batch[flips] = batch[flips, :, ::-1]
    want = batch.astype(np.float32) * np.float32(1 / 127.5) - np.float32(1)
    check(np.array_equal(native.assemble_batch(nat, idx, flips), want),
          "assemble_batch differs from the numpy gather, flip and normalisation")
    counters = (warp, warp_bwd, fused_instance_norm)
    config, _ = production_config(root, "n", native_loader=True, training_steps=S_NATIVE_STEPS)
    for c in counters:
        c.launches = 0
    trainer = Trainer(config, verbose=False)
    check(trainer.shoeprint_iter.native, "the Trainer's streams are not native")
    check(trainer.run().step == S_NATIVE_STEPS, "the native-loader Trainer stopped early")
    launches = dict(zip(("warp_fwd", "warp_bwd", "instance_norm"),
                        (c.launches for c in counters), strict=True))
    log(f"native loader: {len(nat)} images of {P_SIZE}x{P_SIZE} decoded in {native_s:.3f} s "
        f"(PIL {pil_s:.3f} s), byte-equal to PIL's; assemble_batch byte-equal to numpy's; "
        f"the Trainer with native_loader = true trained {S_NATIVE_STEPS} steps; launches "
        f"{launches}")
    return {"built": True, "native_s": native_s, "pil_s": pil_s, "launches": launches}


def phase_slice7(torch, production: dict) -> dict:
    """The slice's training options on the production config (module
    docstring, phase 16)."""
    import tempfile

    t_phase = time.perf_counter()
    out: dict = {"ss_warp": _ss_warp_sites(torch)}
    out["ss_card_vs_cpu"] = _ss_card_vs_cpu(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_slice7_") as tmp:
        root = Path(tmp)
        config, _ = production_config(root, "s")
        ss_config = copy.deepcopy(config)
        ss_config["tpu"]["ada_supersample"] = True
        out["ss_steps"] = _ss_bare_steps(torch, ss_config, production["bare"])
        torch.cuda.empty_cache()
        out["remat"] = _remat_steps(torch, config)
        torch.cuda.empty_cache()
        out["native"] = _native_loader(torch, root)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 16 ok in {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------- main


# ---------------------------------------------------------------- phase 17


def held_mask(grad, want_grad, lr: float, first: bool):
    """Where Adam must move a parameter alike from two gradients that differ
    by float reassociation: its first step is ``lr * g / (|g| + eps)``,
    alike where |g| exceeds twice the two gradients' largest disagreement
    (the signs agree) and eps does not magnify that past half the atol; a
    later step scales with g, alike where the disagreement is under 1 % of
    |g|. Elsewhere (a gradient of rounding noise: the bias of a conv an
    instance norm follows) the two moves may differ by up to 2 lr."""
    err = (grad - want_grad).abs().max()
    if first:
        low = want_grad.abs() - err
        return (low > err) & (lr * 1e-8 * err / (low + 1e-8) ** 2 < STEP_ATOL / 2)
    return want_grad.abs() > 100 * err


def _named_params(state) -> dict:
    nets = {"g": state.generator, "m": state.mapping, "d": state.discriminator,
            "s": state.extractor}
    return {f"{k}.{n}": p for k, m in nets.items() for n, p in m.named_parameters()}


def compare_steps(torch, got: dict, want: dict, lr: float, first: bool, label: str, *,
                  grad_rtol: float = STEP_RTOL, min_held: float = 0.9) -> dict:
    """Metrics within the step tolerance; gradients per leaf within
    ``grad_rtol`` of the leaf's largest entry; parameters within the step
    tolerance wherever Adam must move them alike (``held_mask``), which
    must be at least ``min_held`` of them. ``got`` / ``want``: {"metrics",
    "grads", "params"} (tensors on any device). -> the largest errors."""
    out = {"metric_rel": 0.0, "grad_rel": 0.0, "grad_worst": None, "param_err_held": 0.0,
           "param_err": 0.0, "held_share": 0.0}
    for name, w in want["metrics"].items():
        g = got["metrics"][name]
        check(abs(g - w) <= STEP_ATOL + STEP_RTOL * abs(w), f"{label}: {name} {g} against {w}")
        out["metric_rel"] = max(out["metric_rel"], abs(g - w) / max(abs(w), 1e-12))
    held = total = 0
    for name, w in want["grads"].items():
        g = got["grads"][name].double().cpu()
        w = w.double().cpu()
        scale = w.abs().max().item()
        pg, pw = got["params"][name].double().cpu(), want["params"][name].double().cpu()
        diff = (pg - pw).abs()
        out["param_err"] = max(out["param_err"], diff.max().item())
        total += w.numel()
        if scale < 1e-5:  # rounding noise: the bias of a conv an instance norm follows
            continue
        rel = (g - w).abs().max().item() / scale
        check(rel <= grad_rtol, f"{label}: gradient {name} {rel:.3g} of its largest entry")
        if rel > out["grad_rel"]:
            out["grad_rel"], out["grad_worst"] = rel, name
        same = held_mask(g, w, lr / 100 if name.startswith("m.") else lr, first)
        held += int(same.sum())
        if same.any():
            bad = diff[same] > STEP_ATOL + STEP_RTOL * pw.abs()[same]
            check(not bad.any().item(), f"{label}: parameter {name} off where held")
            out["param_err_held"] = max(out["param_err_held"], diff[same].max().item())
    out["held_share"] = held / total
    check(out["held_share"] >= min_held,
          f"{label}: only {out['held_share']:.3f} of the parameters held")
    return out


def _snapshot_step(torch, state, metrics: dict, steps: int) -> dict:
    params = _named_params(state)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": {k: p.grad.detach().cpu().clone() for k, p in params.items()},
            "params": {k: p.detach().cpu().clone() for k, p in params.items()},
            "steps": steps}


def phase_data_parallel(torch) -> dict:
    """17. The data-parallel step with a world of one card over NCCL
    against the step without a group, each step from the same state (the
    no-group run's, through its checkpoint dict), on the same batches and
    draws; its launches; the collectives' device time."""
    import torch.distributed as dist

    from one_to_many_gan_torch import train
    from one_to_many_gan_torch.core.train_step import (
        Batches,
        draw_step,
        make_train_step,
        synthetic_batch,
    )
    from one_to_many_gan_torch.device import use_deterministic_kernels
    from one_to_many_gan_torch.migrate import from_reference_checkpoint, to_reference_checkpoint
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd
    from one_to_many_gan_torch.parallel import distributed, replicate

    config = d_phase_config("float32", D_BATCH, path_interval=G_INTERVAL)
    lr = config["optimisation"]["learning_rate"]
    counters = (warp, warp_bwd, fused_instance_norm)
    group = distributed.ensure_initialized(
        "cuda", rank=0, world_size=1,
        init_method=f"tcp://127.0.0.1:{distributed._free_port()}")
    try:
        with _determinism_restored(torch):
            use_deterministic_kernels()
            models, state, gen = train.setup(config, seed=0, ada_p=D_ADA_P, device="cuda")
            step_fn = make_train_step(config, models)
            g_models, g_state, _ = train.setup(config, seed=1, ada_p=D_ADA_P, device="cuda")
            replicate(group, g_state)
            g_step_fn = make_train_step(config, g_models, group)
            refs = []  # the no-group steps: each one's state before it, inputs, result
            for _ in range(DP_STEPS):
                start = to_reference_checkpoint(state)
                batches = Batches(*(synthetic_batch(gen, D_BATCH, (D_SIZE, D_SIZE), 1)
                                    for _ in range(4)))
                draws = draw_step(gen, config, models)
                state, metrics = step_fn(state, batches, draws)
                refs.append((start, batches, draws, _snapshot_step(torch, state, metrics, 1)))
            for c in counters:  # the main path of this phase: the group's steps
                c.launches = 0
            errs, launches, step_ms = [], [], []
            for k, (start, batches, draws, want) in enumerate(refs):
                g_state = from_reference_checkpoint(start, g_state, step=k)
                c0 = [c.launches for c in counters]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g_state, g_metrics = g_step_fn(g_state, batches, draws)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                launches.append(_phase_counts(counters, c0))
                errs.append(compare_steps(torch, _snapshot_step(torch, g_state, g_metrics, 1),
                                          want, lr, first=k == 0,
                                          label=f"group of one against no group, step {k}"))
            total = dict(zip(("warp_fwd", "warp_bwd", "instance_norm"),
                             (c.launches for c in counters), strict=True))
            del refs
            prof = profile_call(torch, lambda: train.run_step(config, g_models, g_state,
                                                              g_step_fn, gen, group),
                                "one fused step in a group of one (float32)",
                                select=lambda n: "nccl" in n.lower())
            flats = {k: torch.zeros(sum(p.numel() for p in mod.parameters()), device="cuda")
                     for k, mod in (("d", g_state.discriminator), ("g", g_state.generator),
                                    ("m", g_state.mapping), ("s", g_state.extractor))}
            allreduce = {k: {"bytes": f.numel() * 4,
                             "ms": _cuda_ms(torch, lambda f=f: dist.all_reduce(f), 20)}
                         for k, f in flats.items()}
            del models, state, step_fn, g_models, g_state, g_step_fn, flats
            torch.cuda.empty_cache()
        want = [G_WARPS_PER_STEP, G_WARP_BWDS_PER_STEP, G_IN_PER_STEP]
        check(all(c == want for c in launches), f"group steps launched {launches} (want {want})")
    finally:
        group.close()
        dist.destroy_process_group()
    nccl_ms = sum(k["ms"] for k in prof["selected"])
    worst = {key: max(e[key] for e in errs) for key in errs[0] if key != "grad_worst"}
    worst["held_share"] = min(e["held_share"] for e in errs)
    log(f"data-parallel step, world 1 over NCCL ({D_SIZE}x{D_SIZE}, batch {D_BATCH}, float32, "
        f"{DP_STEPS} steps, each from the no-group run's state): metrics "
        f"{worst['metric_rel']:.3g} relative, gradients {worst['grad_rel']:.3g} of each leaf's "
        f"largest entry, parameters {worst['param_err_held']:.3g} where held "
        f"({worst['held_share']:.4f} of them), {worst['param_err']:.3g} anywhere; step ms "
        f"{[round(t, 2) for t in step_ms]}")
    log(f"  launches {total}; NCCL kernels in one step's profile {nccl_ms:.4f} ms "
        f"({len(prof['selected'])} names) of {prof['busy_ms']:.2f} ms busy; all-reduce of each "
        "optimiser's gradient buffer, one card: " + ", ".join(
            f"{k} {v['bytes'] / 2**20:.2f} MiB {v['ms']:.4f} ms" for k, v in allreduce.items()))
    log("phase 17 ok")
    return {"launches": total, "per_step": launches, "errors": errs, "step_ms": step_ms,
            "nccl_ms": nccl_ms, "nccl_kernels": prof["selected"], "profile_busy_ms":
            prof["busy_ms"], "idle_share": prof["idle_share"], "allreduce": allreduce}


# ---------------------------------------------------------------- phase 19


def _split_norm(torch, x, spatial: int, relu: bool, kernel: bool):
    """The split instance norm of ``x`` cut into ``spatial`` bands of rows
    on one card: every band's partials, stacked in band order in place of
    the all-gather, then every band's apply. -> (output, partials)."""
    from one_to_many_gan_torch.ops.cuda import instance_norm as in_module
    from one_to_many_gan_torch.parallel import halo

    part = in_module.instance_norm_partials if kernel else in_module.partials_plain
    apply = in_module.instance_norm_apply if kernel else in_module.apply_plain
    bands = [x[:, :, lo:hi].contiguous()
             for lo, hi in (halo.band(x.shape[2], spatial, t) for t in range(spatial))]
    gathered = torch.stack([part(b) for b in bands])
    return torch.cat([apply(b, gathered, relu=relu) for b in bands], 2), gathered


def _split_sites(torch) -> dict:
    """19a: the split form at SP_IN_SITES, float32 and bfloat16, S = 2 and
    4: against its plain version and the whole-plane kernel, two launches
    bitwise equal; in bfloat16, one band's partials and apply timed (cold
    L2) beside the whole-plane kernel, ``F.instance_norm`` of the whole
    site, the library calls of each launch's work (``torch.var_mean``;
    ``F.batch_norm`` with the combined statistics) and the bytes bounds."""
    import torch.nn.functional as F

    from one_to_many_gan_torch.ops.cuda import fused_instance_norm
    from one_to_many_gan_torch.ops.cuda import instance_norm as in_module
    from one_to_many_gan_torch.ops.cuda.instance_norm import plan
    from one_to_many_gan_torch.parallel import halo

    gen = torch.Generator("cuda").manual_seed(19)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for b, c, h, w, relu in sorted(set(SP_IN_SITES)):
            x = (torch.randn((b, c, h, w), generator=gen, device="cuda") * 2 + 0.5).to(dtype)
            whole = fused_instance_norm(x, relu=relu)
            for spatial in SP_SPLITS:
                got, gathered = _split_norm(torch, x, spatial, relu, kernel=True)
                again, _ = _split_norm(torch, x, spatial, relu, kernel=True)
                plain, _ = _split_norm(torch, x, spatial, relu, kernel=False)
                torch.cuda.synchronize()
                case = {"dtype": dtype_name, "b": b, "c": c, "h": h, "w": w, "relu": relu,
                        "spatial": spatial,
                        "band_rows": [hi - lo for lo, hi in (halo.band(h, spatial, t)
                                                             for t in range(spatial))],
                        "max_abs_err": (got.float() - plain.float()).abs().max().item(),
                        "vs_whole_kernel": (got.float() - whole.float()).abs().max().item(),
                        "repeat_bitwise_equal": torch.equal(got, again), "tol": IN_TOL[dtype_name]}
                check(case["repeat_bitwise_equal"], f"two split IN launches differ: {case}")
                check(max(case["max_abs_err"], case["vs_whole_kernel"]) <= case["tol"],
                      f"split IN off its plain version or the whole-plane kernel: {case}")
                if dtype == torch.bfloat16:
                    lo, hi = halo.band(h, spatial, 0)
                    x0 = x[:, :, lo:hi].contiguous()
                    layout = plan(b * c, (hi - lo) * w, dtype)
                    mean, var = in_module.combine_plain(gathered, True)
                    case["plan"] = layout.__dict__
                    case.update(time_cold_ms(torch, {
                        "partials_ms": lambda t: in_module.instance_norm_partials(t),
                        "apply_ms": lambda t, r=relu: in_module.instance_norm_apply(
                            t, gathered, relu=r),
                        "plain_partials_ms": lambda t: in_module.partials_plain(t),
                        "plain_apply_ms": lambda t, r=relu: in_module.apply_plain(
                            t, gathered, relu=r),
                        "library_partials_ms": lambda t: torch.var_mean(
                            t, dim=(2, 3), correction=0),
                        "library_apply_ms": lambda t: F.batch_norm(
                            t.view(1, b * c, hi - lo, w), mean, var, training=False),
                        "whole_kernel_ms": lambda t, r=relu: fused_instance_norm(x, relu=r),
                        "whole_library_ms": lambda t: F.instance_norm(x),
                    }, x0, flush, reps=SP_IN_REPS))
                    band_bytes = x0.numel() * x0.element_size()
                    case["partials_bound_ms"] = ((band_bytes + (b * c + 1) * 8)
                                                 / HBM_BYTES_PER_S * 1e3)
                    case["apply_bound_ms"] = ((2 * band_bytes + gathered.numel() * 4)
                                              / HBM_BYTES_PER_S * 1e3)
                    log(f"split IN bf16 S={spatial} B={b} [{c},{h},{w}] relu={int(relu)} "
                        f"band {hi - lo} rows {layout.variant}/{layout.planes_per_block}/"
                        f"{layout.cluster}: err {case['max_abs_err']:.3g}, vs whole "
                        f"{case['vs_whole_kernel']:.3g}; band ms partials "
                        f"{case['partials_ms']:.4f} + apply {case['apply_ms']:.4f} (bounds "
                        f"{case['partials_bound_ms']:.4f} + {case['apply_bound_ms']:.4f}); "
                        f"whole-plane kernel {case['whole_kernel_ms']:.4f}, F.instance_norm "
                        f"{case['whole_library_ms']:.4f}")
                cases.append(case)
                del got, again, plain, gathered
            del x, whole
    del flush
    torch.cuda.empty_cache()
    keys = ("partials_ms", "apply_ms", "plain_partials_ms", "plain_apply_ms",
            "library_partials_ms", "library_apply_ms", "whole_kernel_ms", "whole_library_ms",
            "partials_bound_ms", "apply_bound_ms")
    per_step = {}
    for spatial in SP_SPLITS:
        table = {(k["b"], k["c"], k["h"], k["w"], k["relu"]): k for k in cases
                 if k["dtype"] == "bfloat16" and k["spatial"] == spatial}
        per_step[spatial] = {key: sum(table[site][key] for site in SP_IN_SITES) for key in keys}
        t = per_step[spatial]
        log(f"  32 sites of a 2x2 step, bf16, one card's band at S={spatial}: partials "
            f"{t['partials_ms']:.4f} + apply {t['apply_ms']:.4f} = "
            f"{t['partials_ms'] + t['apply_ms']:.4f} ms (bounds {t['partials_bound_ms']:.4f} + "
            f"{t['apply_bound_ms']:.4f}; plain {t['plain_partials_ms']:.4f} + "
            f"{t['plain_apply_ms']:.4f}; var_mean + batch_norm {t['library_partials_ms']:.4f} + "
            f"{t['library_apply_ms']:.4f}); whole sites: kernel {t['whole_kernel_ms']:.4f}, "
            f"F.instance_norm {t['whole_library_ms']:.4f}")
    return {"cases": cases, "per_step_bf16": per_step,
            "max_abs_err_f32": max(k["max_abs_err"] for k in cases if k["dtype"] == "float32"),
            "max_abs_err_bf16": max(k["max_abs_err"] for k in cases
                                    if k["dtype"] == "bfloat16")}


def _banded_steps(torch) -> dict:
    """19b: the fused step on the spatial path with a world of one card
    over NCCL, whose spatial group holds that card alone (every conv, FIR
    and pad through ``halo.window``, every instance norm the split form
    with a one-rank all-gather), at phase 11's config in float32 (TF32
    off, deterministic kernels), SP_STEPS steps against the same steps
    without a group, each from the same state, with the no-group step's
    ReLU / LeakyReLU pattern pinned (the banded convs run on padded rows,
    which cuDNN sums in another order; ``ops/activations.py``); its
    launches."""
    import torch.distributed as dist

    from one_to_many_gan_torch import train
    from one_to_many_gan_torch.core.train_step import (
        Batches,
        draw_step,
        make_train_step,
        synthetic_batch,
    )
    from one_to_many_gan_torch.device import use_deterministic_kernels
    from one_to_many_gan_torch.migrate import from_reference_checkpoint, to_reference_checkpoint
    from one_to_many_gan_torch.ops import activations
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd
    from one_to_many_gan_torch.ops.cuda import instance_norm as in_module
    from one_to_many_gan_torch.parallel import distributed, halo

    config = d_phase_config("float32", D_BATCH, path_interval=G_INTERVAL)
    lr = config["optimisation"]["learning_rate"]
    counters = (warp, warp_bwd, fused_instance_norm, in_module.instance_norm_partials,
                in_module.instance_norm_apply)
    group = distributed.ensure_initialized(
        "cuda", rank=0, world_size=1,
        init_method=f"tcp://127.0.0.1:{distributed._free_port()}")
    group.spatial = halo.Spatial(1, 0, [0])
    try:
        with _determinism_restored(torch):
            use_deterministic_kernels()
            models, state, gen = train.setup(config, seed=0, ada_p=D_ADA_P, device="cuda")
            step_fn = make_train_step(config, models)
            g_models, g_state, _ = train.setup(config, seed=1, ada_p=D_ADA_P, device="cuda")
            g_step_fn = make_train_step(config, g_models, group)
            refs = []
            for _ in range(SP_STEPS):
                start = to_reference_checkpoint(state)
                batches = Batches(*(synthetic_batch(gen, D_BATCH, (D_SIZE, D_SIZE), 1)
                                    for _ in range(4)))
                draws = draw_step(gen, config, models)
                with activations.record() as kinks:
                    state, metrics = step_fn(state, batches, draws)
                refs.append((start, batches, draws, _snapshot_step(torch, state, metrics, 1),
                             kinks.masks))
            for c in counters:  # the main path of this phase: the banded steps
                c.launches = 0
            errs, launches, step_ms, flips = [], [], [], []
            for k, (start, batches, draws, want, masks) in enumerate(refs):
                g_state = from_reference_checkpoint(start, g_state, step=k)
                c0 = [c.launches for c in counters]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with activations.pin(masks) as pinned:
                    g_state, g_metrics = g_step_fn(g_state, batches, draws)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                check(len(pinned.flips) == len(masks), "the banded step ran other activations")
                flips.append([pinned.n_flips(), sum(m.numel() for m in masks)])
                launches.append(_phase_counts(counters, c0))
                errs.append(compare_steps(torch, _snapshot_step(torch, g_state, g_metrics, 1),
                                          want, lr, first=k == 0, grad_rtol=SP_GRAD_RTOL,
                                          label=f"banded step on one card, step {k}"))
            total = dict(zip(("warp_fwd", "warp_bwd", "instance_norm", "split_partials",
                              "split_apply"), (c.launches for c in counters), strict=True))
            del refs, models, state, step_fn, g_models, g_state, g_step_fn
            torch.cuda.empty_cache()
        want = [G_WARPS_PER_STEP, G_WARP_BWDS_PER_STEP, 0, G_IN_PER_STEP, G_IN_PER_STEP]
        check(all(c == want for c in launches), f"banded steps launched {launches} (want {want})")
    finally:
        group.close()
        dist.destroy_process_group()
    worst = {key: max(e[key] for e in errs) for key in errs[0] if key != "grad_worst"}
    worst["held_share"] = min(e["held_share"] for e in errs)
    worst["grad_worst"] = [e["grad_worst"] for e in errs]
    log(f"banded fused step, a spatial group of one card ({D_SIZE}x{D_SIZE}, batch {D_BATCH}, "
        f"float32, {SP_STEPS} steps against no group): metrics {worst['metric_rel']:.3g} "
        f"relative, gradients {worst['grad_rel']:.3g} of each leaf's largest entry (worst "
        f"{worst['grad_worst']}; limit {SP_GRAD_RTOL}), parameters "
        f"{worst['param_err_held']:.3g} where held ({worst['held_share']:.4f}), its kinks "
        f"pinned (flips, inputs per step {flips}); step ms (pinned) "
        f"{[round(t, 2) for t in step_ms]}; launches {total}")
    return {"launches": total, "per_step": launches, "errors": errs, "step_ms": step_ms,
            "flips": flips}


def phase_split_norm(torch) -> dict:
    """19. The split instance norm on one card (19a), and the spatial path
    that launches it (19b)."""
    out = {"sites": _split_sites(torch), "steps": _banded_steps(torch)}
    log("phase 19 ok")
    return out


# ---------------------------------------------------------------- phase 20


@contextlib.contextmanager
def _timed_calls(module, names: tuple, times: dict):
    """Replace ``module.<name>`` for each of ``names`` by a wrapper that
    appends each call's wall seconds to ``times[name]``; restored after."""
    saved = {name: getattr(module, name) for name in names}

    def timed(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = saved[name](*args, **kwargs)
            times.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    for name in names:
        setattr(module, name, timed(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def phase_inception(torch) -> dict:
    """20. Evaluation with InceptionV3: the validation checkpoint at CONFIG
    under ``require_inception_fid`` with weights given through
    ``OTM_INCEPTION_WEIGHTS``; the extractor's features on the card against
    the CPU, its rate, the resize's time and a trace of one call."""
    import re
    import tempfile

    from PIL import Image

    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.core import evaluation
    from one_to_many_gan_torch.core.state import Models, init_train_state
    from one_to_many_gan_torch.data import BatchIterator, synthetic_images
    from one_to_many_gan_torch import metrics
    from one_to_many_gan_torch.metrics import fid, inception, inception_v3
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm
    from one_to_many_gan_torch.ops.resample import pil_bicubic_resize
    from one_to_many_gan_torch.utils import profiling

    config = load_config(CONFIG)
    h, w = config["data"]["image_size"]
    batch = config["evaluation"]["inference_batch_size"]
    state_dict = inception_v3.random_state_dict(0)
    prints = synthetic_images(I_EVAL_IMAGES, (h, w), seed=0)
    reals = synthetic_images(I_EVAL_IMAGES, (h, w), seed=1)
    saved_env = os.environ.get(inception.WEIGHTS_ENV)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_inception_") as tmp:
        weights = Path(tmp) / "inception_v3_random.pt"
        torch.save({k: torch.from_numpy(v) for k, v in state_dict.items()}, weights)
        os.environ[inception.WEIGHTS_ENV] = str(weights)
        config["training"].update(checkpoint_directory=Path(tmp), training_run="inception")
        config["evaluation"].update(n_evaluation_images=I_EVAL_IMAGES)
        config["tpu"]["require_inception_fid"] = True
        models = Models(config, device="cuda", seed=0)
        state = init_train_state(config, models, seed=0)
        val_iter = BatchIterator(prints, batch, shuffle=False, flip_prob=0.5, seed=0)
        gen = torch.Generator("cuda").manual_seed(7_000_000)
        times: dict = {}
        fused_instance_norm.launches = 0
        t0 = time.perf_counter()
        try:
            with _timed_calls(metrics, ("default_extractor",), times), \
                    _timed_calls(fid, ("frechet_distance", "kernel_distance"), times):
                fid_score, kid_score = evaluation.val_checkpoint(
                    0, config, models, state, val_iter, gen, real_images=reals)
        finally:
            if saved_env is None:
                os.environ.pop(inception.WEIGHTS_ENV, None)
            else:
                os.environ[inception.WEIGHTS_ENV] = saved_env
        val_s = time.perf_counter() - t0
        in_launches = fused_instance_norm.launches
        log_lines = (Path(tmp) / "inception" / "log").read_text().splitlines()
        record = json.loads((Path(tmp) / "inception" / "metrics.jsonl").read_text()
                            .splitlines()[-1])
        generated = np.stack([np.asarray(Image.open(p)) for p in sorted(
            (Path(tmp) / "inception" / "val").glob("*.png"),
            key=lambda p: int(p.stem))])[..., None]
    check(len(log_lines) == 1 and re.fullmatch(
        r"Step 0 \| fid: \S+, kid: \S+ \[inception_v3_pool3\]", log_lines[0]) is not None,
        f"the validation log {log_lines}")
    check(record["fid_extractor"] == "inception_v3_pool3"
          and np.isfinite([record["fid"], record["kid"]]).all(),
          f"metrics.jsonl's record {record}")
    check(in_launches == 9 * (I_EVAL_IMAGES // batch),
          f"{in_launches} instance-norm launches for {I_EVAL_IMAGES // batch} encodes")
    check(generated.shape == (I_EVAL_IMAGES, h, w, 1), f"validation images {generated.shape}")

    model = inception_v3.from_torchvision_state(state_dict)
    card = inception_v3.make_extractor(model, batch=I_BATCH, device="cuda")
    cpu = inception_v3.make_extractor(
        inception_v3.from_torchvision_state(state_dict), batch=I_BATCH, device="cpu")
    got = card(generated[:I_CARD_CPU_IMAGES])
    want = cpu(generated[:I_CARD_CPU_IMAGES])
    scale = float(np.abs(want).mean())
    err = float(np.abs(got - want).max())
    check(got.shape == (I_CARD_CPU_IMAGES, 2048) and np.isfinite(got).all(),
          f"features {got.shape}")
    check(np.allclose(got, want, rtol=INCEPTION_CARD_CPU_TOL,
                      atol=INCEPTION_CARD_CPU_TOL * scale),
          f"Inception on the card against the CPU: max |delta| {err:.3e}, mean |feature| "
          f"{scale:.3e}")
    rate_images = np.concatenate([generated, reals])[:I_RATE_IMAGES]
    card(rate_images)  # warm: cuDNN's algorithm choice at batch 32
    t0 = time.perf_counter()
    card(rate_images)
    rate = I_RATE_IMAGES / (time.perf_counter() - t0)
    x = torch.from_numpy(generated[:I_BATCH]).cuda().permute(0, 3, 1, 2).float()
    resize_ms = _cuda_ms(torch, lambda: pil_bicubic_resize(x, 299, 299), 20)
    with profiling.trace(ROOT / "chiprun_out" / "inception_trace", device="cuda") as path:
        card(generated[:I_BATCH])
    events = json.loads(path.read_text())["traceEvents"]
    device_events = [e for e in events if e.get("cat") == "kernel"]
    check(path.is_file() and device_events, f"the trace {path} holds no device kernels")
    out = {
        "val_checkpoint_s": val_s, "fid": fid_score, "kid": kid_score,
        "extractor_load_s": sum(times["default_extractor"]),
        "fid_ms": 1e3 * sum(times["frechet_distance"]),
        "kid_ms": 1e3 * sum(times["kernel_distance"]),
        "images_scored": {"generated": I_EVAL_IMAGES, "reals": I_EVAL_IMAGES},
        "in_launches": in_launches, "card_vs_cpu_max_abs": err,
        "card_vs_cpu_max_rel": float(np.max(np.abs(got - want) / (np.abs(want) + scale))),
        "mean_abs_feature": scale, "images_per_s_batch32": rate,
        "resize_ms_batch32": resize_ms, "trace": str(path.relative_to(ROOT)),
        "trace_kernels": len(device_events), "phase_s": time.perf_counter() - t_phase,
    }
    log(f"phase 20: evaluation at {CONFIG.name} under require_inception_fid, "
        f"{I_EVAL_IMAGES} generated against {I_EVAL_IMAGES} reals: {log_lines[0]} "
        f"({val_s:.2f} s; weights read and folded {out['extractor_load_s']:.2f} s, FID "
        f"{out['fid_ms']:.1f} ms, KID {out['kid_ms']:.1f} ms; {in_launches} IN launches)")
    log(f"  the extractor at batch {I_BATCH}: {rate:.1f} images/s over {I_RATE_IMAGES} images "
        f"({h}x{w}, 1 channel); the resize of {I_BATCH} images to 299x299 {resize_ms:.4f} ms; "
        f"card against CPU on {I_CARD_CPU_IMAGES} images: max |delta| {err:.3e} (mean |feature| "
        f"{scale:.3e}, limit rtol {INCEPTION_CARD_CPU_TOL} atol {INCEPTION_CARD_CPU_TOL} x mean)")
    log(f"  trace of one extractor call: {out['trace']} ({len(device_events)} device kernels)")
    log("phase 20 ok")
    return out


# ---------------------------------------------------------------- phase 21


def up_errors(torch, got, x) -> dict:
    """``got`` = the kernel's ``upsample2x(x)`` against the plain version
    in float32 and in ``x``'s dtype (TF32 off): the largest excess over the
    float32 bound (at most 0 when held) and the error and limit against the
    plain version in ``x``'s dtype (module constants UP_TOL*)."""
    from one_to_many_gan_torch.ops.resample import upsample2x_plain

    scale = x.float().abs().max().item()
    with _cudnn_flags(torch, allow_tf32=False):
        y32 = upsample2x_plain(x.float())
        own = y32 if x.dtype == torch.float32 else upsample2x_plain(x).float()
    limit32 = UP_TOL32 * scale + (0 if x.dtype == torch.float32 else 2**-8 * y32.abs())
    dtype_name = str(x.dtype).removeprefix("torch.")
    return {"excess_vs_float32": ((got.float() - y32).abs() - limit32).max().item(),
            "max_abs_err": (got.float() - own).abs().max().item(),
            "tol": UP_TOL[dtype_name] * scale}


def phase_upsample(torch, config) -> dict:
    """The upsample kernel at the serving sites against its plain version
    (the library path it replaced), timed beside it and its bound; the
    launches of one bfloat16 engine call of UP_REQUESTS requests at n =
    UP_N."""
    from one_to_many_gan_torch.ops.cuda import upsample as up
    from one_to_many_gan_torch.ops.resample import upsample2x_plain
    from one_to_many_gan_torch.serve import InferenceEngine

    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for dtype_name in ("bfloat16", "float32"):
        for site, shape in UP_SITES.items():
            x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(
                getattr(torch, dtype_name))
            got = up.upsample2x(x)
            same = torch.equal(got, up.upsample2x(x))
            errs = up_errors(torch, got, x)
            err, tol = errs["max_abs_err"], errs["tol"]
            del got
            case = {"site": site, "shape": list(shape), "dtype": dtype_name, **errs,
                    "repeat_bitwise_equal": same,
                    **time_cold_ms(torch, {"kernel_ms": up.upsample2x,
                                           "plain_ms": upsample2x_plain}, x, flush, UP_REPS),
                    "bound_ms": up.bound_bytes(shape, x.element_size()) / HBM_BYTES_PER_S * 1e3}
            # the plain version is the library path the kernel replaced: per
            # axis a replication pad and cuDNN's grouped transposed conv
            case["library_ms"] = case["plain_ms"]
            case["of_bound"] = case["bound_ms"] / case["kernel_ms"]
            cases.append(case)
            log(f"upsample {dtype_name:8s} {site} {list(shape)}: max_abs_err {err:.3g} (tol "
                f"{tol:.3g}), excess over the float32 bound {errs['excess_vs_float32']:.3g}; "
                f"kernel {case['kernel_ms']:.4f} ms, plain = library {case['plain_ms']:.4f} ms, "
                f"bound {case['bound_ms']:.4f} ms: {case['of_bound']:.1%} of the bound")
            check(err <= tol and errs["excess_vs_float32"] <= 0,
                  f"the upsample kernel disagrees with its plain version: {case}")
            check(same, f"two upsample launches differ: {case}")
            del x
    del flush
    torch.cuda.empty_cache()
    sums = {dtype_name: {k: sum(c[k] for c in cases if c["dtype"] == dtype_name)
                         for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
            for dtype_name in UP_TOL}
    for dtype_name, t in sums.items():
        log(f"upsample per decode chunk of 86 ({dtype_name}, 2 sites): " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()))
    # one engine call as the batcher makes it: 4 requests, each n = 64
    cfg = copy.deepcopy(config)
    cfg["tpu"]["precision"] = "bfloat16"
    engine = InferenceEngine(cfg, buckets=BUCKETS)
    h, w = cfg["data"]["image_size"]
    sources = [_source_image(20 + i, h, w) for i in range(UP_REQUESTS)]
    launches0, calls0 = up.upsample2x.launches, engine.device_calls
    outs = engine.generate_batch(sources, [UP_N] * UP_REQUESTS, list(range(UP_REQUESTS)),
                                 [1.0] * UP_REQUESTS)
    launches, calls = up.upsample2x.launches - launches0, engine.device_calls - calls0
    for out in outs:
        _check_out(out, UP_N, h, w)
    del engine
    torch.cuda.empty_cache()
    log(f"upsample launches in one bfloat16 engine call of {UP_REQUESTS} requests at "
        f"n={UP_N}: {launches} in {calls} call(s) (want {UP_LAUNCHES_PER_CALL})")
    check(calls == 1 and launches == UP_LAUNCHES_PER_CALL,
          f"{launches} upsample launches in {calls} engine calls")
    log("phase 21 ok")
    return {"cases": cases, "per_chunk": sums, "call_launches": launches}


# ---------------------------------------------------------------- phase 18


@contextlib.contextmanager
def int8_sites(seen: list):
    """Record the inputs of every int8 site of the decoder
    (``ops/modulated.py``'s call of ``modulated_int8_conv``), in call order,
    as dicts of its arguments (``x`` unpadded, ``s``, ``w_q``, ``w_scale``,
    ``d``, ``padding``, ``pad_mode``, ``dtype``), and run the site."""
    from one_to_many_gan_torch.ops import modulated

    real = modulated.modulated_int8_conv

    def tap(x, s, w_q, w_scale, d, **kw):
        seen.append({"x": x, "s": s, "w_q": w_q, "w_scale": w_scale, "d": d, **kw})
        return real(x, s, w_q, w_scale, d, **kw)

    modulated.modulated_int8_conv = tap
    try:
        yield seen
    finally:
        modulated.modulated_int8_conv = real


def site_padded(site: dict):
    """The modulated, padded tensor that an int8 site quantises."""
    from one_to_many_gan_torch.ops.cuda.int8_conv import modulate_plain
    from one_to_many_gan_torch.ops.equalized import pad2d

    return pad2d(modulate_plain(site["x"], site["s"], site["dtype"]), site["padding"],
                 site["pad_mode"])


def int8_run(site: dict, plain: bool = False):
    """The int8 site through the kernels (or, ``plain``, their plain
    versions): ``modulated_int8_conv`` of its recorded arguments."""
    from one_to_many_gan_torch.ops.cuda import int8_conv

    fn = int8_conv.modulated_int8_conv_plain if plain else int8_conv.modulated_int8_conv
    return fn(site["x"], site["s"], site["w_q"], site["w_scale"], site["d"],
              padding=site["padding"], pad_mode=site["pad_mode"], dtype=site["dtype"])


def random_sites(torch, gen, b: int, c: int, h: int, w: int, o: int) -> list:
    """Int8 sites of shape (B, C, H, W) -> O from ``gen``: float32 and
    bfloat16, zero and reflection padding, and (where H, W >= 3) the
    unmodulated, unpadded float32 case of ``ops/quantize.int8_conv``."""
    from one_to_many_gan_torch.ops.quantize import quantize_weight

    x = torch.randn((b, c, h, w), generator=gen, device="cuda")
    s = torch.randn((b, c), generator=gen, device="cuda")
    d = torch.rand((b, o), generator=gen, device="cuda") + 0.5
    w_q, w_scale = quantize_weight(torch.randn((o, c, 3, 3), generator=gen, device="cuda") * 0.05)
    sites = []
    for dtype in (torch.float32, torch.bfloat16):
        for pad_mode in ("zero", "reflect"):
            sites.append({"x": x.to(dtype), "s": s, "w_q": w_q, "w_scale": w_scale, "d": d,
                          "padding": 1, "pad_mode": pad_mode, "dtype": dtype})
        if min(h, w) >= 3:
            sites.append({"x": x.to(dtype), "s": None, "w_q": w_q, "w_scale": w_scale, "d": None,
                          "padding": 0, "pad_mode": "zero", "dtype": torch.float32})
    return sites


def site_on(site: dict, device) -> dict:
    """The site's tensors on ``device``."""
    return {k: v.to(device) if hasattr(v, "device") else v for k, v in site.items()}


def int8_library(torch, site: dict):
    """The yardstick, never on the path: the site as plain torch passes
    (modulate, pad, quantise, channels-last codes), im2col (the 9 taps
    materialised) and ``torch._int_mm``, then the rescale, the cast and
    the demodulation."""
    from one_to_many_gan_torch.ops.quantize import quantize_activations

    xq, xs = quantize_activations(site_padded(site))
    xq = xq.permute(0, 2, 3, 1).contiguous()
    wq = site["w_q"].permute(0, 2, 3, 1).contiguous()
    b, hp, wp, c = xq.shape
    o, kh, kw, _ = wq.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    cols = xq.unfold(1, kh, 1).unfold(2, kw, 1).permute(0, 1, 2, 4, 5, 3)
    y32 = torch._int_mm(cols.reshape(b * ho * wo, kh * kw * c), wq.reshape(o, -1).t())
    y = y32.view(b, ho, wo, o).permute(0, 3, 1, 2).to(torch.float32)
    y = (y * (xs[:, None, None, None] * site["w_scale"][None, :, None, None])).to(site["dtype"])
    return y * site["d"][:, :, None, None].to(site["dtype"])


def _bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def int8_bound_ms(xq_shape, wq_shape) -> tuple[float, str]:
    """The least time of an int8 conv of codes alone: the larger of its
    2*M*N*K operations at the dense int8 rate and its bytes (padded
    channels-last codes and scales read once, the float32 output written
    once) at the memory rate. -> (ms, "operations" or "bytes")."""
    b, hp, wp, c = xq_shape
    o, kh, kw, _ = wq_shape
    m = b * (hp - kh + 1) * (wp - kw + 1)
    return _bound(2.0 * m * o * kh * kw * c,
                  b * hp * wp * c + o * kh * kw * c + 4 * (b + o) + 4 * m * o)


def int8_fused_bound_ms(site: dict, x_reads: int = 2) -> tuple[float, str]:
    """The least time of one int8 site as the fused kernels compute it:
    ``x`` read ``x_reads`` times (the pre-pass and the conv), the style,
    the weight codes, the scales and the demodulation read once, the
    output written once in the activation dtype; 2*M*N*K operations at the
    dense int8 rate."""
    x, w_q = site["x"], site["w_q"]
    b, c, h, w = x.shape
    o = w_q.shape[0]
    m = b * (h + 2 * site["padding"] - 2) * (w + 2 * site["padding"] - 2)
    out = m * o * site["dtype"].itemsize
    nbytes = x_reads * x.numel() * x.element_size() + 4 * b * c + w_q.numel() + 4 * (b + o) \
        + 4 * b * o + out
    return _bound(2.0 * m * o * 9 * c, nbytes)


def _site_label(site: dict) -> str:
    return (f"x{list(site['x'].shape)} {str(site['x'].dtype)[6:]}->{str(site['dtype'])[6:]} "
            f"o{site['w_q'].shape[0]} pad {site['padding']} {site['pad_mode']}"
            f"{'' if site['s'] is not None else ' unmodulated'}")


def phase_int8_kernel(torch, config, source: np.ndarray) -> dict:
    """18a: the int8 pre-pass and fused conv kernels against their plain
    versions at the 10 sites of an n = 64 decode in float32 and bfloat16,
    and at ragged shapes; times per site type."""
    import torch.nn.functional as F

    from one_to_many_gan_torch.core import Models, make_inference_fns
    from one_to_many_gan_torch.ops.cuda.int8_conv import (
        fused_int8_conv,
        fused_int8_conv_plain,
        int8_prepass,
        int8_prepass_plain,
    )
    from one_to_many_gan_torch.ops.quantize import quantize_activations

    run = int8_run
    plain = functools.partial(int8_run, plain=True)

    def conv_only(site, x_scale):
        return fused_int8_conv(site["x"], site["s"], x_scale, site["w_q"], site["w_scale"],
                               site["d"], padding=site["padding"], pad_mode=site["pad_mode"],
                               dtype=site["dtype"])

    def conv_plain(site, x_scale):
        return fused_int8_conv_plain(site["x"], site["s"], x_scale, site["w_q"], site["w_scale"],
                                     site["d"], padding=site["padding"],
                                     pad_mode=site["pad_mode"], dtype=site["dtype"])

    def check_site(site: dict, label: str) -> dict:
        """Both kernels against their plain versions, and a second launch."""
        xs = int8_prepass(site["x"], site["s"], site["dtype"])
        xs_plain = int8_prepass_plain(site["x"], site["s"], site["dtype"])
        got, again = conv_only(site, xs), run(site)
        want = plain(site)
        torch.cuda.synchronize()
        res = {"label": label, "prepass_bitwise": torch.equal(xs, xs_plain),
               "prepass_max_abs_err": (xs - xs_plain).abs().max().item(),
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "bitwise": torch.equal(got, want), "repeat_bitwise_equal": torch.equal(got, again)}
        check(res["prepass_bitwise"] and res["bitwise"] and res["repeat_bitwise_equal"],
              f"int8 kernels differ from their plain versions or themselves: {res}")
        return res

    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    n = BUCKETS[-1]
    sites, types = [], {}
    for dtype_name in ("float32", "bfloat16"):
        cfg = copy.deepcopy(config)
        cfg["tpu"]["precision"] = dtype_name
        models = Models(cfg, device="cuda", seed=0, int8_decode=True)
        seen: list = []
        with torch.inference_mode(), int8_sites(seen):
            make_inference_fns(models)[2](*_fixed_inputs(torch, source, models.w_dim, n))
        torch.cuda.synchronize()
        check(len(seen) == INT8_SITES_PER_DECODE,
              f"{len(seen)} int8 sites in one n={n} decode, want {INT8_SITES_PER_DECODE}")
        with torch.inference_mode():
            for i in range(len(seen)):
                site = seen[i]
                seen[i] = None
                res = check_site(site, f"{dtype_name} site {i}")
                res.update({"dtype": dtype_name, "site": i, "x": list(site["x"].shape),
                            "w": list(site["w_q"].shape), "pad_mode": site["pad_mode"]})
                sites.append(res)
                kind = next((k for k, v in INT8_SITE_TYPES.items() if v == i), None)
                if kind is not None:
                    t = types.setdefault(kind, {"x": list(site["x"].shape),
                                                "w": list(site["w_q"].shape),
                                                "pad_mode": site["pad_mode"]})
                    xs = int8_prepass(site["x"], site["s"], site["dtype"])
                    ms = time_cold_ms(torch, {
                        "kernel_ms": run,
                        "prepass_ms": lambda a: int8_prepass(a["x"], a["s"], a["dtype"]),
                        "conv_ms": lambda a: conv_only(a, xs),
                        "plain_ms": plain,
                        "prepass_plain_ms": lambda a: int8_prepass_plain(a["x"], a["s"],
                                                                         a["dtype"]),
                        "conv_plain_ms": lambda a: conv_plain(a, xs),
                        "library_ms": lambda a: int8_library(torch, a),
                    }, site, flush, INT8_TIMING_REPS)
                    t[dtype_name] = ms
                    t[dtype_name]["library_bitwise"] = torch.equal(int8_library(torch, site),
                                                                   plain(site))
                    t[dtype_name]["bound_ms"], t[dtype_name]["bound_by"] = \
                        int8_fused_bound_ms(site)
                    t[dtype_name]["conv_bound_ms"], t[dtype_name]["conv_bound_by"] = \
                        int8_fused_bound_ms(site, x_reads=1)
                    t[dtype_name]["prepass_bound_ms"] = (
                        site["x"].numel() * site["x"].element_size()
                        + 4 * site["x"].shape[0] * (site["x"].shape[1] + 1)) \
                        / HBM_BYTES_PER_S * 1e3
                    if dtype_name == "float32":
                        xq = quantize_activations(site_padded(site))[0]
                        wq = site["w_q"].permute(0, 2, 3, 1)
                        t["codes_bound_ms"], t["codes_bound_by"] = int8_bound_ms(
                            tuple(xq.permute(0, 2, 3, 1).shape), tuple(wq.shape))
                        xb = xq.to(torch.bfloat16)
                        wb = site["w_q"].to(torch.bfloat16)
                        t["bf16_conv_ms"] = time_cold_ms(
                            torch, {"c": lambda a: F.conv2d(a, wb)}, xb, flush,
                            INT8_TIMING_REPS)["c"]
                        del xq, wq, xb, wb
                del site
        del models, seen
        torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(18)
    ragged = []
    with torch.inference_mode():
        for shape in INT8_RAGGED:
            for site in random_sites(torch, gen, *shape):
                ragged.append(check_site(site, _site_label(site)))
    del flush
    torch.cuda.empty_cache()
    counts = {"resnet": INT8_SITES_PER_DECODE - 2, "up1": 1, "up2": 1}
    per_decode = {}
    for dtype_name in ("float32", "bfloat16"):
        per_decode[dtype_name] = {
            key: sum(counts[k] * types[k][dtype_name][key] for k in counts)
            for key in ("kernel_ms", "prepass_ms", "conv_ms", "plain_ms", "prepass_plain_ms",
                        "conv_plain_ms", "library_ms", "bound_ms", "conv_bound_ms",
                        "prepass_bound_ms")}
        for bound in ("bound", "conv_bound"):
            ops_share = sum(counts[k] * types[k][dtype_name][f"{bound}_ms"] for k in counts
                            if types[k][dtype_name][f"{bound}_by"] == "operations") \
                / per_decode[dtype_name][f"{bound}_ms"]
            per_decode[dtype_name][f"{bound}_by"] = "operations" if ops_share >= 0.5 else "bytes"
    per_decode["codes_bound_ms"] = sum(counts[k] * types[k]["codes_bound_ms"] for k in counts)
    per_decode["bf16_conv_ms"] = sum(counts[k] * types[k]["bf16_conv_ms"] for k in counts)
    for kind, t in types.items():
        for dtype_name in ("float32", "bfloat16"):
            m = t[dtype_name]
            log(f"int8 {kind} {dtype_name} x{t['x']} w{t['w']} {t['pad_mode']}: kernels "
                f"{m['kernel_ms']:.4f} ms (pre-pass {m['prepass_ms']:.4f}, conv "
                f"{m['conv_ms']:.4f}), plain {m['plain_ms']:.4f}, torch passes + im2col + "
                f"_int_mm {m['library_ms']:.4f} (bitwise {m['library_bitwise']}), bound "
                f"{m['bound_ms']:.4f} ({m['bound_by']}); kernels/bound "
                f"{m['kernel_ms'] / m['bound_ms']:.2f}")
        log(f"int8 {kind}: codes-only bound {t['codes_bound_ms']:.4f} ({t['codes_bound_by']}), "
            f"bf16 cuDNN conv of the codes (not the same function) {t['bf16_conv_ms']:.4f} ms")
    for key, v in per_decode.items():
        log(f"int8 per n=64 decode (10 sites) {key}: " + (", ".join(
            f"{k} {x:.4f}" if isinstance(x, float) else f"{k} {x}" for k, x in v.items())
            if isinstance(v, dict) else f"{v:.4f} ms"))
    log(f"phase 18a ok: {len(sites)} decode sites (f32 and bf16) and {len(ragged)} ragged sites, "
        "pre-pass and fused conv bitwise equal to their plain versions, repeats bitwise equal")
    return {"sites": sites, "types": types, "per_decode": per_decode, "ragged": ragged}


def _serve_requests(torch, engine, body: bytes, h: int, w: int) -> tuple[dict, dict]:
    """n = 8, 32, 64 over HTTP (npy, REPS each, no coalescing) and
    ``/healthz``: -> ({n: latencies ms}, health)."""
    from one_to_many_gan_torch.serve import make_server

    server = make_server(engine, "127.0.0.1", 0, max_batch=1)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        lat = {}
        for n in BUCKETS:
            lat[n] = []
            for rep in range(REPS):
                payload, ms = _post(port, body, n=n, seed=rep, format="npy")
                _check_out(_npy(payload), n, h, w)
                lat[n].append(ms)
        health = _get(port, "/healthz")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return lat, health


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(4.0 / max(mse, 1e-12))


def phase_int8_serve(torch, config, source: np.ndarray) -> dict:
    """18b: int8 engines at CONFIG in float32 and bfloat16 over HTTP beside
    the float engines; the launches of the int8 path; images against the
    float32 engine's. 18c: the int8 engine on the card against the CPU."""
    from one_to_many_gan_torch.core import Models, make_inference_fns
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, fused_int8_conv, int8_prepass
    from one_to_many_gan_torch.serve import InferenceEngine

    h, w = config["data"]["image_size"]
    body = _png(source)
    engines = {}
    for precision in ("float32", "bfloat16"):
        cfg = copy.deepcopy(config)
        cfg["tpu"]["precision"] = precision
        for int8 in (True, False):
            engine = InferenceEngine(cfg, buckets=BUCKETS, int8=int8)
            engine.warmup(batched=False)
            engines[precision + ("_int8" if int8 else "")] = engine
    # the main path: int8 requests over HTTP, the counts read around them
    int8_prepass.launches = fused_int8_conv.launches = fused_instance_norm.launches = 0
    for name in ("float32_int8", "bfloat16_int8"):
        engines[name].device_calls = 0
    latency, health = {}, {}
    for name in ("float32_int8", "bfloat16_int8"):
        latency[name], health[name] = _serve_requests(torch, engines[name], body, h, w)
    launches = {"int8_prepass": int8_prepass.launches, "int8_conv": fused_int8_conv.launches,
                "instance_norm": fused_instance_norm.launches}
    calls = sum(engines[k].device_calls for k in ("float32_int8", "bfloat16_int8"))
    for name in ("float32", "bfloat16"):
        latency[name], health[name] = _serve_requests(torch, engines[name], body, h, w)
    for name in ("int8_prepass", "int8_conv"):
        check(calls > 0 and launches[name] == INT8_SITES_PER_DECODE * calls,
              f"{name} launches {launches[name]} for {calls} device calls (want 10 a call)")
    check(launches["instance_norm"] == 9 * calls,
          f"IN launches {launches['instance_norm']} for {calls} device calls (want 9 a call)")
    for name in ("float32_int8", "bfloat16_int8"):
        check(health[name]["int8"] is True and health[name]["device"].startswith("cuda"),
              f"/healthz {health[name]}")
    for name in ("float32", "bfloat16"):
        check(health[name]["int8"] is False, f"/healthz {health[name]}")
    medians = {name: {n: statistics.median(t) for n, t in lat.items()}
               for name, lat in latency.items()}
    for name, med in medians.items():
        log(f"{name:14s} npy median ms " + ", ".join(f"n={n} {v:.2f}" for n, v in med.items()))
    # images against the float32 engine's
    want = engines["float32"].generate(source, BUCKETS[-1], seed=0)
    levels, psnr = {}, {}
    inputs = _fixed_inputs(torch, source, engines["float32"].models.w_dim, INT8_CPU_N)
    ref = make_inference_fns(engines["float32"].models)[2](*inputs).float().cpu().numpy()
    for name in ("float32_int8", "bfloat16_int8", "bfloat16"):
        got = engines[name].generate(source, BUCKETS[-1], seed=0)
        levels[name] = float(np.abs(got.astype(int) - want.astype(int)).mean())
        out = make_inference_fns(engines[name].models)[2](*inputs).float().cpu().numpy()
        psnr[name] = _psnr(out, ref)
    log("against the float32 engine (n=64, seed 0): mean |delta| uint8 levels "
        + ", ".join(f"{k} {v:.4f}" for k, v in levels.items()) + f" (limit {INT8_MEAN_LEVELS}); "
        "tanh PSNR dB " + ", ".join(f"{k} {v:.2f}" for k, v in psnr.items()))
    for name in ("float32_int8", "bfloat16_int8"):
        check(levels[name] < INT8_MEAN_LEVELS and psnr[name] > INT8_PSNR_FLOOR,
              f"{name} images {levels[name]} levels, {psnr[name]} dB from float32's")
    card_models = engines["float32_int8"].models
    del engines
    torch.cuda.empty_cache()
    log(f"phase 18b ok: int8 serving over HTTP, {calls} device calls with "
        f"{launches['int8_prepass']} pre-pass, {launches['int8_conv']} fused int8 conv and "
        f"{launches['instance_norm']} IN launches, /healthz int8 true")
    # 18c: the same int8 engine on the card and on the CPU, n = INT8_CPU_N
    from one_to_many_gan_torch.ops.quantize import quantize_activations

    cpu_models = Models(config, device="cpu", seed=0, int8_decode=True)
    outs, taps = {}, {}
    t0 = time.perf_counter()
    for where, models in (("card", card_models), ("cpu", cpu_models)):
        seen: list = []
        with int8_sites(seen):
            outs[where] = make_inference_fns(models)[2](*inputs).float().cpu().numpy()
        taps[where] = [site_on(site, "cpu") for site in seen]
        del seen
    cpu_s = time.perf_counter() - t0
    with torch.inference_mode():
        same = [torch.equal(int8_run(site_on(site, "cuda")).cpu(), int8_run(site))
                for site in taps["cpu"]]
    flips = [int((quantize_activations(site_padded(a))[0]
                  != quantize_activations(site_padded(b))[0]).sum())
             for a, b in zip(taps["card"], taps["cpu"], strict=True)]
    sizes = [site_padded(site).numel() for site in taps["card"]]
    del taps

    def u8(a):
        return np.clip((a + 1.0) * 127.5, 0, 255).astype(np.uint8).astype(int)

    cpu_levels = float(np.abs(u8(outs["card"]) - u8(outs["cpu"])).mean())
    cpu_psnr = _psnr(outs["card"], outs["cpu"])
    log(f"int8 card vs CPU (n={INT8_CPU_N}, float32, TF32 off): mean |delta| "
        f"{cpu_levels:.4f} uint8 levels (limit {INT8_MEAN_LEVELS}), tanh PSNR {cpu_psnr:.2f} dB "
        f"(floor {INT8_PSNR_FLOOR}); flipped codes per site {flips} of {sizes}; the card's "
        f"int8 conv on the CPU's inputs bitwise the CPU's at {sum(same)} of {len(same)} "
        f"sites; both passes {cpu_s:.1f} s")
    check(np.isfinite(outs["card"]).all() and outs["card"].shape == (INT8_CPU_N, h, w, 1),
          "int8 card output")
    check(all(same), f"the card's int8 conv differs from the CPU's on the same inputs: {same}")
    check(flips[0] <= INT8_FIRST_SITE_FLIPS * sizes[0],
          f"{flips[0]} of {sizes[0]} codes flipped at the first int8 site")
    check(cpu_levels < INT8_MEAN_LEVELS and cpu_psnr > INT8_PSNR_FLOOR,
          "the int8 engine on the card is further from the CPU's than int8 from float32")
    log("phase 18 ok")
    return {"latency_ms": latency, "median_ms": medians, "launches": launches,
            "device_calls": calls, "healthz": health, "mean_levels_vs_f32": levels,
            "psnr_vs_f32": psnr,
            "card_vs_cpu": {"mean_levels": cpu_levels, "psnr": cpu_psnr,
                            "flipped_codes": flips, "codes": sizes, "same_inputs_bitwise": same}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.device import set_cublas_workspace
    from one_to_many_gan_torch.ops.cuda import build

    set_cublas_workspace()  # phase 13 trains deterministically: before cuBLAS starts

    t_start = time.perf_counter()
    report = {"environment": phase_environment(torch, build)}
    report["kernels"] = phase_kernels(torch)
    config = load_config(CONFIG)
    h, w = config["data"]["image_size"]
    source = _source_image(0, h, w)
    report["serve"], engine = phase_serve(torch, config, source)
    report["card_vs_cpu"], card = phase_card_vs_cpu(torch, config, engine, source)
    report["profile_f32"] = phase_profile(torch, engine, source, "float32")
    del engine
    torch.cuda.empty_cache()
    report["bf16"], engine = phase_bf16(torch, config, source, card)
    report["profile_bf16"] = phase_profile(torch, engine, source, "bfloat16")
    del engine
    torch.cuda.empty_cache()
    report["upsample"] = phase_upsample(torch, config)
    report["warp"] = phase_warp(torch)
    report["d_phase"] = phase_d_phase(torch)
    torch.cuda.empty_cache()
    report["d_card_vs_cpu"] = phase_d_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    report["warp_bwd"] = phase_warp_bwd(torch)
    report["fused_step"] = phase_fused_step(torch)
    torch.cuda.empty_cache()
    report["g_card_vs_cpu"] = phase_g_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    report["deterministic"] = phase_deterministic(torch, report["fused_step"])
    torch.cuda.empty_cache()
    report["trainer"] = phase_trainer(torch, report["fused_step"])
    torch.cuda.empty_cache()
    report["production"] = phase_production(torch)
    torch.cuda.empty_cache()
    report["slice7"] = phase_slice7(torch, report["production"])
    torch.cuda.empty_cache()
    report["data_parallel"] = phase_data_parallel(torch)
    torch.cuda.empty_cache()
    report["int8_kernel"] = phase_int8_kernel(torch, config, source)
    report["int8_serve"] = phase_int8_serve(torch, config, source)
    torch.cuda.empty_cache()
    report["split_norm"] = phase_split_norm(torch)
    torch.cuda.empty_cache()
    report["inception"] = phase_inception(torch)

    fused = report["fused_step"]["launches"]
    enc = report["kernels"]["per_encode"]["float32_b1"]
    f32_cases = [k for k in report["kernels"]["cases"] if k["dtype"] == "float32"]
    trained = report["trainer"]["a"]["launches"]
    prod = report["production"]["run"]["launches"]
    slice7 = report["slice7"]
    # phase 16's main paths, each counted from 0 around its run
    s7 = {"supersampled steps (phase 16c)": slice7["ss_steps"]["launches"],
          "remat steps (phase 16d)": slice7["remat"]["launches"],
          "data-parallel steps, world 1 (phase 17)": report["data_parallel"]["launches"]}
    if slice7["native"]["built"]:
        s7["native-loader Trainer (phase 16e)"] = slice7["native"]["launches"]
    in_by_phase = {"serve (phase 3)": report["serve"]["launches"],
                   "D phase (phase 8)": report["d_phase"]["in_launches"],
                   "fused step (phase 11)": fused["instance_norm"],
                   "Trainer (phase 14)": trained["instance_norm"],
                   "production Trainer (phase 15)": prod["instance_norm"],
                   **{k: v["instance_norm"] for k, v in s7.items()},
                   "int8 serving (phase 18b)": report["int8_serve"]["launches"]["instance_norm"],
                   "evaluation with Inception (phase 20)": report["inception"]["in_launches"]}
    kernels = [{
        "name": "instance_norm",
        "route": "cuda",
        "source": "one_to_many_gan_torch/csrc/instance_norm.cu",
        "replaces": IN_REPLACES,
        "launches": sum(in_by_phase.values()),
        "max_abs_err": max(k["max_abs_err"] for k in f32_cases),
        "ms": enc["kernel_ms"],
        "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"],
        "bound_by": "bytes",
        "library_ms": enc["library_ms"],
        "per": "the 9 instance norms of one encode at B=1, float32, cold L2",
        "per_d_step_bfloat16": report["kernels"]["per_d_step"]["bfloat16"],
        "per_fused_step_bfloat16": report["kernels"]["per_fused_step"]["bfloat16"],
        "per_production_step_bfloat16": report["kernels"]["per_production_step"]["bfloat16"],
        "sites_slower_than_library": len(report["kernels"]["slower_than_library"]),
        "launches_by_phase": in_by_phase,
        "checked_in": "phase 2",
    }]

    def warp_case(phase: str, dtype: str, aa: bool, shape=WARP_SHAPES[0]) -> dict:
        return next(c for c in report[phase]["cases"] if (c["b"], c["h"], c["w"]) ==
                    shape and c["dtype"] == dtype and c["antialias"] == aa)

    def at_512(phase: str) -> dict:
        c = warp_case(phase, "bfloat16", True, (P_BATCH, P_SIZE, P_SIZE))
        return {k: c[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "max_abs_err")}

    d_case, off_case = warp_case("warp", "bfloat16", True), warp_case("warp", "float32", False)
    fwd_by_phase = {"D phase (phase 8)": report["d_phase"]["warp_launches"],
                    "fused step (phase 11)": fused["warp_fwd"],
                    "Trainer (phase 14)": trained["warp_fwd"],
                    "production Trainer (phase 15)": prod["warp_fwd"],
                    **{k: v["warp_fwd"] for k, v in s7.items()}}

    def supersampled(fn: str) -> dict:
        """Phase 16a's cases of ``fn`` at S_SHAPE, antialias off."""
        return {c["dtype"]: {k: c[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "max_abs_err")}
                for c in slice7["ss_warp"] if c["fn"] == fn}
    kernels.append({
        "name": "warp_fwd",
        "route": "cuda",
        "source": "one_to_many_gan_torch/csrc/warp.cu",
        "replaces": WARP_REPLACES,
        "launches": sum(fwd_by_phase.values()),
        "max_abs_err": max(c["max_abs_err"] for c in report["warp"]["cases"]
                           if c["dtype"] == "float32"),
        "ms": d_case["kernel_ms"],
        "plain_ms": d_case["plain_ms"],
        "bound_ms": d_case["bound_ms"],
        "bound_by": d_case["bound_by"],
        "library_ms": None,
        "per": "one call at the D phase's [16,256,256], bfloat16, antialias on, cold L2; "
               "no single PyTorch call computes the antialiased warp",
        "grid_sample_ms_antialias_off_f32": off_case["library_ms"],
        "kernel_ms_antialias_off_f32": off_case["kernel_ms"],
        "production_site_bf16_aa": at_512("warp"),
        "supersampled_site_8x1024x1024_aa_off": supersampled("warp_fwd"),
        "launches_by_phase": fwd_by_phase,
        "checked_in": "phases 7 and 16a",
    })
    b_case, b_off = warp_case("warp_bwd", "bfloat16", True), warp_case("warp_bwd", "float32", False)
    kernels.append({
        "name": "warp_bwd",
        "route": "cuda",
        "source": "one_to_many_gan_torch/csrc/warp.cu",
        "replaces": WARP_BWD_REPLACES,
        "launches": (fused["warp_bwd"] + trained["warp_bwd"] + prod["warp_bwd"]
                     + sum(v["warp_bwd"] for v in s7.values())),
        "max_abs_err": max(c["max_abs_err"] for c in report["warp_bwd"]["cases"]
                           if c["dtype"] == "float32"),
        "ms": b_case["kernel_ms"],
        "plain_ms": b_case["plain_ms"],
        "bound_ms": b_case["bound_ms"],
        "bound_by": b_case["bound_by"],
        "library_ms": None,
        "per": "one call (pre-pass and gather) at the fused step's [16,256,256], bfloat16, "
               "antialias on, cold L2; no single PyTorch call computes the antialiased warp's "
               "gradient",
        "prepass_share_warm": report["warp_bwd"]["prepass_share"]["share"],
        "grid_sampler_2d_backward_ms_antialias_off_f32": b_off["library_ms"],
        "kernel_ms_antialias_off_f32": b_off["kernel_ms"],
        "production_site_bf16_aa": at_512("warp_bwd"),
        "supersampled_site_8x1024x1024_aa_off": supersampled("warp_bwd"),
        "launches_by_phase": {"fused step (phase 11)": fused["warp_bwd"],
                              "Trainer (phase 14)": trained["warp_bwd"],
                              "production Trainer (phase 15)": prod["warp_bwd"],
                              **{k: v["warp_bwd"] for k, v in s7.items()}},
        "checked_in": "phases 10 and 16a",
    })
    i8, i8_types = report["int8_kernel"]["per_decode"], report["int8_kernel"]["types"]
    f32, i8_launches = i8["float32"], report["int8_serve"]["launches"]
    i8_checked = report["int8_kernel"]["sites"] + report["int8_kernel"]["ragged"]
    i8_per = ("the 10 int8 sites of one n=64 decode of configs/default.toml (the resnet-block "
              "site timed once, counted 8 times), float32, one call each, cold L2")
    kernels.append({
        "name": "int8_prepass",
        "route": "cuda",
        "source": "one_to_many_gan_torch/csrc/int8_conv.cu",
        "replaces": INT8_PREPASS_REPLACES,
        "launches": i8_launches["int8_prepass"],
        "max_abs_err": max(s["prepass_max_abs_err"] for s in i8_checked),
        "ms": f32["prepass_ms"],
        "plain_ms": f32["prepass_plain_ms"],
        "bound_ms": f32["prepass_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "per": i8_per + "; no single PyTorch call modulates and takes the per-sample amax",
        "bfloat16": {k: i8["bfloat16"][k] for k in ("prepass_ms", "prepass_plain_ms",
                                                     "prepass_bound_ms")},
        "launches_by_phase": {"int8 serving (phase 18b)": i8_launches["int8_prepass"]},
        "checked_in": "phase 18a",
    })
    kernels.append({
        "name": "int8_conv",
        "route": "cuda",
        "source": "one_to_many_gan_torch/csrc/int8_conv.cu",
        "replaces": INT8_REPLACES,
        "launches": i8_launches["int8_conv"],
        "max_abs_err": max(s["max_abs_err"] for s in i8_checked),
        "ms": f32["conv_ms"],
        "plain_ms": f32["conv_plain_ms"],
        "bound_ms": f32["conv_bound_ms"],
        "bound_by": f32["conv_bound_by"],
        "library_ms": f32["library_ms"],
        "per": i8_per + "; library: the site as torch passes (modulate, pad, quantise), im2col "
               "(Tensor.unfold, materialised) + torch._int_mm, rescale, cast, demodulate",
        "with_prepass": {dtype: {k: i8[dtype][k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                                           "bound_by", "library_ms")}
                         for dtype in ("float32", "bfloat16")},
        "bfloat16": {k: i8["bfloat16"][k] for k in ("conv_ms", "conv_plain_ms", "conv_bound_ms",
                                                     "conv_bound_by", "library_ms")},
        "codes_only_bound_ms": i8["codes_bound_ms"],
        "bf16_conv_ms_not_the_same_function": i8["bf16_conv_ms"],
        "by_site_type": {k: {key: t[key] for key in ("x", "w", "pad_mode", "float32",
                                                     "bfloat16", "codes_bound_ms",
                                                     "bf16_conv_ms")}
                         for k, t in i8_types.items()},
        "launches_by_phase": {"int8 serving (phase 18b)": i8_launches["int8_conv"]},
        "checked_in": "phase 18a",
    })
    split, split_steps = report["split_norm"]["sites"], report["split_norm"]["steps"]
    sp2 = split["per_step_bf16"][2]
    split_per = ("one card's band of the 32 sites of a 512^2 step of the production config as "
                 "data 2 x spatial 2 runs it (S = 2), bfloat16, one call each, cold L2")
    for name, kind, library in (("instance_norm_split_partials", "partials",
                                 "torch.var_mean of the band"),
                                ("instance_norm_split_apply", "apply",
                                 "F.batch_norm of the band with the combined statistics")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "one_to_many_gan_torch/csrc/instance_norm.cu",
            "replaces": IN_REPLACES + " (its plane statistics and normalisation, for a plane "
                        "split into bands of rows)",
            "launches": split_steps["launches"][f"split_{kind}"],
            "max_abs_err": split["max_abs_err_f32"],
            "ms": sp2[f"{kind}_ms"],
            "plain_ms": sp2[f"plain_{kind}_ms"],
            "bound_ms": sp2[f"{kind}_bound_ms"],
            "bound_by": "bytes",
            "library_ms": sp2[f"library_{kind}_ms"],
            "per": split_per + f"; library: {library}",
            "at_spatial_4": {k: v for k, v in split["per_step_bf16"][4].items()
                             if k.startswith((kind, f"plain_{kind}", f"library_{kind}"))},
            "whole_sites_kernel_ms": sp2["whole_kernel_ms"],
            "whole_sites_f_instance_norm_ms": sp2["whole_library_ms"],
            "max_abs_err_bf16": split["max_abs_err_bf16"],
            "launches_by_phase": {"banded fused steps, a spatial group of one card (phase 19b)":
                                  split_steps["launches"][f"split_{kind}"]},
            "checked_in": "phase 19a",
        })
    up_cases = report["upsample"]["cases"]
    up_bf16 = report["upsample"]["per_chunk"]["bfloat16"]
    up_by_phase = {"serve (phase 3)": report["serve"]["upsample_launches"],
                   "bf16 serve (phase 5)": report["bf16"]["upsample_launches"],
                   "one engine call of 4 requests at n=64 (phase 21)":
                       report["upsample"]["call_launches"]}
    kernels.append({
        "name": "upsample2x",
        "route": "cuda",
        "source": "one_to_many_gan_torch/csrc/upsample.cu",
        "replaces": UP_REPLACES,
        "launches": sum(up_by_phase.values()),
        "max_abs_err": max(c["max_abs_err"] for c in up_cases if c["dtype"] == "float32"),
        "ms": up_bf16["kernel_ms"],
        "plain_ms": up_bf16["plain_ms"],
        "bound_ms": up_bf16["bound_ms"],
        "bound_by": "bytes",
        "library_ms": up_bf16["library_ms"],
        "per": "the two upsample sites of one serving decode chunk of 86 images, bfloat16, one "
               "call each, cold L2; plain and library: the plain version, per axis a "
               "replication pad + cuDNN's grouped F.conv_transpose2d",
        "sites": {f"{c['site']}_{c['dtype']}": {k: c[k] for k in (
            "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "of_bound")}
            for c in up_cases},
        "launches_per_call": report["upsample"]["call_launches"],
        "launches_by_phase": up_by_phase,
        "checked_in": "phase 21",
    })
    report["wall_s"] = time.perf_counter() - t_start
    log(f"chip_smoke wall time {report['wall_s']:.1f} s")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
