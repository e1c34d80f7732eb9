"""Smoke run of stego_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from stego_torch/csrc with nvcc (one process a source, started
   together).
2. Holds kernel L (LayerNorm, at ViT-T's, ViT-S's and ViT-B's widths 192,
   384 and 768), its residual form L2 (add_layer_norm, at 192 and 384) and
   kernel A (attention: token-major, and every head-major form at ViT-T's
   shapes: batch_resident, kv_resident, resident, flash, no_softmax, and
   packed at ViT-S's) against their plain PyTorch versions at the shapes
   the trunk gives them, and times them beside F.layer_norm (L2: of x + y)
   and F.scaled_dot_product_attention (timed only: the port never calls
   them); L and L2 also cold, on rotating inputs larger than L2. Then the
   narrow widths: kernel A's bf16 narrow-head kernel at heads of 8, 16
   and 32 in every form (the sensitive accuracy instrument's trunk: 4
   heads of 8, N = 65, batch 16 and 48) and L at D = 32 and 64, the same
   way, beside SDPA and F.layer_norm; and the narrow-head kernel's f32
   instantiation in every form at 2e-5 (TF32 off), beside f32 SDPA, with
   its bf16 instantiation on the same inputs as a control that must fail.
3. Serves flip-TTA requests with seeded ViT-S/8 and ViT-T/8 STEGO
   segmenters at full width (cocostuff27 head: dim 70, nonlinear, 27
   classes, bf16 trunk): 3 requests of 8 images at res 224, then 3 at res
   320, through load_model_for_eval and make_eval_step, after a round trip
   through a .ckpt. Each request must launch each kernel a fixed number of
   times (ViT-S: token-major attention; ViT-T: head-major, batch-resident at
   224 and kv-resident at 320), and its code and predictions must agree
   with the same batch through the plain versions on the card.
   Then the serving artifact (stego_torch/serve.py, python -m
   stego_torch.serve): package() of those checkpoints on the card, ViT-S/8
   at res 320 and 224, ViT-T/8 at 320 and an f32-trunk ViT-S/8 (A-f32) at
   224, a torch.export program whose trunk reaches kernels A and L through
   the ops stego_torch::attention and stego_torch::layer_norm; each loaded
   by ServingModel.load in a fresh python3 process that imports no model
   code. Each predict of 8 must launch 24 A at the trunk's entry and 50 L
   (none in f32), its outputs must equal the eager serving module's on the
   same batch bit for bit (ViT-S at 320 also at batch 5), and the same
   artifact loaded with device="cpu" must agree with the card. Prints the
   packaging and load seconds, ms per predict at 320 (artifact, eager
   module, with host arrays), device ms a predict, images/s and the host
   cost of a call through an op against the direct call.
4. Holds kernel C1 (the sampled correlation loss, forward and backward:
   the gather kernel, C2's forward, C2's backward and the adjoint kernel)
   against its plain version at the train step's shapes, with bf16
   features at ViT-T's 192, ViT-S's 384 and ViT-B's 768 channels and f32
   features at 384 and 768 (an f32 trunk), the gather and the adjoint
   each against their own plain versions, two calls' outputs bit for bit,
   and times it whole and by part; on f32 features its fd elementwise, with
   the bf16 instantiation and one TF32 pass a product as controls that
   must fail.
5. Holds kernel C2 (the streamed correlation loss, forward and backward)
   against its plain version at the full-field shape (7 dense 784 x 784
   fields of 16 images) and the grid-sampled shape (121 samples), with f32
   and with bf16 code (code_bf16), with f32 features, and at ViT-B's 768
   channels (bf16 and f32 features), and times it; the f32 kernel, which
   ignores code_bf16, must fail the code_bf16 gate, and the bf16 kernel on
   f32 features the f32 elementwise gates, and so must, at the full-field
   shape, the plain version on TF32-rounded features and code (one TF32
   pass a product, where the kernel takes three). Its stored clamp masks
   on code built near the clamp bounds must be f32 FMA's in channel order
   bit for bit (a build without the fix-up must fail that), and a build
   that records the entries the fix-up recomputes must find their 3xTF32
   cd within an eighth of the fix-up's margin of the FMA's.
6. Trains: 20 steps of make_train_step at the reference footprint
   (src/configs/train_config.yml: ViT-S/8, res 224, batch 16, 11 x 11
   samples, 5 negatives, dropout) on one fixed synthetic batch, each
   launching C1 forward and backward once and the trunk's kernels once
   over img || img_pos; the loss must fall. One step with C1 is held
   against the same step with C1's plain version. Then 3 val steps
   (make_val_step) at res 320.
7. Trains with the streamed loss C2: 10 full-field steps (full_field_loss)
   at the same footprint, whose loss must fall (then timed also with C2's
   plain version), then 3 steps each with
   fused_sampling="off" and pallas_loss_bf16; each step launches C2 forward
   and backward once and C1 never, and one step of each is held against
   the same step with C2's plain version.
8. The feature-cache path, on seeded synthetic scenes of 27 classes
   (stego_torch/data/synthetic.py; 1024 train images at res 224, 128 val
   images at res 320): the KNN table of the train split (train/knn.py,
   bf16 trunk, top 30; every image its own nearest); feature caches
   (train/feat_cache.py) of both splits with the bf16 and the f32 trunk,
   whose rows equal the trunk's output; cached train runs over index
   batches that FeatCacheSampler draws from the KNN table (bf16 and f32
   trunks with the sampled loss, C1, 20 steps; f32 full-field, C2, 10
   steps; f32 fused_sampling="off", C2, 3 steps), each step launching the
   loss's kernel forward and backward once and no other kernel, the loss
   falling, one step held against the same step with the loss's plain
   version; one f32 image step against one cached step on the same images;
   make_cached_val_epoch over both val caches, its last batch padded,
   against make_val_step on the same images.
9. Trains a seeded ViT-T/8 segmenter (cocostuff27 head) 10 steps with the
   sampled loss (C1 at 192 channels; 12 head-major attention and 25 L
   launches at D=192 a step), one step held against the plain loss, then 3
   val steps at res 320; and a seeded ViT-B/8 segmenter with the
   cocostuff27_vit_base preset 10 steps with the sampled loss (C1 at 768
   channels) and 3 full-field steps (C2 at 768), each with the same gates.
10. Past the parent's caps: A-f32 (kernel A on f32 q/k/v, its products by
   3xTF32 on the tensor cores; TF32 off in the plain versions) against its
   plain versions at 2e-5, token-major at ViT-S's shape and every
   head-major form at ViT-T's, beside f32 SDPA, with the plain version in
   one TF32 pass a product as a control that must fail; C1 at 100 code
   channels and 12x12 samples and C2 at 160 code channels in phases C1
   and C2; 3 ViT-S/8 train steps each at dim=100 with 12x12 samples (C1),
   full-field at dim=160 (C2) and with an f32 trunk through A-f32 (12
   launches a step, LayerNorm plain), each held against its plain step
   (the f32 trunk by its gradients, with TF32 and bf16 attention as
   controls that must fail). Then the narrow widths' paths: 3 train steps
   of the sensitive instrument's configuration on bf16 trunks of width
   32, 64 and 128 with heads of 8, 16 and 32 (2 A at the head width, 5 L
   at the width, C1 once a step), and one forward of f32 trunks of those
   shapes with use_flash_attention (2 f32 narrow-head launches, no L),
   held at 2e-5 to the plain trunk; the training branches at the main
   footprint, each 3 steps with one held against its loss kernel's plain
   version: the salience-biased draw sampled (C1) and grid-sampled (C2),
   the aug-alignment loss on the device route (ops/augment.py in the
   step, the trunk over 48 images) and the host route; the sensitive
   accuracy row end to end (tools/accuracy_bench.py: the mosaic, its KNN,
   40 steps of the app; every A launch at d = 8, every L at D = 32),
   gated by its bands, after checking the seeded init's pinned draws,
   then on 8 seeded trunks (every one inside the linear bands, at least 6
   inside every band); and an f32 eval step through load_model_for_eval from torch's default
   TF32 flags, held to the step with TF32 off (cuDNN's TF32 on, the
   control, must fail).
11. The training app (stego_torch/train/app.py: train() through its
   Trainer) at the same footprint on the scenes and their KNN table:
   100 steps with validation at res 320 and a checkpoint every 50, a
   resumed run to 150 and 50 cached steps (cache_backbone_feats). Every
   step launches 12 A, 25 L and C1 forward and backward once, every
   validation batch 12 A2 and 25 L; the logged loss must fall, the
   validations give finite metrics with the JAX app's keys, the kept
   checkpoints are the JAX manager's top 2 of them, the backbone is saved
   in f32 beside the bf16 trunk, the newest .ckpt through
   load_model_for_eval gives the in-memory segmenter's flip-TTA code bit
   for bit, and the resumed run starts at step 100. Prints the app's
   median step, images/s, the bare step's, the loader's wait, the
   validation epochs' seconds and peak device memory. Then the app's soak
   (stego_torch/tools/soak.py) at 300 steps on the same scenes:
   validation, a checkpoint and the histograms every 50, the probes reset
   at 150, a straight run and one cut at 100 and resumed, held by every
   gate of the soak but the accuracy bands and host RSS (the schedule's
   rows, the kept checkpoints, flat device memory, exact launches a step
   and a validation batch, the resumed run bit for bit the straight one).
12. Evaluates the app's newest .ckpt over its 128 val scenes at res 320
   (stego_torch/eval/evaluate.py: evaluate() through its Evaluator,
   loader batches of 16, flip-TTA) without a CRF, with the grid CRF on the
   card and with the exact CRF on the host (one batch of 8). Every batch
   launches 24 A at pair_kv and 50 L and nothing else; the device-summed
   confusion matrices equal the host's np.bincount of the predictions; the
   metrics are finite with the JAX evaluate's keys. The grid CRF of one
   batch's log-probs on the card is held against the same function on the
   CPU and in f64 (its first 8 images), and the grid and exact CRFs must
   agree on 90% of the argmaxes of its first 8; save_outputs writes the
   PNG trees. Prints each run's
   images/s, the grid CRF's device ms a batch and the exact CRF's host
   seconds an image.
13. Trains 10 sampled steps with the in-training CRF loss (crf_weight 0.1:
   12 A, 25 L and C1 forward and backward once a step; the loss must fall;
   one step held against the plain loss's), then runs the CRF app
   (stego_torch/train/crf_app.py: 20 epochs of train_crf_codes on 4
   scenes), whose loss must be finite and fall.
14. Phase ddp (stego_torch/parallel/dist.py): two ranks on this card over
   gloo, each a child process (chip_smoke.py --ddp-child), at the train
   footprint (global batch 16, 8 images a rank): 3 steps with local
   negatives (C1 on each rank; an f32 trunk through A-f32), 3 with global
   negatives (C2 over the gathered maps' rows) and 2 full-field (C2),
   each rank's parameters equal bit for bit after every step, and
   metrics and parameters within the train step's gates of one process on
   the whole batch with the same draws, each of its steps from the ranks'
   state after the step before (local: C2's emulation of the two
   blocks), and the whole trajectories against its own from the seeded
   start (the f32 local case where Adam's sqrt(v) >= 1e-5); the KNN
   build (nns equal one process's), the app (16 steps
   straight, and 8, a checkpoint and a resume to 16, equal bit for bit;
   the validation's matrices equal one process's) and evaluate() (its
   matrices equal one process's) on the two ranks; exact launches a rank.
   One rank over NCCL runs beside them (the global case's one-process
   step through a group of one); then two ranks over NCCL, one a card,
   where the machine has two. Prints each rank's ms a step, device busy
   and the collectives' calls and host ms a step: processes sharing one
   card, not a scaling number.
15. The plot apps (python -m stego_torch.eval.plot_apps) at ViT-S/8 bf16
   with the cocostuff27 head on a written directory set and a written
   PotsdamRaw scene: correspondence at res 224 (24 A, 50 L) and 512 (no A:
   N = 4097 takes the einsum form; 50 L), the Potsdam mosaic of 15 x 15
   tiles at 320 (2 trunk calls a batch of 16) and the PR curves at 320
   with the CRF recalibrator trained on the card; exact launches, each
   held against the same app with the trunk's kernels off, its seconds.
16. Runs the attention layout ladder (stego_torch/tools/attention_layouts.py:
   12 chained pre-LN attention sublayers at B=32, N=785 for ViT-S, ViT-B
   and ViT-T), every rung's core held against its plain version and each
   chain launching exactly its kernels: the path of kernel A's resident,
   flash, no_softmax and packed forms and of L2.

Phase fpn, before phase analysis, trains the feature-pyramid arch
(ResNet-50) and drives its entry points; its app cut at 5 steps and resumed
to 10 must end in the straight run's train state bit for bit. The scenes of
steps 8-14 render on the host's other cores from phase C1 on. Prints each
phase's seconds, one JSON line with the kernels' results (times, launches
on the main paths, errors against the plain versions, the least time the
card could take for the same work, and the library call's time where one
PyTorch call computes the same function), the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Exits non-zero, without that line,
when there is no CUDA device, a kernel does not build or launch, or a check
fails. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import functools
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 8
REQUESTS = 3
RESOLUTIONS = (224, 320)
HEADS, HEAD_DIM, EMBED = 6, 64, 384  # ViT-S/8
LN_SHAPES = [(8 * 785, EMBED), (8 * 1601, EMBED), (8 * 785, 192),
             (8 * 785, 768)]
ADD_LN_SHAPES = [(8 * 785, EMBED), (8 * 785, 192), (8 * 785, 768)]
# the head-major forms at ViT-T's shapes (3 heads; B=8 at res 224 and 320,
# B=2 at 448), packed (an even head count) at ViT-S's; the first shape of
# each entry is its row in the kernels line
HEAD_MAJOR_CASES = (
    ("batch_resident", (8, 3, 785)), ("kv_resident", (8, 3, 1601)),
    ("kv_resident", (8, 3, 785)), ("resident", (8, 3, 785)),
    ("flash", (8, 3, 785)), ("flash", (8, 3, 1601)), ("flash", (2, 3, 3137)),
    ("no_softmax", (8, 3, 785)), ("packed", (8, 6, 785)))
# token-major kernel A: (B, N, H) of ViT-S/8 serving at res 224, 320 and
# 448, and of ViT-B/8's train trunk (img || img_pos of a batch of 16 at res
# 224, the shape of scripts/bench_attn_vitb.py)
ATTN_SHAPES = [(8, 785, HEADS), (8, 1601, HEADS), (2, 3137, HEADS),
               (32, 785, 12)]
ATTN_RTOL, ATTN_ATOL = 2e-2, 5e-3  # attention rows of PARITY_r05.json
# kernel A's narrow-head kernel, bf16 (d, B, H, N): the sensitive accuracy
# instrument's trunk (4 heads of 8 at res 64: N = 65; batch 16, 48 images
# in its aug step), and heads of 16 and 32 at the same shape; every form
# at each, the first of each d its row in the kernels line
NARROW_CASES = ((8, 16, 4, 65), (8, 48, 4, 65), (16, 16, 4, 65),
                (32, 16, 4, 65))
NARROW_FORMS = ("batch_resident", "kv_resident", "resident", "flash",
                "no_softmax", "pair")
# the narrow-head kernel's f32 instantiation (d, B, H, N): the sensitive
# instrument's shape at each width, every form at each
NARROW_F32_CASES = ((8, 16, 4, 65), (16, 16, 4, 65), (32, 16, 4, 65))
# kernel L at the runtime-width kernel's widths: the tiny trunk's 32 (16
# and 48 images of 65 tokens) and 64
NARROW_LN_SHAPES = [(16 * 65, 32), (48 * 65, 32), (16 * 65, 64)]
# the narrow trunks driven through the train step (phase_narrow_paths):
# width and heads; the first is the sensitive instrument's own
NARROW_TRUNKS = ((32, 4), (64, 4), (128, 4))
NARROW_STEPS = 3
# models/vit.py:trunc_normal(torch.empty(6), 0.02, seed 0), as
# tests/test_torch_vit.py pins them: a seed's trunk is one trunk under any
# torch release
TRUNC_NORMAL_SEED0 = [0.03081992268562317, -0.00586857832968235,
                      -0.01438515167683363, 0.011368625797331333,
                      -0.021690446883440018, -0.027971908450126648]
CODE_MAX_ABS, CODE_MEAN_ABS, PRED_AGREE = 6e-2, 4e-3, 0.99
# per request: 2 trunk calls x (12 attention sublayers, 25 LayerNorms)
ATTN_PER_REQUEST, LN_PER_REQUEST = 2 * 12, 2 * 25
# the train step's footprint (src/configs/train_config.yml)
TRAIN_BATCH, TRAIN_RES, VAL_RES = 16, 224, 320
TRAIN_STEPS, HIST_STEPS, VAL_STEPS = 20, (0, 10), 3
# ViT-T and ViT-B train runs: 10 sampled steps (loss window 3), then ViT-B
# 3 full-field steps (window 1)
WIDE_STEPS, WIDE_FULL_STEPS = 10, 3
CORR_SHAPE = dict(b=16, hw=28, cf=384, cc=70, s=11, neg=5)
# kernels C1 and C2 by feature type and channels: ViT-S's 384 (bf16 and f32
# trunks), ViT-T's 192 and ViT-B's 768 (bf16 trunks, and f32 at 768); the
# key of each in the kernels line
C1_CASES = (("bf16", torch.bfloat16, 384), ("f32", torch.float32, 384),
            ("bf16_192", torch.bfloat16, 192),
            ("bf16_768", torch.bfloat16, 768),
            ("f32_768", torch.float32, 768),
            # dim=100, feature_samples=12: two code chunks, two sample tiles
            ("bf16_cc100_s144", torch.bfloat16, 384, dict(cc=100, s=12)),
            # the feature-pyramid step's: ResNet-50's layer4 (2048 channels
            # at 7 x 7, res 224) beside 56 x 56 code, bf16 and f32 trunks
            ("bf16_2048", torch.bfloat16, 2048, dict(hw=7, code_hw=56)),
            ("f32_2048", torch.float32, 2048, dict(hw=7, code_hw=56)))
# the code widths past one chunk of C1 (96) and C2 (128) that the wide
# train steps run: dim=100 with feature_samples=12 (S=144), and dim=160
WIDE_C1 = dict(dim=100, feature_samples=12)
WIDE_C2_DIM = 160
# the least gradient whose Adam step the f32-trunk step holds, and the
# gap its gradients may have (phase_wide): at the seed-0 trunk of
# models/vit.py:trunc_normal the step with A-f32 is 4.8e-6 from the plain
# step and the control with TF32 attention 5.1e-5 (H100), so the gap sits
# between them (it was 1e-4, which that control passed)
ADAM_LIVE = 1e-7
F32_TRUNK_GRAD_GAP = 2e-5
# the least Adam sqrt(v) at which phase ddp holds the f32 trunk's
# parameter trajectories: a ReLU of the cluster head whose input lies
# within an f32 rounding of 0 is decided one way by the ranks' 8-image
# GEMMs and the other by one process's 16-image GEMMs, which moves one
# row's gradient by one pixel's share (up to ~5e-7 on the H100, row 212
# of net.cluster2.0.weight); Adam carries a gradient difference d into
# lr (1 - b1) / (1 - b1^t) d / sqrt(v) of the parameter, more than
# GRAD_ATOL at lr 5e-4 where sqrt(v) < ~1e-5 (hold_ddp_trajectories
# prints the entries it leaves out that are over the gate)
ADAM_LIVE_TRAJECTORY = 1e-5
# A-f32 against its plain versions: the JAX package's f32 tolerance
# (tests/test_torch_attention.py), which TF32 products would fail
F32_RTOL, F32_ATOL = 2e-5, 2e-5
# the plain version's form of each head-major entry A-f32 and the narrow
# heads are held on (the others' are their names)
FORM_OF = {"batch_resident": "two_pass", "kv_resident": "two_pass"}
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6  # sampled-loss rows of PARITY_r05.json
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5  # tests/test_fused_sampling.py:265
# the streamed loss: full-field maps, grid-sampled maps (PARITY_r05's corr
# rows: losses and cd rtol 1e-4 atol 1e-5, code gradients as above)
STREAM_SHAPES = (("full-field", 28), ("grid-sampled", 11))
STREAM_RTOL, STREAM_ATOL = 1e-4, 1e-5
# code_bf16: both versions compute cd in other orders, so a cd within an
# f32 rounding of the clamp's bound may fall inside the mask in one and
# outside in the other; each such element moves a code gradient row by up
# to ~2**-8 of the largest gradient (the weights make it 1). So: every code
# gradient within BF16_GRAD_ATOL, and at least BF16_GRAD_SHARE of them
# within the f32 tolerance (GRAD_RTOL, GRAD_ATOL). Not rounding dL/dcd to
# bf16 (8 significant bits) moves nearly every element by ~2**-9 of its
# row's size; phase C2 checks that both controls, the f32 kernel on the raw
# and on the bf16-rounded code, fail this gate. The step's updated
# parameters: within a tenth of lr (5e-4), the most a first Adam step moves
# a parameter whose gradient is below 1e-9 (lr g / (|g| + 1e-8)); the step
# with the f32 kernel must fail that.
BF16_GRAD_ATOL, BF16_GRAD_SHARE, BF16_PARAM_ATOL = 2 ** -7, 0.99, 5e-5
# f32 features: the losses and code gradients average fd over many
# elements, so a kernel that rounded the features to bf16 (~1e-4 on one fd
# of unit vectors of 384 channels) could stay inside their tolerances. The
# f32 kernels' products are therefore also held elementwise against the f32
# plain version: C1's fd within FD_ATOL, C2's fd row sums (N terms) within
# ROW_SUM_ATOL; the bf16 instantiation on the same f32 features, the
# control, must fail.
FD_ATOL, ROW_SUM_ATOL = 1e-5, 1e-4
# C1's gather against sample_sets_plain (rtol, atol), by the sets' type: the
# plain version sums the four taps inside a GEMM over the map's weight row,
# which may group them otherwise (an f32 rounding); a bf16 sample that
# moves by a rounding step moves by one bf16 step (2^-8 to 2^-7 of its
# size), and its normalised value rounds once more. Its adjoint against
# unsample_plain on the same inputs: f32 sums of a few terms of the
# gradients' size, which phase C1 scales to a largest code gradient of 1.
GATHER_TOL = {torch.bfloat16: (2 ** -6, 1e-6), torch.float32: (1e-5, 1e-6)}
ADJOINT_TOL = (1e-5, 1e-5)
# the parts of C1's forward in c1_parts (the others are its backward's)
C1_FWD_PARTS = ("inputs", "gather", "c2_copies", "c2_fwd_kernel", "finalize")
# The full-field steps' gradient distance to the step with C2's plain
# version in f64 with the previous forward, whose f32 cd was f32 FMA
# throughout (its chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): C2's
# by 3xTF32 with the fix-up is held to at most twice it.
F64_GAP_FMA_CD = {"ViT-S full-field": 9.862e-08, "ViT-B full-field": 3.056e-07,
               "cached f32 full-field": 7.681e-08}
# C2's check builds, built in main before the first phase: without the
# fix-up (near_bound_masks' control) and recording what it recomputes
# (fixup_margin); {build flag: library path}
NO_FIXUP, COUNT_FIXUPS = "-DSTEGO_C2_FWD_ABLATION=8", "-DSTEGO_C2_FWD_ABLATION=16"
CHECK_BUILDS = {}
# each train_run's median step (ms), by its label
STEP_MEDIANS = {}
# A cd within CLAMP_TIE of a clamp bound may be clamped in the kernel and not
# in the plain version (they sum it in other orders): one such coefficient
# moves ~560 code gradients by up to ~4e-3 at unit scale (seen on the card
# at 192 channels). Phase C1's inputs are drawn again until none is.
CLAMP_TIE = 1e-7
FULL_STEPS, SHORT_STEPS = 10, 3
# the feature-pyramid arch (phase fpn): ResNet-50's layer4 channels, the
# head's granularity, its sampled steps (bf16 trunk) and the app's run on
# FPN_TRAIN + FPN_VAL written scenes at TRAIN_RES; a conv bias before a
# train-mode BatchNorm (and a kernel entry whose input channel is constant
# over the batch) has an analytic gradient of 0, which a kernel step and a
# plain step compute as different rounding noise, and Adam's first step
# moves either by up to lr: the parameters are held where the plain step's
# gradient is at least ADAM_LIVE
FPN_CF, FPN_GRANULARITY, FPN_STEPS = 2048, 4, 10
# the gap the feature-pyramid steps' head gradients may have from the plain
# step's (phase fpn); C1's and C2's kernels take the plain versions' rounding
FPN_GRAD_GAP = 1e-6
# the part of the feature-pyramid steps' loss that must fall: on a random
# ResNet-50 the linear probe's cross-entropy of the head's unnormalised code
# grows over the first steps and takes loss/total with it
CONTRASTIVE = ("the weighted contrastive losses (loss/total - loss/linear - "
               "loss/cluster)", lambda m: m["loss/total"] - m["loss/linear"]
               - m["loss/cluster"])
FPN_TRAIN, FPN_VAL, FPN_APP_STEPS, FPN_APP_CUT = 64, 16, 10, 5
FPN_EMBEDDERS = ("resnet50", "vgg11", "densenet121")
# the feature-cache path: seeded synthetic scenes of 27 classes, the train
# split at TRAIN_RES with its KNN table, the val split at VAL_RES in
# batches of VAL_BATCH (128 = 5 x 24 + 8: a short final chunk and batch)
TRAIN_IMAGES, VAL_IMAGES, VAL_BATCH, KNN_K = 1024, 128, 24, 30
# counted launches: attention, LN, C1 forward/backward, C2 forward/backward
COUNTS = ("attention", "layer_norm", "corr_sampled_fwd", "corr_sampled_bwd",
          "corr_stream_fwd", "corr_stream_bwd")
# and, on every main path beside them, kernel A's launches by entry point
# and L2's
ENTRIES = ("pair", "pair_kv", "packed", "resident", "batch_resident",
           "kv_resident", "flash", "no_softmax")
# and kernel A's launches at the narrow head widths, L's at the runtime-
# width kernel's widths that a path runs (attention_d<d>, layer_norm_<D>)
NARROW_DS = (8, 16, 32)
NARROW_LN_DS = (32, 64, 128)
# the attention layout ladder (stego_torch/tools/attention_layouts.py):
# 12 chained sublayers at B=32, N=785 for these models, LAYOUT_ITERS timed
# chains a rung; the kernel A entry each rung launches once a sublayer
LAYOUT_MODELS = ("vit_small", "vit_base", "vit_tiny")
LAYOUT_BATCH, LAYOUT_TOKENS, LAYOUT_ITERS = 32, 785, 5
RUNG_ENTRY = {"head-major, copies outside": "batch_resident",
              "head-major views": "batch_resident",
              "head-major views, resident": "resident",
              "token-major": "pair", "packed": "packed",
              "flash": "flash", "no softmax": "no_softmax",
              "token-major, add+LN fused": "pair",
              "head-major views, add+LN fused": "batch_resident"}
# H100 SXM at 700 W, dense (NVIDIA data sheet): FLOP/s by operand
# type and HBM bytes/s, for the least time a kernel's work could take.
# "tf32x3": f32 products on the tensor cores by 3xTF32 (csrc/tf32x3.cuh),
# three TF32 products each at 495 TFLOP/s, the rate at which A-f32 and C2
# count every f32 product; "f32": f32 FMA outside the tensor cores (C1,
# and the f32-FMA bound printed beside each 3xTF32 one)
PEAK_FLOPS = {"bf16": 989e12, "tf32x3": 495e12 / 3, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20

failures: list[str] = []


def check(ok: bool, what: str) -> bool:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)
    return ok


def within(diff, tol, want) -> bool:
    """All of ``diff`` within ``tol``; else prints the count and the worst
    element."""
    bad = diff > tol
    if not bool(bad.any()):
        return True
    i = int(torch.argmax(diff / tol))
    print(f"  {int(bad.sum())} of {diff.numel()} elements out of tolerance; "
          f"worst: diff {float(diff.flatten()[i]):.3e}, tolerance "
          f"{float(tol.flatten()[i]):.3e}, reference "
          f"{float(want.flatten()[i]):.6e}")
    return False


def call_ms(fn, iters: int = 20) -> float:
    """Mean time of one call of ``fn`` in ms, launch overhead included:
    CUDA events around ``iters`` calls after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn, iters: int = 1, attempts: int = 5) -> dict:
    """Device microseconds by kernel name over ``iters`` calls of ``fn``,
    from the profiler's CUDA trace (after one warm-up call). The trace
    now and then comes back without device events, sometimes several
    times in a row; the window is then traced again, up to ``attempts``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                times[e.name] = times.get(e.name, 0.0) \
                    + e.time_range.elapsed_us()
        if times:
            return times
        print("  (the profiler's trace held no device events; tracing again)")
    raise RuntimeError(f"the profiler recorded no device time in {attempts} "
                       f"traces")


def device_ms(fn, iters: int = 20, floor_ms: float = 0.0,
              attempts: int = 3) -> float:
    """Device time of one call of ``fn`` in ms: the summed durations of the
    kernels it launches. A trace now and then holds only some of the
    kernels: a time below ``floor_ms`` (the work's bound, which no run can
    beat) is traced again, up to ``attempts`` times."""
    for _ in range(attempts):
        ms = sum(kernel_times(fn, iters).values()) / iters / 1e3
        if ms >= floor_ms:
            return ms
        print(f"  (a trace gave {ms:.4f} ms, below the bound {floor_ms:.4f} "
              f"ms: tracing again)")
    raise RuntimeError(f"{attempts} traces below the bound {floor_ms} ms")


def compare_times(kernel, plain):
    """{device, call} x {kernel, plain} ms, timed in turns plain, kernel,
    kernel, plain."""
    out = {}
    for what, timer in (("device", device_ms), ("call", call_ms)):
        p1, k1, k2, p2 = timer(plain), timer(kernel), timer(kernel), \
            timer(plain)
        out[what] = ((k1 + k2) / 2, (p1 + p2) / 2)
    return out


def bound(flops: dict, nbytes: float):
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``flops`` (operations by type, each at its peak rate) and
    ``nbytes`` (inputs read once, outputs written once)."""
    t_ops = sum(f / PEAK_FLOPS[kind] for kind, f in flops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound_text(b) -> str:
    return f"bound {b[0]:.4f} ms ({b[1]}, H100 SXM peaks)"


def timing_text(t) -> str:
    return (f"device kernel {t['device'][0]:.4f} ms, plain "
            f"{t['device'][1]:.4f} ms; per call with launch: kernel "
            f"{t['call'][0]:.4f} ms, plain {t['call'][1]:.4f} ms")


def cold_ms(fn, inputs) -> float:
    """Device time of one call of ``fn`` when its input is not in L2: one
    call on each of ``inputs`` in turn (together larger than L2), from the
    profiler's trace."""
    def sweep():
        for x in inputs:
            fn(x)

    return sum(kernel_times(sweep, 3).values()) / (3 * len(inputs)) / 1e3


def phase_layer_norm(dev, shapes=None):
    """Kernel L at ``shapes`` (default LN_SHAPES) against its plain
    version, timed warm and cold beside F.layer_norm; (the worst error,
    {D: the result at its first shape})."""
    import torch.nn.functional as F

    from stego_torch.ops import layer_norm as ln

    print("kernel L (layer_norm) vs plain, bf16, within one bf16 ulp; "
          "library: F.layer_norm with bf16 weights (it takes no f32 "
          "weights with a bf16 input on the card)")
    g = torch.Generator(device=dev).manual_seed(0)
    worst, by_width = 0.0, {}
    for rows, d in shapes or LN_SHAPES:
        x = (torch.randn(rows, d, generator=g, device=dev) * 3 + 1.5) \
            .bfloat16()
        w = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        b = 0.1 * torch.randn(d, generator=g, device=dev)
        got = ln.fused_layer_norm(x, w, b, 1e-6)
        torch.cuda.synchronize()
        want = ln.layer_norm_plain(x, w, b, 1e-6)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        worst = max(worst, err)
        t = compare_times(lambda: ln.fused_layer_norm(x, w, b, 1e-6),
                          lambda: ln.layer_norm_plain(x, w, b, 1e-6))
        wb, bb = w.bfloat16(), b.bfloat16()
        lib = device_ms(lambda: F.layer_norm(x, (d,), wb, bb, 1e-6))
        copies = -(-2 * L2_BYTES // x.nbytes)
        xs = [x + i for i in range(copies)]
        cold = cold_ms(lambda xi: ln.fused_layer_norm(xi, w, b, 1e-6), xs)
        lib_cold = cold_ms(lambda xi: F.layer_norm(xi, (d,), wb, bb, 1e-6),
                           xs)
        del xs
        # 2 bf16 bytes read and written an element, f32 weight and bias;
        # ~8 f32 operations an element (mean, variance, normalise, affine)
        bnd = bound({"f32": 8 * rows * d}, 4 * rows * d + 8 * d)
        check(within(diff, ln.bf16_ulp_tolerance(want), want),
              f"({rows}, {d}): max_abs_err {err:.3e}; {timing_text(t)}; "
              f"cold (inputs {copies} x {x.nbytes / 2**20:.1f} MiB in "
              f"turn): kernel {cold:.4f} ms, F.layer_norm {lib_cold:.4f} "
              f"ms; warm F.layer_norm {lib:.4f} ms; {bound_text(bnd)}")
        by_width.setdefault(d, dict(
            ms=t["device"][0], plain_ms=t["device"][1], cold_ms=cold,
            library_ms=lib, bound=bnd, max_abs_err=err,
            shape=f"({rows}, {d}) bf16"))
    return worst, by_width


def phase_add_layer_norm(dev):
    """Kernel L2 (add_layer_norm) against its plain version: r bit for bit
    (one rounding of an exact f32 sum), LN(r) within one bf16 ulp; timed
    warm and cold beside the two-call form (x + y, then kernel L) and
    F.layer_norm(x + y). Returns the rows by width, the first shape's
    first."""
    import torch.nn.functional as F

    from stego_torch.ops import layer_norm as ln

    print("kernel L2 (add_layer_norm) vs plain: r = bf16(x + y) bit for "
          "bit, LN(r) within one bf16 ulp; two-call form: x + y, then kernel "
          "L; library: F.layer_norm(x + y) with bf16 weights")
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for rows, d in ADD_LN_SHAPES:
        x = (torch.randn(rows, d, generator=g, device=dev) * 3 + 1.5) \
            .bfloat16()
        y = torch.randn(rows, d, generator=g, device=dev).bfloat16()
        w = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        b = 0.1 * torch.randn(d, generator=g, device=dev)
        r, got = ln.add_layer_norm(x, y, w, b, 1e-6)
        torch.cuda.synchronize()
        want_r, want = ln.add_layer_norm_plain(x, y, w, b, 1e-6)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = torch.equal(r, want_r) and within(
            diff, ln.bf16_ulp_tolerance(want), want)
        t = compare_times(lambda: ln.add_layer_norm(x, y, w, b, 1e-6),
                          lambda: ln.add_layer_norm_plain(x, y, w, b, 1e-6))
        wb, bb = w.bfloat16(), b.bfloat16()
        two = device_ms(lambda: ln.fused_layer_norm(x + y, w, b, 1e-6))
        lib = device_ms(lambda: F.layer_norm(x + y, (d,), wb, bb, 1e-6))
        copies = -(-2 * L2_BYTES // (2 * x.nbytes))
        xys = [(x + i, y - i) for i in range(copies)]
        cold = cold_ms(lambda xy: ln.add_layer_norm(xy[0], xy[1], w, b,
                                                    1e-6), xys)
        two_cold = cold_ms(lambda xy: ln.fused_layer_norm(xy[0] + xy[1], w,
                                                          b, 1e-6), xys)
        lib_cold = cold_ms(lambda xy: F.layer_norm(xy[0] + xy[1], (d,), wb,
                                                   bb, 1e-6), xys)
        del xys
        # x and y read, r and LN(r) written (bf16); ~9 f32 operations an
        # element (the add and kernel L's 8)
        bnd = bound({"f32": 9 * rows * d}, 8 * rows * d + 8 * d)
        check(ok, f"({rows}, {d}): r equal, max_abs_err {err:.3e}; "
                  f"{timing_text(t)}; two-call form {two:.4f} ms, "
                  f"F.layer_norm(x + y) {lib:.4f} ms; cold (x and y in {copies} "
                  f"copies): kernel {cold:.4f} ms, two-call {two_cold:.4f} "
                  f"ms, F.layer_norm(x + y) {lib_cold:.4f} ms; "
                  f"{bound_text(bnd)}")
        out[d] = dict(ms=t["device"][0], plain_ms=t["device"][1],
                      cold_ms=cold, library_ms=lib, two_call_ms=two,
                      bound=bnd, max_abs_err=err,
                      shape=f"({rows}, {d}) bf16")
    return out


def packed_qkv(b, n, gen, dev, embed=EMBED):
    """(B, N, 3 * embed) bf16: q and k drawn N(0, 1) * 2 so softmax rows are
    peaked, v drawn N(0, 1). Scaling v would only scale the output and its
    absolute error: the kernel and the plain version each round p to bf16,
    and a one-ulp difference on a large p moves the output by ~2**-8 |v|."""
    qkv = torch.randn(b, n, 3 * embed, generator=gen, device=dev)
    qkv[..., :2 * embed] *= 2
    return qkv.bfloat16()


def phase_attention(dev):
    from stego_torch.ops import flash_attention as fa

    import torch.nn.functional as F

    print(f"kernel A (attention), token-major, vs plain, bf16, d={HEAD_DIM}, "
          f"q, k ~ N(0, 4), v ~ N(0, 1), rtol {ATTN_RTOL} atol {ATTN_ATOL}; "
          f"library: F.scaled_dot_product_attention on (B, H, N, d)")
    g = torch.Generator(device=dev).manual_seed(1)
    worst, by_shape = 0.0, {}
    for b, n, heads in ATTN_SHAPES:
        embed = heads * HEAD_DIM
        # q, k, v as the column blocks of one packed qkv, as in the trunk
        q, k, v = packed_qkv(b, n, g, dev, embed).split(embed, dim=-1)
        scale = HEAD_DIM ** -0.5
        got = fa.token_major_attention(q, k, v, heads, scale)
        torch.cuda.synchronize()
        want = fa.attention_plain(q, k, v, heads, scale)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        worst = max(worst, err)
        ok = within(diff, ATTN_ATOL + ATTN_RTOL * want.float().abs(), want)
        t = compare_times(
            lambda: fa.token_major_attention(q, k, v, heads, scale),
            lambda: fa.attention_plain(q, k, v, heads, scale))
        qh, kh, vh = (x.reshape(b, n, heads, HEAD_DIM).transpose(1, 2)
                      .contiguous() for x in (q, k, v))
        # q k^T and p v: 4 N^2 d bf16 operations a head; q, k, v, out once
        bnd = bound({"bf16": 4 * b * heads * n * n * HEAD_DIM},
                    4 * b * n * embed * 2)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), floor_ms=bnd[0])
        check(ok, f"(B={b}, N={n}, H={heads}): max_abs_err {err:.3e}; "
                  f"{timing_text(t)}; F.scaled_dot_product_attention "
                  f"{lib:.4f} ms (kernel / SDPA {t['device'][0] / lib:.2f}); "
                  f"{bound_text(bnd)}")
        by_shape[(b, n, heads)] = dict(
            ms=t["device"][0], plain_ms=t["device"][1], library_ms=lib,
            bound=bnd, max_abs_err=err,
            shape=f"B={b} N={n} H={heads} d={HEAD_DIM} bf16")
    return worst, by_shape


def phase_layouts(dev):
    """The attention layout ladder (stego_torch/tools/attention_layouts.py,
    the counterpart of scripts/bench_attncore.py and bench_attn_vitb.py)
    for LAYOUT_MODELS: every rung's core on the first sublayer against its
    plain version (rtol ATTN_RTOL, atol ATTN_ATOL; no softmax: two bf16 ulps
    of its largest output), then the timed chains, the main path of kernel
    A's resident, flash, no_softmax and packed forms and of L2: each chain
    must launch its rung's entry of kernel A 12 times and L 13 times (the
    fused rungs: L2 12 times and L once). Returns {model: launches}."""
    from stego_torch.tools import attention_layouts as al

    errors = {}
    for model in LAYOUT_MODELS:
        errors[model] = al.ladder_errors(model, LAYOUT_BATCH, LAYOUT_TOKENS,
                                         dev)
        for rung, e in errors[model].items():
            if e["worst_ratio_plain"] is not None:
                check(e["worst_ratio_plain"] <= 1,
                      f"ladder {model}, {rung}: core vs its plain version "
                      f"max_abs_err {e['max_abs_err_plain']:.3e}, worst "
                      f"error / tolerance {e['worst_ratio_plain']:.3f}")
    torch.cuda.synchronize()
    out = {}
    for model in LAYOUT_MODELS:
        reset_counts()  # the main path: every launch of the chains counts
        rows = al.run_ladder(model, LAYOUT_BATCH, LAYOUT_TOKENS,
                             LAYOUT_ITERS, dev)
        out[model] = path_counts()
        al.print_ladder(model, rows, errors[model], LAYOUT_BATCH,
                        LAYOUT_TOKENS)
        for r in rows:
            want = {"layer_norm": 13}
            if r["rung"] in RUNG_ENTRY:
                want[RUNG_ENTRY[r["rung"]]] = 12
            if "fused" in r["rung"]:
                want.update(layer_norm=1, add_layer_norm=12)
            check(r["launches"] == want,
                  f"ladder {model}, {r['rung']}: {r['ms']:.3f} ms a chain; "
                  f"launches a chain {r['launches']}")
    return out


def phase_head_major(dev):
    """Every head-major form of kernel A (A3: batch_resident, kv_resident,
    resident; A4: flash, packed; S: no_softmax) against its plain version
    at ViT-T's shapes (packed at ViT-S's: it takes an even head count), on
    views of one packed qkv, and timed beside SDPA. Returns {entry: [the
    result at each shape]}."""
    import torch.nn.functional as F

    from stego_torch.ops import flash_attention as fa

    print(f"kernel A, head-major forms vs plain, bf16, d={HEAD_DIM}, views "
          f"of a packed qkv, q, k ~ N(0, 4), v ~ N(0, 1); rtol {ATTN_RTOL} "
          f"atol {ATTN_ATOL} (no_softmax: two bf16 ulps of its largest "
          f"output); library: F.scaled_dot_product_attention on (B, H, N, d) "
          f"(none for no_softmax)")
    scale = HEAD_DIM ** -0.5
    out = {}
    for entry, (b, h, n) in HEAD_MAJOR_CASES:
        g = torch.Generator(device=dev).manual_seed(b * n + h)
        qkv = torch.randn(b, n, 3, h, HEAD_DIM, generator=g, device=dev)
        qkv[:, :, :2] *= 2
        qkv = qkv.bfloat16()
        q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
        if entry == "packed":
            packed = qkv.flatten(3)

            def kernel():
                return fa.packed_attention(packed, h, scale)

            def plain():
                return fa.packed_attention(packed, h, scale,
                                           use_kernel=False)
        else:
            fn = getattr(fa, f"{entry}_attention")

            def kernel(fn=fn):
                return fn(q, k, v, scale)

            def plain(fn=fn):
                return fn(q, k, v, scale, use_kernel=False)
        got = kernel()
        torch.cuda.synchronize()
        want = plain().float()
        diff = (got.float() - want).abs()
        tol = (torch.full_like(want, 2 ** -7 * float(want.abs().max()))
               if entry == "no_softmax" else ATTN_ATOL + ATTN_RTOL * want.abs())
        ok = within(diff, tol, want)
        t = compare_times(kernel, plain)
        lib = None
        bnd = bound({"bf16": 4 * b * h * n * n * HEAD_DIM},
                    4 * b * n * h * HEAD_DIM * 2)
        if entry != "no_softmax":
            qh, kh, vh = (x.contiguous() for x in (q, k, v))
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, scale=scale), floor_ms=bnd[0])
        lib_text = "" if lib is None else \
            f"; SDPA {lib:.4f} ms (kernel / SDPA {t['device'][0] / lib:.2f})"
        check(ok, f"{entry} (B={b}, H={h}, N={n}): max_abs_err "
                  f"{float(diff.max()):.3e}; {timing_text(t)}{lib_text}; "
                  f"{bound_text(bnd)}")
        out.setdefault(entry, []).append(dict(
            shape=f"B={b} H={h} N={n} d={HEAD_DIM} bf16",
            max_abs_err=float(diff.max()), ms=t["device"][0],
            plain_ms=t["device"][1], library_ms=lib, bound=bnd))
    return out


def phase_attention_f32(dev):
    """A-f32, kernel A's f32 instantiation, against its plain versions at
    F32_RTOL / F32_ATOL (no_softmax: F32_RTOL of its largest output, a sum
    of N unnormalised products), TF32 off for matmuls and cuDNN: the
    two-pass form token-major at ViT-S's shape (the f32 trunk's path) and
    every head-major form at ViT-T's, each timed beside f32 SDPA (none for
    no_softmax) and the f32 bound. Returns the token-major result with the
    head-major ones under "forms"."""
    import torch.nn.functional as F

    from stego_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stego_torch.ops import tf32

    print(f"kernel A-f32 (attention on f32 q/k/v, 3xTF32 on the tensor "
          f"cores) vs plain, d={HEAD_DIM}, q, k ~ N(0, 4), v ~ N(0, 1); rtol "
          f"{F32_RTOL} atol {F32_ATOL}; library: f32 "
          f"F.scaled_dot_product_attention; TF32 off; control: the plain "
          f"version with one TF32 pass a product (ops/tf32.py) must fail")
    scale = HEAD_DIM ** -0.5
    results = {}
    for form, (b, h, n) in (("two_pass", (8, 6, 785)),
                            ("batch_resident", (8, 3, 785)),
                            ("resident", (8, 3, 785)),
                            ("flash", (8, 3, 785)),
                            ("no_softmax", (8, 3, 785))):
        g = torch.Generator(device=dev).manual_seed(7 * n + h)
        qkv = torch.randn(b, n, 3, h, HEAD_DIM, generator=g, device=dev)
        qkv[:, :, :2] *= 2
        if form == "two_pass":  # token-major column blocks, as the trunk's
            q, k, v = (x.flatten(2) for x in qkv.unbind(2))

            def kernel():
                return fa.token_major_attention(q, k, v, h, scale)

            def plain(matmul=torch.matmul):
                return fa.attention_plain(q, k, v, h, scale, matmul=matmul)
        else:
            q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
            fn = getattr(fa, f"{form}_attention")

            def kernel(fn=fn):
                return fn(q, k, v, scale)

            def plain(matmul=torch.matmul, form=FORM_OF.get(form, form)):
                return fa.attention_heads_plain(q, k, v, scale, form,
                                                matmul=matmul)
        before = fa.F32_LAUNCHES
        got = kernel()
        torch.cuda.synchronize()
        launched = fa.F32_LAUNCHES - before
        want = plain()
        diff = (got - want).abs()
        tol = (torch.full_like(want, F32_RTOL * float(want.abs().max()))
               if form == "no_softmax" else F32_ATOL + F32_RTOL * want.abs())
        ok = within(diff, tol, want) and launched == 1
        ctl = (plain(tf32.matmul_tf32) - want).abs()
        check(bool((ctl > tol).any()),
              f"control, A-f32 {form} by its plain version with one TF32 "
              f"pass a product: max_abs_err {float(ctl.max()):.3e}, "
              f"{int((ctl > tol).sum())} of {ctl.numel()} elements out of "
              f"the gate (must fail)")
        t = compare_times(kernel, plain)
        flops = 4 * b * h * n * n * HEAD_DIM
        nbytes = 4 * b * n * h * HEAD_DIM * 4
        # every form at the 3xTF32 rate, no_softmax too, though its kernel
        # stays on f32 FMA (csrc/attention.cu says why)
        bnd = bound({"tf32x3": flops}, nbytes)
        fma = bound({"f32": flops}, nbytes)
        lib = None
        if form != "no_softmax":
            qh, kh, vh = (x.reshape(b, n, h, HEAD_DIM).transpose(1, 2)
                          .contiguous() for x in qkv.unbind(2))
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, scale=scale), floor_ms=0.0)
        lib_text = "" if lib is None else \
            f"; f32 SDPA {lib:.4f} ms (kernel / SDPA {t['device'][0] / lib:.2f})"
        layout = "token-major" if form == "two_pass" else "head-major"
        check(ok, f"A-f32 {form}, {layout} (B={b}, H={h}, N={n}): "
                  f"max_abs_err {float(diff.max()):.3e}, {launched} f32 "
                  f"launch; {timing_text(t)}{lib_text}; {bound_text(bnd)}; "
                  f"at f32 FMA {fma[0]:.4f} ms")
        results[form] = dict(
            shape=f"B={b} H={h} N={n} d={HEAD_DIM} f32 {layout}",
            max_abs_err=float(diff.max()), ms=t["device"][0],
            plain_ms=t["device"][1], library_ms=lib, bound=bnd)
    out = results.pop("two_pass")
    out["forms"] = {
        form: {**{k: v for k, v in r.items() if k != "bound"},
               "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
        for form, r in results.items()}
    return out


def phase_wide(dev):
    """Train paths at shapes the parent's kernels refused, each step
    launching exactly its kernels, one step held against its plain
    version (train_run's gates; 3 steps, no loss-fall gate): the sampled
    loss at dim=100, feature_samples=12 (C1 with two code chunks and two
    sample tiles a side) and the full-field loss at dim=160 (C2 with two
    code chunks), each with the parameter gate of the other train runs;
    and an f32 ViT-S/8 trunk with use_flash_attention (A-f32, 12 launches a
    step; LayerNorm plain, as in JAX) with the sampled loss (C1 on f32
    features), held against the same step with no kernel. A-f32 differs
    from its plain version by up to 2e-5 and the trunk carries that
    through 12 blocks, and Adam's first step moves a parameter by
    lr g / (|g| + 1e-8), so a gradient difference of a rounding below
    ~ADAM_LIVE moves a parameter by more than the parameter tolerance:
    that step holds the updated parameters where |g| >= ADAM_LIVE and the
    gradients everywhere, |g_kernel - g_plain| / |g_plain| within
    F32_TRUNK_GRAD_GAP, and two controls must fail that gradient gate: the
    same step with the trunk's attention computed by its plain version in
    TF32 and on bf16-rounded q, k, v (ATTENTION_CONTROLS). The launches of
    each run."""
    runs = {}
    _, _, runs["cc100_s144"] = train_run(
        dev, "sampled loss (kernel C1), dim=100, 12x12 samples", 3, (0,),
        (12, 25, 1, 1, 0, 0), None, **WIDE_C1)
    _, _, runs["cc160"] = train_run(
        dev, f"full-field loss (kernel C2), dim={WIDE_C2_DIM}", 3, (0,),
        (12, 25, 0, 0, 1, 1), None, full_field_loss=True, dim=WIDE_C2_DIM)
    _, _, runs["f32_trunk"] = train_run(
        dev, "sampled loss (kernel C1 on f32 features), use_flash_attention "
        "(kernel A-f32)", 3, (0,), (12, 0, 1, 1, 0, 0), None,
        backbone_dtype="float32", use_flash_attention=True,
        adam_live=ADAM_LIVE, grad_gap_max=F32_TRUNK_GRAD_GAP,
        controls=ATTENTION_CONTROLS)
    return runs


def tf32_attention(q, k, v, heads, scale):
    """The trunk's token-major attention by its plain version with TF32
    matmuls (10-bit mantissas): a control of the f32-trunk step's gate."""
    from stego_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fa.attention_plain(q, k, v, heads, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def bf16_attention(q, k, v, heads, scale):
    """The trunk's token-major attention by its plain version on
    bf16-rounded q, k, v, back in f32: a control of the f32-trunk step's
    gate."""
    from stego_torch.ops import flash_attention as fa

    return fa.attention_plain(*(x.bfloat16() for x in (q, k, v)), heads,
                              scale).float()


# the f32-trunk step's controls: its attention replaced, each must fail the
# step's gradient gate ({name: (module, attribute, the replacement of the
# attribute's function)})
ATTENTION_CONTROLS = {
    "TF32 attention": ("stego_torch.models.vit", "token_major_attention",
                       lambda kept: tf32_attention),
    "bf16 attention": ("stego_torch.models.vit", "token_major_attention",
                       lambda kept: bf16_attention)}
# the feature-pyramid steps' controls, each must fail their gradient gate:
# the code gradient of C2's backward (C1's backward runs it too) scaled by
# 1 + 1e-3, which Adam's first step does not see (it moves a parameter by
# lr g / (|g| + 1e-8)); and C1's adjoint on bf16-rounded tap weights
SCALED_CODE_GRADIENT = {"C2's code gradient x (1 + 1e-3)": (
    "stego_torch.ops.corr_stream", "backward_launch",
    lambda kept: lambda *a, **kw: kept(*a, **kw) * (1 + 1e-3))}
C1_CONTROLS = {**SCALED_CODE_GRADIENT, "C1's adjoint on bf16 tap weights": (
    "stego_torch.ops.corr_fused_sampling", "adjoint_launch",
    lambda kept: lambda lib, dsets, csets, norms, keys, wts, *rest: kept(
        lib, dsets, csets, norms, keys, wts.bfloat16().float(), *rest))}


def images(gen, res, dev, batch=BATCH):
    """A batch of random [0, 1] images, ImageNet-normalized, NHWC."""
    from stego_torch.data.transforms import channel_stats

    mean, std = (torch.as_tensor(s, device=dev) for s in channel_stats(3))
    img01 = torch.rand(batch, res, res, 3, generator=gen, device=dev)
    return (img01 - mean) / std


MODEL_NAMES = {"vit_tiny": "ViT-T/8", "vit_small": "ViT-S/8",
               "vit_base": "ViT-B/8", "resnet50": "ResNet-50 FPN"}


def trunk_entry(model_type, res):
    """Kernel A's entry point in the /8 trunk of ``model_type`` at ``res``:
    token-major (pair, pair_kv) for an even head count, else head-major
    (batch_resident, kv_resident), each by N as the JAX trunk."""
    from stego_torch.models.vit import VIT_CONFIGS
    from stego_torch.ops.flash_attention import attention_entry

    vit = VIT_CONFIGS[model_type][8]
    return attention_entry(vit.num_heads, vit.head_dim, (res // 8) ** 2 + 1)


def phase_slice(dev, tmp, model_type="vit_small"):
    from stego_torch.config import Config
    from stego_torch.eval.evaluate import (flip_tta_code, load_model_for_eval,
                                           make_eval_step)
    from stego_torch.models import convert
    from stego_torch.train.segmenter import UnsupervisedSegmenter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"slice: seeded {MODEL_NAMES[model_type]} segmenter, cocostuff27 "
          f"head, bf16 trunk")
    cfg = Config(dataset_name="cocostuff27", model_type=model_type,
                 dino_patch_size=8, dim=70, projection_type="nonlinear",
                 backbone_dtype="bfloat16", run_crf=False)
    seeded = UnsupervisedSegmenter(27, cfg,
                                   generator=torch.Generator().manual_seed(0))
    path = os.path.join(tmp, f"{model_type}_8_seed0.ckpt")
    convert.save_stego_checkpoint(path, seeded)
    loaded = convert.load_stego_checkpoint(path)
    want = seeded.state_dict()
    check(loaded.cfg == cfg and loaded.state_dict().keys() == want.keys()
          and all(torch.equal(v, want[k])
                  for k, v in loaded.state_dict().items()),
          "round trip through save/load_stego_checkpoint: tensors equal")
    again = convert.from_jax_params(*convert.to_jax_params(seeded), cfg)
    check(all(torch.equal(v, want[k]) for k, v in again.state_dict().items()),
          "round trip through to/from_jax_params: tensors equal")

    seg = load_model_for_eval(path, dev)
    step = make_eval_step(seg, run_crf=False)
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = {res: [images(gen, res, dev) for _ in range(REQUESTS)]
               for res in RESOLUTIONS}
    torch.cuda.synchronize()

    # the main path: every launch from here to the read below is counted
    reset_counts()
    served = {}
    for res, imgs in batches.items():
        entry = trunk_entry(model_type, res)
        for img in imgs:
            before = path_counts()
            t0 = time.perf_counter()
            preds = step(img, img[..., 0])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            served.setdefault(res, []).append((ms, preds))
            delta = {k: v - before[k] for k, v in path_counts().items()}
            check(delta == launches_of(ATTN_PER_REQUEST, LN_PER_REQUEST,
                                       entry),
                  f"res {res} request: {ms:.2f} ms, attention launches "
                  f"{delta['attention']} ({entry}: "
                  f"{delta['attention_' + entry]}), layer_norm launches "
                  f"{delta['layer_norm']}")
    launches = path_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    for res, runs in served.items():
        med = statistics.median(ms for ms, _ in runs)
        img = batches[res][-1]
        by_kernel = kernel_times(lambda: step(img, img[..., 0]))
        busy = sum(by_kernel.values()) / 1e3
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        print(f"  res {res}: median {med:.2f} ms per request of {BATCH}, "
              f"{BATCH / med * 1e3:.1f} images/s; device busy {busy:.3f} ms "
              f"a request ({busy / med:.0%} of the median)")
        for name, us in top:
            print(f"    {us / 1e3:8.3f} ms  {name[:90]}")
        with torch.inference_mode():
            code = flip_tta_code(seg, img)
            seg.net.model.use_kernels = False
            plain_code = flip_tta_code(seg, img)
            plain_preds = step(img, img[..., 0])
            seg.net.model.use_kernels = True
        hp = res // seg.vit_cfg.patch_size
        check(code.shape == (BATCH, hp, hp, 70)
              and bool(torch.isfinite(code).all()),
              f"res {res}: code {tuple(code.shape)} f32, finite")
        diff = (code - plain_code).abs()
        check(float(diff.max()) <= CODE_MAX_ABS
              and float(diff.mean()) <= CODE_MEAN_ABS,
              f"res {res}: code vs plain versions: max abs "
              f"{float(diff.max()):.3e} (<= {CODE_MAX_ABS}), mean abs "
              f"{float(diff.mean()):.3e} (<= {CODE_MEAN_ABS})")
        for name, got, want_p in zip(("linear", "cluster"), runs[-1][1],
                                     plain_preds):
            agree = float((got == want_p).float().mean())
            check(got.shape == (BATCH, res, res) and got.dtype == torch.int32
                  and int(got.min()) >= 0 and int(got.max()) < 27
                  and agree >= PRED_AGREE,
                  f"res {res}: {name} predictions {tuple(got.shape)}, "
                  f"agree with plain on {agree:.4%} (>= {PRED_AGREE:.0%})")
    print(f"  peak device memory {peak_gb:.2f} GiB")
    return launches


# phase serve: (label, model_type, trunk dtype, res) of each artifact that
# python -m stego_torch.serve's package() makes from a phase-3 checkpoint;
# SERVE_TIMED is timed and also serves SERVE_BATCHES[1]; a load with
# device="cpu" predicts the first SERVE_CPU_IMAGES[label] images
SERVE_CASES = (("vit_small_320", "vit_small", "bfloat16", 320),
               ("vit_small_224", "vit_small", "bfloat16", 224),
               ("vit_tiny_320", "vit_tiny", "bfloat16", 320),
               ("vit_small_f32_224", "vit_small", "float32", 224))
SERVE_TIMED, SERVE_BATCHES, SERVE_ITERS = "vit_small_320", (BATCH, 5), 6
SERVE_CPU_IMAGES = {"vit_small_224": 1, "vit_tiny_320": 1,
                    "vit_small_f32_224": 1}
# f32 artifact, card against CPU: log-probs within SERVE_F32_ATOL and
# predictions equal where the top-two margin exceeds SERVE_F32_MARGIN (the
# f32 tolerances the port's CPU tests hold its eval and serving to against
# the JAX package); bf16: PRED_AGREE where the margin exceeds
# SERVE_BF16_MARGIN
SERVE_F32_ATOL, SERVE_F32_MARGIN, SERVE_BF16_MARGIN = 1e-4, 1e-3, 5e-2
# the n_devices artifact of SERVE_TIMED's checkpoint: its shards, served on
# that many cards where the machine has them, else all on cuda:0
SERVE_SHARDS = 2
# the modules a serving process must not import: the model code
MODEL_CODE = ("stego_torch.models", "stego_torch.train", "stego_torch.eval",
              "stego_torch.data", "stego_torch.config")


def serve_child(args) -> int:
    """``chip_smoke.py --serve-child <json>``: a fresh process that loads
    one artifact with ServingModel.load (cuda:0), predicts each batch of
    ``batches`` from the saved images, counting the launches of each
    predict, times it when asked (once the file ``go`` exists) and, when
    ``cpu_images`` is not 0, loads it again with device="cpu" and predicts
    that many images; writes the outputs to ``out`` (npz) and prints one
    JSON line."""
    opts = json.loads(args[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stego_torch.serve import ServingModel

    t0 = time.perf_counter()
    model = ServingModel.load(opts["artifact"])
    load_s = time.perf_counter() - t0
    img = np.load(opts["images"])
    report = {"load_s": load_s, "launches": {}}
    outputs = {}
    for b in opts["batches"]:
        torch.cuda.synchronize()
        reset_counts()
        out = model.predict(img[:b])
        report["launches"][str(b)] = path_counts()
        outputs.update({f"{k}_{b}": v for k, v in out.items()})
    report["model_code"] = sorted(
        m for m in sys.modules if m.startswith(MODEL_CODE))
    if opts["timed"]:
        waited = 0.0
        while not os.path.exists(opts["go"]) and waited < 300:
            time.sleep(0.05)
            waited += 0.05
        x = torch.from_numpy(img).to(model.device)

        def program():
            with torch.no_grad():
                return model.module(x)

        def wall_ms(fn):
            out = []
            for _ in range(SERVE_ITERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(out)

        program()
        report["predict_ms"] = wall_ms(lambda: model.predict(img))
        report["program_ms"] = wall_ms(program)
        by_kernel = kernel_times(program)
        report["device_ms"] = sum(by_kernel.values()) / 1e3
        report["top"] = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    if opts["cpu_images"]:
        t0 = time.perf_counter()
        on_cpu = ServingModel.load(opts["artifact"], devices=["cpu"])
        report["cpu_load_s"] = time.perf_counter() - t0
        report["cpu_devices"] = sorted(
            {str(p.device) for p in on_cpu.module.parameters()}
            | {str(n.kwargs["device"]) for n in on_cpu.module.graph.nodes
               if "device" in n.kwargs})
        t0 = time.perf_counter()
        out = on_cpu.predict(img[:opts["cpu_images"]])
        report["cpu_predict_s"] = time.perf_counter() - t0
        outputs.update({f"{k}_cpu": v for k, v in out.items()})
    np.savez(opts["out"], **outputs)
    print(json.dumps(report))
    return 0


def margin(log_probs):
    """Top-1 minus top-2 of log-probs along the last axis."""
    top = torch.topk(log_probs, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def serve_agreement(label, got, want, f32):
    """``got`` (a CPU load's outputs) against ``want`` (the card's): f32 by
    SERVE_F32_ATOL and SERVE_F32_MARGIN, bf16 by PRED_AGREE where the
    margin exceeds SERVE_BF16_MARGIN."""
    for probe in ("linear", "cluster"):
        lp, wp = (torch.from_numpy(o[f"{probe}_probs"]) for o in (got, want))
        g, w = (torch.from_numpy(o[f"{probe}_preds"]) for o in (got, want))
        m = margin(wp)
        err = float((lp - wp).abs().max())
        same = float((g == w).float().mean())
        if f32:
            sure = m > SERVE_F32_MARGIN
            check(err <= SERVE_F32_ATOL and bool((g == w)[sure].all()),
                  f"{label} {probe}: CPU vs card log-probs max abs "
                  f"{err:.3e} (<= {SERVE_F32_ATOL}), predictions equal on "
                  f"the {float(sure.float().mean()):.2%} of pixels with a "
                  f"margin > {SERVE_F32_MARGIN} ({same:.4%} of all)")
        else:
            sure = m > SERVE_BF16_MARGIN
            agree = float((g == w)[sure].float().mean())
            check(float(sure.float().mean()) > 0.5 and agree >= PRED_AGREE,
                  f"{label} {probe}: CPU vs card predictions agree on "
                  f"{agree:.4%} (>= {PRED_AGREE:.0%}) of the "
                  f"{float(sure.float().mean()):.2%} of pixels with a margin "
                  f"> {SERVE_BF16_MARGIN}; log-probs max abs {err:.3e}")


def op_host_us(dev):
    """Host microseconds a call, op route against the direct call, for
    kernel L at ViT-S's (8 x 1601, 384) and kernel A at ViT-S's token-major
    (8, 1601, 384) q/k/v: 200 calls enqueued, the host's clock around them
    (the card runs behind)."""
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(8, 1601, 384, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    w = torch.ones(384, device=dev)
    b = torch.zeros(384, device=dev)
    qkv = torch.randn(8, 1601, 3 * 384, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = qkv.split(384, dim=-1)
    calls = {
        "L direct": lambda: ln.fused_layer_norm(x, w, b, 1e-6),
        "L op": lambda: ln.layer_norm_op(x, w, b, 1e-6),
        "A direct": lambda: fa.token_major_attention(q, k, v, 6, 0.125),
        "A op": lambda: fa.attention_op(q, k, v, 6, 0.125),
    }
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            out[name] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
    return out


def package_shards(case, tmp):
    """An n_devices=SERVE_SHARDS artifact of ``case``'s checkpoint (phase
    serve's SERVE_TIMED), packaged on the card: its directory and the
    packaging's seconds."""
    from stego_torch import serve

    t0 = time.perf_counter()
    art = serve.package(case["ckpt"], os.path.join(tmp, "serve_shards"),
                        res=case["res"], batch_size=BATCH,
                        n_devices=SERVE_SHARDS)
    return art, time.perf_counter() - t0


def serve_n_devices(case, art, pack_s):
    """The n_devices=SERVE_SHARDS artifact ``art`` of ``case``'s checkpoint
    (package_shards; phase serve's SERVE_TIMED), loaded in this process
    on its default devices where the machine has SERVE_SHARDS cards, else
    on [cuda:0] * SERVE_SHARDS after a default-devices load, which must
    raise. Gates: its predict of the case's BATCH images equals the
    one-device artifact's predict of each shard bit for bit, and kernels
    A and L launch one request's count on each shard's card. On two cards
    it prints the predict's time beside the one-device artifact's on the
    whole batch. Returns the predict's launches."""
    from stego_torch import serve
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln

    n, cards = SERVE_SHARDS, torch.cuda.device_count()
    if cards >= n:
        model = serve.ServingModel.load(art)
        where = f"on cuda:0 .. cuda:{n - 1}"
    else:
        try:
            serve.ServingModel.load(art)
            raised = "nothing"
        except RuntimeError as e:
            raised = str(e)
        check(f"needs {n} CUDA devices, have {cards}" in raised,
              f"serve n_devices={n}: a default-devices load on {cards} "
              f"card raises: {raised}")
        model = serve.ServingModel.load(art, devices=["cuda:0"] * n)
        where = (f"on [cuda:0] * {n} ({cards} card: its time is no scaling "
                 f"number and is not printed)")
    one = serve.ServingModel.load(case["art"])
    img = case["img"]
    torch.cuda.synchronize()
    reset_counts()
    got = model.predict(img)
    launches = path_counts()
    by_card = (dict(fa.DEVICE_LAUNCHES), dict(ln.DEVICE_LAUNCHES))
    per = len(img) // n
    same = True
    for s in range(n):
        want = one.predict(img[s * per:(s + 1) * per])
        same &= all(np.array_equal(got[k][s * per:(s + 1) * per], want[k])
                    for k in serve.OUTPUT_KEYS)
    cards_used = sorted({d.index for d in model.devices})
    share = n // len(cards_used)
    want_by_card = tuple({i: share * c for i in cards_used}
                         for c in (ATTN_PER_REQUEST, LN_PER_REQUEST))
    check(same and model.meta["n_devices"] == n and by_card == want_by_card,
          f"serve n_devices={n} ({case['res']}, packaged in {pack_s:.2f} s) "
          f"{where}: predict of {len(img)} equals the one-device "
          f"artifact's on each shard of {per} bit for bit; attention "
          f"launches by card {by_card[0]}, layer_norm {by_card[1]}")
    if cards >= n:
        def wall_ms(fn):
            out = []
            fn()
            for _ in range(SERVE_ITERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                out.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(out)

        print(f"  serve n_devices={n}: predict() of {len(img)} on {n} cards "
              f"{wall_ms(lambda: model.predict(img)):.3f} ms, the one-device"
              f" artifact on cuda:0 {wall_ms(lambda: one.predict(img)):.3f}"
              f" ms (median of {SERVE_ITERS}, host arrays in and out)")
    return launches


def phase_serve(dev, tmp):
    """The serving path (stego_torch/serve.py): package() of phase 3's
    checkpoints (and an f32-trunk one of the same seeded ViT-S/8) on the
    card, each artifact loaded in a fresh python3 process (no model code)
    that predicts with it; gates: exact launches a predict, the outputs
    equal to the eager serving module's on the same batch bit for bit, the
    same artifact loaded on the CPU against the card. The untimed
    processes run beside the next packaging; the timed one runs alone.
    Returns the launches of the gated predicts, by model type."""
    from stego_torch import serve
    from stego_torch.config import Config
    from stego_torch.eval.evaluate import load_model_for_eval
    from stego_torch.models import convert
    from stego_torch.train.segmenter import UnsupervisedSegmenter

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("serve: package() of phase 3's checkpoints on the card, each "
          "artifact served from a fresh process")
    f32_ckpt = os.path.join(tmp, "vit_small_8_seed0_f32.ckpt")
    convert.save_stego_checkpoint(f32_ckpt, UnsupervisedSegmenter(
        27, Config(dataset_name="cocostuff27", model_type="vit_small",
                   dino_patch_size=8, dim=70, projection_type="nonlinear",
                   backbone_dtype="float32", use_flash_attention=True,
                   run_crf=False),
        generator=torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(3)
    cases = {}

    def package(label, model_type, dtype, res):
        """Package the case's checkpoint and save its images."""
        ckpt = f32_ckpt if dtype == "float32" else os.path.join(
            tmp, f"{model_type}_8_seed0.ckpt")
        art = os.path.join(tmp, f"serve_{label}")
        t0 = time.perf_counter()
        serve.package(ckpt, art, res=res, batch_size=BATCH)
        pack_s = time.perf_counter() - t0
        img = rng.random((BATCH, res, res, 3), dtype=np.float32)
        path = os.path.join(tmp, label)
        np.save(path + ".npy", img)
        timed = label == SERVE_TIMED
        opts = {"artifact": art, "images": path + ".npy",
                "out": path + ".npz", "go": path + ".go",
                "batches": SERVE_BATCHES if timed else SERVE_BATCHES[:1],
                "timed": timed, "cpu_images": SERVE_CPU_IMAGES.get(label, 0)}
        cases[label] = dict(model_type=model_type, f32=dtype == "float32",
                            res=res, ckpt=ckpt, art=art, img=img, path=path,
                            opts=opts, pack_s=pack_s)

    def launch(label):
        """Start the case's serving process."""
        c = cases[label]
        with open(c["path"] + ".log", "w") as log:
            c["proc"] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--serve-child",
                 json.dumps(c["opts"])], stdout=log,
                stderr=subprocess.STDOUT, text=True)
        c["t0"] = time.perf_counter()

    def finish(label):
        """Wait for the case's process and hold its outputs; the launches
        of its gated predicts."""
        c = cases[label]
        rc = c["proc"].wait(timeout=600)
        child_s = time.perf_counter() - c["t0"]
        with open(c["path"] + ".log") as log:
            lines = log.read().strip().splitlines()
        if not check(rc == 0, f"{label}: serving process exit code {rc}"):
            print("\n".join(lines[-30:]))
            return []
        report = json.loads(lines[-1])
        got = dict(np.load(c["path"] + ".npz"))
        mb = os.path.getsize(os.path.join(c["art"], serve.MODEL_FILE)) / 2**20
        n_cpu = c["opts"]["cpu_images"]
        cpu = (f"; CPU load {report['cpu_load_s']:.2f} s, CPU predict of "
               f"{n_cpu} {report['cpu_predict_s']:.2f} s" if n_cpu else "")
        print(f"  {label}: packaged in {c['pack_s']:.2f} s ({mb:.1f} MiB "
              f"model.pt2), serving process {child_s:.1f} s (load "
              f"{report['load_s']:.2f} s{cpu})")
        check(report["model_code"] == [],
              f"{label}: the serving process imported no model code "
              f"{report['model_code']}")
        res, f32 = c["res"], c["f32"]
        entry = trunk_entry(c["model_type"], res)
        want_launches = launches_of(ATTN_PER_REQUEST,
                                    0 if f32 else LN_PER_REQUEST, entry,
                                    f32=f32)
        seg = load_model_for_eval(c["ckpt"], dev)
        c["fn"] = fn = serve.ServeFn(seg).eval()
        runs = []
        for b in c["opts"]["batches"]:
            n = report["launches"][str(b)]
            check(n == want_launches,
                  f"{label}: predict of {b}: attention launches "
                  f"{n['attention']} ({entry}: {n['attention_' + entry]}, "
                  f"f32 {n['attention_f32']}), layer_norm launches "
                  f"{n['layer_norm']}")
            runs.append(n)
            with torch.no_grad():
                want = fn(torch.from_numpy(c["img"][:b]).to(dev))
            same = {k: bool(np.array_equal(got[f"{k}_{b}"],
                                           want[k].cpu().numpy()))
                    for k in serve.OUTPUT_KEYS}
            shapes = {k: (got[f"{k}_{b}"].shape, str(got[f"{k}_{b}"].dtype))
                      for k in serve.OUTPUT_KEYS}
            check(all(same.values())
                  and shapes["linear_probs"][0] == (b, res, res, 27)
                  and shapes["linear_preds"] == ((b, res, res), "int32"),
                  f"{label}: predict of {b} equals the eager serving module "
                  f"bit for bit {same}; {shapes['linear_probs']}, "
                  f"{shapes['linear_preds']}")
        if n_cpu:
            check(report["cpu_devices"] == ["cpu"],
                  f"{label}: device=\"cpu\" load: the weights and the "
                  f"devices traced into the graph moved to "
                  f"{report['cpu_devices']}")
            keys = serve.OUTPUT_KEYS
            serve_agreement(label, {k: got[f"{k}_cpu"] for k in keys},
                            {k: got[f"{k}_{BATCH}"][:n_cpu] for k in keys},
                            f32)
        c["report"] = report
        return runs

    launches = {}
    untimed = [case[0] for case in SERVE_CASES if case[0] != SERVE_TIMED]
    for case in SERVE_CASES:  # the timed case last, beside the others
        if case[0] != SERVE_TIMED:
            package(*case)
            launch(case[0])
    package(*next(case for case in SERVE_CASES if case[0] == SERVE_TIMED))
    # the timed process loads and predicts beside the others; it times
    # once the go file exists, after they have ended and their outputs are
    # held here, with nothing else on the card; meanwhile this process
    # packages the timed case's n-device artifact
    launch(SERVE_TIMED)
    shards = package_shards(cases[SERVE_TIMED], tmp)
    for label in untimed:
        cases[label]["proc"].wait(timeout=600)
    for label in untimed + [SERVE_TIMED]:
        if label == SERVE_TIMED:
            open(cases[label]["opts"]["go"], "w").close()
        launches.setdefault(cases[label]["model_type"], []).extend(
            finish(label))
        if label != SERVE_TIMED:
            cases[label].pop("fn", None)
    timed = cases[SERVE_TIMED]
    report = timed.get("report")
    if report is not None:
        x = torch.from_numpy(timed["img"]).to(dev)

        def eager():
            with torch.no_grad():
                return timed["fn"](x)

        eager()
        eager_ms = []
        for _ in range(SERVE_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager()
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        eager_ms = statistics.median(eager_ms)
        eager_dev = sum(kernel_times(eager).values()) / 1e3
        print(f"  {SERVE_TIMED}: per predict of {BATCH} (median of "
              f"{SERVE_ITERS}, synchronised): artifact program "
              f"{report['program_ms']:.3f} ms "
              f"({BATCH / report['program_ms'] * 1e3:.1f} images/s), eager "
              f"serving module {eager_ms:.3f} ms; predict() with host "
              f"arrays in and out {report['predict_ms']:.3f} ms "
              f"({BATCH / report['predict_ms'] * 1e3:.1f} images/s); device "
              f"{report['device_ms']:.3f} ms a predict (eager "
              f"{eager_dev:.3f}), "
              f"{report['device_ms'] / report['program_ms']:.0%} of the "
              f"program's wall time")
        for name, us in report["top"]:
            print(f"    {us / 1e3:8.3f} ms  {name[:90]}")
        host = op_host_us(dev)
        print("  host us a call: " + ", ".join(
            f"{k} {v:.1f}" for k, v in host.items()))
    launches["vit_small"].append(serve_n_devices(timed, *shards))
    print(f"  phase serve: {time.perf_counter() - t_phase:.1f} s")
    return {m: add_counts(*runs) for m, runs in launches.items()}


def corr_inputs(dev, b, hw, cf, cc, s, neg, seed, code_hw=None):
    """Seeded inputs of kernel C1 at the train step's shapes: f32 feature
    and code maps (as the trunk and head give them; the code on its own
    ``code_hw`` grid where given), U(-1, 1) coordinates,
    super_perm negatives, and the weights of a random combination of the
    losses and cd means to take gradients of. Drawn again (seed + 1000 k)
    while a cd of the plain version lies within CLAMP_TIE of a bound of
    the zero clamp (0) or the stabilising one (0.8)."""
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops.math import super_perm

    for k in range(20):
        g = torch.Generator(device=dev).manual_seed(seed + 1000 * k)
        feats = [torch.randn(b, hw, hw, cf, generator=g, device=dev)
                 for _ in range(2)]
        chw = code_hw or hw
        code = [torch.randn(b, chw, chw, cc, generator=g, device=dev)
                for _ in range(2)]
        coords = [torch.rand(b, s, s, 2, generator=g, device=dev) * 2 - 1
                  for _ in range(2)]
        perms = [super_perm(b, g) for _ in range(neg)]
        weights = torch.randn(2, 2 + neg, generator=g, device=dev)
        _, cd = c1.sampled_products_plain(feats[0], feats[1], code[0],
                                          code[1], coords[0], coords[1],
                                          perms)
        gap = float(torch.minimum(cd.abs(), (cd - 0.8).abs()).min())
        if gap > CLAMP_TIE:
            if k:
                print(f"  (inputs drawn {k + 1} times: a cd at a clamp "
                      f"bound; seed {seed + 1000 * k})")
            return feats, code, coords, perms, weights
    raise RuntimeError("20 draws of C1's inputs, each with a cd at a clamp "
                       "bound")


def c1_parts(feats, code, coords, perms, shifts, feat_dtype, opts, wts):
    """Kernel C1's route part by part, as its autograd function runs it
    (ops/corr_fused_sampling.py:_SampledCorr): the gather and the adjoint
    each held against their own plain versions (sample_sets_plain within
    GATHER_TOL, unsample_plain within ADJOINT_TOL on the kernel's own
    inputs), C2's backward on the gather's pair-row layout against C2's
    own sort, and each part's device ms: the wrapper's casts and stacks,
    the gather, C2's operand copies, C2's forward kernel, finalize; C2's
    backward kernel, its scalars and code tiles, the Jacobian kernel and
    the adjoint kernel. ``wts``: the losses' and cd means' weights, the
    backward's incoming gradients. Returns {part: ms}."""
    from stego_torch.kernels import build
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import corr_stream as c2

    lib = build.library()
    b, h, w, _ = feats[0].shape
    chw = tuple(code[0].shape[1:3])  # the code's grid
    g = 2 + len(perms)
    args = (feats[0], feats[1], code[0], code[1], coords[0], coords[1],
            perms)
    inputs = c1.gather_inputs(*args, feat_dtype)
    fsets, csets, norms, keys, tap_wts, i1, i2, *layout = c1.gather_launch(
        lib, *inputs, g, (h, w), chw)
    perm = inputs[-1]
    lo_hi = (opts.get("zero_clamp", True), opts.get("stabalize", False))
    acc, fd, mask = c2.forward_launch(lib, fsets, csets, i1, i2, *lo_hi,
                                      False, True)
    groups, pointwise = [b] * g, opts.get("pointwise", True)
    _, _, gm = c2.finalize_rows(acc[:, 0], acc[:, 1], acc[:, 2], acc[:, 3],
                                shifts, groups, pointwise)
    saved = (csets, fd, i1, i2, acc, gm, mask)
    static = (shifts, groups, pointwise, False)
    dsets = c2.backward_launch(lib, saved, static, wts[0], wts[1], layout)
    check(torch.equal(dsets, c2.backward_launch(lib, saved, static, wts[0],
                                                wts[1])),
          "C1's pair-row layout from the gather gives C2's backward the "
          "code gradient of C2's own sort, bit for bit")
    dcode = c1.adjoint_launch(lib, dsets, csets, norms, keys, tap_wts, perm,
                              b, chw)
    label = (f"{str(feat_dtype)[6:]} features, cf={feats[0].shape[-1]}, "
             f"cc={code[0].shape[-1]}, S={csets.shape[1]}"
             + ("" if chw == (h, w) else f", {h}x{w} features and "
                f"{chw[0]}x{chw[1]} code"))
    want = c1.sample_sets_plain(*args, feat_dtype)
    for name, x, y, (rtol, atol) in (
            ("feature sets", fsets, want[0], GATHER_TOL[feat_dtype]),
            ("code sets", csets, want[1], GATHER_TOL[torch.float32]),
            ("code norms", norms, want[2], GATHER_TOL[torch.float32])):
        x, y = x.float(), y.float()
        err = float((x - y).abs().max())
        check(within((x - y).abs(), atol + rtol * y.abs(), y),
              f"{label}: gather's {name} against sample_sets_plain, "
              f"max_abs_err {err:.3e} (rtol {rtol:.2e} atol {atol:.0e})")
    rtol, atol = ADJOINT_TOL
    want = torch.cat(c1.unsample_plain(dsets, csets, norms, coords[0],
                                       coords[1], perms, chw))
    got = dcode.reshape(want.shape)
    check(within((got - want).abs(), atol + rtol * want.abs(), want),
          f"{label}: adjoint's code gradients against unsample_plain, "
          f"max_abs_err {float((got - want).abs().max()):.3e} (largest "
          f"{float(want.abs().max()):.3e}; rtol {rtol} atol {atol})")

    def split(fn, own):
        """Device ms of ``fn``'s kernels whose names hold ``own`` and of
        the others."""
        t = kernel_times(fn, 20)
        mine = sum(v for k, v in t.items() if own in k) / 20e3
        return mine, sum(t.values()) / 20e3 - mine

    c2_kernel, c2_copies = split(lambda: c2.forward_launch(
        lib, fsets, csets, i1, i2, *lo_hi, False, True),
        "corr_stream_fwd_kernel")
    c2_bwd_kernel, c2_bwd_rest = split(lambda: c2.backward_launch(
        lib, saved, static, wts[0], wts[1], layout), "corr_stream_bwd_kernel")
    adjoint, jacobian = split(lambda: c1.adjoint_launch(
        lib, dsets, csets, norms, keys, tap_wts, perm, b, chw),
        "corr_sampled_adjoint_kernel")
    parts = {
        "inputs": device_ms(lambda: c1.gather_inputs(*args, feat_dtype)),
        "gather": device_ms(lambda: c1.gather_launch(lib, *inputs, g,
                                                     (h, w), chw)),
        "c2_copies": c2_copies, "c2_fwd_kernel": c2_kernel,
        "finalize": device_ms(lambda: c2.finalize_rows(
            acc[:, 0], acc[:, 1], acc[:, 2], acc[:, 3], shifts, groups,
            pointwise)),
        "c2_bwd_kernel": c2_bwd_kernel, "c2_bwd_scalars_tiles": c2_bwd_rest,
        "jacobian": jacobian, "adjoint": adjoint}
    print(f"  {label}: device ms by part: " + ", ".join(
        f"{k} {v:.4f}" for k, v in parts.items()))
    return parts


def phase_corr(dev):
    """Kernel C1 against its plain version with bf16 features (a bf16
    trunk) and f32 features (an f32 trunk) at the channels of C1_CASES;
    {case: (errors, device times, bounds, device ms by part)}."""
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops.tf32 import round_tf32

    kinds = ", ".join(f"{c[2]} {c[0].split('_')[0]}" for c in C1_CASES)
    print(f"kernel C1 (corr_sampled) vs plain: B={CORR_SHAPE['b']}, "
          f"{CORR_SHAPE['hw']}x{CORR_SHAPE['hw']} maps, feats {kinds}, code "
          f"{CORR_SHAPE['cc']} f32, {CORR_SHAPE['s']}x{CORR_SHAPE['s']} "
          f"samples (and code 100, 12x12 samples; and 2048 at 7x7 beside "
          f"56x56 code), {CORR_SHAPE['neg']} "
          f"negatives; losses and cd rtol "
          f"{LOSS_RTOL} atol {LOSS_ATOL}, code grads rtol {GRAD_RTOL} atol "
          f"{GRAD_ATOL}")
    out = {}
    for name, feat_dtype, cf, *shape in C1_CASES:
        sh = dict(CORR_SHAPE, cf=cf, **(shape[0] if shape else {}))
        seed = 3 if cf == 384 else cf
        if shape:
            seed = 1000 * sh["cc"] + sh["s"] + sh.get("code_hw", 0)
        feats, code, coords, perms, wts = corr_inputs(dev, **sh, seed=seed)
        shifts = [0.18, 0.12] + [0.46] * sh["neg"]
        errs = {"fwd": 0.0, "bwd": 0.0}
        times = {}
        for opts in (dict(pointwise=True, zero_clamp=True),
                     dict(pointwise=False, stabalize=True)):
            def forward(fn, dtype=feat_dtype):
                c = [x.clone().requires_grad_(True) for x in code]
                losses, cds = fn(feats[0], feats[1], c[0], c[1], coords[0],
                                 coords[1], perms, shifts, feat_dtype=dtype,
                                 **opts)
                total = (losses * wts[0]).sum() + (cds * wts[1]).sum()
                return losses, cds, total, c

            def run(fn, dtype=feat_dtype):
                losses, cds, total, c = forward(fn, dtype)
                return (losses.detach(), cds.detach(),
                        *torch.autograd.grad(total, c))

            wts = unit_gradient_weights(wts, run, c1.sampled_corr_plain)
            got = run(c1.sampled_corr_fused)
            again = run(c1.sampled_corr_fused)
            torch.cuda.synchronize()
            want = run(c1.sampled_corr_plain)
            label = (f"{name.split('_')[0]} features, cf={cf}, "
                     f"cc={sh['cc']}, S={sh['s'] ** 2}, "
                     + (f"{sh['hw']}x{sh['hw']} features and "
                        f"{sh['code_hw']}x{sh['code_hw']} code, "
                        if sh.get("code_hw") else "") + ", ".join(
                         f"{k}={v}" for k, v in opts.items()))
            hold_to_plain(label, got, want, errs, (LOSS_RTOL, LOSS_ATOL),
                          (GRAD_RTOL, GRAD_ATOL))
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"{label}: two calls' losses, cd means and code gradients "
                  f"bit for bit")
            if feat_dtype == torch.float32:
                plain_fd = c1.sampled_products_plain(
                    feats[0], feats[1], code[0], code[1], coords[0],
                    coords[1], perms)[0]
                fd_err = {dtype: float((c1.kernel_fd(forward(
                    c1.sampled_corr_fused, dtype)[0]) - plain_fd).abs().max())
                    for dtype in (torch.float32, torch.bfloat16)}
                f32_control(label, "fd", fd_err, FD_ATOL, agreement(
                    run(c1.sampled_corr_fused, torch.bfloat16), want,
                    (LOSS_RTOL, LOSS_ATOL), (GRAD_RTOL, GRAD_ATOL),
                    verbose=False))
                f = round_tf32(c1.sample_sets_plain(
                    feats[0], feats[1], code[0], code[1], coords[0],
                    coords[1], perms)[0])
                i1, i2 = c1.pair_rows(sh["b"], 2 + sh["neg"], dev)
                err = float((torch.bmm(f[i1], f[i2].transpose(1, 2))
                             - plain_fd).abs().max())
                check(err > FD_ATOL,
                      f"control, one TF32 pass (the plain version's fd from "
                      f"TF32-rounded sets) against the f32 plain version: "
                      f"fd max_abs_err {err:.3e} (must fail <= {FD_ATOL})")
            if not times:
                times = time_fwd_bwd(forward, run, c1.sampled_corr_fused,
                                     c1.sampled_corr_plain)
                parts = c1_parts(feats, code, coords, perms, shifts,
                                 feat_dtype, opts, wts)
        bounds = c1_bounds(**sh, feat_bytes=torch.finfo(feat_dtype).bits // 8)
        print(f"  {name.split('_')[0]} features, cf={cf}, cc={sh['cc']}, "
              f"S={sh['s'] ** 2}: forward "
              f"{bound_text(bounds['fwd'])}; backward "
              f"{bound_text(bounds['bwd'])}")
        out[name] = (errs, times, bounds, parts)
    return out


def c1_bounds(b, hw, cf, cc, s, neg, feat_bytes=2, code_hw=None):
    """C1's least times, forward and backward. Forward: fd and cd of every
    slot (S x S x (cf + cc) multiply-adds, S = s * s samples) and the
    4-tap sampling of both sides; it reads the feature maps
    (``feat_bytes`` an element) and f32 code maps and the coordinates and
    writes the row sums, z2cn and fd. Backward: cd again, dz1 and dz2, the
    normalise Jacobian and the 4-tap scatter; it reads the residuals and
    writes the code gradients. The sampling, the Jacobian and the scatter
    count once for each of the G * B (= slots) distinct sets, which the
    slots' two sides share. Products count at their type's fastest
    rate (fd on bf16 features at bf16, every f32 product at 3xTF32), the
    sampling and the Jacobian at f32 FMA: the function's work, whatever
    implements it (the products run on C2's tensor cores, and its backward
    reads the fd and mask its forward kept instead of taking cd again).
    ``code_hw``: the code's grid, where it is not the features'."""
    n, ss, slots = hw * hw, s * s, (2 + neg) * b
    nc = (code_hw or hw) ** 2
    coords = 2 * b * ss * 2 * 4
    resid = slots * (5 * ss + ss * cc + ss * ss) * 4
    fd = 2 * slots * ss * ss * cf
    fwd_ops = {"bf16": 0, "tf32x3": 2 * slots * ss * ss * cc,
               "f32": 2 * slots * ss * 4 * (cf + cc)}
    fwd_ops["bf16" if feat_bytes == 2 else "tf32x3"] += fd
    fwd = bound(fwd_ops, 2 * b * (n * feat_bytes * cf + nc * 4 * cc)
                + coords + resid)
    bwd = bound({"tf32x3": 3 * 2 * slots * ss * ss * cc,
                 "f32": 2 * slots * ss * 6 * cc},
                resid + coords + 2 * b * nc * cc * 4)
    return {"fwd": fwd, "bwd": bwd}


def unit_gradient_weights(wts, run, plain):
    """``wts`` scaled so that the plain version's largest code gradient is
    1. At weights of order 1 the code gradients of a full-field loss are
    ~1e-7 and any atol of 1e-5 holds; at unit scale the gradient tolerances
    measure the error against the gradient's own size."""
    return wts / max(float(g.abs().max()) for g in run(plain)[2:])


def agreement(got, want, loss_tol, grad_tol, share=None, verbose=True):
    """(losses, cd means, *code gradients) of a kernel against its plain
    version, by part ("fwd": losses and cd means within ``loss_tol``
    (rtol, atol); "bwd": code gradients within ``grad_tol``, and with
    ``share`` at least that share of them within the f32 tolerance
    (GRAD_RTOL, GRAD_ATOL)): {part: (ok, text)}. ``verbose`` prints the
    worst element of a part out of tolerance."""
    out = {}
    for what, sl, (rtol, atol) in (("fwd", slice(0, 2), loss_tol),
                                   ("bwd", slice(2, None), grad_tol)):
        diffs = [(g - w).abs() for g, w in zip(got[sl], want[sl])]
        tols = [atol + rtol * w.abs() for w in want[sl]]
        err = max(float(d.max()) for d in diffs)
        ok = all([within(d, t, w) if verbose else bool((d <= t).all())
                  for d, t, w in zip(diffs, tols, want[sl])])
        ratio = max(float((d / t).max()) for d, t in zip(diffs, tols))
        scale = max(float(w.abs().max()) for w in want[sl])
        name = "losses and cd means" if what == "fwd" else "code gradients"
        text = (f"{name}, max_abs_err {err:.3e} (largest |value| "
                f"{scale:.3e}; worst error / tolerance {ratio:.3f})")
        if what == "bwd" and share is not None:
            inside = sum(int((d <= GRAD_ATOL + GRAD_RTOL * w.abs()).sum())
                         for d, w in zip(diffs, want[sl]))
            frac = inside / sum(d.numel() for d in diffs)
            ok = ok and frac >= share
            text += (f", {frac:.4%} within rtol {GRAD_RTOL} atol {GRAD_ATOL}"
                     f" (>= {share:.0%})")
        out[what] = (ok, text, err)
    return out


def hold_to_plain(label, got, want, errs, loss_tol, grad_tol, share=None):
    """Checks :func:`agreement` of a kernel with its plain version; keeps
    the largest absolute errors in ``errs``."""
    for what, (ok, text, err) in agreement(got, want, loss_tol, grad_tol,
                                           share).items():
        errs[what] = max(errs[what], err)
        check(ok, f"{label}: {text}")


def f32_control(label, what, err, atol, ctl):
    """The f32 kernel's products (``what``) against the f32 plain version's
    within ``atol``; and the control, the bf16 instantiation on the same f32
    features, must fail the gate of losses, code gradients (``ctl``, its
    :func:`agreement`) and products together. ``err``: {feature type: the
    products' max_abs_err}."""
    f32, bf16 = err[torch.float32], err[torch.bfloat16]
    check(f32 <= atol, f"{label}: {what} elementwise, max_abs_err "
                       f"{f32:.3e} (<= {atol})")
    verdict = {k: "passes" if v[0] else "fails" for k, v in ctl.items()}
    check(not (ctl["fwd"][0] and ctl["bwd"][0] and bf16 <= atol),
          f"control, the bf16 instantiation on the same f32 features against "
          f"the f32 plain version: {what} max_abs_err {bf16:.3e} "
          f"({'passes' if bf16 <= atol else 'fails'} <= {atol}); losses and "
          f"cd {verdict['fwd']} ({ctl['fwd'][1]}); code gradients "
          f"{verdict['bwd']} ({ctl['bwd'][1]})")


def tf32_control(label, feats, code, idx1, idx2, plain_sums, run, want,
                 grad_tol):
    """The control of C2's f32 gates for one TF32 pass a product: the plain
    version with fd and cd from TF32-rounded features and code
    (ops/tf32.py:round_tf32) must fail the fd row-sum gate."""
    from stego_torch.ops.tf32 import round_tf32

    f = round_tf32(feats)
    err = float((torch.bmm(f[idx1], f[idx2].transpose(1, 2)).sum(-1)
                 - plain_sums).abs().max())
    ctl = agreement(run(False, code_in=round_tf32(code), feats_in=f), want,
                    (STREAM_RTOL, STREAM_ATOL), grad_tol, verbose=False)
    verdict = {k: "passes" if v[0] else "fails" for k, v in ctl.items()}
    check(err > ROW_SUM_ATOL,
          f"control, one TF32 pass (the plain version on TF32-rounded "
          f"features and code) against the f32 plain version: fd row sums "
          f"max_abs_err {err:.3e} (must fail <= {ROW_SUM_ATOL}); losses and "
          f"cd {verdict['fwd']} ({ctl['fwd'][1]}); code gradients "
          f"{verdict['bwd']} ({ctl['bwd'][1]})")


def time_fwd_bwd(forward, run, kernel, plain):
    """Device and per-call times of the forward, forward+backward and
    backward alone of a kernel and its plain version; returns the device
    times {"fwd": (kernel, plain), "bwd": (kernel, plain)}."""
    t_fwd = compare_times(lambda: forward(kernel), lambda: forward(plain))
    t_all = compare_times(lambda: run(kernel), lambda: run(plain))
    _, _, tk, ck = forward(kernel)
    _, _, tp, cp = forward(plain)
    t_bwd = compare_times(
        lambda: torch.autograd.grad(tk, ck, retain_graph=True),
        lambda: torch.autograd.grad(tp, cp, retain_graph=True))
    for what, t in (("forward", t_fwd), ("forward+backward", t_all),
                    ("backward alone", t_bwd)):
        print(f"  {what}: {timing_text(t)}")
    return {"fwd": t_fwd["device"], "bwd": t_bwd["device"]}


def stream_inputs(dev, b, hw, cf, cc, neg, distinct, seed,
                  feat_dtype=torch.bfloat16):
    """Seeded inputs of kernel C2 as the train step builds them
    (ops/corr_stream.py): normalized feature (``feat_dtype``: a bf16 or an
    f32 trunk's) and f32 code maps, and the pair rows of the self pair, the
    positive pair and ``neg`` negatives. Full-field (``distinct=False``):
    the maps of the b images and of their positives, negatives read by
    index. Grid-sampled (``distinct=True``): one map set a pair type, as the
    sampled pairs are."""
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops.math import super_perm

    g = torch.Generator(device=dev).manual_seed(seed)
    m = (2 + neg if distinct else 2) * b
    feats = c2.prep(torch.randn(m, hw, hw, cf, generator=g, device=dev),
                    feat_dtype)
    code = c2.prep(torch.randn(m, hw, hw, cc, generator=g, device=dev))
    ar = torch.arange(b, device=dev)
    idx1 = ar.repeat(2 + neg)
    idx2 = (torch.arange(m, device=dev) if distinct else
            torch.cat([ar, ar + b] + [super_perm(b, g) for _ in range(neg)]))
    weights = torch.randn(2, 2 + neg, generator=g, device=dev)
    return feats, code, idx1, idx2, weights


def c2_bounds(rows, maps, n, cf, cc, code_bf16, feat_f32=False,
              f32_kind="tf32x3"):
    """C2's least times. Forward ("fwd"): fd, a product of n x n x cf a pair
    row (bf16, or f32 for an f32 trunk's features), and cd, n x n x cc in
    f32 (bf16 with code_bf16); it reads the maps and writes the row sums.
    "fwd_keep" adds the writes of this design's forward when a gradient is
    taken: fd (4 bytes) and the clamp mask (a bit) of every entry.
    Backward: "bwd_stored" on the stored fd and mask, the two contractions
    coeff c2 and coeff^T c1 (n x n x cc each) against one read of each
    stored entry, the code maps and the row means, and the code gradient's
    write; "bwd_recompute" recomputing fd and cd instead (the design
    whose forward wrote neither); "bwd", the least time
    of the same gradient, is the lower of the two. "fwd_bwd": forward and
    backward together, the lower of the stored design (fd and mask written
    once and read once) and the recompute. "bwd_design_ms": the bytes that
    this backward moves, each stored tile read once for each gradient side
    and code chunk of 128 channels (its ownership's repeats, which the
    gradient does not need), over the memory rate. Every f32 product counts
    at the rate of ``f32_kind`` (3xTF32, the card's fastest f32-accurate
    rate; or f32 FMA for the bound beside it), whatever unit the kernel
    uses: its f32 cd stays on FMA, and this bound does not excuse that."""
    fd = 2 * rows * n * n * cf
    cd = 2 * rows * n * n * cc
    feat_type = f32_kind if feat_f32 else "bf16"
    code_type = "bf16" if code_bf16 else f32_kind
    code_bytes = maps * n * cc * 4
    maps_bytes = maps * n * (4 if feat_f32 else 2) * cf + code_bytes
    sums = rows * 4 * n * 4
    means = rows * n * 4
    kept = rows * n * n * 4 + rows * n * n / 8  # fd and the mask's bits
    chunks = -(-cc // 128)
    fwd_ops = dict.fromkeys(("bf16", f32_kind), 0)
    fwd_ops[feat_type] += fd
    fwd_ops[code_type] += cd
    recompute_ops = dict(fwd_ops)
    recompute_ops[code_type] += 2 * cd
    stored_ops = {code_type: 2 * cd}
    both_stored = dict(fwd_ops)
    both_stored[code_type] += 2 * cd
    both_recompute = {k: fwd_ops[k] + recompute_ops[k] for k in fwd_ops}
    out = {"fwd": bound(fwd_ops, maps_bytes + sums),
           "fwd_keep": bound(fwd_ops, maps_bytes + sums + kept),
           "bwd_stored": bound(stored_ops,
                               kept + code_bytes + means + code_bytes),
           "bwd_recompute": bound(recompute_ops,
                                  maps_bytes + sums + code_bytes),
           "bwd_design_ms": (2 * chunks * kept + code_bytes + means
                             + code_bytes) / HBM_BYTES_PER_S * 1e3}
    out["bwd"] = min(out["bwd_stored"], out["bwd_recompute"])
    out["fwd_bwd"] = min(
        bound(both_stored, maps_bytes + sums + 2 * kept + 2 * code_bytes
              + means),
        bound(both_recompute, 2 * (maps_bytes + sums) + 2 * code_bytes))
    return out


def phase_corr_stream(dev):
    """Kernel C2 against its plain version; {(shape name, code_bf16,
    f32 features, feature channels): errors, device times, bounds}."""
    from stego_torch.ops import corr_stream as c2

    sh = CORR_SHAPE
    b, cc, neg = sh["b"], sh["cc"], sh["neg"]
    print(f"kernel C2 (corr_stream) vs plain: B={b}, feats {sh['cf']} in "
          f"bf16 and in f32 (and ViT-B's 768 full-field, ResNet-50's 2048 "
          f"grid-sampled), code {cc} f32 "
          f"(and {WIDE_C2_DIM}), "
          f"{neg} negatives; losses and cd rtol "
          f"{STREAM_RTOL} atol {STREAM_ATOL}, code grads rtol {GRAD_RTOL} "
          f"atol {GRAD_ATOL}")
    for bf16 in (False, True):
        for feat_f32 in (False, True):
            occ = c2.forward_occupancy(bf16, feat_f32, dev)
            print(f"  forward, {'bf16' if bf16 else 'f32'} code, "
                  f"{'f32' if feat_f32 else 'bf16'} features: "
                  f"{occ['registers']} registers, {occ['stages']} ring "
                  f"stages, {occ['smem_bytes']} bytes of shared memory, "
                  f"{occ['blocks_per_sm']} blocks an SM (occupancy API)")
    for width in (cc, WIDE_C2_DIM):
        for bf16 in (False, True):
            occ = c2.backward_occupancy(width, bf16, dev)
            print(f"  backward at {width} code channels "
                  f"({'bf16' if bf16 else 'f32'} code): {occ['stages']} ring "
                  f"stages, {occ['smem_bytes']} bytes of shared memory, "
                  f"{occ['blocks_per_sm']} blocks an SM (occupancy API)")
    near_bound_masks(dev)
    fixup_margin(dev)
    shifts = [0.18, 0.12] + [0.46] * neg
    groups = [b] * (2 + neg)
    out = {}
    zero_clamp = dict(pointwise=True, zero_clamp=True)  # the train runs'
    stabalize = dict(pointwise=False, stabalize=True)
    cf = sh["cf"]
    cases = [(name, hw, False, False, cf, opts) for name, hw in STREAM_SHAPES
             for opts in (zero_clamp, stabalize)]
    # code_bf16 at the shape of the path that runs it (pallas_loss_bf16,
    # grid-sampled), then at the full-field shape
    cases += [(name, hw, True, False, cf, zero_clamp)
              for name, hw in STREAM_SHAPES[::-1]]
    # f32 features (an f32 trunk's cached full-field and grid-sampled steps)
    cases += [(name, hw, False, True, cf, opts) for name, hw in STREAM_SHAPES
              for opts in (zero_clamp, stabalize)]
    # ViT-B's 768 channels, full-field: bf16 (its train path) and f32
    full = STREAM_SHAPES[0]
    cases += [(*full, False, False, 768, opts)
              for opts in (zero_clamp, stabalize)]
    cases += [(*full, False, True, 768, zero_clamp)]
    # past one code chunk (128): dim=160, full-field (its train path) and
    # grid-sampled with code_bf16; keyed with their code channels
    cases += [(*full, False, False, cf, opts, WIDE_C2_DIM)
              for opts in (zero_clamp, stabalize)]
    cases += [(*STREAM_SHAPES[1], True, False, cf, zero_clamp, WIDE_C2_DIM)]
    # ResNet-50's 2048 channels: the feature-pyramid step's grid-sampled
    # sets (its fused_sampling=off path), bf16 and f32 features
    cases += [(*STREAM_SHAPES[1], False, feat_f32, FPN_CF, zero_clamp)
              for feat_f32 in (False, True)]
    for name, hw, code_bf16, feat_f32, cf, opts, *wide in cases:
        key = (name, code_bf16, feat_f32, cf) + tuple(wide)
        cc = wide[0] if wide else sh["cc"]
        distinct = name == "grid-sampled"
        feats, code, idx1, idx2, wts = stream_inputs(
            dev, b, hw, cf, cc, neg, distinct,
            seed=hw + code_bf16 + (cf if cf != sh["cf"] else 0)
            + (1000 * cc if wide else 0),
            feat_dtype=torch.float32 if feat_f32 else torch.bfloat16)

        def forward(use_kernel, code_in=code, bf16=code_bf16, feats_in=feats):
            c = code_in.clone().requires_grad_(True)
            losses, cds = c2.stream_loss(feats_in, c, idx1, idx2, shifts,
                                         groups, code_bf16=bf16,
                                         use_kernel=use_kernel, **opts)
            total = (losses * wts[0]).sum() + (cds * wts[1]).sum()
            return losses, cds, total, c

        def run(use_kernel, **kw):
            losses, cds, total, c = forward(use_kernel, **kw)
            return (losses.detach(), cds.detach(),
                    *torch.autograd.grad(total, c))

        wts = unit_gradient_weights(wts, run, False)
        got = run(True)
        torch.cuda.synchronize()
        want = run(False)
        again = run(True)
        res = out.setdefault(key, {"errs": {"fwd": 0.0, "bwd": 0.0}})
        grad_tol = (GRAD_RTOL, BF16_GRAD_ATOL if code_bf16 else GRAD_ATOL)
        share = BF16_GRAD_SHARE if code_bf16 else None
        label = (f"{name} (N={hw * hw}, {idx1.numel()} pair rows, "
                 f"{feats.shape[0]} maps, {cf}/{cc} channels)"
                 f"{', f32 features' if feat_f32 else ''}"
                 f"{', code_bf16' if code_bf16 else ''}, "
                 + ", ".join(f"{k}={v}" for k, v in opts.items())
                 + f"; code grads rtol {grad_tol[0]} atol {grad_tol[1]}")
        hold_to_plain(label, got, want, res["errs"],
                      (STREAM_RTOL, STREAM_ATOL), grad_tol, share)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{label}: two kernel runs bitwise equal")
        stored = stored_backward(forward, wts, shifts, groups, opts,
                                 code_bf16, timed="times" not in res)
        res["errs"]["bwd_stored"] = max(res["errs"].get("bwd_stored", 0.0),
                                        stored["err"])
        check(stored["ok"], f"{label}: backward on the stored fd and mask vs "
                            f"stream_backward_plain, {stored['text']}")
        if feat_f32 and opts is zero_clamp:
            plain_sums = torch.bmm(feats[idx1],
                                   feats[idx2].transpose(1, 2)).sum(-1)
            sum_err = {dtype: float((c2.kernel_row_sums(forward(
                True, feats_in=feats.to(dtype))[0])[:, 2] - plain_sums)
                .abs().max()) for dtype in (torch.float32, torch.bfloat16)}
            f32_control(label, "fd row sums", sum_err, ROW_SUM_ATOL,
                        agreement(run(True, feats_in=feats.bfloat16()), want,
                                  (STREAM_RTOL, STREAM_ATOL), grad_tol,
                                  verbose=False))
            if name == "full-field":
                tf32_control(label, feats, code, idx1, idx2, plain_sums,
                             run, want, grad_tol)
        if code_bf16:
            # controls: kernels that ignore code_bf16 must fail the gate
            for what, code_in in (("raw", code),
                                  ("bf16-rounded", code.bfloat16().float())):
                ctl = agreement(run(True, code_in=code_in, bf16=False), want,
                                (STREAM_RTOL, STREAM_ATOL), grad_tol, share,
                                verbose=False)
                verdict = {k: "passes" if v[0] else "fails"
                           for k, v in ctl.items()}
                check(not (ctl["fwd"][0] and ctl["bwd"][0]),
                      f"control, f32 kernel on the {what} code against the "
                      f"code_bf16 plain version: forward {verdict['fwd']} "
                      f"({ctl['fwd'][1]}); backward {verdict['bwd']} "
                      f"({ctl['bwd'][1]})")
        if "times" in res:
            continue
        res["times"] = time_fwd_bwd(forward, run, True, False)
        res["times"]["bwd_stored_plain"] = stored["plain_ms"]
        print(f"  backward alone, stream_backward_plain on the stored fd and "
              f"mask: device {stored['plain_ms']:.4f} ms")
        res["bounds"] = bnd = c2_bounds(idx1.numel(), feats.shape[0],
                                        hw * hw, cf, cc, code_bf16, feat_f32)
        fma = c2_bounds(idx1.numel(), feats.shape[0], hw * hw, cf, cc,
                        code_bf16, feat_f32, f32_kind="f32")
        print(f"  forward {bound_text(bnd['fwd'])} (with this design's "
              f"fd and mask writes {bnd['fwd_keep'][0]:.4f} ms); backward "
              f"on the stored fd and mask {bound_text(bnd['bwd_stored'])} "
              f"(this design's reads, each tile once a side and code chunk, "
              f"{bnd['bwd_design_ms']:.4f} ms), recomputing fd and cd "
              f"{bound_text(bnd['bwd_recompute'])}; "
              f"forward+backward {bound_text(bnd['fwd_bwd'])}; at f32 FMA "
              f"{fma['fwd'][0]:.4f} / {fma['bwd'][0]:.4f} ms")
    return out


def near_bound_masks(dev):
    """C2's forward takes the f32 cd by 3xTF32 and recomputes by f32 FMA
    in channel order every entry within fixup_eps of a clamp bound
    (csrc/corr_stream.cu): on code built to put many cd within 1e-6 of 0
    and 0.8 (ops/tf32.py:near_bound_code; full-field pair rows of 8 maps of
    81 rows, 70 channels) its stored clamp mask must equal the FMA chain's
    (ops/tf32.py:cd_fma, emulated exactly) bit for bit, with bf16 and f32
    features, zero_clamp and stabalize; the control, a build without the
    fix-up (STEGO_C2_FWD_ABLATION=8, its cd by 3xTF32 alone), must not."""
    from stego_torch.kernels import build
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops import tf32
    from stego_torch.ops.math import super_perm

    control = build.load(CHECK_BUILDS[NO_FIXUP])
    b, hw, cc = 4, 9, CORR_SHAPE["cc"]
    g = torch.Generator(device=dev).manual_seed(cc)
    code = tf32.near_bound_code(2 * b, hw * hw, cc, cc).to(dev)
    ar = torch.arange(b, device=dev)
    idx1 = ar.repeat(3).int()
    idx2 = torch.cat([ar, ar + b, super_perm(b, g)]).int()
    cd = tf32.cd_fma(code[idx1.long()], code[idx2.long()])
    for feat_dtype in (torch.bfloat16, torch.float32):
        feats = c2.prep(torch.randn(2 * b, hw, hw, 64, generator=g,
                                    device=dev), feat_dtype)
        for zero_clamp, stabalize in ((True, False), (False, True)):
            lo, hi = c2.clamp_bounds(zero_clamp, stabalize)
            bound = lo if zero_clamp else hi
            want = (cd >= lo) & (cd <= hi)
            near = int(((cd - bound).abs() < 1e-6).sum())
            got, ctl = (c2.unpack_mask(c2.forward_launch(
                lib, feats, code, idx1, idx2, zero_clamp, stabalize, False,
                True)[2], hw * hw) for lib in (build.library(), control))
            label = (f"near-bound clamp masks ({str(feat_dtype)[6:]} "
                     f"features, {'zero_clamp' if zero_clamp else 'stabalize'}"
                     f", {near} of {cd.numel()} cd within 1e-6 of {bound})")
            check(torch.equal(got, want),
                  f"{label}: the kernel's stored mask equals the FMA "
                  f"chain's bit for bit ({int((got != want).sum())} differ)")
            check(not torch.equal(ctl, want),
                  f"control, {label}: the build without the fix-up differs "
                  f"from the FMA chain's mask in {int((ctl != want).sum())} "
                  f"bits (must differ)")


def fixup_margin(dev):
    """The fix-up's margin against the card's 3xTF32: a build that records
    the entries the fix-up recomputes and the largest |cd by 3xTF32 - cd by
    FMA| over them (STEGO_C2_FWD_ABLATION=16) must find that gap below
    fixup_eps / 8, at the full-field shape (B=16, 28x28, five negatives, 384
    feature channels, seeded normalized code, zero_clamp) with 70 and 160
    code channels, bf16 and f32 features, and on the near-bound code (70
    channels) at both clamp bounds."""
    from stego_torch.kernels import build
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops import tf32
    from stego_torch.ops.math import super_perm

    lib = build.load(CHECK_BUILDS[COUNT_FIXUPS])
    sh = CORR_SHAPE
    b, hw, neg, cf = sh["b"], sh["hw"], sh["neg"], sh["cf"]
    g = torch.Generator(device=dev).manual_seed(10)
    ar = torch.arange(b, device=dev)
    idx1 = ar.repeat(2 + neg).int()
    idx2 = torch.cat([ar, ar + b] + [super_perm(b, g)
                                     for _ in range(neg)]).int()
    runs = []
    for cc in (sh["cc"], WIDE_C2_DIM):
        code = c2.prep(torch.randn(2 * b, hw, hw, cc, generator=g,
                                   device=dev))
        runs.append((f"full-field, {cc} code channels", code, idx1, idx2,
                     True, False))
    nb = 4  # near_bound_masks' pair rows
    code = tf32.near_bound_code(2 * nb, 81, sh["cc"], sh["cc"]).to(dev)
    ar = torch.arange(nb, device=dev)
    nb1 = ar.repeat(3).int()
    nb2 = torch.cat([ar, ar + nb, super_perm(nb, g)]).int()
    runs += [(f"near-bound code, {'zero_clamp' if zc else 'stabalize'}",
              code, nb1, nb2, zc, not zc) for zc in (True, False)]
    c2.fixup_stats(lib, dev)
    for label, code, i1, i2, zero_clamp, stabalize in runs:
        m, n, cc = code.shape
        side = math.isqrt(n)
        eps = tf32.fixup_eps(cc)
        for feat_dtype in (torch.bfloat16, torch.float32):
            feats = c2.prep(torch.randn(m, side, side, cf, generator=g,
                                        device=dev), feat_dtype)
            c2.forward_launch(lib, feats, code, i1, i2, zero_clamp,
                              stabalize, False, True)
            torch.cuda.synchronize()
            count, gap = c2.fixup_stats(lib, dev)
            check(count > 0 and gap < eps / 8,
                  f"fix-up margin, {label}, {str(feat_dtype)[6:]} features: "
                  f"{count} of {i1.numel() * n * n} entries recomputed, "
                  f"largest |3xTF32 cd - FMA cd| over them {gap:.3e} < "
                  f"fixup_eps / 8 = {eps / 8:.3e}")


def stored_backward(forward, wts, shifts, groups, opts, code_bf16,
                    timed):
    """C2's backward kernel against its plain version on the same stored
    fd and clamp mask (ops/corr_stream.py:stream_backward_plain), after one
    kernel forward of ``forward(True)`` at the weights ``wts``: the code
    gradients within (GRAD_RTOL, GRAD_ATOL), code_bf16 too (the same
    coefficients, summed in another order); {"ok", "text", "err", and
    with ``timed`` "plain_ms": the plain backward's device time}."""
    from stego_torch.ops import corr_stream as c2

    losses, cds, _, c = forward(True)
    saved = c2.kernel_saved(losses)
    (got,) = torch.autograd.grad((losses * wts[0]).sum()
                                 + (cds * wts[1]).sum(), c)
    n = saved["code"].shape[1]
    scal = c2.backward_scalars(wts[0], wts[1], saved["gm"], shifts, groups,
                               n)[c2.row_groups(groups, c.device).long()]

    def plain():
        return c2.stream_backward_plain(
            saved["fd"], saved["mask"], saved["code"].detach(),
            saved["idx1"], saved["idx2"], saved["acc"], scal,
            opts.get("pointwise", True), code_bf16)

    want = plain()
    diff = (got - want).abs()
    tol = GRAD_ATOL + GRAD_RTOL * want.abs()
    return {"ok": bool(torch.isfinite(got).all()) and within(diff, tol, want),
            "err": float(diff.max()),
            "text": (f"max_abs_err {float(diff.max()):.3e} (largest |value| "
                     f"{float(want.abs().max()):.3e}; worst error / "
                     f"tolerance {float((diff / tol).max()):.3f}), bitwise "
                     f"equal {torch.equal(got, want)}"),
            "plain_ms": device_ms(plain, iters=3) if timed else None}


def train_counts():
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln

    return (fa.LAUNCHES, ln.LAUNCHES, c1.FWD_LAUNCHES, c1.BWD_LAUNCHES,
            c2.FWD_LAUNCHES, c2.BWD_LAUNCHES)


def reset_counts():
    from stego_torch.ops import corr_fused_sampling as c1
    from stego_torch.ops import corr_stream as c2
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln

    fa.reset_launches()
    ln.LAUNCHES = ln.ADD_LAUNCHES = 0
    ln.WIDTH_LAUNCHES.clear()
    ln.DEVICE_LAUNCHES.clear()
    c1.FWD_LAUNCHES = c1.BWD_LAUNCHES = 0
    c2.FWD_LAUNCHES = c2.BWD_LAUNCHES = 0


def path_counts():
    """Every count: the COUNTS, kernel A's launches by entry point
    (``attention_<entry>``) and L2's (``add_layer_norm``)."""
    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops import layer_norm as ln

    out = dict(zip(COUNTS, train_counts()))
    out.update({f"attention_{e}": fa.ENTRY_LAUNCHES[e] for e in ENTRIES})
    out["attention_f32"] = fa.F32_LAUNCHES  # of the attention launches
    out["add_layer_norm"] = ln.ADD_LAUNCHES
    out.update({f"attention_d{d}": fa.HEAD_DIM_LAUNCHES[(d, torch.bfloat16)]
                for d in NARROW_DS})
    out.update({f"attention_d{d}_f32":
                fa.HEAD_DIM_LAUNCHES[(d, torch.float32)] for d in NARROW_DS})
    out.update({f"layer_norm_{d}": ln.WIDTH_LAUNCHES.get(d, 0)
                for d in NARROW_LN_DS})
    return out


def add_counts(*runs):
    """The sum of launch dicts, key by key."""
    out = {}
    for run in runs:
        for k, v in run.items():
            out[k] = out.get(k, 0) + v
    return out


def launches_of(attention=0, layer_norm=0, entry="pair", f32=False,
                **counts):
    """The path_counts of ``attention`` launches of kernel A, all at
    ``entry`` (and on f32 q/k/v with ``f32``), ``layer_norm`` of L and
    ``counts`` of the others."""
    out = dict.fromkeys(path_counts(), 0)
    out.update(attention=attention, layer_norm=layer_norm, **counts)
    out[f"attention_{entry}"] += attention
    out["attention_f32"] += attention if f32 else 0
    return out


def compare_steps(ref, make_step, kernel, param_atol=GRAD_ATOL,
                  plain_trunk=False, adam_live=None, grad_gap_max=None,
                  controls=None, f64_run=None, gap_over=""):
    """One train step from ``ref``'s state with the loss's kernel
    (``kernel``, C1 or C2) and one with its plain version (trunk kernels on
    in both; with ``plain_trunk`` off in the plain step, so that the step
    with every kernel is held against the step with none): metrics within
    rtol LOSS_RTOL, atol LOSS_ATOL, updated
    parameters within rtol GRAD_RTOL, atol ``param_atol``; then one with
    every kernel off, reported only, and for C2 on f32 code the gradients of
    both against the step with C2's plain version in f64 (stream_loss_f64),
    reported only, and for the runs named in F64_GAP_FMA_CD (``f64_run``)
    held to at most twice the previous forward's distance. ``make_step(seg)`` builds the step of a
    copy of ``ref`` as a call without arguments. With ``pallas_loss_bf16``,
    a step with the kernel ignoring it (the f32 kernel) must fail the
    parameter gate. With ``adam_live`` the parameters are held only where
    the plain step's gradient is at least that, and the gradients instead:
    |g_kernel - g_plain| / |g_plain| over the parameters whose names start
    with ``gap_over`` within ``grad_gap_max`` (reported only without one);
    then each of ``controls`` ({name: (module, attribute, replace)}), the
    step with every kernel and the module's attribute replaced by
    ``replace(attribute)``, must fail that gradient gate."""
    def one_step(use_kernels, use_corr_kernel, ignore_code_bf16=False,
                 f64=False):
        from stego_torch.ops import corr_stream as c2

        seg = copy.deepcopy(ref)
        seg.net.model.use_kernels = use_kernels
        seg.use_corr_kernel = use_corr_kernel
        step = make_step(seg)
        if ignore_code_bf16:  # the sampler stays the one resolved above
            seg.cfg = dataclasses.replace(seg.cfg, pallas_loss_bf16=False)
        kept = c2.fused_correlation_loss_plain
        if f64:
            c2.fused_correlation_loss_plain = stream_loss_f64
        try:
            metrics = step()
        finally:
            c2.fused_correlation_loss_plain = kept
        return metrics, {n: p.detach() for n, p in seg.named_parameters()}, \
            {n: p.grad for n, p in seg.named_parameters()}

    def grad_gap(ga, gb):
        """|ga - gb| / |gb| over the gradients of the parameters named
        ``gap_over``*."""
        pairs = [(ga[n], gb[n]) for n in gb
                 if gb[n] is not None and n.startswith(gap_over)]
        num = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
        return math.sqrt(num / sum(float((b ** 2).sum()) for _, b in pairs))

    def param_gap(pa, pb):
        return max(float((pa[n] - pb[n]).abs().max()) for n in pb)

    mk, pk, gk = one_step(True, True)
    mp, pp, gp = one_step(not plain_trunk, False)
    if plain_trunk:
        kernel = f"{kernel} and the trunk's kernels"
    m0, _, _ = one_step(False, False)
    if kernel == "C2" and not ref.cfg.pallas_loss_bf16:
        _, _, g64 = one_step(True, False, f64=True)
        gap = grad_gap(gk, g64)
        text = (f"gradients against the step with C2's plain version in "
                f"f64: |g - g_f64| / |g_f64| = {gap:.3e} with C2, "
                f"{grad_gap(gp, g64):.3e} with its f32 plain version")
        if f64_run in F64_GAP_FMA_CD:
            before = F64_GAP_FMA_CD[f64_run]
            check(gap <= 2 * before,
                  f"{f64_run}: {text}; the forward with its f32 cd on FMA "
                  f"throughout {before:.3e} (<= 2x it)")
        else:
            print(f"  {text} (report only)")
    over = f" over {gap_over}*" if gap_over else ""
    if adam_live is None or grad_gap_max is None:
        print(f"  gradients with {kernel} vs {kernel} plain{over}: |g_kernel"
              f" - g_plain| / |g_plain| = {grad_gap(gk, gp):.3e} (report "
              f"only)")
    else:
        check(grad_gap(gk, gp) <= grad_gap_max,
              f"step with {kernel} vs {kernel} plain: gradients{over}, "
              f"|g_kernel - g_plain| / |g_plain| = {grad_gap(gk, gp):.3e} "
              f"(<= {grad_gap_max})")
    if controls and plain_trunk and ref.vit_cfg is not None:
        _, _, ga = one_step(True, False)
        print(f"  gradients with the trunk's kernels alone ({kernel.split()[0]}"
              f" plain) vs {kernel} plain: |g - g_plain| / |g_plain| = "
              f"{grad_gap(ga, gp):.3e} (report only: the trunk is frozen, so "
              f"attention reaches the gradients through the features)")
    for name, (module, attr, replace) in (controls or {}).items():
        module = importlib.import_module(module)
        kept = getattr(module, attr)
        setattr(module, attr, replace(kept))
        try:
            _, pc, gc = one_step(True, True)
        finally:
            setattr(module, attr, kept)
        check(grad_gap(gc, gp) > grad_gap_max,
              f"control, the step with {name} vs {kernel} plain fails the "
              f"gradient gate{over}: |g_control - g_plain| / |g_plain| = "
              f"{grad_gap(gc, gp):.3e} (> {grad_gap_max}); updated "
              f"parameters max abs diff {param_gap(pc, pp):.3e}")
    if ref.cfg.pallas_loss_bf16:
        _, pc, gc = one_step(True, True, ignore_code_bf16=True)
        inside = all(bool(((pc[n] - pp[n]).abs()
                           <= param_atol + GRAD_RTOL * pp[n].abs()).all())
                     for n in pp)
        check(not inside,
              f"control, {kernel} ignoring pallas_loss_bf16 vs {kernel} "
              f"plain fails the parameter gate: updated parameters max abs "
              f"diff {param_gap(pc, pp):.3e} (atol {param_atol}); gradients "
              f"{grad_gap(gc, gp):.3e}")
    worst = 0.0
    ok = True
    for k in mk:
        d = (mk[k] - mp[k]).abs()
        worst = max(worst, float(d))
        ok &= within(d, LOSS_ATOL + LOSS_RTOL * mp[k].abs(), mp[k])
    check(ok, f"step with {kernel} vs {kernel} plain: {len(mk)} loss/cd "
              f"metrics, max abs diff {worst:.3e} (rtol {LOSS_RTOL}, atol "
              f"{LOSS_ATOL})")
    worst, where = 0.0, None
    ok = True
    for n in pk:
        d = (pk[n] - pp[n]).abs()
        if adam_live is not None and gp[n] is not None:
            d = torch.where(gp[n].abs() >= adam_live, d, 0.0)
        if float(d.max()) > worst:
            worst, where = float(d.max()), (n, int(torch.argmax(d)))
        ok &= within(d, param_atol + GRAD_RTOL * pp[n].abs(), pp[n])
    live = "" if adam_live is None else \
        f", where the gradient is at least {adam_live}"
    check(ok, f"step with {kernel} vs {kernel} plain: updated parameters"
              f"{live}, max abs diff {worst:.3e} (rtol {GRAD_RTOL}, atol "
              f"{param_atol})")
    if where is not None:
        n, i = where
        g_k, g_p = (float(g[n].flatten()[i]) for g in (gk, gp))
        print(f"  largest parameter difference at {n}[{i}]: gradient "
              f"{g_k:.6e} with {kernel}, {g_p:.6e} plain (Adam's first "
              f"step moves a parameter by lr * g / (|g| + 1e-8))")
    print(f"  every kernel off (trunk plain, {kernel} plain): loss/total "
          f"{float(m0['loss/total']):.6f}, with kernels "
          f"{float(mk['loss/total']):.6f}, diff "
          f"{float(m0['loss/total'] - mk['loss/total']):.3e} (report only)")


def stream_loss_f64(f1, f2, c1, c2, shifts, group_sizes, pointwise=True,
                    zero_clamp=True, stabalize=False, code_bf16=False,
                    over_ranks=False):
    """C2's plain version (ops/corr_stream.py:fused_correlation_loss_plain)
    with fd, cd and the row sums in f64, f32 code only: the reference that
    compare_steps holds C2's kernel and its f32 plain version to."""
    from stego_torch.ops import corr_stream as c2mod

    if code_bf16:
        raise ValueError("the f64 reference takes f32 code")
    fd = torch.bmm(f1.detach().double(), f2.detach().double().transpose(1, 2))
    cd = torch.bmm(c1.double(), c2.double().transpose(1, 2))
    cdc = torch.clamp(cd, *c2mod.clamp_bounds(zero_clamp, stabalize))
    losses, cd_means, _ = c2mod.finalize_rows(
        (cdc * fd).sum(-1), cdc.sum(-1), fd.sum(-1), cd.sum(-1), shifts,
        group_sizes, pointwise, over_ranks)
    return losses.float(), cd_means.float()


def run_steps(steps, hist_steps, expect, fall_window, hist_logged, step,
              fall_on=None):
    """``steps`` calls of ``step(i, with_hist) -> metrics``, the variant
    with histograms at ``hist_steps``; the main path, so every launch is
    counted. Every step must launch exactly ``expect`` (the COUNTS), give a
    finite loss and log histograms at ``hist_steps`` when ``hist_logged``;
    with ``fall_window`` the mean loss of the last that many steps must be
    below that of the first: loss/total, or the part that ``fall_on``
    ((name, function of the metrics)) names. Returns the step times (ms)
    and the launches (:func:`path_counts`)."""
    reset_counts()
    losses, step_ms = [], []
    watched = "loss/total" if fall_on is None else fall_on[0]
    for i in range(steps):
        before = train_counts()  # the COUNTS
        t0 = time.perf_counter()
        m = step(i, i in hist_steps)
        loss = float(m["loss/total"])  # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss if fall_on is None else float(fall_on[1](m)))
        delta = tuple(a - b for a, b in zip(train_counts(), before))
        part = "" if fall_on is None else f", {watched} {losses[-1]:.6f}"
        check(delta == expect and math.isfinite(loss)
              and ("hist/pos_intra" in m) == (hist_logged
                                               and i in hist_steps),
              f"step {i}{' (hist)' if i in hist_steps else ''}: "
              f"{step_ms[-1]:.2f} ms, loss/total {loss:.6f}{part}, launches "
              f"attention/LN/C1 fwd/C1 bwd/C2 fwd/C2 bwd {delta}")
    launches = path_counts()
    if fall_window:
        first = statistics.mean(losses[:fall_window])
        last = statistics.mean(losses[-fall_window:])
        check(last < first,
              f"{watched} falls: mean of steps 0-{fall_window - 1} "
              f"{first:.6f}, of steps {steps - fall_window}-{steps - 1} "
              f"{last:.6f}")
    return step_ms, launches


def report_steps(step_ms, images, one_step, peak_gb):
    """Prints the median step (after the third), images/s, the device's
    busy time over one more step (``one_step``) and its top 6 kernels, and
    peak memory."""
    skip = min(3, len(step_ms) - 1)
    med = statistics.median(step_ms[skip:])
    by_kernel = kernel_times(one_step)
    busy = sum(by_kernel.values()) / 1e3
    print(f"  median {med:.2f} ms per step (steps {skip}-{len(step_ms) - 1}), "
          f"{images / med * 1e3:.1f} images/s; device busy "
          f"{busy:.3f} ms a step ({busy / med:.0%} of the median); peak "
          f"device memory {peak_gb:.2f} GiB")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:8.3f} ms  {name[:90]}")
    return med


def train_run(dev, label, steps, hist_steps, expect, fall_window,
              time_plain=False, model_type="vit_small", preset=None,
              backbone_dtype="bfloat16", adam_live=None, grad_gap_max=None,
              controls=None, f64_run=None, extra=None, fall_on=None,
              gap_over="", **cfg_kw):
    """``steps`` train steps of a seeded segmenter (``model_type``'s /8
    trunk in bf16, cocostuff27 head, the config ``preset`` where one is
    named) at the reference footprint on one fixed batch, the
    variant with histograms at ``hist_steps``. Every step must launch
    exactly ``expect`` (the COUNTS) and give a finite loss; with
    ``fall_window`` the mean loss of the last that many steps (loss/total,
    or the part ``fall_on`` names) must be below that of the first.
    Reports the median step, images/s, device busy, the top 6 kernels and
    peak memory (with ``time_plain`` also the step's time with the loss's
    plain version), then holds one step with the loss's
    kernel against the same step with its plain version (an f32
    ``backbone_dtype``: the step with every kernel against the step with
    none, ``use_kernels=False``). ``extra(batch, gen)`` gives the batch's
    further entries (the salience masks, the host route's augmented view).
    Returns the trained segmenter, the batch, the generator and the
    launches of the steps (the main path; the comparison's launches are
    not counted)."""
    from stego_torch.train.segmenter import (draw_step_randomness,
                                             make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"train, {label}: seeded {MODEL_NAMES[model_type]} segmenter, "
          f"cocostuff27 head{f' ({preset} preset)' if preset else ''}, "
          f"{'bf16' if backbone_dtype == 'bfloat16' else 'f32'} trunk, "
          f"res {TRAIN_RES}, batch {TRAIN_BATCH}, 5 negatives, "
          f"dropout; {steps} steps on one fixed batch")
    seg = cocostuff_segmenter(dev, backbone_dtype, model_type, preset,
                              **cfg_kw)
    cfg = seg.cfg
    ref = copy.deepcopy(seg)
    gen = torch.Generator(device=dev).manual_seed(4)
    img = images(gen, TRAIN_RES, dev, TRAIN_BATCH)
    batch = {"img": img,
             "img_pos": img + 0.05 * torch.randn(img.shape, generator=gen,
                                                 device=dev),
             "label": torch.randint(-1, 27, img.shape[:3], generator=gen,
                                    device=dev)}
    if extra is not None:
        batch.update(extra(batch, gen))
    step_fns = {h: make_train_step(seg, with_hist=h) for h in (True, False)}
    hist_logged = not cfg.full_field_loss  # full-field logs cd means only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: every launch of run_steps is counted
    step_ms, launches = run_steps(
        steps, hist_steps, expect, fall_window, hist_logged,
        lambda i, hist: step_fns[hist](
            batch, draw_step_randomness(seg, TRAIN_BATCH, gen)), fall_on)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    STEP_MEDIANS[label] = report_steps(
        step_ms, TRAIN_BATCH, lambda: step_fns[False](
            batch, draw_step_randomness(seg, TRAIN_BATCH, gen)), peak_gb)
    if time_plain:
        # the same step with the loss's plain version, after the counted run
        seg.use_corr_kernel = False
        plain_ms = []
        for i in range(5):
            t0 = time.perf_counter()
            float(step_fns[False](batch, draw_step_randomness(
                seg, TRAIN_BATCH, gen))["loss/total"])
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        plain_busy = sum(kernel_times(lambda: step_fns[False](
            batch, draw_step_randomness(seg, TRAIN_BATCH, gen))).values()) / 1e3
        seg.use_corr_kernel = True
        plain_med = statistics.median(plain_ms[2:])
        print(f"  with the loss's plain version: median {plain_med:.2f} ms "
              f"per step (steps 2-4 of 5), {TRAIN_BATCH / plain_med * 1e3:.1f}"
              f" images/s; device busy {plain_busy:.3f} ms a step")

    rand = draw_step_randomness(ref, TRAIN_BATCH, gen)
    compare_steps(ref, lambda s: functools.partial(
        make_train_step(s, with_hist=False), batch, rand),
        "C2" if expect[4] else "C1",
        BF16_PARAM_ATOL if cfg.pallas_loss_bf16 else GRAD_ATOL,
        plain_trunk=backbone_dtype == "float32", adam_live=adam_live,
        grad_gap_max=grad_gap_max, controls=controls, f64_run=f64_run,
        gap_over=gap_over)
    return seg, gen, launches


BARE_STEP = "sampled loss (kernel C1), 11x11 samples"


def phase_train(dev):
    seg, gen, launches = train_run(
        dev, BARE_STEP, TRAIN_STEPS, HIST_STEPS, (12, 25, 1, 1, 0, 0), 5)
    return launches, val_run(dev, seg, gen)


def val_run(dev, seg, gen):
    """VAL_STEPS steps of make_val_step at VAL_RES, batch TRAIN_BATCH, each
    launching the trunk's kernels (12 A and 25 L) and nothing else, the
    confusion matrices summing to the valid pixels; the launches (the main
    path)."""
    from stego_torch.train.segmenter import make_val_step

    print(f"val: {VAL_STEPS} steps of make_val_step at res {VAL_RES}, batch "
          f"{TRAIN_BATCH}, {MODEL_NAMES[seg.cfg.model_type]}")
    val = make_val_step(seg)
    vbatch = {"img": images(gen, VAL_RES, dev, TRAIN_BATCH),
              "label": torch.randint(-1, 27, (TRAIN_BATCH, VAL_RES, VAL_RES),
                                     generator=gen, device=dev)}
    n_valid = int((vbatch["label"] >= 0).sum())
    torch.cuda.synchronize()
    reset_counts()
    val_ms = []
    for i in range(VAL_STEPS):
        before = train_counts()
        t0 = time.perf_counter()
        out = val(vbatch)
        sums = (int(out["conf_linear"].sum()), int(out["conf_cluster"].sum()))
        val_ms.append((time.perf_counter() - t0) * 1e3)
        delta = tuple(a - b for a, b in zip(train_counts(), before))
        check(delta == (12, 25, 0, 0, 0, 0) and sums == (n_valid, n_valid),
              f"val step {i}: {val_ms[-1]:.2f} ms, launches {delta}, "
              f"confusion matrices sum to {sums} of {n_valid} valid pixels")
    val_launches = path_counts()
    print(f"  median {statistics.median(val_ms):.2f} ms per val step")
    return val_launches


def phase_train_stream(dev):
    """The streamed loss's three training options; launches of each run."""
    runs = {}
    expect = (12, 25, 0, 0, 1, 1)
    _, _, runs["full_field"] = train_run(
        dev, "full-field loss (kernel C2, 7 dense 784x784 fields)",
        FULL_STEPS, (0,), expect, 3, time_plain=True, full_field_loss=True,
        f64_run="ViT-S full-field")
    _, _, runs["gather"] = train_run(
        dev, "fused_sampling=off (grid-sampled 11x11, kernel C2)",
        SHORT_STEPS, (0,), expect, 0, fused_sampling="off")
    _, _, runs["code_bf16"] = train_run(
        dev, "pallas_loss_bf16 (grid-sampled 11x11, kernel C2, bf16 code)",
        SHORT_STEPS, (0,), expect, 0, pallas_loss_bf16=True)
    return runs


def phase_train_models(dev):
    """ViT-T/8 (3 heads: head-major kernel A, L at D=192, C1 at 192
    channels) trained WIDE_STEPS sampled steps, then VAL_STEPS val steps at
    VAL_RES (kv-resident); ViT-B/8 with the cocostuff27_vit_base preset
    (C1 and C2 at 768 channels, L at 768) WIDE_STEPS sampled steps and
    WIDE_FULL_STEPS full-field steps. Each with train_run's gates; the
    launches of each run."""
    runs = {}
    sampled, streamed = (12, 25, 1, 1, 0, 0), (12, 25, 0, 0, 1, 1)
    seg, gen, runs["vit_tiny"] = train_run(
        dev, "sampled loss (kernel C1 at 192 channels), 11x11 samples",
        WIDE_STEPS, (0,), sampled, 3, model_type="vit_tiny")
    runs["vit_tiny_val"] = val_run(dev, seg, gen)
    del seg
    vit_base = dict(model_type="vit_base", preset="cocostuff27_vit_base")
    _, _, runs["vit_base"] = train_run(
        dev, "sampled loss (kernel C1 at 768 channels), 11x11 samples",
        WIDE_STEPS, (0,), sampled, 3, **vit_base)
    _, _, runs["vit_base_full_field"] = train_run(
        dev, "full-field loss (kernel C2 at 768 channels, 7 dense 784x784 "
        "fields)", WIDE_FULL_STEPS, (0,), streamed, 1, full_field_loss=True,
        f64_run="ViT-B full-field", **vit_base)
    return runs


def cocostuff_segmenter(dev, backbone_dtype="bfloat16",
                        model_type="vit_small", preset=None, **cfg_kw):
    """A seeded segmenter (``model_type``'s /8 trunk) with the cocostuff27
    head (dim 70 unless ``cfg_kw`` names one, nonlinear, 27 classes) at the
    reference train footprint
    (res 224, batch 16, 11 x 11 samples, 5 negatives, dropout), the config
    ``preset`` applied where one is named, on ``dev``; a bf16 trunk keeps
    its block weights in bf16."""
    from stego_torch.config import Config, apply_preset
    from stego_torch.train.segmenter import UnsupervisedSegmenter

    cfg_kw = {"dim": 70, **cfg_kw}
    cfg = Config(dataset_name="cocostuff27", model_type=model_type,
                 dino_patch_size=8, projection_type="nonlinear",
                 backbone_dtype=backbone_dtype, res=TRAIN_RES,
                 batch_size=TRAIN_BATCH, run_crf=False, **cfg_kw)
    if preset is not None:
        cfg = apply_preset(cfg, preset)
    seg = UnsupervisedSegmenter(27, cfg,
                                generator=torch.Generator().manual_seed(0))
    seg.to(dev)
    if backbone_dtype == "bfloat16":
        seg.net.model.cast_blocks(torch.bfloat16)
    return seg


def render(args):
    """Scene ``i`` of split ``split`` (0 train, 1 val) at ``res``
    (stego_torch/data/synthetic.py, seeded by (split, i)): the
    ImageNet-normalized f32 image and the int16 labels (-1 ignored)."""
    from stego_torch.data.synthetic import render_scene
    from stego_torch.data.transforms import channel_stats

    split, i, res = args
    img, label = render_scene(np.random.default_rng((split, i)), res, 27)
    mean, std = channel_stats(3)
    return ((img - mean) / std).astype(np.float32), label.astype(np.int16)


def start_scenes(*splits, jobs=()):
    """Start rendering the scenes of each ``(split, n, res)`` of
    ``splits``, and each ``(fn, *args)`` of ``jobs``, on a pool of
    processes (spawned, so that no child shares this process's CUDA state;
    one fewer than the cores, so that this process keeps one while the
    phases go on). Returns a function that waits for them all and returns
    one list of scenes a split, the pool ended."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    pool = concurrent.futures.ProcessPoolExecutor(
        max(1, min(8, os.cpu_count() or 1) - 1), mp_context=ctx)
    done = [pool.submit(*job) for job in jobs]
    maps = [pool.map(render, [(split, i, res) for i in range(n)],
                     chunksize=8) for split, n, res in splits]

    def result():
        try:
            for job in done:
                job.result()
            return [list(m) for m in maps]
        finally:
            pool.shutdown()
    return result


class SceneSplit:
    """A split of scenes with the surface of ContrastiveSegDataset that
    build_feat_cache and FeatCacheSampler read: the base dataset of (img,
    label) items, its KNN table and the pair draw's seed and epoch."""

    def __init__(self, items, nns=None, num_neighbors=7):
        self.dataset = items
        self.nns = nns
        self.num_neighbors = num_neighbors
        self.seed, self.epoch = 0, 0
        self.pos_images = self.pos_labels = nns is not None

    def __len__(self):
        return len(self.dataset)


def trunk_launches(batches, res=TRAIN_RES):
    """The launches of ``batches`` bf16 ViT-S trunk calls at ``res`` and
    nothing else."""
    return launches_of(12 * batches, 25 * batches,
                       trunk_entry("vit_small", res))


def phase_knn(dev, tmp, seg, items):
    """The KNN precompute of the train split with the bf16 trunk
    (train/knn.py): embed in batches of 16, top-30, the .npz. Returns nns
    and the launches (12 attention and 25 LN a batch)."""
    from stego_torch.train.knn import build_knn_cache, knn_cache_file

    n = len(items)
    print(f"knn: {n} scenes at res {TRAIN_RES}, bf16 trunk, batches of "
          f"{TRAIN_BATCH}, top {KNN_K}")
    loader = [torch.from_numpy(np.stack([img for img, _ in
                                         items[i:i + TRAIN_BATCH]]))
              for i in range(0, n, TRAIN_BATCH)]
    path = knn_cache_file(tmp, "vit_small", "synthetic", "train", None,
                          TRAIN_RES)
    torch.cuda.synchronize()
    reset_counts()  # the main path: every launch of the build is counted
    t0 = time.perf_counter()
    nns = build_knn_cache(path, seg.net, loader, k=KNN_K)
    sec = time.perf_counter() - t0
    launches = path_counts()
    with np.load(path) as f:
        saved = f["nns"]
    check(nns.shape == (n, KNN_K) and np.array_equal(saved, nns)
          and bool((nns[:, 0] == np.arange(n)).all()),
          f"nns {nns.shape} {nns.dtype}, saved and loaded equal, every image "
          f"its own nearest; {sec:.2f} s for embedding, top-k and .npz "
          f"({n / sec:.1f} images/s)")
    check(launches == trunk_launches(len(loader)),
          f"knn launches {launches}: 12 attention and 25 LN a batch")
    # report only: how often a neighbour's main class is the image's
    main = np.array([np.bincount(lab[lab >= 0], minlength=27).argmax()
                     for _, lab in items])
    same = float((main[nns[:, 1:8]] == main[:, None]).mean())
    chance = float((np.bincount(main, minlength=27) / n) @
                   (np.bincount(main, minlength=27) / n))
    print(f"  the 7 nearest neighbours share the image's main class in "
          f"{same:.1%} of cases (chance {chance:.1%}; random trunk weights)")
    return nns, launches


def phase_feat_cache(dev, segs, train, val):
    """Feature caches (train/feat_cache.py) of the train split (res 224,
    chunks of 16) and the val split (res 320, chunks of 24, the last padded)
    with the bf16 and the f32 trunk. A bf16 build launches A 12 and L 25
    times a chunk, an f32 build neither; the rows of one chunk of each cache
    equal the trunk's output on the same batch (f32 within rtol 1e-4, atol
    1e-5; bf16 within one bf16 ulp). Returns {(trunk, split): cache} and the
    launches of every build."""
    from stego_torch.ops import layer_norm as ln
    from stego_torch.train.feat_cache import (build_feat_cache,
                                              estimate_cache_gb)

    caches, total = {}, {}
    for trunk, seg in segs.items():
        for split, ds, res, chunk in (("train", train, TRAIN_RES, TRAIN_BATCH),
                                      ("val", val, VAL_RES, VAL_BATCH)):
            n = len(ds)
            chunks = -(-n // chunk)
            torch.cuda.synchronize()
            reset_counts()  # the main path: every launch is counted
            t0 = time.perf_counter()
            cache = build_feat_cache(seg, ds, seg.cfg, batch_size=chunk,
                                     res=res, with_mask=False)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = path_counts()
            total = add_counts(total, launches)
            gib = sum(t.numel() * t.element_size()
                      for t in cache.values()) / 2**30
            est = estimate_cache_gb(seg.cfg, seg, n, res=res, with_mask=False)
            feats = cache["feats"]
            want_launches = trunk_launches(chunks if trunk == "bf16" else 0,
                                           res)
            check(feats.shape == (n, res // 8, res // 8, EMBED)
                  and feats.dtype == seg.net.backbone_dtype
                  and cache["label"].shape == (n, res, res)
                  and launches == want_launches,
                  f"cache, {trunk} trunk, {split}: {n} images at res {res} "
                  f"in chunks of {chunk}: {sec:.2f} s ({n / sec:.1f} "
                  f"images/s), features {tuple(feats.shape)} {feats.dtype}, "
                  f"{gib:.3f} GiB with the labels (estimate {est:.3f}); "
                  f"launches attention/LN {launches['attention']}/"
                  f"{launches['layer_norm']}")
            # the rows of one chunk against the trunk on the same batch: the
            # train split's second chunk, the val split's short last chunk
            # with the build's padding (copies of its last image)
            first = chunk if split == "train" else (chunks - 1) * chunk
            rows = list(range(first, min(n, first + chunk)))
            img = np.stack([ds.dataset[i][0] for i in rows])
            img = np.concatenate([img] + [img[-1:]] * (chunk - len(rows)))
            want = seg.net.backbone_features(
                torch.from_numpy(img).to(dev))[:len(rows)]
            got = feats[rows].float()
            if trunk == "f32":
                tol, what = 1e-5 + 1e-4 * want.abs(), "rtol 1e-4, atol 1e-5"
            else:
                tol, what = ln.bf16_ulp_tolerance(want), "one bf16 ulp"
            diff = (got - want).abs()
            check(within(diff, tol, want),
                  f"cache, {trunk} trunk, {split}: rows {rows[0]}-{rows[-1]} "
                  f"vs the trunk on the same batch: max abs diff "
                  f"{float(diff.max()):.3e} (within {what})")
            caches[(trunk, split)] = cache
    return caches, total


def index_batches(dev, split, count):
    """``count`` index batches of 16 (ind, and ind_pos drawn by
    FeatCacheSampler from the KNN table) over a seeded order of the split,
    on ``dev``."""
    from stego_torch.train.feat_cache import FeatCacheSampler

    sampler = FeatCacheSampler(split)
    order = np.random.default_rng(5).permutation(len(split))
    out = []
    for j in range(count):
        draws = [sampler[int(i)]
                 for i in order[j * TRAIN_BATCH:(j + 1) * TRAIN_BATCH]]
        out.append({k: torch.tensor([int(d[k]) for d in draws], device=dev)
                    for k in ("ind", "ind_pos")})
    return out


def cached_run(dev, label, base, cache, batches, steps, hist_steps, expect,
               fall_window, f64_run=None, **cfg_kw):
    """``steps`` cached train steps (make_cached_train_step) of a copy of
    ``base`` with ``cfg_kw``, over ``batches`` in turn (as many as the loss
    windows hold, so that both windows see the same images); the checks and
    report of train_run, then one step with the loss's kernel held against
    the same step with its plain version. Returns the trained segmenter and
    the launches of the steps."""
    from stego_torch.train.segmenter import (draw_step_randomness,
                                             make_cached_train_step)

    seg = copy.deepcopy(base)
    seg.cfg = dataclasses.replace(seg.cfg, **cfg_kw)
    ref = copy.deepcopy(seg)
    print(f"cached train, {label}: {steps} steps over {len(batches)} index "
          f"batches of {TRAIN_BATCH} in turn")
    gen = torch.Generator(device=dev).manual_seed(6)
    step_fns = {h: make_cached_train_step(seg, with_hist=h)
                for h in (True, False)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: every launch of run_steps is counted
    step_ms, launches = run_steps(
        steps, hist_steps, expect, fall_window, not seg.cfg.full_field_loss,
        lambda i, hist: step_fns[hist](
            cache, batches[i % len(batches)],
            draw_step_randomness(seg, TRAIN_BATCH, gen)))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    report_steps(step_ms, TRAIN_BATCH, lambda: step_fns[False](
        cache, batches[0], draw_step_randomness(seg, TRAIN_BATCH, gen)),
        peak_gb)
    rand = draw_step_randomness(ref, TRAIN_BATCH, gen)
    compare_steps(ref, lambda s: functools.partial(
        make_cached_train_step(s, with_hist=False), cache, batches[0], rand),
        "C2" if expect[4] else "C1", f64_run=f64_run)
    return seg, launches


def phase_cached_train(dev, bases, caches, batches):
    """The cached train runs: bf16 and f32 trunks with the sampled loss
    (C1, 20 steps), the f32 trunk with the full-field loss (C2, 10 steps)
    and with fused_sampling="off" (C2 at N=121, 3 steps). Returns the
    segmenters of the sampled runs and the launches of every run."""
    sampled, streamed = (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 1, 1)
    trained, runs = {}, {}
    for trunk in ("bf16", "f32"):
        trained[trunk], runs[trunk] = cached_run(
            dev, f"{trunk} trunk, sampled loss (C1, {trunk} features)",
            bases[trunk], caches[(trunk, "train")], batches[:5], TRAIN_STEPS,
            HIST_STEPS, sampled, 5)
    _, runs["f32_full_field"] = cached_run(
        dev, "f32 trunk, full-field loss (C2, f32 features, 7 dense 784x784 "
        "fields)", bases["f32"], caches[("f32", "train")], batches[:3],
        FULL_STEPS, (0,), streamed, 3, full_field_loss=True,
        f64_run="cached f32 full-field")
    _, runs["f32_gather"] = cached_run(
        dev, "f32 trunk, fused_sampling=off (grid-sampled 11x11, C2, f32 "
        "features)", bases["f32"], caches[("f32", "train")], batches[:1],
        SHORT_STEPS, (0,), streamed, 0, fused_sampling="off")
    return trained, runs


def phase_cached_vs_image(dev, base, cache, split, batch):
    """One f32 image step (make_train_step: the f32 trunk over img ||
    img_pos, then C1 with f32 features) against one cached step from the
    same state and draws on the same 16 images: loss metrics within rtol
    LOSS_RTOL, atol LOSS_ATOL; updated parameters within rtol GRAD_RTOL,
    atol GRAD_ATOL. Comparison launches, not counted."""
    from stego_torch.train.segmenter import (draw_step_randomness,
                                             make_cached_train_step,
                                             make_train_step)

    print("cached vs image step: f32 trunk, sampled loss (C1, f32 features), "
          "one step each from the same state and draws on the same images")
    ind, ind_pos = batch["ind"].tolist(), batch["ind_pos"].tolist()

    def stack(sel, j, dtype):
        return torch.from_numpy(np.stack(
            [split.dataset[i][j] for i in sel])).to(dev, dtype)

    img_batch = {"img": stack(ind, 0, torch.float32),
                 "img_pos": stack(ind_pos, 0, torch.float32),
                 "label": stack(ind, 1, torch.int64)}
    rand = draw_step_randomness(base, TRAIN_BATCH,
                                torch.Generator(device=dev).manual_seed(7))
    out = {}
    for name, steps in (("image", lambda s: functools.partial(
            make_train_step(s, with_hist=False), img_batch, rand)),
                        ("cached", lambda s: functools.partial(
            make_cached_train_step(s, with_hist=False), cache, batch, rand))):
        seg = copy.deepcopy(base)
        step = steps(seg)
        before = train_counts()
        metrics = step()
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(train_counts(), before))
        params = {n: p.detach() for n, p in seg.named_parameters()}
        device = sum(kernel_times(steps(copy.deepcopy(base))).values()) / 1e3
        out[name] = (metrics, params)
        check(delta == (0, 0, 1, 1, 0, 0),
              f"{name} step: launches {delta}; device time of one step "
              f"{device:.3f} ms (report only)")
    (mi, pi), (mc, pc) = out["image"], out["cached"]
    worst, ok = 0.0, True
    for k in mi:
        d = (mc[k] - mi[k]).abs()
        worst = max(worst, float(d))
        ok &= within(d, LOSS_ATOL + LOSS_RTOL * mi[k].abs(), mi[k])
    check(ok, f"cached vs image step: {len(mi)} loss/cd metrics, max abs "
              f"diff {worst:.3e} (rtol {LOSS_RTOL}, atol {LOSS_ATOL})")
    worst, ok = 0.0, True
    for n in pi:
        d = (pc[n] - pi[n]).abs()
        worst = max(worst, float(d.max()))
        ok &= within(d, GRAD_ATOL + GRAD_RTOL * pi[n].abs(), pi[n])
    check(ok, f"cached vs image step: updated parameters, max abs diff "
              f"{worst:.3e} (rtol {GRAD_RTOL}, atol {GRAD_ATOL})")


def phase_cached_val(dev, segs, caches, split):
    """make_cached_val_epoch over each val cache in batches of 24, the last
    padded with -1: the confusion matrices sum to the valid pixels, no
    kernel launches; against make_val_step over the same images batch by
    batch, at least PRED_AGREE of the predictions agree, and the summed
    confusion matrices move no more pixels than that allows. Returns the
    launches of the epochs (none)."""
    from stego_torch.train.segmenter import (make_cached_val_epoch,
                                             make_cached_val_step,
                                             make_val_step)

    n = len(split)
    nb = -(-n // VAL_BATCH)
    inds = torch.full((nb * VAL_BATCH,), -1, dtype=torch.long, device=dev)
    inds[:n] = torch.arange(n, device=dev)
    inds = inds.reshape(nb, VAL_BATCH)
    n_valid = sum(int((label >= 0).sum()) for _, label in split.dataset)
    total = {}
    for trunk, seg in segs.items():
        cache = caches[(trunk, "val")]
        epoch = make_cached_val_epoch(seg)
        torch.cuda.synchronize()
        reset_counts()  # the main path: every launch is counted
        t0 = time.perf_counter()
        out = epoch(cache, inds)
        sums = (int(out["conf_linear"].sum()), int(out["conf_cluster"].sum()))
        ms = (time.perf_counter() - t0) * 1e3
        launches = path_counts()
        total = add_counts(total, launches)
        check(sums == (n_valid, n_valid) and launches == trunk_launches(0),
              f"cached val, {trunk} trunk: {nb} batches of {VAL_BATCH} at res "
              f"{VAL_RES} (the last {n - (nb - 1) * VAL_BATCH} images and "
              f"padding) in {ms:.2f} ms; confusion matrices sum to {sums} of "
              f"{n_valid} valid pixels; no kernel launches")
        val_step, step = make_val_step(seg), make_cached_val_step(seg)
        agree = dict.fromkeys(("linear", "cluster"), 0)
        conf = dict.fromkeys(("conf_linear", "conf_cluster"), 0)
        t0 = time.perf_counter()
        for b in range(nb):
            rows = range(b * VAL_BATCH, min(n, (b + 1) * VAL_BATCH))
            img = torch.from_numpy(np.stack([split.dataset[i][0]
                                             for i in rows])).to(dev)
            label = torch.from_numpy(np.stack([split.dataset[i][1]
                                               for i in rows])).to(dev)
            o = val_step({"img": img, "label": label})
            oc = step(cache, {"ind": inds[b]})
            for name in agree:
                agree[name] += int((o[f"{name}_preds"]
                                    == oc[f"{name}_preds"][:len(rows)]).sum())
            for k in conf:
                conf[k] = conf[k] + o[k]
        img_ms = (time.perf_counter() - t0) * 1e3
        pixels = n * VAL_RES * VAL_RES
        for name, same in agree.items():
            check(same / pixels >= PRED_AGREE,
                  f"cached val, {trunk} trunk: {name} predictions agree with "
                  f"make_val_step's on {same / pixels:.4%} of pixels (>= "
                  f"{PRED_AGREE:.0%}); the image val steps (trunk, head, "
                  f"probes) took {img_ms:.2f} ms")
        for k in conf:
            moved = int((conf[k] - out[k]).abs().sum()) // 2
            check(moved <= (1 - PRED_AGREE) * n_valid,
                  f"cached val, {trunk} trunk: {k} of the epoch vs the image "
                  f"val steps: {moved} pixels moved (<= "
                  f"{1 - PRED_AGREE:.0%} of the valid pixels)")
    return total



# the app phase: train() at the reference footprint on the scenes, val at
# VAL_RES in batches of VAL_BATCH (a short last batch), validation and a
# checkpoint every APP_FREQ steps, the loss logged every APP_LOG_FREQ and
# the cd histograms every APP_HIST_FREQ; a first run, a resumed one and a
# cached one; the steps before the app's median (warmup)
APP_STEPS, APP_RESUMED_STEPS, APP_CACHED_STEPS = 100, 150, 50
APP_FREQ, APP_LOG_FREQ, APP_HIST_FREQ, APP_WARMUP = 50, 10, 25, 21
# the app's profiler window (profile_dir: steps 10-19 traced), before the
# median's steps
APP_TRACED = range(10, 20)
APP_NO_THREADS_STEPS = 50
APP_METRICS = {f"test/{probe}/{m}" for probe in ("linear", "cluster")
               for m in ("mIoU", "Accuracy")}  # the JAX app's keys


class SceneItems:
    """The rendered scenes as a base dataset of (img, label, mask) items, as
    DirectoryDataset gives them (int64 labels, mask = label > 0)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        img, label = self.items[i]
        label = label.astype(np.int64)
        return img, label, (label > 0).astype(np.float32)


def best_n(metrics_by_step, n):
    """The steps the JAX package's orbax manager keeps (BestN): the steps in
    step order, sorted stably by test/cluster/mIoU, the last n."""
    ranked = sorted(sorted(metrics_by_step),
                    key=lambda s: metrics_by_step[s]["test/cluster/mIoU"])
    return sorted(ranked[-n:])


def app_run(make, label, want):
    """``make().run()`` (``make`` builds the Trainer, and the feature caches
    of a cached run), the main path: the counts are set to 0 just before
    it and read just after, and must be ``want``. Returns the trainer and
    the launches."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer = make()
    metrics = trainer.run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = path_counts()
    check(launches == want,
          f"app, {label}: steps {trainer.start_step}-{trainer.seg.step} in "
          f"{sec:.2f} s, launches attention/LN/C1 fwd/C1 bwd/C2 fwd/C2 bwd "
          f"{tuple(launches[k] for k in COUNTS)}, attention at pair/pair_kv "
          f"{launches['attention_pair']}/{launches['attention_pair_kv']}")
    check(set(metrics) == APP_METRICS
          and all(math.isfinite(v) for v in metrics.values()),
          f"app, {label}: last validation " + ", ".join(
              f"{k}={v:.2f}" for k, v in sorted(metrics.items())))
    return trainer, launches


def trace_breakdown(path, steps):
    """ms a step, from a chrome trace of ``steps`` steps: the host's time
    inside cudaMemcpy* calls (a copy from pageable memory returns only when
    it is done, after the work queued before it) and the device's kernel,
    copy and memset time."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    memcpy = sum(e["dur"] for e in events if e.get("cat") == "cuda_runtime"
                 and e["name"].startswith("cudaMemcpy"))
    device = sum(e["dur"] for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return memcpy / 1e3 / steps, device / 1e3 / steps


def phase_app(dev, tmp, train_items, val_items, nns):
    """The training app (stego_torch/train/app.py) at ViT-S/8's full width
    on the scenes: APP_STEPS steps of train() from ContrastiveSegDataset
    over the scenes and their KNN table, a resumed run to
    APP_RESUMED_STEPS, then APP_CACHED_STEPS cached steps
    (cache_backbone_feats). Gates: the launches (12 A, 25 L, 1+1 C1 a
    step, 12 A2 and 25 L a validation batch at res 320; the cached run: the
    caches' trunk batches and 1+1 C1 a step), the logged loss falls, finite
    validation metrics with the JAX app's keys, the kept checkpoints are
    BestN's of the logged metrics, the f32 backbone of the bf16 trunk, the
    newest .ckpt through load_model_for_eval gives the in-memory segmenter's
    flip-TTA code bit for bit, and the resumed run starts at step
    APP_STEPS and logs first at APP_STEPS + APP_LOG_FREQ. Prints the app's
    median step, images/s, the bare step's median (phase train), the
    loader's share of the loop, the batch's copy, one batch's host work,
    a profiled window (profile_dir), the validation epochs' seconds and
    peak device memory; and the median step of the image and cached loops
    without the loader's fetch threads (num_workers=0). Writes under
    ``tmp``. Returns the launches of every run and the newest kept
    checkpoint's .ckpt."""
    from stego_torch.config import Config
    from stego_torch.data.contrastive import ContrastiveSegDataset
    from stego_torch.eval.evaluate import flip_tta_code, load_model_for_eval
    from stego_torch.train.app import Trainer

    train_ds = ContrastiveSegDataset.from_items(SceneItems(train_items), 27,
                                                nns=nns, num_neighbors=7)
    val_ds = ContrastiveSegDataset.from_items(SceneItems(val_items), 27)
    val_batches = -(-len(val_items) // VAL_BATCH)
    no_threads = []

    def steps(n, trunk=True):
        calls = n if trunk else 0
        return launches_of(12 * calls, 25 * calls, "pair",
                           corr_sampled_fwd=n, corr_sampled_bwd=n)

    print(f"app: train() on {len(train_items)} scenes at res {TRAIN_RES} "
          f"(KNN top {KNN_K}, 7 neighbours), ViT-S/8 bf16 trunk, cocostuff27 "
          f"head, batch {TRAIN_BATCH}, validation on {len(val_items)} scenes "
          f"at res {VAL_RES} in batches of {VAL_BATCH}")
    cfg = Config(dataset_name="cocostuff27", model_type="vit_small",
                 dino_patch_size=8, projection_type="nonlinear", dim=70,
                 backbone_dtype="bfloat16", res=TRAIN_RES,
                 val_res=VAL_RES, batch_size=TRAIN_BATCH,
                 val_batch_size=VAL_BATCH, max_steps=APP_STEPS,
                 val_freq=APP_FREQ, checkpoint_freq=APP_FREQ,
                 scalar_log_freq=APP_LOG_FREQ, hist_freq=APP_HIST_FREQ,
                 save_top_k=2, output_root=tmp, experiment_name="app",
                 run_crf=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_val = APP_STEPS // APP_FREQ
    profile_dir = os.path.join(tmp, "profile")
    first, run1 = app_run(
        lambda: Trainer(cfg.replace(profile_dir=profile_dir),
                        train_dataset=train_ds, val_dataset=val_ds,
                        device=dev),
        "first run", add_counts(steps(APP_STEPS), trunk_launches(
            n_val * val_batches, VAL_RES)))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_val = (APP_RESUMED_STEPS - APP_STEPS) // APP_FREQ
    resumed, run2 = app_run(
        lambda: Trainer(cfg.replace(max_steps=APP_RESUMED_STEPS,
                                    resume=True),
                        train_dataset=train_ds, val_dataset=val_ds,
                        device=dev),
        "resumed run", add_counts(
            steps(APP_RESUMED_STEPS - APP_STEPS),
            trunk_launches(n_val * val_batches, VAL_RES)))
    check(resumed.start_step == APP_STEPS,
          f"app: the resumed run restored step {resumed.start_step}, "
          f"its loader fast-forwarded to epoch "
          f"{APP_STEPS // len(first.train_loader)}, batch "
          f"{APP_STEPS % len(first.train_loader)}")

    with open(os.path.join(first.log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    losses = [ln for ln in lines if "loss/total" in ln]
    n_first = APP_STEPS // APP_LOG_FREQ
    check([ln["step"] for ln in losses][n_first:n_first + 1]
          == [APP_STEPS + APP_LOG_FREQ],
          f"app: the resumed run's first logged step "
          f"{losses[n_first]['step'] if len(losses) > n_first else None}")
    tenth = max(1, len(losses) // 10)
    head = statistics.mean(ln["loss/total"] for ln in losses[:tenth])
    tail = statistics.mean(ln["loss/total"] for ln in losses[-tenth:])
    check(tail < head and len(losses) == APP_RESUMED_STEPS // APP_LOG_FREQ,
          f"app: loss/total in metrics.jsonl falls: mean of the first "
          f"{tenth} of {len(losses)} logged steps {head:.6f}, of the last "
          f"{tenth} {tail:.6f}")
    vals = {ln["step"]: ln for ln in lines if "test/cluster/mIoU" in ln}
    check(sorted(vals) == list(range(APP_FREQ, APP_RESUMED_STEPS + 1,
                                     APP_FREQ))
          and all(APP_METRICS <= set(v) and all(
              math.isfinite(v[k]) for k in APP_METRICS)
              for v in vals.values()),
          "app: validations at steps " + ", ".join(
              f"{s} (cluster mIoU {v['test/cluster/mIoU']:.2f})"
              for s, v in sorted(vals.items())))

    mgr = resumed.mgr
    kept = mgr.all_steps()
    want_kept = best_n(vals, cfg.save_top_k)
    check(kept == want_kept, f"app: checkpoints kept {kept}, BestN of the "
          f"logged metrics {want_kept}")
    backbone = mgr.restore_backbone()
    qkv = backbone["blocks.0.attn.qkv.weight"]
    check(all(t.dtype == torch.float32 for t in backbone.values())
          and not torch.equal(qkv, qkv.bfloat16().float())
          and resumed.seg.net.model.blocks[0].attn.qkv.weight.dtype
          == torch.bfloat16
          and all(torch.equal(backbone[k], v)
                  for k, v in resumed.backbone_store.items()),
          "app: backbone.pt holds the f32 source weights of the bf16 "
          "trunk")
    newest = {APP_STEPS: first.seg,
              APP_RESUMED_STEPS: resumed.seg}.get(kept[-1])
    check(newest is not None, f"app: the newest kept step {kept[-1]} is "
          f"one a run ended on")
    if newest is not None:
        loaded = load_model_for_eval(mgr.checkpoint_path(kept[-1]), dev)
        img = torch.from_numpy(np.stack(
            [val_items[i][0] for i in range(BATCH)])).to(dev)
        with torch.inference_mode():
            want = flip_tta_code(newest.eval(), img)
            got = flip_tta_code(loaded, img)
        check(torch.equal(got, want),
              f"app: step {kept[-1]}'s .ckpt through load_model_for_eval:"
              f" a flip-TTA request of {BATCH} at res {VAL_RES} gives the "
              f"in-memory segmenter's code bit for bit (max abs diff "
              f"{float((got - want).abs().max()):.3e})")
        del loaded

    intervals = np.diff(first.step_starts)[APP_WARMUP:]
    med_ms = float(np.median(intervals)) * 1e3
    loop_s = first.step_starts[-1] - first.step_starts[APP_WARMUP]
    wait = sum(first.loader_wait[APP_WARMUP:-1]) / loop_s
    copy_ms = float(np.median(first.copy_seconds[APP_WARMUP:])) * 1e3
    bare = STEP_MEDIANS.get(BARE_STEP)
    print(f"  app: median {med_ms:.2f} ms per train step (wall clock, "
          f"steps {APP_WARMUP}-{APP_STEPS - 1} of the first run), "
          f"{TRAIN_BATCH / med_ms * 1e3:.1f} images/s; the bare step "
          f"(phase train, one fixed batch on the device) "
          f"{bare if bare is None else f'{bare:.2f}'} ms; loader wait "
          f"{wait:.1%} of the loop's time; the batch's copy to the "
          f"device (host clock, median) {copy_ms:.2f} ms a step; "
          f"validation epochs "
          + ", ".join(f"{s:.3f}" for s in first.val_seconds
                      + resumed.val_seconds)
          + f" s; peak device memory {peak_gb:.2f} GiB")
    # what the prefetch thread does for a batch, alone on the host
    from stego_torch.data.loader import collate

    t0 = time.perf_counter()
    items = [train_ds[i] for i in range(TRAIN_BATCH)]
    t1 = time.perf_counter()
    host_batch = collate(items)
    t2 = time.perf_counter()
    print(f"  app: one batch on the host, alone: {TRAIN_BATCH} items "
          f"{(t1 - t0) * 1e3:.2f} ms, collate {(t2 - t1) * 1e3:.2f} ms, "
          f"{sum(v.nbytes for v in host_batch.values()) / 2**20:.1f} MiB")
    del items, host_batch
    traced = len(APP_TRACED)
    memcpy_ms, device_ms_ = trace_breakdown(
        os.path.join(profile_dir, "train_steps.json"), traced)
    window_ms = (first.step_starts[APP_TRACED[-1] + 1]
                 - first.step_starts[APP_TRACED[0]]) / traced * 1e3
    print(f"  app, steps {APP_TRACED[0]}-{APP_TRACED[-1]} under the "
          f"profiler (profile_dir): {window_ms:.2f} ms a step, of it "
          f"{memcpy_ms:.2f} ms on the host inside cudaMemcpy calls (the "
          f"batch's pageable host-to-device copies); device busy "
          f"{device_ms_:.3f} ms a step ({device_ms_ / window_ms:.0%})")

    # the same loops without the loader's fetch threads (num_workers=0;
    # its prefetch thread stays): what those threads cost the main one
    for label, extra in (("image", {}),
                         ("cached", {"cache_backbone_feats": True})):
        def make(extra=extra, label=label):
            return Trainer(cfg.replace(
                num_workers=0, max_steps=APP_NO_THREADS_STEPS,
                val_freq=APP_NO_THREADS_STEPS,
                checkpoint_freq=APP_NO_THREADS_STEPS,
                experiment_name=f"app_no_threads_{label}", **extra),
                train_dataset=train_ds, val_dataset=val_ds, device=dev)

        builds = ((trunk_launches(-(-len(train_items) // TRAIN_BATCH)),
                   trunk_launches(-(-len(val_items) // TRAIN_BATCH),
                                  VAL_RES)) if extra else
                  (trunk_launches(val_batches, VAL_RES),))
        trainer, run = app_run(
            make, f"{label}, num_workers=0",
            add_counts(steps(APP_NO_THREADS_STEPS, trunk=not extra),
                       *builds))
        no_threads.append(run)
        print(f"  app, {label}, num_workers=0: median "
              f"{float(np.median(np.diff(trainer.step_starts)[APP_WARMUP:])) * 1e3:.2f}"
              f" ms per train step (steps {APP_WARMUP}-"
              f"{APP_NO_THREADS_STEPS - 1})")
        del trainer

    # the cached run's constructor builds both caches: a trunk call a
    # chunk of TRAIN_BATCH images at each split's res
    cached, run3 = app_run(
        lambda: Trainer(cfg.replace(cache_backbone_feats=True,
                                    max_steps=APP_CACHED_STEPS,
                                    experiment_name="app_cached"),
                        train_dataset=train_ds, val_dataset=val_ds,
                        device=dev),
        "cached run", add_counts(
            steps(APP_CACHED_STEPS, trunk=False),
            trunk_launches(-(-len(train_items) // TRAIN_BATCH)),
            trunk_launches(-(-len(val_items) // TRAIN_BATCH), VAL_RES)))
    intervals = np.diff(cached.step_starts)[APP_WARMUP:]
    print(f"  app, cached: median "
          f"{float(np.median(intervals)) * 1e3:.2f} ms per train step, "
          f"the index batch's copy to the device (median) "
          f"{float(np.median(cached.copy_seconds[APP_WARMUP:])) * 1e3:.2f}"
          f" ms, validation epochs "
          + ", ".join(f"{s:.3f}" for s in cached.val_seconds) + " s")
    return add_counts(run1, run2, run3, *no_threads), \
        mgr.checkpoint_path(kept[-1])


# phase soak: tools/soak.py's two runs (straight; cut and resumed) on phase
# app's scenes and KNN table at its footprint, SOAK_STEPS steps with
# validation, a checkpoint and the histograms every SOAK_FREQ, the probes
# reset at SOAK_RESET, the cut run at SOAK_CUT; memory held from SOAK_CUT
SOAK_STEPS, SOAK_FREQ, SOAK_RESET, SOAK_CUT = 300, 50, 150, 100


def phase_soak(dev, tmp, train_items, val_items, nns):
    """The training app's soak (stego_torch/tools/soak.py) at a depth that
    fits this script: both runs of SOAK_STEPS at phase app's footprint,
    every gate of soak.gates (the schedule's rows and histogram sets, the
    loss finite and falling, the kept checkpoints, the probe reset and the
    linear probe's recovery, flat device memory, exact launches a step and
    a validation batch, the resumed run bit for bit the straight one)
    except the accuracy bands and host RSS, which mean nothing this short.
    The main path: the counts are set to 0 just before both runs and must
    be 12 A, 25 L and 1+1 C1 a step and 12 A2 and 25 L a validation batch
    (and soak.code_stats' trunk call a validation) just after. Writes
    under ``tmp``; returns the launches."""
    from stego_torch.config import Config
    from stego_torch.data.contrastive import ContrastiveSegDataset
    from stego_torch.tools import soak

    t0 = time.perf_counter()
    train_ds = ContrastiveSegDataset.from_items(SceneItems(train_items), 27,
                                                nns=nns, num_neighbors=7)
    val_ds = ContrastiveSegDataset.from_items(SceneItems(val_items), 27)
    cfg = Config(dataset_name="cocostuff27", model_type="vit_small",
                 dino_patch_size=8, projection_type="nonlinear", dim=70,
                 backbone_dtype="bfloat16", res=TRAIN_RES, val_res=VAL_RES,
                 batch_size=TRAIN_BATCH, val_batch_size=VAL_BATCH,
                 max_steps=SOAK_STEPS, val_freq=SOAK_FREQ,
                 checkpoint_freq=SOAK_FREQ, hist_freq=SOAK_FREQ,
                 scalar_log_freq=APP_LOG_FREQ, reset_probe_steps=SOAK_RESET,
                 save_top_k=2, output_root=tmp, experiment_name="soak",
                 run_crf=False)
    print(f"soak: tools/soak.py at {SOAK_STEPS} steps on the app's scenes, "
          f"validation, checkpoints and histograms every {SOAK_FREQ}, the "
          f"probes reset at {SOAK_RESET}, a run cut at {SOAK_CUT} and "
          f"resumed")
    torch.cuda.synchronize()
    reset_counts()
    runs, fails = soak.soak(
        cfg, SOAK_CUT, soak.Limits(mem_from=SOAK_CUT,
                                   loss_window=SOAK_STEPS // 10,
                                   rss_growth=None),
        train_dataset=train_ds, val_dataset=val_ds, device=dev)
    torch.cuda.synchronize()
    launches = path_counts()
    steps = sum(r.record["steps"][1] - r.record["steps"][0]
                for r in runs.values())
    vals = sum(r.record["val_s"]["n"] for r in runs.values())
    batches = -(-len(val_items) // VAL_BATCH)
    # each validation: its batches and soak.code_stats' trunk call
    want = add_counts(launches_of(12 * steps, 25 * steps, "pair",
                                  corr_sampled_fwd=steps,
                                  corr_sampled_bwd=steps),
                      trunk_launches(vals * (batches + 1), VAL_RES))
    check(launches == want,
          f"soak: {steps} steps and {vals} validations of {batches} batches "
          f"and a code-statistics call, launches attention/LN/C1 fwd/C1 bwd/"
          f"C2 fwd/C2 bwd "
          f"{tuple(launches[k] for k in COUNTS)}, attention at "
          f"pair/pair_kv {launches['attention_pair']}/"
          f"{launches['attention_pair_kv']}")
    for f in fails:
        check(False, f"soak: {f}")
    straight, resumed = runs["straight"].record, runs["resumed"].record
    mem = [m[1:3] for m in straight["memory_mib"]]
    check(not fails,
          f"soak: every gate of tools/soak.py: the resumed run (from step "
          f"{resumed['steps'][0]}, across the reset at {SOAK_RESET}) ends in "
          f"the straight run's state bit for bit and logs its rows; linear "
          f"mIoU by validation "
          + ", ".join(f"{v[0]}: {v[1]:.2f}" for v in straight["validation"])
          + f"; device memory (allocated, peak MiB) "
          + ", ".join(f"{a:.1f}/{p:.1f}" for a, p in mem)
          + "; the code's norm, pairwise cosine and one direction's share "
          + ", ".join(f"{c[1]:.2f}/{c[2]:.4f}/{c[3]:.4f}"
                      for c in straight["code"]))
    for line in soak.lines(runs, dev):
        for seg in line.get("segments", [line]):
            print(f"  soak, {line['soak']}, steps {seg['steps'][0]}-"
                  f"{seg['steps'][1]}: {seg['wall_s']:.1f} s wall, "
                  f"{seg['images_per_s']:.1f} images/s over the loop, median "
                  f"step {seg['median_step_ms']:.2f} ms, loader wait "
                  f"{seg['loader_wait_share']:.1%}, validation "
                  f"{seg['val_s']['sum']:.2f} s ({seg['val_s']['n']}), "
                  f"checkpoints {seg['ckpt_s']['sum']:.2f} s "
                  f"({seg['ckpt_s']['n']})")
    print(f"  soak: the phase took {time.perf_counter() - t0:.1f} s")
    return launches


# the eval phase: evaluate() on the app's newest .ckpt over its val scenes
# at VAL_RES, batch_size EVAL_BATCH (loader batches of twice that), without
# a CRF, with the grid CRF and with the exact CRF (EXACT_BATCHES batches;
# the scene logits' exact CRF on EXACT_SCENES images); an input whose
# argmaxes the grid CRF moves on fewer than MIN_MOVED of the pixels is not
# counted;
# the grid CRF on the card against the same function on the CPU: every
# argmax equal on CRF_ARGMAX of the pixels, CRF_SHARE of the probabilities
# within CRF_ATOL and a mean |difference| under CRF_MEAN; from the f64
# evaluation, the card's mean error at most F64_RATIO times the CPU's and
# its largest under CRF_F64_MAX, what one f32 rounding of a saturating
# message can move a near-tied pixel (tests/test_torch_crf.py); the grid
# and exact backends agree on GRID_EXACT of the argmaxes
# (tests/test_crf.py:101-143)
EVAL_BATCH, EXACT_BATCHES, EXACT_SCENES, MIN_MOVED = 8, 1, 8, 1e-3
# the exact CRF's run takes batch_size EXACT_BATCH; the grid CRF on the
# CPU, the first CRF_CPU_IMAGES images of the first batch
EXACT_BATCH, CRF_CPU_IMAGES = 4, 8
CRF_ATOL, CRF_SHARE, CRF_MEAN, CRF_ARGMAX, F64_RATIO = 1e-4, 0.995, 2e-6, \
    0.999, 3.0
CRF_F64_MAX = 1e-2
GRID_EXACT = 0.90
EVAL_METRICS = {f"final/{probe}/{m}" for probe in ("linear", "cluster")
                for m in ("mIoU", "Accuracy")}  # the JAX evaluate's keys
# the CRF-loss train run and the CRF app (train_crf_codes: CRF_APP_SCENES
# scenes at res CRF_APP_RES, the app's res // 2 of TRAIN_RES)
CRF_WEIGHT, CRF_APP_EPOCHS, CRF_APP_SCENES, CRF_APP_RES = 0.1, 20, 4, 112


def recount(kept, n_classes, extra):
    """The linear and cluster confusion matrices of the kept (label,
    linear, cluster) batches, counted on the host by np.bincount with the
    reference's mask (utils/metrics.py:21-28)."""
    out = []
    for col, total in ((1, n_classes), (2, n_classes + extra)):
        stats = np.zeros(total * n_classes, np.int64)
        for item in kept:
            label = np.asarray(item[0]).reshape(-1).astype(np.int64)
            pred = np.asarray(item[col]).reshape(-1).astype(np.int64)
            ok = (label >= 0) & (label < n_classes) & (pred >= 0) \
                & (pred < n_classes)
            stats += np.bincount(pred[ok] * n_classes + label[ok],
                                 minlength=total * n_classes)
        out.append(stats.reshape(total, n_classes))
    return out


def eval_run(dev, label, ckpt, val_ds, max_batches=None,
             batch_size=EVAL_BATCH, **cfg_kw):
    """evaluate()'s loop (an Evaluator) over ``val_ds``, the main path: the
    counts are set to 0 just before it and read just after. Gates: 24 A
    (pair_kv) and 50 L launches a batch and no other, the summed confusion
    matrices equal the host's recount of the predictions, finite metrics
    with the JAX keys. Returns the evaluator, the kept (label, linear,
    cluster) batches as host arrays, the first loader batch, the launches
    and the images a second."""
    from stego_torch.config import Config
    from stego_torch.eval.evaluate import Evaluator

    cfg = Config(dataset_name="cocostuff27", res=VAL_RES,
                 batch_size=batch_size, experiment_name="eval", **cfg_kw)
    ev = Evaluator(cfg, ckpt, dev, val_dataset=val_ds)
    kept, first = [], []

    def on_batch(b, lp, cp):
        kept.append((b["label"], lp, cp))
        first[:] = first or [b]

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    metrics = ev.run(save_outputs=False, max_batches=max_batches,
                     on_batch=on_batch)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = path_counts()
    n = len(kept)
    check(launches == launches_of(2 * 12 * n, 2 * 25 * n, "pair_kv"),
          f"eval, {label}: {n} batches of {ev.batch_size} at res {VAL_RES} "
          f"in {sec:.3f} s, {n * ev.batch_size / sec:.1f} images/s; "
          f"launches attention/LN/C1 fwd/C1 bwd/C2 fwd/C2 bwd "
          f"{tuple(launches[k] for k in COUNTS)}, attention at pair_kv "
          f"{launches['attention_pair_kv']}")
    kept = [tuple(x.cpu().numpy() if isinstance(x, torch.Tensor)
                  else np.asarray(x) for x in k) for k in kept]
    lin, clu = recount(kept, ev.seg.n_classes, ev.seg.cfg.extra_clusters)
    check(np.array_equal(ev.linear_metrics.stats, lin)
          and np.array_equal(ev.cluster_metrics.stats, clu),
          f"eval, {label}: the summed confusion matrices ({int(lin.sum())} "
          f"pixels) equal the host's np.bincount of the predictions")
    check(set(metrics) == EVAL_METRICS
          and all(math.isfinite(v) for v in metrics.values()),
          f"eval, {label}: " + ", ".join(
              f"{k}={v:.2f}" for k, v in sorted(metrics.items())))
    return ev, kept, first[0], launches, n * ev.batch_size / sec


def crf_agreement(got, want):
    """(share of equal argmaxes, share within CRF_ATOL, mean |diff|, max
    |diff|) of two (B, H, W, C) probability tensors."""
    d = (got - want).abs()
    return (float((got.argmax(-1) == want.argmax(-1)).float().mean()),
            float((d <= CRF_ATOL).float().mean()), float(d.mean()),
            float(d.max()))


def crf_moved(probs, logits):
    """The share of pixels whose argmax the CRF moved from its input's,
    the logits upsampled as dense_crf upsamples them. Where it moves none,
    as on a probe that is confident everywhere, the CRF's argmax is the
    input's in any backend, and agreement tests nothing."""
    up = torch.nn.functional.interpolate(
        logits.permute(0, 3, 1, 2).float(), size=tuple(probs.shape[1:3]),
        mode="bilinear", align_corners=False).argmax(1)
    return float((probs.argmax(-1) != up).float().mean())


def scene_logits(label, n_classes, stride, gen):
    """(B, h, w, n_classes) logits at the code's resolution (one a patch of
    ``stride``), 2 at each patch centre's label and N(0, 1) noise
    (tests/test_crf.py:101-143's inputs); a pixel without a label (-1)
    gets the noise alone."""
    lab = label[:, stride // 2::stride, stride // 2::stride].long()
    onehot = torch.nn.functional.one_hot(lab.clamp_min(0), n_classes)
    onehot = onehot * (lab >= 0)[..., None]
    noise = torch.randn(onehot.shape, generator=gen, device=label.device)
    return 2.0 * onehot.float() + noise


def eval_vs_plain(evs, img, label):
    """The first loader batch through flip_tta_code and each evaluator's
    eval step with the kernels and with their plain versions (phase
    serving's gates, at the eval's batch); each evaluator's segmenter is
    its own copy of the checkpoint."""
    from stego_torch.eval.evaluate import flip_tta_code

    for name, ev in evs:
        model = ev.seg.net.model
        with torch.inference_mode():
            code = flip_tta_code(ev.seg, img)
            preds = ev.eval_step(img, label)[:2]
            model.use_kernels = False
            try:
                plain_code = flip_tta_code(ev.seg, img)
                plain_preds = ev.eval_step(img, label)[:2]
            finally:
                model.use_kernels = True
        diff = (code - plain_code).abs()
        check(bool(torch.isfinite(code).all())
              and float(diff.max()) <= CODE_MAX_ABS
              and float(diff.mean()) <= CODE_MEAN_ABS,
              f"eval, {name}: the first batch's code {tuple(code.shape)} vs "
              f"plain versions: max abs {float(diff.max()):.3e} (<= "
              f"{CODE_MAX_ABS}), mean abs {float(diff.mean()):.3e} (<= "
              f"{CODE_MEAN_ABS})")
        for probe, got, want in zip(("linear", "cluster"), preds,
                                    plain_preds):
            agree = float((got == want).float().mean())
            check(got.shape == label.shape and agree >= PRED_AGREE,
                  f"eval, {name}: the first batch's {probe} predictions "
                  f"{tuple(got.shape)} agree with plain on {agree:.4%} "
                  f"(>= {PRED_AGREE:.0%})")


def phase_eval(dev, tmp, ckpt, val_items):
    """The dataset eval (stego_torch/eval/evaluate.py) of the app's newest
    checkpoint over its VAL_IMAGES val scenes at VAL_RES: without a CRF,
    with the grid CRF on the card and with the exact CRF on the host
    (EXACT_BATCHES batches), each with eval_run's gates; the first batch's
    code and predictions with the kernels against their plain versions;
    the grid CRF on that batch (both probes' log-probs and scene logits
    made from its labels) against the same function on the CPU and in
    f64, its device ms a batch, and against the exact CRF; the PNG trees
    of save_outputs. A probe whose argmaxes the grid CRF moves on fewer
    than MIN_MOVED of the pixels is named and not counted: its argmax is no
    test. Returns the launches of the three runs."""
    from stego_torch.data.contrastive import ContrastiveSegDataset
    from stego_torch.eval.evaluate import make_eval_step
    from stego_torch.ops.crf import bilateral_kernel, dense_crf
    from stego_torch.ops.crf_exact import dense_crf_exact_batch_multi

    t_phase = time.perf_counter()
    val_ds = ContrastiveSegDataset.from_items(SceneItems(val_items), 27)
    print(f"eval: evaluate() of {os.path.basename(os.path.dirname(ckpt))}/"
          f"{os.path.basename(ckpt)} (the app's newest) over "
          f"{len(val_items)} val scenes at res {VAL_RES}, batch_size "
          f"{EVAL_BATCH} (loader batches of {2 * EVAL_BATCH}), flip-TTA, "
          f"ViT-S/8 bf16 trunk")
    ev0, _, batch, run1, _ = eval_run(dev, "no CRF", ckpt, val_ds,
                                      run_crf=False)
    ev, grid_kept, _, run2, _ = eval_run(dev, "grid CRF", ckpt, val_ds,
                                         run_crf=True, crf_backend="grid")
    ev_x, exact_kept, _, run3, _ = eval_run(
        dev, "exact CRF", ckpt, val_ds, max_batches=EXACT_BATCHES,
        batch_size=EXACT_BATCH, run_crf=True, crf_backend="exact")
    n_exact = EXACT_BATCHES * ev_x.batch_size
    print(f"  eval, exact CRF: host {sum(ev_x.crf_seconds) / n_exact:.3f} s "
          f"an image ({os.cpu_count()} CPU cores, "
          f"{len(ev_x.crf_seconds)} batches of {ev_x.batch_size})")

    img = torch.from_numpy(np.asarray(batch["img"])).to(dev)
    label = torch.from_numpy(np.asarray(batch["label"])).to(dev)
    eval_vs_plain((("no CRF", ev0), ("grid CRF", ev)), img, label)

    # the grid CRF on the first batch: card, CPU and f64, on the probes'
    # log-probs and on scene logits that are never flat
    lp, cp, img01 = make_eval_step(ev.seg, return_probs=True)(img, label)
    scene = scene_logits(label, ev.seg.n_classes, ev.seg.vit_cfg.patch_size,
                         torch.Generator(device=dev).manual_seed(5))
    inputs = {"linear log-probs": lp, "cluster log-probs": cp,
              "scene logits": scene}

    def grid(device, dtype=torch.float32, names=tuple(inputs), n=None):
        """The grid CRF of the first ``n`` images (all: None)."""
        im = img01[:n].to(device, dtype)
        kern = bilateral_kernel(im)
        return {k: dense_crf(im, inputs[k][:n].to(device, dtype), kern=kern)
                for k in names}

    card = grid(dev)
    moved = {k: crf_moved(c, inputs[k]) for k, c in card.items()}
    check(moved["scene logits"] >= MIN_MOVED, f"eval: the grid CRF moves "
          f"{moved['scene logits']:.4f} of the scene logits' argmaxes (>= "
          f"{MIN_MOVED:g})")
    for k in inputs:
        if moved[k] < MIN_MOVED:
            print(f"  eval: grid CRF of the {k}: moves {moved[k]:.2e} of "
                  f"the argmaxes (< {MIN_MOVED:g}), not counted")
    counted = tuple(k for k in inputs if moved[k] >= MIN_MOVED)
    t0 = time.perf_counter()
    cpu = grid("cpu", names=counted, n=CRF_CPU_IMAGES)
    cpu_s = time.perf_counter() - t0
    ref = grid(dev, torch.float64, names=counted, n=CRF_CPU_IMAGES)
    for k in counted:
        c, h, r = card[k][:CRF_CPU_IMAGES], cpu[k].to(dev), ref[k]
        argmax, share, mean, mx = crf_agreement(c, h)
        card_f64 = [float(f((c.double() - r).abs())) for f in (torch.max,
                                                              torch.mean)]
        cpu_f64 = [float(f((h.double() - r).abs())) for f in (torch.max,
                                                             torch.mean)]
        check(argmax >= CRF_ARGMAX and share >= CRF_SHARE and mean <= CRF_MEAN
              and card_f64[1] <= F64_RATIO * max(cpu_f64[1], 1e-12)
              and card_f64[0] <= CRF_F64_MAX,
              f"eval: grid CRF of the {k}, card vs CPU "
              f"({c.shape[0]}x{VAL_RES}x{VAL_RES}, {c.shape[-1]} classes,"
              f" {moved[k]:.4f} of the argmaxes moved): argmax equal "
              f"{argmax:.6f}, within {CRF_ATOL:g} {share:.6f}, mean |diff| "
              f"{mean:.2e}, max {mx:.2e}; from f64: card max "
              f"{card_f64[0]:.2e} mean {card_f64[1]:.2e}, CPU max "
              f"{cpu_f64[0]:.2e} mean {cpu_f64[1]:.2e}")

    # grid against exact: the eval runs' first batch, and the scene logits
    # on its first EXACT_SCENES images
    for i, k in ((1, "linear log-probs"), (2, "cluster log-probs")):
        n = len(exact_kept[0][i])
        agree = float(np.mean(grid_kept[0][i][:n] == exact_kept[0][i]))
        if moved[k] < MIN_MOVED:
            print(f"  eval: grid and exact CRF agree on {agree:.4f} of the "
                  f"first batch's argmaxes of the {k}: the grid CRF moves "
                  f"{moved[k]:.2e} of them, not counted")
            continue
        check(agree >= GRID_EXACT, f"eval: grid and exact CRF agree on "
              f"{agree:.4f} of the argmaxes of the {k} of the first batch's "
              f"first {n} images")
    t0 = time.perf_counter()
    exact = dense_crf_exact_batch_multi(
        img01[:EXACT_SCENES].cpu().numpy(),
        [scene[:EXACT_SCENES].cpu().numpy()])[0]
    exact_s = time.perf_counter() - t0
    agree = float(np.mean(exact.argmax(-1) == card["scene logits"]
                          [:EXACT_SCENES].argmax(-1).cpu().numpy()))
    check(agree >= GRID_EXACT, f"eval: grid and exact CRF agree on "
          f"{agree:.4f} of the argmaxes of the scene logits on "
          f"{EXACT_SCENES} images (exact: {exact_s:.2f} s on the host)")

    del card, cpu, ref
    by_kernel = kernel_times(lambda: grid(dev, names=("linear log-probs",
                                                      "cluster log-probs")))
    crf_ms = sum(by_kernel.values()) / 1e3
    print(f"  eval: grid CRF of one batch (both probes, the bilateral kernel "
          f"built once): device {crf_ms:.3f} ms (profiler); on the CPU, "
          f"{', '.join(counted)}: {cpu_s:.2f} s; top kernels:")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    {us / 1e3:8.3f} ms  {name[:90]}")

    # save_outputs: the PNG trees; each figure matplotlib cannot draw is
    # named on a line
    from stego_torch.config import Config
    from stego_torch.eval.evaluate import evaluate

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        evaluate(Config(dataset_name="cocostuff27", res=VAL_RES,
                        batch_size=EVAL_BATCH, run_crf=False,
                        experiment_name="eval"),
                 ckpt, dev, val_dataset=val_ds, max_batches=1)
    finally:
        os.chdir(cwd)
    out = os.path.join(tmp, "results", "predictions", "eval")
    trees = {t: len(os.listdir(os.path.join(out, t)))
             for t in ("img", "label", "cluster", "linear")}
    check(set(trees.values()) == {min(5, ev.batch_size)},
          f"eval: save_outputs wrote the PNG "
          f"trees {trees} under results/predictions/eval")
    print(f"  eval: the phase took {time.perf_counter() - t_phase:.1f} s")
    return add_counts(run1, run2, run3)


def phase_crf_loss(dev):
    """CRF_WEIGHT of the in-training CRF loss at the reference footprint:
    WIDE_STEPS sampled steps (train_run's gates: 12 A, 25 L, 1+1 C1 a
    step, the loss falls, one step against the plain loss's); then the CRF
    app, CRF_APP_EPOCHS epochs of train_crf_codes on CRF_APP_SCENES
    scenes, whose loss must be finite and fall. Returns the train run's
    launches."""
    from stego_torch.config import Config
    from stego_torch.train.crf_app import train_crf_codes

    _, _, launches = train_run(
        dev, f"CRF loss (crf_weight={CRF_WEIGHT}, 1000 samples of 56x56) "
        f"beside the sampled loss (kernel C1)", WIDE_STEPS, (0,),
        (12, 25, 1, 1, 0, 0), 3, crf_weight=CRF_WEIGHT)
    imgs = np.stack([render((2, i, CRF_APP_RES))[0]
                     for i in range(CRF_APP_SCENES)])
    cfg = Config(dim=70, res=2 * CRF_APP_RES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_crf_codes(cfg, imgs, epochs=CRF_APP_EPOCHS, log_every=1,
                          device=dev)
    sec = time.perf_counter() - t0
    losses = out["losses"]
    check(len(losses) == CRF_APP_EPOCHS and bool(np.isfinite(losses).all())
          and losses[-3:].mean() < losses[:3].mean(),
          f"CRF app: train_crf_codes, {CRF_APP_EPOCHS} epochs on "
          f"{CRF_APP_SCENES} scenes at res {CRF_APP_RES} (dim 70, "
          f"{cfg.crf_samples} samples) in {sec:.2f} s: loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    return launches


# phase ddp: the train step, the app, the dataset eval and the KNN build on
# DDP_WORLD processes of this card over gloo (NCCL refuses two ranks on one
# device), each a child `chip_smoke.py --ddp-child`, held against one
# process on the whole global batch; and one rank over NCCL
DDP_WORLD, DDP_SEED, DDP_TIMEOUT = 2, 1000, 600
# Local negatives run C1 on each rank and their reference C2's emulation of
# the blocks; from bf16 features those two round the samples to bf16 at
# other points (gradients 1.7e-4 of their largest apart, a CPU run at res
# 32), and a first Adam step turns that into sign flips of the near-zero
# gradients, past the parameter gate. So that case takes an f32 trunk
# (kernel A-f32, LayerNorm plain), where they agree to 1e-7.
DDP_CASES = {"local": dict(negatives_scope="local", backbone_dtype="float32",
                           use_flash_attention=True),  # C1 on each rank
             "global": {},  # C2 over the gathered maps' rows
             "full_field": dict(full_field_loss=True)}  # C2, whole maps
DDP_STEPS = {"local": 3, "global": 3, "full_field": 2}
# The feature-pyramid cases: ResNet-50, granularity FPN_GRANULARITY, dim 70,
# res 224, TRAIN_BATCH // DDP_WORLD images a rank, the head's train-mode
# BatchNorms on the global batch's statistics (all-reduced,
# models/fpn.py:batch_stats). Global negatives on a bf16 trunk (C2's gather
# route at 2048 channels over the gathered maps), local ones on an f32
# trunk (C1 at 2048 channels on each rank), for the local ViT case's
# reason above. The control: the global case with each rank's BatchNorms
# on its own batch (models/fpn.py:local_stats), which must fail the
# running statistics' gate. The FPN app's steps (validation and a
# checkpoint at half and at the end).
FPN_DDP = dict(model_type="resnet50", arch="feature-pyramid",
               granularity=FPN_GRANULARITY)
FPN_DDP_CASES = {"fpn_global": FPN_DDP,
                 "fpn_local": dict(FPN_DDP, negatives_scope="local",
                                   backbone_dtype="float32")}
FPN_CONTROL = "fpn_own_stats"
DDP_STEPS.update(fpn_global=3, fpn_local=3, fpn_own_stats=1)
DDP_FPN_APP_STEPS = 4
# the app's scenes (the first of the train and val splits), steps (a cut
# and a resume at half), global validation and eval batches
DDP_TRAIN, DDP_VAL, DDP_APP_STEPS, DDP_VAL_BATCH, DDP_EVAL_BATCH = \
    64, 24, 16, 8, 4


def ddp_batch(dev):
    """A seeded global batch at the train footprint: the first half's labels
    (rank 0's rows) 60% ignore pixels, the second half's 10%, so that a
    per-rank mean of the probe's loss differs from the global one."""
    g = torch.Generator().manual_seed(11)
    img = images(g, TRAIN_RES, "cpu", TRAIN_BATCH)
    out = {"img": img, "img_pos": img + 0.05 * torch.randn(img.shape,
                                                           generator=g)}
    for key in ("label", "label_pos"):
        label = torch.randint(0, 27, (TRAIN_BATCH, TRAIN_RES, TRAIN_RES),
                              generator=g, dtype=torch.int32)
        share = torch.tensor([0.6, 0.1]).repeat_interleave(TRAIN_BATCH // 2)
        label[torch.rand(label.shape, generator=g) < share[:, None, None]] = -1
        out[key] = label
    return {k: v.to(dev) for k, v in out.items()}


def trainable_flat(seg):
    return torch.cat([p.detach().reshape(-1).cpu()
                      for n, p in seg.named_parameters()
                      if not n.startswith("net.model.")])


def head_buffers(seg):
    """The buffers outside the frozen trunk (the feature-pyramid head's
    BatchNorm running statistics and their counts), on the CPU."""
    return {n: b.detach().cpu().clone() for n, b in seg.named_buffers()
            if not n.startswith("net.model.")}


def grads_flat(seg, prefix=""):
    """The gradients of the trainable parameters named ``prefix``*, flat
    in trainable_flat's order, on the CPU; inf for a parameter without one
    (no loss reached it: it is held wherever ADAM_LIVE decides)."""
    return torch.cat([(p.grad if p.grad is not None else torch.full_like(
        p, math.inf)).detach().reshape(-1).cpu()
        for n, p in seg.named_parameters()
        if not n.startswith("net.model.") and n.startswith(prefix)])


def head_state(seg):
    """The segmenter's state that its train steps change: every parameter
    and buffer outside the frozen trunk, the optimizers' states and the
    step count (on the CPU)."""
    return {"params": {n: p.detach().cpu().clone()
                       for n, p in seg.named_parameters()
                       if not n.startswith("net.model.")},
            "buffers": head_buffers(seg),
            "opts": {k: copy.deepcopy(o.state_dict())
                     for k, o in seg.optimizers().items()},
            "step": seg.step}


def load_head_state(seg, state):
    with torch.no_grad():
        for n, p in seg.named_parameters():
            if n in state["params"]:
                p.copy_(state["params"][n])
        for n, b in seg.named_buffers():
            if n in state["buffers"]:
                b.copy_(state["buffers"][n])
    for k, o in seg.optimizers().items():
        o.load_state_dict(state["opts"][k])
    seg.step = state["step"]


def adam_rms(seg):
    """The root of each trainable parameter's bias-corrected Adam second
    moment, in trainable_flat's order (inf where it has no state): the
    size of gradient below which an f32 rounding of it moves the
    parameter by more than the parameter tolerance (lr m / (sqrt(v) +
    1e-8); |g| on the first step)."""
    rms = {}
    for o in seg.optimizers().values():
        for group in o.param_groups:
            beta2 = group["betas"][1]
            for p in group["params"]:
                st = o.state.get(p)
                if st:
                    rms[p] = (st["exp_avg_sq"]
                              / (1 - beta2 ** float(st["step"]))).sqrt()
    return torch.cat([rms.get(p, torch.full_like(p, math.inf)).detach()
                      .reshape(-1).cpu()
                      for n, p in seg.named_parameters()
                      if not n.startswith("net.model.")])


def ddp_steps(dev, name, batch, reference=False, states=None):
    """DDP_STEPS[name] train steps of a seeded ViT-S/8 segmenter on this
    process's rows of ``batch``, with the global batch's draws from
    generators seeded DDP_SEED + step, the main path (counts and collective
    time from 0). ``reference``: one process on the whole batch, on C2's
    route (fused_sampling="off"); for local negatives with C2's emulation
    of DDP_WORLD blocks (corr_stream.py:687-693); for the feature-pyramid
    cases with its trunk called as the ranks call it (rank_trunk); with
    ``states`` (a
    rank's head_state after each of its steps) each step after the first
    starts from the rank's state after the step before, so that every step
    of the ranks is held against the one-process step from the same state;
    without, its own trajectory, with each step's adam_rms.
    Returns each step's metrics, trainable parameters, head buffers, net
    gradients and wall ms, the launches, the collectives' calls and host
    ms, over several processes the head_state after each step and the
    device busy ms of one more step. The feature-pyramid cases
    (FPN_DDP_CASES, FPN_CONTROL) likewise, on their ResNet-50 segmenter;
    the control's steps take models/fpn.py:local_stats for the BatchNorms'
    statistics."""
    from stego_torch.models import fpn
    from stego_torch.parallel import dist
    from stego_torch.train.segmenter import (draw_step_randomness,
                                             make_train_step)

    kw = dict({**DDP_CASES, **FPN_DDP_CASES, FPN_CONTROL: FPN_DDP}[name])
    if reference and name != "full_field":
        kw["fused_sampling"] = "off"
    seg = cocostuff_segmenter(dev, **kw)
    if reference and name.startswith("fpn"):
        rank_trunk(seg)
    if reference and kw.get("negatives_scope") == "local":
        seg.corr_cfg = dataclasses.replace(seg.corr_cfg, neg_blocks=DDP_WORLD)
    step = make_train_step(seg, with_hist=False)
    rows = dist.local_rows(TRAIN_BATCH)
    local = {k: v[rows] for k, v in batch.items()}
    gen = torch.Generator(device=dev)
    out = {"metrics": [], "params": [], "buffers": [], "grads": [],
           "net_grads": [], "ms": [], "states": [], "rms": []}
    kept = fpn.batch_stats
    if name == FPN_CONTROL:
        fpn.batch_stats = fpn.local_stats
    torch.cuda.synchronize()
    reset_counts()
    calls, secs = dist.CALLS, dist.SECONDS
    for i in range(DDP_STEPS[name]):
        if states is not None and i > 0:
            load_head_state(seg, states[i - 1])
        gen.manual_seed(DDP_SEED + i)
        rand = draw_step_randomness(seg, TRAIN_BATCH, gen)
        t0 = time.perf_counter()
        m = step(local, rand)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append(trainable_flat(seg))
        if name.startswith("fpn"):
            out["buffers"].append(head_buffers(seg))
            out["grads"].append(grads_flat(seg))
            out["net_grads"].append(grads_flat(seg, "net."))
        if reference and states is None:
            out["rms"].append(adam_rms(seg))
        if dist.initialized():
            out["states"].append(head_state(seg))
    fpn.batch_stats = kept
    out["launches"] = path_counts()
    out["collective_calls"] = dist.CALLS - calls
    out["collective_ms"] = (dist.SECONDS - secs) * 1e3
    if dist.initialized():
        out["busy_ms"] = sum(kernel_times(lambda: step(local, rand))
                             .values()) / 1e3
    return out


class ImageItems:
    """Scenes as a dataset of {"img": ...} items, the KNN loader's."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return {"img": self.items[i][0]}


def ddp_knn(dev, tmp, items):
    """build_knn_cache over this process's stripe of the batches of
    TRAIN_BATCH scenes (train/knn.py:stripe_loader), a seeded bf16 trunk,
    the main path. Returns nns and the launches."""
    from stego_torch.train.knn import build_knn_cache, stripe_loader

    net = cocostuff_segmenter(dev).net
    loader, rows = stripe_loader(ImageItems(items), TRAIN_BATCH)
    path = os.path.join(tmp, "nns", "nns_ddp.npz")
    torch.cuda.synchronize()
    reset_counts()
    nns = build_knn_cache(path, net, loader, k=KNN_K, rows=rows,
                          n=len(items))
    return nns, path_counts()


def ddp_app_cfg(tmp):
    from stego_torch.config import Config

    return Config(dataset_name="cocostuff27", model_type="vit_small",
                  dino_patch_size=8, projection_type="nonlinear", dim=70,
                  backbone_dtype="bfloat16", res=TRAIN_RES, val_res=VAL_RES,
                  batch_size=TRAIN_BATCH, val_batch_size=DDP_VAL_BATCH,
                  max_steps=DDP_APP_STEPS, val_freq=DDP_APP_STEPS // 2,
                  checkpoint_freq=DDP_APP_STEPS // 2, scalar_log_freq=4,
                  hist_freq=0, save_top_k=2, output_root=tmp,
                  run_crf=False, num_workers=2)


def val_confusion(seg, val_step, batches):
    """The confusion matrices of ``batches`` (host dicts) through
    ``val_step``, summed over the ranks (merge_stats)."""
    from stego_torch.utils.metrics import UnsupervisedMetrics

    dev = next(seg.parameters()).device
    conf = None
    for b in batches:
        out = val_step({k: torch.from_numpy(np.asarray(b[k])).to(dev)
                        for k in ("img", "label")})
        pair = (out["conf_linear"], out["conf_cluster"])
        conf = pair if conf is None else (conf[0] + pair[0],
                                          conf[1] + pair[1])
    stats = []
    for c, extra in zip(conf, (0, seg.cfg.extra_clusters)):
        m = UnsupervisedMetrics("", seg.n_classes, extra, False)
        m.merge_stats(c)
        stats.append(m.stats)
    return stats


def ddp_app(dev, tmp, train, val, nns):
    """The app on this process's share: train() straight to
    DDP_APP_STEPS (a validation and a checkpoint at half and at the end),
    the same cut at half and resumed; the trained segmenter's validation
    matrices over the ranks; evaluate() of its newest .ckpt. Counts from 0
    before the runs. Returns what phase ddp holds."""
    from stego_torch.data.contrastive import ContrastiveSegDataset
    from stego_torch.data.loader import pad_batch
    from stego_torch.eval.evaluate import Evaluator
    from stego_torch.train.app import Trainer

    cfg = ddp_app_cfg(tmp)
    train_ds = ContrastiveSegDataset.from_items(SceneItems(train), 27,
                                                nns=nns, num_neighbors=7)
    val_ds = ContrastiveSegDataset.from_items(SceneItems(val), 27)

    def run(c):
        t = Trainer(c, train_dataset=train_ds, val_dataset=val_ds,
                    device=dev)
        t.run()
        return t

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    straight = run(cfg.replace(experiment_name="ddp_straight"))
    app_s = time.perf_counter() - t0
    cut = cfg.replace(experiment_name="ddp_cut",
                      max_steps=DDP_APP_STEPS // 2)
    run(cut)
    resumed = run(cut.replace(max_steps=DDP_APP_STEPS, resume=True))
    val = val_confusion(straight.seg, straight.val_step,
                        [pad_batch(b, straight.val_bs)
                         for b in straight.val_loader])
    launches = path_counts()
    sd_a, sd_b = straight.seg.state_dict(), resumed.seg.state_dict()
    gap = max(float((sd_a[k].float() - sd_b[k].float()).abs().max())
              for k in sd_a)
    ckpt = straight.mgr.checkpoint_path()
    reset_counts()
    ev = Evaluator(cfg.replace(res=VAL_RES, batch_size=DDP_EVAL_BATCH,
                               experiment_name="ddp_eval"),
                   ckpt, dev, val_dataset=val_ds)
    ev.run(save_outputs=True)
    return {"app_launches": launches, "eval_launches": path_counts(),
            "resumed_start": resumed.start_step, "resume_gap": gap,
            "app_s": app_s, "val": val, "ckpt": ckpt,
            "eval": (ev.linear_metrics.stats, ev.cluster_metrics.stats),
            "params": trainable_flat(straight.seg)}


def ddp_fpn_cfg(tmp):
    """The FPN app's config: ddp_app_cfg's footprint on the
    feature-pyramid arch (bf16 trunk, global negatives), validated at
    TRAIN_RES (granularity 4 concatenates the image at 56 x 56, which
    needs res 224)."""
    return ddp_app_cfg(tmp).replace(
        arch="feature-pyramid", model_type="resnet50",
        granularity=FPN_GRANULARITY, val_res=TRAIN_RES,
        max_steps=DDP_FPN_APP_STEPS,
        val_freq=DDP_FPN_APP_STEPS // 2,
        checkpoint_freq=DDP_FPN_APP_STEPS // 2, scalar_log_freq=1,
        experiment_name="ddp_fpn")


def ddp_fpn_app(dev, tmp, train, val, nns):
    """The feature-pyramid app on this process's share: train() to
    DDP_FPN_APP_STEPS (a validation and a checkpoint at half and at the
    end), then evaluate() of its newest .ckpt. Counts from 0 before each.
    Returns what phase ddp holds."""
    from stego_torch.data.contrastive import ContrastiveSegDataset
    from stego_torch.eval.evaluate import Evaluator
    from stego_torch.train.app import Trainer

    cfg = ddp_fpn_cfg(tmp)
    train_ds = ContrastiveSegDataset.from_items(SceneItems(train), 27,
                                                nns=nns, num_neighbors=7)
    val_ds = ContrastiveSegDataset.from_items(SceneItems(val), 27)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, train_dataset=train_ds, val_dataset=val_ds,
                      device=dev)
    metrics = trainer.run()
    app_s = time.perf_counter() - t0
    launches = path_counts()
    ckpt = trainer.mgr.checkpoint_path()
    reset_counts()
    ev = Evaluator(cfg.replace(res=TRAIN_RES, batch_size=DDP_EVAL_BATCH,
                               experiment_name="ddp_fpn_eval"),
                   ckpt, dev, val_dataset=val_ds)
    ev.run(save_outputs=False)
    return {"app_launches": launches, "eval_launches": path_counts(),
            "app_s": app_s, "metrics": metrics, "ckpt": ckpt,
            "step": trainer.seg.step,
            "eval": (ev.linear_metrics.stats, ev.cluster_metrics.stats),
            "params": trainable_flat(trainer.seg),
            "buffers": head_buffers(trainer.seg)}


def ddp_child(args) -> int:
    """``chip_smoke.py --ddp-child <json>``: one rank of phase ddp. Joins
    the group (``backend`` on ``device``), runs the step cases ``cases``,
    and with ``app`` the KNN build, the app and the eval, and the
    feature-pyramid app and its eval, on the scenes of ``data``, in the
    working directory ``tmp``; writes its results to
    ``out`` (torch.save) and prints one JSON line. ``reference``: the
    cases in their one-process configuration (ddp_steps)."""
    opts = json.loads(args[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stego_torch.kernels import build
    from stego_torch.parallel import dist

    dev = torch.device(opts["device"])
    build.library()
    dist.maybe_initialize_distributed(
        backend=opts["backend"], device=dev, rank=opts["rank"],
        world_size=opts["world"], timeout_s=DDP_TIMEOUT,
        init_method=f"tcp://localhost:{opts['port']}")
    try:
        batch = ddp_batch(dev)
        out = {name: ddp_steps(dev, name, batch, opts["reference"])
               for name in opts["cases"]}
        if opts["app"]:
            with np.load(opts["data"]) as f:
                train = list(zip(f["train_img"], f["train_label"]))
                val = list(zip(f["val_img"], f["val_label"]))
                f_val = {k: f[k] for k in ("fpn_val_img", "fpn_val_label")}
            out["nns"], out["knn_launches"] = ddp_knn(dev, opts["tmp"], train)
            out["app"] = ddp_app(dev, opts["tmp"], train, val, out["nns"])
            fpn_val = list(zip(f_val["fpn_val_img"], f_val["fpn_val_label"]))
            out["fpn_app"] = ddp_fpn_app(dev, opts["tmp"], train, fpn_val,
                                         out["nns"])
        torch.save(out, opts["out"])
    finally:
        dist.destroy()
    print(json.dumps({name: {"ms": out[name]["ms"],
                             "busy_ms": out[name].get("busy_ms")}
                      for name in opts["cases"]}))
    return 0


def start_ddp(tmp, tag, backend, devices, cases, app, data=None,
              reference=False):
    """Start one ``--ddp-child`` a device of ``devices`` (its rank), over
    ``backend``, working in ``tmp``; returns the processes and their
    output and log paths."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank, device in enumerate(devices):
        out = os.path.join(tmp, f"ddp_{tag}_{rank}.pt")
        opts = dict(rank=rank, world=len(devices), port=port,
                    backend=backend, device=device, cases=cases, app=app,
                    data=data, tmp=tmp, out=out, reference=reference)
        log = open(os.path.join(tmp, f"ddp_{tag}_{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ddp-child",
             json.dumps(opts)], cwd=tmp, stdout=log,
            stderr=subprocess.STDOUT, text=True), out, log))
    return procs


def finish_ddp(tag, procs):
    """Wait for every rank (at most DDP_TIMEOUT s; a rank still running
    then is killed); a rank that fails fails the phase. Returns each
    rank's results, or None."""
    deadline = time.perf_counter() + DDP_TIMEOUT
    codes = []
    for p, _, log in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline
                                            - time.perf_counter())))
        except subprocess.TimeoutExpired:
            codes.append("timeout")
    for p, _, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    ok = check(codes == [0] * len(procs),
               f"ddp {tag}: ranks' exit codes {codes}")
    if not ok:
        for p, _, log in procs:
            with open(log.name) as f:
                print("\n".join(f.read().splitlines()[-40:]))
        return None
    return [torch.load(out, weights_only=False) for _, out, _ in procs]


def hold_ddp_steps(tag, ranks, refs, names, step_launches):
    """Each case's ranks against one process: parameters equal bit for
    bit between the ranks after every step; every rank's metrics and
    parameters within the train step's gates of the reference's; each
    rank's launches. Prints ms a step, device busy and the collectives'
    time, by rank."""
    for name in names:
        ref = refs[name]
        for i in range(DDP_STEPS[name]):
            check(all(torch.equal(r[name]["params"][i],
                                  ranks[0][name]["params"][i])
                      for r in ranks),
                  f"ddp {tag} {name}: step {i}, the ranks' parameters are "
                  f"equal bit for bit")
        for k, r in enumerate(ranks):
            got, want = r[name], ref
            bad = [(i, key) for i, (gm, wm) in enumerate(
                zip(got["metrics"], want["metrics"]))
                for key in wm
                if not math.isclose(gm[key], wm[key], rel_tol=LOSS_RTOL,
                                    abs_tol=LOSS_ATOL)]
            gap = max(float(((a - b).abs() - GRAD_ATOL
                             - GRAD_RTOL * b.abs()).max())
                      for a, b in zip(got["params"], want["params"]))
            check(not bad and gap <= 0 and got["metrics"][-1].keys()
                  == want["metrics"][-1].keys(),
                  f"ddp {tag} {name}, rank {k}: {DDP_STEPS[name]} steps' "
                  f"metrics within rtol {LOSS_RTOL} atol {LOSS_ATOL} of one "
                  f"process on the whole batch (off: {bad[:3]}), parameters "
                  f"within rtol {GRAD_RTOL} atol {GRAD_ATOL} (worst excess "
                  f"{gap:.3e}); loss/total "
                  f"{got['metrics'][-1]['loss/total']:.6f} vs "
                  f"{want['metrics'][-1]['loss/total']:.6f}")
            check(got["launches"] == step_launches(name),
                  f"ddp {tag} {name}, rank {k}: launches attention/LN/C1 "
                  f"fwd/C1 bwd/C2 fwd/C2 bwd "
                  f"{tuple(got['launches'][c] for c in COUNTS)}")
            n = DDP_STEPS[name]
            busy = got.get("busy_ms")
            print(f"  ddp {tag} {name}, rank {k}: "
                  f"{statistics.median(got['ms']):.2f} ms a step (wall clock, median of {n}; steps "
                  + ", ".join(f"{t:.1f}" for t in got["ms"])
                  + f"), device busy "
                  + ("not measured" if busy is None else f"{busy:.3f} ms")
                  + f" a step, collectives {got['collective_calls'] / n:.1f}"
                  f" calls and {got['collective_ms'] / n:.2f} ms (host "
                  f"clock; gloo's collective on a CUDA tensor first waits "
                  f"for the work queued before it) a step; one process on "
                  f"the whole batch "
                  f"{statistics.median(ref['ms']):.2f} ms a step")


def hold_ddp_trajectories(tag, ranks, trajs, names):
    """Each case's ranks against one process's own DDP_STEPS[name] steps
    from the same seeded start (not from the ranks' states): metrics
    within the train step's gates after every step, and parameters within
    them everywhere on the bf16 trunks, and on the f32 trunk's case where
    the one-process adam_rms is at least ADAM_LIVE_TRAJECTORY (a ReLU
    decided the other way by an f32 rounding moves a row's gradient by
    one pixel's share, which Adam's moments carry into the parameter
    where sqrt(v) is small); prints how many entries that leaves out and
    how far those are off."""
    for name in names:
        want = trajs[name]
        f32 = DDP_CASES[name].get("backbone_dtype") == "float32"
        for k, r in enumerate(ranks):
            got = r[name]
            bad = [(i, key) for i, (gm, wm) in enumerate(
                zip(got["metrics"], want["metrics"]))
                for key in wm
                if not math.isclose(gm[key], wm[key], rel_tol=LOSS_RTOL,
                                    abs_tol=LOSS_ATOL)]
            gap, held, out, out_over, out_worst = -math.inf, 0, 0, 0, None
            where = None
            for i, (a, b, rms) in enumerate(zip(got["params"],
                                                want["params"],
                                                want["rms"])):
                live = (rms >= ADAM_LIVE_TRAJECTORY if f32 else
                        torch.ones_like(b, dtype=torch.bool))
                excess = (a - b).abs() - GRAD_ATOL - GRAD_RTOL * b.abs()
                kept = torch.where(live, excess, -math.inf)
                held += int(live.sum())
                out += int((~live).sum())
                out_over += int(((~live) & (excess > 0)).sum())
                if float(kept.max()) > gap:
                    j = int(kept.argmax())
                    gap, where = float(kept.max()), (i, j, float(rms[j]))
                left = torch.where(live, -math.inf, excess)
                if out and float(left.max()) > 0 and (
                        out_worst is None or float(left.max()) > out_worst[0]):
                    j = int(left.argmax())
                    out_worst = (float(left.max()), i, j, float(rms[j]))
            check(not bad and gap <= 0,
                  f"ddp {tag} {name}, rank {k}: its {DDP_STEPS[name]} steps "
                  f"against one process's own trajectory on the whole "
                  f"batch: metrics within rtol {LOSS_RTOL} atol {LOSS_ATOL} "
                  f"(off: {bad[:3]}), parameters within rtol {GRAD_RTOL} "
                  f"atol {GRAD_ATOL}"
                  + (f" where Adam's sqrt(v) >= {ADAM_LIVE_TRAJECTORY}"
                     if f32 else "")
                  + f" ({held} held, worst excess {gap:.3e} at step, entry, "
                  f"sqrt(v) {where})"
                  + (f"; left out {out}, of them {out_over} over the gate "
                     f"(worst excess, step, entry, sqrt(v): {out_worst})"
                     if f32 else ""))


def running_excess(got, want):
    """The largest excess of ``got``'s running statistics (head_buffers)
    over the parameter gate against ``want``'s, and where: variances
    within rtol GRAD_RTOL, atol GRAD_ATOL; means within GRAD_RTOL of their
    channel's |mean| + running std (the scale of a mean's f32 rounding,
    and the one at which the norm reads it) and GRAD_ATOL."""
    worst = (-math.inf, None)
    for k, w in want.items():
        if k.endswith("running_var"):
            scale = w.abs()
        elif k.endswith("running_mean"):
            scale = w.abs() + want[k[:-len("mean")] + "var"].sqrt()
        else:
            continue
        excess = (got[k] - w).abs() - GRAD_ATOL - GRAD_RTOL * scale
        i = int(excess.argmax())
        if float(excess[i]) > worst[0]:
            worst = (float(excess[i]), f"{k}[{i}] {float(got[k][i]):.6e} "
                     f"vs {float(w[i]):.6e}")
    return worst


def rank_trunk(seg):
    """Make ``seg``'s trunk take a train step's img ‖ img_pos as the ranks
    do: DDP_WORLD calls, each of one rank's img rows and img_pos rows, the
    taps put back in the step's order. The frozen trunk computes each
    image alone, but cuDNN picks its bf16 convolutions' algorithm by the
    batch, so a call of the whole batch rounds the taps otherwise than
    the ranks' calls (the bf16 feature-pyramid step's gradients 4.1e-3
    apart on the H100): so taken, one process's step differs from the
    ranks' only where the ranks meet."""
    whole = seg.net.backbone_features

    def features(img):
        per = img.shape[0] // 2 // DDP_WORLD
        taps = [whole(torch.cat([img[r * per:(r + 1) * per],
                                 img[(DDP_WORLD + r) * per:
                                     (DDP_WORLD + r + 1) * per]]))
                for r in range(DDP_WORLD)]
        return {k: torch.cat([t[k][:per] for t in taps]
                             + [t[k][per:] for t in taps]) for k in taps[0]}

    seg.net.backbone_features = features


def hold_fpn_steps(tag, ranks, refs, names, step_launches):
    """Each feature-pyramid case's ranks against one process on the whole
    batch, each step from the ranks' state before it (phase fpn's gates):
    the ranks' parameters and running statistics equal bit for bit after
    every step; every rank's metrics within rtol LOSS_RTOL atol LOSS_ATOL
    of one process's, its parameters within rtol GRAD_RTOL atol GRAD_ATOL
    where one process's gradient is at least ADAM_LIVE, its running
    statistics within running_excess's gate, and its net's gradients
    within FPN_GRAD_GAP (|g_ranks - g_one| / |g_one|); each rank's
    launches. Prints ms a step and the collectives' calls."""
    for name in names:
        ref = refs[name]
        for i in range(DDP_STEPS[name]):
            first = ranks[0][name]
            check(all(torch.equal(r[name]["params"][i], first["params"][i])
                      and all(torch.equal(r[name]["buffers"][i][k], v)
                              for k, v in first["buffers"][i].items())
                      for r in ranks),
                  f"ddp {tag} {name}: step {i}, the ranks' parameters and "
                  f"BatchNorm running statistics are equal bit for bit")
        for k, r in enumerate(ranks):
            got = r[name]
            bad = [(i, key) for i, (gm, wm) in enumerate(
                zip(got["metrics"], ref["metrics"]))
                for key in wm
                if not math.isclose(gm[key], wm[key], rel_tol=LOSS_RTOL,
                                    abs_tol=LOSS_ATOL)]
            gap = max(float(torch.where(
                g.abs() >= ADAM_LIVE, (a - b).abs() - GRAD_ATOL
                - GRAD_RTOL * b.abs(), -math.inf).max())
                for a, b, g in zip(got["params"], ref["params"],
                                   ref["grads"]))
            stats = max(running_excess(a, b) for a, b in
                        zip(got["buffers"], ref["buffers"]))
            grad_gap = max(float((a - b).norm() / b.norm()) for a, b in
                           zip(got["net_grads"], ref["net_grads"]))
            check(not bad and gap <= 0 and stats[0] <= 0
                  and grad_gap <= FPN_GRAD_GAP,
                  f"ddp {tag} {name}, rank {k}: {DDP_STEPS[name]} steps "
                  f"against one process on the whole batch from the same "
                  f"state: metrics within rtol {LOSS_RTOL} atol {LOSS_ATOL}"
                  f" (off: {bad[:3]}), parameters where the gradient is at "
                  f"least {ADAM_LIVE} within rtol {GRAD_RTOL} atol "
                  f"{GRAD_ATOL} (worst excess {gap:.3e}), running "
                  f"statistics (worst excess {stats[0]:.3e}, {stats[1]}), "
                  f"net gradients "
                  f"|g - g_one| / |g_one| = {grad_gap:.3e} (<= "
                  f"{FPN_GRAD_GAP}); loss/total "
                  f"{got['metrics'][-1]['loss/total']:.6f} vs "
                  f"{ref['metrics'][-1]['loss/total']:.6f}")
            check(got["launches"] == step_launches(name),
                  f"ddp {tag} {name}, rank {k}: launches attention/LN/C1 "
                  f"fwd/C1 bwd/C2 fwd/C2 bwd "
                  f"{tuple(got['launches'][c] for c in COUNTS)}")
            n = DDP_STEPS[name]
            print(f"  ddp {tag} {name}, rank {k}: "
                  f"{statistics.median(got['ms']):.2f} ms a step (wall "
                  f"clock, median of {n}), collectives "
                  f"{got['collective_calls'] / n:.1f} calls and "
                  f"{got['collective_ms'] / n:.2f} ms (host clock) a step; "
                  f"one process on the whole batch "
                  f"{statistics.median(ref['ms']):.2f} ms a step")


def hold_fpn_app(dev, tmp, ranks, val, fpn_runs):
    """The FPN app of phase ddp's ranks (ddp_fpn_app): its trained
    parameters and running statistics equal bit for bit over the ranks,
    DDP_FPN_APP_STEPS steps of exactly 1+1 C2 launches (global negatives)
    and none else, finite metrics with the JAX keys; the eval of its
    checkpoint on the ranks launches no counted kernel and its confusion
    matrices equal one process's evaluate() of the same images. Adds the
    runs' launches to ``fpn_runs``."""
    from stego_torch.data.contrastive import ContrastiveSegDataset
    from stego_torch.eval.evaluate import Evaluator

    apps = [r["fpn_app"] for r in ranks]
    check(all(torch.equal(a["params"], apps[0]["params"])
              and all(torch.equal(a["buffers"][k], v)
                      for k, v in apps[0]["buffers"].items())
              for a in apps),
          "ddp fpn app: the ranks' trained parameters and BatchNorm running "
          "statistics are equal bit for bit")
    want = launches_of(corr_stream_fwd=DDP_FPN_APP_STEPS,
                       corr_stream_bwd=DDP_FPN_APP_STEPS)
    for k, a in enumerate(apps):
        check(a["app_launches"] == want and a["step"] == DDP_FPN_APP_STEPS
              and set(a["metrics"]) == APP_METRICS
              and all(math.isfinite(v) for v in a["metrics"].values()),
              f"ddp fpn app, rank {k}: {a['step']} steps in "
              f"{a['app_s']:.1f} s with 2 validations and checkpoints, "
              f"launches {tuple(a['app_launches'][c] for c in COUNTS)} "
              f"(1+1 C2 a step); "
              + ", ".join(f"{m} {v:.2f}" for m, v in
                          sorted(a["metrics"].items())))
        check(a["eval_launches"] == launches_of(),
              f"ddp fpn eval, rank {k}: no counted kernel")
    fpn_runs["fpn_app"] = add_counts(*(a["app_launches"] for a in apps))
    ev = Evaluator(ddp_fpn_cfg(tmp).replace(
        res=TRAIN_RES, batch_size=DDP_EVAL_BATCH // DDP_WORLD,
        experiment_name="ddp_fpn_eval_one"), apps[0]["ckpt"], dev,
        val_dataset=ContrastiveSegDataset.from_items(SceneItems(val), 27))
    ev.run(save_outputs=False)
    for k, a in enumerate(apps):
        check(np.array_equal(a["eval"][0], ev.linear_metrics.stats)
              and np.array_equal(a["eval"][1], ev.cluster_metrics.stats),
              f"ddp fpn eval, rank {k}: the confusion matrices "
              f"({int(ev.linear_metrics.stats.sum())} pixels) equal one "
              f"process's evaluate() of the same {len(val)} images")


def phase_ddp(dev, tmp, train_items, val_items, fpn_val, smi):
    """Phase ddp. One process first (the KNN table); then DDP_WORLD ranks
    on this card over gloo: the step cases, the KNN build, the app
    (straight, cut and resumed) and the eval, with one rank over NCCL
    beside them (the global case); then one process on the
    whole batch for each step case, each step from the ranks' state after
    the step before, and its own trajectory from the seeded start
    (hold_ddp_trajectories), and the validation and eval matrices of their
    checkpoint; the feature-pyramid cases (FPN_DDP_CASES) in the same
    runs, held by hold_fpn_steps, the control (FPN_CONTROL) against the
    global case's first step, and the FPN app (validated on ``fpn_val``)
    and its eval; then the NCCL rank's step, and DDP_WORLD ranks over
    NCCL, one a card, where the machine has that many (the global case and
    the feature-pyramid cases). Returns the launches of each run, summed over
    its ranks: the ViT runs' and the feature-pyramid runs'."""
    from stego_torch.eval.evaluate import Evaluator, load_model_for_eval
    from stego_torch.train.segmenter import make_val_step

    # as the children (ddp_child): the one-process references in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train, val = train_items[:DDP_TRAIN], val_items[:DDP_VAL]
    print(f"ddp: {DDP_WORLD} processes on one card ({smi}) over gloo, each "
          f"rank {TRAIN_BATCH // DDP_WORLD} of a global batch of "
          f"{TRAIN_BATCH} at res {TRAIN_RES}, ViT-S/8 bf16 and the "
          f"feature-pyramid arch (ResNet-50, granularity {FPN_GRANULARITY},"
          f" BatchNorms on the global batch's statistics), cocostuff27 "
          f"head, 11x11 samples, 5 negatives; two processes sharing one "
          f"card: their times are not a scaling number")
    batch = ddp_batch(dev)
    ref_nns, _ = ddp_knn(dev, tmp, train)
    os.remove(os.path.join(tmp, "nns", "nns_ddp.npz"))
    data = os.path.join(tmp, "ddp_scenes.npz")
    np.savez(data, train_img=np.stack([i for i, _ in train]),
             train_label=np.stack([lb for _, lb in train]),
             val_img=np.stack([i for i, _ in val]),
             val_label=np.stack([lb for _, lb in val]),
             fpn_val_img=np.stack([i for i, _ in fpn_val]),
             fpn_val_label=np.stack([lb for _, lb in fpn_val]))

    def step_launches(name):
        n = DDP_STEPS[name]
        if name == "local":  # the f32 trunk: A-f32, LayerNorm plain
            return launches_of(12 * n, 0, "pair", f32=True,
                               corr_sampled_fwd=n, corr_sampled_bwd=n)
        if name == "fpn_local":  # ResNet-50: no attention, no LayerNorm
            return launches_of(corr_sampled_fwd=n, corr_sampled_bwd=n)
        if name.startswith("fpn"):
            return launches_of(corr_stream_fwd=n, corr_stream_bwd=n)
        return launches_of(12 * n, 25 * n, "pair", corr_stream_fwd=n,
                           corr_stream_bwd=n)

    fpn_names = list(FPN_DDP_CASES)
    t0 = time.perf_counter()
    gloo = start_ddp(tmp, "gloo", "gloo", [str(dev)] * DDP_WORLD,
                     list(DDP_CASES) + fpn_names + [FPN_CONTROL], True, data)
    # one rank over NCCL beside them: the global case's one-process step
    # (C2's route) through a group of one, whose collectives run and change
    # nothing
    nccl_procs = start_ddp(tmp, "nccl", "nccl", ["cuda:0"], ["global"],
                           False, reference=True)
    ranks = finish_ddp("gloo", gloo)
    print(f"  ddp gloo: {DDP_WORLD} ranks ran in "
          f"{time.perf_counter() - t0:.1f} s (each process's start, its "
          f"CUDA context and imports included)")
    # one process on the whole batch, each step from rank 0's state after
    # the step before (the ranks' states are equal bit for bit, which
    # hold_ddp_steps checks): a W-rank step is held against the
    # one-process step from the same state; the trajectories are held
    # apart, where Adam's moments do not compound an f32 rounding at a
    # ReLU or clamp into more than a step's gate
    refs = {name: ddp_steps(
        dev, name, batch, reference=True,
        states=None if ranks is None else ranks[0][name]["states"])
        for name in list(DDP_CASES) + fpn_names}
    trajs = {name: ddp_steps(dev, name, batch, reference=True)
             for name in DDP_CASES}
    del batch
    torch.cuda.empty_cache()
    runs, fpn_runs = {}, {}
    if ranks is not None:
        hold_ddp_steps("gloo", ranks, refs, DDP_CASES, step_launches)
        hold_ddp_trajectories("gloo", ranks, trajs, DDP_CASES)
        for name in DDP_CASES:
            runs[name] = add_counts(*(r[name]["launches"] for r in ranks))
        hold_fpn_steps("gloo", ranks, refs, fpn_names, step_launches)
        for name in fpn_names:
            fpn_runs[name] = add_counts(*(r[name]["launches"]
                                          for r in ranks))
        # the control: each rank's BatchNorms on its own batch
        control = max(running_excess(r[FPN_CONTROL]["buffers"][0],
                                     refs["fpn_global"]["buffers"][0])
                      for r in ranks)
        check(control[0] > 0 and all(r[FPN_CONTROL]["launches"]
                                  == step_launches(FPN_CONTROL)
                                  for r in ranks),
              f"control, ddp gloo {FPN_CONTROL}: the ranks with each "
              f"rank's BatchNorms on its own batch's statistics fail the "
              f"running statistics' gate against one process's first "
              f"step (worst excess {control[0]:.3e} > 0, {control[1]})")
        hold_fpn_app(dev, tmp, ranks, fpn_val, fpn_runs)
        check(all(np.array_equal(r["nns"], ref_nns) for r in ranks),
              f"ddp knn: the {DDP_WORLD} ranks' nns {ref_nns.shape} equal "
              f"one process's, row for row")
        per_rank = DDP_TRAIN // TRAIN_BATCH // DDP_WORLD
        for k, r in enumerate(ranks):
            check(r["knn_launches"] == trunk_launches(per_rank),
                  f"ddp knn, rank {k}: {per_rank} batches' launches")
        runs["knn"] = add_counts(*(r["knn_launches"] for r in ranks))
        apps = [r["app"] for r in ranks]
        half = DDP_APP_STEPS // 2
        steps_run = DDP_APP_STEPS + half + half
        val_batches = DDP_VAL // DDP_VAL_BATCH  # a rank's, each validation
        want_app = add_counts(
            launches_of(12 * steps_run, 25 * steps_run, "pair",
                        corr_stream_fwd=steps_run,
                        corr_stream_bwd=steps_run),
            trunk_launches(5 * val_batches, VAL_RES))
        eval_batches = -(-DDP_VAL // DDP_WORLD // DDP_EVAL_BATCH)
        want_eval = launches_of(24 * eval_batches, 50 * eval_batches,
                                "pair_kv")
        for k, a in enumerate(apps):
            check(a["resumed_start"] == half and a["resume_gap"] == 0.0,
                  f"ddp app, rank {k}: {half} steps, a checkpoint and a "
                  f"resume to {DDP_APP_STEPS} equal {DDP_APP_STEPS} steps "
                  f"straight (largest state difference {a['resume_gap']:.3e},"
                  f" resumed at {a['resumed_start']}); the straight run "
                  f"took {a['app_s']:.1f} s with its validations and "
                  f"checkpoints")
            check(a["app_launches"] == want_app,
                  f"ddp app, rank {k}: launches attention/LN/C1 fwd/C1 "
                  f"bwd/C2 fwd/C2 bwd "
                  f"{tuple(a['app_launches'][c] for c in COUNTS)}, at "
                  f"pair_kv {a['app_launches']['attention_pair_kv']}")
            check(a["eval_launches"] == want_eval,
                  f"ddp eval, rank {k}: launches "
                  f"{tuple(a['eval_launches'][c] for c in COUNTS)}")
        check(torch.equal(apps[0]["params"],
                          apps[1]["params"]),
              "ddp app: the ranks' trained parameters are equal bit for bit")
        runs["app"] = add_counts(*(a["app_launches"] for a in apps))
        runs["eval"] = add_counts(*(a["eval_launches"] for a in apps))
        # one process on the same images: the validation's and the eval's
        # matrices of the ranks' checkpoint (batches of a rank's size)
        seg = load_model_for_eval(apps[0]["ckpt"], dev)
        step = make_val_step(seg)
        per = DDP_VAL_BATCH // DDP_WORLD
        want_val = val_confusion(seg, step, [
            {"img": np.stack([i for i, _ in val[s:s + per]]),
             "label": np.stack([lb for _, lb in val[s:s + per]])}
            for s in range(0, len(val), per)])
        for k, a in enumerate(apps):
            check(all(np.array_equal(g, w) for g, w in zip(a["val"],
                                                            want_val)),
                  f"ddp app, rank {k}: the validation's confusion matrices "
                  f"({int(want_val[0].sum())} pixels) equal one process's on "
                  f"the same {len(val)} images")
        from stego_torch.data.contrastive import ContrastiveSegDataset

        ev = Evaluator(ddp_app_cfg(tmp).replace(
            res=VAL_RES, batch_size=DDP_EVAL_BATCH // DDP_WORLD,
            experiment_name="ddp_eval_one"), apps[0]["ckpt"], dev,
            val_dataset=ContrastiveSegDataset.from_items(SceneItems(val), 27))
        ev.run(save_outputs=False)
        for k, a in enumerate(apps):
            check(np.array_equal(a["eval"][0], ev.linear_metrics.stats)
                  and np.array_equal(a["eval"][1], ev.cluster_metrics.stats),
                  f"ddp eval, rank {k}: the confusion matrices equal one "
                  f"process's evaluate() of the same {len(val)} images")
        check(os.path.isdir(os.path.join(tmp, "results", "predictions",
                                         "ddp_eval", "img")),
              "ddp eval: rank 0 wrote the PNG trees")

    nccl = finish_ddp("nccl", nccl_procs)
    if nccl is not None:
        hold_ddp_steps("nccl, 1 rank", nccl, refs, ["global"], step_launches)
        runs["nccl"] = nccl[0]["global"]["launches"]
        check(nccl[0]["global"]["collective_calls"] > 0,
              f"ddp nccl: {nccl[0]['global']['collective_calls']} collective "
              f"calls went through NCCL")
    cards = torch.cuda.device_count()
    if cards >= DDP_WORLD:
        multi = finish_ddp("nccl_cards", start_ddp(
            tmp, "nccl_cards", "nccl",
            [f"cuda:{i}" for i in range(DDP_WORLD)], ["global"] + fpn_names,
            False))
        if multi is not None:
            hold_ddp_steps(f"nccl, {DDP_WORLD} cards", multi, refs,
                           ["global"], step_launches)
            runs["nccl_cards"] = add_counts(*(r["global"]["launches"]
                                              for r in multi))
            hold_fpn_steps(f"nccl, {DDP_WORLD} cards", multi, refs,
                           fpn_names, step_launches)
            for name in fpn_names:
                fpn_runs[f"{name}_nccl_cards"] = add_counts(
                    *(r[name]["launches"] for r in multi))
    print(f"  ddp: ran {DDP_WORLD} ranks on one card over gloo, 1 rank over "
          f"nccl" + (f", {DDP_WORLD} ranks on {DDP_WORLD} cards over nccl"
                     if cards >= DDP_WORLD else
                     f"; {DDP_WORLD} ranks over nccl not run ({cards} card)"))
    return runs, fpn_runs


def phase_narrow(dev):
    """Kernel A's narrow-head kernel (bf16, d = 8, 16, 32) in every form
    against its plain version at NARROW_CASES, at the head-major gates
    (rtol ATTN_RTOL, atol ATTN_ATOL; no_softmax two bf16 ulps of its
    largest output), on views of a packed qkv with the output written
    through a token-major view as the trunk does ("pair": token-major in
    and out); the trunk's form (batch_resident) timed beside SDPA. Returns
    {d: the result at its first shape, its forms' errors under "forms"}."""
    import torch.nn.functional as F

    from stego_torch.ops import flash_attention as fa

    print(f"kernel A, narrow heads (d in {NARROW_DS}) vs plain, bf16, every "
          f"form, q, k ~ N(0, 4), v ~ N(0, 1); rtol {ATTN_RTOL} atol "
          f"{ATTN_ATOL} (no_softmax: two bf16 ulps of its largest output); "
          f"library: F.scaled_dot_product_attention on (B, H, N, d)")
    out = {}
    for d, b, h, n in NARROW_CASES:
        scale = d ** -0.5
        g = torch.Generator(device=dev).manual_seed(b * n + h + d)
        qkv = torch.randn(b, n, 3, h, d, generator=g, device=dev)
        qkv[:, :, :2] *= 2
        qkv = qkv.bfloat16()
        q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
        tq, tk, tv = (x.flatten(2) for x in qkv.unbind(2))
        errs, timed = {}, None
        for form in NARROW_FORMS:
            if form == "pair":
                def kernel():
                    return fa.token_major_attention(tq, tk, tv, h, scale)

                def plain():
                    return fa.attention_plain(tq, tk, tv, h, scale)
            else:
                fn = getattr(fa, f"{form}_attention")
                tok = torch.empty(b, n, h * d, dtype=torch.bfloat16,
                                  device=dev)
                view = tok.unflatten(-1, (h, d)).transpose(1, 2)

                def kernel(fn=fn, view=view):
                    return fn(q, k, v, scale, out=view)

                def plain(fn=fn):
                    return fn(q, k, v, scale, use_kernel=False)
            before = fa.HEAD_DIM_LAUNCHES[(d, torch.bfloat16)]
            got = kernel()
            torch.cuda.synchronize()
            launched = fa.HEAD_DIM_LAUNCHES[(d, torch.bfloat16)] - before
            want = plain().float()
            diff = (got.float() - want).abs()
            tol = (torch.full_like(want, 2 ** -7 * float(want.abs().max()))
                   if form == "no_softmax"
                   else ATTN_ATOL + ATTN_RTOL * want.abs())
            errs[form] = float(diff.max())
            check(within(diff, tol, want) and launched == 1,
                  f"d={d} {form} (B={b}, H={h}, N={n}): max_abs_err "
                  f"{errs[form]:.3e}, {launched} launch at d={d}")
            if form == "batch_resident":
                timed = (kernel, plain)
        t = compare_times(*timed)
        bnd = bound({"bf16": 4 * b * h * n * n * d}, 4 * b * n * h * d * 2)
        qh, kh, vh = (x.contiguous() for x in (q, k, v))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), floor_ms=bnd[0])
        print(f"  d={d} batch_resident (B={b}, H={h}, N={n}): "
              f"{timing_text(t)}; SDPA {lib:.4f} ms (kernel / SDPA "
              f"{t['device'][0] / lib:.2f}); {bound_text(bnd)}")
        out.setdefault(d, dict(
            shape=f"B={b} H={h} N={n} d={d} bf16",
            max_abs_err=max(errs.values()), ms=t["device"][0],
            plain_ms=t["device"][1], library_ms=lib, bound=bnd,
            forms=errs))
    return out


def phase_launch_floor(dev, narrow, narrow_f32, ln_narrow):
    """The device time of a one-element ``x.add_(1)``, a practical floor
    of any launch, beside the rows whose byte bounds are ~1% of their
    times: kernel A's narrow heads and L at 32 and 64, whose remaining cost
    is the launch (a CUDA graph's to remove). Adds it to each of those rows
    as ``launch_floor_ms``; returns it."""
    x = torch.zeros(1, device=dev)
    floor = device_ms(lambda: x.add_(1))
    print(f"launch floor: a one-element x.add_(1), {floor:.4f} ms of device "
          f"time")
    rows = ([(f"A d={d} bf16", narrow[d]) for d in NARROW_DS]
            + [(f"A d={d} f32", narrow_f32[d]) for d in NARROW_DS]
            + [(f"L at {d}", ln_narrow[d]) for d in (32, 64)])
    for label, r in rows:
        r["launch_floor_ms"] = floor
        print(f"  {label} ({r['shape']}): kernel {r['ms']:.4f} ms, "
              f"{r['ms'] / floor:.2f}x the floor; its bound "
              f"{r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return floor


def sensitive_segmenter(dev, embed, heads, backbone_dtype="bfloat16"):
    """A seeded segmenter of the sensitive accuracy instrument's
    configuration (``tiny_benchmark_setup``: 2 blocks, res 64, 4 classes)
    with a trunk of ``embed`` wide, ``heads`` heads, on ``dev``: bf16, or
    f32 with ``use_flash_attention``."""
    from stego_torch.data.synthetic import tiny_benchmark_setup
    from stego_torch.train.segmenter import UnsupervisedSegmenter

    f32 = backbone_dtype == "float32"
    with tempfile.TemporaryDirectory() as tmp:
        cfg, vit = tiny_benchmark_setup(
            tmp, n_train=1, n_val=1, backbone_dtype=backbone_dtype,
            use_flash_attention=True if f32 else None)
    vit = dataclasses.replace(vit, embed_dim=embed, num_heads=heads)
    seg = UnsupervisedSegmenter(4, cfg, vit_cfg=vit,
                                generator=torch.Generator().manual_seed(0))
    seg.to(dev)
    if not f32:
        seg.net.model.cast_blocks(torch.bfloat16)
    return seg


def phase_narrow_f32(dev):
    """The narrow-head kernel's f32 instantiation (d = 8, 16, 32) in every
    form against the f32 plain version at F32_RTOL / F32_ATOL (no_softmax:
    F32_RTOL of its largest output), TF32 off, on views of a packed qkv as
    phase_narrow; two controls must fail each gate: the bf16
    instantiation on the same inputs, and the plain version with one TF32
    pass a product (``ops/tf32.py:matmul_tf32``; the kernel takes its f32
    products by 3xTF32); the trunk's form (batch_resident) timed beside
    f32 SDPA and the bound (3xTF32's rate, as A-f32's rows; the f32 FMA
    bound printed). Returns {d: the result at NARROW_F32_CASES' shape, its
    forms' errors under "forms"}."""
    import torch.nn.functional as F

    from stego_torch.ops import flash_attention as fa
    from stego_torch.ops.tf32 import matmul_tf32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"kernel A, narrow heads on f32 q/k/v (d in {NARROW_DS}) vs plain, "
          f"every form, q, k ~ N(0, 4), v ~ N(0, 1); rtol {F32_RTOL} atol "
          f"{F32_ATOL} (no_softmax: rtol of its largest output); TF32 off; "
          f"controls that must fail: the bf16 instantiation on the same "
          f"inputs, the plain version in one TF32 pass a product; "
          f"library: f32 F.scaled_dot_product_attention on (B, H, N, d)")
    out = {}
    for d, b, h, n in NARROW_F32_CASES:
        scale = d ** -0.5
        g = torch.Generator(device=dev).manual_seed(b * n + h + d)
        qkv = torch.randn(b, n, 3, h, d, generator=g, device=dev)
        qkv[:, :, :2] *= 2
        q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
        tq, tk, tv = (x.flatten(2) for x in qkv.unbind(2))
        errs, timed = {}, None
        for form in NARROW_FORMS:
            if form == "pair":
                def kernel(dtype=torch.float32):
                    return fa.token_major_attention(
                        *(x.to(dtype) for x in (tq, tk, tv)), h, scale)

                def plain(matmul=torch.matmul):
                    return fa.attention_plain(tq, tk, tv, h, scale,
                                              matmul=matmul)
            else:
                fn = getattr(fa, f"{form}_attention")
                view = torch.empty(b, n, h * d, device=dev).unflatten(
                    -1, (h, d)).transpose(1, 2)

                def kernel(dtype=torch.float32, fn=fn, view=view):
                    if dtype != torch.float32:  # the control, a new output
                        return fn(*(x.to(dtype) for x in (q, k, v)), scale)
                    return fn(q, k, v, scale, out=view)

                def plain(matmul=torch.matmul, fn=fn,
                          form_=FORM_OF.get(form, form)):
                    if matmul is torch.matmul:
                        return fn(q, k, v, scale, use_kernel=False)
                    return fa.attention_heads_plain(q, k, v, scale, form_,
                                                    matmul=matmul)
            before = fa.HEAD_DIM_LAUNCHES[(d, torch.float32)]
            got = kernel()
            torch.cuda.synchronize()
            launched = fa.HEAD_DIM_LAUNCHES[(d, torch.float32)] - before
            want = plain()
            diff = (got - want).abs()
            tol = (torch.full_like(want, F32_RTOL * float(want.abs().max()))
                   if form == "no_softmax"
                   else F32_ATOL + F32_RTOL * want.abs())
            errs[form] = float(diff.max())
            check(got.dtype == torch.float32 and within(diff, tol, want)
                  and launched == 1,
                  f"d={d} f32 {form} (B={b}, H={h}, N={n}): max_abs_err "
                  f"{errs[form]:.3e}, {launched} f32 launch at d={d}")
            ctl = (kernel(torch.bfloat16).float() - want).abs()
            check(bool((ctl > tol).any()),
                  f"control, d={d} {form} by the bf16 instantiation on the "
                  f"same inputs: max_abs_err {float(ctl.max()):.3e}, "
                  f"{int((ctl > tol).sum())} of {ctl.numel()} elements out "
                  f"of the gate (must fail)")
            ctl = (plain(matmul_tf32) - want).abs()
            check(bool((ctl > tol).any()),
                  f"control, d={d} {form} by the plain version in one TF32 "
                  f"pass a product: max_abs_err {float(ctl.max()):.3e}, "
                  f"{int((ctl > tol).sum())} of {ctl.numel()} elements out "
                  f"of the gate (must fail)")
            if form == "batch_resident":
                timed = (kernel, plain)
        t = compare_times(*timed)
        flops = 4 * b * h * n * n * d
        nbytes = 4 * b * n * h * d * 4
        bnd = bound({"tf32x3": flops}, nbytes)
        fma = bound({"f32": flops}, nbytes)
        qh, kh, vh = (x.contiguous() for x in (q, k, v))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), floor_ms=bnd[0])
        print(f"  d={d} f32 batch_resident (B={b}, H={h}, N={n}): "
              f"{timing_text(t)}; f32 SDPA {lib:.4f} ms (kernel / SDPA "
              f"{t['device'][0] / lib:.2f}); {bound_text(bnd)}; at f32 FMA "
              f"{fma[0]:.4f} ms")
        out[d] = dict(shape=f"B={b} H={h} N={n} d={d} f32",
                      max_abs_err=max(errs.values()), ms=t["device"][0],
                      plain_ms=t["device"][1], library_ms=lib, bound=bnd,
                      forms=errs)
    return out


def phase_narrow_f32_paths(dev):
    """One forward through ``seg.net`` of an f32 trunk of each of
    NARROW_TRUNKS' shapes (the sensitive configuration, res 64, batch 16)
    with ``use_flash_attention``, TF32 off: exactly 2 launches, both of the
    narrow-head kernel's f32 instantiation at the trunk's head width, and
    no L (an f32 trunk's LayerNorm stays plain); its features and code
    within F32_RTOL / F32_ATOL of the same forward on the kernels' plain
    versions. Returns {head width: the launches}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for embed, heads in NARROW_TRUNKS:
        d = embed // heads
        seg = sensitive_segmenter(dev, embed, heads, "float32")
        img = images(torch.Generator(device=dev).manual_seed(embed), 64, dev,
                     16)
        reset_counts()
        with torch.inference_mode():
            got = seg.net(img)
        torch.cuda.synchronize()
        runs[d] = path_counts()
        seg.net.model.use_kernels = False
        with torch.inference_mode():
            want = seg.net(img)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        check(all(within((g - w).abs(), F32_ATOL + F32_RTOL * w.abs(), w)
                  for g, w in zip(got, want))
              and runs[d]["attention"] == runs[d][f"attention_d{d}_f32"] == 2
              and runs[d]["layer_norm"] == 0,
              f"f32 trunk, width {embed}, {heads} heads of {d}, "
              f"use_flash_attention: features and code vs plain max_abs_err "
              f"{errs[0]:.3e}, {errs[1]:.3e}; A at d={d} f32 "
              f"{runs[d][f'attention_d{d}_f32']} launches, L "
              f"{runs[d]['layer_norm']}")
    return runs


def phase_narrow_paths(dev):
    """The train step of the sensitive instrument's configuration on bf16
    trunks of NARROW_TRUNKS' widths (heads of 8, 16 and 32; L at 32, 64
    and 128), NARROW_STEPS steps at batch 16 on one fixed batch: each step
    exactly 2 A at its head width, 5 L at its width and 1 + 1 C1, a finite
    loss. Returns {head width: the launches}."""
    from stego_torch.train.segmenter import (draw_step_randomness,
                                             make_train_step)

    runs = {}
    for embed, heads in NARROW_TRUNKS:
        d = embed // heads
        print(f"train, sensitive configuration at width {embed}, {heads} "
              f"heads of {d}: bf16 trunk, res 64, batch 16, "
              f"{NARROW_STEPS} steps")
        seg = sensitive_segmenter(dev, embed, heads)
        gen = torch.Generator(device=dev).manual_seed(embed)
        img = images(gen, 64, dev, 16)
        batch = {"img": img, "img_pos": img.flip(2),
                 "label": torch.randint(-1, 4, img.shape[:3], generator=gen,
                                        device=dev)}
        step = make_train_step(seg, with_hist=False)
        _, launches = run_steps(
            NARROW_STEPS, (), (2, 5, 1, 1, 0, 0), 0, False,
            lambda i, hist: step(batch, draw_step_randomness(seg, 16, gen)))
        check(launches[f"attention_d{d}"] == 2 * NARROW_STEPS
              and launches[f"layer_norm_{embed}"] == 5 * NARROW_STEPS,
              f"width {embed}: A at d={d} {launches[f'attention_d{d}']}, "
              f"L at {embed} {launches[f'layer_norm_{embed}']} launches")
        runs[d] = launches
    return runs


def phase_accuracy(dev, tmp):
    """The sensitive accuracy row end to end through
    ``tools/accuracy_bench.py:sensitive`` (the mosaic written, its KNN
    caches, 40 steps of the app, the final validation), the main path of
    the narrow kernels: every A launch at d = 8 and every L launch at D =
    32, gated by the row's bands; then the row on each of the port's
    seeded trunks (``accuracy_bench.sensitive_trunks``), gated by
    ``trunks_missed`` (every trunk the linear bands, at least
    TRUNKS_PASSING of them every band): one trunk is one draw, so the
    trunks gate the numerics where the first row gates a draw as well.
    Returns the first row's launches and its metrics."""
    from stego_torch.models.vit import trunc_normal
    from stego_torch.tools import accuracy_bench as ab

    got = trunc_normal(torch.empty(6), 0.02, torch.Generator().manual_seed(0))
    check(got.tolist() == TRUNC_NORMAL_SEED0,
          f"the seeded init's truncated normal under torch "
          f"{torch.__version__} gives the pinned draws: {got.tolist()}")
    print("accuracy, the sensitive row (tools/accuracy_bench.py): the "
          "res-64 mosaic (32 train, 8 val), its KNN, 40 steps of the app "
          "with the tiny ViT (width 32, 4 heads of 8) in bf16; bands (the "
          "JAX package's, set on a TPU) "
          + ", ".join(f"{k} >= {v}" for k, v in ab.SENSITIVE_BANDS.items()))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    metrics = ab.sensitive(tmp, dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = path_counts()
    failed = ab.missed(metrics, ab.SENSITIVE_BANDS)
    check(not failed and all(math.isfinite(v) for v in metrics.values()),
          f"sensitive row in {sec:.1f} s on {ab.device_name(dev)}: "
          + ", ".join(f"{k}={v:.2f}" for k, v in sorted(metrics.items()))
          + (f"; below its bands: {failed}" if failed else ""))
    check(launches["attention"] == launches["attention_d8"] > 0
          and launches["layer_norm"] == launches["layer_norm_32"] > 0,
          f"sensitive row launches: A {launches['attention']} (at d=8 "
          f"{launches['attention_d8']}), L {launches['layer_norm']} (at "
          f"D=32 {launches['layer_norm_32']}), C1 "
          f"{launches['corr_sampled_fwd']}+{launches['corr_sampled_bwd']}")
    t0 = time.perf_counter()
    trunks = ab.sensitive_trunks(tmp, dev)
    sec = time.perf_counter() - t0
    failed = ab.trunks_missed(trunks)
    check(failed is None
          and all(math.isfinite(v) for m in trunks.values()
                  for v in m.values()),
          f"sensitive row on {len(trunks)} seeded trunks in {sec:.1f} s "
          f"(linear mIoU/Acc, cluster mIoU/Acc): "
          + "; ".join(f"seed {s} " + "/".join(
              f"{m[k]:.2f}" for k in ab.SENSITIVE_BANDS)
              for s, m in trunks.items())
          + (f"; {failed}" if failed else
             f"; every trunk inside the linear bands, at least "
             f"{ab.TRUNKS_PASSING} inside every band"))
    return launches, metrics


def phase_branches(dev):
    """The training branches at the main footprint (ViT-S/8, bf16, res
    224, batch 16): the salience-biased draw sampled through C1 and
    grid-sampled into C2 (masks: label > 0), and the aug-alignment loss on
    the device route (``ops/augment.py`` in the step; the trunk over 48
    images) and the host route (the batch's img_aug and coord_aug), each
    SHORT_STEPS steps with train_run's gates and one step held against the
    same step with its loss kernel's plain version. Returns {run: the
    launches}."""
    from stego_torch.ops import augment

    def masks(batch, gen):
        return {"mask": (batch["label"] > 0).float(),
                "mask_pos": (batch["label"].flip(2) > 0).float()}

    def host_view(batch, gen):
        b, h = batch["img"].shape[:2]
        img_aug, coord_aug = augment.device_augment(
            batch["img"], augment.sample_geometric(gen, b, h, h),
            augment.sample_photometric(gen, b))
        return {"img_aug": img_aug, "coord_aug": coord_aug}

    sampled, streamed = (12, 25, 1, 1, 0, 0), (12, 25, 0, 0, 1, 1)
    runs = {}
    _, _, runs["salience"] = train_run(
        dev, "salience-biased draw, sampled loss (kernel C1)", SHORT_STEPS,
        (0,), sampled, 0, extra=masks, use_salience=True)
    _, _, runs["salience_gather"] = train_run(
        dev, "salience-biased draw, fused_sampling=off (kernel C2)",
        SHORT_STEPS, (0,), streamed, 0, extra=masks, use_salience=True,
        fused_sampling="off")
    _, _, runs["aug_device"] = train_run(
        dev, "aug-alignment loss, device route (ops/augment.py)",
        SHORT_STEPS, (0,), sampled, 0, aug_alignment_weight=0.5)
    _, _, runs["aug_host"] = train_run(
        dev, "aug-alignment loss, host route (img_aug, coord_aug)",
        SHORT_STEPS, (0,), sampled, 0, extra=host_view,
        aug_alignment_weight=0.5, device_augs=False)
    return runs


def phase_fpn(dev, tmp, smi):
    """The feature-pyramid arch at full width (ResNet-50, granularity 4,
    dim 70, res 224, batch 16, 11 x 11 samples, 5 negatives): FPN_STEPS
    sampled steps with a bf16 trunk (C1 at 2048 bf16 channels, 7 x 7
    features beside 56 x 56 code) and SHORT_STEPS with an f32 trunk (C1 at
    2048 f32 channels), then SHORT_STEPS of each with fused_sampling=off
    (C2 at 2048 channels), each with train_run's gates (exact launches a
    step, a finite loss, one step held against its plain step, the
    parameters where the plain step's gradient is at least ADAM_LIVE), the
    weighted contrastive losses falling (CONTRASTIVE; the first 3 steps
    against the last 3 of the bf16 run, step 0 against step 2 of the
    others) and the head's gradients within FPN_GRAD_GAP of the plain
    step's, which the controls (C1_CONTROLS, SCALED_CODE_GRADIENT) must
    fail. Then the entry points a user calls, on FPN_TRAIN + FPN_VAL
    scenes written as a directory dataset at res 224: ``python -m
    stego_torch.train.knn_app`` with each cut embedder (FPN_EMBEDDERS), ``python
    -m stego_torch.train`` (FPN_APP_STEPS steps, validation and a
    checkpoint every 5, the BatchNorm refresh) with exactly one C1 forward
    and backward a step and no other launch, ``python -m stego_torch.eval``
    on its checkpoint and the evaluator's matrices against a recount, and
    one served predict of the checkpoint packaged on the card. Returns the
    launches of each run."""
    from stego_torch.data.synthetic import write_synthetic_benchmark
    from stego_torch.data.transforms import channel_stats
    from stego_torch.eval import evaluate as ev
    from stego_torch.serve import ServingModel, package
    from stego_torch.train import app, knn_app
    from stego_torch.train.checkpoint import CheckpointManager, load_config
    from stego_torch.train.knn import knn_cache_file

    runs = {}
    sampled, streamed = (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 1, 1)
    fpn = dict(model_type="resnet50", arch="feature-pyramid",
               granularity=FPN_GRANULARITY, adam_live=ADAM_LIVE,
               grad_gap_max=FPN_GRAD_GAP, gap_over="net.",
               fall_on=CONTRASTIVE)
    where = "7x7 ResNet-50 layer4 beside 56x56 code"
    _, _, runs["bf16"] = train_run(
        dev, f"feature-pyramid, sampled loss (kernel C1 at {FPN_CF} bf16 "
        f"channels, {where})", FPN_STEPS, (0,), sampled, 3,
        controls=C1_CONTROLS, **fpn)
    _, _, runs["f32"] = train_run(
        dev, f"feature-pyramid, f32 trunk, sampled loss (kernel C1 at "
        f"{FPN_CF} f32 channels, {where})", SHORT_STEPS, (0,), sampled, 1,
        backbone_dtype="float32", controls=C1_CONTROLS, **fpn)
    for name, dtype in (("gather", "bfloat16"), ("f32_gather", "float32")):
        _, _, runs[name] = train_run(
            dev, f"feature-pyramid, {dtype} trunk, fused_sampling=off "
            f"(grid-sampled 11x11, kernel C2 at {FPN_CF} channels)",
            SHORT_STEPS, (0,), streamed, 1, backbone_dtype=dtype,
            fused_sampling="off", controls=SCALED_CODE_GRADIENT, **fpn)

    t0 = time.perf_counter()
    root = os.path.join(tmp, "data")
    write_synthetic_benchmark(root, n_train=FPN_TRAIN, n_val=FPN_VAL,
                              res=TRAIN_RES)
    args = [f"pytorch_data_dir={root}", "dataset_name=directory",
            "dir_dataset_name=synthbench", "dir_dataset_n_classes=4",
            "arch=feature-pyramid", f"granularity={FPN_GRANULARITY}",
            "dim=70", f"res={TRAIN_RES}", f"val_res={TRAIN_RES}",
            "crop_type=null"]
    print(f"feature-pyramid entry points: {FPN_TRAIN} + {FPN_VAL} scenes "
          f"written at res {TRAIN_RES} in {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    reset_counts()  # the KNN builds: convolutions only
    for model_type in FPN_EMBEDDERS:
        t0 = time.perf_counter()
        knn_app.main(args + [f"model_type={model_type}"])
        sec = time.perf_counter() - t0
        ok = True
        for split, n in (("train", FPN_TRAIN), ("val", FPN_VAL)):
            nns = np.load(knn_cache_file(root, model_type, "synthbench",
                                         split, None, TRAIN_RES))["nns"]
            ok &= nns.shape == (n, min(KNN_K, n)) and bool(
                (nns[:, 0] == np.arange(n)).all())
        check(ok, f"python -m stego_torch.train.knn_app model_type="
                  f"{model_type}: both splits in {sec:.1f} s, every scene "
                  f"its own nearest")
    knn_launches = path_counts()
    check(all(v == 0 for v in knn_launches.values()),
          "the cut embedders launch no counted kernel")

    out = os.path.join(tmp, "out")
    train_args = args + [
        "model_type=resnet50", f"output_root={out}", "experiment_name=fpn",
        f"batch_size={TRAIN_BATCH}", f"val_batch_size={TRAIN_BATCH}",
        f"max_steps={FPN_APP_STEPS}", "val_freq=5", "checkpoint_freq=5",
        "scalar_log_freq=1", "hist_freq=5", "num_neighbors=4"]
    torch.cuda.synchronize()
    reset_counts()  # the main path: every launch of the run is counted
    t0 = time.perf_counter()
    app.main(train_args)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    runs["app"] = path_counts()
    check(runs["app"] == launches_of(corr_sampled_fwd=FPN_APP_STEPS,
                                     corr_sampled_bwd=FPN_APP_STEPS),
          f"python -m stego_torch.train (arch=feature-pyramid, "
          f"{FPN_APP_STEPS} steps, 2 validations) in {sec:.1f} s: launches "
          f"{ {k: v for k, v in runs['app'].items() if v} } (1+1 C1 a step)")
    with open(os.path.join(out, "logs", "directory_fpn",
                           "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    losses = [ln["loss/total"] for ln in lines if "loss/total" in ln]
    tests = [ln for ln in lines if "test/cluster/mIoU" in ln]
    check(len(losses) == FPN_APP_STEPS and len(tests) == 2
          and all(math.isfinite(v) for v in losses),
          f"the app logged {len(losses)} losses ({losses[0]:.4f} .. "
          f"{losses[-1]:.4f}) and {len(tests)} validations (cluster mIoU "
          + ", ".join(f"{ln['test/cluster/mIoU']:.2f}" for ln in tests) + ")")
    ckpt_dir = os.path.join(out, "checkpoints", "directory_fpn")
    ckpt = CheckpointManager(ckpt_dir,
                             load_config(ckpt_dir)).checkpoint_path()
    runs["app_resume"] = fpn_resume(out, train_args, ckpt_dir)
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)["state_dict"]
    tracked = {int(v) for k, v in sd.items()
               if k.endswith("num_batches_tracked")}
    var = sd["net.conv4.double_conv.4.running_var"]
    check(tracked == {int(os.path.basename(os.path.dirname(ckpt)))}
          and not torch.equal(var, torch.ones_like(var)),
          f"{os.path.relpath(ckpt, out)}: every BatchNorm refreshed once a "
          f"step ({sorted(tracked)}), running statistics moved")

    cwd = os.getcwd()
    os.chdir(tmp)  # the eval writes results/ under its working directory
    try:
        eval_args = [f"model_path={ckpt}", f"pytorch_data_dir={root}",
                     "dataset_name=directory", "dir_dataset_name=synthbench",
                     "dir_dataset_n_classes=4", f"res={TRAIN_RES}",
                     "batch_size=8", "run_crf=false",
                     "experiment_name=fpn_eval"]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        ev.main(eval_args)
        sec = time.perf_counter() - t0
        from stego_torch.config import Config, prep_args

        eval_cfg = Config.from_dict({k: v for k, v in prep_args(
            eval_args).items() if k != "model_path"}, strict=True)
        evaluator = ev.Evaluator(eval_cfg, ckpt, dev)
        kept = []
        metrics = evaluator.run(
            save_outputs=False, on_batch=lambda b, lp, cp: kept.append(
                (b["label"], lp.cpu().numpy(), cp.cpu().numpy())))
    finally:
        os.chdir(cwd)
    runs["eval"] = path_counts()
    lin, clu = recount(kept, 4, 0)
    check(np.array_equal(lin, evaluator.linear_metrics.stats)
          and np.array_equal(clu, evaluator.cluster_metrics.stats)
          and all(math.isfinite(v) for v in metrics.values())
          and all(v == 0 for v in runs["eval"].values()),
          f"python -m stego_torch.eval on it ({sec:.1f} s, {FPN_VAL} scenes "
          f"at res {TRAIN_RES}; no counted kernel): the evaluator's summed "
          f"matrices equal a host recount; "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(metrics.items())))

    t0 = time.perf_counter()
    art = package(ckpt, os.path.join(tmp, "art"), res=TRAIN_RES,
                  batch_size=EVAL_BATCH)
    served = ServingModel.load(art)
    gen = torch.Generator(device=dev).manual_seed(21)
    img01 = torch.rand(EVAL_BATCH, TRAIN_RES, TRAIN_RES, 3, generator=gen,
                       device=dev)
    got = served.predict(img01.cpu().numpy())
    sec = time.perf_counter() - t0
    mean, std = (torch.as_tensor(x, device=dev) for x in channel_stats(3))
    seg = ev.load_model_for_eval(ckpt, dev)
    lp, cp, _ = ev.make_eval_step(seg, return_probs=True)(
        (img01 - mean) / std, torch.zeros(img01.shape[:3], device=dev))
    agree = min(float((got[f"{k}_preds"] == w.argmax(-1).cpu().numpy())
                      .mean()) for k, w in (("linear", lp), ("cluster", cp)))
    diff = max(float(np.abs(got[f"{k}_probs"] - w.cpu().numpy()).max())
               for k, w in (("linear", lp), ("cluster", cp)))
    check(agree >= PRED_AGREE and served.meta["in_chans"] == 3,
          f"served predict of the packaged checkpoint ({sec:.1f} s with the "
          f"export; {smi}): predictions agree with the eval step on "
          f"{agree:.4f} of the pixels, log-probs max abs diff {diff:.3e}")
    return runs


def fpn_resume(out, train_args, straight_dir):
    """``python -m stego_torch.train`` of the feature-pyramid arch cut at
    FPN_APP_CUT steps, then run again with resume=true to FPN_APP_STEPS:
    its last step's train state (the head, its BatchNorm statistics, the
    probes and the three Adams' states) must equal the straight run's
    (``straight_dir``) bit for bit. Returns the two runs' launches (1+1
    C1 a step)."""
    from stego_torch.train import app

    args = [a for a in train_args
            if not a.startswith(("max_steps=", "experiment_name="))]
    args.append("experiment_name=fpn_resumed")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    app.main(args + [f"max_steps={FPN_APP_CUT}"])
    app.main(args + [f"max_steps={FPN_APP_STEPS}", "resume=true"])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = path_counts()
    check(launches == launches_of(corr_sampled_fwd=FPN_APP_STEPS,
                                  corr_sampled_bwd=FPN_APP_STEPS),
          f"python -m stego_torch.train (arch=feature-pyramid) cut at "
          f"{FPN_APP_CUT} and resumed to {FPN_APP_STEPS} in {sec:.1f} s: "
          f"launches { {k: v for k, v in launches.items() if v} }")
    states = [torch.load(os.path.join(d, str(FPN_APP_STEPS), "state.pt"),
                         map_location="cpu", weights_only=True)
              for d in (straight_dir, os.path.join(
                  out, "checkpoints", "directory_fpn_resumed"))]
    pairs = [(f"modules.{k}", v, states[1]["modules"][k])
             for k, v in states[0]["modules"].items()]
    for name, opt in states[0]["optimizers"].items():
        for i, entry in opt["state"].items():
            pairs += [(f"{name}.{i}.{k}", v,
                       states[1]["optimizers"][name]["state"][i][k])
                      for k, v in entry.items()]
    off = [(n, float((a.double() - b.double()).abs().max()))
           for n, a, b in pairs if not torch.equal(a, b)]
    worst = max(off, key=lambda x: x[1]) if off else None
    check(not off and states[0]["step"] == states[1]["step"],
          f"feature-pyramid app: cut at {FPN_APP_CUT} and resumed, step "
          f"{FPN_APP_STEPS}'s train state equals the straight run's bit for "
          f"bit ({len(pairs)} tensors; {len(off)} differ"
          + (f", the largest {worst[1]:.3e} at {worst[0]}" if worst else "")
          + ")")
    return launches


# phase analysis: the written directory set (train images for the
# correspondence figure, the val set of the PR curves) and the PotsdamRaw
# scene (the reference's 15 x 15 grid of 320 x 320 tiles)
ANALYSIS_TRAIN, ANALYSIS_VAL, ANALYSIS_RES = 8, 64, 320
# (15 and 320: potsdam_mosaic's grid and tile size, as the main runs it)
POTSDAM_GRID, POTSDAM_TILE, ANALYSIS_BATCH = 15, 320, 16
CORR_RESOLUTIONS = (224, 512)
AP_ATOL, CRF_PARAM_RTOL = 1e-3, 1e-4


def write_potsdamraw(root, grid, res, seed=0):
    """The first ``grid`` x ``grid`` tiles of scene 0 of a PotsdamRaw tree
    (``potsdamraw/processed/{imgs,gt}/0_<row>_<col>.mat``, in the dataset's
    order over its 15 x 15 grid), each of ``res``: 8 x 8 blocks of the 6
    fine labels, a colour a label, with noise."""
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    palette = rng.integers(30, 226, (6, 3))
    cell = -(-res // 8)
    for sub in ("imgs", "gt"):
        os.makedirs(os.path.join(root, "potsdamraw", "processed", sub),
                    exist_ok=True)
    for i in range(grid * grid):
        gt = np.repeat(np.repeat(rng.integers(0, 6, (8, 8)), cell, 0),
                       cell, 1)[:res, :res].astype(np.uint8)
        img = np.clip(palette[gt] + rng.normal(0, 12, (res, res, 3)), 0,
                      255).astype(np.uint8)
        name = f"0_{i // 15}_{i % 15}.mat"
        for sub, key, arr in (("imgs", "img", img), ("gt", "gt", gt)):
            savemat(os.path.join(root, "potsdamraw", "processed", sub, name),
                    {key: arr})


def write_analysis_data(root):
    """Phase analysis's data under ``root``: ANALYSIS_TRAIN + ANALYSIS_VAL
    scenes of 27 classes at ANALYSIS_RES as the directory set "analysis",
    each train image's two neighbours the next image as its KNN caches at
    each CORR_RESOLUTIONS, and a POTSDAM_GRID x POTSDAM_GRID PotsdamRaw
    scene of POTSDAM_TILE tiles; numpy and scipy only."""
    from stego_torch.data.synthetic import write_synthetic_benchmark
    from stego_torch.train.knn import knn_cache_file

    write_synthetic_benchmark(root, "analysis", n_train=ANALYSIS_TRAIN,
                              n_val=ANALYSIS_VAL, res=ANALYSIS_RES,
                              n_classes=27)
    n = ANALYSIS_TRAIN
    nns = np.stack([np.arange(n), (np.arange(n) + 1) % n,
                    (np.arange(n) + 1) % n], 1)
    os.makedirs(os.path.join(root, "nns"), exist_ok=True)
    for res in CORR_RESOLUTIONS:
        np.savez(knn_cache_file(root, "vit_small", "analysis", "train", None,
                                res), nns=nns)
    write_potsdamraw(root, POTSDAM_GRID, POTSDAM_TILE)


def phase_analysis(dev, tmp):
    """``python -m stego_torch.eval.plot_apps``' three mains on the card,
    ViT-S/8 bf16 with the cocostuff27 head (dim 70, 27 classes), seeded
    random weights: correspondence at res 224 (2 trunk calls at B=1, 24 A
    at pair and 50 L; with the movie) and at 512 (N = 4097 pads past
    KV_RESIDENT_MAX_N: 50 L and no A), potsdam over a written PotsdamRaw
    scene of POTSDAM_GRID x POTSDAM_GRID tiles at 320 in batches of 16 (2
    trunk calls a batch: 12 A at pair_kv, 25 L each) and pr_curves over the
    written val set at 320 (one trunk call a batch of 16, up to 8) with the
    recalibrator on the card. Each main's launches exactly; each held
    against the same main with the trunk's kernels off
    (``VisionTransformer.use_kernels``; correspondence without its movie)
    on the card: the heatmaps at
    CODE_MAX_ABS / CODE_MEAN_ABS, the mosaic's predictions at PRED_AGREE,
    the APs within AP_ATOL, the recalibrator's scalars within
    CRF_PARAM_RTOL; its seconds printed. The data are written under
    ``<tmp>/data`` (write_analysis_data) before this is called. Returns
    {app: launches}."""
    from stego_torch.eval import plot_apps
    from stego_torch.models.convert import save_stego_checkpoint
    from stego_torch.models.vit import VisionTransformer

    t0 = time.perf_counter()
    root = os.path.join(tmp, "data")
    ckpt = os.path.join(tmp, "analysis.ckpt")
    save_stego_checkpoint(ckpt, cocostuff_segmenter(dev, "bfloat16"))
    print(f"analysis: the three plot apps, ViT-S/8 bf16, cocostuff27 head, "
          f"seeded weights; {ANALYSIS_TRAIN} train + {ANALYSIS_VAL} val "
          f"scenes at {ANALYSIS_RES} and a {POTSDAM_GRID} x {POTSDAM_GRID} "
          f"PotsdamRaw scene of {POTSDAM_TILE} x {POTSDAM_TILE} tiles, "
          f"written beside the phases since phase C1")
    data = [f"pytorch_data_dir={root}", "dataset_name=directory",
            "dir_dataset_name=analysis", "dir_dataset_n_classes=27",
            f"output_root={os.path.join(tmp, 'out')}"]
    runs = {
        "correspondence_224": (plot_apps.correspondence_main, data + [
            "model_type=vit_small", "dino_patch_size=8", "dim=70",
            "res=224", "img_num=3", "plot_movie=true"],
            launches_of(24, 50, "pair")),
        "correspondence_512": (plot_apps.correspondence_main, data + [
            "model_type=vit_small", "dino_patch_size=8", "dim=70",
            "res=512", "img_num=3"], launches_of(0, 50)),
        "potsdam": (plot_apps.potsdam_main,
                    [f"pytorch_data_dir={root}", f"model_path={ckpt}",
                     "img_num=0"],
                    launches_of(12 * 2 * -(-POTSDAM_GRID ** 2
                                            // ANALYSIS_BATCH),
                                25 * 2 * -(-POTSDAM_GRID ** 2
                                            // ANALYSIS_BATCH), "pair_kv")),
        "pr_curves": (plot_apps.pr_curves_main, data + [
            f"model_path={ckpt}", f"batch_size={ANALYSIS_BATCH}"],
            launches_of(12 * min(8, ANALYSIS_VAL // ANALYSIS_BATCH),
                        25 * min(8, ANALYSIS_VAL // ANALYSIS_BATCH),
                        "pair_kv")),
    }
    cwd = os.getcwd()
    os.chdir(tmp)  # potsdam writes results/predictions/potsdam here
    launches, outs = {}, {}
    try:
        for name, (main_fn, argv, want) in runs.items():
            for kernels in (True, False):
                VisionTransformer.use_kernels = kernels
                reset_counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                # the movie's heatmaps are the figure's function at other
                # points: its ~20 s GIF is encoded once, with the kernels
                out = main_fn([a for a in argv if kernels
                               or a != "plot_movie=true"], device=dev)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t1
                got = path_counts()
                outs[name, kernels] = out
                if kernels:
                    launches[name] = got
                    check(got == want, f"analysis, {name}: {secs:.2f} s on "
                          f"the card, launches A {got['attention']} "
                          f"(pair {got['attention_pair']}, pair_kv "
                          f"{got['attention_pair_kv']}), L "
                          f"{got['layer_norm']}")
                else:
                    print(f"  analysis, {name} with the trunk's kernels off: "
                          f"{secs:.2f} s, {got['attention']} A and "
                          f"{got['layer_norm']} L launches")
    finally:
        VisionTransformer.use_kernels = True
        os.chdir(cwd)

    for name in ("correspondence_224", "correspondence_512"):
        got, want = outs[name, True], outs[name, False]
        for side, g, w in zip(("self", "KNN"), got["heatmaps"],
                              want["heatmaps"]):
            diff = (g - w).abs()
            check(bool(torch.isfinite(g).all()) and g.shape == w.shape
                  and float(diff.max()) <= CODE_MAX_ABS
                  and float(diff.mean()) <= CODE_MEAN_ABS,
                  f"analysis, {name} heatmaps ({side}, {tuple(g.shape)}) vs "
                  f"the kernels off: max abs {float(diff.max()):.3e} (<= "
                  f"{CODE_MAX_ABS}), mean {float(diff.mean()):.3e} (<= "
                  f"{CODE_MEAN_ABS})")
        if got["movie"] is not None:
            check(all(m.shape[0] == 50 and bool(torch.isfinite(m).all())
                      for m in got["movie"]),
                  f"analysis, {name}: the movie's heatmaps "
                  f"{tuple(got['movie'][0].shape)} finite")
    got, want = outs["potsdam", True], outs["potsdam", False]
    side = POTSDAM_GRID * POTSDAM_TILE
    agree = float(np.mean(got["cluster"] == want["cluster"]))
    pngs = sorted(os.listdir(os.path.join(tmp, "results", "predictions",
                                          "potsdam")))
    check(got["cluster"].shape == (side, side) and agree >= PRED_AGREE
          and np.array_equal(got["label"], want["label"]),
          f"analysis, potsdam: the {side} x {side} mosaic's mapped "
          f"predictions agree with the kernels off on {agree:.4%} (>= "
          f"{PRED_AGREE:.0%}); PNGs {pngs}")
    got, want = outs["pr_curves", True], outs["pr_curves", False]
    gaps = {k: abs(got["aps"][k] - want["aps"][k]) for k in got["aps"]}
    check(all(g <= AP_ATOL for g in gaps.values()),
          f"analysis, pr_curves: APs {got['aps']} vs the kernels off, gaps "
          f"{gaps} (<= {AP_ATOL}); {got['targets'].size} pairs")
    rel = {k: abs(float(got["crf_params"][k] - want["crf_params"][k]))
           / max(abs(float(want["crf_params"][k])), 1e-12)
           for k in got["crf_params"]}
    check(all(r <= CRF_PARAM_RTOL for r in rel.values()),
          f"analysis, pr_curves: the recalibrator's scalars "
          f"{ {k: round(float(v), 6) for k, v in got['crf_params'].items()} }"
          f" vs the kernels off, relative gaps <= {max(rel.values()):.2e} "
          f"(<= {CRF_PARAM_RTOL})")
    print(f"  analysis: the phase took {time.perf_counter() - t0:.1f} s")
    return launches


def phase_tf32_eval(dev, tmp):
    """An f32-trunk eval step as ``python -m stego_torch.eval`` runs it: a
    fresh process's flags (torch's defaults: cuDNN TF32 on, matmul TF32
    off), an f32 ViT-S/8 checkpoint through ``load_model_for_eval`` (which
    turns TF32 off for an f32 trunk, ``utils/precision.py``), the flip-TTA
    code and both probes' log-probs (``make_eval_step``) at res 320, batch
    4; held against the same step with both flags off at the f32 trunk's
    gates (rtol 1e-4, atol 1e-5, tests/test_torch_vit.py). The control, the
    step with cuDNN's TF32 on again, must fail them. Restores the flags it
    found."""
    from stego_torch.eval.evaluate import (flip_tta_code,
                                           load_model_for_eval,
                                           make_eval_step)
    from stego_torch.models.convert import save_stego_checkpoint

    print("eval step, f32 ViT-S/8 checkpoint through load_model_for_eval "
          "from torch's default TF32 flags vs TF32 off (rtol 1e-4, atol "
          "1e-5); control: cuDNN TF32 on")
    kept = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    gen = torch.Generator(device=dev).manual_seed(9)
    img = images(gen, VAL_RES, dev, 4)
    label = torch.zeros(img.shape[:3], dtype=torch.long, device=dev)
    path = os.path.join(tmp, "f32.ckpt")
    save_stego_checkpoint(path, cocostuff_segmenter(dev, "float32"))

    def run(seg):
        with torch.inference_mode():
            code = flip_tta_code(seg, img)
        lin, clu, _ = make_eval_step(seg, return_probs=True)(img, label)
        return {"code": code.clone(), "linear": lin.clone(),
                "cluster": clu.clone()}

    def gap(got, want):
        inside = True
        text = []
        for k in want:
            diff = (got[k] - want[k]).abs()
            inside &= bool((diff <= 1e-5 + 1e-4 * want[k].abs()).all())
            text.append(f"{k} max abs diff {float(diff.max()):.3e}")
        return inside, ", ".join(text)

    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        seg = load_model_for_eval(path, dev)
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        entry = run(seg)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        full = run(seg)
        torch.backends.cudnn.allow_tf32 = True
        control = run(seg)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = kept
    ok, text = gap(entry, full)
    check(ok and flags == (False, False),
          f"f32 eval step after load_model_for_eval (cuDNN TF32 "
          f"{flags[0]}, matmul TF32 {flags[1]}) vs TF32 off: {text}")
    bad, text = gap(control, full)
    check(not bad, f"control, cuDNN TF32 on vs off fails the f32 gates: "
                   f"{text}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from stego_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    phase_times = {}
    lap_at = [t0]

    def lap(name):
        """The seconds since the last lap, as phase ``name``'s."""
        now = time.perf_counter()
        phase_times[name] = phase_times.get(name, 0.0) + now - lap_at[0]
        lap_at[0] = now
    # the port's library, C2's two check builds and the exact CRF's
    # lattice (g++), compiled together before any phase is timed
    from stego_torch import native

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        lattice = pool.submit(native.load_library)
        lib_path, *checks = pool.map(
            build.build, ((), (NO_FIXUP,), (COUNT_FIXUPS,)))
        lattice.result()
    CHECK_BUILDS.update(zip((NO_FIXUP, COUNT_FIXUPS), checks))
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name} "
          f"(and C2's check builds {', '.join(p.name for p in checks)}; "
          f"the permutohedral lattice with g++)")
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill stores", "C7513")):
                print(f"  ptxas: {line.strip()}")
    lap("build")

    dev = torch.device("cuda", 0)
    ln_err, ln = phase_layer_norm(dev)
    add_ln = phase_add_layer_norm(dev)
    at_err, at = phase_attention(dev)
    hm = phase_head_major(dev)
    at_f32 = phase_attention_f32(dev)
    narrow = phase_narrow(dev)
    narrow_f32 = phase_narrow_f32(dev)
    _, ln_narrow = phase_layer_norm(dev, NARROW_LN_SHAPES)
    phase_launch_floor(dev, narrow, narrow_f32, ln_narrow)
    lap("L, L2, A")
    serving = {}
    with tempfile.TemporaryDirectory() as tmp:
        for model_type in ("vit_small", "vit_tiny"):
            serving[model_type] = phase_slice(dev, tmp, model_type)
        lap("slice")
        artifacts = phase_serve(dev, tmp)
        lap("serve")
    for model_type, launches in serving.items():
        want = add_counts(*(launches_of(
            REQUESTS * ATTN_PER_REQUEST, REQUESTS * LN_PER_REQUEST,
            trunk_entry(model_type, res)) for res in RESOLUTIONS))
        check(launches == want,
              f"eval path launches, {MODEL_NAMES[model_type]}: {launches}")
    # the scenes of the feature-cache path, the app, its soak and phase ddp
    # (the FPN app validates the val split's first scenes at TRAIN_RES) and
    # phase analysis's data, made on the host's other cores while the next
    # phases run
    analysis_dir = tempfile.TemporaryDirectory()
    rendering = start_scenes(
        (0, TRAIN_IMAGES, TRAIN_RES), (1, VAL_IMAGES, VAL_RES),
        (1, DDP_VAL, TRAIN_RES),
        jobs=[(write_analysis_data, os.path.join(analysis_dir.name,
                                                 "data"))])
    c1 = phase_corr(dev)
    lap("C1")
    c2 = phase_corr_stream(dev)
    lap("C2")
    train, val = phase_train(dev)
    stream = phase_train_stream(dev)
    models = phase_train_models(dev)
    wide = phase_wide(dev)
    narrow_paths = phase_narrow_paths(dev)
    narrow_f32_paths = phase_narrow_f32_paths(dev)
    branches = phase_branches(dev)
    lap("train steps")
    with tempfile.TemporaryDirectory() as tmp:
        accuracy, _ = phase_accuracy(dev, tmp)
        phase_tf32_eval(dev, tmp)
    lap("accuracy, tf32 eval")

    # the feature-cache path: KNN, caches, cached train and val steps
    t0 = time.perf_counter()
    train_items, val_items, ddp_fpn_val = rendering()
    print(f"scenes: {TRAIN_IMAGES} at res {TRAIN_RES} and {VAL_IMAGES} at res "
          f"{VAL_RES} (and phase ddp's {DDP_VAL} at {TRAIN_RES}), 27 "
          f"classes, rendered beside the phases since phase C1, waited "
          f"{time.perf_counter() - t0:.1f} s for them")
    lap("scenes (wait)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bases = {trunk: cocostuff_segmenter(dev, dtype, cache_backbone_feats=True)
             for trunk, dtype in (("bf16", "bfloat16"), ("f32", "float32"))}
    with tempfile.TemporaryDirectory() as tmp:
        nns, knn_launches = phase_knn(dev, tmp, bases["bf16"], train_items)
    train_split = SceneSplit(train_items, nns, bases["bf16"].cfg.num_neighbors)
    val_split = SceneSplit(val_items)
    caches, cache_launches = phase_feat_cache(dev, bases, train_split,
                                              val_split)
    batches = index_batches(dev, train_split, 5)
    trained, cached = phase_cached_train(dev, bases, caches, batches)
    phase_cached_vs_image(dev, bases["f32"], caches[("f32", "train")],
                          train_split, batches[0])
    cached_val = phase_cached_val(dev, trained, caches, val_split)
    del bases, trained, caches
    lap("KNN, caches, cached steps")
    with tempfile.TemporaryDirectory() as tmp:
        app, ckpt = phase_app(dev, tmp, train_items, val_items, nns)
        lap("app")
        evals = phase_eval(dev, tmp, ckpt, val_items)
        lap("eval")
    with tempfile.TemporaryDirectory() as tmp:
        soaked = phase_soak(dev, tmp, train_items, val_items, nns)
    lap("soak")
    crf_loss = phase_crf_loss(dev)
    lap("CRF loss")
    with tempfile.TemporaryDirectory() as tmp:
        ddp, fpn_ddp = phase_ddp(dev, tmp, train_items, val_items,
                                 ddp_fpn_val, smi)
    lap("ddp")
    with tempfile.TemporaryDirectory() as tmp:
        fpn = phase_fpn(dev, tmp, smi)
    lap("fpn")
    with analysis_dir as tmp:
        analysis = phase_analysis(dev, tmp)
    lap("analysis")
    ladder = phase_layouts(dev)
    lap("ladder")
    print("phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_times.items())
        + f"; all {sum(phase_times.values()):.1f}")

    def per_step(steps, corr, entry="pair", trunk=True):
        """The launches of ``steps`` steps: a trunk call each (12 A at
        ``entry``, 25 L) unless not ``trunk``, and ``corr`` of C1 forward,
        C1 backward, C2 forward and C2 backward each."""
        calls = steps if trunk else 0
        return launches_of(12 * calls, 25 * calls, entry, **dict(zip(
            COUNTS[2:], (steps * x for x in corr))))

    check(train == per_step(TRAIN_STEPS, (1, 1, 0, 0)),
          f"train path launches: {train}")
    check(crf_loss == per_step(WIDE_STEPS, (1, 1, 0, 0)),
          f"CRF-loss train path launches: {crf_loss}")
    check(val == per_step(VAL_STEPS, (0, 0, 0, 0), "pair_kv"),
          f"val path launches: {val}")
    for name, run in stream.items():
        steps = FULL_STEPS if name == "full_field" else SHORT_STEPS
        check(run == per_step(steps, (0, 0, 1, 1)),
              f"{name} train path launches: {run}")
    for name, run in cached.items():
        steps = {"f32_full_field": FULL_STEPS,
                 "f32_gather": SHORT_STEPS}.get(name, TRAIN_STEPS)
        corr = (0, 0, 1, 1) if name in ("f32_full_field", "f32_gather") \
            else (1, 1, 0, 0)
        check(run == per_step(steps, corr, trunk=False),
              f"cached {name} train path launches: {run}")
    for name, want in (
            ("vit_tiny", per_step(WIDE_STEPS, (1, 1, 0, 0), "batch_resident")),
            ("vit_tiny_val", per_step(VAL_STEPS, (0, 0, 0, 0), "kv_resident")),
            ("vit_base", per_step(WIDE_STEPS, (1, 1, 0, 0))),
            ("vit_base_full_field", per_step(WIDE_FULL_STEPS, (0, 0, 1, 1)))):
        check(models[name] == want, f"{name} path launches: {models[name]}")
    for name, steps, corr in (("bf16", FPN_STEPS, (1, 1, 0, 0)),
                              ("f32", SHORT_STEPS, (1, 1, 0, 0)),
                              ("gather", SHORT_STEPS, (0, 0, 1, 1)),
                              ("f32_gather", SHORT_STEPS, (0, 0, 1, 1))):
        check(fpn[name] == per_step(steps, corr, trunk=False),
              f"feature-pyramid {name} train path launches: {fpn[name]}")
    for name, want in (
            ("cc100_s144", per_step(3, (1, 1, 0, 0))),
            ("cc160", per_step(3, (0, 0, 1, 1))),
            ("f32_trunk", launches_of(12 * 3, 0, f32=True,
                                      corr_sampled_fwd=3,
                                      corr_sampled_bwd=3))):
        check(wide[name] == want, f"{name} path launches: {wide[name]}")
    # launches summed over the paths of each trunk: ViT-S (serving, the
    # serving artifacts, train with the sampled, full-field, grid-sampled
    # and bf16-code losses, val, the KNN, the cache builds, cached train and
    # val, the app, its soak, the dataset eval, the CRF-loss train run,
    # phase ddp's ranks, the plot apps), ViT-T
    # (serving, its artifact, train, val), ViT-B (train, sampled and
    # full-field), and the layout ladder
    vit_s = add_counts(serving["vit_small"], train, val, *stream.values(),
                       knn_launches, cache_launches, *cached.values(),
                       cached_val, *wide.values(), app, soaked, evals,
                       crf_loss, artifacts.get("vit_small", {}),
                       *ddp.values(),
                       *branches.values(), *analysis.values())
    vit_t = add_counts(serving["vit_tiny"], models["vit_tiny"],
                       models["vit_tiny_val"], artifacts.get("vit_tiny", {}))
    vit_b = add_counts(models["vit_base"], models["vit_base_full_field"])
    # the feature-pyramid paths (ResNet-50: no attention, no LayerNorm),
    # phase ddp's among them: local negatives on an f32 trunk through C1,
    # global ones and the app on a bf16 trunk through C2's gather route
    fpn_c1 = {"bf16": add_counts(fpn["bf16"], fpn["app"],
                                 fpn["app_resume"]),
              "f32": add_counts(fpn["f32"], *(
                  v for k, v in fpn_ddp.items()
                  if k.startswith("fpn_local")))}
    fpn_gather = add_counts(fpn["gather"], *(
        v for k, v in fpn_ddp.items() if not k.startswith("fpn_local")))
    total = add_counts(vit_s, vit_t, vit_b, *ladder.values(), *fpn.values(),
                       *fpn_ddp.values())

    def row(name, source, replaces, launches_, err, times, bnd, lib=None,
            **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
                **extra}

    def measured(r, launches_, replaces, source, name):
        """A row from a phase's result dict ``r``."""
        return row(name, source, replaces, launches_, r["max_abs_err"],
                   (r["ms"], r["plain_ms"]), r["bound"], r["library_ms"],
                   shape=r["shape"],
                   **{k: r[k] for k in ("cold_ms", "two_call_ms", "forms",
                                        "launch_floor_ms") if k in r})

    ln_src, ln_ref = "stego_torch/csrc/layer_norm.cu", "stego_tpu/ops/layer_norm.py"
    at_src = "stego_torch/csrc/attention.cu"
    at_ref = "stego_tpu/ops/flash_attention.py"
    c1_src = "stego_torch/csrc/corr_sampled.cu"
    c1_ref = "stego_tpu/ops/pallas_corr_fused_sampling.py"
    c2_src = "stego_torch/csrc/corr_stream.cu"
    c2_ref = "stego_tpu/ops/pallas_corr.py"
    rows = [
        measured(ln[384], vit_s["layer_norm"] + ladder["vit_small"]
                 ["layer_norm"], f"{ln_ref}:39", ln_src, "layer_norm"),
        measured(ln[192], vit_t["layer_norm"] + ladder["vit_tiny"]
                 ["layer_norm"], f"{ln_ref}:39", ln_src, "layer_norm_192"),
        measured(ln[768], vit_b["layer_norm"] + ladder["vit_base"]
                 ["layer_norm"], f"{ln_ref}:39", ln_src, "layer_norm_768"),
    ]
    for d, model in ((384, "vit_small"), (192, "vit_tiny"),
                     (768, "vit_base")):
        rows.append(measured(add_ln[d], ladder[model]["add_layer_norm"],
                             f"{ln_ref}:72", ln_src,
                             "add_layer_norm" + ("" if d == 384 else f"_{d}")))
    rows += [
        measured(at[(8, 785, HEADS)], vit_s["attention_pair"]
                 - vit_s["attention_f32"]
                 + ladder["vit_small"]["attention_pair"],
                 f"{at_ref}:391", at_src, "attention"),
        # A-f32: the f32 trunk's token-major path; the head-major forms,
        # which no f32 path runs, under "forms"
        measured(at_f32, vit_s["attention_f32"], f"{at_ref}:391", at_src,
                 "attention_f32_two_pass"),
        measured(at[(8, 1601, HEADS)], vit_s["attention_pair_kv"],
                 f"{at_ref}:470", at_src, "attention_pair_kv"),
        measured(at[(32, 785, 12)], vit_b["attention_pair"]
                 + ladder["vit_base"]["attention_pair"],
                 "scripts/bench_attn_vitb.py:150", at_src,
                 "attention_vit_base"),
    ]
    # the head-major forms at their first shape (ViT-T serving at res 224;
    # kv-resident at 320); their launches on every path
    for entry, replaces in (("batch_resident", f"{at_ref}:188"),
                            ("kv_resident", f"{at_ref}:264"),
                            ("resident", f"{at_ref}:124"),
                            ("flash", f"{at_ref}:29"),
                            ("packed", f"{at_ref}:589"),
                            ("no_softmax", "scripts/bench_attncore.py:73")):
        rows.append(measured(hm[entry][0], total[f"attention_{entry}"],
                             replaces, at_src, f"attention_{entry}"))
    check(total["attention"] == sum(total[f"attention_{e}"] for e in ENTRIES),
          "every kernel A launch is at one entry point")
    # the narrow widths, launched by the sensitive accuracy row and the
    # narrow trunks' train steps only
    narrow_total = add_counts(accuracy, *narrow_paths.values())
    check(all(total[f"attention_d{d}"] == 0 for d in NARROW_DS)
          and all(total[f"layer_norm_{d}"] == 0 for d in NARROW_LN_DS),
          "the d=64 paths launch no narrow-head A and no L at the runtime "
          "widths")
    for d in NARROW_DS:
        rows.append(measured(narrow[d], narrow_total[f"attention_d{d}"],
                             f"{at_ref}:188", at_src, f"attention_d{d}"))
    # the f32 instantiation, launched by the f32 narrow trunks' forwards
    narrow_f32_total = add_counts(*narrow_f32_paths.values())
    check(all(total[f"attention_d{d}_f32"] == narrow_total[
        f"attention_d{d}_f32"] == 0 for d in NARROW_DS),
          "no other path launches the narrow-head kernel on f32")
    for d in NARROW_DS:
        rows.append(measured(narrow_f32[d],
                             narrow_f32_total[f"attention_d{d}_f32"],
                             f"{at_ref}:188", at_src, f"attention_d{d}_f32"))
    for d in (32, 64):
        rows.append(measured(ln_narrow[d], narrow_total[f"layer_norm_{d}"],
                             f"{ln_ref}:39", ln_src, f"layer_norm_{d}"))
    # C1's forward by feature type and channels, each launched by its own
    # trunk's paths; the backward reads no features
    ddp_f32 = ddp.get("local", {}).get("corr_sampled_fwd", 0)
    c1_fwd = {"bf16": vit_s["corr_sampled_fwd"]
              - cached["f32"]["corr_sampled_fwd"]
              - wide["f32_trunk"]["corr_sampled_fwd"]
              - wide["cc100_s144"]["corr_sampled_fwd"] - ddp_f32,
              "f32": cached["f32"]["corr_sampled_fwd"]
              + wide["f32_trunk"]["corr_sampled_fwd"] + ddp_f32,
              "bf16_192": vit_t["corr_sampled_fwd"],
              "bf16_768": vit_b["corr_sampled_fwd"],
              "bf16_cc100_s144": wide["cc100_s144"]["corr_sampled_fwd"],
              "bf16_2048": fpn_c1["bf16"]["corr_sampled_fwd"],
              "f32_2048": fpn_c1["f32"]["corr_sampled_fwd"]}
    check(total["corr_sampled_fwd"] == sum(c1_fwd.values()),
          "every C1 forward launch is on a path of one feature type")
    for case, suffix in (("bf16", ""), ("f32", "_f32"), ("bf16_192", "_192"),
                         ("bf16_768", "_768"),
                         ("bf16_cc100_s144", "_cc100_s144"),
                         ("bf16_2048", "_2048"), ("f32_2048", "_f32_2048")):
        errs, times, bnds, parts = c1[case]
        extra = {"parts_ms": {k: parts[k] for k in C1_FWD_PARTS}}
        if case == "f32":  # f32 at ViT-B's 768: no path runs it yet
            e, t, b, _ = c1["f32_768"]
            extra["cf768"] = dict(max_abs_err=e["fwd"], ms=t["fwd"][0],
                                  plain_ms=t["fwd"][1], bound_ms=b["fwd"][0])
        rows.append(row(f"corr_sampled_fwd{suffix}", c1_src, f"{c1_ref}:93",
                        c1_fwd[case], errs["fwd"], times["fwd"], bnds["fwd"],
                        **extra))
    wide_bwd = wide["cc100_s144"]["corr_sampled_bwd"]
    fpn_bwd = {k: v["corr_sampled_bwd"] for k, v in fpn_c1.items()}
    for case, suffix, launches_ in (
            ("bf16", "", total["corr_sampled_bwd"] - wide_bwd
             - sum(fpn_bwd.values())),
            ("bf16_cc100_s144", "_cc100_s144", wide_bwd),
            # the backward at the feature-pyramid step's two grids
            ("bf16_2048", "_2048", fpn_bwd["bf16"]),
            ("f32_2048", "_f32_2048", fpn_bwd["f32"])):
        errs, times, bnds, parts = c1[case]
        err = (max(c1[k][0]["bwd"] for k in c1) if case == "bf16"
               else errs["bwd"])
        rows.append(row(f"corr_sampled_bwd{suffix}", c1_src, f"{c1_ref}:187",
                        launches_, err, times["bwd"], bnds["bwd"],
                        parts_ms={k: v for k, v in parts.items()
                                  if k not in C1_FWD_PARTS}))
    # C2 by the path that runs it, each row measured at that path's shape
    # (phase C2's full-field code_bf16 case runs on no path: printed only)
    for suffix, key, run in (
            ("", ("full-field", False, False, 384),
             add_counts(stream["full_field"], ddp.get("full_field", {}))),
            # with phase ddp's global negatives: the sampled sets' rows
            ("_gather", ("grid-sampled", False, False, 384),
             add_counts(stream["gather"], branches["salience_gather"],
                        *(ddp.get(k, {}) for k in (
                            "global", "app", "nccl", "nccl_cards")))),
            ("_code_bf16", ("grid-sampled", True, False, 384),
             stream["code_bf16"]),
            ("_f32", ("full-field", False, True, 384),
             cached["f32_full_field"]),
            ("_f32_gather", ("grid-sampled", False, True, 384),
             cached["f32_gather"]),
            ("_768", ("full-field", False, False, 768),
             models["vit_base_full_field"]),
            ("_cc160", ("full-field", False, False, 384, WIDE_C2_DIM),
             wide["cc160"]),
            # the feature-pyramid step's fused_sampling=off paths, and
            # phase ddp's global negatives over ranks
            ("_gather_2048", ("grid-sampled", False, False, FPN_CF),
             fpn_gather),
            ("_f32_gather_2048", ("grid-sampled", False, True, FPN_CF),
             fpn["f32_gather"])):
        for what, line in (("fwd", 106), ("bwd", 229)):
            r = c2[key]
            extra = {} if what == "fwd" else dict(
                bound_stored_ms=r["bounds"]["bwd_stored"][0],
                bound_recompute_ms=r["bounds"]["bwd_recompute"][0],
                bound_fwd_bwd_ms=r["bounds"]["fwd_bwd"][0],
                stored_plain_ms=r["times"]["bwd_stored_plain"],
                stored_max_abs_err=r["errs"]["bwd_stored"])
            if suffix == "_f32":  # f32 at ViT-B's 768: no path runs it yet
                r = c2[("full-field", False, True, 768)]
                extra["cf768"] = dict(
                    max_abs_err=r["errs"][what], ms=r["times"][what][0],
                    plain_ms=r["times"][what][1],
                    bound_ms=r["bounds"][what][0])
            rows.append(row(
                f"corr_stream_{what}{suffix}", c2_src, f"{c2_ref}:{line}",
                run[f"corr_stream_{what}"], c2[key]["errs"][what],
                c2[key]["times"][what], c2[key]["bounds"][what], **extra))
    check(all(r["launches"] > 0 for r in rows),
          "every kernel row was launched on a path: "
          + ", ".join(f"{r['name']} {r['launches']}" for r in rows))
    print(json.dumps({"kernels": rows}))
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    CHILDREN = {"--serve-child": serve_child, "--ddp-child": ddp_child}
    sys.exit(CHILDREN[sys.argv[1]](sys.argv[2:]) if sys.argv[1:2]
             and sys.argv[1] in CHILDREN else main())
