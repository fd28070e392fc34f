#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (arcflow_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it imports nothing of JAX. Phases, one
line each, and any failure exits non-zero:

1. facts: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile every kernel source of ``arcflow_tpu_torch/csrc``
   (attention forward and backward, w4a8 matmul, inverse CDF, ring hop,
   int8-QK^T attention), one ``nvcc`` per source, all in parallel;
3. attention kernel vs plain: against ``attention_ref`` at the FLUX shape
   (B1 S4608 H24 D128), a ragged S and key-padded cases, and both timed at
   the FLUX shape beside the kernel's registers and spills; a planted fault
   (one K tile's rows swapped) must break the limit;
4. w4a8 kernel vs plain: against ``w4a8_matmul_ref`` at every (M, K, N) of
   the Qwen-Image int4 layers, a ragged M, groups of 32 and 64 and weights
   of -8; both timed at the two largest shapes;
5. FLUX at reduced depth (1 joint + 1 single block) and full width, in
   bf16: one forward through the kernel, the same weights through the plain
   attention, ``means`` compared by relative L2;
6. FLUX at full geometry: FLUX-12B ArcFlux (19 + 38 blocks, 24 x 128,
   K=16, guidance embeds) and the full FLUX VAE decoder with random bf16
   weights from a seed, 2-NFE at 1024x1024 from random prompt embeds through
   ``ArcFluxPipeline.__call__``; the image must be finite, (1, 1024, 1024, 3),
   and the run must launch the attention kernel exactly 2 x 57 times;
   phase 18 follows on the same model;
7. Qwen-Image at reduced depth (1 joint block) and full width, w4a8: one
   forward through the w4a8 kernel, the same weights through its plain
   version, ``means`` compared by relative L2;
8. Qwen-Image at full geometry: ArcQwen 20B (60 joint blocks, 24 x 128,
   text dim 3584, K=16, LoRA rank 256, 512 text tokens of which 384 are
   valid) with random bf16 weights from a seed, quantized with
   ``pipe.quantize_int4(act_quant=True)``, and the full Wan decoder, 2-NFE
   at 1024x1024 through ``ArcQwenImagePipeline.__call__``; the image must be
   finite, (1, 1024, 1024, 3) and the same on a second run, with exactly
   2 x 60 masked attention launches and 2 w4a8 launches per int4 layer;
   then a ``torch.profiler`` split of one warm image by kernel name;
9. attention backward kernels vs plain: dq, dk and dv against
   ``attention_bwd_ref`` at the FLUX shape, S = 777 and 1000, key-padded
   cases and a batch row with no valid key; kernel, plain version and the
   backward of one ``scaled_dot_product_attention`` call timed at the FLUX
   shape beside the kernel's registers and spills; a planted fault (the dQ
   partial of one key tile dropped) must break the limit;
10. FLUX training at reduced depth (1 joint + 1 single block) and full
    width, bf16: one ``LatentDiffusionTextImage.loss`` + backward through
    both attention kernels, then the same weights and draws through the
    plain versions; loss and adapter gradients compared by relative L2;
11. FLUX training at full geometry: the FLUX-12B ArcFlow distillation of
    ``configs/flux/arcflux_2nfe_k16.py`` (frozen bf16 trunk shared with the
    teacher, fp32 LoRA rank 256 + heads, checkpointing, LoRA dropout 0.05,
    nfe 2, 4 intermediate states) with random weights from a seed, 3
    ``train_step``s of ``build_train_step`` on one batch of random prompt
    embeds: finite losses and grad norms, the adapter moved, the frozen
    trunk bit-identical, the EMA equal to the adapter (copy-through before
    iteration 100), exactly 12 x 57 forward and 2 x 57 backward attention
    launches per step; then a ``torch.profiler`` split of one warm step;
12. inverse-CDF kernel vs plain: against ``gm1d_inverse_cdf_ref`` at the
    KR transport's per-axis problem (G 16 over the 128 x 128 latent, one
    target, 16 steps), 64 times that (1024 x 1024), a ragged M, five
    targets and saturated targets, each with the lanes per element its
    launcher chose; finite, within the root tolerance, bitwise
    deterministic; kernel (device time), the call and the plain version
    timed at both sizes, the kernel at every lane count at the KR axis,
    beside its registers and spills;
13. KR transport on the card: ``gaussian_samples_to_gm_samples`` on a
    mixture of the ArcFlux head geometry at 1024x1024 (K=16 over the
    128 x 128 x 16 latent): exactly 16 kernel launches (one per channel
    axis), the plain path's result by relative L2, and the round trip
    through ``gm_samples_to_gaussian_samples`` back to z;
14. GMFlow on the checkerboard at the full width of
    ``configs/gmflow/checkerboard_gmflow.py``: 1000 ``build_train_step``
    steps of ``Diffusion2D`` at batch 512 (finite losses that fall), then
    ``val_step`` with the EMA weights: 4096 samples, finite and the same on
    a repeat;
15. ring-hop kernel vs plain: ``ring_hop`` against ``ring_hop_ref`` at the
    hop shape of FLUX at sp = 4 (B1, 1152 x 1152, H24 D128), padded, a fully
    padded block, ragged and a 4-hop chain, on O and on the carry; three
    planted faults must break the limits; kernel, plain version and flash
    SDPA timed at one middle hop;
16. ``ring_attention`` on ``LocalRing(4)`` against ``attention_ref`` at the
    FLUX shape, unmasked and masked (16 hop launches per call), and a
    planted lost rotation that the limits must refuse;
17. FLUX (1 + 1 blocks) and Qwen w4a8 (1 block) at full width, every
    attention on ``LocalRing(4)`` against the attention kernel, and FLUX on
    ``LocalRing(3)``, which pads both of its streams;
18. (right after phase 6, on its model) FLUX-12B 2-NFE with every attention
    on ``LocalRing(4)``: exactly 1824 hop and no attention-kernel launches,
    latents against phase 6's, and a planted lost rotation refused;
19. the int8 product of the w8a8 layers (``ops/int8_matmul.py``,
    ``torch._int_mm``) against its exact plain version at every (M, K, N)
    of the FLUX-12B int8 layers at batch 1, bitwise; timed at the two
    largest;
20. FLUX at reduced depth (1 + 1 blocks) and full width under w8a8: one
    forward through the attention kernel and the int8 product, the same
    weights through their plain versions, ``means`` by relative L2; and
    the quantization's own effect against the bf16 forward;
21. (after phase 18, on phase 6's model) FLUX-12B quantized in place with
    ``pipe.quantize_int8(act_quant=True)``: a finite image, the same on a
    second run, with exactly 114 attention and 2 x 502 int8 launches,
    s/image, resident and peak memory, latents against phase 6's; then the
    layers' ``act_quant`` off and weight-only int8 timed the same way;
22. int8-QK^T attention kernel (K7) vs plain: against
    ``flash_attention_int8_ref`` at the FLUX shape, masked, with a keyless
    batch row (the mean of v), at the JAX test's shape, ragged, and on the
    q, k, v of one joint and one single block captured from phase 21's
    w8a8 image (cosine against K1 above 0.999); two planted faults must
    break the limits; the fused row quantization bitwise equal to
    ``rowwise_int8`` on every case's q and k, fp32 and head-major rows; K7,
    the call with its quantization, its plain version, K1 and bf16 SDPA
    timed at the FLUX shape, and the quantization alone, beside both
    kernels' registers and spills.

``python3 chip_smoke.py --ranks 4`` (four cards) instead spawns 4 NCCL
ranks and serves FLUX-12B through ``pipe.shard({'sp': 4})`` in ring and in
Ulysses mode, against one card and against ``LocalRing(4)``.

Then one JSON line of per-kernel numbers (each with its bound on the card
and the time of one PyTorch library call for the same function, where there
is one), the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import gc
import importlib
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from arcflow_tpu_torch.data import CheckerboardData
from arcflow_tpu_torch.models import (ArcFluxTransformer2DModel,
                                      ArcQwenImageTransformer2DModel,
                                      Diffusion2D, LatentDiffusionTextImage,
                                      PretrainedVAE, PretrainedVAEQwenImage)
from arcflow_tpu_torch.models import layers
from arcflow_tpu_torch.models.layers import LoRADense
from arcflow_tpu_torch.ops import _build
from arcflow_tpu_torch.ops import attention as attn
from arcflow_tpu_torch.ops import flash_int8 as fi8
from arcflow_tpu_torch.ops import int8_matmul as i8
from arcflow_tpu_torch.ops import quant_matmul as qmm
from arcflow_tpu_torch.ops import ring_hop as hop
from arcflow_tpu_torch.ops.gm import gm_ops
from arcflow_tpu_torch.ops.gm import inverse_cdf as icdf
from arcflow_tpu_torch.parallel import (LocalRing, SequenceParallel,
                                        ring_attention,
                                        set_sequence_parallel,
                                        setup_distributed, spawn)
from arcflow_tpu_torch.pipelines import ArcFluxPipeline, ArcQwenImagePipeline
from arcflow_tpu_torch.runner import (EmaConfig, TrainState, build_optimizers,
                                      build_train_step, count_params)
from arcflow_tpu_torch.utils.pytree import flatten
from arcflow_tpu_torch.utils.quantize import pack_int4

# the module, which the package's ``ring_attention`` function shadows
ring_mod = importlib.import_module(
    'arcflow_tpu_torch.parallel.ring_attention')

SEED = 0
FLUX_12B = dict(in_channels=64, num_layers=19, num_single_layers=38,
                attention_head_dim=128, num_attention_heads=24,
                joint_attention_dim=4096, pooled_projection_dim=768,
                num_gaussians=16, lora_rank=0)
FLUX_SHAPE = (1, 4608, 24, 128)
# the Qwen path's masked attention: 512 text tokens of which 384 are valid,
# then 4096 image tokens, so 4480 of 4608 keys are valid
QWEN_VALID_KEYS = 4480
# FLUX-12B ArcFlow distillation: configs/flux/arcflux_2nfe_k16.py:13-112
# (model, train_cfg, EMA hook) and configs/flux/_mesh_train.py:19-26
# (optimizer, clip), batch 1
FLUX_TRAIN_NET = dict(in_channels=64, num_layers=19, num_single_layers=38,
                      attention_head_dim=128, num_attention_heads=24,
                      joint_attention_dim=4096, pooled_projection_dim=768,
                      guidance_embeds=True, checkpointing=True)
FLUX_TRAIN_LATENT = (128, 128, 16)          # 1024x1024
FLUX_TRAIN_CFG = dict(num_decay_iters=2000, window_substeps=3, gm_dropout=0.1,
                      num_intermediate_states=4, distilled_guidance_scale=3.5,
                      teacher_distilled_guidance_scale=3.5, nfe=2,
                      timestep_ratio=1.0, total_substeps=128,
                      diffusion_grad_clip=50.0,
                      diffusion_grad_clip_begin_iter=100,
                      diffusion_grad_clip_skip_ratio=20.0)
FLUX_TRAIN_OPT = dict(diffusion=dict(
    type='AdamW', lr=1e-4, betas=(0.9, 0.95), weight_decay=0.0,
    paramwise_cfg=dict(custom_keys={'proj_out_loggamma': dict(lr_mult=0.1)})))
FLUX_TRAIN_EMA_HOOK = dict(type='ExponentialMovingAverageHookMod',
                           module_keys=('diffusion_ema',), interp_mode='lerp',
                           interval=1, start_iter=100,
                           momentum_policy='karras',
                           momentum_cfg=dict(gamma=7.0))
# DiT forwards per train step: nfe student forwards with grad, nfe x
# num_intermediate_states teacher forwards, and the nfe student forwards
# recomputed block by block in the backward
TRAIN_FORWARDS = 2 + 2 * 4 + 2
TRAIN_BACKWARDS = 2
# H100 SXM dense peaks and memory rate (NVIDIA's data sheet), for the bound
H100_BF16, H100_INT8, H100_BYTES = 989e12, 1979e12, 3.35e12
# fp32 outside the tensor cores (NVIDIA's data sheet: 67 TFLOP/s), and the
# special-function units: 16 results per clock per SM for exp2, sin, rsqrt
# and the like (CUDA C++ Programming Guide, throughput of arithmetic
# instructions, compute capability 9.0) x 132 SMs x the 1.98 GHz boost
# clock of the data sheet
H100_FP32, H100_SFU = 67e12, 16 * 132 * 1.98e9
# the KR transport at the ArcFlux head geometry: K=16 heads
# (configs/flux/arcflux_2nfe_k16.py) over the 128 x 128 x 16 latent of a
# 1024^2 image (FLUX_TRAIN_LATENT), one draw, 16 NR steps, no grad
KR_K, KR_LATENT, KR_STEPS, KR_LOGSTD = 16, (128, 128, 16), 16, -1.0
K6_LARGE_HW = (1024, 1024)              # 64 x the 16,384 elements of an axis
# kernel vs plain, per unsaturated element (|target| < 0.999): both run the
# same fp32 steps with sums in another order, so their cdfs differ by a few
# 1e-7 and a root moves by that over the slope 2 pdf
K6_ATOL, K6_CDF_TOL = 1e-5, 1e-6
# KR on the card: kernel path vs plain path, relative L2 over the pixels
# whose every axis is unsaturated; and the round trip z -> x -> z, max abs
# error there (about 4e-5 in a CPU rehearsal at 96 x 96)
KR_REL_L2, KR_ROUND_TRIP = 1e-4, 1e-3
# configs/gmflow/checkerboard_gmflow.py:6-44 (model, train_cfg, test_cfg,
# optimizer, data, EMA hook)
CKB_MODEL = dict(
    data_shape=(1, 1, 2), diffusion_use_ema=True,
    diffusion=dict(
        type='GMFlow',
        denoising=dict(type='ToyGMFlowDenoiser', out_channels=2,
                       num_gaussians=8, hidden=(256, 256, 256),
                       num_timesteps=1000),
        flow_loss=dict(type='GMFlowNLLLoss', data_info=dict(
            pred_means='means', target='x_t_low', pred_logstds='logstds',
            pred_logweights='logweights')),
        num_timesteps=1000,
        timestep_sampler=dict(type='ContinuousTimeStepSampler', shift=1.0)))
CKB_TRAIN_CFG = dict(trans_ratio=1.0, diffusion_grad_clip=10.0)
CKB_TEST_CFG = dict(sampler='FlowEulerODE', num_timesteps=16,
                    output_mode='mean', order=2, num_substeps=2)
CKB_OPT = dict(diffusion=dict(type='AdamW', lr=1e-3, weight_decay=0.0))
CKB_EMA_HOOK = dict(type='ExponentialMovingAverageHookMod',
                    module_keys=('diffusion_ema',), interp_mode='lerp',
                    interval=1, start_iter=100, momentum_policy='karras',
                    momentum_cfg=dict(gamma=7.0))
CKB_BATCH, CKB_STEPS, CKB_SAMPLES = 512, 1000, 4096
# configs/qwen/arcqwen_2nfe_k16.py and bench.py:build_qwen
QWEN_20B = dict(in_channels=64, num_layers=60, attention_head_dim=128,
                num_attention_heads=24, joint_attention_dim=3584,
                max_text_len=512, num_gaussians=16, lora_rank=256)
QWEN_TXT, QWEN_TXT_VALID, QWEN_SHIFT = 512, 384, 3.1
# int4 layers per joint block: 2 AdaLN modulations, 8 attention projections,
# 4 MLP projections; plus txt_in and the two timestep-embedder linears
# (img_in's 64 inputs are not a multiple of the 128 group; norm_out and the
# heads are the adapter surface)
INT4_PER_BLOCK, INT4_OUTSIDE_BLOCKS = 14, 3
# (M, K, N) of every int4 layer of the Qwen path: image and text streams
# (4096 and 512 tokens), txt_in, the modulations and the timestep embedder
W4A8_SHAPES = [(4096, 3072, 3072), (4096, 3072, 12288), (4096, 12288, 3072),
               (512, 3072, 3072), (512, 3072, 12288), (512, 12288, 3072),
               (512, 3584, 3072), (1, 3072, 18432), (1, 256, 3072),
               (1, 3072, 3072)]
W4A8_TIMED = [(4096, 3072, 12288), (4096, 12288, 3072)]
# ragged M and N, each at groups 32, 64 and 128 over K = 384: rows and
# columns off the kernel's 128 x 128 tiles and its 8-token tile, N off the
# 16 bytes a TMA row steps in
W4A8_RAGGED_M, W4A8_RAGGED_N = (1, 3, 130, 511, 513, 777, 4097), (136, 264)
# w4a8 kernel vs plain: each per-group partial sum is an exact integer in
# both (int32 in the kernel, fp32 below 2^24 in the plain version, TF32
# off), so they differ only in how the fp32 sum over groups rounds; each
# output must lie within 1e-6 of its own sum_k |x| |w| scale
W4A8_TOL = 1e-6
# bf16 output of the kernel vs the fp32 plain version cast to bf16: the
# kernel rounds P to bf16 before P.V (8 significant bits), so a few bf16
# ulps of O, whose values are O(1)
O_TOL = 2e-2
# fp32 softmax statistics from bf16 products summed in another order
LSE_TOL = 1e-3
# relative L2 of ``means`` after 1 + 1 full-width blocks in bf16: the kernel
# and the plain path differ by bf16 rounding of P (2^-8 relative) mixed into
# the residual stream; 2e-2 leaves a few ulps of headroom
SLICE_REL_L2 = 2e-2
# relative L2 of ``means`` after 1 full-width Qwen block in w4a8, w4a8
# kernel vs its plain version: their layer outputs differ by fp32 rounding
# of the sum over groups, which flips a bf16 rounding now and then. A flip
# in a token's largest element changes its activation scale (absmax / 127),
# so the whole token re-rounds and many of its int8 values move one step
# (1/127 of the absmax) downstream: bf16 noise of the size of one bf16 ulp
# (2^-8) over the block, as in the FLUX slice above, hence the same 2e-2. A
# layout, sign or scale error in the kernel moves ``means`` by O(1).
QWEN_SLICE_REL_L2 = 2e-2
# kernel vs plain backward, per gradient: relative L2 of dq, dk, dv. The
# kernels round P and dS to bf16 (8 significant bits) before their products
# and write bf16 gradients: a few bf16 ulps of noise, 2^-8 = 4e-3 each
BWD_REL_L2 = 2e-2
# reduced training slice, kernels vs plain, relative L2 of the loss and of
# all adapter gradients together: the forward differs by the bf16 rounding
# of P (about 5e-3 after 2 blocks, phase 5), the teacher targets as much,
# and the backward adds the bf16 rounding of P and dS in each block's
# gradient; 5e-2 is ten times that and far below the O(1) of a wrong
# gradient. Most of that norm is the heads' and the last block's, whose
# gradients pass through no attention backward, and at random weights the
# attention backward carries a small share of the rest (the residual stream
# carries most). So the phase also isolates the backward: under the
# kernels' forward, each adapter tensor upstream of an attention call (the
# timestep embedder's LoRA feeds every block's modulation, the joint
# block's LoRA feeds the single block) takes the kernels' backward, the
# plain one, and the plain one with its outputs zeroed; the kernels' error
# over the share the attention backward carries (plain minus zeroed) is
# bounded at BWD_REL_L2, the per-gradient bound of phase 9. A planted fault,
# the plain backward with dq zeroed, must break that bound.
TRAIN_SLICE_REL_L2 = 5e-2
UPSTREAM_OF_ATTENTION = ('time_text_embed.', 'joint_blocks.')
# device time by kernel family in the profile: the first family with a
# substring in the kernel's name takes it (cuDNN's implicit-GEMM convs
# before cuBLAS's GEMMs)
KERNEL_FAMILIES = (('w4a8 kernel', ('w4a8_matmul',)),
                   ('int8 GEMM (cuBLASLt)', ('s8s8', 'i8i8', 'imma',
                                             'int8', '_s8_')),
                   ('attention backward kernels', ('attention_bwd',)),
                   ('attention kernel', ('attention_fwd',)),
                   ('optimizer and EMA (foreach)', ('multi_tensor_apply',)),
                   ('convolution', ('conv', 'cudnn', 'fprop', 'implicit',
                                    'nchwToNhwc', 'nhwcToNchw')),
                   ('cuBLAS GEMM', ('gemm', 'nvjet', 'cutlass')),
                   ('reduction', ('reduce_kernel',)),
                   ('elementwise and copies', ('elementwise', 'copy',
                                               'Memcpy', 'Memset')))
# sequence parallelism: the FLUX sequence in 4 shards of 1152 tokens
SP = 4
# the ring hop (K4) and the ring against their fp32 plain versions, on O
# (bf16) and on the normalized carry acc / l (fp32): every element within
# K4_ATOL + K4_RTOL |ref| and the whole within K4_REL_L2 by relative L2.
# The kernel rounds P to bf16 (2^-9 relative) before P.V: a sound run reads
# up to 1.2e-3 on acc / l and one bf16 ulp of O (at most 2^-7 of |O|), and a
# few 1e-3 by relative L2. A dropped hop, a V tile read with its key rows
# out of place or a carried acc left unscaled moves O by a tenth of its
# norm or more; phases 15 and 16 plant such faults and require that both
# limits refuse each.
K4_ATOL, K4_RTOL, K4_REL_L2 = 2e-3, 2 ** -7, 1e-2
# FLUX-12B under a ring against the same image on the attention kernel,
# relative L2 of the latents: 57 blocks of random weights amplify the bf16
# rounding by which the ring's hop-by-hop softmax and the one-pass kernel
# differ (phase 17 measures it after 2 blocks; a sound image reads about
# 1e-2), so the bound is three times that; phase 18 plants a lost rotation
# and requires that the bound refuse it
SP_IMAGE_REL_L2 = 3e-2
# int8 layers of FLUX-12B under quantize_weights_int8's skip rules: 14 per
# joint block (2 modulations, 8 attention projections, 4 MLP projections),
# 6 per single block (modulation, q, k, v, proj_mlp, proj_out), and
# x_embedder, context_embedder and the six embedder linears (timestep,
# guidance, pooled text); norm_out and the heads are the adapter surface
INT8_PER_JOINT, INT8_PER_SINGLE, INT8_OUTSIDE_BLOCKS = 14, 6, 8
# (M, K, N) of every int8 layer of the FLUX path at batch 1: the image
# stream (4096 tokens) and the text stream (512) of the joint blocks, the
# 4608 tokens of the single blocks, the modulations and embedders (M = 1)
INT8_SHAPES = [(4096, 64, 3072), (4096, 3072, 3072), (4096, 3072, 12288),
               (4096, 12288, 3072), (512, 4096, 3072), (512, 3072, 3072),
               (512, 3072, 12288), (512, 12288, 3072), (4608, 3072, 3072),
               (4608, 3072, 12288), (4608, 15360, 3072), (1, 256, 3072),
               (1, 768, 3072), (1, 3072, 3072), (1, 3072, 18432),
               (1, 3072, 9216)]
INT8_TIMED = [(4608, 15360, 3072), (4608, 3072, 12288)]
# relative L2 of ``means`` after 1 + 1 full-width blocks under w8a8, the
# card against the plain attention and plain int8 product. The int8
# product is exact on both sides (phase 20 also requires the card's
# layers with the plain product to equal the card bit for bit), so the
# whole difference is the attention's bf16 rounding of P (phase 5: about
# 5e-3), which w8a8 amplifies: an activation moved by it may round to a
# neighbouring int8 step, and a moved token maximum re-rounds the whole
# token. A sound run read 1.98e-2 (NVIDIA H100 80GB HBM3, 700 W), so the
# bound is 5e-2; an attention fault moves ``means`` by O(1). The bound is
# not meant to tell w8a8 from bf16 (their own distance is 4.5e-2): the
# launch counts and the bitwise check of the int8 product do that.
W8A8_SLICE_REL_L2 = 5e-2
# FLUX-12B latents under w8a8 (or weight-only int8) against the bf16 image
# of phase 6, relative L2: the quantization's own error, 4.5e-2 after 2
# blocks in phase 20 and about as much after 57 at random weights (4.4e-2
# and 3.2e-2 read on NVIDIA H100 80GB HBM3, 700 W); the bound is three
# times that. A broken layout or scale moves them by O(1).
INT8_IMAGE_REL_L2 = 0.15
# K7 against its fp32 plain version (bf16 O): every element within
# K7_ATOL + K7_RTOL |ref| and the whole within K7_REL_L2 by relative L2.
# Both compute the same exact int8 scores; the kernel rounds P to bf16
# (2^-9 relative) before P.V, as K1 and K4 do, so the limits are K4's.
# Planted faults (k scales dropped, key rows swapped in one tile) must
# break both. On real q, k, v, K7 against K1 by cosine, the property
# tests/test_flash_int8.py:test_close_to_full_precision_attention pins.
K7_ATOL, K7_RTOL, K7_REL_L2, K7_COSINE = 2e-3, 2 ** -7, 1e-2, 0.999
# ``--ranks``: Qwen w4a8 at full width and this depth, its text mask sharded
# with the text tokens and rotated with the K/V blocks
RANKS_QWEN_LAYERS = 2


def log(line):
    print(line, flush=True)


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def roofline(ops, nbytes, peak):
    """The least time (ms) the card could take for ``ops`` operations at
    ``peak`` per second and ``nbytes`` moved at the memory rate, and which
    of the two bounds it."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / H100_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def attention_bound(shape, valid_keys=None, backward=False):
    """Roofline of attention at (B, S, H, D) over ``valid_keys`` keys (all
    by default): forward QK^T and PV, 4 S Sk D H FLOP, reading q, k, v and
    writing o and the LSE; backward S, dP, dV, dK and dQ, 10 S Sk D H FLOP,
    reading q, k, v, o, dO and the LSE, writing dq, dk, dv. Only the valid
    keys' rows of k and v (and dk, dv) count as work."""
    b, s, h, d = shape
    kv = s if valid_keys is None else valid_keys
    row = b * h * d * 2                        # one bf16 row of all heads
    if backward:
        ops = 10 * b * h * s * kv * d
        nbytes = 4 * s * row + 4 * kv * row + b * h * s * 4
    else:
        ops = 4 * b * h * s * kv * d
        nbytes = 2 * s * row + 2 * kv * row + b * h * s * 4
    if valid_keys is not None:
        nbytes += b * s                        # the key mask
    return roofline(ops, nbytes, H100_BF16)


def sdpa(q, k, v, kv_valid=None):
    """One ``scaled_dot_product_attention`` call on the (B, S, H, D) tensors
    (head-major views, no copies): the library yardstick, never on the
    port's path."""
    mask = None if kv_valid is None else kv_valid[:, None, None, :]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask).transpose(1, 2)


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, name, iters):
    """Mean device time per launch of the kernel whose name holds ``name``
    (per call, of every kernel the call runs, with ``name`` None), over
    ``iters`` calls of ``fn`` under ``torch.profiler`` after two warm-up
    calls: the device's own time where a call is too short for CUDA events
    around it to see past the host's launch cost. The profiler now and then
    drops a kernel record of such short calls: the window runs again, up to
    three times, and then a named kernel's mean is taken over the launches
    it recorded, if they are at least half."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (name is None or name in e.name)]
        if name is None and len(us) >= iters and len(us) % iters == 0:
            return sum(us) / iters / 1e3
        if name is not None and (len(us) == iters or (
                attempt == 2 and 2 * len(us) >= iters)):
            return sum(us) / len(us) / 1e3
    raise AssertionError(f'the profiler saw {len(us)} kernel records of '
                         f'{name or "the call"} in {iters} calls')


def ptxas_usage(kernel):
    """Registers and spills that ``-Xptxas -v`` reported for the kernel
    whose mangled name holds ``kernel``, from the build log."""
    log = _build.library_path().with_suffix('.log').read_text().splitlines()
    usage, current = [], None
    for line in log:
        if 'Compiling entry function' in line:
            current = line
        elif current and kernel in current and (
                'spill' in line or 'registers' in line):
            usage.append(line.split(':')[-1].strip() if 'registers' in line
                         else line.strip())
    return '; '.join(usage) or 'not in the build log'


def phase_facts():
    if not torch.cuda.is_available():
        raise SystemExit('FAIL facts: torch.cuda.is_available() is false')
    smi = smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), '--version'],
                          capture_output=True, text=True, check=True)
    log(f'phase 1 facts: ok | nvidia-smi: {smi} | torch {torch.__version__} '
        f'cuda {torch.version.cuda} | devices {torch.cuda.device_count()} | '
        f'nvcc: {nvcc.stdout.strip().splitlines()[-1]} | TPU kernels still '
        f'to port: none')
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    ptxas = [ln.strip() for ln in lib.with_suffix('.log').read_text()
             .splitlines() if 'registers' in ln or 'spill' in ln]
    log(f'phase 2 build: ok in {time.perf_counter() - t0:.1f} s -> '
        f'{lib.name} | ptxas: {" / ".join(ptxas)}')


def planted_k1_fault(q, k, v, ref):
    """Planted fault: key rows 128-191 and 192-255 of K swapped, what a K
    tile landing out of place in the ring does. The kernel on it must break
    phase 3's limit against the sound plain O ``ref``. Returns the
    reading."""
    swap = torch.cat([torch.arange(192, 256), torch.arange(128, 192)]).to(
        k.device)
    k_bad = k.clone()
    k_bad[:, 128:256] = k[:, swap]
    bad = attn.flash_attention_fwd(q, k_bad, v).float()
    err = (bad - ref.float()).abs()
    if not bool((err > O_TOL + O_TOL * ref.float().abs()).any()):
        raise AssertionError(f'K1 planted fault (K tile rows swapped) passes '
                             f'the O limit: max|dO| {err.max().item():.3e}')
    return (f'planted fault, K rows 128-191 and 192-255 swapped: max|dO| '
            f'{err.max().item():.3e}, refused')


def phase_kernel_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED)
    cases = [('flux', FLUX_SHAPE, None), ('ragged', (2, 1000, 4, 128), None),
             ('key_padded', (2, 1000, 4, 128), (900, 1000)),
             ('no_valid_key', (2, 70, 2, 128), (0, 70))]
    worst = 0.0
    parts = []
    for name, shape, lengths in cases:
        q, k, v = (torch.randn(shape, generator=g, device='cuda',
                               dtype=torch.bfloat16) for _ in range(3))
        kv_valid = None
        if lengths is not None:
            kv_valid = torch.arange(shape[1], device='cuda')[None, :] < \
                torch.tensor(lengths, device='cuda')[:, None]
        out, lse = attn.flash_attention_fwd(q, k, v, kv_valid,
                                            return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = attn.attention_ref(q, k, v, kv_valid, return_lse=True)
        torch.testing.assert_close(out.float(), ref.float(), rtol=O_TOL,
                                   atol=O_TOL)
        finite = torch.isfinite(ref_lse)
        if not torch.equal(finite, torch.isfinite(lse)):
            raise AssertionError(f'{name}: LSE finiteness differs')
        torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=0,
                                   atol=LSE_TOL)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse[finite] - ref_lse[finite]).abs().max().item() \
            if finite.any() else 0.0
        worst = max(worst, err)
        parts.append(f'{name} {tuple(shape)} max|dO| {err:.3e} '
                     f'max|dLSE| {lse_err:.3e}')
        if name == 'flux':
            flux_qkv = (q, k, v)
        if name == 'ragged':
            fault = planted_k1_fault(q, k, v, ref)
    q, k, v = flux_qkv
    b, s, h, d = FLUX_SHAPE
    masked = torch.arange(s, device='cuda')[None, :] < QWEN_VALID_KEYS
    timed = {}
    for name, kv_valid in (('unmasked', None), ('masked', masked)):
        ms = cuda_ms(lambda: attn.flash_attention_fwd(q, k, v, kv_valid), 20)
        plain_ms = cuda_ms(lambda: attn.attention_ref(q, k, v, kv_valid), 5)
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: sdpa(q, k, v, kv_valid), 20)
        bound_ms, bound_by = attention_bound(
            FLUX_SHAPE, None if kv_valid is None else QWEN_VALID_KEYS)
        timed[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
    log(f'phase 3 attention kernel vs plain: ok | {" ; ".join(parts)} | '
        f'FLUX shape B{b} S{s} H{h} D{d}: ' + ' ; '.join(
            f'{name}{"" if name == "unmasked" else f" ({QWEN_VALID_KEYS} valid keys)"}'
            f' kernel {t["ms"]:.4f} ms, plain fp32 {t["plain_ms"]:.4f} ms, '
            f'SDPA {t["library_ms"]:.4f} ms, bound {t["bound_ms"]:.4f} ms '
            f'({t["bound_by"]}, {100 * t["bound_ms"] / t["ms"]:.1f}% of it)'
            for name, t in timed.items())
        + f' | ptxas: {ptxas_usage("attention_fwd_kernel")} | {fault}')
    return worst, timed


def w4a8_case(g, m, k, n, group=128):
    """Random int8 activations, int4 weights over [-8, 7] and scales."""
    xq = torch.randint(-127, 128, (m, k), generator=g, device='cuda',
                       dtype=torch.int8)
    q = torch.randint(-8, 8, (k, n), generator=g, device='cuda',
                      dtype=torch.int8)
    scale = 0.01 + 0.05 * torch.rand(k // group, n, generator=g,
                                     device='cuda')
    return xq, q, pack_int4(q, group), scale


def w4a8_check(xq, q, packed, scale):
    """Kernel vs plain at one shape: raises past ``W4A8_TOL``; returns the
    max abs error and the max error over its bound's scale."""
    group = xq.shape[1] // scale.shape[0]
    out = qmm.w4a8_matmul(xq, packed, scale)
    torch.cuda.synchronize()
    ref = qmm.w4a8_matmul_ref(xq, packed, scale)
    scale_k = scale.repeat_interleave(group, dim=0)
    mag = xq.abs().float() @ (q.abs().float() * scale_k)
    err = (out - ref).abs()
    if not bool((err <= W4A8_TOL * mag).all()):
        raise AssertionError(
            f'w4a8 {tuple(xq.shape)} x {tuple(q.shape)} group {group}: '
            f'error {(err / mag.clamp_min(1e-30)).max().item():.3e} of '
            f'sum |x||w|scale > {W4A8_TOL}')
    return err.max().item(), (err / mag.clamp_min(1e-30)).max().item()


def w4a8_epilogue_check(g, xq, packed, scale):
    """The kernel's fused epilogue (row scale, bf16 out) bitwise equal to
    the two-step path (fp32 out, then ``(y * xs).to(bf16)``, what
    ``models/layers.py:_int4_matmul`` computed before), and a second call
    bitwise equal to the first; raises otherwise."""
    xs = 0.001 + 0.01 * torch.rand(xq.shape[0], 1, generator=g,
                                   device='cuda')
    y = qmm.w4a8_matmul(xq, packed, scale)
    fused = qmm.w4a8_matmul(xq, packed, scale, row_scale=xs,
                            out_dtype=torch.bfloat16)
    if not torch.equal(fused, (y * xs).to(torch.bfloat16)):
        raise AssertionError(f'w4a8 {tuple(xq.shape)} x {tuple(packed.shape)}'
                             f': the fused epilogue differs from the '
                             f'two-step path')
    if not torch.equal(y, qmm.w4a8_matmul(xq, packed, scale)):
        raise AssertionError(f'w4a8 {tuple(xq.shape)}: two runs differ')


def planted_w4a8_faults(g):
    """Two faults a w4a8 kernel could make, planted in its inputs at (M 256,
    K 384, N 264, group 128): one group's scale skipped (group 1's scales
    zeroed) and the low and high nibbles of one packed tile swapped (packed
    rows 64-127, K 128-255). The kernel on each must break W4A8_TOL against
    the sound plain output. Returns the readings."""
    xq, q, packed, scale = w4a8_case(g, 256, 384, 264)
    ref = qmm.w4a8_matmul_ref(xq, packed, scale)
    mag = xq.abs().float() @ (q.abs().float()
                              * scale.repeat_interleave(128, dim=0))
    no_scale = scale.clone()
    no_scale[1] = 0
    swapped = packed.clone()
    tile = packed[64:128].to(torch.int16) & 0xFF
    swapped[64:128] = (((tile << 4) | (tile >> 4)) & 0xFF).to(
        torch.uint8).view(torch.int8)
    parts = []
    for name, args in (('group 1 scale skipped', (xq, packed, no_scale)),
                       ('nibbles swapped in packed rows 64-127',
                        (xq, swapped, scale))):
        worst = ((qmm.w4a8_matmul(*args) - ref).abs() / mag.clamp_min(
            1e-30)).max().item()
        if not worst > W4A8_TOL:
            raise AssertionError(f'w4a8 planted fault "{name}" passes: '
                                 f'{worst:.3e} <= {W4A8_TOL}')
        parts.append(f'{name}: |d| / sum|x||w|scale {worst:.3e}, refused')
    return parts


def phase_w4a8_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 3)
    cases = [(m, k, n, 128) for m, k, n in W4A8_SHAPES] + [
        (777, 3072, 3072, 128), (130, 512, 264, 32), (3, 320, 136, 64)] + [
        (m, 384, n, group) for m in W4A8_RAGGED_M for n in W4A8_RAGGED_N
        for group in qmm.GROUP_SIZES]
    worst, worst_rel = 0.0, 0.0
    for m, k, n, group in cases:
        xq, q, packed, scale = w4a8_case(g, m, k, n, group)
        err, rel = w4a8_check(xq, q, packed, scale)
        w4a8_epilogue_check(g, xq, packed, scale)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    # nibble -8 and activation -127 in whole rows and columns, scale 1: the
    # exact integer product
    xq, q, _, _ = w4a8_case(g, 70, 256, 24, 64)
    q[:, :5] = -8
    xq[:3] = -127
    packed, ones = pack_int4(q, 64), torch.ones(4, 24, device='cuda')
    w4a8_check(xq, q, packed, ones)
    if not torch.equal(qmm.w4a8_matmul(xq, packed, ones).double(),
                       xq.double() @ q.double()):
        raise AssertionError('w4a8: the -8 / -127 case is not exact')
    faults = planted_w4a8_faults(g)
    by_class = []
    for m, k, n in W4A8_SHAPES:
        xq, q, packed, scale = w4a8_case(g, m, k, n)
        # the int8 layers' (K, N) weight, column-major, with the same values
        w8 = q.t().contiguous().t()
        xs = 0.001 + 0.01 * torch.rand(m, 1, generator=g, device='cuda')

        def fused():     # the form the Qwen path launches (_int4_matmul)
            return qmm.w4a8_matmul(xq, packed, scale, row_scale=xs,
                                   out_dtype=torch.bfloat16)
        # int8 activations, packed int4 weights, fp32 scales and row scales
        # in; bf16 out
        bound_ms, bound_by = roofline(
            2 * m * k * n,
            m * k + k * n // 2 + scale.numel() * 4 + m * 4 + m * n * 2,
            H100_INT8)
        dev_ms = kernel_ms(fused, 'w4a8_matmul', 10)
        by_class.append(dict(
            shape=[m, k, n], form='row_scale, bf16 out', ms=dev_ms,
            call_ms=cuda_ms(fused, 20),
            tops=2 * m * k * n / (dev_ms * 1e-3) / 1e12, bound_ms=bound_ms,
            bound_by=bound_by,
            reference_ms=kernel_ms(lambda: i8.int8_matmul(xq, w8), None, 10)))
    timed = []
    for m, k, n in W4A8_TIMED:
        xq, _, packed, scale = w4a8_case(g, m, k, n)
        ms = cuda_ms(lambda: qmm.w4a8_matmul(xq, packed, scale), 20)
        plain_ms = cuda_ms(lambda: qmm.w4a8_matmul_ref(xq, packed, scale), 3)
        # int8 activations, packed int4 weights, fp32 scales in; fp32 out
        bound_ms, bound_by = roofline(
            2 * m * k * n, m * k + k * n // 2 + scale.numel() * 4 + m * n * 4,
            H100_INT8)
        timed.append(dict(shape=[m, k, n], ms=ms, plain_ms=plain_ms,
                          tops=2 * m * k * n / (ms * 1e-3) / 1e12,
                          bound_ms=bound_ms, bound_by=bound_by,
                          reference_ms=next(
                              c['reference_ms'] for c in by_class
                              if c['shape'] == [m, k, n])))
    log(f'phase 4 w4a8 kernel vs plain: ok | {len(cases) + 1} cases (path '
        f'shapes, M {W4A8_RAGGED_M} x N {W4A8_RAGGED_N} x groups '
        f'{qmm.GROUP_SIZES}, -8 nibbles) max|d| {worst:.3e}, max '
        f'|d| / sum|x||w|scale {worst_rel:.3e} (bound {W4A8_TOL}), fused '
        f'epilogue bitwise equal to the two-step path, two runs bitwise '
        f'equal | planted faults: {" ; ".join(faults)} | ptxas: '
        f'{ptxas_usage("w4a8_matmul_kernel")} | '
        + ' ; '.join(f'M{t["shape"][0]} K{t["shape"][1]} N{t["shape"][2]}: '
                     f'kernel {t["ms"]:.4f} ms ({t["tops"]:.1f} TOP/s), '
                     f'plain fp32 {t["plain_ms"]:.4f} ms, bound '
                     f'{t["bound_ms"]:.4f} ms ({t["bound_by"]}), '
                     f'torch._int_mm on the int8 weight '
                     f'{t["reference_ms"]:.4f} ms'
                     for t in timed)
        + ' | by shape class, as the Qwen path calls it (row scale, bf16 '
        'out; device ms by the profiler): ' + ' ; '.join(
            f'M{c["shape"][0]} K{c["shape"][1]} N{c["shape"][2]} '
            f'{c["ms"]:.4f} ms (call {c["call_ms"]:.4f}) {c["tops"]:.1f} '
            f'TOP/s, bound {c["bound_ms"]:.4f} ({c["bound_by"]}), '
            f'torch._int_mm {c["reference_ms"]:.4f}' for c in by_class))
    return worst, timed, by_class


def randomize_(module, generator):
    """normal(0, 0.02) on every weight matrix; biases and norm scales keep
    their init (zeros, ones, the head biases)."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, 0.02, generator=generator)


def flux_inputs(generator, txt=512):
    """Random FLUX prompt embeds: T5 (1, txt, 4096) and pooled CLIP 768."""
    return dict(
        encoder_hidden_states=torch.randn(1, txt, 4096, generator=generator,
                                          device='cuda', dtype=torch.bfloat16),
        pooled_projections=torch.randn(1, 768, generator=generator,
                                       device='cuda', dtype=torch.bfloat16))


def phase_reduced_slice():
    g = torch.Generator(device='cuda').manual_seed(SEED + 1)
    cfg = dict(FLUX_12B, num_layers=1, num_single_layers=1)
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **cfg)
    randomize_(model, g)
    x = torch.randn(1, 128, 128, 16, generator=g, device='cuda')
    kw = dict(flux_inputs(g), t=torch.full((1,), 0.7, device='cuda'),
              guidance=torch.full((1,), 3.5, device='cuda'))
    with torch.inference_mode():
        before = attn.LAUNCHES
        fast = model(x, **kw)['means'].float()
        torch.cuda.synchronize()
        n_fast = attn.LAUNCHES - before

        def plain(q, k, v, kv_valid=None, return_lse=False):
            return attn.attention_ref(q, k, v, kv_valid, return_lse)

        with mock.patch.object(attn, 'flash_attention_fwd', plain):
            slow = model(x, **kw)['means'].float()
        torch.cuda.synchronize()
    if n_fast != 2 or attn.LAUNCHES != before + 2:
        raise AssertionError(f'expected 2 kernel launches, got {n_fast}')
    if not (torch.isfinite(fast).all() and torch.isfinite(slow).all()):
        raise AssertionError('non-finite means')
    rel = ((fast - slow).norm() / slow.norm()).item()
    if rel > SLICE_REL_L2:
        raise AssertionError(f'means rel L2 {rel:.3e} > {SLICE_REL_L2}')
    log(f'phase 5 FLUX reduced slice (1+1 blocks, full width, bf16): ok | '
        f'means {tuple(fast.shape)} rel L2 kernel vs plain {rel:.3e} '
        f'(bound {SLICE_REL_L2}) | kernel launches {n_fast}')


def timed_call(pipe, embeds, latents, **kw):
    """One pipeline call and its host seconds, synchronised at both ends."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = pipe(prompt_embeds=embeds, latents=latents, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def timed_decode(vae, latents):
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        vae.decode(latents)
        torch.cuda.synchronize()
        return time.perf_counter() - t


def check_image(img):
    if tuple(img.shape) != (1, 1024, 1024, 3):
        raise AssertionError(f'image shape {tuple(img.shape)}')
    if not torch.isfinite(img).all():
        raise AssertionError('non-finite image')


def phase_full_slice():
    g = torch.Generator(device='cuda').manual_seed(SEED + 2)
    t0 = time.perf_counter()
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **FLUX_12B)
        vae = PretrainedVAE(dtype=torch.bfloat16)
    randomize_(model, g)
    n_params = sum(p.numel() for p in model.parameters())
    pipe = ArcFluxPipeline(model, vae=vae)
    embeds = flux_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device='cuda')
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    want = 2 * n_blocks

    attn.LAUNCHES = 0
    first, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
    if attn.LAUNCHES != want:
        raise AssertionError(f'cold run: {attn.LAUNCHES} launches, '
                             f'want {want}')
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0                       # the main path's counted run
    out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
    launches = attn.LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != want:
        raise AssertionError(f'{launches} kernel launches, want {want}')
    img = out['images']
    check_image(img)
    lat, t_dit = timed_call(pipe, embeds, latents, output_type='latent')
    lat = lat['latents']
    if not torch.isfinite(lat).all():
        raise AssertionError('non-finite latents')
    t_dec = timed_decode(pipe.vae, lat)
    rerun = (first['images'] - img).abs().max().item()
    log(f'phase 6 FLUX full slice (FLUX-12B ArcFlux {n_params / 1e9:.2f}B '
        f'params bf16, 2-NFE 1024x1024 + VAE decode): ok | image '
        f'{tuple(img.shape)} finite, range [{img.min().item():.3f}, '
        f'{img.max().item():.3f}], max|run1 - run2| {rerun:.3e} | kernel '
        f'launches {launches} | build {t_build:.1f} s, cold run '
        f'{t_cold:.3f} s | warm per image {t_e2e:.4f} s: transformer + '
        f'integration {t_dit:.4f} s, decode {t_dec:.4f} s | peak memory '
        f'{peak_gib:.2f} GiB')
    return launches, (pipe, embeds, latents, lat, t_e2e)


def qwen_inputs(generator):
    """Random Qwen2.5-VL prompt embeds (1, 512, 3584) and their text mask,
    the first 384 tokens valid."""
    mask = torch.arange(QWEN_TXT, device='cuda')[None] < QWEN_TXT_VALID
    return dict(
        encoder_hidden_states=torch.randn(1, QWEN_TXT, 3584,
                                          generator=generator, device='cuda',
                                          dtype=torch.bfloat16),
        encoder_hidden_states_mask=mask.to(torch.int32))


def qwen_w4a8(generator, vae=False, **overrides):
    """ArcQwen at the 20B geometry (``overrides`` cut it) with random bf16
    weights, in a pipeline, int4-quantized layer by layer for w4a8; checks
    the count of int4 layers against the skip rules."""
    cfg = dict(QWEN_20B, **overrides)
    with torch.device('cuda'):
        model = ArcQwenImageTransformer2DModel(dtype=torch.bfloat16, **cfg)
        decoder = PretrainedVAEQwenImage(dtype=torch.bfloat16) if vae \
            else None
    randomize_(model, generator)
    n_params = sum(p.numel() for p in model.parameters())
    pipe = ArcQwenImagePipeline(model, vae=decoder, shift=QWEN_SHIFT)
    n_int4 = pipe.quantize_int4(act_quant=True)
    want = INT4_PER_BLOCK * cfg['num_layers'] + INT4_OUTSIDE_BLOCKS
    found = sum(isinstance(m, LoRADense) and m.is_int4 and m.act_quant
                for m in model.modules())
    if n_int4 != want or found != want:
        raise AssertionError(f'{n_int4} int4 layers quantized, {found} w4a8 '
                             f'in the tree, want {want}')
    return pipe, n_params, n_int4


def phase_qwen_reduced():
    g = torch.Generator(device='cuda').manual_seed(SEED + 4)
    pipe, _, n_int4 = qwen_w4a8(g, num_layers=1)
    x = torch.randn(1, 128, 128, 16, generator=g, device='cuda')
    kw = dict(qwen_inputs(g), t=torch.full((1,), 0.7, device='cuda'))
    with torch.inference_mode():
        before, attn_before = qmm.LAUNCHES, attn.LAUNCHES
        fast = pipe.transformer(x, **kw)['means'].float()
        torch.cuda.synchronize()
        n_fast = qmm.LAUNCHES - before
        n_attn = attn.LAUNCHES - attn_before
        with mock.patch.object(qmm, 'w4a8_matmul', qmm.w4a8_matmul_ref):
            slow = pipe.transformer(x, **kw)['means'].float()
        torch.cuda.synchronize()
    if n_fast != n_int4 or qmm.LAUNCHES != before + n_int4 or n_attn != 1:
        raise AssertionError(f'{n_fast} w4a8 launches (want {n_int4}), '
                             f'{n_attn} attention launches (want 1)')
    if not (torch.isfinite(fast).all() and torch.isfinite(slow).all()):
        raise AssertionError('non-finite means')
    rel = ((fast - slow).norm() / slow.norm()).item()
    if rel > QWEN_SLICE_REL_L2:
        raise AssertionError(f'means rel L2 {rel:.3e} > {QWEN_SLICE_REL_L2}')
    log(f'phase 7 Qwen reduced slice (1 block, full width, w4a8): ok | means '
        f'{tuple(fast.shape)} rel L2 w4a8 kernel vs plain {rel:.3e} (bound '
        f'{QWEN_SLICE_REL_L2}) | w4a8 launches {n_fast}, masked attention '
        f'launches {n_attn}')


def profile_split(fn):
    """One call of ``fn`` under ``torch.profiler``: wall seconds, device
    busy seconds (the union of device activity intervals) and
    {kernel name: (ms, calls)}."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, calls + 1)
    if not spans:
        raise AssertionError('the profiler saw no device activity')
    busy, reach = 0.0, float('-inf')
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return wall, busy / 1e6, by_name


def split_families(by_name):
    """{kernel name: (ms, calls)} -> {family: (ms, calls, largest name)}."""
    families = {}
    for name, (ms, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        family = next((f for f, keys in KERNEL_FAMILIES
                       if any(key in name for key in keys)), 'other')
        f_ms, f_calls, f_top = families.get(family, (0.0, 0, name))
        families[family] = (f_ms + ms, f_calls + calls, f_top)
    return families


@contextlib.contextmanager
def w4a8_shape_tally():
    """Count the w4a8 wrapper's calls by (M, K, N) while the block runs: a
    pass-through around ``qmm.w4a8_matmul``, which the layers look up on the
    module at each call. Yields the Counter."""
    tally, real = collections.Counter(), qmm.w4a8_matmul

    def counted(xq, packed, *args, **kw):
        tally[(xq.shape[0], xq.shape[1], packed.shape[1])] += 1
        return real(xq, packed, *args, **kw)
    with mock.patch.object(qmm, 'w4a8_matmul', counted):
        yield tally


def phase_qwen_full(w4a8_classes):
    """The Qwen-Image 20B w4a8 image. Fills each of phase 4's shape classes
    with its launches in the counted run (``launches_per_image``) and those
    times its phase-4 device time (``ms_per_image``)."""
    g = torch.Generator(device='cuda').manual_seed(SEED + 5)
    t0 = time.perf_counter()
    pipe, n_params, n_int4 = qwen_w4a8(g, vae=True)
    gc.collect()
    torch.cuda.empty_cache()
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    embeds = qwen_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device='cuda')
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    want = dict(attention=2 * QWEN_20B['num_layers'], w4a8=2 * n_int4)

    def counts():
        return dict(attention=attn.LAUNCHES, w4a8=qmm.LAUNCHES)

    attn.LAUNCHES = qmm.LAUNCHES = 0
    first, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
    if counts() != want:
        raise AssertionError(f'cold run: launches {counts()}, want {want}')
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = qmm.LAUNCHES = 0        # the main path's counted run
    with w4a8_shape_tally() as by_shape:
        out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != want:
        raise AssertionError(f'launches {launches}, want {want}')
    if (sum(by_shape.values()) != launches['w4a8']
            or set(by_shape) != set(W4A8_SHAPES)):
        raise AssertionError(f'w4a8 calls by shape {dict(by_shape)} (phase 4 '
                             f'timed {W4A8_SHAPES}), launches {launches}')
    for c in w4a8_classes:
        c['launches_per_image'] = by_shape[tuple(c['shape'])]
        c['ms_per_image'] = c['launches_per_image'] * c['ms']
    img = out['images']
    check_image(img)
    rerun = (first['images'] - img).abs().max().item()
    if rerun != 0.0:
        raise AssertionError(f'two runs differ by {rerun:.3e}')
    lat, t_dit = timed_call(pipe, embeds, latents, output_type='latent')
    lat = lat['latents']
    if not torch.isfinite(lat).all():
        raise AssertionError('non-finite latents')
    t_dec = timed_decode(pipe.vae, lat)
    wall, busy, by_name = profile_split(
        lambda: pipe(prompt_embeds=embeds, latents=latents, output_type='pt'))
    total = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    families = split_families(by_name)
    log(f'phase 8 Qwen full slice (ArcQwen {n_params / 1e9:.2f}B params, '
        f'{n_int4} int4 layers w4a8, 2-NFE 1024x1024 + Wan decode): ok | '
        f'image {tuple(img.shape)} finite, range [{img.min().item():.3f}, '
        f'{img.max().item():.3f}], max|run1 - run2| {rerun:.3e} | launches '
        f'{launches} | build + quantize {t_build:.1f} s, resident after '
        f'quantize {resident_gib:.2f} GiB, cold run {t_cold:.3f} s | warm per '
        f'image {t_e2e:.4f} s: transformer + integration {t_dit:.4f} s, '
        f'decode {t_dec:.4f} s | peak memory {peak_gib:.2f} GiB | w4a8 '
        f'launches by shape in the counted run x phase 4 device ms: '
        + ' ; '.join(f'M{c["shape"][0]} K{c["shape"][1]} N{c["shape"][2]} '
                     f'x{c["launches_per_image"]} = {c["ms_per_image"]:.2f} '
                     f'ms' for c in w4a8_classes)
        + f' | sum {sum(c["ms_per_image"] for c in w4a8_classes):.2f} ms')
    log(f'phase 8 profile (one warm image): wall {wall:.4f} s, device busy '
        f'{busy:.4f} s, idle share {1 - busy / wall:.4f}, {len(by_name)} '
        f'kernel names | by family: ' + ' ; '.join(
            f'{f} {ms:.2f} ms {100 * ms / total:.1f}% x{calls} (largest: '
            f'{top_name[:60]})'
            for f, (ms, calls, top_name) in sorted(families.items(),
                                                   key=lambda kv: -kv[1][0]))
        + ' | by name: ' + ' ; '.join(
            f'{ms:.2f} ms {100 * ms / total:.1f}% x{calls} {name[:90]}'
            for name, (ms, calls) in top))
    return launches


def rel_l2(a, b):
    b = b.float()
    return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()


def planted_k3_fault(q, k, v, o, do, lse, dq_ref):
    """Planted fault: the dQ partial of key tile 1 (keys 128-255) dropped,
    by running the kernels with those keys masked against the sound
    forward's O and LSE. The resulting dq must break phase 9's limit
    against the plain ``dq_ref``. Returns the reading."""
    s = q.shape[1]
    keep = (torch.arange(s, device=q.device) // 128 != 1)[None].expand(
        q.shape[0], s)
    dq = attn.flash_attention_bwd(q, k, v, o, do, lse, keep)[0]
    rel = rel_l2(dq, dq_ref)
    if rel <= BWD_REL_L2:
        raise AssertionError(f'K3 planted fault (a dQ partial dropped) passes '
                             f'the limit: rel L2 {rel:.3e}')
    return (f'planted fault, the dQ partial of key tile 1 dropped: dq rel L2 '
            f'{rel:.3e}, refused')


def phase_bwd_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 6)
    cases = [('flux', FLUX_SHAPE, None), ('s777', (2, 777, 3, 128), None),
             ('s1000', (2, 1000, 4, 128), None),
             ('key_padded', (2, 1000, 4, 128), (900, 1000)),
             ('no_valid_key', (2, 300, 3, 128), (0, 250))]
    worst_abs, worst_rel, parts = 0.0, 0.0, []
    for name, shape, lengths in cases:
        q, k, v, do = (torch.randn(shape, generator=g, device='cuda',
                                   dtype=torch.bfloat16) for _ in range(4))
        kv_valid = None
        if lengths is not None:
            kv_valid = torch.arange(shape[1], device='cuda')[None, :] < \
                torch.tensor(lengths, device='cuda')[:, None]
        o, lse = attn.flash_attention_fwd(q, k, v, kv_valid, return_lse=True)
        got = attn.flash_attention_bwd(q, k, v, o, do, lse, kv_valid)
        torch.cuda.synchronize()
        want = attn.attention_bwd_ref(q, k, v, o, do, lse, kv_valid)
        rels = [rel_l2(x, y) for x, y in zip(got, want)]
        if not all(torch.isfinite(x).all() for x in got):
            raise AssertionError(f'{name}: non-finite gradients')
        if max(rels) > BWD_REL_L2:
            raise AssertionError(f'{name}: rel L2 dq/dk/dv {rels} > '
                                 f'{BWD_REL_L2}')
        if lengths is not None and lengths[0] == 0 and any(
                x[0].any() for x in got):
            raise AssertionError(f'{name}: a row with no valid key got a '
                                 f'gradient')
        worst_abs = max(worst_abs, max((x.float() - y.float()).abs().max()
                                       .item() for x, y in zip(got, want)))
        worst_rel = max(worst_rel, max(rels))
        parts.append(f'{name} {tuple(shape)} rel L2 dq/dk/dv '
                     + '/'.join(f'{r:.2e}' for r in rels))
        if name == 'flux':
            flux = (q, k, v, o, do, lse)
        if name == 's1000':
            fault = planted_k3_fault(q, k, v, o, do, lse, want[0])
        del q, k, v, do, o, lse, got, want
    q, k, v, o, do, lse = flux
    ms = cuda_ms(lambda: attn.flash_attention_bwd(q, k, v, o, do, lse), 10)
    plain_ms = cuda_ms(lambda: attn.attention_bwd_ref(q, k, v, o, do, lse), 3)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 10)
    bound_ms, bound_by = attention_bound(FLUX_SHAPE, backward=True)
    b, s, h, d = FLUX_SHAPE
    tflops = 10 * b * h * s * s * d / (ms * 1e-3) / 1e12
    log(f'phase 9 attention backward kernels vs plain: ok | '
        f'{" ; ".join(parts)} (bound {BWD_REL_L2}), max|d| {worst_abs:.3e} | '
        f'FLUX shape: kernels {ms:.4f} ms ({tflops:.1f} TFLOP/s of the 5 '
        f'needed products), plain fp32 {plain_ms:.4f} ms, SDPA backward '
        f'{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, '
        f'{100 * bound_ms / ms:.1f}% of it) | ptxas: '
        f'{ptxas_usage("attention_bwd_kernel")} | {fault}')
    return dict(max_abs_err=worst_abs, max_rel_l2=worst_rel, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def flux_train_model(generator, **net):
    """The FLUX-12B distillation composition (``net`` cuts it) on the card,
    frozen trunk in bf16, with random weights: normal(0.02) on every weight
    matrix of the student (trunk and adapter) and of the teacher's head."""
    net = dict(FLUX_TRAIN_NET, **net)
    model = LatentDiffusionTextImage(
        diffusion=dict(
            type='ArcFlowImitationDataFree', policy_type='ArcFlow',
            denoising=dict(type='ArcFluxTransformer2DModel', patch_size=2,
                           num_gaussians=16, lora_rank=256, lora_dropout=0.05,
                           **net),
            flow_loss=dict(type='DiffusionMSELoss',
                           data_info=dict(pred='u_t_pred', target='u_t'),
                           rescale_mode='constant',
                           rescale_cfg=dict(scale=30.0)),
            num_timesteps=1,
            timestep_sampler=dict(type='ContinuousTimeStepSampler',
                                  shift=3.2),
            denoising_mean_mode='U'),
        teacher=dict(type='GaussianFlow',
                     denoising=dict(type='FluxTransformer2DModel',
                                    patch_size=2, **net),
                     num_timesteps=1, denoising_mean_mode='U'),
        tie_teacher=True, diffusion_use_ema=True,
        latent_shape=FLUX_TRAIN_LATENT,
        text_embed_dim=net['joint_attention_dim'],
        pooled_dim=net['pooled_projection_dim'], frozen_dtype='bfloat16',
        train_cfg=FLUX_TRAIN_CFG,
        test_cfg=dict(distilled_guidance_scale=3.5, nfe=2, timestep_ratio=1.0,
                      total_substeps=128),
        device='cuda', dtype=torch.bfloat16)
    randomize_(model.diffusion.denoising, generator)
    teacher = model.teacher.denoising
    randomize_(torch.nn.ModuleList([teacher.norm_out, teacher.proj_out]),
               generator)
    return model


def flux_train_batch(generator):
    """One batch of 1: random latents (only their shape and device are
    used: the data-free loss starts from noise) and prompt embeds."""
    return dict(latents=torch.randn(1, *FLUX_TRAIN_LATENT,
                                    generator=generator, device='cuda'),
                prompt_embed_kwargs=flux_inputs(generator))


def phase_train_reduced():
    g = torch.Generator(device='cuda').manual_seed(SEED + 7)
    model = flux_train_model(g, num_layers=1, num_single_layers=1)
    batch = flux_train_batch(g)
    adapter = model.init_params()[0]['diffusion']

    def run():
        for p in adapter.values():
            p.grad = None
        draws = torch.Generator(device='cuda').manual_seed(SEED + 8)
        loss, _ = model.loss(batch, draws, running_status=dict(iteration=0))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.float().clone()
                             for n, p in adapter.items()}

    def plain_fwd(q, k, v, kv_valid=None, return_lse=False):
        return attn.attention_ref(q, k, v, kv_valid, return_lse)

    def plain_bwd_zeroed(*which):
        def bwd(*args):
            return tuple(torch.zeros_like(t) if i in which else t for i, t
                         in enumerate(attn.attention_bwd_ref(*args)))
        return bwd

    kernel_fwd = attn.flash_attention_fwd

    def run_with(fwd, bwd):
        with mock.patch.object(attn, 'flash_attention_fwd', fwd), \
                mock.patch.object(attn, 'flash_attention_bwd', bwd):
            return run()

    before = (attn.LAUNCHES, attn.BWD_LAUNCHES)
    loss_k, grads_k = run()
    counts = (attn.LAUNCHES - before[0], attn.BWD_LAUNCHES - before[1])
    want = (TRAIN_FORWARDS * 2, TRAIN_BACKWARDS * 2)
    if counts != want:
        raise AssertionError(f'launches (forward, backward) {counts}, '
                             f'want {want}')
    loss_p, grads_p = run_with(plain_fwd, attn.attention_bwd_ref)
    # the backward alone, under the kernels' forward
    grads_pb = run_with(kernel_fwd, attn.attention_bwd_ref)[1]
    grads_0 = run_with(kernel_fwd, plain_bwd_zeroed(0, 1, 2))[1]
    grads_fault = run_with(kernel_fwd, plain_bwd_zeroed(0))[1]
    if not all(torch.isfinite(t).all() for t in grads_k.values()):
        raise AssertionError('non-finite adapter gradients')
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    flat_k = torch.cat([t.flatten() for t in grads_k.values()])
    flat_p = torch.cat([t.flatten() for t in grads_p.values()])
    rel_grad = rel_l2(flat_k, flat_p)
    per = {n: rel_l2(grads_k[n], grads_p[n]) for n in grads_k}
    worst = max(per, key=per.get)
    upstream = [n for n in per if n.startswith(UPSTREAM_OF_ATTENTION)]
    if not upstream:
        raise AssertionError('no adapter tensor upstream of an attention')
    share = {n: (grads_pb[n] - grads_0[n]).norm().item() for n in upstream}

    def over_share(grads):
        return {n: (grads[n] - grads_pb[n]).norm().item() / share[n]
                for n in upstream}

    err, fault = over_share(grads_k), over_share(grads_fault)
    worst_up, least_fault = max(err, key=err.get), min(fault, key=fault.get)
    if max(rel_loss, rel_grad) > TRAIN_SLICE_REL_L2 or flat_p.norm() == 0:
        raise AssertionError(f'loss rel {rel_loss:.3e}, adapter gradients '
                             f'rel L2 {rel_grad:.3e} > {TRAIN_SLICE_REL_L2}')
    if not min(share.values()) > 0 or err[worst_up] > BWD_REL_L2:
        raise AssertionError(f'backward error over its share {err} > '
                             f'{BWD_REL_L2}, shares {share}')
    if max(fault.values()) <= BWD_REL_L2:
        raise AssertionError(f'dq zeroed kept every tensor upstream of an '
                             f'attention within {BWD_REL_L2}: {fault}')
    log(f'phase 10 FLUX training reduced slice (1+1 blocks, full width, '
        f'bf16 trunk, LoRA 256): ok | loss {loss_k:.6e} vs plain '
        f'{loss_p:.6e}, rel {rel_loss:.3e} | adapter gradients '
        f'({len(per)} tensors) rel L2 {rel_grad:.3e} (bound '
        f'{TRAIN_SLICE_REL_L2}), worst tensor {worst} {per[worst]:.3e} | '
        f'backward alone, {len(upstream)} tensors upstream of an attention, '
        f'error over the attention backward\'s share: worst {worst_up} '
        f'{err[worst_up]:.3e} (bound {BWD_REL_L2}), that share '
        f'{share[worst_up] / grads_pb[worst_up].norm().item():.3e} of its '
        f'gradient | planted fault, dq zeroed: {fault[least_fault]:.3e} '
        f'({least_fault}) to {max(fault.values()):.3e} | launches forward '
        f'{counts[0]}, backward {counts[1]}')


def phase_train_full():
    g = torch.Generator(device='cuda').manual_seed(SEED + 9)
    t0 = time.perf_counter()
    model = flux_train_model(g)
    trainable, frozen = model.init_params()
    optimizers = build_optimizers(FLUX_TRAIN_OPT, trainable)
    state = TrainState.create(
        torch.Generator(device='cuda').manual_seed(SEED + 10), trainable,
        frozen, optimizers, ema_keys=model.ema_keys)
    step = build_train_step(model, optimizers, model.train_cfg,
                            EmaConfig.from_hook_cfg(FLUX_TRAIN_EMA_HOOK))
    batch = flux_train_batch(g)
    adapter = trainable['diffusion']
    start = {n: p.detach().clone() for n, p in adapter.items()}
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    frozen_host = {n: t.detach().cpu() for n, t in flatten(frozen).items()}
    n_blocks = FLUX_TRAIN_NET['num_layers'] + FLUX_TRAIN_NET[
        'num_single_layers']
    want = (TRAIN_FORWARDS * n_blocks, TRAIN_BACKWARDS * n_blocks)

    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(3):
        attn.LAUNCHES = attn.BWD_LAUNCHES = 0   # the main path's counted run
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, logs = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = (attn.LAUNCHES, attn.BWD_LAUNCHES)
        if launches != want:
            raise AssertionError(f'step {state.step}: launches (forward, '
                                 f'backward) {launches}, want {want}')
        loss, gnorm = float(logs['loss']), logs['diffusion_grad_norm']
        if not (torch.isfinite(torch.tensor([loss, gnorm])).all()
                and logs['diffusion_skipped'] == 0.0):
            raise AssertionError(f'step {state.step}: loss {loss}, grad '
                                 f'norm {gnorm}, skipped '
                                 f'{logs["diffusion_skipped"]}')
        if not all(torch.equal(state.ema['diffusion'][n], p)
                   for n, p in adapter.items()):
            raise AssertionError(f'step {state.step}: the EMA is not the '
                                 f'adapter before start_iter')
        steps.append(dict(s=dt, loss=loss, grad_norm=gnorm,
                          step0=float(logs['loss_diffusion_step0']),
                          step1=float(logs['loss_diffusion_step1'])))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(p, start[n]) for n, p in adapter.items())
    if moved == 0:
        raise AssertionError('the adapter did not move')
    changed = [n for n, t in flatten(frozen).items()
               if not torch.equal(t.cpu(), frozen_host[n])]
    if changed:
        raise AssertionError(f'frozen tensors changed: {changed[:5]}')
    del frozen_host
    wall, busy, by_name = profile_split(lambda: step(state, batch))
    families = split_families(by_name)
    total = sum(ms for ms, _, _ in families.values())
    warm = sum(st['s'] for st in steps[1:]) / len(steps[1:])
    log(f'phase 11 FLUX training full slice (FLUX-12B ArcFlow distillation, '
        f'{count_params(frozen) / 1e9:.2f}B frozen bf16 + '
        f'{count_params(trainable)} fp32 adapter parameters, batch 1, '
        f'1024x1024, nfe 2, 4 intermediate states, checkpointing): ok | '
        + ' ; '.join(f'step {i + 1}: {st["s"]:.3f} s, loss {st["loss"]:.5e} '
                     f'(NFE steps {st["step0"]:.4e} + {st["step1"]:.4e}), '
                     f'grad norm {st["grad_norm"]:.4e}'
                     for i, st in enumerate(steps))
        + f' | warm {warm:.4f} s per step | launches per step forward '
        f'{launches[0]}, backward {launches[1]} | {moved} of '
        f'{len(adapter)} adapter tensors moved, frozen trunk bit-identical, '
        f'EMA = adapter | build '
        f'{t_build:.1f} s | peak memory {peak_gib:.2f} GiB, resident '
        f'{resident_gib:.2f} GiB')
    log(f'phase 11 profile (one warm step): wall {wall:.4f} s, device busy '
        f'{busy:.4f} s, idle share {1 - busy / wall:.4f}, {len(by_name)} '
        f'kernel names | by family: ' + ' ; '.join(
            f'{f} {ms:.2f} ms {100 * ms / total:.1f}% x{calls} (largest: '
            f'{top_name[:60]})'
            for f, (ms, calls, top_name) in sorted(families.items(),
                                                   key=lambda kv: -kv[1][0])))
    return dict(forward=launches[0], backward=launches[1])


def k7_bound(b, s, h, valid_keys=None):
    """Roofline of K7 at (B, S, H, 128) over ``valid_keys`` keys (all by
    default): QK^T, 2 S Sk D H operations at the int8 peak, plus P.V as
    many at the bf16 peak, against reading the int8 q, the valid keys' int8
    k rows, the fp32 row scales and bf16 v rows, and writing bf16 o."""
    d = 128
    kv = s if valid_keys is None else valid_keys
    half = 2 * b * h * s * kv * d
    ms_ops = (half / H100_INT8 + half / H100_BF16) * 1e3
    nbytes = (b * h * (s + kv) * (d + 4) + b * kv * h * d * 2
              + b * s * h * d * 2 + (0 if valid_keys is None else b * s))
    ms_bytes = nbytes / H100_BYTES * 1e3
    return (ms_ops, 'operations') if ms_ops >= ms_bytes else \
        (ms_bytes, 'bytes')


def k4_bound(b, sq, skv, h, valid_keys=None, first=False, last=False):
    """Roofline of one ring hop as the port's kernel does it: QK^T and PV,
    4 Sq Skv D H FLOP over the valid keys, reading q and the valid keys'
    rows of k and v (bf16) and the key mask, reading the fp32 carry (acc,
    m, l) unless ``first``, writing it, and writing O (bf16) when
    ``last``."""
    d = 128
    kv = skv if valid_keys is None else valid_keys
    carry = b * sq * h * d * 4 + 2 * b * h * sq * 4
    nbytes = (b * sq * h * d * 2 + 2 * b * kv * h * d * 2 + carry
              + (0 if first else carry) + (b * sq * h * d * 2 if last else 0)
              + (0 if valid_keys is None else b * skv))
    return roofline(4 * b * h * sq * kv * d, nbytes, H100_BF16)


def k6_bound(g, n, m, n_steps):
    """Roofline of one inverse-CDF launch, counted as the TPU kernel's cost
    estimate counts it (inverse_cdf.py:134-137: 12 fp32 operations and 2
    transcendentals per step, target and component), plus the output
    written: the largest of fp32 operations over the fp32 peak,
    transcendentals over the special-function rate and bytes over the
    memory rate. Returns (ms, 'operations' or 'bytes', which)."""
    times = {'fp32 operations': n_steps * n * g * m * 12 / H100_FP32,
             'special functions': n_steps * n * g * m * 2 / H100_SFU,
             'bytes': ((3 * g + 2 * n + 1) * m + n * m) * 4 / H100_BYTES}
    which = max(times, key=times.get)
    return (times[which] * 1e3, 'bytes' if which == 'bytes'
            else 'operations', which)


def k6_case(g, hw, k=KR_K, n=1, saturate=False):
    """A random 1-D mixture in the KR transport's per-axis layout: means
    and log-weights (1, 1, k, H, W), logstd (1, 1, 1, 1, 1), targets
    erf(z / sqrt 2) (1, 1, n, H, W) and the isotropic-proxy initial samples
    of ``gm1d_inverse_cdf``; with ``saturate`` some targets at and next to
    +-1."""
    kw = dict(generator=g, device='cuda')
    means = torch.randn(1, 1, k, *hw, **kw)
    lw = torch.log_softmax(torch.randn(1, 1, k, *hw, **kw), dim=2)
    logstds = torch.full((1, 1, 1, 1, 1), KR_LOGSTD, device='cuda')
    z = torch.randn(1, 1, n, *hw, **kw)
    tgt = torch.erf(z / math.sqrt(2))
    if saturate:
        tgt[0, 0, 0, 0, :8] = 1.0
        tgt[0, 0, 1, 0, :8] = -1.0
        tgt[0, 0, 2, 0, :8] = 1 - 1e-7
    wt = lw.exp()
    mean = (wt * means).sum(2, keepdim=True)
    var = (wt * (means - mean).square()).sum(2, keepdim=True) \
        + math.exp(2 * KR_LOGSTD)
    return means, lw, wt, logstds, tgt, z * var.sqrt() + mean


def k6_check(name, args):
    """Kernel vs plain at one problem: raises past the root tolerance, on a
    non-finite output or on two runs that differ; returns the max abs error
    over unsaturated elements."""
    out = icdf.gm1d_inverse_cdf_kernel(*args, n_steps=KR_STEPS)
    again = icdf.gm1d_inverse_cdf_kernel(*args, n_steps=KR_STEPS)
    torch.cuda.synchronize()
    ref = icdf.gm1d_inverse_cdf_ref(*args, n_steps=KR_STEPS)
    if not torch.isfinite(out).all():
        raise AssertionError(f'K6 {name}: non-finite output')
    if not torch.equal(out, again):
        raise AssertionError(f'K6 {name}: two runs differ')
    means, lw, _, logstds, tgt, _ = args
    pdf, _ = gm_ops.gm1d_pdf_cdf(dict(means=means, logstds=logstds,
                                      logweights=lw), ref)
    uns = tgt.abs() < 0.999
    err = (out - ref).abs()
    bad = (err > K6_ATOL + K6_CDF_TOL / (2 * pdf)) & uns
    if bad.any():
        raise AssertionError(f'K6 {name}: {int(bad.sum())} unsaturated '
                             f'elements past the root tolerance, max err '
                             f'{err[uns].max().item():.3e}')
    return err[uns].max().item()


def phase_k6_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 11)
    cases = [('kr_axis', dict(hw=KR_LATENT[:2])),
             ('large', dict(hw=K6_LARGE_HW)),
             ('ragged', dict(hw=(37, 53))),
             ('n5_g1', dict(hw=(40, 40), k=1, n=5)),
             ('saturated', dict(hw=(64, 64), n=3, saturate=True))]
    worst, parts, timed = 0.0, [], {}
    for name, kw in cases:
        args = k6_case(g, **kw)
        err = k6_check(name, args)
        worst = max(worst, err)
        geom = icdf.kernel_geometry(*args)
        k, n = args[0].shape[2], args[4].shape[2]
        m = math.prod(args[0].shape[-2:])
        lanes = icdf.lanes_for(k, geom['elements'])
        parts.append(f'{name} G{k} N{n} M{m} L{lanes} max|d| {err:.3e}')
        if name in ('kr_axis', 'large'):
            ms = kernel_ms(lambda: icdf.launch(geom, KR_STEPS, 1e-6, 1.5),
                           'gm_inverse_cdf', 50)
            wrapper_ms = cuda_ms(lambda: icdf.gm1d_inverse_cdf_kernel(
                *args, n_steps=KR_STEPS), 20)
            rows, _ = icdf.kernel_layout(*args)
            plain_ms = cuda_ms(lambda: icdf.nr_steps_ref(
                *rows, KR_STEPS, 1e-6, 1.5), 5)
            bound_ms, bound_by, which = k6_bound(KR_K, 1, m, KR_STEPS)
            per_lane = -(-k // lanes)
            timed[name] = dict(shape=dict(G=KR_K, N=1, M=m,
                                          n_steps=KR_STEPS),
                               lanes=lanes, ms=ms, wrapper_ms=wrapper_ms,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, bound_detail=which,
                               ptxas=ptxas_usage(
                                   f'gm_inverse_cdf_kernelILi{lanes}ELi'
                                   f'{1 << (per_lane - 1).bit_length()}E'))
            if name == 'kr_axis':           # every lane count the launcher
                timed[name]['ms_by_lanes'] = {     # can choose
                    str(n_lanes): kernel_ms(lambda: icdf.launch(
                        geom, KR_STEPS, 1e-6, 1.5, lanes=n_lanes),
                        'gm_inverse_cdf', 50)
                    for n_lanes in (1, 2, 4, 8, 16)}
    log(f'phase 12 inverse-CDF kernel vs plain: ok | {" ; ".join(parts)} '
        f'(bound {K6_ATOL} + {K6_CDF_TOL} / 2 pdf, unsaturated), finite, '
        f'deterministic | ' + ' ; '.join(
            f'{name} M{t["shape"]["M"]} L{t["lanes"]}: kernel {t["ms"]:.4f} '
            f'ms device time (the call with its wrapper {t["wrapper_ms"]:.4f}'
            f' ms), plain fp32 {t["plain_ms"]:.4f} ms, bound '
            f'{t["bound_ms"]:.4f} ms ({t["bound_detail"]}, '
            f'{100 * t["bound_ms"] / t["ms"]:.1f}% of it), ptxas '
            f'{t["ptxas"]}' for name, t in timed.items())
        + ' | kr_axis device ms by lanes: ' + ', '.join(
            f'L{n_lanes} {ms:.4f}' for n_lanes, ms in
            timed['kr_axis']['ms_by_lanes'].items()))
    return worst, timed


def kr_mixture(g):
    """A random mixture of the ArcFlux head geometry: means (1, K, 128,
    128, 16), log-weights (1, K, 128, 128, 1), one scalar logstd; and one
    standard normal draw z (1, 1, 128, 128, 16)."""
    kw = dict(generator=g, device='cuda')
    h, w, c = KR_LATENT
    gm = dict(means=torch.randn(1, KR_K, h, w, c, **kw),
              logstds=torch.full((1, 1, 1, 1, 1), KR_LOGSTD, device='cuda'),
              logweights=torch.log_softmax(
                  torch.randn(1, KR_K, h, w, 1, **kw), dim=1))
    return gm, torch.randn(1, 1, h, w, c, **kw)


def timed_kr(gm, z):
    torch.cuda.synchronize()
    t = time.perf_counter()
    x = gm_ops.gaussian_samples_to_gm_samples(gm, z, n_steps=KR_STEPS,
                                              backward_steps=0)
    torch.cuda.synchronize()
    return x, time.perf_counter() - t


def phase_kr():
    g = torch.Generator(device='cuda').manual_seed(SEED + 12)
    gm, z = kr_mixture(g)
    c = KR_LATENT[-1]
    _, t_cold = timed_kr(gm, z)
    icdf.LAUNCHES = 0                       # the main path's counted run
    x, t_warm = timed_kr(gm, z)
    launches = icdf.LAUNCHES
    if launches != c:
        raise AssertionError(f'{launches} inverse-CDF launches, want {c}')
    with mock.patch.object(icdf, 'gm1d_inverse_cdf_kernel',
                           icdf.gm1d_inverse_cdf_ref):
        x_plain, t_plain = timed_kr(gm, z)
    if not torch.isfinite(x).all():
        raise AssertionError('non-finite KR samples')
    uns = (torch.erf(z / math.sqrt(2)).abs() < 0.999).all(-1, keepdim=True)
    rel = rel_l2(x * uns, x_plain * uns)
    if rel > KR_REL_L2:
        raise AssertionError(f'KR kernel vs plain rel L2 {rel:.3e} > '
                             f'{KR_REL_L2}')
    z_rec = gm_ops.gm_samples_to_gaussian_samples(gm, x)
    rt = ((z_rec - z).abs() * uns).max().item()
    if not rt <= KR_ROUND_TRIP:
        raise AssertionError(f'round trip max |z_rec - z| {rt:.3e} > '
                             f'{KR_ROUND_TRIP}')
    log(f'phase 13 KR transport (K={KR_K} over a {KR_LATENT} latent, 1 '
        f'draw, {KR_STEPS} NR steps): ok | samples {tuple(x.shape)} finite | '
        f'kernel launches {launches} | rel L2 vs the plain path '
        f'{rel:.3e} (bound {KR_REL_L2}) over the {uns.float().mean().item():.4f} '
        f'of pixels with every axis unsaturated | round trip max |z_rec - '
        f'z| {rt:.3e} (bound {KR_ROUND_TRIP}) | seconds per call: cold '
        f'{t_cold:.4f}, warm {t_warm:.4f}, plain path {t_plain:.4f}')
    return dict(launches=launches, s=t_warm, plain_s=t_plain, rel_l2=rel,
                round_trip=rt)


def phase_gmflow():
    torch.manual_seed(SEED + 13)
    model = Diffusion2D(train_cfg=CKB_TRAIN_CFG, test_cfg=CKB_TEST_CFG,
                        device='cuda', **CKB_MODEL)
    trainable, frozen = model.init_params()
    optimizers = build_optimizers(CKB_OPT, trainable)
    state = TrainState.create(
        torch.Generator(device='cuda').manual_seed(SEED + 14), trainable,
        frozen, optimizers, ema_keys=model.ema_keys)
    step = build_train_step(model, optimizers, model.train_cfg,
                            EmaConfig.from_hook_cfg(CKB_EMA_HOOK))
    data = CheckerboardData(n_rc=4, scale=1.0)
    rng = np.random.default_rng(SEED)
    losses = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(CKB_STEPS):
        x = torch.from_numpy(data.batch(rng, CKB_BATCH)['x']).to('cuda')
        state, logs = step(state, dict(x=x))
        losses.append(logs['loss'])
    losses = torch.stack(losses).cpu()
    t_step = (time.perf_counter() - t) / CKB_STEPS
    if not torch.isfinite(losses).all():
        raise AssertionError('non-finite GMFlow losses')
    first, last = losses[:100].mean().item(), losses[-100:].mean().item()
    if not last < first:
        raise AssertionError(f'GMFlow loss did not fall: first 100 {first}, '
                             f'last 100 {last}')
    noise = torch.randn(CKB_SAMPLES, *CKB_MODEL['data_shape'],
                        generator=torch.Generator(device='cuda').manual_seed(
                            SEED + 15), device='cuda')
    ema = state.ema['diffusion']
    torch.cuda.synchronize()
    t = time.perf_counter()
    samples = model.val_step(dict(noise=noise), None, ema=ema)
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t
    again = model.val_step(dict(noise=noise), None, ema=ema)
    if not torch.isfinite(samples).all():
        raise AssertionError('non-finite GMFlow samples')
    if not torch.equal(samples, again):
        raise AssertionError('GMFlow samples differ on a repeat')
    support = data.log_prob_support(samples.reshape(-1, 2).cpu().numpy())
    log(f'phase 14 GMFlow checkerboard (ToyGMFlowDenoiser K=8, hidden '
        f'256 x 3, GMFlowNLLLoss, AdamW 1e-3, Karras EMA from 100, batch '
        f'{CKB_BATCH}): ok | {CKB_STEPS} steps, loss mean of the first 100 '
        f'{first:.4f}, last 100 {last:.4f} | {t_step * 1e3:.3f} ms per step '
        f'| val_step (EMA, FlowEulerODE 16 steps, order 2, 2 substeps, '
        f'mean): {CKB_SAMPLES} samples finite, equal on a repeat, '
        f'{t_sample:.4f} s per call, in-support share {support.mean():.4f} '
        f'(not gated)')
    return dict(s_per_step=t_step, s_per_sample_call=t_sample,
                support=float(support.mean()))


def hop_case(g, b, s, h, lengths=None):
    """A random bf16 K/V block (B, s, H, 128) and its key validity (None, or
    the first ``lengths[i]`` keys of row i valid)."""
    k, v = (torch.randn(b, s, h, 128, generator=g, device='cuda',
                        dtype=torch.bfloat16) for _ in range(2))
    valid = None
    if lengths is not None:
        valid = torch.arange(s, device='cuda')[None, :] < torch.tensor(
            lengths, device='cuda')[:, None]
    return k, v, valid


def hop_chain(fn, q, blocks):
    """The hops of ``blocks`` from the first to the last through ``fn``
    (``ring_hop`` or ``ring_hop_ref``): the final carry and O."""
    carry = None
    for i, (k, v, valid) in enumerate(blocks):
        carry, out = fn(q, k, v, valid, carry, last=i == len(blocks) - 1)
    return carry, out


def k4_readings(got, want):
    """max |d| of ``got`` against the fp32 plain version ``want``, how far
    the worst element lies past K4_ATOL + K4_RTOL |want| (> 0: refused), and
    the relative L2."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    over = (d - K4_ATOL - K4_RTOL * want.abs()).max().item()
    return d.max().item(), over, rel_l2(got, want)


def k4_close(name, got, want):
    """Raises unless ``got`` is within both K4 limits of ``want``; returns
    (max |d|, relative L2)."""
    err, over, rel = k4_readings(got, want)
    if over > 0 or not rel <= K4_REL_L2:
        raise AssertionError(f'{name}: max|d| {err:.3e} ({over:+.2e} past '
                             f'{K4_ATOL} + {K4_RTOL:.4g} |ref|), rel L2 '
                             f'{rel:.3e} (bound {K4_REL_L2})')
    return err, rel


def normalized(carry):
    """acc / l of a carry, 0 on the rows that have seen no valid key."""
    acc, _, l = carry
    l_t = l.transpose(1, 2)[..., None]
    return torch.where(l_t > 0, acc / l_t, 0.0)


def carry_errors(name, carry, ref):
    """Kernel carry vs plain carry: raises unless the rows that have seen
    no valid key agree exactly (l = 0, m = -inf), the log-sum-exp m + log l
    is within ``LSE_TOL`` and the normalized acc / l within the K4 limits;
    returns (max |d(acc / l)|, its relative L2, max |d(m + log l)|)."""
    (_, m, l), (_, m_r, l_r) = carry, ref
    seen = l_r > 0
    if not (torch.equal(seen, l > 0) and torch.isneginf(m[~seen]).all()):
        raise AssertionError(f'K4 {name}: rows without a valid key differ')
    lse_err = ((m + l.log()) - (m_r + l_r.log()))[seen].abs().max().item()
    if lse_err > LSE_TOL:
        raise AssertionError(f'K4 {name} carry: max|d(m + log l)| '
                             f'{lse_err:.3e} (bound {LSE_TOL})')
    return (*k4_close(f'K4 {name} acc / l', normalized(carry),
                      normalized(ref)), lse_err)


def fold_without_acc_rescale(q, k, v, kv_valid=None, carry=None, last=False):
    """Planted fault: the plain fold with the carried acc not rescaled by
    exp(m_old - m_new) on entry (l still is)."""
    new, _ = hop.ring_hop_ref(q, k, v, kv_valid, carry)
    acc, m, l = new
    if carry is not None:
        keep = torch.where(carry[2] > 0, torch.exp(carry[1] - m), 0.0)
        acc = acc + carry[0] * (1 - keep).transpose(1, 2)[..., None]
    out = normalized((acc, m, l)).to(q.dtype) if last else None
    return (acc, m, l), out


def planted_k4_faults(q, blocks, out_r):
    """Three faults a hop could make, on the chain of ``blocks``: each must
    break both K4 limits on O against the sound plain O ``out_r``. Returns
    their readings."""
    k, v, valid = blocks[0]
    swap = torch.cat([torch.arange(8, 16), torch.arange(8)]).to(v.device)
    v_bad = v.clone()
    v_bad[:, :16] = v[:, swap]
    faults = {
        'hop 2 of 4 dropped': (hop.ring_hop, blocks[:1] + blocks[2:]),
        'V key rows 0-7 and 8-15 swapped in the first tile':
            (hop.ring_hop, [(k, v_bad, valid)] + blocks[1:]),
        'carried acc not rescaled (plain fold)':
            (fold_without_acc_rescale, blocks)}
    parts = []
    for name, (fn, chain) in faults.items():
        err, over, rel = k4_readings(hop_chain(fn, q, chain)[1], out_r)
        if not (over > 0 and rel > K4_REL_L2):
            raise AssertionError(f'K4 planted fault "{name}" passes a K4 '
                                 f'limit: max|dO| {err:.3e} ({over:+.2e}), '
                                 f'rel L2 {rel:.3e}')
        parts.append(f'{name}: max|dO| {err:.3e}, rel L2 {rel:.3e}')
    return parts


def phase_k4_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 16)
    b, s, h, _ = FLUX_SHAPE
    sq = s // SP
    cases = [('unmasked', (1, sq, h), [None]),
             ('padded', (2, sq, h), [(1000, sq)]),
             ('padded_block', (2, sq, h), [(0, sq), (700, 0)]),
             ('ragged', (2, 193, h), [(150, 193)]),
             ('chain4', (1, sq, h), [None, (1000,), (0,), None])]
    worst, parts = 0.0, []
    for name, (bb, ss, hh), lengths in cases:
        q = torch.randn(bb, ss, hh, 128, generator=g, device='cuda',
                        dtype=torch.bfloat16)
        blocks = [hop_case(g, bb, ss, hh, ln) for ln in lengths]
        before = hop.LAUNCHES
        carry, out = hop_chain(hop.ring_hop, q, blocks)
        again = hop_chain(hop.ring_hop, q, blocks)
        torch.cuda.synchronize()
        if hop.LAUNCHES != before + 2 * len(blocks):
            raise AssertionError(f'K4 {name}: {hop.LAUNCHES - before} '
                                 f'launches, want {2 * len(blocks)}')
        if not (torch.equal(out, again[1])
                and all(map(torch.equal, carry, again[0]))):
            raise AssertionError(f'K4 {name}: two runs differ')
        ref, out_r = hop_chain(hop.ring_hop_ref, q, blocks)
        acc_err, acc_rel, lse_err = carry_errors(name, carry, ref)
        err, rel = k4_close(f'K4 {name} O', out, out_r)
        worst = max(worst, err)
        parts.append(f'{name} B{bb} S{ss} H{hh} x{len(blocks)} hops max|dO| '
                     f'{err:.3e} rel L2 {rel:.3e}, max|d(acc/l)| '
                     f'{acc_err:.3e} rel L2 {acc_rel:.3e}, max|d(m + log '
                     f'l)| {lse_err:.3e}')
    faults = planted_k4_faults(q, blocks, out_r)     # on the chain4 case
    # one middle hop of the FLUX ring: the carry read and written, no O
    q = torch.randn(1, sq, h, 128, generator=g, device='cuda',
                    dtype=torch.bfloat16)
    k, v, _ = hop_case(g, 1, sq, h)
    carry, _ = hop.ring_hop(q, k, v)
    carry_r, _ = hop.ring_hop_ref(q, k, v)
    # device time by the profiler: a hop is short enough for the host's
    # launch cost to show through CUDA events around it (call_ms)
    ms = kernel_ms(lambda: hop.ring_hop(q, k, v, None, carry), 'ring_hop',
                   50)
    call_ms = cuda_ms(lambda: hop.ring_hop(q, k, v, None, carry), 50)
    plain_ms = cuda_ms(lambda: hop.ring_hop_ref(q, k, v, None, carry_r), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    with torch.inference_mode():
        library_ms = kernel_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt), 'flash', 50)
    bound_ms, bound_by = k4_bound(1, sq, sq, h)
    log(f'phase 15 ring-hop kernel vs plain: ok | {" ; ".join(parts)} '
        f'(limits on O and acc / l: |d| <= {K4_ATOL} + {K4_RTOL:.4g} |ref|, '
        f'rel L2 {K4_REL_L2}; m + log l {LSE_TOL}), keyless rows exact, two '
        f'runs bitwise equal | planted faults refused by both limits: '
        f'{" ; ".join(faults)} | one middle hop at B1 Sq {sq} Skv {sq} H{h} '
        f'D128: kernel {ms:.4f} ms of device time (a call by CUDA events '
        f'{call_ms:.4f} ms), plain fp32 {plain_ms:.4f} ms, flash SDPA (O + '
        f'LSE) {library_ms:.4f} ms of device time, bound {bound_ms:.4f} ms '
        f'({bound_by}, {100 * bound_ms / ms:.1f}% of it) | ptxas: '
        f'{ptxas_usage("ring_hop_kernel")}')
    return worst, dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, shape=[1, sq, sq, h, 128])


@contextlib.contextmanager
def lost_rotation():
    """Planted fault: the first rotation of every ring call hands each
    shard its own block again, so it folds that block twice and never sees
    the one ``size - 1`` shards back."""
    real, calls = ring_mod._rotation, itertools.count()

    def stale(ring, blocks):
        if next(calls) % (ring.size - 1) == 0:
            return lambda: blocks
        return real(ring, blocks)
    with mock.patch.object(ring_mod, '_rotation', stale):
        yield


def max_diff(a, b):
    return (a.float() - b.float()).abs().max().item()


def phase_ring_vs_k1():
    g = torch.Generator(device='cuda').manual_seed(SEED + 17)
    q, k, v = (torch.randn(FLUX_SHAPE, generator=g, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    s = FLUX_SHAPE[1]
    masked = torch.arange(s, device='cuda')[None, :] < QWEN_VALID_KEYS
    ring = LocalRing(SP)
    parts = []
    for name, kv_valid in (('unmasked', None), ('masked', masked)):
        before = hop.LAUNCHES
        out, lse = ring_attention(q, k, v, kv_valid, ring, return_lse=True)
        torch.cuda.synchronize()
        if hop.LAUNCHES != before + SP * SP:
            raise AssertionError(f'{name}: {hop.LAUNCHES - before} hop '
                                 f'launches, want {SP * SP}')
        ref, ref_lse = attn.attention_ref(q, k, v, kv_valid, return_lse=True)
        err, rel = k4_close(f'ring {name} O', out, ref)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=LSE_TOL)
        k1 = attn.flash_attention_fwd(q, k, v, kv_valid)
        ring_ms = cuda_ms(lambda: ring_attention(q, k, v, kv_valid, ring), 10)
        k1_ms = cuda_ms(lambda: attn.flash_attention_fwd(q, k, v, kv_valid),
                        10)
        parts.append(
            f'{name}: max|dO| {err:.3e} rel L2 {rel:.3e} max|dLSE| '
            f'{max_diff(lse, ref_lse):.3e} against the plain version, '
            f'max|ring - K1| {max_diff(out, k1):.3e}; ring {ring_ms:.4f} ms '
            f'({SP * SP} hops), K1 {k1_ms:.4f} ms')
    with lost_rotation():
        lost = ring_attention(q, k, v, masked, ring)
    err, over, rel = k4_readings(lost, ref)
    if not (over > 0 and rel > K4_REL_L2):
        raise AssertionError(f'a ring with a lost rotation passes a K4 '
                             f'limit: max|dO| {err:.3e} ({over:+.2e}), rel '
                             f'L2 {rel:.3e}')
    log(f'phase 16 ring attention (LocalRing({SP})) vs the attention kernel '
        f'at B1 S{s} H24 D128: ok | {" ; ".join(parts)} | limits on O: |d| '
        f'<= {K4_ATOL} + {K4_RTOL:.4g} |ref|, rel L2 {K4_REL_L2}; LSE '
        f'{LSE_TOL} | planted lost rotation (masked) refused by both: '
        f'max|dO| {err:.3e}, rel L2 {rel:.3e}')


def counted_forward(model, x, kw):
    """``means`` of one forward and its (ring-hop, attention) launches."""
    before = (hop.LAUNCHES, attn.LAUNCHES)
    with torch.inference_mode():
        means = model(x, **kw)['means'].float()
    torch.cuda.synchronize()
    return means, (hop.LAUNCHES - before[0], attn.LAUNCHES - before[1])


def local_ring_slice(name, model, x, kw, n_blocks, bound, size=SP):
    """One forward on the attention kernel, one on ``LocalRing(size)``;
    raises past ``bound`` (relative L2 of ``means``) or on wrong counts."""
    k1, n_k1 = counted_forward(model, x, kw)
    set_sequence_parallel(model, LocalRing(size))
    try:
        ring, n_ring = counted_forward(model, x, kw)
    finally:
        set_sequence_parallel(model, None)
    if n_k1 != (0, n_blocks) or n_ring != (size * size * n_blocks, 0):
        raise AssertionError(f'{name}: launches (hop, attention) {n_k1} on '
                             f'the kernel and {n_ring} on the ring')
    if not torch.isfinite(ring).all():
        raise AssertionError(f'{name}: non-finite means')
    rel = rel_l2(ring, k1)
    if rel > bound:
        raise AssertionError(f'{name}: means rel L2 {rel:.3e} > {bound}')
    return f'{name}: rel L2 ring vs K1 {rel:.3e} (bound {bound}), ' \
        f'{n_ring[0]} hop launches'


def phase_local_ring_slices():
    g = torch.Generator(device='cuda').manual_seed(SEED + 18)
    cfg = dict(FLUX_12B, num_layers=1, num_single_layers=1)
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **cfg)
    randomize_(model, g)
    x = torch.randn(1, 128, 128, 16, generator=g, device='cuda')
    kw = dict(flux_inputs(g), t=torch.full((1,), 0.7, device='cuda'),
              guidance=torch.full((1,), 3.5, device='cuda'))
    flux = local_ring_slice('FLUX 1+1 blocks bf16', model, x, kw, 2,
                            SLICE_REL_L2)
    # sp = 3 divides neither the 512 text nor the 4096 image tokens: both
    # streams are padded and every hop is masked
    padded = local_ring_slice('FLUX 1+1 blocks bf16 on LocalRing(3), both '
                              'streams padded', model, x, kw, 2,
                              SLICE_REL_L2, size=3)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    pipe, _, _ = qwen_w4a8(g, num_layers=1)
    kw = dict(qwen_inputs(g), t=torch.full((1,), 0.7, device='cuda'))
    qwen = local_ring_slice('Qwen 1 block w4a8', pipe.transformer, x, kw, 1,
                            QWEN_SLICE_REL_L2)
    log(f'phase 17 reduced slices under LocalRing({SP}) (full width): ok | '
        f'{flux} ; {padded} ; {qwen}')


def hop_host_ms(fn):
    """One call of ``fn`` with the ring-hop wrapper and its C entry point
    (TMA maps encoded, kernel launched) timed on the host clock around each
    call: (hop calls, wrapper ms per hop, entry point ms per hop). The
    kernels run asynchronously, so this is what the host spends to issue a
    hop, not the hop's device time."""
    lib = _build.load_library()
    real_hop, real_entry = ring_mod.ring_hop, lib.arcflow_ring_hop
    spent = dict(wrapper=0.0, entry=0.0, calls=0)

    def timed_hop(*args, **kw):
        t = time.perf_counter()
        try:
            return real_hop(*args, **kw)
        finally:
            spent['wrapper'] += time.perf_counter() - t
            spent['calls'] += 1

    def timed_entry(*args):
        t = time.perf_counter()
        try:
            return real_entry(*args)
        finally:
            spent['entry'] += time.perf_counter() - t
    with mock.patch.object(ring_mod, 'ring_hop', timed_hop), \
            mock.patch.object(lib, 'arcflow_ring_hop', timed_entry):
        fn()
    n = spent['calls']
    return n, 1e3 * spent['wrapper'] / n, 1e3 * spent['entry'] / n


def phase_full_local_ring(pipe, embeds, latents, lat_single, t_single):
    set_sequence_parallel(pipe.transformer, LocalRing(SP))
    try:
        _, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
        torch.cuda.reset_peak_memory_stats()
        hop.LAUNCHES = attn.LAUNCHES = 0    # the main path's counted run
        out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
        launches = dict(ring_hop=hop.LAUNCHES, attention=attn.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        lat = timed_call(pipe, embeds, latents,
                         output_type='latent')[0]['latents']
        n_host, host_ms, entry_ms = hop_host_ms(
            lambda: timed_call(pipe, embeds, latents, output_type='pt'))
        wall, busy, by_name = profile_split(
            lambda: pipe(prompt_embeds=embeds, latents=latents,
                         output_type='pt'))
        with lost_rotation():
            lost = pipe(prompt_embeds=embeds, latents=latents,
                        output_type='latent')['latents']
    finally:
        set_sequence_parallel(pipe.transformer, None)
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    want = dict(ring_hop=2 * n_blocks * SP * SP, attention=0)
    if launches != want:
        raise AssertionError(f'launches {launches}, want {want}')
    check_image(out['images'])
    rel = rel_l2(lat, lat_single)
    if not rel <= SP_IMAGE_REL_L2:
        raise AssertionError(f'latents rel L2 {rel:.3e} against one device '
                             f'> {SP_IMAGE_REL_L2}')
    hop_dev, hop_calls = (sum(v[i] for name, v in by_name.items()
                              if 'ring_hop' in name) for i in (0, 1))
    rel_lost = rel_l2(lost, lat_single)
    if not rel_lost > SP_IMAGE_REL_L2:
        raise AssertionError(f'a lost rotation passes: latents rel L2 '
                             f'{rel_lost:.3e} <= {SP_IMAGE_REL_L2}')
    log(f'phase 18 FLUX full slice under LocalRing({SP}) (phase 6 model): ok '
        f'| image finite | launches {launches} | latents rel L2 against '
        f'phase 6 {rel:.3e} (bound {SP_IMAGE_REL_L2}; planted lost rotation '
        f'{rel_lost:.3e}, refused) | cold run {t_cold:.3f} s, warm per image '
        f'{t_e2e:.4f} s (phase 6: {t_single:.4f} s) | peak memory '
        f'{peak_gib:.2f} GiB | host per hop (one image, {n_host} hops, host '
        f'clock around each call): wrapper {host_ms:.4f} ms, of it the C '
        f'entry point (TMA maps, launch) {entry_ms:.4f} ms; {n_host} x '
        f'wrapper = {n_host * host_ms / 1e3:.4f} s | profile (one image): '
        f'wall {wall:.4f} s, device busy {busy:.4f} s, idle share '
        f'{1 - busy / wall:.4f}, ring_hop device {hop_dev:.2f} ms x'
        f'{hop_calls}')
    return launches['ring_hop'], dict(
        host_ms_per_hop=host_ms, entry_ms_per_hop=entry_ms,
        idle_share=1 - busy / wall, image_s=t_e2e)


def int8_case(g, m, k, n):
    """Random int8 activations (M, K) and an int8 kernel (K, N) stored as
    the layers store it: column-major, the bytes of (N, K)."""
    xq = torch.randint(-127, 128, (m, k), generator=g, device='cuda',
                       dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device='cuda',
                      dtype=torch.int8).t()
    return xq, w


def int_mm_takes(m):
    """Whether ``torch._int_mm`` itself takes an M-row product (the limit
    the wrapper's zero rows are for), or its error message."""
    xq, w = int8_case(torch.Generator(device='cuda'), m, 64, 64)
    try:
        torch._int_mm(xq, w)
        return 'takes it'
    except RuntimeError as e:
        return f'refuses it ({str(e).splitlines()[0][:80]})'


def phase_int8_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 20)
    for m, k, n in INT8_SHAPES:
        xq, w = int8_case(g, m, k, n)
        out = i8.int8_matmul(xq, w)
        torch.cuda.synchronize()
        if not torch.equal(out, i8.int8_matmul_ref(xq, w)):
            raise AssertionError(f'int8 product at ({m}, {k}, {n}) is not '
                                 f'exact')
    timed = []
    for m, k, n in INT8_TIMED:
        xq, w = int8_case(g, m, k, n)
        ms = cuda_ms(lambda: i8.int8_matmul(xq, w), 20)
        plain_ms = cuda_ms(lambda: i8.int8_matmul_ref(xq, w), 3)
        bound_ms, bound_by = roofline(2 * m * k * n, m * k + k * n + m * n * 4,
                                      H100_INT8)
        timed.append(dict(shape=[m, k, n], ms=ms, plain_ms=plain_ms,
                          tops=2 * m * k * n / (ms * 1e-3) / 1e12,
                          bound_ms=bound_ms, bound_by=bound_by))
    limits = {m: int_mm_takes(m) for m in (1, 16, 17)}
    log(f'phase 19 int8 product (torch._int_mm) vs plain: ok | '
        f'{len(INT8_SHAPES)} FLUX-12B layer shapes bitwise exact (M 4096, '
        f'512, 4608 and 1, the last zero-padded to {i8.MIN_ROWS} rows) | '
        f'torch._int_mm alone at M=1 {limits[1]}, M=16 {limits[16]}, M=17 '
        f'{limits[17]} | ' + ' ; '.join(
            f'M{t["shape"][0]} K{t["shape"][1]} N{t["shape"][2]}: '
            f'{t["ms"]:.4f} ms ({t["tops"]:.1f} TOP/s), plain fp64 '
            f'{t["plain_ms"]:.4f} ms, bound {t["bound_ms"]:.4f} ms '
            f'({t["bound_by"]}, {100 * t["bound_ms"] / t["ms"]:.1f}% of it)'
            for t in timed))
    return timed


def int8_layers(model, act_quant):
    """The int8 layers of ``model``, each set to ``act_quant``."""
    found = [m for m in model.modules()
             if isinstance(m, LoRADense) and m.is_int8]
    for m in found:
        m.act_quant = act_quant
    return len(found)


def phase_w8a8_reduced():
    g = torch.Generator(device='cuda').manual_seed(SEED + 21)
    cfg = dict(FLUX_12B, num_layers=1, num_single_layers=1)
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **cfg)
    randomize_(model, g)
    x = torch.randn(1, 128, 128, 16, generator=g, device='cuda')
    kw = dict(flux_inputs(g), t=torch.full((1,), 0.7, device='cuda'),
              guidance=torch.full((1,), 3.5, device='cuda'))
    want_layers = INT8_OUTSIDE_BLOCKS + INT8_PER_JOINT + INT8_PER_SINGLE
    with torch.inference_mode():
        bf16 = model(x, **kw)['means'].float()
        n_int8 = ArcFluxPipeline(model).quantize_int8(act_quant=True)
        before = (attn.LAUNCHES, i8.LAUNCHES)
        fast = model(x, **kw)['means'].float()
        torch.cuda.synchronize()
        launches = (attn.LAUNCHES - before[0], i8.LAUNCHES - before[1])

        def plain(q, k, v, kv_valid=None, return_lse=False):
            return attn.attention_ref(q, k, v, kv_valid, return_lse)

        with mock.patch.object(i8, 'int8_matmul', i8.int8_matmul_ref):
            plain_product = model(x, **kw)['means'].float()
            with mock.patch.object(attn, 'flash_attention_fwd', plain):
                slow = model(x, **kw)['means'].float()
        int8_layers(model, act_quant=False)
        weight_only = model(x, **kw)['means'].float()
        torch.cuda.synchronize()
    if n_int8 != want_layers or launches != (2, want_layers):
        raise AssertionError(f'{n_int8} int8 layers (want {want_layers}), '
                             f'launches (attention, int8) {launches}')
    if not all(torch.isfinite(t).all() for t in (fast, slow, weight_only)):
        raise AssertionError('non-finite means')
    if not torch.equal(fast, plain_product):
        raise AssertionError('the plain int8 product changes the means')
    rel = rel_l2(fast, slow)
    if rel > W8A8_SLICE_REL_L2:
        raise AssertionError(f'means rel L2 {rel:.3e} > {W8A8_SLICE_REL_L2}')
    quant_rel, wo_rel = rel_l2(fast, bf16), rel_l2(weight_only, bf16)
    log(f'phase 20 FLUX reduced slice (1+1 blocks, full width) w8a8: ok | '
        f'{n_int8} int8 layers | means with the plain int8 product bitwise '
        f'equal | means rel L2 card vs plain attention and plain int8 '
        f'product {rel:.3e} (bound {W8A8_SLICE_REL_L2}) | launches '
        f'(attention, int8) {launches} | quantization against bf16: w8a8 '
        f'{quant_rel:.3e}, weight-only int8 {wo_rel:.3e}')
    return quant_rel


def int8_image(pipe, embeds, latents, lat_bf16, want):
    """A cold then a counted warm image of the quantized ``pipe`` (counts
    set to 0 just before), checked against ``want`` launches; then the
    latents alone and a decode. Returns the numbers of one mode."""
    attn.LAUNCHES = i8.LAUNCHES = 0
    first, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = i8.LAUNCHES = 0        # the main path's counted run
    out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
    launches = dict(attention=attn.LAUNCHES, int8=i8.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != want:
        raise AssertionError(f'launches {launches}, want {want}')
    img = out['images']
    check_image(img)
    rerun = (first['images'] - img).abs().max().item()
    if rerun != 0.0:
        raise AssertionError(f'two runs differ by {rerun:.3e}')
    lat, t_dit = timed_call(pipe, embeds, latents, output_type='latent')
    lat = lat['latents']
    rel = rel_l2(lat, lat_bf16)
    if not rel <= INT8_IMAGE_REL_L2:
        raise AssertionError(f'latents rel L2 against bf16 {rel:.3e} > '
                             f'{INT8_IMAGE_REL_L2}')
    return dict(launches=launches, cold_s=t_cold, warm_s=t_e2e, dit_s=t_dit,
                decode_s=timed_decode(pipe.vae, lat), peak_gib=peak_gib,
                rel_l2=rel, range=(img.min().item(), img.max().item()))


def captured_attention(pipe, embeds, latents, calls):
    """q, k, v of the attention calls numbered ``calls`` (in order) of the
    first DiT call of one image, copied by a spy on ``layers.attention``."""
    seen, kept = itertools.count(), []

    def spy(q, k, v, mask=None, sp=None):
        if next(seen) in calls:
            kept.append(tuple(t.clone() for t in (q, k, v)))
        return attention(q, k, v, mask=mask, sp=sp)
    attention = layers.attention
    with mock.patch.object(layers, 'attention', spy):
        pipe(prompt_embeds=embeds, latents=latents, output_type='latent')
    return kept


def phase_w8a8_full(pipe, embeds, latents, lat_bf16, t_bf16):
    resident_bf16 = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    n_int8 = pipe.quantize_int8(act_quant=True)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    n_joint = FLUX_12B['num_layers']
    n_single = FLUX_12B['num_single_layers']
    want_layers = (INT8_OUTSIDE_BLOCKS + INT8_PER_JOINT * n_joint
                   + INT8_PER_SINGLE * n_single)
    if n_int8 != want_layers or int8_layers(pipe.transformer,
                                            True) != want_layers:
        raise AssertionError(f'{n_int8} int8 layers, want {want_layers}')
    n_attn = 2 * (n_joint + n_single)
    w8a8 = int8_image(pipe, embeds, latents, lat_bf16,
                      dict(attention=n_attn, int8=2 * n_int8))
    # the first joint and the first single block of the first DiT call
    captured = captured_attention(pipe, embeds, latents, (0, n_joint))
    wall, busy, by_name = profile_split(
        lambda: pipe(prompt_embeds=embeds, latents=latents, output_type='pt'))
    total = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    int8_layers(pipe.transformer, act_quant=False)
    weight_only = int8_image(pipe, embeds, latents, lat_bf16,
                             dict(attention=n_attn, int8=0))
    log(f'phase 21 FLUX-12B int8 (phase 6 model quantized in place with '
        f'quantize_int8(act_quant=True)): ok | {n_int8} int8 layers in '
        f'{t_quant:.1f} s, resident {resident_gib:.2f} GiB (bf16 '
        f'{resident_bf16:.2f} GiB) | ' + ' ; '.join(
            f'{name}: image finite, range [{r["range"][0]:.3f}, '
            f'{r["range"][1]:.3f}], two runs bitwise equal, launches '
            f'{r["launches"]}, cold run {r["cold_s"]:.3f} s, warm per image '
            f'{r["warm_s"]:.4f} s: transformer + integration '
            f'{r["dit_s"]:.4f} s, decode {r["decode_s"]:.4f} s (bf16 phase 6: '
            f'{t_bf16:.4f} s), peak memory {r["peak_gib"]:.2f} GiB, latents '
            f'rel L2 against bf16 {r["rel_l2"]:.3e} (bound '
            f'{INT8_IMAGE_REL_L2})'
            for name, r in (('w8a8', w8a8), ('weight-only int8',
                                               weight_only))))
    log(f'phase 21 profile (one warm w8a8 image): wall {wall:.4f} s, device '
        f'busy {busy:.4f} s, idle share {1 - busy / wall:.4f} | by family: '
        + ' ; '.join(f'{f} {ms:.2f} ms {100 * ms / total:.1f}% x{calls}'
                     for f, (ms, calls, _) in sorted(
                         split_families(by_name).items(),
                         key=lambda kv: -kv[1][0]))
        + ' | by name: ' + ' ; '.join(
            f'{ms:.2f} ms x{calls} {name[:70]}' for name, (ms, calls) in top))
    return captured


def k7_readings(got, want):
    """max |d| of ``got`` against the plain version ``want``, how far the
    worst element lies past K7_ATOL + K7_RTOL |want| (> 0: refused), and
    the relative L2."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    over = (d - K7_ATOL - K7_RTOL * want.abs()).max().item()
    return d.max().item(), over, rel_l2(got, want)


def k7_check(name, q, k, v, kv_valid=None):
    """K7 against its plain version on one case (and a bitwise repeat);
    raises past a limit; returns (max |d|, rel L2, O)."""
    out = fi8.flash_attention_int8(q, k, v, kv_valid)
    again = fi8.flash_attention_int8(q, k, v, kv_valid)
    torch.cuda.synchronize()
    if not (torch.isfinite(out).all() and torch.equal(out, again)):
        raise AssertionError(f'K7 {name}: non-finite or not repeatable')
    err, over, rel = k7_readings(
        out, fi8.flash_attention_int8_ref(q, k, v, kv_valid))
    if over > 0 or not rel <= K7_REL_L2:
        raise AssertionError(f'K7 {name}: max|d| {err:.3e} ({over:+.2e} past '
                             f'{K7_ATOL} + {K7_RTOL:.4g} |ref|), rel L2 '
                             f'{rel:.3e} (bound {K7_REL_L2})')
    return err, rel, out


def planted_k7_faults(q, k, v):
    """Two faults the kernel could make, on sound inputs: the k scales
    dropped, and int8 key rows 0-7 and 8-15 swapped in the first tile (what
    rescaling an accumulator by another column's scale does). Each must
    break both limits. Returns their readings."""
    qq, qs, kq, ks = fi8.quantize_qk(q, k)
    ref = fi8.flash_attention_int8_ref(q, k, v)
    swap = torch.cat([torch.arange(8, 16), torch.arange(8)]).to(q.device)
    kq_bad = kq.clone()
    kq_bad[:, :16] = kq[:, swap]
    parts = []
    for name, (k_i8, k_scale) in {
            'k scales dropped': (kq, torch.ones_like(ks)),
            'int8 key rows swapped in one tile': (kq_bad, ks)}.items():
        bad = fi8.launch(qq, qs, k_i8, k_scale, v, None, q.shape[-1] ** -0.5,
                         q.dtype)
        err, over, rel = k7_readings(bad, ref)
        if not (over > 0 and rel > K7_REL_L2):
            raise AssertionError(f'K7 planted fault "{name}" passes a limit: '
                                 f'max|d| {err:.3e} ({over:+.2e}), rel L2 '
                                 f'{rel:.3e}')
        parts.append(f'{name}: max|d| {err:.3e}, rel L2 {rel:.3e}')
    return parts


def quant_bound(b, s, h, elem=2):
    """Roofline of the row quantization of q and k at (B, S, H, 128):
    reading both in ``elem`` bytes a value, writing their int8 rows and fp32
    scales; against 6 fp32 operations a value (abs, max, divide, round,
    two clips) at the fp32 peak."""
    values = 2 * b * s * h * 128
    nbytes = values * elem + values + 2 * b * h * s * 4
    return roofline(6 * values, nbytes, H100_FP32)


def quant_check(name, q, k):
    """The quantization kernel against ``rowwise_int8`` (through
    ``quantize_qk_ref``) on the same card tensors, bitwise; raises on any
    difference, else returns the largest |difference| (0)."""
    got = fi8.quantize_qk(q, k)
    want = fi8.quantize_qk_ref(q, k)
    worst = 0.0
    for part, x, y in zip(('q rows', 'q scales', 'k rows', 'k scales'), got,
                          want):
        if not torch.equal(x, y):
            raise AssertionError(f'quantization {name}: {part} differ from '
                                 f'rowwise_int8 at {int((x != y).sum())} '
                                 f'places')
        worst = max(worst, (x.float() - y.float()).abs().max().item())
    return worst


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def phase_k7_vs_plain(captured):
    g = torch.Generator(device='cuda').manual_seed(SEED + 22)
    b, s, h, _ = FLUX_SHAPE

    def qkv(shape):
        return [torch.randn(shape, generator=g, device='cuda',
                            dtype=torch.bfloat16) for _ in range(3)]

    def valid(n, lengths):
        return torch.arange(n, device='cuda')[None, :] < torch.tensor(
            lengths, device='cuda')[:, None]
    flux = qkv(FLUX_SHAPE)
    jax_shape = qkv((2, 512, 3, 128))
    cases = [('flux', flux, None),
             ('masked', flux, valid(s, (QWEN_VALID_KEYS,))),
             ('keyless row', jax_shape, valid(512, (0, 512))),
             ('jax test shape', jax_shape, None),
             ('jax test shape masked', jax_shape, valid(512, (256, 448))),
             ('ragged', qkv((2, 1000, 4, 128)), valid(1000, (900, 1000)))]
    fp32 = [x.float() for x in qkv((2, 1000, 4, 128))]
    quant_err = max(quant_check(name, q, k) for name, (q, k, _), _ in
                    cases + [('ragged fp32', fp32, None)])
    q, k, _ = flux
    quant_err = max(quant_err, quant_check(
        'FLUX shape, head-major views',
        q.transpose(1, 2).contiguous().transpose(1, 2),
        k.transpose(1, 2).contiguous().transpose(1, 2)))
    worst, parts = 0.0, []
    for name, (q, k, v), kv_valid in cases:
        err, rel, out = k7_check(name, q, k, v, kv_valid)
        if name == 'keyless row':
            mean = v[0].float().mean(0).expand_as(v[0]).to(v.dtype)
            if (out[0].float() - mean.float()).abs().max() > K7_ATOL:
                raise AssertionError('K7: a keyless row is not the mean of v')
        worst = max(worst, err)
        parts.append(f'{name} max|d| {err:.3e} rel L2 {rel:.3e}')
    fi8.LAUNCHES = fi8.QUANT_LAUNCHES = 0   # the probe of the w8a8 image
    probe = []
    for name, (q, k, v) in zip(('joint block 0', 'single block 0'),
                               captured):
        err, rel, out = k7_check(name, q, k, v)
        cos = cosine(out, attn.flash_attention_fwd(q, k, v))
        if not cos > K7_COSINE:
            raise AssertionError(f'K7 {name}: cosine against K1 {cos:.6f}')
        worst = max(worst, err)
        probe.append(f'{name} max|d| {err:.3e} rel L2 {rel:.3e}, cosine '
                     f'against K1 {cos:.6f}')
    launches = fi8.LAUNCHES // 2            # each case runs twice
    quant_launches = fi8.QUANT_LAUNCHES // 2
    if launches != 2 or quant_launches != 2:
        raise AssertionError(f'the probe launched K7 {launches} and the '
                             f'quantization {quant_launches} times, want 2')
    faults = planted_k7_faults(*flux) + planted_k7_faults(*jax_shape)
    q, k, v = flux
    qq, qs, kq, ks = fi8.quantize_qk(q, k)
    sm = q.shape[-1] ** -0.5
    ms = cuda_ms(lambda: fi8.launch(qq, qs, kq, ks, v, None, sm, q.dtype), 20)
    wrapper_ms = cuda_ms(lambda: fi8.flash_attention_int8(q, k, v), 20)
    plain_ms = cuda_ms(lambda: fi8.flash_attention_int8_ref(q, k, v), 3)
    k1_ms = cuda_ms(lambda: attn.flash_attention_fwd(q, k, v), 20)
    with torch.inference_mode():
        sdpa_ms = cuda_ms(lambda: sdpa(q, k, v), 20)
    bound_ms, bound_by = k7_bound(b, s, h)
    quant = dict(ms=kernel_ms(lambda: fi8.quantize_qk(q, k),
                              'quantize_rows_int8', 50),
                 call_ms=cuda_ms(lambda: fi8.quantize_qk(q, k), 50),
                 plain_ms=cuda_ms(lambda: fi8.quantize_qk_ref(q, k), 20),
                 launches=quant_launches, max_abs_err=quant_err)
    quant['bound_ms'], quant['bound_by'] = quant_bound(b, s, h)
    ptxas = {name: ptxas_usage(name) for name in (
        'flash_int8_kernelI13__nv_bfloat16E', 'quantize_rows_int8_kernel')}
    log(f'phase 22 int8-QK^T attention kernel (K7) vs plain: ok | '
        f'{" ; ".join(parts)} | on the w8a8 image ({launches} probe '
        f'launches): {" ; ".join(probe)} | limits |d| <= {K7_ATOL} + '
        f'{K7_RTOL:.4g} |ref|, rel L2 {K7_REL_L2}, cosine {K7_COSINE}; two '
        f'runs bitwise equal, the keyless row the mean of v | planted faults '
        f'refused by both limits (FLUX shape, then B2 S512 H3): '
        f'{" ; ".join(faults)} | FLUX shape B{b} S{s} H{h} D128: kernel '
        f'{ms:.4f} ms (the call with the quantization {wrapper_ms:.4f} ms), '
        f'plain {plain_ms:.4f} ms, K1 {k1_ms:.4f} ms, SDPA bf16 '
        f'{sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, '
        f'{100 * bound_ms / ms:.1f}% of it) | quantization ({quant_launches} '
        f'probe launches) bitwise rowwise_int8 on bf16, fp32, ragged and '
        f'head-major rows: {quant["ms"]:.4f} ms device time (the call '
        f'{quant["call_ms"]:.4f} ms), plain {quant["plain_ms"]:.4f} ms, '
        f'bound {quant["bound_ms"]:.4f} ms ({quant["bound_by"]}, '
        f'{100 * quant["bound_ms"] / quant["ms"]:.1f}% of it) | ptxas: '
        + ' ; '.join(f'{name}: {use}' for name, use in ptxas.items()))
    return worst, launches, dict(ms=ms, wrapper_ms=wrapper_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, k1_ms=k1_ms,
                                 sdpa_ms=sdpa_ms, quant=quant,
                                 ptxas=ptxas)


def spied_call(pipe, embeds, latents, output_type):
    """One counted call of the sharded ``pipe`` (every count set to 0 just
    before it): (result, seconds, launches, the first ring attention's q,
    k, v, key mask and output, or None under Ulysses)."""
    calls = []

    def spy(*args, **kw):
        out = ring_attention(*args, **kw)
        if not calls:
            calls.append((*args[:4], out))
        return out
    hop.LAUNCHES = attn.LAUNCHES = qmm.LAUNCHES = 0
    with mock.patch.object(layers, 'ring_attention', spy):
        out, t = timed_call(pipe, embeds, latents, output_type=output_type)
    launches = dict(ring_hop=hop.LAUNCHES, attention=attn.LAUNCHES,
                    w4a8=qmm.LAUNCHES)
    return out, t, launches, calls[0] if calls else None


def equals_local_ring(sp, call):
    """Whether this rank's first ring attention is, bit for bit, its shard
    of ``LocalRing`` on every rank's q, k, v and key mask put together."""
    if call is None:
        return None
    q, k, v, valid, got = call
    full = [sp.gather(t) for t in (q, k, v)]
    mask = None if valid is None else sp.gather(valid)
    local = ring_attention(*full, mask, LocalRing(sp.size))
    return torch.equal(local.split(q.shape[1], dim=1)[sp.rank], got)


def broadcast_from_rank0(*tensors):
    for t in tensors:
        dist.broadcast(t, 0)


def rank_main(out_dir):
    """One rank of ``--ranks N``: FLUX-12B on one device, then sharded over
    the N ranks in ring and in Ulysses mode; then Qwen w4a8 at full width
    and RANKS_QWEN_LAYERS blocks, with its text mask, the same way; writes
    ``rank{r}.json``."""
    dev = setup_distributed(timeout=300.0)
    rank, n = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    with torch.device(dev):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **FLUX_12B)
        vae = PretrainedVAE(dtype=torch.bfloat16)
    randomize_(model, g)
    pipe = ArcFluxPipeline(model, vae=vae)
    embeds = flux_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device=dev)
    broadcast_from_rank0(*model.state_dict().values(),
                         *vae.state_dict().values(), *embeds.values(),
                         latents)
    timed_call(pipe, embeds, latents, output_type='pt')     # cold
    single, t_single = timed_call(pipe, embeds, latents, output_type='pt')
    single_lat = pipe(prompt_embeds=embeds, latents=latents,
                      output_type='latent')['latents']
    res = dict(rank=rank, single_s=t_single)
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    for mode in ('ring', 'ulysses'):
        pipe.shard({'sp': n}, sp_mode=mode)
        sp = pipe.transformer.sequence_parallel
        _, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
        torch.cuda.reset_peak_memory_stats()
        out, t_e2e, launches, call = spied_call(pipe, embeds, latents, 'pt')
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        img = out['images']
        lat = pipe(prompt_embeds=embeds, latents=latents,
                   output_type='latent')['latents']
        wall, busy, _ = profile_split(lambda: pipe(
            prompt_embeds=embeds, latents=latents, output_type='pt'))
        rank0 = img.clone(memory_format=torch.contiguous_format)
        broadcast_from_rank0(rank0)
        want = dict(ring=dict(ring_hop=2 * n_blocks * n, attention=0, w4a8=0),
                    ulysses=dict(ring_hop=0, attention=2 * n_blocks,
                                 w4a8=0))[mode]
        res[mode] = dict(
            launches=launches, launches_ok=launches == want,
            image_finite=bool(torch.isfinite(img).all()),
            equal_to_rank0=torch.equal(img, rank0),
            local_ring_equal=equals_local_ring(sp, call),
            rel_l2_image=rel_l2(img, single['images']),
            rel_l2_latents=rel_l2(lat, single_lat), cold_s=t_cold,
            warm_s=t_e2e, peak_gib=peak_gib, profiled_wall_s=wall,
            device_busy_s=busy, idle_share=1 - busy / wall)
    del pipe, model, vae, single, img, out
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    pipe, _, n_int4 = qwen_w4a8(g, num_layers=RANKS_QWEN_LAYERS)
    embeds = qwen_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device=dev)
    broadcast_from_rank0(*pipe.transformer.state_dict().values(),
                         *embeds.values(), latents)
    timed_call(pipe, embeds, latents, output_type='latent')  # cold
    single_lat = pipe(prompt_embeds=embeds, latents=latents,
                      output_type='latent')['latents']
    for mode in ('ring', 'ulysses'):
        pipe.shard({'sp': n}, sp_mode=mode)
        sp = pipe.transformer.sequence_parallel
        timed_call(pipe, embeds, latents, output_type='latent')  # cold
        out, t_e2e, launches, call = spied_call(pipe, embeds, latents,
                                                'latent')
        lat = out['latents']
        rank0 = lat.clone(memory_format=torch.contiguous_format)
        broadcast_from_rank0(rank0)
        want = dict(ring=dict(ring_hop=2 * RANKS_QWEN_LAYERS * n,
                              attention=0, w4a8=2 * n_int4),
                    ulysses=dict(ring_hop=0, attention=2 * RANKS_QWEN_LAYERS,
                                 w4a8=2 * n_int4))[mode]
        res[f'qwen_{mode}'] = dict(
            launches=launches, launches_ok=launches == want,
            image_finite=bool(torch.isfinite(lat).all()),
            equal_to_rank0=torch.equal(lat, rank0),
            local_ring_equal=equals_local_ring(sp, call),
            masked_ring_call=call is not None and call[3] is not None,
            rel_l2_latents=rel_l2(lat, single_lat), warm_s=t_e2e)
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def main_ranks(n):
    smi = phase_facts()
    if torch.cuda.device_count() < n:
        raise SystemExit(f'FAIL ranks: --ranks {n} needs {n} cards, '
                         f'{torch.cuda.device_count()} visible')
    phase_build()
    out_dir = tempfile.mkdtemp(prefix='ranks-', dir=_build.BUILD_DIR)
    t = time.perf_counter()
    spawn(rank_main, n, (out_dir,), timeout=600.0)
    wall = time.perf_counter() - t
    ranks = [json.load(open(os.path.join(out_dir, f'rank{r}.json')))
             for r in range(n)]
    modes = ('ring', 'ulysses', 'qwen_ring', 'qwen_ulysses')
    bad = [(r['rank'], mode, key) for r in ranks for mode in modes
           for key in ('launches_ok', 'image_finite', 'equal_to_rank0')
           if not r[mode][key]]
    bad += [(r['rank'], mode, 'local_ring_equal') for r in ranks
            for mode in ('ring', 'qwen_ring')
            if r[mode]['local_ring_equal'] is not True]
    bad += [(r['rank'], 'qwen_ring', 'masked_ring_call') for r in ranks
            if not r['qwen_ring']['masked_ring_call']]
    bad += [(r['rank'], mode, 'rel_l2_latents') for r in ranks
            for mode in modes
            if not r[mode]['rel_l2_latents'] <= SP_IMAGE_REL_L2]
    if bad:
        raise AssertionError(f'--ranks {n} failed: {bad}; {ranks}')
    r0 = ranks[0]
    log(f'phase R FLUX-12B on {n} NCCL ranks (sp = {n}): ok in {wall:.1f} s '
        f'| single device {r0["single_s"]:.4f} s per warm image | '
        + ' ; '.join(
            f'{mode}: launches per rank {r0[mode]["launches"]}, warm per '
            f'image {r0[mode]["warm_s"]:.4f} s (cold {r0[mode]["cold_s"]:.3f}'
            f'), rank 0 profiled: wall {r0[mode]["profiled_wall_s"]:.4f} s, '
            f'device busy {r0[mode]["device_busy_s"]:.4f} s, idle share '
            f'{r0[mode]["idle_share"]:.4f}, peak {r0[mode]["peak_gib"]:.2f} '
            f'GiB, rank 0 against one '
            f'device: image rel L2 {r0[mode]["rel_l2_image"]:.3e}, latents '
            f'{r0[mode]["rel_l2_latents"]:.3e} (bound {SP_IMAGE_REL_L2}); '
            f'every rank bitwise equal to rank 0'
            for mode in modes[:2])
        + f' ; first ring attention bitwise equal to LocalRing({n}) on every '
        f'rank')
    log(f'phase RQ Qwen w4a8 ({RANKS_QWEN_LAYERS} blocks, full width, text '
        f'mask {QWEN_TXT_VALID} of {QWEN_TXT}) on {n} NCCL ranks: ok | '
        + ' ; '.join(
            f'{mode[5:]}: launches per rank {r0[mode]["launches"]}, latents '
            f'rel L2 against one device {r0[mode]["rel_l2_latents"]:.3e} '
            f'(bound {SP_IMAGE_REL_L2}), warm {r0[mode]["warm_s"]:.4f} s, '
            f'every rank bitwise equal to rank 0' for mode in modes[2:])
        + f' ; first masked ring attention bitwise equal to LocalRing({n}) '
        f'on every rank')
    print(json.dumps({'ranks': ranks}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def main():
    if sys.argv[1:2] == ['--ranks']:
        return main_ranks(int(sys.argv[2]))
    smi = phase_facts()
    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    attn_err, attn_timed = phase_kernel_vs_plain()
    w4a8_err, w4a8_timed, w4a8_classes = phase_w4a8_vs_plain()
    phase_int8_vs_plain()
    phase_reduced_slice()
    phase_w8a8_reduced()
    gc.collect()
    torch.cuda.empty_cache()
    flux_launches, flux_run = phase_full_slice()
    ring_launches, ring_host = phase_full_local_ring(*flux_run)
    captured = phase_w8a8_full(*flux_run)
    del flux_run
    gc.collect()                            # the FLUX model goes first
    torch.cuda.empty_cache()
    k7_err, k7_launches, k7_timed = phase_k7_vs_plain(captured)
    del captured
    phase_qwen_reduced()
    gc.collect()
    torch.cuda.empty_cache()
    qwen_launches = phase_qwen_full(w4a8_classes)
    gc.collect()
    torch.cuda.empty_cache()
    bwd = phase_bwd_vs_plain()
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_reduced()
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = phase_train_full()
    gc.collect()
    torch.cuda.empty_cache()
    k6_err, k6_timed = phase_k6_vs_plain()
    kr = phase_kr()
    phase_gmflow()
    gc.collect()
    torch.cuda.empty_cache()
    k4_err, k4_timed = phase_k4_vs_plain()
    phase_ring_vs_k1()
    gc.collect()
    torch.cuda.empty_cache()
    phase_local_ring_slices()
    fwd = attn_timed['unmasked']
    ff_in = w4a8_timed[0]
    fwd_by_path = {'flux': flux_launches, 'qwen': qwen_launches['attention'],
                   'flux_train': train_launches['forward']}
    print(json.dumps({'kernels': [
        {'name': 'attention_fwd', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/attention_fwd.cu',
         'replaces': 'arcflow_tpu/models/layers.py:525',
         'launches': sum(fwd_by_path.values()),
         'launches_by_path': fwd_by_path,
         'max_abs_err': attn_err, 'ms': fwd['ms'],
         'plain_ms': fwd['plain_ms'], 'bound_ms': fwd['bound_ms'],
         'bound_by': fwd['bound_by'], 'library_ms': fwd['library_ms'],
         'shape': list(FLUX_SHAPE),
         'masked': dict(attn_timed['masked'], valid_keys=QWEN_VALID_KEYS)},
        {'name': 'w4a8_matmul', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/w4a8_matmul.cu',
         'replaces': 'arcflow_tpu/ops/quant_matmul.py:88',
         'launches': qwen_launches['w4a8'],
         'launches_by_path': {'qwen': qwen_launches['w4a8']},
         'max_abs_err': w4a8_err, 'ms': ff_in['ms'],
         'plain_ms': ff_in['plain_ms'], 'bound_ms': ff_in['bound_ms'],
         'bound_by': ff_in['bound_by'], 'library_ms': None,
         'reference_ms': ff_in['reference_ms'],
         'shape': ff_in['shape'], 'timed': w4a8_timed,
         'by_class': w4a8_classes},
        {'name': 'attention_bwd', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/attention_bwd.cu',
         'replaces': 'arcflow_tpu/models/layers.py:542',
         'launches': train_launches['backward'],
         'launches_by_path': {'flux_train': train_launches['backward']},
         'max_abs_err': bwd['max_abs_err'], 'max_rel_l2': bwd['max_rel_l2'],
         'ms': bwd['ms'], 'plain_ms': bwd['plain_ms'],
         'bound_ms': bwd['bound_ms'], 'bound_by': bwd['bound_by'],
         'library_ms': bwd['library_ms'], 'shape': list(FLUX_SHAPE)},
        {'name': 'gm_inverse_cdf', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/gm_inverse_cdf.cu',
         'replaces': 'arcflow_tpu/ops/gm/inverse_cdf.py:70',
         'launches': kr['launches'],
         'launches_by_path': {'kr_transport': kr['launches']},
         'max_abs_err': k6_err, 'ms': k6_timed['kr_axis']['ms'],
         'plain_ms': k6_timed['kr_axis']['plain_ms'],
         'bound_ms': k6_timed['kr_axis']['bound_ms'],
         'bound_by': k6_timed['kr_axis']['bound_by'], 'library_ms': None,
         'shape': k6_timed['kr_axis']['shape'],
         'wrapper_ms': k6_timed['kr_axis']['wrapper_ms'],
         'lanes': k6_timed['kr_axis']['lanes'],
         'ms_by_lanes': k6_timed['kr_axis']['ms_by_lanes'],
         'large': k6_timed['large']},
        {'name': 'ring_hop', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/ring_hop.cu',
         'replaces': 'arcflow_tpu/parallel/ring_attention.py:116',
         'launches': ring_launches,
         'launches_by_path': {'flux_local_ring': ring_launches},
         'max_abs_err': k4_err, 'ms': k4_timed['ms'],
         'plain_ms': k4_timed['plain_ms'], 'bound_ms': k4_timed['bound_ms'],
         'bound_by': k4_timed['bound_by'],
         'library_ms': k4_timed['library_ms'],
         'call_ms': k4_timed['call_ms'], 'shape': k4_timed['shape'],
         'flux_local_ring': ring_host},
        {'name': 'flash_int8', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/flash_int8.cu',
         'replaces': 'arcflow_tpu/ops/flash_int8.py:93',
         'launches': k7_launches,
         'launches_by_path': {'w8a8_flux_probe': k7_launches},
         'max_abs_err': k7_err, 'ms': k7_timed['ms'],
         'plain_ms': k7_timed['plain_ms'], 'bound_ms': k7_timed['bound_ms'],
         'bound_by': k7_timed['bound_by'], 'library_ms': None,
         'wrapper_ms': k7_timed['wrapper_ms'],
         'reference_ms': {'attention_fwd': k7_timed['k1_ms'],
                          'sdpa_bf16': k7_timed['sdpa_ms']},
         'shape': list(FLUX_SHAPE)},
        {'name': 'quantize_rows_int8', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/flash_int8.cu',
         'replaces': 'arcflow_tpu/ops/flash_int8.py:118',
         'launches': k7_timed['quant']['launches'],
         'launches_by_path': {
             'w8a8_flux_probe': k7_timed['quant']['launches']},
         'max_abs_err': k7_timed['quant']['max_abs_err'],
         'ms': k7_timed['quant']['ms'],
         'plain_ms': k7_timed['quant']['plain_ms'],
         'bound_ms': k7_timed['quant']['bound_ms'],
         'bound_by': k7_timed['quant']['bound_by'], 'library_ms': None,
         'call_ms': k7_timed['quant']['call_ms'],
         'shape': list(FLUX_SHAPE)}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
