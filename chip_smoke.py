#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (arcflow_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it imports nothing of JAX. Phases, one
line each, and any failure exits non-zero:

1. facts: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile both kernels (attention, w4a8 matmul) from
   ``arcflow_tpu_torch/csrc``, one ``nvcc`` per source, all in parallel;
3. attention kernel vs plain: against ``attention_ref`` at the FLUX shape
   (B1 S4608 H24 D128), a ragged S and key-padded cases, and both timed at
   the FLUX shape;
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
   then a ``torch.profiler`` split of one warm image by kernel name.

Then one JSON line of per-kernel numbers, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

import gc
import json
import subprocess
import sys
import time
from unittest import mock

import torch

from arcflow_tpu_torch.models import (ArcFluxTransformer2DModel,
                                      ArcQwenImageTransformer2DModel,
                                      PretrainedVAE, PretrainedVAEQwenImage)
from arcflow_tpu_torch.models.layers import LoRADense
from arcflow_tpu_torch.ops import _build
from arcflow_tpu_torch.ops import attention as attn
from arcflow_tpu_torch.ops import quant_matmul as qmm
from arcflow_tpu_torch.pipelines import ArcFluxPipeline, ArcQwenImagePipeline
from arcflow_tpu_torch.utils.quantize import pack_int4

SEED = 0
FLUX_12B = dict(in_channels=64, num_layers=19, num_single_layers=38,
                attention_head_dim=128, num_attention_heads=24,
                joint_attention_dim=4096, pooled_projection_dim=768,
                num_gaussians=16, lora_rank=0)
FLUX_SHAPE = (1, 4608, 24, 128)
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
# device time by kernel family in the profile: the first family with a
# substring in the kernel's name takes it (cuDNN's implicit-GEMM convs
# before cuBLAS's GEMMs)
KERNEL_FAMILIES = (('w4a8 kernel', ('w4a8_matmul',)),
                   ('attention kernel', ('attention_fwd',)),
                   ('convolution', ('conv', 'cudnn', 'fprop', 'implicit',
                                    'nchwToNhwc', 'nhwcToNchw')),
                   ('cuBLAS GEMM', ('gemm', 'nvjet', 'cutlass')),
                   ('reduction', ('reduce_kernel',)),
                   ('elementwise and copies', ('elementwise', 'copy',
                                               'Memcpy', 'Memset')))


def log(line):
    print(line, flush=True)


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def phase_facts():
    if not torch.cuda.is_available():
        raise SystemExit('FAIL facts: torch.cuda.is_available() is false')
    smi = smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), '--version'],
                          capture_output=True, text=True, check=True)
    log(f'phase 1 facts: ok | nvidia-smi: {smi} | torch {torch.__version__} '
        f'cuda {torch.version.cuda} | devices {torch.cuda.device_count()} | '
        f'nvcc: {nvcc.stdout.strip().splitlines()[-1]}')
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    ptxas = [ln.strip() for ln in lib.with_suffix('.log').read_text()
             .splitlines() if 'registers' in ln or 'spill' in ln]
    log(f'phase 2 build: ok in {time.perf_counter() - t0:.1f} s -> '
        f'{lib.name} | ptxas: {" / ".join(ptxas)}')


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
    q, k, v = flux_qkv
    ms = cuda_ms(lambda: attn.flash_attention_fwd(q, k, v), 20)
    plain_ms = cuda_ms(lambda: attn.attention_ref(q, k, v), 5)
    b, s, h, d = FLUX_SHAPE
    tflops = 4 * b * h * s * s * d / (ms * 1e-3) / 1e12
    log(f'phase 3 attention kernel vs plain: ok | {" ; ".join(parts)} | '
        f'FLUX shape: '
        f'kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain fp32 '
        f'{plain_ms:.4f} ms')
    return worst, ms, plain_ms


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


def phase_w4a8_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 3)
    cases = [(m, k, n, 128) for m, k, n in W4A8_SHAPES] + [
        (777, 3072, 3072, 128), (130, 512, 264, 32), (3, 320, 136, 64)]
    worst, worst_rel = 0.0, 0.0
    for m, k, n, group in cases:
        err, rel = w4a8_check(*w4a8_case(g, m, k, n, group))
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
    timed = []
    for m, k, n in W4A8_TIMED:
        xq, _, packed, scale = w4a8_case(g, m, k, n)
        ms = cuda_ms(lambda: qmm.w4a8_matmul(xq, packed, scale), 20)
        plain_ms = cuda_ms(lambda: qmm.w4a8_matmul_ref(xq, packed, scale), 3)
        timed.append(dict(shape=[m, k, n], ms=ms, plain_ms=plain_ms,
                          tops=2 * m * k * n / (ms * 1e-3) / 1e12))
    log(f'phase 4 w4a8 kernel vs plain: ok | {len(cases) + 1} cases (path '
        f'shapes, M 777, groups 32/64, -8 nibbles) max|d| {worst:.3e}, max '
        f'|d| / sum|x||w|scale {worst_rel:.3e} (bound {W4A8_TOL}) | '
        + ' ; '.join(f'M{t["shape"][0]} K{t["shape"][1]} N{t["shape"][2]}: '
                     f'kernel {t["ms"]:.4f} ms ({t["tops"]:.1f} TOP/s), '
                     f'plain fp32 {t["plain_ms"]:.4f} ms' for t in timed))
    return worst, timed


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
    return launches


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


def phase_qwen_full():
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
    out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
    launches = counts()
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
    if not torch.isfinite(lat).all():
        raise AssertionError('non-finite latents')
    t_dec = timed_decode(pipe.vae, lat)
    wall, busy, by_name = profile_split(
        lambda: pipe(prompt_embeds=embeds, latents=latents, output_type='pt'))
    total = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    families = {}                           # family: (ms, calls, top name)
    for name, (ms, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        family = next((f for f, keys in KERNEL_FAMILIES
                       if any(key in name for key in keys)), 'other')
        f_ms, f_calls, f_top = families.get(family, (0.0, 0, name))
        families[family] = (f_ms + ms, f_calls + calls, f_top)
    log(f'phase 8 Qwen full slice (ArcQwen {n_params / 1e9:.2f}B params, '
        f'{n_int4} int4 layers w4a8, 2-NFE 1024x1024 + Wan decode): ok | '
        f'image {tuple(img.shape)} finite, range [{img.min().item():.3f}, '
        f'{img.max().item():.3f}], max|run1 - run2| {rerun:.3e} | launches '
        f'{launches} | build + quantize {t_build:.1f} s, resident after '
        f'quantize {resident_gib:.2f} GiB, cold run {t_cold:.3f} s | warm per '
        f'image {t_e2e:.4f} s: transformer + integration {t_dit:.4f} s, '
        f'decode {t_dec:.4f} s | peak memory {peak_gib:.2f} GiB')
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


def main():
    smi = phase_facts()
    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    attn_err, attn_ms, attn_plain_ms = phase_kernel_vs_plain()
    w4a8_err, w4a8_timed = phase_w4a8_vs_plain()
    phase_reduced_slice()
    torch.cuda.empty_cache()
    flux_launches = phase_full_slice()
    gc.collect()                            # the FLUX model goes first
    torch.cuda.empty_cache()
    phase_qwen_reduced()
    gc.collect()
    torch.cuda.empty_cache()
    qwen_launches = phase_qwen_full()
    ff_in = w4a8_timed[0]
    print(json.dumps({'kernels': [
        {'name': 'attention_fwd', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/attention_fwd.cu',
         'replaces': 'arcflow_tpu/models/layers.py:525',
         'launches': flux_launches + qwen_launches['attention'],
         'launches_by_path': {'flux': flux_launches,
                              'qwen': qwen_launches['attention']},
         'max_abs_err': attn_err, 'ms': attn_ms, 'plain_ms': attn_plain_ms,
         'shape': list(FLUX_SHAPE)},
        {'name': 'w4a8_matmul', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/w4a8_matmul.cu',
         'replaces': 'arcflow_tpu/ops/quant_matmul.py:88',
         'launches': qwen_launches['w4a8'],
         'launches_by_path': {'qwen': qwen_launches['w4a8']},
         'max_abs_err': w4a8_err, 'ms': ff_in['ms'],
         'plain_ms': ff_in['plain_ms'], 'shape': ff_in['shape'],
         'timed': w4a8_timed}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
