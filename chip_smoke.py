#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (arcflow_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it imports nothing of JAX. Phases, one
line each, and any failure exits non-zero:

1. facts: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile the attention kernel from ``arcflow_tpu_torch/csrc``;
3. kernel vs plain: the kernel against ``attention_ref`` at the FLUX shape
   (B1 S4608 H24 D128), a ragged S and a key-padded case, and both timed at
   the FLUX shape;
4. the slice at reduced depth (1 joint + 1 single block) and full width, in
   bf16: one forward through the kernel, the same weights through the plain
   attention, ``means`` compared by relative L2;
5. the slice at full geometry: FLUX-12B ArcFlux (19 + 38 blocks, 24 x 128,
   K=16, guidance embeds) and the full FLUX VAE decoder with random bf16
   weights from a seed, 2-NFE at 1024x1024 from random prompt embeds through
   ``ArcFluxPipeline.__call__``; the image must be finite, (1, 1024, 1024, 3),
   and the run must launch the kernel exactly 2 x 57 times.

Then one JSON line of per-kernel numbers, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from unittest import mock

import torch

from arcflow_tpu_torch.models import ArcFluxTransformer2DModel, PretrainedVAE
from arcflow_tpu_torch.ops import _build
from arcflow_tpu_torch.ops import attention as attn
from arcflow_tpu_torch.pipelines import ArcFluxPipeline

SEED = 0
FLUX_12B = dict(in_channels=64, num_layers=19, num_single_layers=38,
                attention_head_dim=128, num_attention_heads=24,
                joint_attention_dim=4096, pooled_projection_dim=768,
                num_gaussians=16, lora_rank=0)
FLUX_SHAPE = (1, 4608, 24, 128)
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
    log(f'phase 3 kernel vs plain: ok | {" ; ".join(parts)} | FLUX shape: '
        f'kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain fp32 '
        f'{plain_ms:.4f} ms')
    return worst, ms, plain_ms


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
    log(f'phase 4 reduced slice (1+1 blocks, full width, bf16): ok | means '
        f'{tuple(fast.shape)} rel L2 kernel vs plain {rel:.3e} '
        f'(bound {SLICE_REL_L2}) | kernel launches {n_fast}')


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

    def run(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe(prompt_embeds=embeds, latents=latents, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    attn.LAUNCHES = 0
    first, t_cold = run(output_type='pt')
    if attn.LAUNCHES != want:
        raise AssertionError(f'cold run: {attn.LAUNCHES} launches, '
                             f'want {want}')
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0                       # the main path's counted run
    out, t_e2e = run(output_type='pt')
    launches = attn.LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != want:
        raise AssertionError(f'{launches} kernel launches, want {want}')
    img = out['images']
    if tuple(img.shape) != (1, 1024, 1024, 3):
        raise AssertionError(f'image shape {tuple(img.shape)}')
    if not torch.isfinite(img).all():
        raise AssertionError('non-finite image')
    lat, t_dit = run(output_type='latent')
    lat = lat['latents']
    if not torch.isfinite(lat).all():
        raise AssertionError('non-finite latents')
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe.vae.decode(lat)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t
    rerun = (first['images'] - img).abs().max().item()
    log(f'phase 5 full slice (FLUX-12B ArcFlux {n_params / 1e9:.2f}B params '
        f'bf16, 2-NFE 1024x1024 + VAE decode): ok | image '
        f'{tuple(img.shape)} finite, range [{img.min().item():.3f}, '
        f'{img.max().item():.3f}], max|run1 - run2| {rerun:.3e} | kernel '
        f'launches {launches} | build {t_build:.1f} s, cold run '
        f'{t_cold:.3f} s | warm per image {t_e2e:.4f} s: transformer + '
        f'integration {t_dit:.4f} s, decode {t_dec:.4f} s | peak memory '
        f'{peak_gib:.2f} GiB')
    return launches


def main():
    smi = phase_facts()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    worst, ms, plain_ms = phase_kernel_vs_plain()
    phase_reduced_slice()
    torch.cuda.empty_cache()
    launches = phase_full_slice()
    print(json.dumps({'kernels': [{
        'name': 'attention_fwd', 'route': 'cuda',
        'source': 'arcflow_tpu_torch/csrc/attention_fwd.cu',
        'replaces': 'arcflow_tpu/models/layers.py:525',
        'launches': launches, 'max_abs_err': worst, 'ms': ms,
        'plain_ms': plain_ms}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
