#!/usr/bin/env python3
"""Time the port's redesigned kernels of one or more checkouts in turns, on
one CUDA card: K1 (unmasked) and K2 (the Qwen key mask) forward and K3
backward at the FLUX shape of ``chip_smoke.py``, beside PyTorch's SDPA; K4
at one middle hop of the FLUX ring (sp = 4), with the host time to issue
one hop (the wrapper, and its C entry point within it); K5 at every shape
of ``chip_smoke.W4A8_SHAPES``, with fp32 output and, where the checkout
has them, with the row scale and bf16 output of the Qwen path; K7 at the
FLUX shape (the kernel, the call with its q and k quantization, and the
quantization alone); K6 at the KR transport's axis and at 64 times it (the
kernel's device time and the call with its wrapper) and one warm KR call
(``chip_smoke.timed_kr``), and, where the checkout's K6 has the
Abramowitz-Stegun erf, K6 built both ways (that erf and CUDA's ``erff``)
with each one's error against the plain version;
and, where the checkout's K7 runs on ``wgmma_ss_s8``, K7's split: its
source built again with one part of its work taken out at a time (the key
scale, the convert and both scales, the exp2 of the softmax, the QK^T
product, the P.V product), each build's device time beside the whole
kernel's and K1's. Those builds compute nothing useful; they say where the
time goes.

    python3 attention_ab.py [ROOT ...]

Each ROOT (default: this checkout) is the root of a checkout of this
repository; its ``chip_smoke`` (the timing helper ``cuda_ms``, ``sdpa``, the
shapes, key count and input makers) and ``arcflow_tpu_torch`` are imported
in a fresh process, which builds that checkout's kernels at first use. Give
the roots in the order to run them, for example ``parent change change
parent``, so that both sides meet the card in the same state. K4 and K5 are
timed as device time per launch by ``torch.profiler`` (``kernel_ms``
below), which short calls need: CUDA events around them see the host's
launch cost. Prints the card's name and power limit, then one JSON line per
run; exits non-zero without a CUDA card.
"""

import inspect
import json
import os
import subprocess
import sys


def kernel_ms(torch, fn, name, iters):
    """Mean device time per launch of the kernel whose name holds ``name``
    (per call, of every kernel the call runs, with ``name`` None) over
    ``iters`` calls of ``fn`` under ``torch.profiler``, after two warm-up
    calls, as ``chip_smoke.kernel_ms`` takes it (kept here so that a parent
    checkout without it can be timed the same way)."""
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
    raise AssertionError(f'{len(us)} launches of {name} in {iters} calls')


def host_ms(torch, fn, lib, entry, iters):
    """Mean host time per call of ``fn`` and of the C entry point ``entry``
    of ``lib`` inside it, on the host clock, over ``iters`` calls issued
    without a wait between them (after two warm-up calls): what the host
    spends to issue a launch. Returns (call ms, entry point ms)."""
    import time
    from unittest import mock
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    real, spent = getattr(lib, entry), [0.0]

    def timed(*args):
        t = time.perf_counter()
        try:
            return real(*args)
        finally:
            spent[0] += time.perf_counter() - t
    with mock.patch.object(lib, entry, timed):
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        total = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * total / iters, 1e3 * spent[0] / iters


def run_one():
    """Time the kernels of the checkout in the working directory, with that
    checkout's own ``chip_smoke`` timing helpers, shapes and inputs."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as smoke
    attn, hop, qmm = smoke.attn, smoke.hop, smoke.qmm

    g = torch.Generator(device='cuda').manual_seed(0)
    q, k, v, do = (torch.randn(smoke.FLUX_SHAPE, generator=g, device='cuda',
                               dtype=torch.bfloat16) for _ in range(4))
    masked = torch.arange(smoke.FLUX_SHAPE[1], device='cuda')[None] < \
        smoke.QWEN_VALID_KEYS
    o, lse = attn.flash_attention_fwd(q, k, v, return_lse=True)
    with torch.inference_mode():
        res = dict(
            k1_ms=smoke.cuda_ms(lambda: attn.flash_attention_fwd(q, k, v),
                                20),
            k2_ms=smoke.cuda_ms(
                lambda: attn.flash_attention_fwd(q, k, v, masked), 20),
            sdpa_ms=smoke.cuda_ms(lambda: smoke.sdpa(q, k, v), 20),
            sdpa_masked_ms=smoke.cuda_ms(lambda: smoke.sdpa(q, k, v, masked),
                                         20))
    res['k3_ms'] = smoke.cuda_ms(
        lambda: attn.flash_attention_bwd(q, k, v, o, do, lse), 10)
    a = attn.flash_attention_bwd(q, k, v, o, do, lse)
    b = attn.flash_attention_bwd(q, k, v, o, do, lse)
    res['k3_bitwise_repeatable'] = all(map(torch.equal, a, b))

    # K4: one middle hop of the FLUX ring, the carry read and written
    b, s, h, _ = smoke.FLUX_SHAPE
    sq = s // smoke.SP
    qh = torch.randn(b, sq, h, 128, generator=g, device='cuda',
                     dtype=torch.bfloat16)
    kh, vh, _ = smoke.hop_case(g, b, sq, h)
    carry, _ = hop.ring_hop(qh, kh, vh)
    res['k4_middle_hop_ms'] = kernel_ms(
        torch, lambda: hop.ring_hop(qh, kh, vh, None, carry), 'ring_hop', 50)
    res['k4_host_ms'], res['k4_entry_host_ms'] = host_ms(
        torch, lambda: hop.ring_hop(qh, kh, vh, None, carry),
        smoke._build.load_library(), 'arcflow_ring_hop', 200)

    # K5 at every shape of the Qwen-Image w4a8 path, fp32 out (the form
    # every side has) and, where the checkout has it, the form the path
    # calls (row scale, bf16 out)
    fused = 'row_scale' in inspect.signature(qmm.w4a8_matmul).parameters
    res['k5_ms'], res['k5_fused_ms'] = {}, {}
    for m, kk, n in smoke.W4A8_SHAPES:
        xq, _, packed, scale = smoke.w4a8_case(g, m, kk, n)
        xs = 0.001 + 0.01 * torch.rand(m, 1, generator=g, device='cuda')
        res['k5_ms'][f'{m}x{kk}x{n}'] = kernel_ms(
            torch, lambda: qmm.w4a8_matmul(xq, packed, scale), 'w4a8_matmul',
            10)
        if fused:
            res['k5_fused_ms'][f'{m}x{kk}x{n}'] = kernel_ms(
                torch, lambda: qmm.w4a8_matmul(
                    xq, packed, scale, row_scale=xs,
                    out_dtype=torch.bfloat16), 'w4a8_matmul', 10)
    k7(torch, smoke, g, res)
    k6(torch, smoke, g, res)
    src = smoke._build.CSRC_DIR / 'flash_int8.cu'
    if 'wgmma_ss_s8' in src.read_text():
        res['k7_split_ms'] = k7_split(torch, smoke, g, src)
    res['root'] = os.getcwd()
    print(json.dumps(res), flush=True)


def k7(torch, smoke, g, res):
    """K7 at the FLUX shape: the kernel on prepared operands (CUDA events),
    the call that quantizes q and k first, and the quantization alone
    (device time of all its kernels, and CUDA events)."""
    fi8 = smoke.fi8
    q, k, v = (torch.randn(smoke.FLUX_SHAPE, generator=g, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    qq, qs, kq, ks = fi8.quantize_qk(q, k)
    sm = q.shape[-1] ** -0.5
    res['k7_ms'] = smoke.cuda_ms(
        lambda: fi8.launch(qq, qs, kq, ks, v, None, sm, q.dtype), 20)
    res['k7_call_ms'] = smoke.cuda_ms(
        lambda: fi8.flash_attention_int8(q, k, v), 20)
    res['k7_quant_device_ms'] = kernel_ms(
        torch, lambda: fi8.quantize_qk(q, k), None, 20)
    res['k7_quant_ms'] = smoke.cuda_ms(lambda: fi8.quantize_qk(q, k), 50)


# K7's parts, each taken out of its source by one replacement (old, new)
K7_PARTS = {
    'no key scale': (
        's[e] = keep ? (float)sc[e] * q_scale[i] * k_scale : fill;',
        's[e] = keep ? (float)sc[e] * q_scale[i] : fill;'),
    'no convert or scales': (
        's[e] = keep ? (float)sc[e] * q_scale[i] * k_scale : fill;',
        's[e] = keep ? __int_as_float(sc[e]) : fill;'),
    'no exp2': (
        's[4 * n + e] = exp2f(s[4 * n + e] - m_row[e >> 1]);',
        's[4 * n + e] = s[4 * n + e] - m_row[e >> 1];'),
    'no QK^T product': (
        """        wgmma_ss_s8(sc, make_desc(cQ + kk * 32, 16, 1024),
                    make_desc(cK + kk * 32, 16, 1024), kk > 0);""",
        """        if (kk == 0)
          for (int e = 0; e < kBlockN / 2; ++e) sc[e] = e * (lane + j);"""),
    'no P.V product': (
        """        wgmma_rs_n128<1>(o_acc, pf[kk],
                         make_desc(cV + kk * 16 * 128, kVBoxBytes, 1024), 1);""",
        """        o_acc[kk] += __uint_as_float(pf[kk][0] ^ pf[kk][1] ^ pf[kk][2]
                                     ^ pf[kk][3]);"""),
}


def k7_split(torch, smoke, g, src):
    """K7's device time at the FLUX shape as built and with each of
    ``K7_PARTS`` taken out (each build compiled from a patched copy of
    ``src`` into its own library, all in parallel, and loaded in place of
    the checkout's library for its launches), beside K1's."""
    import ctypes
    import types
    from unittest import mock
    _build, fi8 = smoke._build, smoke.fi8
    real = _build.load_library()
    text = src.read_text()
    builds = {}
    for name, (old, new) in K7_PARTS.items():
        if text.count(old) != 1:
            raise AssertionError(f'K7 part "{name}": its code is not in '
                                 f'{src} once')
        stem = 'k7_' + ''.join(c if c.isalnum() else '_' for c in name)
        cu = _build.BUILD_DIR / f'{stem}.cu'
        so = _build.BUILD_DIR / f'{stem}.so'
        patched = text.replace(old, new)
        if so.exists() and cu.exists() and cu.read_text() == patched:
            builds[name] = (so, None)       # built by an earlier run
            continue
        cu.write_text(patched)
        so.unlink(missing_ok=True)
        builds[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, '-I',
             str(_build.CSRC_DIR), '-shared', '-o', str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    q, k, v = (torch.randn(smoke.FLUX_SHAPE, generator=g, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    qq, qs, kq, ks = fi8.quantize_qk(q, k)
    sm = q.shape[-1] ** -0.5

    def k7_ms():
        return kernel_ms(torch, lambda: fi8.launch(
            qq, qs, kq, ks, v, None, sm, q.dtype), 'flash_int8_kernel', 20)
    out = {'as built': k7_ms(), 'K1': kernel_ms(
        torch, lambda: smoke.attn.flash_attention_fwd(q, k, v),
        'attention_fwd', 20)}
    for name, (so, proc) in builds.items():
        _, err = proc.communicate() if proc else (None, None)
        if proc and proc.returncode != 0:
            raise RuntimeError(f'K7 part "{name}" did not build: '
                               f'{err.decode()[-2000:]}')
        fn = ctypes.CDLL(str(so)).arcflow_flash_int8
        fn.argtypes = real.arcflow_flash_int8.argtypes
        fn.restype = ctypes.c_int
        lib = types.SimpleNamespace(
            arcflow_flash_int8=fn,
            arcflow_cuda_error_string=real.arcflow_cuda_error_string)
        with mock.patch.object(_build, 'load_library', lambda: lib):
            out[name] = k7_ms()
    return out


def k6(torch, smoke, g, res):
    """K6 at the KR axis and at 64 times it: the kernel's device time on
    the checkout's own launch form, the call with its wrapper (CUDA
    events), then one warm KR call on the host clock (best of five)."""
    icdf = smoke.icdf
    for name, hw in (('kr_axis', smoke.KR_LATENT[:2]),
                     ('large', smoke.K6_LARGE_HW)):
        args = smoke.k6_case(g, hw)
        if hasattr(icdf, 'kernel_geometry'):
            geom = icdf.kernel_geometry(*args)
            fn = lambda: icdf.launch(geom, smoke.KR_STEPS, 1e-6, 1.5)
        else:
            rows, _ = icdf.kernel_layout(*args)
            fn = lambda: icdf.launch(rows, smoke.KR_STEPS, 1e-6, 1.5)
        res[f'k6_{name}_ms'] = kernel_ms(torch, fn, 'gm_inverse_cdf', 50)
        res[f'k6_{name}_call_ms'] = smoke.cuda_ms(
            lambda: icdf.gm1d_inverse_cdf_kernel(
                *args, n_steps=smoke.KR_STEPS), 50)
    gm, z = smoke.kr_mixture(g)
    smoke.timed_kr(gm, z)
    res['kr_call_s'] = min(smoke.timed_kr(gm, z)[1] for _ in range(5))
    src = smoke._build.CSRC_DIR / 'gm_inverse_cdf.cu'
    if all(old in src.read_text() for old, _ in K6_ERFF):
        res['k6_erf_variants'] = k6_erf_variants(torch, smoke, g, src)


# K6 with CUDA's erff, and a second ex2 for the pdf, in place of its
# Abramowitz-Stegun erf: replacements (old, new) of its source
K6_ERFF = (
    ('      pw[c] = expf(lw - ls);', '      pw[c] = (lw - ls) * kLog2e;'),
    ('      pw[c] = 0.f;', '      pw[c] = -INFINITY;'),
    ("""      const float ex = ex2_approx(-kLog2e * x * x);   // exp(-nd^2 / 2)
      pdf = fmaf(pw[c], ex, pdf);
      cdf = fmaf(wt[c], erf_as(x, ex), cdf);""",
     """      pdf += ex2_approx(fmaf(-kLog2e * x, x, pw[c]));
      cdf = fmaf(wt[c], erff(x), cdf);"""))


def k6_erf_variants(torch, smoke, g, src):
    """K6 built alone twice, from ``src`` (its Abramowitz-Stegun erf) and
    from a copy with ``K6_ERFF`` applied (CUDA's erff), each loaded in place
    of the checkout's library for its launches: device ms at the KR axis
    and at 64 times it, and the largest error against the plain version
    over the unsaturated elements (``chip_smoke.k6_check``'s bound)."""
    import ctypes
    from unittest import mock
    _build, icdf = smoke._build, smoke.icdf
    real = _build.load_library()
    text = src.read_text()
    erff = text
    for old, new in K6_ERFF:
        erff = erff.replace(old, new)
    out = {}
    for variant, source in (('as_erf', text), ('erff', erff)):
        cu = _build.BUILD_DIR / f'k6_{variant}.cu'
        so = _build.BUILD_DIR / f'k6_{variant}.so'
        if not (so.exists() and cu.exists() and cu.read_text() == source):
            cu.write_text(source)
            subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                            '-shared', '-o', str(so), str(cu)], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.arcflow_gm_inverse_cdf.argtypes = \
            real.arcflow_gm_inverse_cdf.argtypes
        lib.arcflow_gm_inverse_cdf.restype = ctypes.c_int
        lib.arcflow_cuda_error_string = real.arcflow_cuda_error_string
        with mock.patch.object(_build, 'load_library', lambda: lib):
            for name, hw in (('kr_axis', smoke.KR_LATENT[:2]),
                             ('large', smoke.K6_LARGE_HW)):
                args = smoke.k6_case(g, hw)
                geom = icdf.kernel_geometry(*args)
                out[f'{variant}_{name}_ms'] = kernel_ms(
                    torch, lambda: icdf.launch(geom, smoke.KR_STEPS, 1e-6,
                                               1.5), 'gm_inverse_cdf', 50)
                got = icdf.gm1d_inverse_cdf_kernel(*args,
                                                   n_steps=smoke.KR_STEPS)
                ref = icdf.gm1d_inverse_cdf_ref(*args,
                                                n_steps=smoke.KR_STEPS)
                means, lw, _, logstds, tgt, _ = args
                pdf, _ = smoke.gm_ops.gm1d_pdf_cdf(dict(
                    means=means, logstds=logstds, logweights=lw), ref)
                uns = tgt.abs() < 0.999
                err = (got - ref).abs()
                over = err - smoke.K6_ATOL - smoke.K6_CDF_TOL / (2 * pdf)
                out[f'{variant}_{name}_max_err'] = err[uns].max().item()
                out[f'{variant}_{name}_worst_past_bound'] = \
                    over[uns].max().item()
    return out


def main():
    if '--one' in sys.argv:
        run_one()
        return 0
    import torch
    if not torch.cuda.is_available():
        print('FAIL: no CUDA card', file=sys.stderr)
        return 1
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    for root in sys.argv[1:] or ['.']:
        subprocess.run([sys.executable, me, '--one'], cwd=root, check=True,
                       timeout=600)
    return 0


if __name__ == '__main__':
    sys.exit(main())
