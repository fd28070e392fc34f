#!/usr/bin/env python3
"""Time the port's redesigned kernels of one or more checkouts in turns, on
one CUDA card: K1 (unmasked) and K2 (the Qwen key mask) forward and K3
backward at the FLUX shape of ``chip_smoke.py``, beside PyTorch's SDPA; K4
at one middle hop of the FLUX ring (sp = 4), with the host time to issue
one hop (the wrapper, and its C entry point within it); K5 at every shape
of ``chip_smoke.W4A8_SHAPES``, with fp32 output and, where the checkout
has them, with the row scale and bf16 output of the Qwen path.

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
    over ``iters`` calls of ``fn`` under ``torch.profiler``, after two
    warm-up calls, as ``chip_smoke.kernel_ms`` takes it (kept here so that
    a parent checkout without it can be timed the same way)."""
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
              and name in e.name]
        if len(us) == iters or (attempt == 2 and 2 * len(us) >= iters):
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
    res['root'] = os.getcwd()
    print(json.dumps(res), flush=True)


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
