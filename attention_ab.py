#!/usr/bin/env python3
"""Time the port's attention kernels of one or more checkouts in turns, on
one CUDA card: K1 (unmasked) and K2 (the Qwen key mask) forward and K3
backward at the FLUX shape of ``chip_smoke.py``, beside PyTorch's SDPA.

    python3 attention_ab.py [ROOT ...]

Each ROOT (default: this checkout) is the root of a checkout of this
repository; its ``chip_smoke`` (the timing helper ``cuda_ms``, ``sdpa``, the
shape and key count) and ``arcflow_tpu_torch`` are imported in a fresh
process, which builds that checkout's kernels at first use. Give the roots
in the order to run them, for example ``parent change change parent``, so
that both sides meet the card in the same state. Prints the card's name and power limit,
then one JSON line per run; exits non-zero without a CUDA card.
"""

import json
import os
import subprocess
import sys


def run_one():
    """Time the kernels of the checkout in the working directory, with that
    checkout's own ``chip_smoke`` timing helpers, shape and key count."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as smoke
    attn = smoke.attn

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
