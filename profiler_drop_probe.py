"""Does one large ``torch.profiler`` trace make later short traces drop
kernel records?

Counts the kernel records that ``torch.profiler`` (CPU and CUDA activity,
as ``chip_smoke.kernel_ms`` traces) keeps of 50 calls of the flash-SDPA
kernel at the FLUX ring-hop shape (B1 S1152 H24 D128, bf16), three
windows, and the same with 0.1 s of idle window at each end; first on a
fresh process, then after each trace of ``N`` tiny kernels (an in-place
add on 256 floats). Prints the card's name and power limit and one JSON
object of the counts. Needs one CUDA card and nothing of the repo:

    python3 profiler_drop_probe.py [N ...]     # default 170000 250000
"""

import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile


def records(fn, iters, name=None, pad=0.0):
    """Kernel records (those whose name holds ``name``) that one profiler
    window keeps of ``iters`` calls of ``fn``."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (name is None or name in e.name))


def main():
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    sizes = [int(n) for n in sys.argv[1:]] or [170_000, 250_000]
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(f'card: {smi} | torch {torch.__version__} cuda '
          f'{torch.version.cuda}', flush=True)
    q, k, v = (torch.randn(1, 24, 1152, 128, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))

    def flash():
        return torch.ops.aten._scaled_dot_product_flash_attention(q, k, v)

    def yardstick(tag):
        flash()
        flash()
        torch.cuda.synchronize()
        plain = [records(flash, 50, 'flash') for _ in range(3)]
        padded = [records(flash, 50, 'flash', pad=0.1) for _ in range(3)]
        print(f'{tag}: flash records kept of 50 calls {plain}, with 0.1 s '
              f'of idle window at each end {padded}', flush=True)
        return dict(plain=plain, padded=padded)

    out = dict(before=yardstick('fresh process'))
    x = torch.zeros(256, device='cuda')
    for n in sizes:
        t = time.perf_counter()
        kept = records(lambda: x.add_(1), n)
        print(f'one trace of {n} tiny kernels: {kept} records kept, '
              f'{time.perf_counter() - t:.1f} s', flush=True)
        out[str(n)] = dict(kept=kept, **yardstick(f'after {n}'))
    print(json.dumps(out))


if __name__ == '__main__':
    main()
