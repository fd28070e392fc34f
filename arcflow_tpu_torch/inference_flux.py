"""2-NFE ArcFlow-FLUX inference CLI of the port:

    python -m arcflow_tpu_torch.inference_flux --model-dir DIR
        [--adapter FILE] [--vae-dir DIR] [--prompt TEXT | --prompt-embeds NPZ]
        [--height H --width W --nfe N --temperature T --guidance G --seed S]
        [--int8 | --w8a8 | --int4 | --w4a8]
        [--mesh AXIS=N,... --sp-mode MODE]
        [--out FILE] [--device cuda|cpu]

The root ``inference_flux.py`` with ``--device``. ``--model-dir`` is a
local diffusers folder: a whole pipeline (``model_index.json``: transformer,
VAE, text towers, tokenizers, scheduler) or a transformer alone, with the
VAE from ``--vae-dir`` and the text towers from the hub names of
``PretrainedFluxTextEncoder``, which must already be on local disk (nothing
is downloaded). ``--prompt-embeds`` (an ``.npz`` of the transformer's
conditioning) skips the text towers. The adapter is merged before any
quantization. With a VAE the image is written as PNG, else the latents as
``.npy``. It runs on the card and exits 2 without one, unless ``--device
cpu`` is given.

``--mesh`` serves over the processes of ``torch.distributed.run`` (one
card each), which the CLI joins into a process group and leaves at the
end: ``python -m torch.distributed.run --nproc-per-node 4 -m
arcflow_tpu_torch.inference_flux --mesh fsdp=4 ...`` (axes data, fsdp,
tensor, sp, pipe, expert, as ``ArcFluxPipeline.shard`` takes them). Every
rank makes the same image; rank 0 writes it.
"""

import argparse
import struct
import sys
import zlib

import numpy as np
import torch
import torch.distributed as dist

from arcflow_tpu_torch.parallel import setup_distributed

FAMILIES = {
    'flux': dict(pipeline='ArcFluxPipeline',
                 prompt='a photo of an astronaut riding a horse on the moon'),
    'qwen': dict(pipeline='ArcQwenImagePipeline',
                 prompt='a serene mountain lake at sunrise'),
}


def parse_args(argv=None, family: str = 'flux'):
    p = argparse.ArgumentParser(
        description=f'2-NFE ArcFlow {family} inference with the PyTorch port')
    p.add_argument('--model-dir', required=True,
                   help='local diffusers pipeline or transformer folder')
    p.add_argument('--adapter', default=None,
                   help='exported ArcFlow adapter (.safetensors)')
    p.add_argument('--vae-dir', default=None,
                   help='local diffusers VAE folder (transformer folders)')
    p.add_argument('--prompt', default=FAMILIES[family]['prompt'])
    p.add_argument('--prompt-embeds', default=None,
                   help='.npz of cached prompt embeddings; skips the text '
                        'towers')
    p.add_argument('--height', type=int, default=1024)
    p.add_argument('--width', type=int, default=1024)
    p.add_argument('--nfe', type=int, default=2)
    p.add_argument('--temperature', type=float, default=1.0)
    if family == 'flux':
        p.add_argument('--guidance', type=float, default=3.5)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--int8', action='store_true',
                   help='weight-only int8 transformer')
    p.add_argument('--w8a8', action='store_true',
                   help='int8 weights and per-token int8 activations')
    p.add_argument('--int4', action='store_true',
                   help='weight-only int4 (group-128 scales)')
    p.add_argument('--w4a8', action='store_true',
                   help='int4 weights and per-token int8 activations')
    p.add_argument('--mesh', default=None,
                   help="multi-card serving mesh over the processes of "
                        "torch.distributed.run, e.g. 'sp=4,tensor=2' "
                        "(single-image latency) or 'fsdp=4,tensor=2' "
                        "(weight sharding); axes: data/fsdp/tensor/sp/pipe/"
                        "expert")
    p.add_argument('--sp-mode', choices=('ulysses', 'ring'),
                   default='ulysses')
    p.add_argument('--out', default='output.png')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='serve on the card (default) or, for tests, on the '
                        'CPU')
    return p.parse_args(argv)


def write_png(path: str, image: np.ndarray) -> None:
    """(H, W, 3) values in [0, 1] -> an 8-bit RGB PNG (zlib only)."""
    rgb = np.round(np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
    h, w, _ = rgb.shape
    raw = b''.join(b'\x00' + rgb[i].tobytes() for i in range(h))

    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(raw, 6)) + chunk(b'IEND', b''))


def build_pipeline(args, family: str, device=None):
    """The pipeline of ``--model-dir`` on ``device`` (``--device`` by
    default), with the adapter merged, then quantized and sharded as the
    flags ask."""
    import os
    from arcflow_tpu_torch import models, pipelines
    cls = getattr(pipelines, FAMILIES[family]['pipeline'])
    device = torch.device(args.device) if device is None else device
    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    kw = dict(nfe=args.nfe, temperature=args.temperature, device=device,
              dtype=dtype)
    if family == 'flux':
        kw['guidance_scale'] = args.guidance
    if not os.path.exists(os.path.join(args.model_dir, 'model_index.json')):
        if args.vae_dir:
            import json
            with open(os.path.join(args.vae_dir, 'config.json')) as f:
                name = json.load(f).get('_class_name', '')
            kw['vae'] = cls._load_vae_folder(args.vae_dir, name,
                                             device=device, dtype=dtype)
        if args.prompt_embeds is None:
            encoder = models.PretrainedFluxTextEncoder if family == 'flux' \
                else models.PretrainedQwenImageTextEncoder
            kw['text_encoder'] = encoder(device=device, dtype=dtype)
    pipe = cls.from_pretrained(args.model_dir, **kw)
    if args.adapter:
        pipe.load_arcflow_adapter(args.adapter)
    if args.int4 or args.w4a8:
        pipe.quantize_int4(act_quant=args.w4a8)
    elif args.int8 or args.w8a8:
        pipe.quantize_int8(act_quant=args.w8a8)
    if args.mesh:
        axes = {k: int(v) for k, v in
                (kv.split('=') for kv in args.mesh.split(','))}
        mesh = pipe.shard(axes, sp_mode=args.sp_mode)
        print(f'serving mesh: {axes} ({args.sp_mode}), process groups '
              f'{mesh}')
    return pipe, device


def main(argv=None, family: str = 'flux'):
    args = parse_args(argv, family)
    module = f'arcflow_tpu_torch.inference_{family}'
    if args.device == 'cuda' and not torch.cuda.is_available():
        print(f'{module}: no CUDA device is available; pass --device cpu to '
              f'serve on the CPU', file=sys.stderr)
        return 2
    started = args.mesh is not None and not dist.is_initialized()
    device = setup_distributed(args.device) if started else None
    try:
        return _serve(args, family, device)
    finally:
        if started:
            dist.destroy_process_group()


def _serve(args, family: str, device) -> int:
    pipe, device = build_pipeline(args, family, device)
    print(f'device: {device}' + (f' ({torch.cuda.get_device_name(device)})'
                                 if device.type == 'cuda' else ''))
    embeds = None
    if args.prompt_embeds:
        embeds = {k: torch.from_numpy(v).to(device)
                  for k, v in np.load(args.prompt_embeds).items()}
    generator = torch.Generator(device).manual_seed(args.seed)
    has_vae = pipe.vae is not None
    out = pipe(prompt=None if embeds else [args.prompt],
               prompt_embeds=embeds, height=args.height, width=args.width,
               generator=generator,
               output_type='np' if has_vae else 'latent')
    path = args.out
    if dist.is_initialized() and dist.get_rank() != 0:
        return 0
    if has_vae:
        write_png(path, out['images'][0])
    else:
        path = path if path.endswith('.npy') else path + '.npy'
        np.save(path, out['latents'].float().cpu().numpy())
    print(f'saved {path}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
