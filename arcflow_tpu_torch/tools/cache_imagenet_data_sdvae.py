"""Cache SD-VAE latents of an ImageNet-style image folder (one folder per
class) for ``data/imagenet.py:ImageNet``'s latents mode (the JAX package's
``tools/cache_imagenet_data_sdvae.py``): the images of shard ``--shard`` of
``--num-shards``, ADM center-cropped to ``--image-size``, are encoded in
batches on ``--device`` (the card unless ``cpu``) by the port's
``PretrainedVAEEncoder`` (4 latent channels, scale 0.18215, shift 0, the
posterior mean) and written one record per image,
``<8-digit index>.npz`` with ``x`` (C, H, W) fp32 and ``y`` (the label).

The encoder has random weights from seed 0: loading real SD-VAE
weights (``--vae-dir``) is refused by name, as in JAX. JAX writes ``x``
channel-last (H, W, C), which ``ImageNet`` (both packages') reads as
(C, H, W) and so transposes; the port writes (C, H, W) (ROADMAP queue C).

    python -m arcflow_tpu_torch.tools.cache_imagenet_data_sdvae \\
        --image-dir DIR --out DIR [--image-size 256] [--batch 16] \\
        [--device cuda]
"""

import argparse
import os

import numpy as np

LATENT_CHANNELS, SCALING_FACTOR = 4, 0.18215


def build_encoder(device):
    """The SD-VAE encoder with random fp32 weights drawn on the host from
    seed 0 (the host's global generator is left as it was), on
    ``device``."""
    import torch

    from ..models import PretrainedVAEEncoder
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(0)
        vae = PretrainedVAEEncoder(latent_channels=LATENT_CHANNELS,
                                   scaling_factor=SCALING_FACTOR,
                                   shift_factor=0.0, device='cpu',
                                   dtype=torch.float32)
    return vae.to(device).eval()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--image-dir', required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--vae-dir', default=None,
                   help='real AutoencoderKL weights: refused (not ported)')
    p.add_argument('--image-size', type=int, default=256)
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--num-shards', type=int, default=1)
    p.add_argument('--shard', type=int, default=0)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    if args.vae_dir:
        raise NotImplementedError(
            '--vae-dir: loading real SD-VAE weights into the cacher is not '
            'ported, as in JAX; the encoder has random weights')

    import torch

    from ..data import ImageNet, collate
    ds = ImageNet(image_dir=args.image_dir, image_size=args.image_size)
    vae = build_encoder(args.device)
    os.makedirs(args.out, exist_ok=True)
    idxs = list(range(args.shard, len(ds), args.num_shards))
    for i in range(0, len(idxs), args.batch):
        chunk = idxs[i:i + args.batch]
        batch = collate([ds[j] for j in chunk])
        images = torch.from_numpy(batch['images']).to(args.device)
        with torch.inference_mode():
            latents = vae.encode(images * 2 - 1).float().cpu().numpy()
        for j, rec_idx in enumerate(chunk):
            np.savez(os.path.join(args.out, f'{rec_idx:08d}.npz'),
                     x=np.moveaxis(latents[j], -1, 0),
                     y=batch['label'][j])
        print(f'\rshard {args.shard}: {i + len(chunk)}/{len(idxs)}', end='')
    print()


if __name__ == '__main__':
    main()
