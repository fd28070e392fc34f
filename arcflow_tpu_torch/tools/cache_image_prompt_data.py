"""Build the prompt-embedding cache that ``data/image_prompts.py:
ImagePrompt`` reads in cache mode (the JAX package's
``tools/cache_image_prompt_data.py``): one zstd-compressed pickle per prompt,
``{prompt, prompt_embed_kwargs: {name: array of one prompt}, latent_size}``,
named ``<8-digit index>.zst``, and ``datalist.jsonl.gz`` naming them. The
embeddings come from the port's ``PretrainedFluxTextEncoder`` (CLIP-L +
T5-XXL) or ``PretrainedQwenImageTextEncoder`` (Qwen2.5-VL) on ``--device``
(the card unless ``cpu``), in bf16, and are stored as fp32 numpy (JAX stores its encoder's dtype, bf16 by default, as ml_dtypes
arrays); both packages' ``ImagePrompt`` read either. Needs ``zstandard``.

    python -m arcflow_tpu_torch.tools.cache_image_prompt_data \\
        --prompts prompts.jsonl --out CACHE_DIR --family flux \\
        [--height 1024 --width 1024] [--device cuda]
"""

import argparse
import gzip
import json
import os
import pickle


def build_encoder(args):
    from ..models import (PretrainedFluxTextEncoder,
                          PretrainedQwenImageTextEncoder)
    if args.family == 'flux':
        kw = {k: v for k, v in dict(clip_path=args.clip_path,
                                    t5_path=args.t5_path).items() if v}
        return PretrainedFluxTextEncoder(
            max_sequence_length=args.max_seq_len, device=args.device, **kw)
    kw = dict(pretrained=args.pretrained) if args.pretrained else {}
    return PretrainedQwenImageTextEncoder(
        pad_seq_len=args.max_seq_len, device=args.device, **kw)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--prompts', required=True,
                   help='jsonl of prompts (or {"prompt": ...} records)')
    p.add_argument('--out', required=True)
    p.add_argument('--family', choices=['flux', 'qwen'], default='flux')
    p.add_argument('--height', type=int, default=1024)
    p.add_argument('--width', type=int, default=1024)
    p.add_argument('--max-seq-len', type=int, default=512)
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--clip-path', default=None,
                   help='flux family: CLIP model and tokenizer folder '
                        '(default: openai/clip-vit-large-patch14)')
    p.add_argument('--t5-path', default=None,
                   help='flux family: T5 model and tokenizer folder')
    p.add_argument('--pretrained', default=None,
                   help='qwen family: Qwen2.5-VL folder')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)

    import zstandard as zstd

    from ..data import load_datalist
    encoder = build_encoder(args)
    prompts = [r.get('prompt', r.get('name'))
               for r in load_datalist(args.prompts)]
    latent_size = (args.height // 8, args.width // 8, 16)

    os.makedirs(args.out, exist_ok=True)
    names = []
    for i in range(0, len(prompts), args.batch):
        chunk = prompts[i:i + args.batch]
        embeds = {k: (v.float() if v.is_floating_point() else v)
                  .cpu().numpy() for k, v in encoder(chunk).items()}
        for j, prompt in enumerate(chunk):
            name = f'{i + j:08d}'
            rec = dict(prompt=prompt,
                       prompt_embed_kwargs={k: v[j]
                                            for k, v in embeds.items()},
                       latent_size=latent_size)
            with open(os.path.join(args.out, f'{name}.zst'), 'wb') as f:
                with zstd.ZstdCompressor().stream_writer(f) as z:
                    pickle.dump(rec, z)
            names.append(name)
        print(f'\r{i + len(chunk)}/{len(prompts)}', end='')
    print()
    with gzip.open(os.path.join(args.out, 'datalist.jsonl.gz'), 'wt') as f:
        for n in names:
            f.write(json.dumps({'name': n}) + '\n')


if __name__ == '__main__':
    main()
