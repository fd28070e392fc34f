"""Convert a Comfy / Kohya FLUX LoRA to diffusers-peft naming.

The port's own copy of the JAX package's
``tools/convert_comfy_flux_lora_to_diffusers.py`` (numpy only): BFL module
names (``lora_unet_double_blocks_0_img_attn_qkv``) -> diffusers FLUX names
(``transformer.transformer_blocks.0.attn.to_q``), with

* the fused qkv and single-block ``linear1`` LoRA split into the
  per-projection diffusers modules: A is shared, B is cut by rows, exact;
* kohya ``alpha`` folded into B as alpha / rank;
* ``lora_down`` / ``lora_up`` -> ``lora_A`` / ``lora_B``.

    python -m arcflow_tpu_torch.tools.convert_comfy_flux_lora_to_diffusers \\
        IN.safetensors OUT.safetensors
"""

import re
import sys

import numpy as np


def _double_map(attention_head_dim=128, num_attention_heads=24):
    d = attention_head_dim * num_attention_heads
    return {
        'img_attn_qkv': [('attn.to_q', 0, d), ('attn.to_k', d, 2 * d),
                         ('attn.to_v', 2 * d, 3 * d)],
        'img_attn_proj': [('attn.to_out.0', None, None)],
        'img_mlp_0': [('ff.net.0.proj', None, None)],
        'img_mlp_2': [('ff.net.2', None, None)],
        'img_mod_lin': [('norm1.linear', None, None)],
        'txt_attn_qkv': [('attn.add_q_proj', 0, d),
                         ('attn.add_k_proj', d, 2 * d),
                         ('attn.add_v_proj', 2 * d, 3 * d)],
        'txt_attn_proj': [('attn.to_add_out', None, None)],
        'txt_mlp_0': [('ff_context.net.0.proj', None, None)],
        'txt_mlp_2': [('ff_context.net.2', None, None)],
        'txt_mod_lin': [('norm1_context.linear', None, None)],
    }


def _single_map(attention_head_dim=128, num_attention_heads=24,
                mlp_ratio=4.0):
    d = attention_head_dim * num_attention_heads
    m = int(d * mlp_ratio)
    return {
        'linear1': [('attn.to_q', 0, d), ('attn.to_k', d, 2 * d),
                    ('attn.to_v', 2 * d, 3 * d),
                    ('proj_mlp', 3 * d, 3 * d + m)],
        'linear2': [('proj_out', None, None)],
        'modulation_lin': [('norm.linear', None, None)],
    }


def convert_comfy_flux_lora(state, attention_head_dim=128,
                            num_attention_heads=24, prefix='transformer.'):
    """{comfy key: array} -> {diffusers peft key: array}."""
    dmap = _double_map(attention_head_dim, num_attention_heads)
    smap = _single_map(attention_head_dim, num_attention_heads)
    mods = {}
    for k, v in state.items():
        m = re.match(
            r'^lora_unet_(double|single)_blocks_(\d+)_(.+?)'
            r'\.(lora_down\.weight|lora_up\.weight|alpha)$', k)
        if not m:
            raise KeyError(f'unrecognized comfy lora key: {k}')
        kind, idx, module, leaf = m.groups()
        mods.setdefault((kind, int(idx), module), {})[leaf] = np.asarray(v)

    out = {}
    for (kind, idx, module), leaves in sorted(mods.items()):
        table = dmap if kind == 'double' else smap
        if module not in table:
            raise KeyError(f'unmapped comfy module: {kind}_blocks.{module}')
        down = leaves['lora_down.weight']            # (r, in)
        up = leaves['lora_up.weight']                # (out, r)
        rank = down.shape[0]
        if 'alpha' in leaves:
            up = up * (float(leaves['alpha']) / rank)
        block = 'transformer_blocks' if kind == 'double' \
            else 'single_transformer_blocks'
        for name, lo, hi in table[module]:
            base = f'{prefix}{block}.{idx}.{name}'
            out[f'{base}.lora_A.weight'] = down
            out[f'{base}.lora_B.weight'] = up if lo is None else up[lo:hi]
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        sys.exit('usage: python -m arcflow_tpu_torch.tools.'
                 'convert_comfy_flux_lora_to_diffusers IN.safetensors '
                 'OUT.safetensors')
    src, dst = argv
    from safetensors import safe_open
    from safetensors.numpy import save_file
    with safe_open(src, framework='np') as f:
        state = {k: f.get_tensor(k) for k in f.keys()}
    out = convert_comfy_flux_lora(state)
    save_file({k: np.ascontiguousarray(v) for k, v in out.items()}, dst)
    print(f'wrote {dst} ({len(out)} tensors)')


if __name__ == '__main__':
    main()
