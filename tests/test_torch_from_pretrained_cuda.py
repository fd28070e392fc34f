"""Prompt to image on the card: a diffusers folder loaded with
``from_pretrained`` and an adapter, images from a prompt bitwise equal to
images from ``encode_prompt``'s embeds, and the adapter's weights grafted
onto the card's model.

Marked ``cuda``: they skip without a CUDA device. This file imports no
JAX: ``python -m pytest --noconftest -q
tests/test_torch_from_pretrained_cuda.py``. Tiny widths, except the head
dimension of 128 the attention kernel takes; a toy tokenizer trained here.
"""

import json
import os

import pytest
import torch

from arcflow_tpu_torch.models import ArcFluxTransformer2DModel
from arcflow_tpu_torch.ops import attention as attn
from arcflow_tpu_torch.pipelines import (ArcFluxPipeline, save_adapter_state,
                                         torch_to_diffusers)

PROMPT = 'a photo of a cat sitting on a mat'
FLUX = dict(in_channels=16, num_layers=1, num_single_layers=1,
            attention_head_dim=128, num_attention_heads=2,
            joint_attention_dim=64, pooled_projection_dim=32,
            num_gaussians=4, lora_rank=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.Generator(device='cuda').manual_seed(0)


def _tokenizer():
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    tok = Tokenizer(models.BPE(unk_token='<unk>'))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator([PROMPT, 'an astronaut riding a horse'] * 4,
                            trainers.BpeTrainer(vocab_size=120,
                                                special_tokens=['<pad>',
                                                                '<unk>']))
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token='<pad>', unk_token='<unk>')


def _folder(root, g):
    """A FLUX pipeline folder (transformer, tiny CLIP and T5, tokenizers,
    scheduler; no VAE) and the transformer it was written from."""
    import transformers
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **FLUX)
        clip = transformers.CLIPTextModel(transformers.CLIPTextConfig(
            vocab_size=120, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=77))
        t5 = transformers.T5EncoderModel(transformers.T5Config(
            vocab_size=120, d_model=64, d_kv=16, d_ff=96, num_layers=2,
            num_heads=2, feed_forward_proj='gated-gelu'))
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, 0.05, generator=g)
    os.makedirs(os.path.join(root, 'transformer'))
    with open(os.path.join(root, 'transformer', 'config.json'), 'w') as f:
        json.dump(dict(FLUX, _class_name='ArcFluxTransformer2DModel'), f)
    from safetensors.torch import save_file
    save_file({k: v.cpu().contiguous() for k, v in torch_to_diffusers(
        model.state_dict()).items()},
        os.path.join(root, 'transformer', 'model.safetensors'))
    tok = _tokenizer()
    for sub, m in (('text_encoder', clip), ('text_encoder_2', t5)):
        m.save_pretrained(os.path.join(root, sub))
    for sub in ('tokenizer', 'tokenizer_2'):
        tok.save_pretrained(os.path.join(root, sub))
    with open(os.path.join(root, 'model_index.json'), 'w') as f:
        json.dump(dict(transformer=['diffusers', 'ArcFluxTransformer2DModel'],
                       text_encoder=['transformers', 'CLIPTextModel'],
                       text_encoder_2=['transformers', 'T5EncoderModel']), f)
    return model


@pytest.mark.cuda
def test_prompt_and_embeds_give_the_same_image(cuda, tmp_path):
    _folder(str(tmp_path), cuda)
    pipe = ArcFluxPipeline.from_pretrained(
        str(tmp_path), text_encoder_kwargs=dict(max_sequence_length=32))
    assert next(pipe.transformer.parameters()).device.type == 'cuda'
    latents = pipe.prepare_latents(1, 128, 128, generator=cuda,
                                   device='cuda')
    before = attn.LAUNCHES
    a = pipe(prompt=PROMPT, latents=latents, output_type='latent')
    assert attn.LAUNCHES - before == 2 * 2        # 2 NFE x (1 + 1) blocks
    embeds = pipe.encode_prompt(PROMPT)
    assert all(v.device.type == 'cuda' for v in embeds.values())
    b = pipe(prompt_embeds=embeds, latents=latents, output_type='latent')
    assert torch.isfinite(a['latents']).all()
    assert torch.equal(a['latents'], b['latents'])


@pytest.mark.cuda
def test_adapter_grafts_on_the_card(cuda, tmp_path):
    model = _folder(str(tmp_path), cuda)
    adapter = {k: (v.float() + 0.1).to(v.dtype)
               for k, v in model.state_dict().items()
               if k.startswith(('proj_out_', 'norm_out')) or 'lora_' in k}
    path = str(tmp_path / 'adapter.safetensors')
    save_adapter_state(path, adapter, policy_config=dict(temperature=0.5))
    pipe = ArcFluxPipeline.from_pretrained(str(tmp_path), text_encoder=None)
    assert pipe.load_arcflow_adapter(path) == dict(temperature=0.5)
    assert pipe.diffusion.test_cfg['temperature'] == 0.5
    state = pipe.transformer.state_dict()
    for k, v in adapter.items():
        assert state[k].device.type == 'cuda'
        assert torch.equal(state[k], v), k
