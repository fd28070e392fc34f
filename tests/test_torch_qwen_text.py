"""The port's native Qwen2.5 text decoder (``models/qwen_text.py``) against
the JAX package's flax decoder, on the same tiny safetensors folder.

The folder is a transformers ``Qwen2_5_VLForConditionalGeneration`` (a
2-layer text model, hidden 32, 4 heads over 2 KV heads, so GQA repeats
keys and values; a 2-layer vision tower the decoder never reads) saved with
torch, with an in-test BPE tokenizer. Both decoders run in fp32 on random
token ids with right padding; hidden states agree at the valid positions
within atol=1e-5, rtol=1e-4 (fp32 products in another order through two
layers).
"""

import json
import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip('transformers')

PROMPTS = ['a photo of a cat sitting on a mat',
           'an astronaut riding a horse on the moon']


def write_tokenizer(d):
    """A tiny BPE trained in-test: tokenizer.json + vocab.json/merges.txt."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    tok = Tokenizer(models.BPE(unk_token='<unk>'))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(vocab_size=240, special_tokens=[
        '<unk>', '<pad>', '</s>', '<|startoftext|>', '<|endoftext|>',
        '<|im_start|>', '<|im_end|>'])
    tok.train_from_iterator(
        PROMPTS + ['the quick brown fox jumps over the lazy dog',
                   'describe the image system user assistant'] * 5, trainer)
    tok.save(os.path.join(d, 'tokenizer.json'))
    tok.model.save(d)


@pytest.fixture(scope='module')
def qwen_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('qwenvl'))
    cfg = tf.Qwen2_5_VLConfig(
        text_config=dict(vocab_size=240, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=256, rope_theta=1e6,
                         rope_scaling=dict(type='mrope',
                                           mrope_section=[1, 1, 2])),
        vision_config=dict(depth=2, hidden_size=32, out_hidden_size=32,
                           intermediate_size=64, num_heads=2, patch_size=14,
                           spatial_merge_size=2, temporal_patch_size=2))
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = tf.Qwen2_5_VLForConditionalGeneration(cfg)
        with torch.no_grad():       # visible biases and norm scales
            for name, p in model.named_parameters():
                if p.dim() == 1:
                    p.add_(0.1 * torch.randn_like(p))
    model.save_pretrained(d)
    write_tokenizer(d)
    with open(os.path.join(d, 'tokenizer_config.json'), 'w') as fh:
        json.dump(dict(tokenizer_class='Qwen2Tokenizer', unk_token='<unk>',
                       eos_token='<|im_end|>', pad_token='<pad>'), fh)
    return d


def test_native_decoder_matches_jax(qwen_dir):
    import jax.numpy as jnp
    from arcflow_tpu.models.qwen_text import load_qwen25_text_params as j_load
    from arcflow_tpu_torch.models import load_qwen25_text_params

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 240, (2, 20)).astype(np.int32)
    mask = np.ones((2, 20), np.int32)
    mask[1, 13:] = 0
    jm, params = j_load(qwen_dir, dtype=jnp.float32)
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(ids),
                               jnp.asarray(mask)))
    model = load_qwen25_text_params(qwen_dir, device='cpu',
                                    dtype=torch.float32)
    assert model.layers[0].self_attn.kv_heads == 2
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 20, 32)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=1e-4)
    assert np.abs(got[valid]).max() > 0.1


def test_bf16_load_keeps_fp32_norms(qwen_dir):
    from arcflow_tpu_torch.models import load_qwen25_text_params
    model = load_qwen25_text_params(qwen_dir, device='cpu',
                                    dtype=torch.bfloat16)
    assert model.norm.weight.dtype == torch.float32
    assert model.layers[1].input_layernorm.weight.dtype == torch.float32
    assert model.layers[1].self_attn.q_proj.weight.dtype == torch.bfloat16
    assert model.embed_tokens.weight.dtype == torch.bfloat16
    out = model(torch.arange(12)[None] % 240)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_decoder_prefixes(tmp_path):
    from arcflow_tpu_torch.models.qwen_text import decoder_state
    with pytest.raises(ValueError, match='no Qwen text decoder'):
        decoder_state({'visual.blocks.0.weight': torch.zeros(1)},
                      str(tmp_path))
    # the three prefixes transformers has written
    for prefix in ('model.language_model.', 'language_model.model.',
                   'model.'):
        state = {prefix + 'embed_tokens.weight': torch.zeros(1),
                 'lm_head.weight': torch.zeros(1)}
        assert list(decoder_state(state)) == ['embed_tokens.weight']
