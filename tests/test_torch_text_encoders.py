"""The port's prompt encoders (``models/text_encoders.py``) against the JAX
package's, on the same tiny folders.

CLIP (hidden 32, 2 layers, projection 24) and T5 (d_model 80, gated-GELU,
2 layers) are saved with torch and converted once with Flax
(``from_pt=True``) to ``flax_model.msgpack`` beside the torch weights: JAX
reads the Flax file, the port the safetensors. Tokenizers are trained in
the test (slow CLIP in JAX, ``AutoTokenizer`` in the port: the same ids).
The Qwen folder is ``test_torch_qwen_text.py``'s. Everything in fp32 on
the CPU; outputs agree within atol=1e-5, rtol=1e-4 (the Qwen ones at the
valid positions, masks equal), and the Qwen native backend against the
transformers VL class within the JAX test's band
(``tests/test_text_encoders.py:184-185``).
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_qwen_text import PROMPTS, qwen_dir, write_tokenizer  # noqa

tf = pytest.importorskip('transformers')

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope='module')
def clip_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('clip'))
    cfg = tf.CLIPTextConfig(vocab_size=240, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=2,
                            max_position_embeddings=77, projection_dim=24)
    with torch.random.fork_rng():
        torch.manual_seed(1)
        tf.CLIPTextModelWithProjection(cfg).save_pretrained(d)
    tf.FlaxCLIPTextModelWithProjection.from_pretrained(
        d, from_pt=True).save_pretrained(d)
    write_tokenizer(d)
    os.remove(os.path.join(d, 'tokenizer.json'))    # CLIP's own BPE
    with open(os.path.join(d, 'tokenizer_config.json'), 'w') as fh:
        json.dump(dict(tokenizer_class='CLIPTokenizer',
                       bos_token='<|startoftext|>',
                       eos_token='<|endoftext|>', unk_token='<unk>',
                       pad_token='<|endoftext|>', model_max_length=77), fh)
    return d


@pytest.fixture(scope='module')
def t5_dir(tmp_path_factory):
    from arcflow_tpu.models.text_encoders import _patch_flax_t5_clip
    _patch_flax_t5_clip(tf)
    d = str(tmp_path_factory.mktemp('t5'))
    cfg = tf.T5Config(vocab_size=240, d_model=80, d_kv=8, d_ff=64,
                      num_layers=2, num_heads=2,
                      feed_forward_proj='gated-gelu')
    with torch.random.fork_rng():
        torch.manual_seed(2)
        tf.T5EncoderModel(cfg).save_pretrained(d)
    tf.FlaxT5EncoderModel.from_pretrained(d, from_pt=True).save_pretrained(d)
    write_tokenizer(d)
    with open(os.path.join(d, 'tokenizer_config.json'), 'w') as fh:
        json.dump(dict(tokenizer_class='T5Tokenizer', eos_token='</s>',
                       unk_token='<unk>', pad_token='<pad>'), fh)
    return d


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_flux_encoder_matches_jax(clip_dir, t5_dir):
    from arcflow_tpu.models import PretrainedFluxTextEncoder as J
    from arcflow_tpu_torch.models import PretrainedFluxTextEncoder
    kw = dict(clip_path=clip_dir, t5_path=t5_dir, max_sequence_length=16,
              dtype='float32')
    want = J(**kw)(PROMPTS)
    enc = PretrainedFluxTextEncoder(device='cpu', **kw)
    got = enc(PROMPTS)
    assert set(got) == {'encoder_hidden_states', 'pooled_projections'}
    assert got['encoder_hidden_states'].shape == (2, 16, 80)
    assert got['pooled_projections'].shape == (2, 32)
    for k in got:
        assert got[k].device.type == 'cpu' and got[k].dtype == torch.float32
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL)
    assert enc.clip.device.type == 'cpu'


def test_sd3_layout_matches_jax(clip_dir, t5_dir):
    from arcflow_tpu.models import PretrainedStableDiffusion3TextEncoder as J
    from arcflow_tpu_torch.models import PretrainedStableDiffusion3TextEncoder
    kw = dict(clip_l_path=clip_dir, clip_g_path=clip_dir, t5_path=t5_dir,
              max_sequence_length=16, dtype='float32')
    want = J(**kw)(PROMPTS)
    got = PretrainedStableDiffusion3TextEncoder(device='cpu', **kw)(PROMPTS)
    h = _np(got['encoder_hidden_states'])
    assert h.shape == (2, 77 + 16, 80)
    assert np.abs(h[:, :77, 64:]).max() == 0.0
    assert got['pooled_projections'].shape == (2, 48)
    for k in got:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL)


def test_registry_builds_the_encoders(clip_dir, t5_dir, qwen_dir):  # noqa
    from arcflow_tpu_torch import build_module
    from arcflow_tpu_torch.models import (PretrainedFluxTextEncoder,
                                          PretrainedQwenImageTextEncoder)
    flux = build_module(dict(type='PretrainedFluxTextEncoder',
                             clip_path=clip_dir, t5_path=t5_dir,
                             max_sequence_length=16, dtype='float32',
                             device='cpu'))
    assert isinstance(flux, PretrainedFluxTextEncoder)
    direct = PretrainedFluxTextEncoder(clip_path=clip_dir, t5_path=t5_dir,
                                       max_sequence_length=16,
                                       dtype=torch.float32, device='cpu')
    a, b = flux(PROMPTS[:1]), direct(PROMPTS[:1])
    for k in a:
        assert torch.equal(a[k], b[k])
    # wrapping built towers gives the same conditioning
    wrapped = PretrainedFluxTextEncoder.from_modules(
        direct.clip, direct.t5, direct.clip_tokenizer, direct.t5_tokenizer,
        max_sequence_length=16)
    for k, v in wrapped(PROMPTS[:1]).items():
        assert torch.equal(v, a[k])
    qwen = build_module(dict(type='PretrainedQwenImageTextEncoder',
                             pretrained=qwen_dir, device='cpu'))
    assert isinstance(qwen, PretrainedQwenImageTextEncoder)
    assert qwen.backend == 'native'
    with pytest.raises(ValueError, match='backend'):
        PretrainedQwenImageTextEncoder(backend='flax')


def test_qwen_native_matches_jax_flax(qwen_dir):  # noqa: F811
    from arcflow_tpu.models import PretrainedQwenImageTextEncoder as J
    from arcflow_tpu_torch.models import PretrainedQwenImageTextEncoder
    kw = dict(pretrained=qwen_dir, pad_seq_len=128, dtype='float32')
    want = J(**kw)(PROMPTS)
    enc = PretrainedQwenImageTextEncoder(device='cpu', **kw)
    got = enc(PROMPTS)
    mask = got['encoder_hidden_states_mask']
    assert mask.dtype == torch.int32
    assert got['encoder_hidden_states'].dtype == torch.float32
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(want['encoder_hidden_states_mask']))
    valid = mask.numpy().astype(bool)
    assert 0 < valid.sum() < valid.size
    h = _np(got['encoder_hidden_states'])
    assert h.shape == (2, 128, 32)
    np.testing.assert_allclose(
        h[valid], _np(want['encoder_hidden_states'])[valid], **TOL)


def test_qwen_native_matches_transformers_backend(qwen_dir):  # noqa: F811
    from arcflow_tpu_torch.models import PretrainedQwenImageTextEncoder
    kw = dict(pretrained=qwen_dir, pad_seq_len=128, dtype='float32',
              device='cpu')
    native = PretrainedQwenImageTextEncoder(**kw)(PROMPTS)
    enc = PretrainedQwenImageTextEncoder(backend='transformers', **kw)
    vl = enc(PROMPTS)
    assert type(enc.model).__name__ == 'Qwen2_5_VLForConditionalGeneration'
    m = native['encoder_hidden_states_mask'].numpy()
    np.testing.assert_array_equal(
        m, vl['encoder_hidden_states_mask'].numpy())
    valid = m.astype(bool)
    h_n = _np(native['encoder_hidden_states'])[valid]
    h_t = _np(vl['encoder_hidden_states'])[valid]
    err = np.abs(h_n - h_t)
    assert err.max() / (np.abs(h_t).mean() + 1e-6) < 5e-2
    np.testing.assert_allclose(h_n, h_t, atol=1e-3, rtol=1e-2)
