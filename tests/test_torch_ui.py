"""Port parity: the UI layer (``arcflow_tpu_torch/ui``) against the JAX
package's: the media grid page equal to JAX's, string for string; the
gradio app built against a stand-in ``gradio`` module (gradio is not
installed here), as ``tests/test_ui_and_tools.py`` builds JAX's; and the
module-level ``generate`` callback, which runs without gradio and draws the
latents from a ``torch.Generator`` seeded with the UI's seed where JAX
passes ``seed=`` (ROADMAP queue C: no bitwise counterpart across the two
random number generators).
"""

import os
import sys

import numpy as np
import pytest
import torch

from arcflow_tpu.ui.media_viewer import grid_tools as j_grid
from arcflow_tpu_torch.ui import gradio_app
from arcflow_tpu_torch.ui.media_viewer import grid_tools
from test_ui_and_tools import _Component, _fake_gradio


@pytest.mark.parametrize('paths, titles, page_title', [
    (['a.png', 'clip.mp4', 'loop.webm'], ['a <cat>', 'vid', 'w'],
     'ArcFlow samples'),
    (['x/y z.jpg', 'B.MP4'], None, 'run "7" & co'),
    ([], None, 'empty')])
def test_grid_html_equals_jax(paths, titles, page_title):
    assert grid_tools.grid_html(paths, titles, page_title) == \
        j_grid.grid_html(paths, titles, page_title)


def test_write_media_grid_equals_jax(tmp_path):
    media = tmp_path / 'samples'
    media.mkdir()
    for n in ('x.png', 'y.mp4'):
        (media / n).write_bytes(b'0')
    files = [str(media / 'x.png'), str(media / 'y.mp4')]
    out = grid_tools.write_media_grid(str(media), files)
    page = open(out, encoding='utf-8').read()
    os.remove(out)
    j_out = j_grid.write_media_grid(str(media), files)
    assert out == j_out and page == open(j_out, encoding='utf-8').read()
    assert '<img src="x.png"' in page and '<video src="y.mp4"' in page


class StubPipeline:
    """Records its calls; images from the generator it is given."""

    def __init__(self):
        self.calls = []
        self.transformer = torch.nn.Linear(2, 2)

    def __call__(self, **kwargs):
        self.calls.append(kwargs)
        bs, h, w = len(kwargs['prompt']), kwargs['height'], kwargs['width']
        return dict(images=torch.rand((bs, h, w, 3),
                                      generator=kwargs['generator']).numpy())


def test_gradio_builder_wiring(monkeypatch):
    """The builder makes the whole control surface and wires the three
    callbacks; ``generate`` drives the pipeline with the UI's values."""
    monkeypatch.setitem(sys.modules, 'gradio', _fake_gradio())
    _Component.created = []
    pipe = StubPipeline()
    demo = gradio_app.create_interface_text_to_img(
        pipe, default_prompt='hi', default_height=32, default_width=64)
    assert demo is not None
    labels = {c.label for c in _Component.created} - {None}
    assert labels == {'Prompt', 'Height', 'Width', 'NFE', 'Temperature',
                      'Guidance', 'Seed', 'Batch', 'Results'}
    clicks = [(fn, ins, outs) for c in _Component.created
              for fn, ins, outs in c.clicks]
    by_name = {fn.__name__: (fn, ins, outs) for fn, ins, outs in clicks}
    assert set(by_name) == {'swap_hw', 'randomize_seed', 'generate'}
    gen, ins, outs = by_name['generate']
    assert len(ins) == 8 and len(outs) == 1
    imgs = gen('a cat', 32, 64, 2, 1.0, 3.5, 7, 2)
    assert len(imgs) == 2 and imgs[0].shape == (32, 64, 3)
    call = pipe.calls[-1]
    assert call['prompt'] == ['a cat', 'a cat']
    assert call['num_inference_steps'] == 2 and call['guidance_scale'] == 3.5
    assert call['temperature'] == 1.0 and call['output_type'] == 'np'
    assert 'seed' not in call
    assert call['generator'].initial_seed() == 7
    assert by_name['swap_hw'][0](32, 64) == (64, 32)
    assert 0 <= by_name['randomize_seed'][0]() < 2 ** 31


def test_gradio_refused_by_name_without_it(monkeypatch):
    monkeypatch.setitem(sys.modules, 'gradio', None)
    with pytest.raises(RuntimeError, match='gradio'):
        gradio_app.create_interface_text_to_img(StubPipeline())


def test_generate_seeds_a_torch_generator_unlike_jax():
    """The same seed gives the same images, another seed others; the
    generator lies on the pipeline's device. JAX's callback passes
    ``seed=`` to its pipeline, which draws with ``jax.random``: the port's
    images cannot be JAX's bit for bit, so the UI's seed is a torch seed."""
    pipe = StubPipeline()
    a = gradio_app.generate(pipe, 'p', 8, 8, 2, 1.0, 3.5, 11, 1)
    b = gradio_app.generate(pipe, 'p', 8, 8, 2, 1.0, 3.5, 11, 1)
    c = gradio_app.generate(pipe, 'p', 8, 8, 2, 1.0, 3.5, 12, 1)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])
    assert pipe.calls[-1]['generator'].device == torch.device('cpu')
    assert gradio_app.pipeline_device(pipe) == torch.device('cpu')
