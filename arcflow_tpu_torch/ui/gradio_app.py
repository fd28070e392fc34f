"""Gradio text-to-image app around an ``ArcFluxPipeline``-like pipeline.

Counterpart of ``arcflow_tpu/ui/gradio_app.py``: a prompt box, height and
width with a swap button, NFE / temperature / guidance sliders, a seed with
a randomize button and a batch slider. ``gradio`` is imported when the app
is built, and refused by name without it. The callback is the module-level
``generate``, which runs without gradio: it draws the latents from a
``torch.Generator`` seeded with the seed on the pipeline's device, where
JAX passes ``seed=`` to its pipeline, so the images are not JAX's bit for
bit (two random number generators).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def pipeline_device(pipeline) -> torch.device:
    """The device of the pipeline's transformer (the CPU for a pipeline
    without parameters)."""
    transformer = getattr(pipeline, 'transformer', None)
    if transformer is not None:
        for p in transformer.parameters():
            return p.device
    return torch.device('cpu')


def generate(pipeline, prompt: str, height, width, nfe, temperature,
             guidance, seed, batch) -> list:
    """``batch`` images of ``prompt`` at ``height`` x ``width``: a list of
    (H, W, 3) numpy arrays in [0, 1]."""
    g = torch.Generator(device=pipeline_device(pipeline))
    g.manual_seed(int(seed))
    out = pipeline(prompt=[prompt] * int(batch), height=int(height),
                   width=int(width), num_inference_steps=int(nfe),
                   temperature=float(temperature),
                   guidance_scale=float(guidance), generator=g,
                   output_type='np')
    return [np.asarray(img) for img in out['images']]


def randomize_seed() -> int:
    return random.randint(0, 2 ** 31 - 1)


def swap_hw(h, w):
    return w, h


def create_interface_text_to_img(pipeline, default_prompt: str = '',
                                 default_height: int = 1024,
                                 default_width: int = 1024,
                                 max_batch: int = 4):
    """The gradio ``Blocks`` app; ``demo.launch()`` serves it."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError('the gradio app needs gradio, which is not '
                           'installed here') from e

    def generate_images(prompt, height, width, nfe, temperature, guidance,
                        seed, batch):
        return generate(pipeline, prompt, height, width, nfe, temperature,
                        guidance, seed, batch)
    generate_images.__name__ = 'generate'

    with gr.Blocks(title='ArcFlow') as demo:
        gr.Markdown('## ArcFlow 2-NFE text-to-image')
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label='Prompt', value=default_prompt,
                                    lines=3)
                with gr.Row():
                    height = gr.Number(label='Height', value=default_height)
                    width = gr.Number(label='Width', value=default_width)
                    swap = gr.Button('⇄', scale=0)
                with gr.Row():
                    nfe = gr.Slider(1, 8, value=2, step=1, label='NFE')
                    temperature = gr.Slider(0.1, 2.0, value=1.0,
                                            label='Temperature')
                    guidance = gr.Slider(0.0, 10.0, value=3.5,
                                         label='Guidance')
                with gr.Row():
                    seed = gr.Number(label='Seed', value=42, precision=0)
                    rand = gr.Button('\U0001f3b2', scale=0)
                    batch = gr.Slider(1, max_batch, value=1, step=1,
                                      label='Batch')
                run = gr.Button('Generate', variant='primary')
            gallery = gr.Gallery(label='Results', columns=2)
        swap.click(swap_hw, [height, width], [height, width])
        rand.click(randomize_seed, [], [seed])
        # no negative prompt: the 2-NFE student is guidance-distilled
        run.click(generate_images,
                  [prompt, height, width, nfe, temperature, guidance, seed,
                   batch], [gallery])
    return demo
