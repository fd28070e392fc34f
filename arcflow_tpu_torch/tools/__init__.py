"""Command-line tools around a training run, one module per script of the
repository root's ``tools/`` (the JAX package's), each runnable as
``python -m arcflow_tpu_torch.tools.<name>``:

* ``save_inference_weights``: a checkpoint's EMA (or live) weights as one
  safetensors file, cast to a dtype;
* ``checkpoint_cleaner``: prune old steps of a checkpoint directory;
* ``count_parameters``: trainable / frozen parameters of a config's model;
* ``convert_comfy_flux_lora_to_diffusers``: a Comfy / Kohya FLUX LoRA in
  diffusers-peft naming;
* ``cache_image_prompt_data``: the prompt-embedding cache ``ImagePrompt``
  reads;
* ``cache_imagenet_data_sdvae``: SD-VAE latents of an image folder, the
  records ``ImageNet`` reads;
* ``validate_toy_e2e``: flow pretraining -> 2-NFE ArcFlow distillation ->
  the in-support share of the samples on the checkerboard.

Those that compute run on the card unless ``--device cpu`` is passed.
"""
