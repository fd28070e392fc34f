#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (arcflow_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it imports nothing of JAX. Phases, one
line each, and any failure exits non-zero:

1. facts: the card's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile every kernel source of ``arcflow_tpu_torch/csrc``
   (attention forward and backward, w4a8 matmul, inverse CDF, ring hop,
   int8-QK^T attention), one ``nvcc`` per source, all in parallel;
3. attention kernel vs plain: against ``attention_ref`` at the FLUX shape
   (B1 S4608 H24 D128), a ragged S and key-padded cases, and both timed at
   the FLUX shape beside the kernel's registers and spills; a planted fault
   (one K tile's rows swapped) must break the limit;
4. w4a8 kernel vs plain: against ``w4a8_matmul_ref`` at every (M, K, N) of
   the Qwen-Image int4 layers, a ragged M, groups of 32 and 64 and weights
   of -8; both timed at the two largest shapes;
5. FLUX at reduced depth (1 joint + 1 single block) and full width, in
   bf16: one forward through the kernel, the same weights through the plain
   attention, ``means`` compared by relative L2;
6. FLUX at full geometry: FLUX-12B ArcFlux (19 + 38 blocks, 24 x 128,
   K=16, guidance embeds) and the full FLUX VAE decoder with random bf16
   weights from a seed, 2-NFE at 1024x1024 from random prompt embeds through
   ``ArcFluxPipeline.__call__``; the image must be finite, (1, 1024, 1024, 3),
   and the run must launch the attention kernel exactly 2 x 57 times;
   phase 18 follows on the same model;
7. Qwen-Image at reduced depth (1 joint block) and full width, w4a8: one
   forward through the w4a8 kernel, the same weights through its plain
   version, ``means`` compared by relative L2;
8. Qwen-Image at full geometry: ArcQwen 20B (60 joint blocks, 24 x 128,
   text dim 3584, K=16, LoRA rank 256, 512 text tokens of which 384 are
   valid) with random bf16 weights from a seed, quantized with
   ``pipe.quantize_int4(act_quant=True)``, and the full Wan decoder, 2-NFE
   at 1024x1024 through ``ArcQwenImagePipeline.__call__``; the image must be
   finite, (1, 1024, 1024, 3) and the same on a second run, with exactly
   2 x 60 masked attention launches and 2 w4a8 launches per int4 layer;
   then a ``torch.profiler`` split of one warm image by kernel name;
9. attention backward kernels vs plain: dq, dk and dv against
   ``attention_bwd_ref`` at the FLUX shape, S = 777 and 1000, key-padded
   cases and a batch row with no valid key; kernel, plain version and the
   backward of one ``scaled_dot_product_attention`` call timed at the FLUX
   shape beside the kernel's registers and spills; a planted fault (the dQ
   partial of one key tile dropped) must break the limit;
10. FLUX training at reduced depth (1 joint + 1 single block) and full
    width, bf16: one ``LatentDiffusionTextImage.loss`` + backward through
    both attention kernels, then the same weights and draws through the
    plain versions; loss and adapter gradients compared by relative L2;
11. FLUX training at full geometry: the FLUX-12B ArcFlow distillation of
    ``configs/flux/arcflux_2nfe_k16.py``, built through the port's
    ``Config`` and ``MODELS`` (frozen bf16 trunk shared with the teacher,
    fp32 LoRA rank 256 + heads, checkpointing, LoRA dropout 0.05, nfe 2, 4
    intermediate states; 652,405,884 adapter parameters) with random
    weights from a seed, 2 ``train_step``s of ``build_train_step`` on one
    batch of random prompt embeds: finite losses and grad norms, the
    adapter moved, the frozen trunk bit-identical, the EMA equal to the
    adapter (copy-through before iteration 100), exactly 12 x 57 forward
    and 2 x 57 backward attention launches per step; then a
    ``torch.profiler`` split of one warm step;
11r. (right after phase 11, on its model and state) FLUX-12B through
    ``IterBasedRunner`` with the config's log hooks, the loss quartiles,
    ``IterTimerHook(sync=True)`` and a trainable-only fp32
    ``CheckpointManager`` in a temporary directory: a hook raises SIGTERM
    after the second of three iterations, and the runner must stop there
    with a checkpoint of that step; 12 x 57 / 2 x 57 launches per
    iteration; the checkpoint (10.4 GB) bitwise equal to the live state,
    and restored into a disturbed live state bitwise; the frozen trunk
    untouched; s per iteration against phase 11's bare step, the runner's
    own host time, the checkpoint's bytes and save / load / restore
    seconds;
12. inverse-CDF kernel vs plain: against ``gm1d_inverse_cdf_ref`` at the
    KR transport's per-axis problem (G 16 over the 128 x 128 latent, one
    target, 16 steps), 64 times that (1024 x 1024), a ragged M, five
    targets and saturated targets, each with the lanes per element its
    launcher chose; finite, within the root tolerance, bitwise
    deterministic; kernel (device time), the call and the plain version
    timed at both sizes, the kernel at every lane count at the KR axis,
    beside its registers and spills;
13. KR transport on the card: ``gaussian_samples_to_gm_samples`` on a
    mixture of the ArcFlux head geometry at 1024x1024 (K=16 over the
    128 x 128 x 16 latent): exactly 16 kernel launches (one per channel
    axis), the plain path's result by relative L2, and the round trip
    through ``gm_samples_to_gaussian_samples`` back to z;
14. GMFlow on the checkerboard at the full width of
    ``configs/gmflow/checkerboard_gmflow.py``: 1000 ``build_train_step``
    steps of ``Diffusion2D`` at batch 512 (finite losses that fall), then
    ``val_step`` with the EMA weights: 4096 samples, finite and the same on
    a repeat;
15. (with 16-17 right after phase 19, before the model phases' profiles)
    ring-hop kernel vs plain: ``ring_hop`` against ``ring_hop_ref`` at the
    hop shape of FLUX at sp = 4 (B1, 1152 x 1152, H24 D128), padded, a fully
    padded block, ragged and a 4-hop chain, on O and on the carry; three
    planted faults must break the limits; kernel, plain version and flash
    SDPA timed at one middle hop;
16. ``ring_attention`` on ``LocalRing(4)`` against ``attention_ref`` at the
    FLUX shape, unmasked and masked (16 hop launches per call), and a
    planted lost rotation that the limits must refuse;
17. FLUX (1 + 1 blocks) and Qwen w4a8 (1 block) at full width, every
    attention on ``LocalRing(4)`` against the attention kernel, and FLUX on
    ``LocalRing(3)``, which pads both of its streams;
18. (right after phase 6, on its model) FLUX-12B 2-NFE with every attention
    on ``LocalRing(4)``: exactly 1824 hop and no attention-kernel launches,
    latents against phase 6's, and a planted lost rotation refused;
19. the int8 product of the w8a8 layers (``ops/int8_matmul.py``,
    ``torch._int_mm``) against its exact plain version at every (M, K, N)
    of the FLUX-12B int8 layers at batch 1, bitwise; timed at the two
    largest;
20. FLUX at reduced depth (1 + 1 blocks) and full width under w8a8: one
    forward through the attention kernel and the int8 product, the same
    weights through their plain versions, ``means`` by relative L2; and
    the quantization's own effect against the bf16 forward;
21. (after phase 18, on phase 6's model) FLUX-12B quantized in place with
    ``pipe.quantize_int8(act_quant=True)``: a finite image, the same on a
    second run, with exactly 114 attention and 2 x 502 int8 launches,
    s/image, resident and peak memory, latents against phase 6's; then the
    layers' ``act_quant`` off and weight-only int8 timed the same way;
22. int8-QK^T attention kernel (K7) vs plain: against
    ``flash_attention_int8_ref`` at the FLUX shape, masked, with a keyless
    batch row (the mean of v), at the JAX test's shape, ragged, and on the
    q, k, v of one joint and one single block captured from phase 21's
    w8a8 image (cosine against K1 above 0.999); two planted faults must
    break the limits; the fused row quantization bitwise equal to
    ``rowwise_int8`` on every case's q and k, fp32 and head-major rows; K7,
    the call with its quantization, its plain version, K1 and bf16 SDPA
    timed at the FLUX shape, and the quantization alone, beside both
    kernels' registers and spills;
23. (last, after phase 26, beside phases 32-33's child and the toy
    validation's process) the toy stack through the training CLI on the
    card:
    ``python -m arcflow_tpu_torch.train`` in a subprocess on
    ``configs/toy/checkerboard_flow.py``, then on
    ``configs/toy/checkerboard_arcflow_2nfe.py`` with that run's
    checkpoint as its teacher, with the cuts of
    ``tests/test_e2e_checkerboard.py`` (hidden 128 x 2, the 2 x 2 board,
    3000 and 800 iterations); each child must log that it trains on the
    card; the samples of each run's last checkpoint (EMA) must lie in the
    board's support above 0.75 (flow) and 0.5 (2-NFE student), as in the
    JAX test;
24. (right after phase 6, on its pipeline) FLUX-12B from a prompt: CLIP-L
    and the T5 v1.1 XXL encoder at their published widths (random bf16
    weights from a seed, built on the card; a toy BPE tokenizer, since the
    real ones are not in the repo) wrapped by ``PretrainedFluxTextEncoder``;
    ``pipe(prompt=...)`` with exactly 114 attention launches in the counted
    run, its image bitwise equal to the one from
    ``prompt_embeds=pipe.encode_prompt(prompt)``, finite embeddings (shape,
    dtype and max|x| printed); s per warm image split into encode,
    transformer + integration and decode, and peak memory;
25. (right after phase 8, on its pipeline) Qwen-Image 20B w4a8 from a
    prompt: the native Qwen2.5-VL-7B decoder (28 layers, 28 heads over 4
    KV heads, hidden 3584, FF 18944, vocab 152064) with random bf16 weights
    through ``PretrainedQwenImageTextEncoder``; the same checks and split,
    the valid text tokens of the encoder's mask, exactly 120 masked
    attention and 1686 w4a8 launches;
26. (after phase 30, beside phases 32-33's child, before 23 and 37)
    ``from_pretrained``:
    diffusers pipeline folders
    (``model_index.json``, ``transformer/``, ``vae/``, ``text_encoder*/``,
    ``tokenizer*/``, ``scheduler/``) written at FLUX's and Qwen-Image's
    widths with depth cut (2 joint + 2 single FLUX blocks with LoRA rank
    256 and a 2-layer T5-XXL; 2 Qwen blocks and a 2-layer Qwen2.5 decoder;
    CLIP-L and the VAEs whole), and an ArcFlow adapter written by
    ``save_adapter_state``; each loaded by ``from_pretrained`` +
    ``load_arcflow_adapter`` on the card, its image from a prompt bitwise
    equal to that of a pipeline built directly from the same modules;
    bytes and load seconds; then ``python -m
    arcflow_tpu_torch.inference_flux`` on the FLUX folder in a subprocess,
    which must exit 0 and write a PNG.

27. (after phase 14, last with 28-30) Qwen training at reduced depth (1
    joint block) and full width:
    ``configs/qwen/arcqwen_2nfe_k16_int8trunk.py`` through
    ``Config`` and ``MODELS`` (int8 frozen trunk, LoRA 256, the teacher's
    CFG at batch 2), one ``LatentDiffusionTextImage.loss`` + backward
    through the masked attention kernels (384 of 512 text tokens valid,
    the negative prompt's 128), then the same weights and draws through
    the plain versions, as phase 10; then K3 on the key-padded FLUX shape
    (4480 of 4608 keys valid) against its plain version, timed beside the
    plain version and SDPA's masked backward;
28. Qwen training at full geometry: the Qwen-Image 20B distillation of
    that config (60 blocks, K=16, LoRA 256 with dropout 0.05,
    checkpointing, the trunk in int8 and bf16 and shared with the tied
    teacher, CFG 4.0, nfe 2, 4 intermediate states; 968,551,548 adapter
    parameters, 844 int8 layers) with random weights from a seed, 2
    ``train_step``s on one batch: finite losses and grad norms, the adapter
    moved, the frozen trunk bit-identical, the teacher's trunk in the
    student's storage, the EMA equal to the adapter, exactly 12 x 60
    forward and 2 x 60 backward attention launches per step; s per warm
    step, peak memory, then a ``torch.profiler`` split of one warm step;
28r. (right after phase 28, on its model and state) 2 iterations through
    ``IterBasedRunner`` with the config's log hooks, the loss quartiles and
    ``IterTimerHook(sync=True)``: the same launches per iteration, finite
    logged losses, s per iteration against the bare step;
29. both VAE encoders at their published widths (the FLUX AutoencoderKL
    ``Encoder`` and the Wan ``QwenVAEEncoder``), random bf16 weights from
    a seed, a 1024x1024 image to (1, 128, 128, 16): finite, the same on
    repeats, s per encode and peak memory;
30. ``python -m arcflow_tpu_torch.train`` on the card in
    a subprocess: the int8-trunk Qwen config cut to 2 joint blocks, an
    ``ImagePrompt`` in prompt mode over prompts in two ``size_idx``
    buckets of two resolutions, 1024^2 and 768^2 (the bucketized loader,
    one iteration of each), the native Qwen2.5-VL-7B decoder at
    its published width cut to 2 layers with phase 25's toy tokenizer run
    inside the loss; two iterations, finite, logged on the card; the
    config's mesh set to 1 x 1, so FSDP2 runs it at world size 1;
31. (right after phase 11r, its model freed) mesh training:
    ``configs/flux/arcflux_2nfe_k16.py`` through ``train_model`` with
    ``parallel.mesh`` data=1, fsdp=-1 (the per-slice half of
    ``_multihost_train.py``) on one card, so the 12B trunk and the adapter
    go through FSDP2, the sharded AdamW, EMA and checkpoint; cuts: frozen
    trunk bf16, batch 1, 1 iteration, a checkpoint at it,
    the data ``SmokePromptEmbeds`` (no cache of real prompts is in the
    repo; phase 43 reads a written one through the native loader),
    random weights from a seed. The shipped data=2, fsdp=-1 must be
    refused with JAX's one-device message; against the same config
    through ``train_model`` without a mesh (the runner's unsharded path),
    the first iteration's loss and the adapter after it must be bitwise,
    but for the timestep embedder's LoRA, whose gradients (summed in bf16
    over 58 consumers in another order under FSDP2) are held to
    ``TEMB_GRAD_REL_L2``; 12 x 57 / 2 x 57 launches per iteration; the checkpoint bitwise before and
    after a restore; s per iteration beside phases 11 and 11r, peak
    memory, the checkpoint's bytes and seconds.

32. (last, in a child process with phase 33, beside phases 28r, 29 and
    30: ``python3 chip_smoke.py --imagenet`` runs the two alone) the
    class-conditional ImageNet path at full width,
    fp32 with TF32 off: ``configs/imagenet/imagenet256_flow.py`` and
    ``imagenet256_arcflow_2nfe.py`` as shipped through ``train_model``
    (DenoisingUnetMod 67,481,988 and ArcDenoisingUnetMod K=8 67,531,567
    parameters, batch 64 and 32, the Karras EMA, the teacher read from the
    flow run's checkpoint at the config's ``teacher_ckpt`` and grafted into
    the student, CFG 1.5, nfe 2, 4 states, 128 substeps) on seeded
    synthetic 32x32x4 latents in the cacher's ``.npz`` format; cuts: the
    data, 5 + 5 iterations, a checkpoint at the last. Then ``init_model``
    (EMA) on each checkpoint and 64 labels sampled by the 2-NFE student
    (its CFG refused by name, as JAX fails on it), the teacher's 50-step
    ``FlowEulerODE`` with and without CFG 1.5 and each of ``FlowDPMSolver``,
    ``FlowUniPC``, ``FlowDEIS`` and ``FlowSASolver`` at 8 steps: finite,
    samples per second, the latent FD of each set against the data; the
    small UNet and two UniPC steps on the card against the CPU; warm s per
    iteration, peak memory, the seconds to build each model and to graft;
    no hand-written kernel launched;
33. ``tests/test_e2e_imagenet.py``'s recipe on the card at its own size:
    4 classes of 8x8x4 latents, its ``_tiny_overrides``, 1200 flow
    iterations, then 500 distillation iterations (K=4, 2 states, teacher
    guidance 1.0); the 32-step teacher's per-class sample means within
    relative error 0.45 of the true means, the 2-NFE student's within 0.6,
    each class nearest its own mean, or the run fails.

Around a training run (PR 15):

34. (inside phase 11r's run) ``EvalHook(interval=1, metrics=('latent_fd',
    'clip_score'))`` after each iteration on two prompts with seeded
    FLUX-width embeds (standing for the cache records', so no T5-XXL is
    loaded) and a bf16 VAE decoder attached as in phase 6: 2-NFE 1024x1024
    images of the EMA weights, 2 x 57 K1 launches per evaluation; the grid
    ``work_dir/eval/iter_N.png`` must decode to the evaluation's two images;
    ``eval_clip_score`` a finite number from a CLIP-L folder written at
    ``openai/clip-vit-large-patch14``'s widths (text 768 x 12 layers,
    vision 1024 x 24 layers, patch 14 at 224, projection 768; random fp32
    weights, the toy tokenizer) and run on the card; the TensorBoard hook
    when ``tensorboard`` is installed, the wandb hook (its
    ``metrics.jsonl`` fallback without wandb);
35. (before phase 11r removes its directory) ``python -m
    arcflow_tpu_torch.export_arcflow_to_diffusers`` on phase 11r's
    checkpoint: the 0.65B fp32 EMA adapter with its ``policy_config`` and
    ``config.json``; an ``ArcFluxPipeline`` on the student's own modules
    loads it with ``load_arcflow_adapter`` and draws from the last
    evaluation's seed: its images within EXPORT_IMAGE_ATOL of the
    EvalHook's (bitwise expected), 114 K1 launches; then
    ``tools.save_inference_weights`` on the same checkpoint;
36. (after phase 18, on phase 6's FLUX-12B) a 2-NFE image with ControlNet
    residuals (5 joint samples on the interval map, then on the repeat
    map, 10 single samples, (1, 4096, 3072) bf16) and one with the
    Flux-fill inputs through a temporary 384-wide ``x_embedder`` (64
    latent + 64 masked-image + 256 mask features): finite, off the plain
    image, 114 K1 launches each; then 2 + 2-block reductions of each
    against the plain attention within SLICE_REL_L2;
37. the tools that compute on the card: (inside phase 24, on its
    pipeline and towers) the gradio app's ``generate`` callback for one
    1024x1024 image, bitwise the pipeline's image for the generator it
    seeds; ``python -m arcflow_tpu_torch.tools.validate_toy_e2e`` with its
    own flags, 3000 + 800 iterations, above its 2-NFE bar of 0.5, in a
    process of its own alongside phases 28r-30, 26 and 23; (after phase 23)
    ``tools.cache_imagenet_data_sdvae`` on seeded 256^2 images, its
    records read back by ``ImageNet`` as the encoder's latents.
    ``tools.cache_image_prompt_data`` writes its records with the
    ``zstandard`` package, which the card's machine lacks (it reads such
    records through the native loader, phase 43): the phase says it did
    not run it.
38. (right after phase 11r, on phase 11's model, state and batch) FLUX-12B
    training with every attention on ``LocalRing(4)``: from one state
    snapshot, the one-device step, the one-device step with every
    attention backward zeroed, the ring step with a planted fault (shard
    0's dK / dV accumulators not sent home), then one counted ring step
    of exactly 12 x 57 x 16 K4, 2 x 57 x 16 K3 and no K1 launches; the
    first against the one-device step (loss, adapter gradients, the
    adapter's update within TRAIN_SLICE_REL_L2; the ring's error over the
    attention backward's share within SP_SHARE_REL_L2, which the fault
    must break); the state is put back after;
39. (inside phase 27, on its model) Qwen (1 joint block, full width, int8
    trunk, 384 of 512 text tokens valid, CFG negatives) with every
    attention on ``LocalRing(4)``: one loss and backward against the one
    without ``sp`` on the same draws (TRAIN_SLICE_REL_L2), the ring's error
    over the attention backward's share within SP_SHARE_REL_L2, which the
    planted fault must break (as phase 38), 192 K4 and 32 key-masked K3
    launches, no K1;
40. (right after phase 38, on phase 11's model and state) FLUX-12B
    training with its block stacks on ``LocalPipe(2)`` at a batch of 2 in
    2 microbatches (the 38 single blocks pipelined, the 19 joint blocks
    plain): from one state snapshot, the one-device step at batch 2, the
    step with a planted fault (stage 1 fed zeros for stage 0's handoff),
    then one counted pipelined step of exactly 12 x (19 + 38 x 2) K1 and
    2 x (19 + 38 x 2) K3 launches; the first against the one-device step
    (loss, adapter gradients, the adapter's update within
    TRAIN_SLICE_REL_L2, which the fault must break); s per step and peak;
41. (after phase 22, phase 6's model freed, its VAE, embeds and latents
    kept) the MoE FFN at FLUX-12B width: 2 + 2 blocks with
    ``moe_experts=1`` at capacity 1 and the dense FFN's weights in the
    expert against the dense blocks (MOE_DENSE_REL_L2), then FLUX-12B with
    ``moe_experts=2`` (fp32 experts) for a 2-NFE 1024^2 image: 114 K1, s
    per image, peak memory. Inside phase 23 the MoE toy
    (``configs/toy/checkerboard_arcflow_2nfe_moe.py``) trains through the
    CLI beside the dense student from the same teacher and must pass
    ``tests/test_quantized_quality.py``'s bars.
42. the ``tensor`` split on one card (``parallel/tensor.py``,
    ``LocalTensor(2)``): 42a (after phase 19) K1, K2 (4480 of 4608 keys)
    and K3 on one shard's heads at t = 2 and 4 (B1 S4608 H12 and H6) and
    K5 at Qwen-Image's column and row shard shapes at t = 2, each against
    its plain version, timed beside its bound and the library call; 42
    (after phase 18, on phase 6's model) FLUX-12B bf16 with every block
    split at JAX's default ``min_size`` (171 units): a 2-NFE 1024^2 image
    with exactly 2 x 57 x 2 K1 launches at H12, its latents against phase
    6's within TP_IMAGE_REL_L2, s per image and one profiled image; single
    block 0's row-split ``proj_out`` against the whole layer on the same
    fused input, and with the planted fault of its rows taken as one
    contiguous half (not its heads' and hidden units' two segments), which
    must break TP_PROJ_OUT_REL_L2; 42b (after phase 21) the same model
    w8a8, its image against the one-device w8a8 image, single block 0's
    row-parallel w8a8 ``proj_out`` against the whole layer, and with the
    planted per-shard activation absmax, which must break
    TP_W8A8_LAYER_REL_L2; 42c (after phase 25, on phase 8's model)
    Qwen-Image 20B w4a8 (300 units): 2 x 60 x 2 K2 and 2 x (3 + 2 x 840)
    K5 launches, counted by shape, the image against one device's on the
    same embeds.

The frozen weights' placement and the native loader (phases 43-45, in a
child process started with phases 32-33's, beside phases 28r-30, 26, 23
and 37; ``python3 chip_smoke.py --placement FILE`` runs them alone):

43. the native loader (``data/_fastloader``): whether g++ finds
    ``zstd.h`` and where libzstd is; where both are, the loader must build
    into ``build/arcflow_tpu_torch/`` and ``ImagePrompt.getitems`` must
    decode, in one batch through it, a cache of 8 records written with
    libzstd (FLUX embeds 512 x 4096 + 768 bf16 and 16 x 128 x 128 latents,
    half the frames without their content size), every array bitwise its
    record, with the decode's MB/s; elsewhere the phase says it did not
    run and why;
44. each shipped quantized-trunk config (``arcflux_2nfe_k16_int8trunk``,
    ``_int4trunk``, ``arcqwen_2nfe_k16_int8trunk``) at full width and
    reduced depth (1 + 2 FLUX blocks, 2 Qwen blocks) through
    ``train_model`` over data=1, fsdp=-1 (FSDP2 at world size 1) against
    the same config without a mesh: the int8 / int4 kernels and their
    scales sharded beside FSDP2's units (``parallel/fsdp.py:_QuantShards``)
    with the one-device values, unchanged by the step; 12 / 2 K1 (K2 for Qwen) / K3 launches per block and
    iteration; the loss and the timestep embedder's gradients within
    TRAIN_SLICE_REL_L2;
45. FLUX at full width and 2 + 4 blocks served 2-NFE at 1024^2 with both
    stacks on ``LocalPipe(2)`` against the plain loop: 12 K1 launches, the
    latents within SP_IMAGE_REL_L2.

``python3 chip_smoke.py --ranks 4 --placement-only`` (four cards) serves
FLUX-12B at ``fsdp=4``, ``fsdp=2 x tensor=2`` and ``data=2 x pipe=2``,
Qwen-Image 20B w4a8 at ``fsdp=4`` and FLUX-12B with ``moe_experts=2`` at
``pipe=2 x expert=2`` through ``pipe.shard`` (batch 1, whole on every
rank), each rank first making the one-card image of the same weights: the
launches per rank, every rank's latents bitwise rank 0's and within
TP_IMAGE_REL_L2 / TP_QUANT_IMAGE_REL_L2 of one card's, the weights a rank
holds (at most 1.02 / fsdp of them under fsdp), s per image, resident
and peak memory and one profiled image's NCCL share; then trains the
Qwen-Image 20B int8-trunk config over its shipped mesh (data=2, fsdp=-1)
at 1 row a rank, 2 iterations, its trunk sharded: the launches, the
losses on every rank, the trunk's bytes a rank holds, every rank's shards
against the trunk gathered whole and the checkpoint gathered from data
replica 0, s per iteration, peaks and the NCCL share of one profiled step.

``python3 chip_smoke.py --ranks 4 --tensor-only`` (four cards) serves
FLUX-12B at ``tensor=4`` and at ``sp=2 x tensor=2`` (Ulysses and ring)
and Qwen-Image 20B w4a8 at ``tensor=4`` through ``pipe.shard``, each
rank first making the one-card image of the same weights: the launches
per rank, every rank's latents bitwise rank 0's and within
TP_IMAGE_REL_L2 / TP_QUANT_IMAGE_REL_L2 of one card's, the weights a rank
holds (at most 1.1 / t of the blocks'), s per image, resident and peak
memory and one profiled image's NCCL share; then trains FLUX-12B through
``train_model`` with ``tensor_axis='tensor'`` at ``fsdp=2 x tensor=2`` and
``data=2 x tensor=2`` (phase 31's cuts, 2 iterations) against the
parent's one-card first iteration on the same 2 rows, in
``check_pe_ranks``' form, with s per iteration, peaks and the NCCL share
of one profiled step.

``python3 chip_smoke.py --ranks 4`` (four cards) instead spawns 4 NCCL
ranks and serves FLUX-12B through ``pipe.shard({'sp': 4})`` in ring and in
Ulysses mode, against one card and against ``LocalRing(4)``; then trains,
in 4 fresh ranks, the shipped FLUX-12B config (phase 31's cuts, 2
iterations) and the Qwen-Image 20B int8-trunk config (its shipped 4 rows a
rank in 4 micro-batches, 1 iteration) over their mesh as shipped (data=2,
fsdp=-1 -> 2 x 2): the launches per iteration, every rank's shards and
generator equal to their parts of the checkpoint gathered from data
replica 0, the FLUX checkpoint restored on the same ranks bitwise, per
rank s per iteration, peak memory and the profiler's NCCL all-gather /
reduce-scatter time of one more step, and FLUX's step with the LoRA
dropout drawn as now, as before (every rank drawing the whole global
batch's masks) and off; then FLUX-12B trained under ``sp`` through
``train_model`` with the config's mesh overridden (``sp=4`` ring, ``sp=4``
Ulysses, ``fsdp=2 x sp=2`` ring; 2 iterations each, phase 31's cuts)
against one card's first iteration on the same rows (the parent's, before
the ranks start): the launches per rank and iteration, every rank's
losses equal to rank 0's, the loss and the timestep embedder's gradients
within TRAIN_SLICE_REL_L2 and the adapter's update nonzero and within
SP_UPDATE_REL_L2, s per iteration and peak memory per rank. ``--ranks 4
--train-only`` runs the training alone, ``--ranks 4 --sp-train-only`` the
``sp`` training alone. ``--ranks 4 --pipe-expert-only`` trains FLUX-12B
through ``train_model`` with ``configs/flux/_pipeline_train.py``'s
``parallel`` composed in at ``data=2 x pipe=2`` and the MoE FLUX-12B
(``moe_experts=2``) at ``pipe=2 x expert=2`` (2 iterations each, phase
31's cuts), each against one card's first iteration on the same rows in
``check_sp_ranks``' form, with s per iteration, the peak per rank and the
NCCL share of one profiled step's wall.

Then one JSON line of per-kernel numbers (each with its bound on the card
and the time of one PyTorch library call for the same function, where there
is one), the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import gc
import importlib
import itertools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from arcflow_tpu_torch import MODELS, MODULES, Config
from arcflow_tpu_torch.apis import (build_model_from_cfg, ema_config_from_cfg,
                                    init_model)
from arcflow_tpu_torch.data import BucketizedBatchSampler, CheckerboardData
from arcflow_tpu_torch.models import (ArcDenoisingUnetMod,
                                      ArcFluxTransformer2DModel,
                                      ArcQwenImageTransformer2DModel,
                                      Diffusion2D, LatentDiffusionClassImage,
                                      PretrainedVAE, PretrainedVAEQwenImage)
from arcflow_tpu_torch.models import layers
from arcflow_tpu_torch.models.layers import LoRADense
from arcflow_tpu_torch.ops import _build
from arcflow_tpu_torch.ops import attention as attn
from arcflow_tpu_torch.ops import flash_int8 as fi8
from arcflow_tpu_torch.ops import int8_matmul as i8
from arcflow_tpu_torch.ops import quant_matmul as qmm
from arcflow_tpu_torch.ops import ring_hop as hop
from arcflow_tpu_torch.ops.gm import gm_ops
from arcflow_tpu_torch.ops.gm import inverse_cdf as icdf
from arcflow_tpu_torch.apis import train as t_train
from arcflow_tpu_torch.parallel import (LocalPipe, LocalRing,
                                        SequenceParallel, ring_attention,
                                        set_pipe, set_sequence_parallel,
                                        setup_distributed, spawn)
from arcflow_tpu_torch.parallel import mesh as mesh_mod
from arcflow_tpu_torch.parallel import tensor as tensor_mod
from arcflow_tpu_torch.parallel.fsdp import is_sharded, local, shard_of
from arcflow_tpu_torch.parallel.mesh import batch_ranks
from arcflow_tpu_torch.registry import DATASETS
from arcflow_tpu_torch.runner.runner import to_device
from arcflow_tpu_torch.pipelines import ArcFluxPipeline, ArcQwenImagePipeline
from arcflow_tpu_torch.runner import (CheckpointHook, CheckpointManager,
                                      EmaConfig, Hook, IterBasedRunner,
                                      IterTimerHook, QuartileLossLoggerHook,
                                      TrainState, build_hooks,
                                      build_optimizers, build_train_step,
                                      count_params, load_raw_checkpoint)
from arcflow_tpu_torch.diffusion.schedulers import FlowUniPCScheduler
from arcflow_tpu_torch.utils.metrics import latent_frechet_distance
from arcflow_tpu_torch.utils.pytree import flatten
from arcflow_tpu_torch.utils.quantize import pack_int4

# the module, which the package's ``ring_attention`` function shadows
ring_mod = importlib.import_module(
    'arcflow_tpu_torch.parallel.ring_attention')

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FLUX_12B = dict(in_channels=64, num_layers=19, num_single_layers=38,
                attention_head_dim=128, num_attention_heads=24,
                joint_attention_dim=4096, pooled_projection_dim=768,
                num_gaussians=16, lora_rank=0)
FLUX_SHAPE = (1, 4608, 24, 128)
# the Qwen path's masked attention: 512 text tokens of which 384 are valid,
# then 4096 image tokens, so 4480 of 4608 keys are valid
QWEN_VALID_KEYS = 4480
# FLUX-12B ArcFlow distillation, batch 1: configs/flux/arcflux_2nfe_k16.py
# (model, train_cfg, optimizer, EMA hook, log_config) through the port's
# Config and MODELS. The config sets no frozen_dtype, and the port's
# default fp32 trunk would not leave room on the card: the frozen trunk is
# bf16. Its parallel (a TPU mesh) and data (ImagePrompt) are not used: the
# phases feed their own batches.
FLUX_TRAIN_CONFIG = 'configs/flux/arcflux_2nfe_k16.py'
# (trainable, frozen) parameters it builds: the fp32 adapter (LoRA rank 256
# on every block, the three heads, norm_out) and the bf16 trunk plus the
# teacher's head
FLUX_TRAIN_PARAMS = (652_405_884, 11_901_408_320)
# phase 11r: runner iterations from phase 11's step, and the one after
# which a hook raises SIGTERM (the runner must stop there, saved)
RUNNER_ITERS, RUNNER_SIGTERM_AFTER = 3, 2
# bare steps of phases 11 and 28 (phases 38-39 took the time of a third
# step of each, and of phase 31's third iteration)
TRAIN_STEPS = 2
# free disk the phase 11r checkpoint needs beyond its own bytes
CKPT_DISK_MARGIN = 2 ** 30
# DiT forwards per train step: nfe student forwards with grad, nfe x
# num_intermediate_states teacher forwards, and the nfe student forwards
# recomputed block by block in the backward. The Qwen teacher's CFG runs
# the negative and the positive prompt as one batch of 2, one forward, so
# the counts hold for it too: 12 x 60 K2 and 2 x 60 K3 launches per
# Qwen-Image 20B step
TRAIN_FORWARDS = 2 + 2 * 4 + 2
TRAIN_BACKWARDS = 2
# Qwen-Image 20B ArcFlow distillation with an int8 frozen trunk (phases
# 27-30): configs/qwen/arcqwen_2nfe_k16_int8trunk.py through the port's
# Config and MODELS, every parallel.mesh axis set to 1 (one card) and
# total_iters its only overrides
QWEN_TRAIN_CONFIG = 'configs/qwen/arcqwen_2nfe_k16_int8trunk.py'
# (trainable, frozen) parameters it builds. The fp32 adapter: LoRA rank 256
# on the four MLP projections of each of the 60 blocks (60 x 4 x 256 x
# 15,360 = 943.7 M) and on the timestep embedder (2.4 M), the three heads
# (3.5 M) and norm_out (18.9 M). The frozen trunk: 20,405,747,712 int8
# kernel elements in 844 layers (14 per block, img_in, txt_in, the two
# timestep-embedder linears), their fp32 scales, the bf16 rest and the
# teacher's bf16 head (norm_out, proj_out)
QWEN_TRAIN_PARAMS = (968_551_548, 20_435_942_976)
QWEN_INT8_LAYERS = 14 * 60 + 4
# the negative prompt's valid text tokens (the prompt's: QWEN_TXT_VALID)
QWEN_NEG_VALID = 128
# with one joint block the timestep embedder's LoRA is the adapter upstream
# of an attention (it feeds the block's modulations)
QWEN_UPSTREAM_OF_ATTENTION = ('timestep_embedder.',)
# phase 27's bound on the kernels' error over the attention backward's
# share of those gradients. The share is one path (the block's
# modulations) through two backward calls (the NFE steps), each of whose
# dq, dk and dv carry the kernels' bf16 rounding of P and dS (a few 1e-3
# by relative L2, phase 9); summed into four LoRA tensors whose signal
# partly cancels across tokens, it read up to 2.7e-2 on a sound run
# (NVIDIA H100 80GB HBM3, 700 W), above phase 10's 2e-2, which bounds a
# share that several blocks carry. The planted dq-zeroed fault must still
# break this bound.
QWEN_SHARE_REL_L2 = 5e-2
# phase 28r: iterations of phase 28's state through the runner
QWEN_RUNNER_ITERS = 2
# phase 30: the CLI's run, depth cut to this; one bucket of prompts per
# resolution, each one global batch, so the two iterations are one epoch
# and train each resolution once
QWEN_CLI_LAYERS, QWEN_CLI_ITERS = 2, 2
QWEN_CLI_SIZES = (1024, 768)
# profiler windows kernel_ms runs before it gives up on missing records
KERNEL_MS_WINDOWS = 6
# H100 SXM dense peaks and memory rate (NVIDIA's data sheet), for the bound
H100_BF16, H100_INT8, H100_BYTES = 989e12, 1979e12, 3.35e12
# fp32 outside the tensor cores (NVIDIA's data sheet: 67 TFLOP/s), and the
# special-function units: 16 results per clock per SM for exp2, sin, rsqrt
# and the like (CUDA C++ Programming Guide, throughput of arithmetic
# instructions, compute capability 9.0) x 132 SMs x the 1.98 GHz boost
# clock of the data sheet
H100_FP32, H100_SFU = 67e12, 16 * 132 * 1.98e9
# the KR transport at the ArcFlux head geometry: K=16 heads
# (configs/flux/arcflux_2nfe_k16.py) over the 128 x 128 x 16 latent of a
# 1024^2 image (the FLUX config's latent_shape), one draw, 16 NR steps,
# no grad
KR_K, KR_LATENT, KR_STEPS, KR_LOGSTD = 16, (128, 128, 16), 16, -1.0
K6_LARGE_HW = (1024, 1024)              # 64 x the 16,384 elements of an axis
# kernel vs plain, per unsaturated element (|target| < 0.999): both run the
# same fp32 steps with sums in another order, so their cdfs differ by a few
# 1e-7 and a root moves by that over the slope 2 pdf
K6_ATOL, K6_CDF_TOL = 1e-5, 1e-6
# KR on the card: kernel path vs plain path, relative L2 over the pixels
# whose every axis is unsaturated; and the round trip z -> x -> z, max abs
# error there (about 4e-5 in a CPU rehearsal at 96 x 96)
KR_REL_L2, KR_ROUND_TRIP = 1e-4, 1e-3
# configs/gmflow/checkerboard_gmflow.py:6-44 (model, train_cfg, test_cfg,
# optimizer, data, EMA hook)
CKB_MODEL = dict(
    data_shape=(1, 1, 2), diffusion_use_ema=True,
    diffusion=dict(
        type='GMFlow',
        denoising=dict(type='ToyGMFlowDenoiser', out_channels=2,
                       num_gaussians=8, hidden=(256, 256, 256),
                       num_timesteps=1000),
        flow_loss=dict(type='GMFlowNLLLoss', data_info=dict(
            pred_means='means', target='x_t_low', pred_logstds='logstds',
            pred_logweights='logweights')),
        num_timesteps=1000,
        timestep_sampler=dict(type='ContinuousTimeStepSampler', shift=1.0)))
CKB_TRAIN_CFG = dict(trans_ratio=1.0, diffusion_grad_clip=10.0)
CKB_TEST_CFG = dict(sampler='FlowEulerODE', num_timesteps=16,
                    output_mode='mean', order=2, num_substeps=2)
CKB_OPT = dict(diffusion=dict(type='AdamW', lr=1e-3, weight_decay=0.0))
CKB_EMA_HOOK = dict(type='ExponentialMovingAverageHookMod',
                    module_keys=('diffusion_ema',), interp_mode='lerp',
                    interval=1, start_iter=100, momentum_policy='karras',
                    momentum_cfg=dict(gamma=7.0))
CKB_BATCH, CKB_STEPS, CKB_SAMPLES = 512, 1000, 4096
# phase 23: the toy stack through the CLI on the card, with the cuts and
# the in-support gates of tests/test_e2e_checkerboard.py
TOY_FLOW = ('configs/toy/checkerboard_flow.py', {
    'model.diffusion.denoising.hidden': (128, 128), 'data.train.n_rc': 2,
    'data.train_dataloader.samples_per_gpu': 512, 'total_iters': 3000,
    'checkpoint_config.interval': 1000, 'log_config.interval': 1000})
TOY_DISTILL = ('configs/toy/checkerboard_arcflow_2nfe.py', {
    'model.diffusion.denoising.hidden': (128, 128),
    'model.teacher.denoising.hidden': (128, 128), 'data.train.n_rc': 2,
    'data.train_dataloader.samples_per_gpu': 256, 'total_iters': 800,
    'train_cfg.num_decay_iters': 300, 'checkpoint_config.interval': 800,
    'log_config.interval': 400})
TOY_FLOW_SUPPORT, TOY_DISTILL_SUPPORT = 0.75, 0.5
# the MoE toy (configs/toy/checkerboard_arcflow_2nfe_moe.py) with the dense
# student's cuts, trained alongside it from the same teacher, and the bars
# of tests/test_quantized_quality.py:191-232: its in-support share above
# 0.6, within 0.10 of the dense student's, every router column's norm
# above 1e-3
TOY_MOE = ('configs/toy/checkerboard_arcflow_2nfe_moe.py', TOY_DISTILL[1])
TOY_MOE_SUPPORT, TOY_MOE_MARGIN, TOY_MOE_ROUTER_NORM = 0.6, 0.10, 1e-3
TOY_CLI_TIMEOUT = 300
# phases 32-33: the class-conditional ImageNet path (configs/imagenet)
IMAGENET_FLOW = 'configs/imagenet/imagenet256_flow.py'
IMAGENET_DISTILL = 'configs/imagenet/imagenet256_arcflow_2nfe.py'
# DenoisingUnetMod (flow, teacher) and ArcDenoisingUnetMod K=8 (student)
# at the shipped widths, as jax.eval_shape counts the JAX modules
IMAGENET_PARAMS = (67_481_988, 67_531_567)
IMAGENET_LATENT = (32, 32, 4)
IMAGENET_FILES = 256           # synthetic cached latents (the data cut)
IMAGENET_ITERS = (5, 5)        # flow, distillation (the iteration cut)
IMAGENET_SAMPLES = 64
IMAGENET_SOLVERS = ('FlowDPMSolver', 'FlowUniPC', 'FlowDEIS', 'FlowSASolver')
IMAGENET_SOLVER_STEPS = 8
# the small UNet and a solver step on the card against the CPU, TF32 off
# (tests/test_torch_imagenet_cuda.py's limits)
IMAGENET_CARD_REL_L2, IMAGENET_STEP_ATOL = 1e-4, 1e-5
# phase 33: tests/test_e2e_imagenet.py's recipe, sizes and bars
E2E_CLASSES, E2E_LAT = 4, (8, 8, 4)
E2E_UNET = dict(base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                attn_resolutions=(4,), num_classes=E2E_CLASSES, num_heads=4)
E2E_TINY = {'model.num_classes': E2E_CLASSES, 'model.latent_shape': E2E_LAT,
            **{f'model.diffusion.denoising.{k}': v
               for k, v in E2E_UNET.items()},
            'data.train_dataloader.samples_per_gpu': 64,
            'log_config.interval': 500}
E2E_DISTILL = {**{f'model.teacher.denoising.{k}': v
                  for k, v in E2E_UNET.items()},
               'model.diffusion.denoising.num_gaussians': 4,
               'train_cfg.num_decay_iters': 200,
               'train_cfg.num_intermediate_states': 2,
               'train_cfg.teacher_guidance_scale': 1.0}
E2E_FLOW_ITERS, E2E_DISTILL_ITERS = 1200, 500
E2E_TEACHER_REL, E2E_STUDENT_REL = 0.45, 0.6
IMAGENET_TIMEOUT = 600
# configs/qwen/arcqwen_2nfe_k16.py and bench.py:build_qwen
QWEN_20B = dict(in_channels=64, num_layers=60, attention_head_dim=128,
                num_attention_heads=24, joint_attention_dim=3584,
                max_text_len=512, num_gaussians=16, lora_rank=256)
QWEN_TXT, QWEN_TXT_VALID, QWEN_SHIFT = 512, 384, 3.1
# int4 layers per joint block: 2 AdaLN modulations, 8 attention projections,
# 4 MLP projections; plus txt_in and the two timestep-embedder linears
# (img_in's 64 inputs are not a multiple of the 128 group; norm_out and the
# heads are the adapter surface)
INT4_PER_BLOCK, INT4_OUTSIDE_BLOCKS = 14, 3
# (M, K, N) of every int4 layer of the Qwen path: image and text streams
# (4096 and 512 tokens), txt_in, the modulations and the timestep embedder
W4A8_SHAPES = [(4096, 3072, 3072), (4096, 3072, 12288), (4096, 12288, 3072),
               (512, 3072, 3072), (512, 3072, 12288), (512, 12288, 3072),
               (512, 3584, 3072), (1, 3072, 18432), (1, 256, 3072),
               (1, 3072, 3072)]
W4A8_TIMED = [(4096, 3072, 12288), (4096, 12288, 3072)]
# ragged M and N, each at groups 32, 64 and 128 over K = 384: rows and
# columns off the kernel's 128 x 128 tiles and its 8-token tile, N off the
# 16 bytes a TMA row steps in
W4A8_RAGGED_M, W4A8_RAGGED_N = (1, 3, 130, 511, 513, 777, 4097), (136, 264)
# w4a8 kernel vs plain: each per-group partial sum is an exact integer in
# both (int32 in the kernel, fp32 below 2^24 in the plain version, TF32
# off), so they differ only in how the fp32 sum over groups rounds; each
# output must lie within 1e-6 of its own sum_k |x| |w| scale
W4A8_TOL = 1e-6
# bf16 output of the kernel vs the fp32 plain version cast to bf16: the
# kernel rounds P to bf16 before P.V (8 significant bits), so a few bf16
# ulps of O, whose values are O(1)
O_TOL = 2e-2
# fp32 softmax statistics from bf16 products summed in another order
LSE_TOL = 1e-3
# relative L2 of ``means`` after 1 + 1 full-width blocks in bf16: the kernel
# and the plain path differ by bf16 rounding of P (2^-8 relative) mixed into
# the residual stream; 2e-2 leaves a few ulps of headroom
SLICE_REL_L2 = 2e-2
# relative L2 of ``means`` after 1 full-width Qwen block in w4a8, w4a8
# kernel vs its plain version: their layer outputs differ by fp32 rounding
# of the sum over groups, which flips a bf16 rounding now and then. A flip
# in a token's largest element changes its activation scale (absmax / 127),
# so the whole token re-rounds and many of its int8 values move one step
# (1/127 of the absmax) downstream: bf16 noise of the size of one bf16 ulp
# (2^-8) over the block, as in the FLUX slice above, hence the same 2e-2. A
# layout, sign or scale error in the kernel moves ``means`` by O(1).
QWEN_SLICE_REL_L2 = 2e-2
# kernel vs plain backward, per gradient: relative L2 of dq, dk, dv. The
# kernels round P and dS to bf16 (8 significant bits) before their products
# and write bf16 gradients: a few bf16 ulps of noise, 2^-8 = 4e-3 each
BWD_REL_L2 = 2e-2
# reduced training slice, kernels vs plain, relative L2 of the loss and of
# all adapter gradients together: the forward differs by the bf16 rounding
# of P (about 5e-3 after 2 blocks, phase 5), the teacher targets as much,
# and the backward adds the bf16 rounding of P and dS in each block's
# gradient; 5e-2 is ten times that and far below the O(1) of a wrong
# gradient. Most of that norm is the heads' and the last block's, whose
# gradients pass through no attention backward, and at random weights the
# attention backward carries a small share of the rest (the residual stream
# carries most). So the phase also isolates the backward: under the
# kernels' forward, each adapter tensor upstream of an attention call (the
# timestep embedder's LoRA feeds every block's modulation, the joint
# block's LoRA feeds the single block) takes the kernels' backward, the
# plain one, and the plain one with its outputs zeroed; the kernels' error
# over the share the attention backward carries (plain minus zeroed) is
# bounded at BWD_REL_L2, the per-gradient bound of phase 9. A planted fault,
# the plain backward with dq zeroed, must break that bound.
TRAIN_SLICE_REL_L2 = 5e-2
UPSTREAM_OF_ATTENTION = ('time_text_embed.', 'joint_blocks.')
# device time by kernel family in the profile: the first family with a
# substring in the kernel's name takes it (cuDNN's implicit-GEMM convs
# before cuBLAS's GEMMs)
KERNEL_FAMILIES = (('NCCL', ('nccl',)), ('w4a8 kernel', ('w4a8_matmul',)),
                   ('ring hop kernel', ('ring_hop',)),
                   ('int8 GEMM (cuBLASLt)', ('s8s8', 'i8i8', 'imma',
                                             'int8', '_s8_')),
                   ('attention backward kernels', ('attention_bwd',)),
                   ('attention kernel', ('attention_fwd',)),
                   ('optimizer and EMA (foreach)', ('multi_tensor_apply',)),
                   ('convolution', ('conv', 'cudnn', 'fprop', 'implicit',
                                    'nchwToNhwc', 'nhwcToNchw')),
                   ('cuBLAS GEMM', ('gemm', 'nvjet', 'cutlass')),
                   ('reduction', ('reduce_kernel',)),
                   ('elementwise and copies', ('elementwise', 'copy',
                                               'Memcpy', 'Memset')))
# sequence parallelism: the FLUX sequence in 4 shards of 1152 tokens
SP = 4
# the ring hop (K4) and the ring against their fp32 plain versions, on O
# (bf16) and on the normalized carry acc / l (fp32): every element within
# K4_ATOL + K4_RTOL |ref| and the whole within K4_REL_L2 by relative L2.
# The kernel rounds P to bf16 (2^-9 relative) before P.V: a sound run reads
# up to 1.2e-3 on acc / l and one bf16 ulp of O (at most 2^-7 of |O|), and a
# few 1e-3 by relative L2. A dropped hop, a V tile read with its key rows
# out of place or a carried acc left unscaled moves O by a tenth of its
# norm or more; phases 15 and 16 plant such faults and require that both
# limits refuse each.
K4_ATOL, K4_RTOL, K4_REL_L2 = 2e-3, 2 ** -7, 1e-2
# FLUX-12B under a ring against the same image on the attention kernel,
# relative L2 of the latents: 57 blocks of random weights amplify the bf16
# rounding by which the ring's hop-by-hop softmax and the one-pass kernel
# differ (phase 17 measures it after 2 blocks; a sound image reads about
# 1e-2), so the bound is three times that; phase 18 plants a lost rotation
# and requires that the bound refuse it
SP_IMAGE_REL_L2 = 3e-2
# int8 layers of FLUX-12B under quantize_weights_int8's skip rules: 14 per
# joint block (2 modulations, 8 attention projections, 4 MLP projections),
# 6 per single block (modulation, q, k, v, proj_mlp, proj_out), and
# x_embedder, context_embedder and the six embedder linears (timestep,
# guidance, pooled text); norm_out and the heads are the adapter surface
INT8_PER_JOINT, INT8_PER_SINGLE, INT8_OUTSIDE_BLOCKS = 14, 6, 8
# (M, K, N) of every int8 layer of the FLUX path at batch 1: the image
# stream (4096 tokens) and the text stream (512) of the joint blocks, the
# 4608 tokens of the single blocks, the modulations and embedders (M = 1)
INT8_SHAPES = [(4096, 64, 3072), (4096, 3072, 3072), (4096, 3072, 12288),
               (4096, 12288, 3072), (512, 4096, 3072), (512, 3072, 3072),
               (512, 3072, 12288), (512, 12288, 3072), (4608, 3072, 3072),
               (4608, 3072, 12288), (4608, 15360, 3072), (1, 256, 3072),
               (1, 768, 3072), (1, 3072, 3072), (1, 3072, 18432),
               (1, 3072, 9216)]
INT8_TIMED = [(4608, 15360, 3072), (4608, 3072, 12288)]
# relative L2 of ``means`` after 1 + 1 full-width blocks under w8a8, the
# card against the plain attention and plain int8 product. The int8
# product is exact on both sides (phase 20 also requires the card's
# layers with the plain product to equal the card bit for bit), so the
# whole difference is the attention's bf16 rounding of P (phase 5: about
# 5e-3), which w8a8 amplifies: an activation moved by it may round to a
# neighbouring int8 step, and a moved token maximum re-rounds the whole
# token. A sound run read 1.98e-2 (NVIDIA H100 80GB HBM3, 700 W), so the
# bound is 5e-2; an attention fault moves ``means`` by O(1). The bound is
# not meant to tell w8a8 from bf16 (their own distance is 4.5e-2): the
# launch counts and the bitwise check of the int8 product do that.
W8A8_SLICE_REL_L2 = 5e-2
# FLUX-12B latents under w8a8 (or weight-only int8) against the bf16 image
# of phase 6, relative L2: the quantization's own error, 4.5e-2 after 2
# blocks in phase 20 and about as much after 57 at random weights (4.4e-2
# and 3.2e-2 read on NVIDIA H100 80GB HBM3, 700 W); the bound is three
# times that. A broken layout or scale moves them by O(1).
INT8_IMAGE_REL_L2 = 0.15
# K7 against its fp32 plain version (bf16 O): every element within
# K7_ATOL + K7_RTOL |ref| and the whole within K7_REL_L2 by relative L2.
# Both compute the same exact int8 scores; the kernel rounds P to bf16
# (2^-9 relative) before P.V, as K1 and K4 do, so the limits are K4's.
# Planted faults (k scales dropped, key rows swapped in one tile) must
# break both. On real q, k, v, K7 against K1 by cosine, the property
# tests/test_flash_int8.py:test_close_to_full_precision_attention pins.
K7_ATOL, K7_RTOL, K7_REL_L2, K7_COSINE = 2e-3, 2 ** -7, 1e-2, 0.999
# ``--ranks``: Qwen w4a8 at full width and this depth, its text mask sharded
# with the text tokens and rotated with the K/V blocks
RANKS_QWEN_LAYERS = 2


T0 = time.perf_counter()


def log(line):
    """A phase's line, with the seconds since the script started."""
    print(f'{line} [{time.perf_counter() - T0:.1f} s]', flush=True)


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def roofline(ops, nbytes, peak):
    """The least time (ms) the card could take for ``ops`` operations at
    ``peak`` per second and ``nbytes`` moved at the memory rate, and which
    of the two bounds it."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / H100_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def attention_bound(shape, valid_keys=None, backward=False):
    """Roofline of attention at (B, S, H, D) over ``valid_keys`` keys (all
    by default): forward QK^T and PV, 4 S Sk D H FLOP, reading q, k, v and
    writing o and the LSE; backward S, dP, dV, dK and dQ, 10 S Sk D H FLOP,
    reading q, k, v, o, dO and the LSE, writing dq, dk, dv. Only the valid
    keys' rows of k and v (and dk, dv) count as work."""
    b, s, h, d = shape
    kv = s if valid_keys is None else valid_keys
    row = b * h * d * 2                        # one bf16 row of all heads
    if backward:
        ops = 10 * b * h * s * kv * d
        nbytes = 4 * s * row + 4 * kv * row + b * h * s * 4
    else:
        ops = 4 * b * h * s * kv * d
        nbytes = 2 * s * row + 2 * kv * row + b * h * s * 4
    if valid_keys is not None:
        nbytes += b * s                        # the key mask
    return roofline(ops, nbytes, H100_BF16)


def sdpa(q, k, v, kv_valid=None):
    """One ``scaled_dot_product_attention`` call on the (B, S, H, D) tensors
    (head-major views, no copies): the library yardstick, never on the
    port's path."""
    mask = None if kv_valid is None else kv_valid[:, None, None, :]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask).transpose(1, 2)


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, name, iters):
    """Mean device time per launch of the kernel whose name holds ``name``
    (per call, of every kernel the call runs, with ``name`` None), over
    ``iters`` calls of ``fn`` under ``torch.profiler`` after two warm-up
    calls: the device's own time where a call is too short for CUDA events
    around it to see past the host's launch cost. The profiler drops kernel
    records of such short calls in every window once the process has run
    large traces (the model phases' profiles, up to 168k kernels in phase
    28; see ``profiler_drop_probe.py``): phase 15 kept 23 of 50 in each
    window after the FLUX phases. Each kept record is one launch's device time, so
    a named kernel's mean is taken over the records kept across windows,
    run until they number ``iters``, up to ``KERNEL_MS_WINDOWS`` windows;
    the per-call sum (``name`` None) needs a window that kept whole
    calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    kept = []
    for _ in range(KERNEL_MS_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (name is None or name in e.name)]
        if name is None and len(us) >= iters and len(us) % iters == 0:
            return sum(us) / iters / 1e3
        if name is not None and len(us) == iters:
            return sum(us) / len(us) / 1e3
        if name is not None:
            kept += us
            if len(kept) >= iters:
                return sum(kept) / len(kept) / 1e3
    raise AssertionError(f'the profiler kept {len(kept)} kernel records of '
                         f'{name or "whole calls"} over {KERNEL_MS_WINDOWS} '
                         f'windows of {iters} calls')


def ptxas_usage(kernel):
    """Registers and spills that ``-Xptxas -v`` reported for the kernel
    whose mangled name holds ``kernel``, from the build log."""
    log = _build.library_path().with_suffix('.log').read_text().splitlines()
    usage, current = [], None
    for line in log:
        if 'Compiling entry function' in line:
            current = line
        elif current and kernel in current and (
                'spill' in line or 'registers' in line):
            usage.append(line.split(':')[-1].strip() if 'registers' in line
                         else line.strip())
    return '; '.join(usage) or 'not in the build log'


def phase_facts():
    if not torch.cuda.is_available():
        raise SystemExit('FAIL facts: torch.cuda.is_available() is false')
    smi = smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), '--version'],
                          capture_output=True, text=True, check=True)
    log(f'phase 1 facts: ok | nvidia-smi: {smi} | torch {torch.__version__} '
        f'cuda {torch.version.cuda} | devices {torch.cuda.device_count()} | '
        f'nvcc: {nvcc.stdout.strip().splitlines()[-1]} | TPU kernels still '
        f'to port: none')
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    ptxas = [ln.strip() for ln in lib.with_suffix('.log').read_text()
             .splitlines() if 'registers' in ln or 'spill' in ln]
    log(f'phase 2 build: ok in {time.perf_counter() - t0:.1f} s -> '
        f'{lib.name} | ptxas: {" / ".join(ptxas)}')


def planted_k1_fault(q, k, v, ref):
    """Planted fault: key rows 128-191 and 192-255 of K swapped, what a K
    tile landing out of place in the ring does. The kernel on it must break
    phase 3's limit against the sound plain O ``ref``. Returns the
    reading."""
    swap = torch.cat([torch.arange(192, 256), torch.arange(128, 192)]).to(
        k.device)
    k_bad = k.clone()
    k_bad[:, 128:256] = k[:, swap]
    bad = attn.flash_attention_fwd(q, k_bad, v).float()
    err = (bad - ref.float()).abs()
    if not bool((err > O_TOL + O_TOL * ref.float().abs()).any()):
        raise AssertionError(f'K1 planted fault (K tile rows swapped) passes '
                             f'the O limit: max|dO| {err.max().item():.3e}')
    return (f'planted fault, K rows 128-191 and 192-255 swapped: max|dO| '
            f'{err.max().item():.3e}, refused')


def phase_kernel_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED)
    cases = [('flux', FLUX_SHAPE, None), ('ragged', (2, 1000, 4, 128), None),
             ('key_padded', (2, 1000, 4, 128), (900, 1000)),
             ('no_valid_key', (2, 70, 2, 128), (0, 70))]
    worst = 0.0
    parts = []
    for name, shape, lengths in cases:
        q, k, v = (torch.randn(shape, generator=g, device='cuda',
                               dtype=torch.bfloat16) for _ in range(3))
        kv_valid = None
        if lengths is not None:
            kv_valid = torch.arange(shape[1], device='cuda')[None, :] < \
                torch.tensor(lengths, device='cuda')[:, None]
        out, lse = attn.flash_attention_fwd(q, k, v, kv_valid,
                                            return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = attn.attention_ref(q, k, v, kv_valid, return_lse=True)
        torch.testing.assert_close(out.float(), ref.float(), rtol=O_TOL,
                                   atol=O_TOL)
        finite = torch.isfinite(ref_lse)
        if not torch.equal(finite, torch.isfinite(lse)):
            raise AssertionError(f'{name}: LSE finiteness differs')
        torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=0,
                                   atol=LSE_TOL)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse[finite] - ref_lse[finite]).abs().max().item() \
            if finite.any() else 0.0
        worst = max(worst, err)
        parts.append(f'{name} {tuple(shape)} max|dO| {err:.3e} '
                     f'max|dLSE| {lse_err:.3e}')
        if name == 'flux':
            flux_qkv = (q, k, v)
        if name == 'ragged':
            fault = planted_k1_fault(q, k, v, ref)
    q, k, v = flux_qkv
    b, s, h, d = FLUX_SHAPE
    masked = torch.arange(s, device='cuda')[None, :] < QWEN_VALID_KEYS
    timed = {}
    for name, kv_valid in (('unmasked', None), ('masked', masked)):
        ms = cuda_ms(lambda: attn.flash_attention_fwd(q, k, v, kv_valid), 20)
        plain_ms = cuda_ms(lambda: attn.attention_ref(q, k, v, kv_valid), 5)
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: sdpa(q, k, v, kv_valid), 20)
        bound_ms, bound_by = attention_bound(
            FLUX_SHAPE, None if kv_valid is None else QWEN_VALID_KEYS)
        timed[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
    log(f'phase 3 attention kernel vs plain: ok | {" ; ".join(parts)} | '
        f'FLUX shape B{b} S{s} H{h} D{d}: ' + ' ; '.join(
            f'{name}{"" if name == "unmasked" else f" ({QWEN_VALID_KEYS} valid keys)"}'
            f' kernel {t["ms"]:.4f} ms, plain fp32 {t["plain_ms"]:.4f} ms, '
            f'SDPA {t["library_ms"]:.4f} ms, bound {t["bound_ms"]:.4f} ms '
            f'({t["bound_by"]}, {100 * t["bound_ms"] / t["ms"]:.1f}% of it)'
            for name, t in timed.items())
        + f' | ptxas: {ptxas_usage("attention_fwd_kernel")} | {fault}')
    return worst, timed


def w4a8_case(g, m, k, n, group=128):
    """Random int8 activations, int4 weights over [-8, 7] and scales."""
    xq = torch.randint(-127, 128, (m, k), generator=g, device='cuda',
                       dtype=torch.int8)
    q = torch.randint(-8, 8, (k, n), generator=g, device='cuda',
                      dtype=torch.int8)
    scale = 0.01 + 0.05 * torch.rand(k // group, n, generator=g,
                                     device='cuda')
    return xq, q, pack_int4(q, group), scale


def w4a8_check(xq, q, packed, scale):
    """Kernel vs plain at one shape: raises past ``W4A8_TOL``; returns the
    max abs error and the max error over its bound's scale."""
    group = xq.shape[1] // scale.shape[0]
    out = qmm.w4a8_matmul(xq, packed, scale)
    torch.cuda.synchronize()
    ref = qmm.w4a8_matmul_ref(xq, packed, scale)
    scale_k = scale.repeat_interleave(group, dim=0)
    mag = xq.abs().float() @ (q.abs().float() * scale_k)
    err = (out - ref).abs()
    if not bool((err <= W4A8_TOL * mag).all()):
        raise AssertionError(
            f'w4a8 {tuple(xq.shape)} x {tuple(q.shape)} group {group}: '
            f'error {(err / mag.clamp_min(1e-30)).max().item():.3e} of '
            f'sum |x||w|scale > {W4A8_TOL}')
    return err.max().item(), (err / mag.clamp_min(1e-30)).max().item()


def w4a8_epilogue_check(g, xq, packed, scale):
    """The kernel's fused epilogue (row scale, bf16 out) bitwise equal to
    the two-step path (fp32 out, then ``(y * xs).to(bf16)``, what
    ``models/layers.py:_int4_matmul`` computed before), and a second call
    bitwise equal to the first; raises otherwise."""
    xs = 0.001 + 0.01 * torch.rand(xq.shape[0], 1, generator=g,
                                   device='cuda')
    y = qmm.w4a8_matmul(xq, packed, scale)
    fused = qmm.w4a8_matmul(xq, packed, scale, row_scale=xs,
                            out_dtype=torch.bfloat16)
    if not torch.equal(fused, (y * xs).to(torch.bfloat16)):
        raise AssertionError(f'w4a8 {tuple(xq.shape)} x {tuple(packed.shape)}'
                             f': the fused epilogue differs from the '
                             f'two-step path')
    if not torch.equal(y, qmm.w4a8_matmul(xq, packed, scale)):
        raise AssertionError(f'w4a8 {tuple(xq.shape)}: two runs differ')


def planted_w4a8_faults(g):
    """Two faults a w4a8 kernel could make, planted in its inputs at (M 256,
    K 384, N 264, group 128): one group's scale skipped (group 1's scales
    zeroed) and the low and high nibbles of one packed tile swapped (packed
    rows 64-127, K 128-255). The kernel on each must break W4A8_TOL against
    the sound plain output. Returns the readings."""
    xq, q, packed, scale = w4a8_case(g, 256, 384, 264)
    ref = qmm.w4a8_matmul_ref(xq, packed, scale)
    mag = xq.abs().float() @ (q.abs().float()
                              * scale.repeat_interleave(128, dim=0))
    no_scale = scale.clone()
    no_scale[1] = 0
    swapped = packed.clone()
    tile = packed[64:128].to(torch.int16) & 0xFF
    swapped[64:128] = (((tile << 4) | (tile >> 4)) & 0xFF).to(
        torch.uint8).view(torch.int8)
    parts = []
    for name, args in (('group 1 scale skipped', (xq, packed, no_scale)),
                       ('nibbles swapped in packed rows 64-127',
                        (xq, swapped, scale))):
        worst = ((qmm.w4a8_matmul(*args) - ref).abs() / mag.clamp_min(
            1e-30)).max().item()
        if not worst > W4A8_TOL:
            raise AssertionError(f'w4a8 planted fault "{name}" passes: '
                                 f'{worst:.3e} <= {W4A8_TOL}')
        parts.append(f'{name}: |d| / sum|x||w|scale {worst:.3e}, refused')
    return parts


def phase_w4a8_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 3)
    cases = [(m, k, n, 128) for m, k, n in W4A8_SHAPES] + [
        (777, 3072, 3072, 128), (130, 512, 264, 32), (3, 320, 136, 64)] + [
        (m, 384, n, group) for m in W4A8_RAGGED_M for n in W4A8_RAGGED_N
        for group in qmm.GROUP_SIZES]
    worst, worst_rel = 0.0, 0.0
    for m, k, n, group in cases:
        xq, q, packed, scale = w4a8_case(g, m, k, n, group)
        err, rel = w4a8_check(xq, q, packed, scale)
        w4a8_epilogue_check(g, xq, packed, scale)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    # nibble -8 and activation -127 in whole rows and columns, scale 1: the
    # exact integer product
    xq, q, _, _ = w4a8_case(g, 70, 256, 24, 64)
    q[:, :5] = -8
    xq[:3] = -127
    packed, ones = pack_int4(q, 64), torch.ones(4, 24, device='cuda')
    w4a8_check(xq, q, packed, ones)
    if not torch.equal(qmm.w4a8_matmul(xq, packed, ones).double(),
                       xq.double() @ q.double()):
        raise AssertionError('w4a8: the -8 / -127 case is not exact')
    faults = planted_w4a8_faults(g)
    by_class = []
    for m, k, n in W4A8_SHAPES:
        xq, q, packed, scale = w4a8_case(g, m, k, n)
        # the int8 layers' (K, N) weight, column-major, with the same values
        w8 = q.t().contiguous().t()
        xs = 0.001 + 0.01 * torch.rand(m, 1, generator=g, device='cuda')

        def fused():     # the form the Qwen path launches (_int4_matmul)
            return qmm.w4a8_matmul(xq, packed, scale, row_scale=xs,
                                   out_dtype=torch.bfloat16)
        # int8 activations, packed int4 weights, fp32 scales and row scales
        # in; bf16 out
        bound_ms, bound_by = roofline(
            2 * m * k * n,
            m * k + k * n // 2 + scale.numel() * 4 + m * 4 + m * n * 2,
            H100_INT8)
        dev_ms = kernel_ms(fused, 'w4a8_matmul', 10)
        by_class.append(dict(
            shape=[m, k, n], form='row_scale, bf16 out', ms=dev_ms,
            call_ms=cuda_ms(fused, 20),
            tops=2 * m * k * n / (dev_ms * 1e-3) / 1e12, bound_ms=bound_ms,
            bound_by=bound_by,
            reference_ms=kernel_ms(lambda: i8.int8_matmul(xq, w8), None, 10)))
    timed = []
    for m, k, n in W4A8_TIMED:
        xq, _, packed, scale = w4a8_case(g, m, k, n)
        ms = cuda_ms(lambda: qmm.w4a8_matmul(xq, packed, scale), 20)
        plain_ms = cuda_ms(lambda: qmm.w4a8_matmul_ref(xq, packed, scale), 3)
        # int8 activations, packed int4 weights, fp32 scales in; fp32 out
        bound_ms, bound_by = roofline(
            2 * m * k * n, m * k + k * n // 2 + scale.numel() * 4 + m * n * 4,
            H100_INT8)
        timed.append(dict(shape=[m, k, n], ms=ms, plain_ms=plain_ms,
                          tops=2 * m * k * n / (ms * 1e-3) / 1e12,
                          bound_ms=bound_ms, bound_by=bound_by,
                          reference_ms=next(
                              c['reference_ms'] for c in by_class
                              if c['shape'] == [m, k, n])))
    log(f'phase 4 w4a8 kernel vs plain: ok | {len(cases) + 1} cases (path '
        f'shapes, M {W4A8_RAGGED_M} x N {W4A8_RAGGED_N} x groups '
        f'{qmm.GROUP_SIZES}, -8 nibbles) max|d| {worst:.3e}, max '
        f'|d| / sum|x||w|scale {worst_rel:.3e} (bound {W4A8_TOL}), fused '
        f'epilogue bitwise equal to the two-step path, two runs bitwise '
        f'equal | planted faults: {" ; ".join(faults)} | ptxas: '
        f'{ptxas_usage("w4a8_matmul_kernel")} | '
        + ' ; '.join(f'M{t["shape"][0]} K{t["shape"][1]} N{t["shape"][2]}: '
                     f'kernel {t["ms"]:.4f} ms ({t["tops"]:.1f} TOP/s), '
                     f'plain fp32 {t["plain_ms"]:.4f} ms, bound '
                     f'{t["bound_ms"]:.4f} ms ({t["bound_by"]}), '
                     f'torch._int_mm on the int8 weight '
                     f'{t["reference_ms"]:.4f} ms'
                     for t in timed)
        + ' | by shape class, as the Qwen path calls it (row scale, bf16 '
        'out; device ms by the profiler): ' + ' ; '.join(
            f'M{c["shape"][0]} K{c["shape"][1]} N{c["shape"][2]} '
            f'{c["ms"]:.4f} ms (call {c["call_ms"]:.4f}) {c["tops"]:.1f} '
            f'TOP/s, bound {c["bound_ms"]:.4f} ({c["bound_by"]}), '
            f'torch._int_mm {c["reference_ms"]:.4f}' for c in by_class))
    return worst, timed, by_class


def randomize_(module, generator):
    """normal(0, 0.02) on every weight matrix; biases and norm scales keep
    their init (zeros, ones, the head biases)."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, 0.02, generator=generator)


def flux_inputs(generator, txt=512):
    """Random FLUX prompt embeds: T5 (1, txt, 4096) and pooled CLIP 768."""
    return dict(
        encoder_hidden_states=torch.randn(1, txt, 4096, generator=generator,
                                          device='cuda', dtype=torch.bfloat16),
        pooled_projections=torch.randn(1, 768, generator=generator,
                                       device='cuda', dtype=torch.bfloat16))


def phase_reduced_slice():
    g = torch.Generator(device='cuda').manual_seed(SEED + 1)
    cfg = dict(FLUX_12B, num_layers=1, num_single_layers=1)
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **cfg)
    randomize_(model, g)
    x = torch.randn(1, 128, 128, 16, generator=g, device='cuda')
    kw = dict(flux_inputs(g), t=torch.full((1,), 0.7, device='cuda'),
              guidance=torch.full((1,), 3.5, device='cuda'))
    rel, shape = reduced_vs_plain('phase 5', model, x, kw)
    log(f'phase 5 FLUX reduced slice (1+1 blocks, full width, bf16): ok | '
        f'means {shape} rel L2 kernel vs plain {rel:.3e} '
        f'(bound {SLICE_REL_L2}) | kernel launches 2')


def reduced_vs_plain(label, model, x, kw):
    """One forward of the FLUX ``model`` with ``kw`` through K1 (one launch
    per block), then the same through the plain attention (none): finite
    ``means`` within SLICE_REL_L2 by relative L2; (that, their shape)."""
    def plain(q, k, v, kv_valid=None, return_lse=False):
        return attn.attention_ref(q, k, v, kv_valid, return_lse)
    n_blocks = len(model.joint_blocks) + len(model.single_blocks)
    with torch.inference_mode():
        before = attn.LAUNCHES
        fast = model(x, **kw)['means'].float()
        torch.cuda.synchronize()
        n_fast = attn.LAUNCHES - before
        with mock.patch.object(attn, 'flash_attention_fwd', plain):
            slow = model(x, **kw)['means'].float()
        torch.cuda.synchronize()
    if n_fast != n_blocks or attn.LAUNCHES != before + n_blocks:
        raise AssertionError(f'{label}: expected {n_blocks} kernel launches, '
                             f'got {n_fast}')
    if not (torch.isfinite(fast).all() and torch.isfinite(slow).all()):
        raise AssertionError(f'{label}: non-finite means')
    rel = ((fast - slow).norm() / slow.norm()).item()
    if rel > SLICE_REL_L2:
        raise AssertionError(f'{label}: means rel L2 {rel:.3e} > '
                             f'{SLICE_REL_L2}')
    return rel, tuple(fast.shape)


def timed_call(pipe, embeds, latents, **kw):
    """One pipeline call and its host seconds, synchronised at both ends."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = pipe(prompt_embeds=embeds, latents=latents, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def timed_decode(vae, latents):
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        vae.decode(latents)
        torch.cuda.synchronize()
        return time.perf_counter() - t


def check_image(img):
    if tuple(img.shape) != (1, 1024, 1024, 3):
        raise AssertionError(f'image shape {tuple(img.shape)}')
    if not torch.isfinite(img).all():
        raise AssertionError('non-finite image')


def phase_full_slice():
    g = torch.Generator(device='cuda').manual_seed(SEED + 2)
    t0 = time.perf_counter()
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **FLUX_12B)
        vae = PretrainedVAE(dtype=torch.bfloat16)
    randomize_(model, g)
    n_params = sum(p.numel() for p in model.parameters())
    pipe = ArcFluxPipeline(model, vae=vae)
    embeds = flux_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device='cuda')
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    want = 2 * n_blocks

    attn.LAUNCHES = 0
    first, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
    if attn.LAUNCHES != want:
        raise AssertionError(f'cold run: {attn.LAUNCHES} launches, '
                             f'want {want}')
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0                       # the main path's counted run
    out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
    launches = attn.LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != want:
        raise AssertionError(f'{launches} kernel launches, want {want}')
    img = out['images']
    check_image(img)
    lat, t_dit = timed_call(pipe, embeds, latents, output_type='latent')
    lat = lat['latents']
    if not torch.isfinite(lat).all():
        raise AssertionError('non-finite latents')
    t_dec = timed_decode(pipe.vae, lat)
    rerun = (first['images'] - img).abs().max().item()
    log(f'phase 6 FLUX full slice (FLUX-12B ArcFlux {n_params / 1e9:.2f}B '
        f'params bf16, 2-NFE 1024x1024 + VAE decode): ok | image '
        f'{tuple(img.shape)} finite, range [{img.min().item():.3f}, '
        f'{img.max().item():.3f}], max|run1 - run2| {rerun:.3e} | kernel '
        f'launches {launches} | build {t_build:.1f} s, cold run '
        f'{t_cold:.3f} s | warm per image {t_e2e:.4f} s: transformer + '
        f'integration {t_dit:.4f} s, decode {t_dec:.4f} s | peak memory '
        f'{peak_gib:.2f} GiB')
    return launches, (pipe, embeds, latents, lat, t_e2e)


def qwen_inputs(generator):
    """Random Qwen2.5-VL prompt embeds (1, 512, 3584) and their text mask,
    the first 384 tokens valid."""
    mask = torch.arange(QWEN_TXT, device='cuda')[None] < QWEN_TXT_VALID
    return dict(
        encoder_hidden_states=torch.randn(1, QWEN_TXT, 3584,
                                          generator=generator, device='cuda',
                                          dtype=torch.bfloat16),
        encoder_hidden_states_mask=mask.to(torch.int32))


def qwen_w4a8(generator, vae=False, **overrides):
    """ArcQwen at the 20B geometry (``overrides`` cut it) with random bf16
    weights, in a pipeline, int4-quantized layer by layer for w4a8; checks
    the count of int4 layers against the skip rules."""
    cfg = dict(QWEN_20B, **overrides)
    with torch.device('cuda'):
        model = ArcQwenImageTransformer2DModel(dtype=torch.bfloat16, **cfg)
        decoder = PretrainedVAEQwenImage(dtype=torch.bfloat16) if vae \
            else None
    randomize_(model, generator)
    n_params = sum(p.numel() for p in model.parameters())
    pipe = ArcQwenImagePipeline(model, vae=decoder, shift=QWEN_SHIFT)
    n_int4 = pipe.quantize_int4(act_quant=True)
    want = INT4_PER_BLOCK * cfg['num_layers'] + INT4_OUTSIDE_BLOCKS
    found = sum(isinstance(m, LoRADense) and m.is_int4 and m.act_quant
                for m in model.modules())
    if n_int4 != want or found != want:
        raise AssertionError(f'{n_int4} int4 layers quantized, {found} w4a8 '
                             f'in the tree, want {want}')
    return pipe, n_params, n_int4


def phase_qwen_reduced():
    g = torch.Generator(device='cuda').manual_seed(SEED + 4)
    pipe, _, n_int4 = qwen_w4a8(g, num_layers=1)
    x = torch.randn(1, 128, 128, 16, generator=g, device='cuda')
    kw = dict(qwen_inputs(g), t=torch.full((1,), 0.7, device='cuda'))
    with torch.inference_mode():
        before, attn_before = qmm.LAUNCHES, attn.LAUNCHES
        fast = pipe.transformer(x, **kw)['means'].float()
        torch.cuda.synchronize()
        n_fast = qmm.LAUNCHES - before
        n_attn = attn.LAUNCHES - attn_before
        with mock.patch.object(qmm, 'w4a8_matmul', qmm.w4a8_matmul_ref):
            slow = pipe.transformer(x, **kw)['means'].float()
        torch.cuda.synchronize()
    if n_fast != n_int4 or qmm.LAUNCHES != before + n_int4 or n_attn != 1:
        raise AssertionError(f'{n_fast} w4a8 launches (want {n_int4}), '
                             f'{n_attn} attention launches (want 1)')
    if not (torch.isfinite(fast).all() and torch.isfinite(slow).all()):
        raise AssertionError('non-finite means')
    rel = ((fast - slow).norm() / slow.norm()).item()
    if rel > QWEN_SLICE_REL_L2:
        raise AssertionError(f'means rel L2 {rel:.3e} > {QWEN_SLICE_REL_L2}')
    log(f'phase 7 Qwen reduced slice (1 block, full width, w4a8): ok | means '
        f'{tuple(fast.shape)} rel L2 w4a8 kernel vs plain {rel:.3e} (bound '
        f'{QWEN_SLICE_REL_L2}) | w4a8 launches {n_fast}, masked attention '
        f'launches {n_attn}')


def profile_split(fn):
    """One call of ``fn`` under ``torch.profiler``: wall seconds, device
    busy seconds (the union of device activity intervals) and
    {kernel name: (ms, calls)}."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, calls + 1)
    if not spans:
        raise AssertionError('the profiler saw no device activity')
    busy, reach = 0.0, float('-inf')
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return wall, busy / 1e6, by_name


def split_families(by_name):
    """{kernel name: (ms, calls)} -> {family: (ms, calls, largest name)}."""
    families = {}
    for name, (ms, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        family = next((f for f, keys in KERNEL_FAMILIES
                       if any(key in name for key in keys)), 'other')
        f_ms, f_calls, f_top = families.get(family, (0.0, 0, name))
        families[family] = (f_ms + ms, f_calls + calls, f_top)
    return families


@contextlib.contextmanager
def w4a8_shape_tally():
    """Count the w4a8 wrapper's calls by (M, K, N) while the block runs: a
    pass-through around ``qmm.w4a8_matmul``, which the layers look up on the
    module at each call. Yields the Counter."""
    tally, real = collections.Counter(), qmm.w4a8_matmul

    def counted(xq, packed, *args, **kw):
        tally[(xq.shape[0], xq.shape[1], packed.shape[1])] += 1
        return real(xq, packed, *args, **kw)
    with mock.patch.object(qmm, 'w4a8_matmul', counted):
        yield tally


def phase_qwen_full(w4a8_classes):
    """The Qwen-Image 20B w4a8 image. Fills each of phase 4's shape classes
    with its launches in the counted run (``launches_per_image``) and those
    times its phase-4 device time (``ms_per_image``)."""
    g = torch.Generator(device='cuda').manual_seed(SEED + 5)
    t0 = time.perf_counter()
    pipe, n_params, n_int4 = qwen_w4a8(g, vae=True)
    gc.collect()
    torch.cuda.empty_cache()
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    embeds = qwen_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device='cuda')
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    want = dict(attention=2 * QWEN_20B['num_layers'], w4a8=2 * n_int4)

    def counts():
        return dict(attention=attn.LAUNCHES, w4a8=qmm.LAUNCHES)

    attn.LAUNCHES = qmm.LAUNCHES = 0
    first, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
    if counts() != want:
        raise AssertionError(f'cold run: launches {counts()}, want {want}')
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = qmm.LAUNCHES = 0        # the main path's counted run
    with w4a8_shape_tally() as by_shape:
        out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != want:
        raise AssertionError(f'launches {launches}, want {want}')
    if (sum(by_shape.values()) != launches['w4a8']
            or set(by_shape) != set(W4A8_SHAPES)):
        raise AssertionError(f'w4a8 calls by shape {dict(by_shape)} (phase 4 '
                             f'timed {W4A8_SHAPES}), launches {launches}')
    for c in w4a8_classes:
        c['launches_per_image'] = by_shape[tuple(c['shape'])]
        c['ms_per_image'] = c['launches_per_image'] * c['ms']
    img = out['images']
    check_image(img)
    rerun = (first['images'] - img).abs().max().item()
    if rerun != 0.0:
        raise AssertionError(f'two runs differ by {rerun:.3e}')
    lat, t_dit = timed_call(pipe, embeds, latents, output_type='latent')
    lat = lat['latents']
    if not torch.isfinite(lat).all():
        raise AssertionError('non-finite latents')
    t_dec = timed_decode(pipe.vae, lat)
    wall, busy, by_name = profile_split(
        lambda: pipe(prompt_embeds=embeds, latents=latents, output_type='pt'))
    total = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    families = split_families(by_name)
    log(f'phase 8 Qwen full slice (ArcQwen {n_params / 1e9:.2f}B params, '
        f'{n_int4} int4 layers w4a8, 2-NFE 1024x1024 + Wan decode): ok | '
        f'image {tuple(img.shape)} finite, range [{img.min().item():.3f}, '
        f'{img.max().item():.3f}], max|run1 - run2| {rerun:.3e} | launches '
        f'{launches} | build + quantize {t_build:.1f} s, resident after '
        f'quantize {resident_gib:.2f} GiB, cold run {t_cold:.3f} s | warm per '
        f'image {t_e2e:.4f} s: transformer + integration {t_dit:.4f} s, '
        f'decode {t_dec:.4f} s | peak memory {peak_gib:.2f} GiB | w4a8 '
        f'launches by shape in the counted run x phase 4 device ms: '
        + ' ; '.join(f'M{c["shape"][0]} K{c["shape"][1]} N{c["shape"][2]} '
                     f'x{c["launches_per_image"]} = {c["ms_per_image"]:.2f} '
                     f'ms' for c in w4a8_classes)
        + f' | sum {sum(c["ms_per_image"] for c in w4a8_classes):.2f} ms')
    log(f'phase 8 profile (one warm image): wall {wall:.4f} s, device busy '
        f'{busy:.4f} s, idle share {1 - busy / wall:.4f}, {len(by_name)} '
        f'kernel names | by family: ' + ' ; '.join(
            f'{f} {ms:.2f} ms {100 * ms / total:.1f}% x{calls} (largest: '
            f'{top_name[:60]})'
            for f, (ms, calls, top_name) in sorted(families.items(),
                                                   key=lambda kv: -kv[1][0]))
        + ' | by name: ' + ' ; '.join(
            f'{ms:.2f} ms {100 * ms / total:.1f}% x{calls} {name[:90]}'
            for name, (ms, calls) in top))
    return launches, (pipe, latents, n_int4)


def rel_l2(a, b):
    b = b.float()
    return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()


def planted_k3_fault(q, k, v, o, do, lse, dq_ref):
    """Planted fault: the dQ partial of key tile 1 (keys 128-255) dropped,
    by running the kernels with those keys masked against the sound
    forward's O and LSE. The resulting dq must break phase 9's limit
    against the plain ``dq_ref``. Returns the reading."""
    s = q.shape[1]
    keep = (torch.arange(s, device=q.device) // 128 != 1)[None].expand(
        q.shape[0], s)
    dq = attn.flash_attention_bwd(q, k, v, o, do, lse, keep)[0]
    rel = rel_l2(dq, dq_ref)
    if rel <= BWD_REL_L2:
        raise AssertionError(f'K3 planted fault (a dQ partial dropped) passes '
                             f'the limit: rel L2 {rel:.3e}')
    return (f'planted fault, the dQ partial of key tile 1 dropped: dq rel L2 '
            f'{rel:.3e}, refused')


def phase_bwd_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 6)
    cases = [('flux', FLUX_SHAPE, None), ('s777', (2, 777, 3, 128), None),
             ('s1000', (2, 1000, 4, 128), None),
             ('key_padded', (2, 1000, 4, 128), (900, 1000)),
             ('no_valid_key', (2, 300, 3, 128), (0, 250))]
    worst_abs, worst_rel, parts = 0.0, 0.0, []
    for name, shape, lengths in cases:
        q, k, v, do = (torch.randn(shape, generator=g, device='cuda',
                                   dtype=torch.bfloat16) for _ in range(4))
        kv_valid = None
        if lengths is not None:
            kv_valid = torch.arange(shape[1], device='cuda')[None, :] < \
                torch.tensor(lengths, device='cuda')[:, None]
        o, lse = attn.flash_attention_fwd(q, k, v, kv_valid, return_lse=True)
        got = attn.flash_attention_bwd(q, k, v, o, do, lse, kv_valid)
        torch.cuda.synchronize()
        want = attn.attention_bwd_ref(q, k, v, o, do, lse, kv_valid)
        rels = [rel_l2(x, y) for x, y in zip(got, want)]
        if not all(torch.isfinite(x).all() for x in got):
            raise AssertionError(f'{name}: non-finite gradients')
        if max(rels) > BWD_REL_L2:
            raise AssertionError(f'{name}: rel L2 dq/dk/dv {rels} > '
                                 f'{BWD_REL_L2}')
        if lengths is not None and lengths[0] == 0 and any(
                x[0].any() for x in got):
            raise AssertionError(f'{name}: a row with no valid key got a '
                                 f'gradient')
        worst_abs = max(worst_abs, max((x.float() - y.float()).abs().max()
                                       .item() for x, y in zip(got, want)))
        worst_rel = max(worst_rel, max(rels))
        parts.append(f'{name} {tuple(shape)} rel L2 dq/dk/dv '
                     + '/'.join(f'{r:.2e}' for r in rels))
        if name == 'flux':
            flux = (q, k, v, o, do, lse)
        if name == 's1000':
            fault = planted_k3_fault(q, k, v, o, do, lse, want[0])
        del q, k, v, do, o, lse, got, want
    q, k, v, o, do, lse = flux
    ms = cuda_ms(lambda: attn.flash_attention_bwd(q, k, v, o, do, lse), 10)
    plain_ms = cuda_ms(lambda: attn.attention_bwd_ref(q, k, v, o, do, lse), 3)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 10)
    bound_ms, bound_by = attention_bound(FLUX_SHAPE, backward=True)
    b, s, h, d = FLUX_SHAPE
    tflops = 10 * b * h * s * s * d / (ms * 1e-3) / 1e12
    log(f'phase 9 attention backward kernels vs plain: ok | '
        f'{" ; ".join(parts)} (bound {BWD_REL_L2}), max|d| {worst_abs:.3e} | '
        f'FLUX shape: kernels {ms:.4f} ms ({tflops:.1f} TFLOP/s of the 5 '
        f'needed products), plain fp32 {plain_ms:.4f} ms, SDPA backward '
        f'{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, '
        f'{100 * bound_ms / ms:.1f}% of it) | ptxas: '
        f'{ptxas_usage("attention_bwd_kernel")} | {fault}')
    return dict(max_abs_err=worst_abs, max_rel_l2=worst_rel, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def flux_train_config(**net):
    """The FLUX config through the port's ``Config``: frozen trunk bf16,
    ``total_iters`` and ``checkpoint_config`` cut to phase 11r's run,
    ``net`` cutting the depth of the student and of the teacher alike."""
    cfg = Config.fromfile(FLUX_TRAIN_CONFIG)
    opts = {'model.frozen_dtype': 'bfloat16',
            'total_iters': RUNNER_ITERS,
            'checkpoint_config': dict(_delete_=True, interval=0,
                                      trainable_only=True)}
    for k, v in net.items():
        opts[f'model.diffusion.denoising.{k}'] = v
        opts[f'model.teacher.denoising.{k}'] = v
    cfg.merge_from_dict(opts)
    return cfg


def flux_train_model(generator, cfg):
    """The FLUX-12B distillation composition of ``cfg`` built through
    ``MODELS`` on the card, with random weights: normal(0.02) on every
    weight matrix of the student (trunk and adapter) and of the teacher's
    head."""
    model = MODELS.build(cfg.model, default_args=dict(
        train_cfg=cfg.train_cfg, test_cfg=cfg.test_cfg, device='cuda',
        dtype=torch.bfloat16))
    randomize_(model.diffusion.denoising, generator)
    teacher = model.teacher.denoising
    randomize_(torch.nn.ModuleList([teacher.norm_out, teacher.proj_out]),
               generator)
    return model


def flux_train_batch(generator, cfg):
    """One batch of 1: random latents (only their shape and device are
    used: the data-free loss starts from noise) and prompt embeds."""
    return dict(latents=torch.randn(1, *cfg.model.latent_shape,
                                    generator=generator, device='cuda'),
                prompt_embed_kwargs=flux_inputs(generator))


def train_slice_vs_plain(model, batch, upstream_keys, want, seed,
                         share_bound=BWD_REL_L2):
    """One ``model.loss`` + backward through the attention kernels, then
    the same weights and draws (a generator seeded with ``seed``) through
    the plain versions: loss and adapter gradients by relative L2 within
    TRAIN_SLICE_REL_L2. Then the backward alone, under the kernels'
    forward: for each adapter tensor upstream of an attention
    (``upstream_keys``), the kernels' error over the share of its gradient
    the attention backward carries (plain minus zeroed) within
    ``share_bound``, and a planted fault (the plain backward with dq
    zeroed) must break that bound. ``want`` is the (forward, backward)
    launch count of one loss. Returns the readings."""
    adapter = model.init_params()[0]['diffusion']

    def run():
        for p in adapter.values():
            p.grad = None
        draws = torch.Generator(device='cuda').manual_seed(seed)
        loss, _ = model.loss(batch, draws, running_status=dict(iteration=0))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: (p.grad if p.grad is not None
                                 else torch.zeros_like(p)).float().clone()
                             for n, p in adapter.items()}

    def plain_fwd(q, k, v, kv_valid=None, return_lse=False):
        return attn.attention_ref(q, k, v, kv_valid, return_lse)

    def plain_bwd_zeroed(*which):
        def bwd(*args):
            return tuple(torch.zeros_like(t) if i in which else t for i, t
                         in enumerate(attn.attention_bwd_ref(*args)))
        return bwd

    kernel_fwd = attn.flash_attention_fwd

    def run_with(fwd, bwd):
        with mock.patch.object(attn, 'flash_attention_fwd', fwd), \
                mock.patch.object(attn, 'flash_attention_bwd', bwd):
            return run()

    before = (attn.LAUNCHES, attn.BWD_LAUNCHES)
    loss_k, grads_k = run()
    counts = (attn.LAUNCHES - before[0], attn.BWD_LAUNCHES - before[1])
    if counts != want:
        raise AssertionError(f'launches (forward, backward) {counts}, '
                             f'want {want}')
    loss_p, grads_p = run_with(plain_fwd, attn.attention_bwd_ref)
    # the backward alone, under the kernels' forward
    grads_pb = run_with(kernel_fwd, attn.attention_bwd_ref)[1]
    grads_0 = run_with(kernel_fwd, plain_bwd_zeroed(0, 1, 2))[1]
    grads_fault = run_with(kernel_fwd, plain_bwd_zeroed(0))[1]
    if not all(torch.isfinite(t).all() for t in grads_k.values()):
        raise AssertionError('non-finite adapter gradients')
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    flat_k = torch.cat([t.flatten() for t in grads_k.values()])
    flat_p = torch.cat([t.flatten() for t in grads_p.values()])
    rel_grad = rel_l2(flat_k, flat_p)
    per = {n: rel_l2(grads_k[n], grads_p[n]) for n in grads_k
           if grads_p[n].any()}
    worst = max(per, key=per.get)
    upstream = [n for n in per if n.startswith(upstream_keys)]
    if not upstream:
        raise AssertionError('no adapter tensor upstream of an attention')
    share = {n: (grads_pb[n] - grads_0[n]).norm().item() for n in upstream}

    def over_share(grads):
        return {n: (grads[n] - grads_pb[n]).norm().item() / share[n]
                for n in upstream}

    err, fault = over_share(grads_k), over_share(grads_fault)
    worst_up, least_fault = max(err, key=err.get), min(fault, key=fault.get)
    if max(rel_loss, rel_grad) > TRAIN_SLICE_REL_L2 or flat_p.norm() == 0:
        raise AssertionError(f'loss rel {rel_loss:.3e}, adapter gradients '
                             f'rel L2 {rel_grad:.3e} > {TRAIN_SLICE_REL_L2}')
    if not min(share.values()) > 0 or err[worst_up] > share_bound:
        raise AssertionError(f'backward error over its share {err} > '
                             f'{share_bound}, shares {share}, planted fault '
                             f'{fault}')
    if max(fault.values()) <= share_bound:
        raise AssertionError(f'dq zeroed kept every tensor upstream of an '
                             f'attention within {share_bound}: {fault}')
    return (f'loss {loss_k:.6e} vs plain {loss_p:.6e}, rel {rel_loss:.3e} '
            f'| adapter gradients ({len(per)} nonzero tensors) rel L2 '
            f'{rel_grad:.3e} (bound {TRAIN_SLICE_REL_L2}), worst tensor '
            f'{worst} {per[worst]:.3e} | backward alone, {len(upstream)} '
            f'tensors upstream of an attention, error over the attention '
            f'backward\'s share: worst {worst_up} {err[worst_up]:.3e} (bound '
            f'{share_bound}), that share '
            f'{share[worst_up] / grads_pb[worst_up].norm().item():.3e} of its '
            f'gradient | planted fault, dq zeroed: {fault[least_fault]:.3e} '
            f'({least_fault}) to {max(fault.values()):.3e} | launches forward '
            f'{counts[0]}, backward {counts[1]}')


def phase_train_reduced():
    g = torch.Generator(device='cuda').manual_seed(SEED + 7)
    cfg = flux_train_config(num_layers=1, num_single_layers=1)
    model = flux_train_model(g, cfg)
    batch = flux_train_batch(g, cfg)
    readings = train_slice_vs_plain(
        model, batch, UPSTREAM_OF_ATTENTION,
        (TRAIN_FORWARDS * 2, TRAIN_BACKWARDS * 2), SEED + 8)
    log(f'phase 10 FLUX training reduced slice (1+1 blocks, full width, '
        f'bf16 trunk, LoRA 256): ok | {readings}')


def phase_train_full():
    g = torch.Generator(device='cuda').manual_seed(SEED + 9)
    t0 = time.perf_counter()
    cfg = flux_train_config()
    model = flux_train_model(g, cfg)
    trainable, frozen = model.init_params()
    n_params = (count_params(trainable), count_params(frozen))
    if n_params != FLUX_TRAIN_PARAMS:
        raise AssertionError(f'{FLUX_TRAIN_CONFIG} built (trainable, '
                             f'frozen) {n_params} parameters, want '
                             f'{FLUX_TRAIN_PARAMS}')
    optimizers = build_optimizers(dict(cfg.optimizer), trainable)
    state = TrainState.create(
        torch.Generator(device='cuda').manual_seed(SEED + 10), trainable,
        frozen, optimizers, ema_keys=model.ema_keys)
    step = build_train_step(model, optimizers, model.train_cfg,
                            ema_config_from_cfg(cfg))
    batch = flux_train_batch(g, cfg)
    adapter = trainable['diffusion']
    start = {n: p.detach().clone() for n, p in adapter.items()}
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    frozen_host = {n: t.detach().cpu() for n, t in flatten(frozen).items()}
    net = cfg.model.diffusion.denoising
    n_blocks = net.num_layers + net.num_single_layers
    want = (TRAIN_FORWARDS * n_blocks, TRAIN_BACKWARDS * n_blocks)

    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(TRAIN_STEPS):
        attn.LAUNCHES = attn.BWD_LAUNCHES = 0   # the main path's counted run
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, logs = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = (attn.LAUNCHES, attn.BWD_LAUNCHES)
        if launches != want:
            raise AssertionError(f'step {state.step}: launches (forward, '
                                 f'backward) {launches}, want {want}')
        loss, gnorm = float(logs['loss']), logs['diffusion_grad_norm']
        if not (torch.isfinite(torch.tensor([loss, gnorm])).all()
                and logs['diffusion_skipped'] == 0.0):
            raise AssertionError(f'step {state.step}: loss {loss}, grad '
                                 f'norm {gnorm}, skipped '
                                 f'{logs["diffusion_skipped"]}')
        if not all(torch.equal(state.ema['diffusion'][n], p)
                   for n, p in adapter.items()):
            raise AssertionError(f'step {state.step}: the EMA is not the '
                                 f'adapter before start_iter')
        steps.append(dict(s=dt, loss=loss, grad_norm=gnorm,
                          step0=float(logs['loss_diffusion_step0']),
                          step1=float(logs['loss_diffusion_step1'])))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(p, start[n]) for n, p in adapter.items())
    if moved == 0:
        raise AssertionError('the adapter did not move')
    changed = [n for n, t in flatten(frozen).items()
               if not torch.equal(t.cpu(), frozen_host[n])]
    if changed:
        raise AssertionError(f'frozen tensors changed: {changed[:5]}')
    wall, busy, by_name = profile_split(lambda: step(state, batch))
    families = split_families(by_name)
    total = sum(ms for ms, _, _ in families.values())
    warm = sum(st['s'] for st in steps[1:]) / len(steps[1:])
    log(f'phase 11 FLUX training full slice (FLUX-12B ArcFlow distillation '
        f'of {FLUX_TRAIN_CONFIG} through Config and MODELS, '
        f'{count_params(frozen) / 1e9:.2f}B frozen bf16 + '
        f'{count_params(trainable)} fp32 adapter parameters, batch 1, '
        f'1024x1024, nfe 2, 4 intermediate states, checkpointing): ok | '
        + ' ; '.join(f'step {i + 1}: {st["s"]:.3f} s, loss {st["loss"]:.5e} '
                     f'(NFE steps {st["step0"]:.4e} + {st["step1"]:.4e}), '
                     f'grad norm {st["grad_norm"]:.4e}'
                     for i, st in enumerate(steps))
        + f' | warm {warm:.4f} s per step | launches per step forward '
        f'{launches[0]}, backward {launches[1]} | {moved} of '
        f'{len(adapter)} adapter tensors moved, frozen trunk bit-identical, '
        f'EMA = adapter | build '
        f'{t_build:.1f} s | peak memory {peak_gib:.2f} GiB, resident '
        f'{resident_gib:.2f} GiB')
    log(f'phase 11 profile (one warm step): wall {wall:.4f} s, device busy '
        f'{busy:.4f} s, idle share {1 - busy / wall:.4f}, {len(by_name)} '
        f'kernel names | by family: ' + ' ; '.join(
            f'{f} {ms:.2f} ms {100 * ms / total:.1f}% x{calls} (largest: '
            f'{top_name[:60]})'
            for f, (ms, calls, top_name) in sorted(families.items(),
                                                   key=lambda kv: -kv[1][0])))
    return dict(forward=launches[0], backward=launches[1]), dict(
        cfg=cfg, model=model, state=state, step=step, batch=batch,
        frozen_host=frozen_host, warm=warm, n_blocks=n_blocks)


# phase 38: every attention of the FLUX-12B step on LocalRing(SP): per
# step 12 x 57 forwards of SP x SP K4 hops and 2 x 57 backwards of SP x SP
# K3 hops, and no K1
SP_TRAIN_LAUNCHES = (TRAIN_FORWARDS * SP * SP, TRAIN_BACKWARDS * SP * SP, 0)
# The ring step against the one-device step of the same state and draws:
# the two differ in the forward kernels (K4 hops against K1, bf16 P.V in
# other tiles) and in the order of the backward's sums, as phase 10's
# kernels differ from the plain fp32 versions, so the loss, the adapter
# gradients and the adapter's update stay within TRAIN_SLICE_REL_L2. At
# random weights the residual stream carries most of every gradient (see
# phase 10), so the ring's backward is also held over the share of the
# gradient that the attention backward carries (one device, minus one
# device with every attention backward zeroed), for the adapter tensors
# upstream of an attention: SP_SHARE_REL_L2 = 0.1 of that share. The
# bf16 noise of the two forwards, of the order of phase 16's 3e-3 on O,
# stays well under it; one block's dK / dV accumulators not sent home
# takes a quarter of every dK and dV, of the order of that share. Phase 39
# holds Qwen's ring so too: there each side carries about phase 27's
# kernel-against-plain noise (up to 3e-2 of the share, one block and
# CFG), and the two sides' bf16 roundings differ, so the ring against one
# device read 4.3-6.4e-2 (NVIDIA H100 80GB HBM3, 700 W), above
# QWEN_SHARE_REL_L2, which bounds one side.
SP_SHARE_REL_L2 = 0.1
# counted ring steps of phase 38 (one: the smoke's time goes to phases
# 40-41)
RING_STEPS = 1


def state_snapshot(state):
    """Copies of what a train step changes: the adapter, its EMA, the
    optimizers' slots, the generator and the step."""
    tensors = [p for sub in (*state.trainable.values(), *state.ema.values())
               for p in sub.values()]
    for tx in state.optimizers.values():
        for slots in tx.state.values():
            tensors += [t for t in slots.values()
                        if isinstance(t, torch.Tensor)]
    return dict(tensors=tensors, copies=[t.detach().clone() for t in tensors],
                generator=state.generator.get_state(), step=state.step)


def state_restore(state, snap):
    with torch.no_grad():
        for t, c in zip(snap['tensors'], snap['copies']):
            t.copy_(c)
    state.generator.set_state(snap['generator'])
    state.step = snap['step']


def step_with_grads(step, state, batch, keep=None):
    """One train step; returns (loss, the adapter gradients it clipped, as
    fp32 copies, ``keep`` selecting names, the adapter after it on the
    host)."""
    from arcflow_tpu_torch.runner import train_step as ts
    names = list(state.trainable['diffusion'])
    clip, grads = ts.clip_and_skip, {}

    def spy(gs, iteration, cfg, *rest):
        if not grads:
            grads.update({n: g.detach().float().clone()
                          for n, g in zip(names, gs)
                          if keep is None or n.startswith(keep)})
        return clip(gs, iteration, cfg, *rest)
    with mock.patch.object(ts, 'clip_and_skip', spy):
        state, logs = step(state, batch)
    torch.cuda.synchronize()
    return float(logs['loss']), grads, {
        n: p.detach().to('cpu', copy=True)
        for n, p in state.trainable['diffusion'].items()}


def ring_over_share(ref, zero, got, fault, bound):
    """The ring's error over the share of each gradient that the attention
    backward carries (``ref``, one device, minus ``zero``, one device with
    every attention backward zeroed), for the tensors of ``zero``: raises
    unless every one of ``got`` is within ``bound`` of ``ref`` and the
    planted ``fault`` breaks ``bound`` for one. Returns both by name."""
    share = {n: (ref[n] - zero[n]).norm().item() for n in zero}
    err = {n: (got[n] - ref[n]).norm().item() / share[n]
           for n in share if share[n] > 0}
    fault = {n: (fault[n] - ref[n]).norm().item() / share[n] for n in err}
    if not err or max(err.values()) > bound:
        raise AssertionError(f'ring backward over the attention backward\'s '
                             f'share {err} > {bound}, shares {share}')
    if max(fault.values()) <= bound:
        raise AssertionError(f'a block\'s dK / dV not sent home kept every '
                             f'tensor within {bound}: {fault}')
    return err, fault


def lost_home_block():
    """Planted fault: the last rotation of every ring backward leaves shard
    0's block without its dK / dV accumulators (zeros), as if they were not
    sent home."""
    real = ring_mod._home

    def lost(ring, accs):
        wait = real(ring, accs)
        return lambda: [tuple(torch.zeros_like(t) for t in a) if i == 0
                        else a for i, a in enumerate(wait())]
    return mock.patch.object(ring_mod, '_home', lost)


def phase_train_local_ring(run):
    """Phase 38: phase 11's FLUX-12B model and state with every attention on
    ``LocalRing(SP)``, a train step against the one-device step of the
    same state, batch and draws."""
    model, state, step, batch = (run[k] for k in ('model', 'state', 'step',
                                                  'batch'))
    n_blocks = run['n_blocks']
    snap = state_snapshot(state)
    before = {n: p.detach().to('cpu', copy=True)
              for n, p in state.trainable['diffusion'].items()}
    ref_loss, ref_grads, ref_after = step_with_grads(step, state, batch)
    state_restore(state, snap)
    zeroed = lambda *a: tuple(torch.zeros_like(t) for t in a[:3])  # noqa
    with mock.patch.object(attn, 'flash_attention_bwd', zeroed):
        _, zero_grads, _ = step_with_grads(step, state, batch,
                                           UPSTREAM_OF_ATTENTION)
    state_restore(state, snap)
    set_sequence_parallel(model, LocalRing(SP))
    try:
        with lost_home_block():
            _, fault_grads, _ = step_with_grads(step, state, batch,
                                                UPSTREAM_OF_ATTENTION)
        state_restore(state, snap)
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(RING_STEPS):
            # the main path's counted run
            hop.LAUNCHES = attn.LAUNCHES = attn.BWD_LAUNCHES = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, grads, after = step_with_grads(step, state, batch)
            dt = time.perf_counter() - t
            launches = (hop.LAUNCHES, attn.BWD_LAUNCHES, attn.LAUNCHES)
            want = tuple(n_blocks * x for x in SP_TRAIN_LAUNCHES)
            if launches != want:
                raise AssertionError(f'ring step {i + 1}: launches (K4, K3, '
                                     f'K1) {launches}, want {want}')
            if not math.isfinite(loss):
                raise AssertionError(f'ring step {i + 1}: loss {loss}')
            steps.append(dict(s=dt, loss=loss))
            if i == 0:
                first = grads, after
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        set_sequence_parallel(model, None)
    grads, after = first
    rel_loss = abs(steps[0]['loss'] - ref_loss) / abs(ref_loss)
    flat = lambda d: torch.cat([t.flatten() for t in d.values()])  # noqa
    rel_grad = rel_l2(flat(grads), flat(ref_grads))
    rel_update = rel_l2(flat({n: after[n] - before[n] for n in after}),
                        flat({n: ref_after[n] - before[n] for n in after}))
    if max(rel_loss, rel_grad, rel_update) > TRAIN_SLICE_REL_L2:
        raise AssertionError(f'ring against one device: loss rel '
                             f'{rel_loss:.3e}, gradients {rel_grad:.3e}, '
                             f'update {rel_update:.3e} > '
                             f'{TRAIN_SLICE_REL_L2}')
    err, fault = ring_over_share(ref_grads, zero_grads, grads, fault_grads,
                                 SP_SHARE_REL_L2)
    worst = max(err, key=err.get)
    state_restore(state, snap)
    del snap
    log(f'phase 38 FLUX-12B training on LocalRing({SP}) (phase 11\'s model, '
        f'state and batch; every attention a ring of {SP} shards of '
        f'{FLUX_SHAPE[1] // SP} tokens; LoRA dropout on, as configured): ok '
        f'| launches per step K4 {launches[0]}, K3 {launches[1]}, K1 '
        f'{launches[2]} | steps ' + ', '.join(
            f'{st["s"]:.4f} s (loss {st["loss"]:.5e})' for st in steps)
        + f' against the one-device step\'s loss {ref_loss:.5e} (phase 11 '
        f'bare warm {run["warm"]:.4f} s) | first step against one device: '
        f'loss rel {rel_loss:.3e}, adapter gradients rel L2 {rel_grad:.3e}, '
        f'the adapter\'s update rel L2 {rel_update:.3e} (bound '
        f'{TRAIN_SLICE_REL_L2}) | {len(err)} tensors upstream of an '
        f'attention, the ring\'s error over the attention backward\'s share: '
        f'worst {worst} {err[worst]:.3e} (bound {SP_SHARE_REL_L2}) | planted '
        f'fault, shard 0\'s dK / dV not sent home: '
        f'{min(fault.values()):.3e} to {max(fault.values()):.3e}, refused | '
        f'peak memory {peak_gib:.2f} GiB')
    return dict(k4=launches[0], k3=launches[1], s=[st['s'] for st in steps],
                peak_gib=peak_gib)


# phase 40: phase 11's FLUX-12B model and state with its stacks on
# LocalPipe(PIPE) at a batch of PIPE_BATCH rows in as many microbatches:
# the 38 single blocks pipeline (38 % 2 == 0), the 19 joint blocks run
# plain, as in JAX at pipe 2. Every forward (the student's, the teacher's
# and the recomputes) goes through both stacks: per step 12 x (19 + 38 M)
# K1 and 2 x (19 + 38 M) K3 launches (phase 11's 684 / 114 at M = 1).
PIPE, PIPE_BATCH = 2, 2
PIPE_STEPS = 1          # counted pipelined steps


def own_rng():
    """The block draws from the host's and the card's global generators
    and puts them back after: a phase added among the others leaves the
    weights the later phases build from those generators as they were
    (phase 27's model draws its means-head bias from them, and phase 39's
    reading over its 0.1 bound moves with it: 6.4e-2 to 1.03e-1)."""
    return torch.random.fork_rng(devices=[torch.cuda.current_device()])


def pipe_step_launches(n_joint, n_single, m):
    per_forward = n_joint + n_single * m
    return TRAIN_FORWARDS * per_forward, TRAIN_BACKWARDS * per_forward


class DroppedHandoff(LocalPipe):
    """Planted fault: stage 1 receives zeros in place of what stage 0
    handed it (a stage handoff dropped)."""

    def forward_shift(self, outs, like):
        got = super().forward_shift(outs, like)
        if got.get(1) is not None:
            got[1] = tuple(torch.zeros_like(t) for t in got[1])
        return got


def flux_pipe_batch(generator, cfg, rows):
    """``rows`` rows of phase 11's batch: random latents and prompt
    embeds."""
    embeds = [flux_inputs(generator) for _ in range(rows)]
    return dict(latents=torch.randn(rows, *cfg.model.latent_shape,
                                    generator=generator, device='cuda'),
                prompt_embed_kwargs={k: torch.cat([e[k] for e in embeds])
                                     for k in embeds[0]})


def phase_train_local_pipe(run):
    """Phase 40: phase 11's FLUX-12B model and state with its stacks on
    ``LocalPipe(PIPE)`` at PIPE_BATCH rows (PIPE_BATCH microbatches),
    PIPE_STEPS train steps against the one-device step of the same state,
    batch and draws, with phase 38's bounds; a dropped stage handoff must
    break them. Its draws from the global generators are put back after,
    as are phase 41's: the later phases build their weights from them."""
    model, state, step, cfg = (run[k] for k in ('model', 'state', 'step',
                                                'cfg'))
    net = cfg.model.diffusion.denoising
    g = torch.Generator(device='cuda').manual_seed(SEED + 41)
    rows, note = PIPE_BATCH, ''
    snap = state_snapshot(state)
    before = {n: p.detach().to('cpu', copy=True)
              for n, p in state.trainable['diffusion'].items()}
    while True:
        batch = flux_pipe_batch(g, cfg, rows)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            ref_loss, ref_grads, ref_after = step_with_grads(step, state,
                                                             batch)
            ref_s = time.perf_counter() - t
            ref_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            break
        except torch.cuda.OutOfMemoryError:
            if rows == 1:
                raise
            state_restore(state, snap)
            gc.collect()
            torch.cuda.empty_cache()
            note = f' (batch {rows} did not fit: batch 1)'
            rows -= 1
    state_restore(state, snap)
    micro = rows
    # the planted fault: a step with stage 1 fed zeros for its handoff (the
    # teacher's targets go through the same faulty trunk, so the loss moves
    # less than the gradients)
    set_pipe(model, DroppedHandoff(PIPE, micro))
    try:
        fault_loss, fault_grads, _ = step_with_grads(step, state, batch)
    finally:
        set_pipe(model, None)
    state_restore(state, snap)
    want = pipe_step_launches(net.num_layers, net.num_single_layers, micro)
    set_pipe(model, LocalPipe(PIPE, micro))
    try:
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(PIPE_STEPS):
            attn.LAUNCHES = attn.BWD_LAUNCHES = 0   # the main path's run
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, grads, after = step_with_grads(step, state, batch)
            dt = time.perf_counter() - t
            launches = (attn.LAUNCHES, attn.BWD_LAUNCHES)
            if launches != want:
                raise AssertionError(f'pipe step {i + 1}: launches (K1, K3) '
                                     f'{launches}, want {want}')
            if not math.isfinite(loss):
                raise AssertionError(f'pipe step {i + 1}: loss {loss}')
            steps.append(dict(s=dt, loss=loss))
            if i == 0:
                first = grads, after
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        set_pipe(model, None)
    grads, after = first
    rel_loss = abs(steps[0]['loss'] - ref_loss) / abs(ref_loss)
    flat = lambda d: torch.cat([t.flatten() for t in d.values()])  # noqa
    rel_grad = rel_l2(flat(grads), flat(ref_grads))
    rel_update = rel_l2(flat({n: after[n] - before[n] for n in after}),
                        flat({n: ref_after[n] - before[n] for n in after}))
    fault_rel = (abs(fault_loss - ref_loss) / abs(ref_loss),
                 rel_l2(flat(fault_grads), flat(ref_grads)))
    if max(rel_loss, rel_grad, rel_update) > TRAIN_SLICE_REL_L2:
        raise AssertionError(f'LocalPipe against one device: loss rel '
                             f'{rel_loss:.3e}, gradients {rel_grad:.3e}, '
                             f'update {rel_update:.3e} > '
                             f'{TRAIN_SLICE_REL_L2}')
    if max(fault_rel) <= TRAIN_SLICE_REL_L2:
        raise AssertionError(f'a dropped stage handoff kept the loss and the '
                             f'gradients within {TRAIN_SLICE_REL_L2}: '
                             f'{fault_rel}')
    state_restore(state, snap)
    del snap
    log(f'phase 40 FLUX-12B training on LocalPipe({PIPE}) (phase 11\'s model '
        f'and state; batch {rows} in {micro} microbatches{note}; the '
        f'{net.num_single_layers} single blocks pipelined, the '
        f'{net.num_layers} joint blocks plain; LoRA dropout on): ok | '
        f'launches per step K1 {launches[0]}, K3 {launches[1]} (12 x (19 + '
        f'38 x {micro}), 2 x (19 + 38 x {micro})) | steps ' + ', '.join(
            f'{st["s"]:.4f} s (loss {st["loss"]:.5e})' for st in steps)
        + f' against the one-device step at batch {rows}: {ref_s:.4f} s, '
        f'loss {ref_loss:.5e}, peak {ref_peak:.2f} GiB | first step against '
        f'one device: loss rel {rel_loss:.3e}, adapter gradients rel L2 '
        f'{rel_grad:.3e}, the adapter\'s update rel L2 {rel_update:.3e} '
        f'(bound {TRAIN_SLICE_REL_L2}) | planted fault, stage 1 fed zeros '
        f'for stage 0\'s handoff: loss rel {fault_rel[0]:.3e}, adapter '
        f'gradients rel L2 {fault_rel[1]:.3e}, refused | peak '
        f'memory {peak_gib:.2f} GiB (the state snapshot on the card)')
    return dict(k1=launches[0], k3=launches[1], s=[st['s'] for st in steps],
                ref_s=ref_s, peak_gib=peak_gib, rows=rows)


# phase 41: the MoE FFN at FLUX-12B width. (a) moe_experts=1 at capacity 1
# with the dense FFN's weights in its one expert, on 2 + 2 blocks: every
# token through the expert at gate 1, the dense blocks' ``means`` within
# MOE_DENSE_REL_L2. The MoE adds the expert's bias after its bf16 product
# where the dense layer adds it in the GEMM's fp32 epilogue, so the two
# differ by one bf16 rounding (2^-8) per MLP; a wrong gate, a token
# dropped or a weight transposed moves ``means`` by O(1). (b) moe_experts=2
# at capacity 1 at full depth: a 2-NFE 1024^2 image from phase 6's embeds
# and latents, 114 K1 launches.
MOE_DENSE_REL_L2 = 1e-2


def moe_from_dense(moe, dense):
    """``moe`` (E = 1) takes ``dense``'s FFN weights (a FeedForward's
    in_proj / out_proj) in its one expert."""
    with torch.no_grad():
        moe.w_in.copy_(dense.in_proj.weight.T.float()[None])
        moe.b_in.copy_(dense.in_proj.bias.float()[None])
        moe.w_out.copy_(dense.out_proj.weight.T.float()[None])
        moe.b_out.copy_(dense.out_proj.bias.float()[None])


def phase_flux_moe(vae, embeds, latents):
    g = torch.Generator(device='cuda').manual_seed(SEED + 42)
    cfg = dict(FLUX_12B, num_layers=2, num_single_layers=2)
    with torch.device('cuda'):
        dense = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **cfg)
        single = ArcFluxTransformer2DModel(dtype=torch.bfloat16,
                                           moe_experts=1,
                                           moe_capacity_factor=1.0, **cfg)
    randomize_(dense, g)
    state = {k: v for k, v in dense.state_dict().items()
             if '.ff_img.' not in k and '.ff_txt.' not in k}
    missing, _ = single.load_state_dict(state, strict=False)
    if not missing or any('.moe.' not in k for k in missing):
        raise AssertionError(f'MoE blocks miss {missing[:4]}')
    for db, mb in zip(dense.joint_blocks, single.joint_blocks):
        for stream in ('ff_img', 'ff_txt'):
            moe_from_dense(getattr(mb, stream).moe, getattr(db, stream))
            getattr(mb, stream).moe.router.data.normal_(0.0, 0.02,
                                                        generator=g)
    x = torch.randn(1, 128, 128, 16, generator=g, device='cuda')
    kw = dict(flux_inputs(g), t=torch.full((1,), 0.7, device='cuda'),
              guidance=torch.full((1,), 3.5, device='cuda'))
    with torch.inference_mode():
        before = attn.LAUNCHES
        want = dense(x, **kw)['means'].float()
        got = single(x, **kw)['means'].float()
        torch.cuda.synchronize()
    if attn.LAUNCHES - before != 8:
        raise AssertionError(f'{attn.LAUNCHES - before} K1 launches, want 8')
    rel_single = ((got - want).norm() / want.norm()).item()
    if not torch.isfinite(got).all() or rel_single > MOE_DENSE_REL_L2:
        raise AssertionError(f'single expert against dense: rel L2 '
                             f'{rel_single:.3e} > {MOE_DENSE_REL_L2}')
    del dense, single, x, kw, want, got
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, moe_experts=2,
                                          moe_capacity_factor=1.0,
                                          **FLUX_12B)
    randomize_(model, g)
    n_params = sum(p.numel() for p in model.parameters())
    expert_bytes = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters() if '.moe.' in n)
    pipe = ArcFluxPipeline(model, vae=vae)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    first, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = 0                       # the main path's counted run
    out, t_warm = timed_call(pipe, embeds, latents, output_type='pt')
    launches = attn.LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != 2 * n_blocks:
        raise AssertionError(f'{launches} K1 launches, want {2 * n_blocks}')
    img = out['images']
    check_image(img)
    rerun = (first['images'] - img).abs().max().item()
    del pipe, model, out, first
    gc.collect()
    torch.cuda.empty_cache()
    log(f'phase 41 MoE at FLUX-12B width: (a) 2 + 2 blocks, moe_experts=1 at '
        f'capacity 1.0 with the dense FFN weights in the expert against the '
        f'dense blocks: means rel L2 {rel_single:.3e} (bound '
        f'{MOE_DENSE_REL_L2}), 8 K1 | (b) FLUX-12B ArcFlux with '
        f'moe_experts=2 at capacity 1.0 in every joint block '
        f'({n_params / 1e9:.2f}B parameters, the experts fp32: '
        f'{expert_bytes / 2 ** 30:.2f} GiB), 2-NFE 1024x1024 + decode from '
        f'phase 6\'s embeds and latents: '
        f'ok | image {tuple(img.shape)} finite, max|run1 - run2| '
        f'{rerun:.3e} | K1 launches {launches} | build {t_build:.1f} s, '
        f'cold {t_cold:.3f} s | warm per image {t_warm:.4f} s | peak memory '
        f'{peak_gib:.2f} GiB')
    return dict(launches=launches, rel_single=rel_single, s=t_warm,
                peak_gib=peak_gib)


def phase_qwen_train_local_ring(model, batch, seed):
    """Phase 39: phase 27's Qwen model (1 joint block, full width, int8
    trunk, 384 of 512 text tokens valid, CFG negatives with 128) with every
    attention on ``LocalRing(SP)``: one loss and backward against the one
    without ``sp`` on the same draws, the key-masked K3 hops included. As
    in phase 38, the ring's backward is also held over the attention
    backward's share of the gradients upstream of an attention
    (QWEN_UPSTREAM_OF_ATTENTION) within SP_SHARE_REL_L2, which the planted
    fault (shard 0's dK / dV not sent home) must break."""
    adapter = model.init_params()[0]['diffusion']
    calls = []
    real_ring = layers.ring_attention

    def spied(q, k, v, kv_valid, ring, **kw):
        calls.append(kv_valid is not None)
        return real_ring(q, k, v, kv_valid, ring, **kw)

    def run():
        for p in adapter.values():
            p.grad = None
        draws = torch.Generator(device='cuda').manual_seed(seed)
        loss, _ = model.loss(batch, draws, running_status=dict(iteration=0))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: (p.grad if p.grad is not None else
                                 torch.zeros_like(p)).float().clone()
                             for n, p in adapter.items()}
    ref_loss, ref_grads = run()
    zeroed = lambda *a: tuple(torch.zeros_like(t) for t in a[:3])  # noqa
    with mock.patch.object(attn, 'flash_attention_bwd', zeroed):
        zero_grads = {n: g for n, g in run()[1].items()
                      if n.startswith(QWEN_UPSTREAM_OF_ATTENTION)}
    set_sequence_parallel(model, LocalRing(SP))
    try:
        with lost_home_block():
            fault_grads = run()[1]
        # the main path's counted run
        hop.LAUNCHES = attn.LAUNCHES = attn.BWD_LAUNCHES = 0
        with mock.patch.object(layers, 'ring_attention', spied):
            loss, grads = run()
        launches = (hop.LAUNCHES, attn.BWD_LAUNCHES, attn.LAUNCHES)
    finally:
        set_sequence_parallel(model, None)
    want = SP_TRAIN_LAUNCHES
    if launches != want or not calls or not all(calls):
        raise AssertionError(f'launches (K4, K3, K1) {launches}, want '
                             f'{want}; key-masked ring calls {calls}')
    flat = lambda d: torch.cat([t.flatten() for t in d.values()])  # noqa
    rel_loss = abs(loss - ref_loss) / abs(ref_loss)
    rel_grad = rel_l2(flat(grads), flat(ref_grads))
    if max(rel_loss, rel_grad) > TRAIN_SLICE_REL_L2:
        raise AssertionError(f'loss rel {rel_loss:.3e}, adapter gradients '
                             f'rel L2 {rel_grad:.3e} > {TRAIN_SLICE_REL_L2}')
    err, fault = ring_over_share(ref_grads, zero_grads, grads, fault_grads,
                                 SP_SHARE_REL_L2)
    worst = max(err, key=err.get)
    part = (ref_grads[worst] - zero_grads[worst]).norm().item() \
        / ref_grads[worst].norm().item()
    log(f'phase 39 Qwen training on LocalRing({SP}) (phase 27\'s model: 1 '
        f'joint block, full width, int8 trunk, {QWEN_TXT_VALID} of '
        f'{QWEN_TXT} text tokens valid, CFG negatives {QWEN_NEG_VALID}): ok '
        f'| launches K4 {launches[0]}, K3 {launches[1]}, K1 {launches[2]}, '
        f'all {len(calls)} ring calls key-masked | loss {loss:.6e} against '
        f'{ref_loss:.6e} without sp, rel {rel_loss:.3e}; adapter gradients '
        f'rel L2 {rel_grad:.3e} (bound {TRAIN_SLICE_REL_L2}) | {len(err)} '
        f'tensors upstream of an attention, the ring\'s error over the '
        f'attention backward\'s share: worst {worst} {err[worst]:.3e} (bound '
        f'{SP_SHARE_REL_L2}), that share {part:.3e} of its gradient | '
        f'planted fault, shard 0\'s dK / dV not sent home: '
        f'{min(fault.values()):.3e} to {max(fault.values()):.3e}, refused')
    return dict(k4=launches[0], k3=launches[1])


class LaunchesPerIter(Hook):
    """Reads the attention launch counts (K1, K3, K4) after each iteration
    and sets them to 0 for the next (first among the hooks, none of which
    launches)."""

    priority = 0

    def __init__(self):
        self.per_iter = []

    def after_train_iter(self, runner):
        self.per_iter.append((attn.LAUNCHES, attn.BWD_LAUNCHES, hop.LAUNCHES))
        attn.LAUNCHES = attn.BWD_LAUNCHES = hop.LAUNCHES = 0


class Timings(Hook):
    """Keeps IterTimerHook's per-iteration readings (interval 1)."""

    priority = 35

    def __init__(self):
        self.rows = []

    def after_train_iter(self, runner):
        self.rows.append({k: runner.log_buffer[k] for k in
                          ('time_data', 'time_step', 'time_iter')})


class RaiseSigterm(Hook):
    priority = 90

    def __init__(self, at):
        self.at = at

    def after_train_iter(self, runner):
        if runner.iter == self.at:
            signal.raise_signal(signal.SIGTERM)


def state_mismatches(state, raw):
    """Names of what differs, bit for bit, between the live ``state`` and
    the checkpoint dict ``raw``: trainable, EMA, optimizer slots and step
    counts, the step and the generator's state. A sharded tensor's shard
    on this rank is held against its part of the saved full tensor."""
    bad = []
    for what in ('trainable', 'ema'):
        for k, sub in getattr(state, what).items():
            bad += [f'{what}.{n}' for n, t in sub.items()
                    if not torch.equal(local(t).detach().cpu(),
                                       shard_of(raw[what][k][n], t))]
    for k, tx in state.optimizers.items():
        saved = raw['optimizers'][k]['state']
        for i, slots in tx.state_dict()['state'].items():
            bad += [f'opt.{i}.{n}' for n, v in slots.items()
                    if not torch.equal(local(v).cpu(),
                                       shard_of(saved[i][n], v))]
    if not torch.equal(state.generator.get_state(), raw['generator']):
        bad.append('generator')
    if state.step != raw['step']:
        bad.append('step')
    return bad


def phase_train_runner(run):
    """Phase 11's model and state through ``IterBasedRunner``: the config's
    log hooks, the loss quartiles, ``IterTimerHook(sync=True)``, a
    trainable-only fp32 ``CheckpointManager`` in a temporary directory, and
    a hook that raises SIGTERM after the second of three iterations; with
    phase 34's evaluation after every iteration (``EvalHook`` with
    ``latent_fd`` and ``clip_score`` on a CLIP-L folder, a VAE decoder
    attached as in phase 6, the TensorBoard and wandb hooks) and phase 35's
    export of the checkpoint."""
    import importlib.util

    from arcflow_tpu_torch.runner import (EvalHook, TensorboardLoggerHook,
                                          WandbLoggerHook)
    cfg, state, frozen_host = run['cfg'], run['state'], run['frozen_host']
    adapter_bytes = 4 * FLUX_TRAIN_PARAMS[0] * 4   # weights, EMA, 2 slots
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix='runner-', dir=_build.BUILD_DIR)
    try:
        free = shutil.disk_usage(work).free
        log(f'phase 11r: {free / 2 ** 30:.1f} GiB free under {work} for a '
            f'{adapter_bytes / 2 ** 30:.1f} GiB checkpoint')
        if free < adapter_bytes + CKPT_DISK_MARGIN:
            raise AssertionError(f'{free} bytes free under {work}: the '
                                 f'checkpoint needs {adapter_bytes} + '
                                 f'{CKPT_DISK_MARGIN}')
        ckpt_cfg = cfg.checkpoint_config
        manager = CheckpointManager(
            os.path.join(work, 'ckpt'), interval=ckpt_cfg.interval,
            ckpt_trainable_only=ckpt_cfg.trainable_only)
        start = state.step
        counter, timings = LaunchesPerIter(), Timings()
        # phase 34: the evaluation, its CLIP-L folder, prompts and decoder
        g = torch.Generator(device='cuda').manual_seed(SEED + 34)
        clip_dir = os.path.join(work, 'clip')
        (n_clip, clip_ids), clip_s = synced(lambda: write_clip_folder(
            clip_dir, g, toy_tokenizer()))
        n = len(EVAL_PROMPTS)
        eval_batch = dict(prompt=EVAL_PROMPTS, prompt_embed_kwargs=dict(
            encoder_hidden_states=torch.randn(
                n, 512, cfg.model.text_embed_dim, generator=g,
                device='cuda', dtype=torch.bfloat16),
            pooled_projections=torch.randn(
                n, cfg.model.pooled_dim, generator=g, device='cuda',
                dtype=torch.bfloat16)))
        with torch.device('cuda'):
            run['model'].vae = PretrainedVAE(dtype=torch.bfloat16)
        before = EvalProbe(59)
        probe = EvalProbe(91, before)
        tensorboard = importlib.util.find_spec('tensorboard') is not None
        os.environ.setdefault('WANDB_MODE', 'offline')
        wandb_hook = WandbLoggerHook(interval=1)
        eval_hooks = [before, EvalHook(
            interval=1, batch=eval_batch, num_samples=n,
            metrics=('latent_fd', 'clip_score'), clip_path=clip_dir),
            probe, wandb_hook] + ([TensorboardLoggerHook(interval=1)]
                                  if tensorboard else [])
        log_cfg = dict(cfg.log_config, interval=1)
        hooks = build_hooks(log_cfg, extra_hooks=[
            counter, timings, QuartileLossLoggerHook(
                total_timesteps=cfg.model.diffusion.num_timesteps),
            IterTimerHook(interval=1, sync=True), CheckpointHook(manager),
            RaiseSigterm(start + RUNNER_SIGTERM_AFTER), *eval_hooks])
        runner = IterBasedRunner(
            run['model'], state, run['step'], itertools.repeat(run['batch']),
            start + cfg.total_iters, work_dir=work, hooks=hooks,
            device='cuda')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path's counted run
        attn.LAUNCHES = attn.BWD_LAUNCHES = hop.LAUNCHES = 0
        t = time.perf_counter()
        with mock.patch.object(run['model'], 'val_step',
                               probe.spy(run['model'].val_step)):
            runner.run()
        wall = time.perf_counter() - t
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        ran = runner.iter - start
        want = (TRAIN_FORWARDS * run['n_blocks'],
                TRAIN_BACKWARDS * run['n_blocks'], 0)
        if ran != RUNNER_SIGTERM_AFTER or not runner.preempted:
            raise AssertionError(f'{ran} iterations ran (preempted '
                                 f'{runner.preempted}), want '
                                 f'{RUNNER_SIGTERM_AFTER} then SIGTERM')
        if counter.per_iter != [want] * ran:
            raise AssertionError(f'launches (K1, K3, K4) per iteration '
                                 f'{counter.per_iter}, want {want}')
        saved_at = manager.latest_step()
        if saved_at != state.step:
            raise AssertionError(f'latest checkpoint {saved_at}, state step '
                                 f'{state.step}')
        nbytes, save = manager.last_save['bytes'], dict(manager.last_save)
        t = time.perf_counter()
        raw = load_raw_checkpoint(os.path.join(work, 'ckpt'))
        load_s = time.perf_counter() - t
        bad = state_mismatches(state, raw)
        if bad:
            raise AssertionError(f'checkpoint differs from the live state: '
                                 f'{bad[:5]} ({len(bad)})')
        # restore into a disturbed live state: every part must come back
        live_step = state.step
        with torch.no_grad():
            for sub in (*state.trainable.values(), *state.ema.values()):
                for p in sub.values():
                    p.add_(1.0)
        state.generator.manual_seed(SEED + 99)
        state.step = 0
        t = time.perf_counter()
        manager.restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        bad = state_mismatches(state, raw)
        if bad or state.step != live_step:
            raise AssertionError(f'restored state differs: {bad[:5]} '
                                 f'({len(bad)}), step {state.step}')
        del raw
        changed = [n for n, t in flatten(state.frozen).items()
                   if not torch.equal(t.cpu(), frozen_host[n])]
        if changed:
            raise AssertionError(f'frozen tensors changed: {changed[:5]}')
        evals = check_eval_outputs(work, probe, run['n_blocks'],
                                   wandb_hook._fallback is not None)
        export = phase_export(run, work, os.path.join(work, 'ckpt'), probe,
                              eval_batch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        run['model'].vae = None
    log(f'phase 34 evaluation inside phase 11r\'s run (EvalHook interval 1, '
        f'{n} prompts with seeded FLUX-width embeds, 2-NFE 1024x1024 from the '
        f'EMA, a bf16 VAE decoder as in phase 6; metrics latent_fd and '
        f'clip_score on a CLIP-L folder at openai/clip-vit-large-patch14\'s '
        f'widths, {n_clip} fp32 params, random, written in {clip_s:.1f} s, '
        f'token ids {clip_ids}): ok | per evaluation (generation, decode, '
        f'the CLIP load and score, the grid, the TensorBoard and wandb '
        f'logging): ' + ', '.join(f'{x:.3f} s' for x in evals['s'])
        + f' (before the run, wandb.init {probe.init_s:.3f} s)'
        + f' | eval_clip_score ' + ', '.join(f'{x:.6f}' for x in
                                             evals['scores'])
        + f' | K1 launches in the evaluations {evals["launches"]} '
        f'(2 x {2 * run["n_blocks"]}) | grid {evals["grid"]} = the last '
        f'evaluation\'s {n} images | metrics.jsonl {evals["jsonl_lines"]} '
        f'lines (wandb: '
        + ('absent, the jsonl fallback' if wandb_hook._fallback is not None
           else f'installed, WANDB_MODE={os.environ["WANDB_MODE"]}')
        + f') | tensorboard installed: {tensorboard}, '
        f'{evals["tf_events"]} event files')
    log(f'phase 35 export and serve back (python -m arcflow_tpu_torch.'
        f'export_arcflow_to_diffusers on phase 11r\'s checkpoint): ok | '
        f'{export["export_bytes"]} bytes of adapter ({FLUX_TRAIN_PARAMS[0]} '
        f'params fp32, EMA) in {export["export_s"]:.2f} s of command | '
        f'policy {export["policy"]} | served back on the student\'s own '
        f'modules through ArcFluxPipeline.load_arcflow_adapter, the last '
        f'evaluation\'s seed: {export["serve_s"]:.4f} s for '
        f'{len(EVAL_PROMPTS)} images, K1 {export["launches"]}, max |d| '
        f'against the EvalHook image {export["max_abs"]:.3e} (bitwise '
        f'{export["bitwise"]}; bound {EXPORT_IMAGE_ATOL}) | '
        f'tools.save_inference_weights: {export["inference_params"]} params '
        f'bf16, {export["inference_bytes"]} bytes in '
        f'{export["inference_s"]:.2f} s')
    # an iteration's time_iter (read at priority 30) holds the previous
    # iteration's evaluation and its logging (priorities 60-90), the first
    # the hooks' before_run (wandb.init): taken out, as phase 34 times them
    eval_s = [probe.init_s] + evals['s'][:len(timings.rows) - 1]
    per_iter = [r['time_iter'] - e for r, e in zip(timings.rows, eval_s)]
    host_ms = [1e3 * (r['time_iter'] - e - r['time_step'])
               for r, e in zip(timings.rows, eval_s)]
    data_ms = [1e3 * r['time_data'] for r in timings.rows]
    log(f'phase 11r FLUX-12B through IterBasedRunner (phase 11 model and '
        f'state, {len(hooks)} hooks: {", ".join(type(h).__name__ for h in hooks)}'
        f'): ok | SIGTERM after iteration {RUNNER_SIGTERM_AFTER} of '
        f'{RUNNER_ITERS}: {ran} iterations ran, steps {start} -> '
        f'{live_step}, force-saved at {saved_at} | launches (K1, K3, K4) per '
        f'iteration {counter.per_iter} | s per iteration through the runner '
        + ', '.join(f'{x:.4f}' for x in per_iter)
        + f' (phase 11 bare warm step {run["warm"]:.4f} s; phase 34\'s '
        f'evaluations, their logging and wandb.init taken out) | runner '
        f'host time per iteration (iteration minus synced step and those: '
        f'data, hooks) '
        + ', '.join(f'{x:.3f}' for x in host_ms) + ' ms, of it data '
        + ', '.join(f'{x:.3f}' for x in data_ms) + f' ms | checkpoint '
        f'(trainable-only fp32: adapter, EMA, AdamW slots, step, generator) '
        f'{nbytes} bytes, staged to the host in {save["stage_s"]:.3f} s, '
        f'written in {save["write_s"]:.3f} s ({nbytes / save["write_s"] / 1e9:.2f} '
        f'GB/s), loaded in {load_s:.3f} s, restored into the live state in '
        f'{restore_s:.3f} s, bitwise equal to the live state before and after '
        f'the restore; frozen trunk bit-identical | run {wall:.2f} s with '
        f'the forced save | peak memory {peak_gib:.2f} GiB')
    return dict(forward=sum(c[0] for c in counter.per_iter),
                backward=sum(c[1] for c in counter.per_iter),
                s_per_iter=per_iter, eval=evals['launches'],
                export_served=export['launches'])


# ---------------------------------------------------------------------------
# mesh training: the data and fsdp axes (phase 31 on one card, --ranks)
# ---------------------------------------------------------------------------

# phase 31: iterations of the FLUX-12B config through train_model over a
# mesh of one device, a checkpoint at the last
MESH_ITERS = 1          # one: the smoke's time goes to phases 40-41
# --ranks: (name, config, iterations, rows a rank or None as shipped) of
# each shipped config over its shipped mesh, a checkpoint at the last:
# FLUX-12B at phase 11r's batch 1, Qwen-Image 20B at its shipped 4 rows a
# rank in micro-batches of its shipped grad_accum_batch_size 1
RANKS_TRAIN = (('flux', FLUX_TRAIN_CONFIG, 2, 1),
               ('qwen', QWEN_TRAIN_CONFIG, 1, None))
# what JAX's make_mesh says to the shipped data=2, fsdp=-1 on one device
# (1 // 2 = 0; tests/test_torch_mesh_train.py holds the port's message to
# JAX's)
ONE_DEVICE_REFUSAL = "mesh {'data': 2, 'fsdp': 0} != 1 devices"
# phase 31 holds the adapter after the first iteration bitwise to the
# unsharded run, except upstream of the timestep embedding that all 57
# blocks and the head share: FSDP2 gives every unit's inputs an identity
# autograd node (its post-backward hook), which groups the 58 bf16
# gradients of that embedding in another order before autograd sums them,
# each sum rounding to bf16 (2^-8 relative). So the timestep embedder's
# LoRA gradients differ: 0.94-1.02e-2 by relative L2 on an NVIDIA H100
# 80GB HBM3 at 700.00 W, against sqrt(58) x 2^-8 = 3e-2 for
# 58 roundings in another order. AdamW's first step is g / (|g| + eps),
# sign(g) wherever |g| >> eps, so an entry whose gradient lies within that
# rounding of 0 moves the other way: the updates differ by whole steps
# there, and are reported, not bounded.
TEMB_UPSTREAM = ('time_text_embed.',)
TEMB_GRAD_REL_L2 = 3e-2


@DATASETS.register_module()
class SmokePromptEmbeds:
    """Prompt-embed batches from the loader's seeded generator, in place of
    the configs' ImagePrompt cache (no cache of real prompts is in the
    repo; phase 43 reads a written one through the native loader): per
    sample zero latents of the
    config's latent size (the data-free loss reads only their shape) and
    normal prompt embeds of the family's width; with ``valid`` a text mask
    of that many valid tokens, with ``negative_valid`` the negative
    prompt's embeds that a CFG teacher takes."""

    def __init__(self, latent_size, text_dim, text_len, pooled_dim=None,
                 valid=None, negative_valid=None):
        self.latent_size = tuple(latent_size)
        self.text_dim, self.text_len = text_dim, text_len
        self.pooled_dim = pooled_dim
        self.valid, self.negative_valid = valid, negative_valid

    def __len__(self):
        return 1

    def _embeds(self, rng, n, valid):
        out = dict(encoder_hidden_states=rng.standard_normal(
            (n, self.text_len, self.text_dim), dtype=np.float32))
        if self.pooled_dim:
            out['pooled_projections'] = rng.standard_normal(
                (n, self.pooled_dim), dtype=np.float32)
        if valid is not None:
            out['encoder_hidden_states_mask'] = np.repeat(
                (np.arange(self.text_len) < valid)[None], n, 0).astype(
                    np.int64)
        return out

    def batch(self, rng, n):
        out = dict(latents=np.zeros((n, *self.latent_size), np.float32),
                   prompt_embed_kwargs=self._embeds(rng, n, self.valid))
        if self.negative_valid is not None:
            out['negative_prompt_embed_kwargs'] = self._embeds(
                rng, n, self.negative_valid)
        return out


def mesh_train_config(path, iters, interval, mesh=None, unsharded=False,
                      samples=1):
    """``path`` through the port's ``Config`` with the cuts of phase 31 and
    --ranks: the frozen trunk in bf16 (phase 11's cut; the Qwen config sets
    it itself), ``samples`` rows a rank (phase 11r's 1; None keeps the
    config's), ``iters`` iterations, a trainable-only fp32 checkpoint every
    ``interval`` (and the forced one at the end), log interval 1, and the
    data from ``SmokePromptEmbeds`` at the config's widths (512 text
    tokens; Qwen's mask and its CFG negatives as phase 28 has them).
    ``mesh`` updates ``parallel.mesh``; ``unsharded`` drops
    ``parallel``."""
    cfg = Config.fromfile(path)
    m = cfg.model
    qwen = m.diffusion.denoising.type.startswith('ArcQwen')
    cfg_scale = cfg.train_cfg.get('teacher_guidance_scale')
    data = dict(_delete_=True, type='SmokePromptEmbeds',
                latent_size=m.latent_shape, text_dim=m.text_embed_dim,
                text_len=QWEN_TXT if qwen else 512,
                pooled_dim=None if qwen else m.pooled_dim,
                valid=QWEN_TXT_VALID if qwen else None,
                negative_valid=QWEN_NEG_VALID
                if cfg_scale not in (None, 0.0, 1.0) else None)
    opts = {'model.frozen_dtype': 'bfloat16', 'total_iters': iters,
            'data.train': data,
            'checkpoint_config': dict(_delete_=True, interval=interval,
                                      trainable_only=True),
            'log_config.interval': 1}
    if samples is not None:
        opts['data.train_dataloader.samples_per_gpu'] = samples
    if mesh is not None:
        opts['parallel.mesh'] = mesh
    if unsharded:
        opts['parallel'] = dict(_delete_=True)
    cfg.merge_from_dict(opts)
    return cfg


def host_adapter(state):
    """The adapter gathered whole to the host; of a model split over
    ``tensor`` (every rank joining the gathers) on rank 0 alone, in the
    one-device layout (``TensorPlacement.gather_full``)."""
    mp = getattr(state, 'model_parallel', None)
    if isinstance(mp, tensor_mod.TensorPlacement):
        whole = {n: mp.gather_full(n, p.detach())
                 for n, p in state.trainable['diffusion'].items()}
        return {n: t.to('cpu', copy=True) for n, t in whole.items()
                if t is not None}
    return {n: (p.full_tensor() if is_sharded(p) else p).detach().to(
        'cpu', copy=True) for n, p in state.trainable['diffusion'].items()}


class IterLogs(Hook):
    """Each iteration's loss and gradient norm; with ``keep_first`` the
    adapter before and after the first iteration and the first
    iteration's gradients of the adapter tensors under TEMB_UPSTREAM,
    gathered to the host."""

    priority = 36

    def __init__(self, keep_first=False):
        self.rows = []
        self.keep_first = keep_first
        self.adapters = []
        self.grads = {}

    def before_run(self, runner):
        # the peak of the build (a quantized trunk is built in bf16 first);
        # from here on the peak of training
        self.build_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        self.names = list(runner.state.trainable['diffusion'])
        if self.keep_first:
            self.adapters.append(host_adapter(runner.state))

    @contextlib.contextmanager
    def first_grads(self):
        """Within the block, the train step's first clip (the first
        iteration's gradients) leaves the TEMB_UPSTREAM ones in
        ``grads``."""
        from arcflow_tpu_torch.runner import train_step as ts
        clip = ts.clip_and_skip

        def spy(grads, iteration, cfg, *rest):
            if self.keep_first and not self.grads:
                names = self.names
                self.grads = {
                    names[i]: (g.full_tensor() if is_sharded(g) else g
                               ).detach().to('cpu', copy=True)
                    for i, g in enumerate(grads)
                    if names[i].startswith(TEMB_UPSTREAM)}
            return clip(grads, iteration, cfg, *rest)
        with mock.patch.object(ts, 'clip_and_skip', spy):
            yield

    def after_train_iter(self, runner):
        logs = runner.log_buffer
        self.rows.append(dict(loss=float(logs['loss']),
                              grad_norm=float(logs['diffusion_grad_norm'])))
        if self.keep_first and len(self.rows) == 1:
            self.adapters.append(host_adapter(runner.state))


@contextlib.contextmanager
def mesh_train_hooks(hooks, managers):
    """``train_model`` with ``hooks`` added to its own and each of its
    ``CheckpointManager``s appended to ``managers``."""
    build_hooks_real = t_train.build_hooks

    def build(*args, extra_hooks=(), **kwargs):
        return build_hooks_real(*args, extra_hooks=[*extra_hooks, *hooks],
                                **kwargs)

    class Kept(CheckpointManager):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            managers.append(self)
    with mock.patch.object(t_train, 'build_hooks', build), \
            mock.patch.object(t_train, 'CheckpointManager', Kept):
        yield


@contextlib.contextmanager
def random_weights(seed):
    """``train_model``'s composition with phase 11's and phase 28's random
    weights: normal(0.02) on every weight matrix of the student, drawn
    before its trunk is quantized, and of the teacher's head."""
    from arcflow_tpu_torch.models import LatentDiffusionTextImage
    g = torch.Generator(device='cuda').manual_seed(seed)
    quantize = LatentDiffusionTextImage._quantize
    build = t_train.build_model_from_cfg

    def randomized_quantize(self, module):
        randomize_(module, g)
        return quantize(self, module)

    def randomized_build(cfg, device='cuda'):
        model = build(cfg, device=device)
        teacher = model.teacher.denoising
        randomize_(torch.nn.ModuleList([teacher.norm_out,
                                        teacher.proj_out]), g)
        return model
    with mock.patch.object(LatentDiffusionTextImage, '_quantize',
                           randomized_quantize), \
            mock.patch.object(t_train, 'build_model_from_cfg',
                              randomized_build):
        yield


def mesh_train_run(cfg, work, seed, keep_first=False):
    """``train_model`` on ``cfg`` from random weights of ``seed``, with the
    attention launches read per iteration (LaunchesPerIter), the synced
    step and iteration times (IterTimerHook), the loss and gradient norm
    of each iteration; returns what it read, the state and the model."""
    counter = LaunchesPerIter()
    timings, logs = Timings(), IterLogs(keep_first)
    managers = []
    hooks = [counter, timings, logs, IterTimerHook(interval=1, sync=True)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path's counted run
    attn.LAUNCHES = attn.BWD_LAUNCHES = hop.LAUNCHES = 0
    t = time.perf_counter()
    with random_weights(seed), mesh_train_hooks(hooks, managers), \
            logs.first_grads():
        state, model = t_train.train_model(cfg, work_dir=work, resume=False,
                                           device='cuda')
    torch.cuda.synchronize()
    return dict(state=state, model=model, wall=time.perf_counter() - t,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                build_peak_gib=logs.build_peak_gib,
                launches=counter.per_iter,
                s_per_iter=[r['time_iter'] for r in timings.rows],
                s_per_step=[r['time_step'] for r in timings.rows],
                rows=logs.rows, adapters=logs.adapters, grads=logs.grads,
                manager=managers[0])


def checkpoint_round_trip(state, manager):
    """The latest checkpoint of ``manager`` against the live ``state``
    (each rank's shards against their parts of the saved tensors), then
    restored into a disturbed live state and held against it again.
    Returns (bytes, load s, restore s)."""
    path = os.path.join(manager.directory, str(manager.latest_step()),
                        'state.pt')
    t = time.perf_counter()
    raw = load_raw_checkpoint(manager.directory)
    load_s = time.perf_counter() - t
    bad = state_mismatches(state, raw)
    if bad:
        raise AssertionError(f'checkpoint differs from the live state: '
                             f'{bad[:5]} ({len(bad)})')
    live_step = state.step
    with torch.no_grad():
        for sub in (*state.trainable.values(), *state.ema.values()):
            for p in sub.values():
                local(p).add_(1.0)
    state.generator.manual_seed(SEED + 99)
    state.step = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    manager.restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    bad = state_mismatches(state, raw)
    if bad or state.step != live_step:
        raise AssertionError(f'restored state differs: {bad[:5]} '
                             f'({len(bad)}), step {state.step}')
    return os.path.getsize(path), load_s, restore_s


def phase_mesh_train(runner_s, bare_s):
    """Phase 31: the FLUX-12B config through ``train_model`` over the mesh
    data=1, fsdp=-1 (``_multihost_train.py``'s per-slice half) on one card,
    FSDP2 at world size 1, against the same config without a mesh."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix='mesh-', dir=_build.BUILD_DIR)
    setup_distributed()                 # a process group of one
    try:
        try:
            t_train.train_model(Config.fromfile(FLUX_TRAIN_CONFIG),
                                work_dir=os.path.join(work, 'shipped'),
                                device='cuda')
            raise AssertionError('the shipped mesh data=2, fsdp=-1 trained '
                                 'on one card')
        except ValueError as e:
            if str(e) != ONE_DEVICE_REFUSAL:
                raise AssertionError(f'one card refused the shipped mesh '
                                     f'with {e!r}, JAX says '
                                     f'{ONE_DEVICE_REFUSAL!r}') from e
        ref = mesh_train_run(mesh_train_config(FLUX_TRAIN_CONFIG, 1, 0,
                                               unsharded=True),
                             os.path.join(work, 'ref'), SEED + 31,
                             keep_first=True)
        ref_loss = ref['rows'][0]['loss']
        ref_before, ref_after = ref['adapters']
        ref_grads = ref['grads']
        ref_s = ref['s_per_step'][0]
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        cfg = mesh_train_config(FLUX_TRAIN_CONFIG, MESH_ITERS, MESH_ITERS,
                                mesh=dict(data=1, fsdp=-1))
        run = mesh_train_run(cfg, os.path.join(work, 'mesh'), SEED + 31,
                             keep_first=True)
        state, manager = run['state'], run['manager']
        n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
        want = (TRAIN_FORWARDS * n_blocks, TRAIN_BACKWARDS * n_blocks, 0)
        if run['launches'] != [want] * MESH_ITERS:
            raise AssertionError(f'launches (K1, K3, K4) per iteration '
                                 f'{run["launches"]}, want {want}')
        adapter = state.trainable['diffusion']
        n_sharded = sum(is_sharded(p) for p in adapter.values())
        if n_sharded != len(adapter) or state.step != MESH_ITERS:
            raise AssertionError(f'{n_sharded} of {len(adapter)} adapter '
                                 f'tensors sharded, step {state.step}')
        rows = run['rows']
        if not all(math.isfinite(r['loss']) and math.isfinite(r['grad_norm'])
                   for r in rows):
            raise AssertionError(f'iterations {rows}')
        if rows[0]['loss'] != ref_loss:
            raise AssertionError(f'first loss {rows[0]["loss"]!r} under the '
                                 f'mesh, {ref_loss!r} without')
        before, after = run['adapters']
        before_names = list(before)
        if any(not torch.equal(p, ref_before[n]) for n, p in before.items()):
            raise AssertionError('the two runs start from other adapters')
        differ = [n for n, p in after.items()
                  if not torch.equal(p, ref_after[n])]
        grads = {n: rel_l2(g, ref_grads[n]) for n, g in run['grads'].items()}
        summed = {n: rel_l2(after[n] - before[n], ref_after[n] - before[n])
                  for n in grads}
        if not set(differ) <= set(grads) or not grads or max(
                grads.values()) > TEMB_GRAD_REL_L2:
            raise AssertionError(f'{len(differ)} adapter tensors differ '
                                 f'after the first iteration, e.g. '
                                 f'{differ[:3]}; gradients upstream of the '
                                 f'shared timestep embedding by relative L2 '
                                 f'{grads} (bound {TEMB_GRAD_REL_L2}), their '
                                 f'updates {summed}')
        del ref_before, ref_after, before, after, run['adapters']
        nbytes, load_s, restore_s = checkpoint_round_trip(state, manager)
        save = dict(manager.last_save)
        # the LoRA dropout's cost, drawn as before as 4 ranks drew it
        model = run['model']
        mesh = next(iter(adapter.values())).device_mesh
        step = build_train_step(model, state.optimizers, model.train_cfg,
                                ema_config_from_cfg(cfg), mesh=mesh)
        batch = to_device(t_train.build_dataset(cfg.data.train).batch(
            np.random.default_rng([SEED, 31]), 1), torch.device('cuda'))
        dropout = dropout_cost(model, state, step, batch, ranks=4)
        del model, step
        s_iter, s_step = run['s_per_iter'], run['s_per_step']
        peak, build_peak = run['peak_gib'], run['build_peak_gib']
    finally:
        shutil.rmtree(work, ignore_errors=True)
        dist.destroy_process_group()
    log(f'phase 31 FLUX-12B mesh training ({FLUX_TRAIN_CONFIG} through '
        f'train_model, parallel.mesh data=1, fsdp=-1 -> FSDP2 over a 1 x 1 '
        f'DeviceMesh on one card; cuts: frozen trunk bf16, batch 1, '
        f'{MESH_ITERS} iterations, trainable-only checkpoint every '
        f'{MESH_ITERS}, data SmokePromptEmbeds at 512 x 4096 + 768, random '
        f'weights from a seed): ok | the shipped mesh data=2, fsdp=-1 '
        f'refused: {ONE_DEVICE_REFUSAL!r} (JAX\'s message) | first '
        f'iteration against the unsharded run: loss bitwise ({ref_loss!r}), '
        f'{len(before_names) - len(differ)} of {len(before_names)} adapter '
        f'tensors bitwise after it; the {len(grads)} upstream of the shared '
        f'timestep embedding: gradients within relative L2 '
        + ', '.join(f'{x:.3e}' for x in grads.values())
        + f' (bound {TEMB_GRAD_REL_L2}), updates '
        + ', '.join(f'{x:.3e}' for x in summed.values())
        + ' (AdamW\'s first step, sign(g) where |g| >> eps) | s per synced '
        'step '
        + ', '.join(f'{x:.4f}' for x in s_step)
        + ' | s per iteration ' + ', '.join(f'{x:.4f}' for x in s_iter)
        + f' (unsharded first step {ref_s:.4f} s; phase 11r runner '
        + ', '.join(f'{x:.4f}' for x in runner_s)
        + f'; phase 11 bare warm step {bare_s:.4f} s) | losses '
        + ', '.join(f'{r["loss"]:.5e}' for r in rows)
        + ' | grad norms ' + ', '.join(f'{r["grad_norm"]:.4e}' for r in rows)
        + f' | launches per iteration {run["launches"][0]} | peak memory '
        f'{peak:.2f} GiB training, {build_peak:.2f} GiB building | '
        f'{n_sharded} adapter tensors sharded (DTensor) | '
        f'checkpoint {nbytes} bytes, gathered to the host in '
        f'{save["stage_s"]:.3f} s, written in {save["write_s"]:.3f} s, '
        f'loaded in {load_s:.3f} s, restored into the shards in '
        f'{restore_s:.3f} s, bitwise before and after the restore | '
        + dropout_line(dropout))
    return dict(forward=sum(c[0] for c in run['launches']),
                backward=sum(c[1] for c in run['launches']))


def nccl_split(by_name, wall, busy,
               kinds=('AllGather', 'ReduceScatter', 'AllReduce')):
    """The profiler's NCCL kernel ms of one step by kind (all-gather,
    reduce-scatter and all-reduce by default; 'SendRecv' for the ring's
    rotations and the all-to-alls), with their shares of the profiled
    wall and device-busy time. A NCCL kernel's device time includes its
    wait for the other ranks, so the shares bound the collectives' cost
    from above."""
    out = {}
    for kind in kinds:
        ms = sum(v[0] for name, v in by_name.items()
                 if 'nccl' in name.lower() and kind in name)
        out[kind] = dict(ms=ms, share_of_wall=ms / 1e3 / wall,
                         share_of_busy=ms / 1e3 / busy)
    return out


def micro_batches(cfg):
    """Micro-batches a rank runs per iteration of ``cfg``."""
    spg = cfg.data.train_dataloader.get('samples_per_gpu', 1)
    return spg // (cfg.train_cfg.get('grad_accum_batch_size') or spg)


def whole_batch_draw(count):
    """LoRA dropout's draw as it was before each rank drew its own rows,
    at ``count`` batch ranks: the masks of the whole global batch from one
    generator, of which the rank kept its rows (what
    ``layers.uniform_rows`` replaced; the cost is what is measured, not
    the values)."""
    def draw(x, generator):
        index = mesh_mod._BATCH_ROWS[0]
        g = generator if isinstance(generator, torch.Generator) \
            else generator[0]
        b = x.shape[0]
        return torch.rand((b * count, *x.shape[1:]), generator=g,
                          device=x.device).narrow(0, index * b, b)
    return draw


def dropout_cost(model, state, step, batch, ranks=None):
    """One step each with the LoRA dropout drawn as now (each rank its own
    rows, a generator per row), as before at ``ranks`` batch ranks (this
    mesh's when None; ``whole_batch_draw``), off (no dropout seed), and as
    now again: s per step and peak GiB of each, and the draws of one step
    with the bytes of their masks on this rank, now and before."""
    if ranks is None:
        _, ranks = batch_ranks(next(iter(
            state.trainable['diffusion'].values())).device_mesh)
    real, draws = layers.uniform_rows, []

    def counted(x, generator):
        draws.append(x.numel() * 4)
        return real(x, generator)
    den = model.diffusion.denoising
    out = dict(ranks=ranks)
    for name in ('now', 'before', 'off', 'now_again'):
        patch = dict(now=counted, before=whole_batch_draw(ranks)).get(
            name, real)
        p = den.lora_dropout
        if name == 'off':
            den.lora_dropout = 0.0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with mock.patch.object(layers, 'uniform_rows', patch):
            step(state, batch)
        torch.cuda.synchronize()
        out[name] = dict(s=time.perf_counter() - t,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        den.lora_dropout = p
    out['draws'] = len(draws)
    out['mask_bytes_now'] = sum(draws)
    out['mask_bytes_before'] = sum(draws) * ranks
    return out


def dropout_line(d):
    """``dropout_cost``'s reading as text."""
    return (f'LoRA dropout, s per step (peak GiB) drawn now / as before at '
            f'{d["ranks"]} batch ranks / off / now again: '
            + ' / '.join(f'{d[k]["s"]:.4f} ({d[k]["peak_gib"]:.2f})'
                         for k in ('now', 'before', 'off', 'now_again'))
            + f'; {d["draws"]} draws a step, masks of {d["mask_bytes_now"]} '
            f'bytes now, {d["mask_bytes_before"]} before')


def mesh_rank_main(out_dir):
    """One rank of ``--ranks N``'s training: each of ``RANKS_TRAIN`` over
    its mesh as shipped (data=2, fsdp=-1), with a checkpoint written at
    the last iteration (FLUX's restored on the same ranks), one more step
    profiled, and FLUX's LoRA dropout timed now, before and off
    (``dropout_cost``); writes ``train{r}.json``."""
    setup_distributed(timeout=600.0)
    rank = dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = os.path.join(out_dir, 'work')
    res = dict(rank=rank)
    for name, path, iters, samples in RANKS_TRAIN:
        cfg = mesh_train_config(path, iters, iters, samples=samples)
        run = mesh_train_run(cfg, os.path.join(work, name), SEED + 32)
        state, model = run['state'], run['model']
        mesh = next(iter(state.trainable['diffusion'].values())).device_mesh
        raw = load_raw_checkpoint(run['manager'].directory)
        shards_bad = state_mismatches(state, raw)
        del raw
        round_trip = None
        if name == 'flux':
            round_trip = checkpoint_round_trip(state, run['manager'])
        # one more step of one row under the profiler: the collectives'
        # share
        step = build_train_step(model, state.optimizers, model.train_cfg,
                                ema_config_from_cfg(cfg), mesh=mesh)
        batch = t_train.build_dataset(cfg.data.train).batch(
            np.random.default_rng([SEED, rank]), 1)
        batch = to_device(batch, torch.device('cuda',
                                              torch.cuda.current_device()))
        wall, busy, by_name = profile_split(lambda: step(state, batch))
        dropout = dropout_cost(model, state, step, batch) \
            if name == 'flux' else None
        quant = [b for n, b in model.diffusion.denoising.named_buffers()
                 if n.endswith('.kernel')]
        res[name] = dict(
            mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), iters=iters,
            samples=cfg.data.train_dataloader.samples_per_gpu,
            micro_batches=micro_batches(cfg),
            launches=run['launches'], s_per_iter=run['s_per_iter'],
            rows=run['rows'], peak_gib=run['peak_gib'],
            build_peak_gib=run['build_peak_gib'], wall=run['wall'],
            shards_bad=shards_bad[:5], n_shards_bad=len(shards_bad),
            round_trip=round_trip, profiled_wall_s=wall,
            device_busy_s=busy, nccl=nccl_split(by_name, wall, busy),
            dropout=dropout,
            int8_trunk_bytes_per_rank=sum(local(b).numel()
                                          * local(b).element_size()
                                          for b in quant),
            int8_trunk_sharded=any(is_sharded(b) for b in quant))
        del state, model, step, run
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f'train{rank}.json'), 'w') as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def check_mesh_ranks(ranks, n):
    """--ranks' training read across the ranks: the launches per
    iteration, finite losses, and each rank's shards (trainable, EMA,
    optimizer slots) and generator equal to their parts of the checkpoint
    rank 0 gathered from its data replica: the check that the replicas
    agree. The logged loss and gradient norm are all-reduced before they
    are logged, the same on every rank by construction, and prove
    nothing of the kind."""
    bad = []
    for name, n_blocks in (('flux', FLUX_12B['num_layers']
                            + FLUX_12B['num_single_layers']),
                           ('qwen', QWEN_20B['num_layers'])):
        for r in ranks:
            got = r[name]
            want = [got['micro_batches'] * TRAIN_FORWARDS * n_blocks,
                    got['micro_batches'] * TRAIN_BACKWARDS * n_blocks, 0]
            if got['launches'] != [want] * got['iters']:
                bad.append((r['rank'], name, 'launches', got['launches']))
            if got['n_shards_bad']:
                bad.append((r['rank'], name, 'shards', got['shards_bad']))
            if not all(math.isfinite(x['loss']) for x in got['rows']):
                bad.append((r['rank'], name, 'loss', got['rows']))
            if got['mesh'] != {'data': 2, 'fsdp': n // 2}:
                bad.append((r['rank'], name, 'mesh', got['mesh']))
    if bad:
        raise AssertionError(f'--ranks {n} training failed: {bad}')
    r0 = ranks[0]
    for name in ('flux', 'qwen'):
        lines = []
        for r in ranks:
            x = r[name]
            lines.append(
                f'rank {r["rank"]}: s per iteration '
                + ', '.join(f'{s:.4f}' for s in x['s_per_iter'])
                + f', peak {x["peak_gib"]:.2f} GiB training '
                f'({x["build_peak_gib"]:.2f} building), profiled step wall '
                f'{x["profiled_wall_s"]:.4f} s, busy '
                f'{x["device_busy_s"]:.4f} s, NCCL '
                + ', '.join(f'{k} {v["ms"]:.1f} ms ({100 * v["share_of_wall"]:.1f}% '
                            f'of wall)' for k, v in x['nccl'].items()))
        x = r0[name]
        extra = ''
        if x['round_trip'] is not None:
            nbytes, load_s, restore_s = x['round_trip']
            extra = (f' | checkpoint {nbytes} bytes, loaded in {load_s:.3f} '
                     f's, restored into the shards in {restore_s:.3f} s on '
                     f'every rank, bitwise')
        if name == 'qwen':
            extra += (f' | int8 trunk kernels {x["int8_trunk_bytes_per_rank"]}'
                      f' bytes per rank, sharded: {x["int8_trunk_sharded"]}')
        if x['dropout'] is not None:
            extra += ' | ' + ' ; '.join(
                f'rank {r["rank"]} ' + dropout_line(r[name]['dropout'])
                for r in ranks)
        log(f'phase RT {name} training on {n} NCCL ranks (mesh '
            f'{x["mesh"]}, as shipped; {x["samples"]} rows a rank in '
            f'{x["micro_batches"]} micro-batches, {x["iters"]} iterations): '
            f'ok | launches per iteration {x["launches"][0]} on every rank '
            f'| losses '
            + ', '.join(f'{row["loss"]:.5e}' for row in x['rows'])
            + ' | grad norms '
            + ', '.join(f'{row["grad_norm"]:.4e}' for row in x['rows'])
            + ' (rank 0) | every rank\'s shards equal to their part of the '
            'checkpoint gathered from data replica 0' + extra + ' | '
            + ' ; '.join(lines))


# --ranks: FLUX-12B trained under sp (phase 31's cuts, SP_RANK_ITERS
# iterations, no checkpoint) over n ranks: (name, mesh, sp_mode)
SP_RANK_ITERS = 2


def sp_rank_cases(n):
    return (('ring', dict(data=1, fsdp=1, sp=n), 'ring'),
            ('ulysses', dict(data=1, fsdp=1, sp=n), 'ulysses'),
            ('fsdp2_sp', dict(data=1, fsdp=2, sp=n // 2), 'ring'))


def sp_rank_launches(axes, mode, n_blocks):
    """(K1, K3, K4) launches per rank and iteration: a ring of sp shards
    folds sp hops per attention, forward and backward; Ulysses runs K1 and
    K3 once per attention on its head shard."""
    sp = axes['sp']
    if mode == 'ring':
        return [0, TRAIN_BACKWARDS * n_blocks * sp,
                TRAIN_FORWARDS * n_blocks * sp]
    return [TRAIN_FORWARDS * n_blocks, TRAIN_BACKWARDS * n_blocks, 0]


# The first iteration's update of the adapter under sp (after minus
# before) against one card's, by relative L2. AdamW's first step moves
# every entry by about lr (g / (|g| + eps), the sign of g), so an entry
# whose gradient lies within the two runs' bf16 noise of 0 may move the
# other way (2 lr): sound runs read 0.09-0.1 (NVIDIA H100 80GB HBM3, 700
# W), the sign of some 0.2% of the entries. An update that is lost reads
# 1, one with its signs flipped 2; SP_UPDATE_REL_L2 lies between. A
# gradient off by a factor keeps the signs: the first iteration's
# gradients of the timestep embedder, which feeds both the sharded blocks
# and the replicated head (the case a wrong gradient convention over sp
# shows), are held within TRAIN_SLICE_REL_L2.
SP_UPDATE_REL_L2 = 0.3


def no_final_checkpoint():
    """``train_model`` without the checkpoint ``CheckpointHook`` forces at
    the end of a run (the sp runs check training, not checkpoints: phase
    31 and ``--ranks``' mesh training hold those)."""
    return mock.patch.object(CheckpointHook, 'after_run',
                             lambda self, runner: None)


def _concat_batches(parts):
    if isinstance(parts[0], dict):
        return {k: _concat_batches([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


@contextlib.contextmanager
def joined_rows(count):
    """One card's loader yields the global batch of ``count`` batch ranks:
    their rows (each rank's loader of one row each) concatenated."""
    real = t_train.build_dataloader

    def build(dataset, samples, num_replicas=1, rank=0, **kwargs):
        its = [real(dataset, samples // count, num_replicas=count, rank=r,
                    **kwargs) for r in range(count)]

        def gen():
            while True:
                yield _concat_batches([next(it) for it in its])
        return gen()
    with mock.patch.object(t_train, 'build_dataloader', build):
        yield


def sp_train_references(out_dir, n):
    """--ranks' one-card references for the sp training: the FLUX-12B
    config's first iteration on one card on the global batch of 1 row (the
    sp = n cases) and of 2 rows (fsdp = 2 x sp = n / 2), its loss, its
    timestep embedder's gradients and the adapter before and after, saved
    for the ranks."""
    out = {}
    for rows in sorted({a['data'] * a['fsdp'] for _, a, _ in
                        sp_rank_cases(n)}):
        cfg = mesh_train_config(FLUX_TRAIN_CONFIG, 1, 0, unsharded=True,
                                samples=rows)
        with joined_rows(rows), no_final_checkpoint():
            run = mesh_train_run(cfg, os.path.join(out_dir, f'ref{rows}'),
                                 SEED + 40, keep_first=True)
        before, after = run['adapters']
        torch.save(dict(loss=run['rows'][0]['loss'], grads=run['grads'],
                        before=before, after=after),
                   os.path.join(out_dir, f'sp_ref{rows}.pt'))
        out[rows] = dict(loss=run['rows'][0]['loss'],
                         s=run['s_per_step'][0], peak_gib=run['peak_gib'])
        del run, before, after
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sp_rank_main(out_dir):
    """One rank of ``--ranks N``'s training under sp: FLUX-12B through
    ``train_model`` with the config's mesh overridden by each of
    ``sp_rank_cases`` and ``parallel.sp_mode`` set, from phase 31's random
    weights, against the one-card references; writes ``sp{r}.json``."""
    setup_distributed(timeout=600.0)
    rank, n = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    res = dict(rank=rank)
    for name, axes, mode in sp_rank_cases(n):
        cfg = mesh_train_config(FLUX_TRAIN_CONFIG, SP_RANK_ITERS, 0,
                                mesh=axes)
        cfg.merge_from_dict({'parallel.sp_mode': mode})
        with no_final_checkpoint():
            run = mesh_train_run(cfg, os.path.join(out_dir, 'sp', name),
                                 SEED + 40, keep_first=True)
        rows = axes['data'] * axes['fsdp']
        ref = torch.load(os.path.join(out_dir, f'sp_ref{rows}.pt'))
        before, after = run['adapters']
        names = list(ref['before'])
        upd = torch.cat([(after[k] - before[k]).flatten() for k in names])
        ref_upd = torch.cat([(ref['after'][k] - ref['before'][k]).flatten()
                             for k in names])
        res[name] = dict(
            mesh=axes, sp_mode=mode, iters=SP_RANK_ITERS,
            launches=run['launches'],
            want_launches=sp_rank_launches(axes, mode, n_blocks),
            rows=run['rows'], s_per_iter=run['s_per_iter'],
            s_per_step=run['s_per_step'], peak_gib=run['peak_gib'],
            build_peak_gib=run['build_peak_gib'],
            ref_loss=ref['loss'],
            loss_rel=abs(run['rows'][0]['loss'] - ref['loss'])
            / abs(ref['loss']),
            before_equal=all(torch.equal(before[k], ref['before'][k])
                             for k in names),
            grad_rel={k: rel_l2(g, ref['grads'][k])
                      for k, g in run['grads'].items()},
            update_norm=upd.norm().item(), update_rel=rel_l2(upd, ref_upd))
        del ref, before, after, upd, ref_upd
        # one more step under the profiler: where its time goes
        mesh = mesh_mod.make_mesh(dict(axes))
        model, state = run['model'], run['state']
        step = build_train_step(model, state.optimizers, model.train_cfg,
                                ema_config_from_cfg(cfg), mesh=mesh)
        index, _ = batch_ranks(mesh)
        batch = to_device(t_train.build_dataset(cfg.data.train).batch(
            np.random.default_rng([SEED, index]), 1),
            torch.device('cuda', torch.cuda.current_device()))
        wall, busy, by_name = profile_split(lambda: step(state, batch))
        families = split_families(by_name)
        res[name].update(
            profiled_wall_s=wall, device_busy_s=busy,
            families={f: ms for f, (ms, _, _) in families.items()},
            nccl=nccl_split(by_name, wall, busy, ('SendRecv', 'AllGather',
                                                  'ReduceScatter',
                                                  'AllReduce')))
        del run, model, state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f'sp{rank}.json'), 'w') as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def check_sp_ranks(ranks, n, refs):
    """--ranks' training under sp read across the ranks: the launches per
    iteration, every rank's losses equal to rank 0's, and rank 0's first
    iteration against one card's (loss and the timestep embedder's
    gradients within TRAIN_SLICE_REL_L2, the adapter's update nonzero and
    within SP_UPDATE_REL_L2, the same start)."""
    bad = []
    for name, axes, mode in sp_rank_cases(n):
        for r in ranks:
            got = r[name]
            if got['launches'] != [got['want_launches']] * got['iters']:
                bad.append((r['rank'], name, 'launches', got['launches']))
            if [x['loss'] for x in got['rows']] != [
                    x['loss'] for x in ranks[0][name]['rows']]:
                bad.append((r['rank'], name, 'loss', got['rows']))
            if not all(math.isfinite(x['loss']) for x in got['rows']):
                bad.append((r['rank'], name, 'finite', got['rows']))
            if not got['before_equal']:
                bad.append((r['rank'], name, 'start'))
            if got['loss_rel'] > TRAIN_SLICE_REL_L2 or not got['grad_rel'] \
                    or max(got['grad_rel'].values()) > TRAIN_SLICE_REL_L2:
                bad.append((r['rank'], name, 'one card', got['loss_rel'],
                            got['grad_rel']))
            if not got['update_norm'] > 0 \
                    or got['update_rel'] > SP_UPDATE_REL_L2:
                bad.append((r['rank'], name, 'update', got['update_norm'],
                            got['update_rel']))
    if bad:
        raise AssertionError(f'--ranks {n} training under sp failed: {bad}')
    for name, axes, mode in sp_rank_cases(n):
        x = ranks[0][name]
        rows = axes['data'] * axes['fsdp']
        log(f'phase RS FLUX-12B training under sp on {n} NCCL ranks '
            f'({name}: mesh {axes}, sp_mode {mode}; phase 31\'s cuts, '
            f'{rows} row(s) a step, LoRA dropout on, {x["iters"]} '
            f'iterations): ok | launches per rank and iteration (K1, K3, '
            f'K4) {x["launches"][0]} on every rank | losses '
            + ', '.join(f'{row["loss"]:.5e}' for row in x['rows'])
            + f' on every rank | first iteration against one card (loss '
            f'{x["ref_loss"]:.5e}, s per step {refs[rows]["s"]:.4f}, peak '
            f'{refs[rows]["peak_gib"]:.2f} GiB): loss rel '
            f'{x["loss_rel"]:.3e}, timestep embedder gradients rel L2 '
            + ', '.join(f'{v:.3e}' for v in x['grad_rel'].values())
            + f' (bound {TRAIN_SLICE_REL_L2}), the adapter\'s update (norm '
            f'{x["update_norm"]:.4e}) rel L2 {x["update_rel"]:.3e} (bound '
            f'{SP_UPDATE_REL_L2}) | rank 0 profiled step: wall '
            f'{x["profiled_wall_s"]:.4f} s, device busy '
            f'{x["device_busy_s"]:.4f} s, idle share '
            f'{1 - x["device_busy_s"] / x["profiled_wall_s"]:.4f}; by '
            f'family ' + ', '.join(
                f'{f} {ms:.1f} ms' for f, ms in sorted(
                    x['families'].items(), key=lambda kv: -kv[1]))
            + '; NCCL ' + ', '.join(
                f'{k} {v["ms"]:.1f} ms ({100 * v["share_of_wall"]:.1f}% of '
                f'wall)' for k, v in x['nccl'].items()) + ' | '
            + ' ; '.join(
                f'rank {r["rank"]}: s per iteration '
                + ', '.join(f'{v:.4f}' for v in r[name]['s_per_iter'])
                + f', peak {r[name]["peak_gib"]:.2f} GiB training '
                f'({r[name]["build_peak_gib"]:.2f} building)'
                for r in ranks))


# --ranks N --pipe-expert-only: FLUX-12B trained through ``train_model`` with
# configs/flux/_pipeline_train.py's ``parallel`` composed in (phase 31's
# cuts, PE_RANK_ITERS iterations, no checkpoint), the mesh over n ranks:
# (name, the mesh, moe_experts). At 1 row a data rank a stage runs M = 1
# microbatch: per rank and iteration 12 x (19 + 38 / 2) K1 and 2 x (19 +
# 38 / 2) K3, each rank running its stage's 19 single blocks and all 19
# joint blocks (19 does not divide by 2: they run replicated, as in JAX).
PE_RANK_ITERS = 2
PIPELINE_FRAGMENT = 'configs/flux/_pipeline_train.py'


def pe_rank_cases(n):
    return (('data_pipe', dict(data=-1, pipe=2), 0),
            ('pipe_expert_moe', dict(data=-1, pipe=2, expert=n // 2), 2))


def pe_train_config(mesh, moe_experts, iters, samples=1):
    """The FLUX config with phase 31's cuts, ``_pipeline_train.py``'s
    ``parallel`` composed in and its mesh updated by ``mesh`` (None: no
    ``parallel``, one card), ``moe_experts`` (capacity 1.0) on both
    denoisers."""
    cfg = mesh_train_config(FLUX_TRAIN_CONFIG, iters, 0,
                            unsharded=mesh is None, samples=samples)
    if mesh is not None:
        fragment = Config.fromfile(PIPELINE_FRAGMENT)
        cfg.merge_from_dict({'parallel': dict(fragment.parallel,
                                              _delete_=True)})
        cfg.merge_from_dict({'parallel.mesh': mesh})
    if moe_experts:
        cfg.merge_from_dict({f'model.{k}.denoising.{f}': v
                             for k in ('diffusion', 'teacher')
                             for f, v in (('moe_experts', moe_experts),
                                          ('moe_capacity_factor', 1.0))})
    return cfg


def pe_train_references(out_dir, n):
    """The one-card references of ``--pipe-expert-only``: each case's model
    on the global batch of its data ranks' rows (one row each), its first
    iteration's loss, timestep-embedder gradients and adapter before and
    after, saved for the ranks."""
    out = {}
    for name, mesh, moe in pe_rank_cases(n):
        rows = n // (mesh['pipe'] * mesh.get('expert', 1))
        cfg = pe_train_config(None, moe, 1, samples=rows)
        with joined_rows(rows), no_final_checkpoint():
            run = mesh_train_run(cfg, os.path.join(out_dir, f'ref_{name}'),
                                 SEED + 40, keep_first=True)
        before, after = run['adapters']
        torch.save(dict(loss=run['rows'][0]['loss'], grads=run['grads'],
                        before=before, after=after),
                   os.path.join(out_dir, f'pe_ref_{name}.pt'))
        out[name] = dict(loss=run['rows'][0]['loss'], rows=rows,
                         s=run['s_per_step'][0], peak_gib=run['peak_gib'])
        del run, before, after
        gc.collect()
        torch.cuda.empty_cache()
    return out


def pe_rank_main(out_dir):
    """One rank of ``--ranks N --pipe-expert-only``: FLUX-12B through
    ``train_model`` on each of ``pe_rank_cases`` from phase 31's random
    weights, against the one-card references; writes ``pe{r}.json``."""
    setup_distributed(timeout=600.0)
    rank, n = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = dict(rank=rank)
    for name, mesh, moe in pe_rank_cases(n):
        cfg = pe_train_config(mesh, moe, PE_RANK_ITERS)
        with no_final_checkpoint():
            run = mesh_train_run(cfg, os.path.join(out_dir, 'pe', name),
                                 SEED + 40, keep_first=True)
        state, model = run['state'], run['model']
        mp = state.model_parallel
        ref = torch.load(os.path.join(out_dir, f'pe_ref_{name}.pt'))
        before, after = run['adapters']
        held = [k for k in ref['before']
                if before[k].shape == ref['before'][k].shape]
        upd = torch.cat([(after[k] - before[k]).flatten() for k in held])
        ref_upd = torch.cat([(ref['after'][k] - ref['before'][k]).flatten()
                             for k in held])
        den = model.diffusion.denoising
        n_blocks = (len(den.joint_blocks) + len(den.single_blocks) // 2)
        res[name] = dict(
            mesh=dict(zip(mp.mesh.mesh_dim_names, mp.mesh.shape)),
            iters=PE_RANK_ITERS, launches=run['launches'],
            want_launches=[TRAIN_FORWARDS * n_blocks,
                           TRAIN_BACKWARDS * n_blocks, 0],
            rows=run['rows'], s_per_iter=run['s_per_iter'],
            s_per_step=run['s_per_step'], peak_gib=run['peak_gib'],
            build_peak_gib=run['build_peak_gib'], ref_loss=ref['loss'],
            loss_rel=abs(run['rows'][0]['loss'] - ref['loss'])
            / abs(ref['loss']),
            before_equal=all(torch.equal(before[k], ref['before'][k])
                             for k in held),
            held=len(held), adapter_tensors=len(ref['before']),
            grad_rel={k: rel_l2(g, ref['grads'][k])
                      for k, g in run['grads'].items()},
            update_norm=upd.norm().item(), update_rel=rel_l2(upd, ref_upd),
            resident_gib=torch.cuda.memory_allocated() / 2 ** 30)
        del ref, before, after, upd, ref_upd
        step = build_train_step(model, state.optimizers, model.train_cfg,
                                ema_config_from_cfg(cfg), mesh=mp.mesh)
        index, _ = batch_ranks(mp.mesh)
        batch = to_device(t_train.build_dataset(cfg.data.train).batch(
            np.random.default_rng([SEED, index]), 1),
            torch.device('cuda', torch.cuda.current_device()))
        wall, busy, by_name = profile_split(lambda: step(state, batch))
        families = split_families(by_name)
        res[name].update(
            profiled_wall_s=wall, device_busy_s=busy,
            families={f: ms for f, (ms, _, _) in families.items()},
            nccl=nccl_split(by_name, wall, busy, ('SendRecv', 'AllReduce',
                                                  'Broadcast')))
        del run, model, state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f'pe{rank}.json'), 'w') as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def check_pe_ranks(ranks, n, refs):
    """--pipe-expert-only read across the ranks, in ``check_sp_ranks``'
    form: the launches per iteration, every rank's losses equal to rank
    0's, and each rank's first iteration against one card's (loss and the
    timestep embedder's gradients within TRAIN_SLICE_REL_L2, the update of
    the adapter tensors it holds nonzero and within SP_UPDATE_REL_L2, the
    same start)."""
    bad = []
    for name, _, _ in pe_rank_cases(n):
        for r in ranks:
            got = r[name]
            if got['launches'] != [got['want_launches']] * got['iters']:
                bad.append((r['rank'], name, 'launches', got['launches']))
            if [x['loss'] for x in got['rows']] != [
                    x['loss'] for x in ranks[0][name]['rows']]:
                bad.append((r['rank'], name, 'loss', got['rows']))
            if not all(math.isfinite(x['loss']) for x in got['rows']):
                bad.append((r['rank'], name, 'finite', got['rows']))
            if not got['before_equal'] or not got['held']:
                bad.append((r['rank'], name, 'start', got['held']))
            if got['loss_rel'] > TRAIN_SLICE_REL_L2 or not got['grad_rel'] \
                    or max(got['grad_rel'].values()) > TRAIN_SLICE_REL_L2:
                bad.append((r['rank'], name, 'one card', got['loss_rel'],
                            got['grad_rel']))
            if not got['update_norm'] > 0 \
                    or got['update_rel'] > SP_UPDATE_REL_L2:
                bad.append((r['rank'], name, 'update', got['update_norm'],
                            got['update_rel']))
    if bad:
        raise AssertionError(f'--ranks {n} --pipe-expert-only failed: {bad}')
    for name, _, moe in pe_rank_cases(n):
        x, ref = ranks[0][name], refs[name]
        what = f' MoE (moe_experts={moe})' if moe else ''
        log(f'phase RP FLUX-12B{what} '
            f'training through train_model with {PIPELINE_FRAGMENT} on {n} '
            f'NCCL ranks ({name}: mesh {x["mesh"]}; phase 31\'s cuts, 1 row '
            f'a data rank, M = 1, {x["iters"]} iterations): ok | launches per '
            f'rank and iteration (K1, K3, K4) {x["launches"][0]} on every '
            f'rank | losses '
            + ', '.join(f'{row["loss"]:.5e}' for row in x['rows'])
            + f' on every rank | first iteration against one card '
            f'({ref["rows"]} rows, loss {ref["loss"]:.5e}, s per step '
            f'{ref["s"]:.4f}, peak {ref["peak_gib"]:.2f} GiB): loss rel '
            f'{x["loss_rel"]:.3e}, '
            f'timestep embedder gradients rel L2 '
            + ', '.join(f'{v:.3e}' for v in x['grad_rel'].values())
            + f' (bound {TRAIN_SLICE_REL_L2}), the update of the '
            f'{x["held"]} of {x["adapter_tensors"]} adapter tensors rank 0 '
            f'holds (norm {x["update_norm"]:.4e}) rel L2 '
            f'{x["update_rel"]:.3e} (bound {SP_UPDATE_REL_L2}) | rank 0 '
            f'profiled step: wall {x["profiled_wall_s"]:.4f} s, device busy '
            f'{x["device_busy_s"]:.4f} s, idle share '
            f'{1 - x["device_busy_s"] / x["profiled_wall_s"]:.4f}; by family '
            + ', '.join(f'{f} {ms:.1f} ms' for f, ms in sorted(
                x['families'].items(), key=lambda kv: -kv[1]))
            + '; NCCL ' + ', '.join(
                f'{k} {v["ms"]:.1f} ms ({100 * v["share_of_wall"]:.1f}% of '
                f'wall)' for k, v in x['nccl'].items()) + ' | '
            + ' ; '.join(
                f'rank {r["rank"]}: s per iteration '
                + ', '.join(f'{v:.4f}' for v in r[name]['s_per_iter'])
                + f', peak {r[name]["peak_gib"]:.2f} GiB training '
                f'({r[name]["build_peak_gib"]:.2f} building), resident '
                f'{r[name]["resident_gib"]:.2f} GiB'
                for r in ranks))


def main_pipe_expert(n, smi, out_dir):
    """``--ranks n --pipe-expert-only``: the one-card references, then the
    n ranks."""
    t = time.perf_counter()
    refs = pe_train_references(out_dir, n)
    spawn(pe_rank_main, n, (out_dir,), timeout=1500.0)
    wall = time.perf_counter() - t
    ranks = [json.load(open(os.path.join(out_dir, f'pe{r}.json')))
             for r in range(n)]
    shutil.rmtree(out_dir, ignore_errors=True)
    check_pe_ranks(ranks, n, refs)
    log(f'phase RP pipe and expert training on {n} NCCL ranks: ok in '
        f'{wall:.1f} s (the one-card references, builds and iterations '
        f'included)')
    print(json.dumps({'pipe_expert_train': ranks, 'references': refs}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# the tensor axis: LocalTensor(2) on one card (phases 42-42c), and
# --ranks 4 --tensor-only
# ---------------------------------------------------------------------------

TP = 2                     # the LocalTensor shards on one card
# K1 / K2 / K3 on a shard's heads: the FLUX shape at H24 / t, t = 2 and 4
TP_HEAD_SHAPES = ((1, 4608, 12, 128), (1, 4608, 6, 128))
# K5 at Qwen-Image's shard shapes at t = 2 (M 4096 image tokens): the
# column layers' N / 2 (q / k / v, MLP in) and the row layers' K / 2
# (attention out, MLP out)
TP_W4A8_SHAPES = [(4096, 3072, 1536), (4096, 3072, 6144),
                  (4096, 1536, 3072), (4096, 6144, 3072)]
# a split's images against one device's: the partial sums round in another
# place, what the ring's merges do (SP_IMAGE_REL_L2), and w8a8 / w4a8 carry
# that through their per-token re-rounding (W8A8_SLICE_REL_L2)
TP_IMAGE_REL_L2 = SP_IMAGE_REL_L2
TP_QUANT_IMAGE_REL_L2 = W8A8_SLICE_REL_L2
# a single block's row-split proj_out inside the block against the whole
# layer on the same input: its bf16 partial sums round twice (a few 1e-3);
# proj_out rows taken as one contiguous 1/t (the planted fault) are other
# weights, an error of order 1
TP_PROJ_OUT_REL_L2 = 1e-2
# a row-parallel w8a8 layer: the sound split sums fp32 partials of the same
# int8 products (a few bf16 ties apart); per-shard absmax (the planted
# fault) re-quantizes half the row, about 1.6e-2 at this input's halves
TP_W8A8_LAYER_REL_L2 = 2e-3


def tensor_kernel_case(g, shape, backward=False, valid_keys=None):
    """K1 (K2 with ``valid_keys``) or K3 on a shard's heads against its
    plain version, timed beside its bound and SDPA's."""
    q, k, v, do = (torch.randn(shape, generator=g, device='cuda',
                               dtype=torch.bfloat16) for _ in range(4))
    kv_valid = None if valid_keys is None else \
        torch.arange(shape[1], device='cuda')[None, :] < valid_keys
    if not backward:
        out = attn.flash_attention_fwd(q, k, v, kv_valid)
        torch.cuda.synchronize()
        ref = attn.attention_ref(q, k, v, kv_valid)
        torch.testing.assert_close(out.float(), ref.float(), rtol=O_TOL,
                                   atol=O_TOL)
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: attn.flash_attention_fwd(q, k, v, kv_valid), 20)
        plain_ms = cuda_ms(lambda: attn.attention_ref(q, k, v, kv_valid), 5)
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: sdpa(q, k, v, kv_valid), 20)
    else:
        o, lse = attn.flash_attention_fwd(q, k, v, kv_valid, return_lse=True)
        got = attn.flash_attention_bwd(q, k, v, o, do, lse, kv_valid)
        torch.cuda.synchronize()
        want = attn.attention_bwd_ref(q, k, v, o, do, lse, kv_valid)
        rels = [rel_l2(x, y) for x, y in zip(got, want)]
        if max(rels) > BWD_REL_L2:
            raise AssertionError(f'K3 at {shape}: rel L2 dq/dk/dv {rels} > '
                                 f'{BWD_REL_L2}')
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in zip(got, want))
        ms = cuda_ms(lambda: attn.flash_attention_bwd(q, k, v, o, do, lse,
                                                      kv_valid), 10)
        plain_ms = cuda_ms(lambda: attn.attention_bwd_ref(
            q, k, v, o, do, lse, kv_valid), 3)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves, kv_valid)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 10)
    bound_ms, bound_by = attention_bound(shape, valid_keys, backward)
    return dict(shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                valid_keys=valid_keys)


def phase_tensor_kernels():
    """Phase 42a: K1, K2 and K3 on the heads of one shard at t = 2 and 4,
    and K5 at Qwen-Image's column and row shard shapes at t = 2, each
    against its plain version, timed beside its bound (and the library
    call where there is one)."""
    g = torch.Generator(device='cuda').manual_seed(SEED + 42)
    out = dict(attention_fwd=[], attention_masked=[], attention_bwd=[],
               w4a8_matmul=[])
    for shape in TP_HEAD_SHAPES:
        out['attention_fwd'].append(tensor_kernel_case(g, shape))
        out['attention_masked'].append(tensor_kernel_case(
            g, shape, valid_keys=QWEN_VALID_KEYS))
        out['attention_bwd'].append(tensor_kernel_case(g, shape,
                                                       backward=True))
        gc.collect()
        torch.cuda.empty_cache()
    for m, k, n in TP_W4A8_SHAPES:
        xq, q, packed, scale = w4a8_case(g, m, k, n)
        err, _ = w4a8_check(xq, q, packed, scale)
        xs = 0.001 + 0.01 * torch.rand(m, 1, generator=g, device='cuda')

        def fused():     # the form the Qwen path launches (_int4_matmul)
            return qmm.w4a8_matmul(xq, packed, scale, row_scale=xs,
                                   out_dtype=torch.bfloat16)
        bound_ms, bound_by = roofline(
            2 * m * k * n,
            m * k + k * n // 2 + scale.numel() * 4 + m * 4 + m * n * 2,
            H100_INT8)
        out['w4a8_matmul'].append(dict(
            shape=[m, k, n], max_abs_err=err,
            ms=kernel_ms(fused, 'w4a8_matmul', 10),
            plain_ms=cuda_ms(lambda: qmm.w4a8_matmul_ref(
                xq, packed, scale, xs, torch.bfloat16), 3),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
    log('phase 42a kernels on tensor shards vs plain: ok | ' + ' ; '.join(
        f'{name} {"x".join(map(str, c["shape"]))}'
        f'{"" if not c.get("valid_keys") else f" ({c["valid_keys"]} keys)"}:'
        f' max|d| {c["max_abs_err"]:.3e}, kernel {c["ms"]:.4f} ms, plain '
        f'{c["plain_ms"]:.4f} ms, '
        + (f'library {c["library_ms"]:.4f} ms, ' if c['library_ms'] else '')
        + f'bound {c["bound_ms"]:.4f} ms ({c["bound_by"]}, '
        f'{100 * c["bound_ms"] / c["ms"]:.1f}% of it)'
        for name, cases in out.items() for c in cases))
    return out


def proj_out_reading(block, x, rope, temb):
    """rel L2 of a ``LocalTensor``-split single block's ``proj_out`` output
    inside one call of the block against the whole layer on the same
    fused input (its shards' parts put back in the one-device order)."""
    layer, seen = block.proj_out, {}
    split = layer.forward

    def spy(parts, generator=None):
        seen['parts'], seen['out'] = parts, split(parts, generator)
        return seen['out']
    with torch.inference_mode(), mock.patch.object(layer, 'forward', spy):
        block(x, rope, temb)
        whole = F.linear(tensor_mod.put(seen['parts'], -1,
                                        layer.tensor_split[1]),
                         layer.weight, layer.bias)
    return rel_l2(seen['out'], whole)


def contiguous_rows(segments, size, i):
    """The planted fault: shard i's rows as one contiguous 1/size of all
    rows, not its part of each segment."""
    n = sum(segments) // size
    return [(i * n, n)]


def phase_flux_local_tensor(pipe, embeds, latents, lat_single, t_single):
    """Phase 42: FLUX-12B (phase 6's model) on ``LocalTensor(TP)``: every
    block's heads, MLP and modulations split (JAX's min_size), each shard's
    attention on H / t heads through K1; the image against phase 6's, and
    the planted contiguous-rows fault in a single block's proj_out."""
    model = pipe.transformer
    block = model.single_blocks[0]
    g = torch.Generator(device='cuda').manual_seed(SEED + 43)
    x = torch.randn(1, FLUX_SHAPE[1], model.inner_dim, generator=g,
                    device='cuda', dtype=torch.bfloat16)
    temb = torch.randn(1, model.inner_dim, generator=g, device='cuda',
                       dtype=torch.bfloat16)
    ids = torch.randint(0, 64, (FLUX_SHAPE[1], 3), generator=g,
                        device='cuda')
    rope = layers.rope_frequencies(ids, model.axes_dims_rope)
    units = tensor_mod.set_tensor_parallel(model, tensor_mod.LocalTensor(TP))
    try:
        _, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
        torch.cuda.reset_peak_memory_stats()
        attn.LAUNCHES = 0                   # the main path's counted run
        out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
        launches = attn.LAUNCHES
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        lat = timed_call(pipe, embeds, latents,
                         output_type='latent')[0]['latents']
        wall, busy, _ = profile_split(
            lambda: pipe(prompt_embeds=embeds, latents=latents,
                         output_type='pt'))
        sound = proj_out_reading(block, x, rope, temb)
        with mock.patch.object(tensor_mod, 'part_ranges', contiguous_rows):
            planted = proj_out_reading(block, x, rope, temb)
    finally:
        tensor_mod.set_tensor_parallel(model, None)
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    want = 2 * n_blocks * TP
    if launches != want:
        raise AssertionError(f'{launches} K1 launches, want {want}')
    want_units = 5 * FLUX_12B['num_layers'] + 2 * FLUX_12B[
        'num_single_layers']
    if units != want_units:
        raise AssertionError(f'{units} split units, want {want_units}')
    check_image(out['images'])
    rel = rel_l2(lat, lat_single)
    if not rel <= TP_IMAGE_REL_L2:
        raise AssertionError(f'latents rel L2 {rel:.3e} against one device '
                             f'> {TP_IMAGE_REL_L2}')
    if not sound <= TP_PROJ_OUT_REL_L2 < planted:
        raise AssertionError(f'single block proj_out rel L2: sound '
                             f'{sound:.3e}, planted contiguous rows '
                             f'{planted:.3e}, bound {TP_PROJ_OUT_REL_L2}')
    log(f'phase 42 FLUX-12B under LocalTensor({TP}) (phase 6 model, {units} '
        f'units split): ok | image finite | K1 launches {launches} at H'
        f'{FLUX_12B["num_attention_heads"] // TP} | latents rel L2 against '
        f'phase 6 {rel:.3e} (bound {TP_IMAGE_REL_L2}) | single block 0 '
        f'proj_out (row split over its heads\' and hidden units\' rows) '
        f'against the whole layer rel L2 {sound:.3e}, planted contiguous '
        f'rows {planted:.3e} (bound {TP_PROJ_OUT_REL_L2}, refused) | cold run '
        f'{t_cold:.3f} s, warm per image {t_e2e:.4f} s (phase 6: '
        f'{t_single:.4f} s) | peak memory {peak_gib:.2f} GiB | profile (one '
        f'image): wall {wall:.4f} s, device busy {busy:.4f} s, idle share '
        f'{1 - busy / wall:.4f}')
    return dict(launches=launches, image_s=t_e2e, rel_l2=rel,
                proj_out_rel_l2=sound, planted_rel_l2=planted,
                idle_share=1 - busy / wall, peak_gib=peak_gib)


def phase_w8a8_local_tensor(pipe, embeds, latents):
    """Phase 42b: phase 21's w8a8 FLUX-12B on ``LocalTensor(TP)`` (the int8
    kernels split after quantizing, each shard's parts contiguous beside
    them); the image against the one-device w8a8 image, and the planted
    per-shard activation absmax in a row-parallel w8a8 layer."""
    model = pipe.transformer
    layer = model.single_blocks[0].proj_out
    segments = (model.inner_dim, model.single_blocks[0].proj_mlp.out_features)
    g = torch.Generator(device='cuda').manual_seed(SEED + 44)
    x = torch.randn(1, FLUX_SHAPE[1], sum(segments), generator=g,
                    device='cuda', dtype=torch.bfloat16)
    x[..., :segments[0]] *= 4.0          # the heads' rows louder
    int8_layers(model, act_quant=True)   # phase 21 ends weight-only
    one, t_one = timed_call(pipe, embeds, latents, output_type='latent')
    one = one['latents']
    with torch.inference_mode():
        whole = layer(x)
    units = tensor_mod.set_tensor_parallel(model, tensor_mod.LocalTensor(TP))
    try:
        parts = [tensor_mod.take(x, -1, tensor_mod.part_ranges(
            segments, TP, i)).contiguous() for i in range(TP)]
        with torch.inference_mode():
            sound = rel_l2(layer(parts), whole)
            with mock.patch.object(tensor_mod.LocalTensor, 'all_max',
                                   lambda self, xs: xs):
                planted = rel_l2(layer(parts), whole)
        timed_call(pipe, embeds, latents, output_type='pt')
        attn.LAUNCHES = i8.LAUNCHES = 0     # the main path's counted run
        out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
        launches = dict(attention=attn.LAUNCHES, int8=i8.LAUNCHES)
        lat = timed_call(pipe, embeds, latents,
                         output_type='latent')[0]['latents']
    finally:
        tensor_mod.set_tensor_parallel(model, None)
        int8_layers(model, act_quant=False)
    n_joint, n_single = FLUX_12B['num_layers'], FLUX_12B['num_single_layers']
    want = dict(attention=2 * (n_joint + n_single) * TP, int8=2 * (
        INT8_OUTSIDE_BLOCKS + TP * (INT8_PER_JOINT * n_joint
                                    + INT8_PER_SINGLE * n_single)))
    if launches != want:
        raise AssertionError(f'launches {launches}, want {want}')
    check_image(out['images'])
    rel = rel_l2(lat, one)
    if not rel <= TP_QUANT_IMAGE_REL_L2:
        raise AssertionError(f'w8a8 latents rel L2 {rel:.3e} against one '
                             f'device > {TP_QUANT_IMAGE_REL_L2}')
    if not sound <= TP_W8A8_LAYER_REL_L2 < planted:
        raise AssertionError(f'row-parallel w8a8 proj_out rel L2: sound '
                             f'{sound:.3e}, planted per-shard absmax '
                             f'{planted:.3e}, bound {TP_W8A8_LAYER_REL_L2}')
    log(f'phase 42b FLUX-12B w8a8 under LocalTensor({TP}) (phase 21 model, '
        f'{units} units split): ok | image finite | launches {launches} | '
        f'latents rel L2 against the one-device w8a8 image {rel:.3e} (bound '
        f'{TP_QUANT_IMAGE_REL_L2}) | single block 0 proj_out (row, w8a8) '
        f'rel L2 {sound:.3e}, planted per-shard absmax {planted:.3e} (bound '
        f'{TP_W8A8_LAYER_REL_L2}, refused) | warm per image {t_e2e:.4f} s '
        f'(one device {t_one:.4f} s, latents only)')
    return dict(launches=launches, image_s=t_e2e, rel_l2=rel,
                layer_rel_l2=sound, planted_rel_l2=planted)


def phase_qwen_local_tensor(qwen_run):
    """Phase 42c: Qwen-Image 20B w4a8 (phase 8's model) on
    ``LocalTensor(TP)``: K2 key-padded on H / t heads and K5 on the column
    and row shards of every block's int4 layers; the image against the
    one-device image on the same embeds."""
    pipe, latents, n_int4 = qwen_run
    model = pipe.transformer
    g = torch.Generator(device='cuda').manual_seed(SEED + 45)
    embeds = qwen_inputs(g)
    one, t_one = timed_call(pipe, embeds, latents, output_type='latent')
    one = one['latents']
    units = tensor_mod.set_tensor_parallel(model, tensor_mod.LocalTensor(TP))
    try:
        timed_call(pipe, embeds, latents, output_type='pt')
        torch.cuda.reset_peak_memory_stats()
        attn.LAUNCHES = qmm.LAUNCHES = 0    # the main path's counted run
        with w4a8_shape_tally() as by_shape:
            out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
        launches = dict(attention=attn.LAUNCHES, w4a8=qmm.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        lat = timed_call(pipe, embeds, latents,
                         output_type='latent')[0]['latents']
    finally:
        tensor_mod.set_tensor_parallel(model, None)
    n = QWEN_20B['num_layers']
    want = dict(attention=2 * n * TP,
                w4a8=2 * (INT4_OUTSIDE_BLOCKS + TP * INT4_PER_BLOCK * n))
    if launches != want or units != 5 * n:
        raise AssertionError(f'launches {launches}, units {units}, want '
                             f'{want}, {5 * n} units')
    check_image(out['images'])
    rel = rel_l2(lat, one)
    if not rel <= TP_QUANT_IMAGE_REL_L2:
        raise AssertionError(f'latents rel L2 {rel:.3e} against one device '
                             f'> {TP_QUANT_IMAGE_REL_L2}')
    shard_shapes = {s: c for s, c in by_shape.items() if s[0] == 4096}
    log(f'phase 42c Qwen-Image 20B w4a8 under LocalTensor({TP}) (phase 8 '
        f'model, {units} units split): ok | image finite | launches '
        f'{launches} (K2 at H{QWEN_20B["num_attention_heads"] // TP}) | w4a8 '
        f'launches by (M, K, N): ' + ', '.join(
            f'{s}: {c}' for s, c in sorted(by_shape.items()))
        + f' | latents rel L2 against one device {rel:.3e} (bound '
        f'{TP_QUANT_IMAGE_REL_L2}) | warm per image {t_e2e:.4f} s (one device '
        f'{t_one:.4f} s, latents only) | peak memory {peak_gib:.2f} GiB')
    return dict(launches=launches, image_s=t_e2e, rel_l2=rel,
                w4a8_by_shape={'x'.join(map(str, s)): c
                               for s, c in by_shape.items()},
                image_stream_shard_shapes=len(shard_shapes),
                peak_gib=peak_gib, n_int4=n_int4)


TP_RANK_ITERS = 2
# --tensor-only serving: (name, family, mesh, sp_mode)
TP_SERVING = (('flux_tensor4', 'flux', {'tensor': 4}, 'ulysses'),
              ('flux_sp2_tensor2_ulysses', 'flux', {'sp': 2, 'tensor': 2},
               'ulysses'),
              ('flux_sp2_tensor2_ring', 'flux', {'sp': 2, 'tensor': 2},
               'ring'),
              ('qwen_tensor4', 'qwen', {'tensor': 4}, 'ulysses'))
# --tensor-only training: (name, parallel.mesh)
TP_TRAINING = (('fsdp2_tensor2', dict(data=1, fsdp=2, tensor=2)),
               ('data2_tensor2', dict(data=2, fsdp=1, tensor=2)))


def tp_serving_launches(family, axes, mode):
    """K1 / K2, K4 and K5 launches per rank and image: every rank runs one
    shard of each split layer, its sequence shard under sp."""
    if family == 'qwen':
        n = QWEN_20B['num_layers']
        return dict(attention=2 * n, ring_hop=0,
                    w4a8=2 * (INT4_OUTSIDE_BLOCKS + INT4_PER_BLOCK * n))
    n = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    sp = axes.get('sp', 1)
    ring = mode == 'ring' and sp > 1
    return dict(attention=0 if ring else 2 * n,
                ring_hop=2 * n * sp if ring else 0, w4a8=0)


def tp_build(family):
    """FLUX-12B (phase 6's weights) or Qwen-Image 20B w4a8 (phase 8's
    build) with its inputs: (pipe, embeds, latents). The global generators
    are seeded first: ``randomize_`` redraws the weight matrices only, and
    the means head's bias comes from them, so every rank builds the same
    model."""
    torch.manual_seed(SEED)
    if family == 'flux':
        g = torch.Generator(device='cuda').manual_seed(SEED + 2)
        with torch.device('cuda'):
            model = ArcFluxTransformer2DModel(dtype=torch.bfloat16,
                                              **FLUX_12B)
            vae = PretrainedVAE(dtype=torch.bfloat16)
        randomize_(model, g)
        pipe = ArcFluxPipeline(model, vae=vae)
        embeds = flux_inputs(g)
    else:
        g = torch.Generator(device='cuda').manual_seed(SEED + 5)
        pipe, _, _ = qwen_w4a8(g, vae=True)
        embeds = qwen_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device='cuda')
    return pipe, embeds, latents


def weight_gib(module):
    """GiB of the storage of ``module``'s parameters and buffers (a part
    that shared its whole tensor's storage would count the whole)."""
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in module.state_dict().values()}.values()) / 2 ** 30


def tp_serve(name, family, axes, mode, pipe, embeds, latents, one):
    """One serving case on this rank: shard ``pipe`` over ``axes``, a cold
    then a counted image, the latents against one card's ``one``, the
    weights and memory a rank holds, and one profiled image's NCCL
    share."""
    def nbytes():
        return {n: t.numel() * t.element_size()
                for n, t in pipe.transformer.state_dict().items()}
    whole = nbytes()
    whole_gib = weight_gib(pipe.transformer)
    pipe.shard(dict(axes), sp_mode=mode)
    gc.collect()
    torch.cuda.empty_cache()
    held = nbytes()
    held_gib = weight_gib(pipe.transformer)
    # the tensors the split cut, each to 1 / t of its bytes; the rest (the
    # embedders and heads, the blocks' norms, row biases, LoRA A of a
    # column and B of a row layer) stays whole
    split = [n for n in whole if held[n] != whole[n]]
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    _, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = hop.LAUNCHES = qmm.LAUNCHES = 0  # the counted run
    out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
    launches = dict(attention=attn.LAUNCHES, ring_hop=hop.LAUNCHES,
                    w4a8=qmm.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check_image(out['images'])
    lat = timed_call(pipe, embeds, latents, output_type='latent')[0][
        'latents']
    times = [timed_call(pipe, embeds, latents, output_type='pt')[1]
             for _ in range(2)]
    wall, busy, by_name = profile_split(
        lambda: pipe(prompt_embeds=embeds, latents=latents, output_type='pt'))
    return dict(
        mesh=axes, sp_mode=mode, launches=launches,
        want_launches=tp_serving_launches(family, axes, mode),
        rel_l2=rel_l2(lat, one), latents=lat.float().cpu(),
        s_per_image=[t_e2e] + times, cold_s=t_cold, whole_gib=whole_gib,
        held_gib=held_gib, split_tensors=len(split),
        split_whole_gib=sum(whole[n] for n in split) / 2 ** 30,
        split_held_gib=sum(held[n] for n in split) / 2 ** 30,
        split_exact=all(held[n] * axes['tensor'] == whole[n]
                        for n in split),
        resident_gib=resident_gib, peak_gib=peak_gib,
        profiled_wall_s=wall, device_busy_s=busy,
        nccl=nccl_split(by_name, wall, busy, ('AllReduce', 'AllGather',
                                              'SendRecv')))


def tp_rank_main(out_dir):
    """One rank of ``--ranks N --tensor-only``: serving FLUX-12B at
    ``tensor=N`` and ``sp=2 x tensor=N/2`` (both modes) and Qwen-Image 20B
    w4a8 at ``tensor=N``, each against the one-card image this rank makes
    of the same weights first; then FLUX-12B training through
    ``train_model`` at each of ``TP_TRAINING`` against the parent's
    one-card references. Writes ``tp{r}.json`` and ``tp{r}.pt`` (the
    latents)."""
    setup_distributed(timeout=600.0)
    rank, n = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res, lats = dict(rank=rank), {}
    one = {}
    for name, family, axes, mode in TP_SERVING:
        pipe, embeds, latents = tp_build(family)
        if family not in one:
            timed_call(pipe, embeds, latents, output_type='latent')
            out, t_one = timed_call(pipe, embeds, latents,
                                    output_type='latent')
            one[family] = out['latents']
            res[f'{family}_one_card'] = dict(
                s_latents=t_one, whole_gib=weight_gib(pipe.transformer))
        res[name] = tp_serve(name, family, axes, mode, pipe, embeds, latents,
                             one[family])
        lats[name] = res[name].pop('latents')
        del pipe, embeds, latents
        gc.collect()
        torch.cuda.empty_cache()
    one.clear()
    for name, axes in TP_TRAINING:
        cfg = mesh_train_config(FLUX_TRAIN_CONFIG, TP_RANK_ITERS, 0,
                                mesh=axes)
        cfg.merge_from_dict({'parallel.tensor_axis': 'tensor'})
        with no_final_checkpoint():
            run = mesh_train_run(cfg, os.path.join(out_dir, 'tp', name),
                                 SEED + 40, keep_first=True)
        state, model = run['state'], run['model']
        mp = state.model_parallel
        ref = torch.load(os.path.join(out_dir, 'tp_ref.pt'))
        before, after = run['adapters']
        n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
        got = dict(
            mesh=dict(zip(mp.mesh.mesh_dim_names, mp.mesh.shape)),
            iters=TP_RANK_ITERS, launches=run['launches'],
            want_launches=[TRAIN_FORWARDS * n_blocks,
                           TRAIN_BACKWARDS * n_blocks, 0],
            rows=run['rows'], s_per_iter=run['s_per_iter'],
            s_per_step=run['s_per_step'], peak_gib=run['peak_gib'],
            build_peak_gib=run['build_peak_gib'], ref_loss=ref['loss'],
            loss_rel=abs(run['rows'][0]['loss'] - ref['loss'])
            / abs(ref['loss']),
            grad_rel={k: rel_l2(g, ref['grads'][k])
                      for k, g in run['grads'].items()},
            split_tensors=len(mp.splits),
            resident_gib=torch.cuda.memory_allocated() / 2 ** 30)
        if rank == 0:
            names = list(ref['before'])
            upd = torch.cat([(after[k] - before[k]).flatten()
                             for k in names])
            ref_upd = torch.cat([(ref['after'][k] - ref['before'][k])
                                 .flatten() for k in names])
            got.update(before_equal=all(torch.equal(before[k],
                                                    ref['before'][k])
                                        for k in names),
                       update_norm=upd.norm().item(),
                       update_rel=rel_l2(upd, ref_upd),
                       adapter_tensors=len(names))
            del upd, ref_upd
        del ref, before, after
        step = build_train_step(model, state.optimizers, model.train_cfg,
                                ema_config_from_cfg(cfg), mesh=mp.mesh)
        index, _ = batch_ranks(mp.mesh)
        batch = to_device(t_train.build_dataset(cfg.data.train).batch(
            np.random.default_rng([SEED, index]), 1),
            torch.device('cuda', torch.cuda.current_device()))
        wall, busy, by_name = profile_split(lambda: step(state, batch))
        got.update(profiled_wall_s=wall, device_busy_s=busy,
                   nccl=nccl_split(by_name, wall, busy))
        res[name] = got
        del run, model, state, step, batch, mp
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f'tp{rank}.json'), 'w') as f:
        json.dump(res, f)
    torch.save(lats, os.path.join(out_dir, f'tp{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def tp_train_references(out_dir):
    """--tensor-only's one-card reference: the FLUX-12B config's first
    iteration on one card on the global batch of the two batch ranks of
    both layouts (2 rows), its loss, the timestep embedder's gradients and
    the adapter before and after, saved for the ranks."""
    cfg = mesh_train_config(FLUX_TRAIN_CONFIG, 1, 0, unsharded=True,
                            samples=2)
    with joined_rows(2), no_final_checkpoint():
        run = mesh_train_run(cfg, os.path.join(out_dir, 'tp_ref'),
                             SEED + 40, keep_first=True)
    before, after = run['adapters']
    torch.save(dict(loss=run['rows'][0]['loss'], grads=run['grads'],
                    before=before, after=after),
               os.path.join(out_dir, 'tp_ref.pt'))
    out = dict(loss=run['rows'][0]['loss'], s=run['s_per_step'][0],
               peak_gib=run['peak_gib'])
    del run, before, after
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_tp_ranks(ranks, lats, n, ref):
    """--tensor-only read across the ranks: the launches, every rank's
    latents bitwise rank 0's and within the one-card bound, each rank
    holding about 1/t of the split weights; training's launches per
    iteration, every rank's losses equal to rank 0's and the first
    iteration against one card's (check_pe_ranks' bounds)."""
    bad = []
    for name, family, axes, _ in TP_SERVING:
        bound = TP_IMAGE_REL_L2 if family == 'flux' else \
            TP_QUANT_IMAGE_REL_L2
        for r, lat in zip(ranks, lats):
            got = r[name]
            if got['launches'] != got['want_launches']:
                bad.append((r['rank'], name, 'launches', got['launches']))
            if not got['rel_l2'] <= bound:
                bad.append((r['rank'], name, 'one card', got['rel_l2']))
            if not torch.equal(lat[name], lats[0][name]):
                bad.append((r['rank'], name, 'rank 0 latents'))
            whole_held = got['whole_gib'] - got['split_whole_gib'] \
                + got['split_held_gib']
            if not got['split_tensors'] or not got['split_exact'] or \
                    got['held_gib'] > 1.01 * whole_held:
                bad.append((r['rank'], name, 'held', got['split_tensors'],
                            got['held_gib'], whole_held))
    for name, _ in TP_TRAINING:
        for r in ranks:
            got = r[name]
            if got['launches'] != [got['want_launches']] * got['iters']:
                bad.append((r['rank'], name, 'launches', got['launches']))
            if [x['loss'] for x in got['rows']] != [
                    x['loss'] for x in ranks[0][name]['rows']]:
                bad.append((r['rank'], name, 'loss', got['rows']))
            if not all(math.isfinite(x['loss']) for x in got['rows']):
                bad.append((r['rank'], name, 'finite', got['rows']))
            if got['loss_rel'] > TRAIN_SLICE_REL_L2 or not got['grad_rel'] \
                    or max(got['grad_rel'].values()) > TRAIN_SLICE_REL_L2:
                bad.append((r['rank'], name, 'one card', got['loss_rel'],
                            got['grad_rel']))
        got = ranks[0][name]
        if not got['before_equal'] or not got['update_norm'] > 0 \
                or got['update_rel'] > SP_UPDATE_REL_L2:
            bad.append((0, name, 'update', got['before_equal'],
                        got['update_norm'], got['update_rel']))
    for name, family, axes, mode in TP_SERVING:
        x = ranks[0][name]
        log(f'phase RTP serving {name} on {n} NCCL ranks (mesh {axes}, '
            f'{mode}): {"FAIL" if bad else "ok"} | launches per rank and image {x["launches"]} | '
            f'latents rel L2 against one card {x["rel_l2"]:.3e} on rank 0, '
            f'every rank bitwise rank 0 | s per image (counted, then 2 '
            f'warm) ' + ', '.join(f'{s:.4f}' for s in x['s_per_image'])
            + f' against one card '
            f'{ranks[0][f"{family}_one_card"]["s_latents"]:.4f} s (latents '
            f'only) | weights held {x["held_gib"]:.2f} of '
            f'{x["whole_gib"]:.2f} GiB ({x["split_tensors"]} tensors split, '
            f'{x["split_held_gib"]:.2f} of their {x["split_whole_gib"]:.2f} '
            f'GiB) | resident {x["resident_gib"]:.2f} '
            f'GiB, peak {x["peak_gib"]:.2f} GiB | profiled image: wall '
            f'{x["profiled_wall_s"]:.4f} s, device busy '
            f'{x["device_busy_s"]:.4f} s; NCCL ' + ', '.join(
                f'{k} {v["ms"]:.1f} ms ({100 * v["share_of_wall"]:.1f}% of '
                f'wall)' for k, v in x['nccl'].items()))
    for name, axes in TP_TRAINING:
        x = ranks[0][name]
        log(f'phase RTP FLUX-12B training through train_model on {n} NCCL '
            f'ranks ({name}: mesh {x["mesh"]}, tensor_axis tensor, '
            f'{x["split_tensors"]} adapter and trunk tensors split; phase '
            f'31\'s cuts, 1 row a batch rank, {x["iters"]} iterations): '
            f'{"FAIL" if bad else "ok"} | '
            f'launches per rank and iteration (K1, K3, K4) '
            f'{x["launches"][0]} | losses ' + ', '.join(
                f'{row["loss"]:.5e}' for row in x['rows'])
            + f' on every rank | first iteration against one card (2 rows, '
            f'loss {ref["loss"]:.5e}, s per step {ref["s"]:.4f}, peak '
            f'{ref["peak_gib"]:.2f} GiB): loss rel {x["loss_rel"]:.3e}, '
            f'timestep embedder gradients rel L2 ' + ', '.join(
                f'{v:.3e}' for v in x['grad_rel'].values())
            + f' (bound {TRAIN_SLICE_REL_L2}), the update of the '
            f'{x["adapter_tensors"]} adapter tensors (norm '
            f'{x["update_norm"]:.4e}) rel L2 {x["update_rel"]:.3e} (bound '
            f'{SP_UPDATE_REL_L2}) | rank 0 profiled step: wall '
            f'{x["profiled_wall_s"]:.4f} s, device busy '
            f'{x["device_busy_s"]:.4f} s; NCCL ' + ', '.join(
                f'{k} {v["ms"]:.1f} ms ({100 * v["share_of_wall"]:.1f}% of '
                f'wall)' for k, v in x['nccl'].items()) + ' | ' + ' ; '.join(
                f'rank {r["rank"]}: s per iteration ' + ', '.join(
                    f'{v:.4f}' for v in r[name]['s_per_iter'])
                + f', peak {r[name]["peak_gib"]:.2f} GiB training '
                f'({r[name]["build_peak_gib"]:.2f} building), resident '
                f'{r[name]["resident_gib"]:.2f} GiB' for r in ranks))
    if bad:
        raise AssertionError(f'--ranks {n} --tensor-only failed: {bad}')


def main_tensor(n, smi, out_dir):
    """``--ranks n --tensor-only``: the one-card training reference, then
    the n ranks."""
    t = time.perf_counter()
    ref = tp_train_references(out_dir)
    spawn(tp_rank_main, n, (out_dir,), timeout=1500.0)
    wall = time.perf_counter() - t
    ranks = [json.load(open(os.path.join(out_dir, f'tp{r}.json')))
             for r in range(n)]
    lats = [torch.load(os.path.join(out_dir, f'tp{r}.pt'))
            for r in range(n)]
    shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps({'tensor': ranks, 'reference': ref}))
    check_tp_ranks(ranks, lats, n, ref)
    log(f'phase RTP the tensor axis on {n} NCCL ranks: ok in {wall:.1f} s '
        f'(the one-card references, builds, images and iterations '
        f'included)')
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def k7_bound(b, s, h, valid_keys=None):
    """Roofline of K7 at (B, S, H, 128) over ``valid_keys`` keys (all by
    default): QK^T, 2 S Sk D H operations at the int8 peak, plus P.V as
    many at the bf16 peak, against reading the int8 q, the valid keys' int8
    k rows, the fp32 row scales and bf16 v rows, and writing bf16 o."""
    d = 128
    kv = s if valid_keys is None else valid_keys
    half = 2 * b * h * s * kv * d
    ms_ops = (half / H100_INT8 + half / H100_BF16) * 1e3
    nbytes = (b * h * (s + kv) * (d + 4) + b * kv * h * d * 2
              + b * s * h * d * 2 + (0 if valid_keys is None else b * s))
    ms_bytes = nbytes / H100_BYTES * 1e3
    return (ms_ops, 'operations') if ms_ops >= ms_bytes else \
        (ms_bytes, 'bytes')


def k4_bound(b, sq, skv, h, valid_keys=None, first=False, last=False):
    """Roofline of one ring hop as the port's kernel does it: QK^T and PV,
    4 Sq Skv D H FLOP over the valid keys, reading q and the valid keys'
    rows of k and v (bf16) and the key mask, reading the fp32 carry (acc,
    m, l) unless ``first``, writing it, and writing O (bf16) when
    ``last``."""
    d = 128
    kv = skv if valid_keys is None else valid_keys
    carry = b * sq * h * d * 4 + 2 * b * h * sq * 4
    nbytes = (b * sq * h * d * 2 + 2 * b * kv * h * d * 2 + carry
              + (0 if first else carry) + (b * sq * h * d * 2 if last else 0)
              + (0 if valid_keys is None else b * skv))
    return roofline(4 * b * h * sq * kv * d, nbytes, H100_BF16)


def k6_bound(g, n, m, n_steps):
    """Roofline of one inverse-CDF launch, counted as the TPU kernel's cost
    estimate counts it (inverse_cdf.py:134-137: 12 fp32 operations and 2
    transcendentals per step, target and component), plus the output
    written: the largest of fp32 operations over the fp32 peak,
    transcendentals over the special-function rate and bytes over the
    memory rate. Returns (ms, 'operations' or 'bytes', which)."""
    times = {'fp32 operations': n_steps * n * g * m * 12 / H100_FP32,
             'special functions': n_steps * n * g * m * 2 / H100_SFU,
             'bytes': ((3 * g + 2 * n + 1) * m + n * m) * 4 / H100_BYTES}
    which = max(times, key=times.get)
    return (times[which] * 1e3, 'bytes' if which == 'bytes'
            else 'operations', which)


def k6_case(g, hw, k=KR_K, n=1, saturate=False):
    """A random 1-D mixture in the KR transport's per-axis layout: means
    and log-weights (1, 1, k, H, W), logstd (1, 1, 1, 1, 1), targets
    erf(z / sqrt 2) (1, 1, n, H, W) and the isotropic-proxy initial samples
    of ``gm1d_inverse_cdf``; with ``saturate`` some targets at and next to
    +-1."""
    kw = dict(generator=g, device='cuda')
    means = torch.randn(1, 1, k, *hw, **kw)
    lw = torch.log_softmax(torch.randn(1, 1, k, *hw, **kw), dim=2)
    logstds = torch.full((1, 1, 1, 1, 1), KR_LOGSTD, device='cuda')
    z = torch.randn(1, 1, n, *hw, **kw)
    tgt = torch.erf(z / math.sqrt(2))
    if saturate:
        tgt[0, 0, 0, 0, :8] = 1.0
        tgt[0, 0, 1, 0, :8] = -1.0
        tgt[0, 0, 2, 0, :8] = 1 - 1e-7
    wt = lw.exp()
    mean = (wt * means).sum(2, keepdim=True)
    var = (wt * (means - mean).square()).sum(2, keepdim=True) \
        + math.exp(2 * KR_LOGSTD)
    return means, lw, wt, logstds, tgt, z * var.sqrt() + mean


def k6_check(name, args):
    """Kernel vs plain at one problem: raises past the root tolerance, on a
    non-finite output or on two runs that differ; returns the max abs error
    over unsaturated elements."""
    out = icdf.gm1d_inverse_cdf_kernel(*args, n_steps=KR_STEPS)
    again = icdf.gm1d_inverse_cdf_kernel(*args, n_steps=KR_STEPS)
    torch.cuda.synchronize()
    ref = icdf.gm1d_inverse_cdf_ref(*args, n_steps=KR_STEPS)
    if not torch.isfinite(out).all():
        raise AssertionError(f'K6 {name}: non-finite output')
    if not torch.equal(out, again):
        raise AssertionError(f'K6 {name}: two runs differ')
    means, lw, _, logstds, tgt, _ = args
    pdf, _ = gm_ops.gm1d_pdf_cdf(dict(means=means, logstds=logstds,
                                      logweights=lw), ref)
    uns = tgt.abs() < 0.999
    err = (out - ref).abs()
    bad = (err > K6_ATOL + K6_CDF_TOL / (2 * pdf)) & uns
    if bad.any():
        raise AssertionError(f'K6 {name}: {int(bad.sum())} unsaturated '
                             f'elements past the root tolerance, max err '
                             f'{err[uns].max().item():.3e}')
    return err[uns].max().item()


def phase_k6_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 11)
    cases = [('kr_axis', dict(hw=KR_LATENT[:2])),
             ('large', dict(hw=K6_LARGE_HW)),
             ('ragged', dict(hw=(37, 53))),
             ('n5_g1', dict(hw=(40, 40), k=1, n=5)),
             ('saturated', dict(hw=(64, 64), n=3, saturate=True))]
    worst, parts, timed = 0.0, [], {}
    for name, kw in cases:
        args = k6_case(g, **kw)
        err = k6_check(name, args)
        worst = max(worst, err)
        geom = icdf.kernel_geometry(*args)
        k, n = args[0].shape[2], args[4].shape[2]
        m = math.prod(args[0].shape[-2:])
        lanes = icdf.lanes_for(k, geom['elements'])
        parts.append(f'{name} G{k} N{n} M{m} L{lanes} max|d| {err:.3e}')
        if name in ('kr_axis', 'large'):
            ms = kernel_ms(lambda: icdf.launch(geom, KR_STEPS, 1e-6, 1.5),
                           'gm_inverse_cdf', 50)
            wrapper_ms = cuda_ms(lambda: icdf.gm1d_inverse_cdf_kernel(
                *args, n_steps=KR_STEPS), 20)
            rows, _ = icdf.kernel_layout(*args)
            plain_ms = cuda_ms(lambda: icdf.nr_steps_ref(
                *rows, KR_STEPS, 1e-6, 1.5), 5)
            bound_ms, bound_by, which = k6_bound(KR_K, 1, m, KR_STEPS)
            per_lane = -(-k // lanes)
            timed[name] = dict(shape=dict(G=KR_K, N=1, M=m,
                                          n_steps=KR_STEPS),
                               lanes=lanes, ms=ms, wrapper_ms=wrapper_ms,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, bound_detail=which,
                               ptxas=ptxas_usage(
                                   f'gm_inverse_cdf_kernelILi{lanes}ELi'
                                   f'{1 << (per_lane - 1).bit_length()}E'))
            if name == 'kr_axis':           # every lane count the launcher
                timed[name]['ms_by_lanes'] = {     # can choose
                    str(n_lanes): kernel_ms(lambda: icdf.launch(
                        geom, KR_STEPS, 1e-6, 1.5, lanes=n_lanes),
                        'gm_inverse_cdf', 50)
                    for n_lanes in (1, 2, 4, 8, 16)}
    log(f'phase 12 inverse-CDF kernel vs plain: ok | {" ; ".join(parts)} '
        f'(bound {K6_ATOL} + {K6_CDF_TOL} / 2 pdf, unsaturated), finite, '
        f'deterministic | ' + ' ; '.join(
            f'{name} M{t["shape"]["M"]} L{t["lanes"]}: kernel {t["ms"]:.4f} '
            f'ms device time (the call with its wrapper {t["wrapper_ms"]:.4f}'
            f' ms), plain fp32 {t["plain_ms"]:.4f} ms, bound '
            f'{t["bound_ms"]:.4f} ms ({t["bound_detail"]}, '
            f'{100 * t["bound_ms"] / t["ms"]:.1f}% of it), ptxas '
            f'{t["ptxas"]}' for name, t in timed.items())
        + ' | kr_axis device ms by lanes: ' + ', '.join(
            f'L{n_lanes} {ms:.4f}' for n_lanes, ms in
            timed['kr_axis']['ms_by_lanes'].items()))
    return worst, timed


def kr_mixture(g):
    """A random mixture of the ArcFlux head geometry: means (1, K, 128,
    128, 16), log-weights (1, K, 128, 128, 1), one scalar logstd; and one
    standard normal draw z (1, 1, 128, 128, 16)."""
    kw = dict(generator=g, device='cuda')
    h, w, c = KR_LATENT
    gm = dict(means=torch.randn(1, KR_K, h, w, c, **kw),
              logstds=torch.full((1, 1, 1, 1, 1), KR_LOGSTD, device='cuda'),
              logweights=torch.log_softmax(
                  torch.randn(1, KR_K, h, w, 1, **kw), dim=1))
    return gm, torch.randn(1, 1, h, w, c, **kw)


def timed_kr(gm, z):
    torch.cuda.synchronize()
    t = time.perf_counter()
    x = gm_ops.gaussian_samples_to_gm_samples(gm, z, n_steps=KR_STEPS,
                                              backward_steps=0)
    torch.cuda.synchronize()
    return x, time.perf_counter() - t


def phase_kr():
    g = torch.Generator(device='cuda').manual_seed(SEED + 12)
    gm, z = kr_mixture(g)
    c = KR_LATENT[-1]
    _, t_cold = timed_kr(gm, z)
    icdf.LAUNCHES = 0                       # the main path's counted run
    x, t_warm = timed_kr(gm, z)
    launches = icdf.LAUNCHES
    if launches != c:
        raise AssertionError(f'{launches} inverse-CDF launches, want {c}')
    with mock.patch.object(icdf, 'gm1d_inverse_cdf_kernel',
                           icdf.gm1d_inverse_cdf_ref):
        x_plain, t_plain = timed_kr(gm, z)
    if not torch.isfinite(x).all():
        raise AssertionError('non-finite KR samples')
    uns = (torch.erf(z / math.sqrt(2)).abs() < 0.999).all(-1, keepdim=True)
    rel = rel_l2(x * uns, x_plain * uns)
    if rel > KR_REL_L2:
        raise AssertionError(f'KR kernel vs plain rel L2 {rel:.3e} > '
                             f'{KR_REL_L2}')
    z_rec = gm_ops.gm_samples_to_gaussian_samples(gm, x)
    rt = ((z_rec - z).abs() * uns).max().item()
    if not rt <= KR_ROUND_TRIP:
        raise AssertionError(f'round trip max |z_rec - z| {rt:.3e} > '
                             f'{KR_ROUND_TRIP}')
    log(f'phase 13 KR transport (K={KR_K} over a {KR_LATENT} latent, 1 '
        f'draw, {KR_STEPS} NR steps): ok | samples {tuple(x.shape)} finite | '
        f'kernel launches {launches} | rel L2 vs the plain path '
        f'{rel:.3e} (bound {KR_REL_L2}) over the {uns.float().mean().item():.4f} '
        f'of pixels with every axis unsaturated | round trip max |z_rec - '
        f'z| {rt:.3e} (bound {KR_ROUND_TRIP}) | seconds per call: cold '
        f'{t_cold:.4f}, warm {t_warm:.4f}, plain path {t_plain:.4f}')
    return dict(launches=launches, s=t_warm, plain_s=t_plain, rel_l2=rel,
                round_trip=rt)


def phase_gmflow():
    torch.manual_seed(SEED + 13)
    model = Diffusion2D(train_cfg=CKB_TRAIN_CFG, test_cfg=CKB_TEST_CFG,
                        device='cuda', **CKB_MODEL)
    trainable, frozen = model.init_params()
    optimizers = build_optimizers(CKB_OPT, trainable)
    state = TrainState.create(
        torch.Generator(device='cuda').manual_seed(SEED + 14), trainable,
        frozen, optimizers, ema_keys=model.ema_keys)
    step = build_train_step(model, optimizers, model.train_cfg,
                            EmaConfig.from_hook_cfg(CKB_EMA_HOOK))
    data = CheckerboardData(n_rc=4, scale=1.0)
    rng = np.random.default_rng(SEED)
    losses = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(CKB_STEPS):
        x = torch.from_numpy(data.batch(rng, CKB_BATCH)['x']).to('cuda')
        state, logs = step(state, dict(x=x))
        losses.append(logs['loss'])
    losses = torch.stack(losses).cpu()
    t_step = (time.perf_counter() - t) / CKB_STEPS
    if not torch.isfinite(losses).all():
        raise AssertionError('non-finite GMFlow losses')
    first, last = losses[:100].mean().item(), losses[-100:].mean().item()
    if not last < first:
        raise AssertionError(f'GMFlow loss did not fall: first 100 {first}, '
                             f'last 100 {last}')
    noise = torch.randn(CKB_SAMPLES, *CKB_MODEL['data_shape'],
                        generator=torch.Generator(device='cuda').manual_seed(
                            SEED + 15), device='cuda')
    ema = state.ema['diffusion']
    torch.cuda.synchronize()
    t = time.perf_counter()
    samples = model.val_step(dict(noise=noise), None, ema=ema)
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t
    again = model.val_step(dict(noise=noise), None, ema=ema)
    if not torch.isfinite(samples).all():
        raise AssertionError('non-finite GMFlow samples')
    if not torch.equal(samples, again):
        raise AssertionError('GMFlow samples differ on a repeat')
    support = data.log_prob_support(samples.reshape(-1, 2).cpu().numpy())
    log(f'phase 14 GMFlow checkerboard (ToyGMFlowDenoiser K=8, hidden '
        f'256 x 3, GMFlowNLLLoss, AdamW 1e-3, Karras EMA from 100, batch '
        f'{CKB_BATCH}): ok | {CKB_STEPS} steps, loss mean of the first 100 '
        f'{first:.4f}, last 100 {last:.4f} | {t_step * 1e3:.3f} ms per step '
        f'| val_step (EMA, FlowEulerODE 16 steps, order 2, 2 substeps, '
        f'mean): {CKB_SAMPLES} samples finite, equal on a repeat, '
        f'{t_sample:.4f} s per call, in-support share {support.mean():.4f} '
        f'(not gated)')
    return dict(s_per_step=t_step, s_per_sample_call=t_sample,
                support=float(support.mean()))


def toy_cli(path, opts, work_dir):
    """``python -m arcflow_tpu_torch.train path`` with ``opts`` on the card
    (the CLI's default device), in a subprocess: (its config, its output,
    seconds, the mean s/iter of its last log line)."""
    opts = dict(opts)
    args = [f'{k}={v!r}'.replace(' ', '') for k, v in opts.items()]
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-m', 'arcflow_tpu_torch.train', path,
         '--work-dir', work_dir, '--cfg-options', *args],
        capture_output=True, text=True, timeout=TOY_CLI_TIMEOUT)
    wall = time.perf_counter() - t
    out = res.stdout + res.stderr
    if res.returncode != 0:
        raise AssertionError(f'{path}: the CLI exited {res.returncode}:\n'
                             f'{out[-3000:]}')
    if not re.search(r'INFO device: cuda', out):
        raise AssertionError(f'{path}: the CLI did not train on the card:\n'
                             f'{out[-3000:]}')
    times = re.findall(r'iter \[\d+/\d+\] time: ([0-9.e+-]+)s', out)
    if not times:
        raise AssertionError(f'{path}: no iteration log:\n{out[-3000:]}')
    cfg = Config.fromfile(path)
    cfg.merge_from_dict(opts)
    return cfg, out, wall, float(times[-1])


def toy_support(cfg, work_dir, n, seed, **kwargs):
    """In-support share of ``n`` samples of the CLI run's last checkpoint,
    with its EMA weights, from a model built from the same config on the
    card."""
    model = build_model_from_cfg(cfg, device='cuda')
    raw = load_raw_checkpoint(os.path.join(work_dir, 'checkpoints',
                                           cfg.name))
    ema = {k: t.to('cuda') for k, t in raw['ema']['diffusion'].items()}
    samples = model.val_step(
        dict(num_samples=n), torch.Generator(device='cuda').manual_seed(seed),
        ema=ema, **kwargs)
    samples = samples.float().cpu().numpy()
    if samples.shape != (n, 2) or not np.isfinite(samples).all():
        raise AssertionError(f'{cfg.name}: samples {samples.shape}, finite '
                             f'{np.isfinite(samples).all()}')
    share = CheckerboardData(n_rc=cfg.data.train.n_rc).log_prob_support(
        samples).mean()
    return raw['step'], float(share)


def phase_toy_cli():
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix='toy-', dir=_build.BUILD_DIR)
    try:
        wd_flow, wd_distill = (os.path.join(work, n)
                               for n in ('flow', 'distill'))
        flow_cfg, _, flow_wall, flow_s = toy_cli(*TOY_FLOW, wd_flow)
        flow_step, flow_share = toy_support(
            flow_cfg, wd_flow, 2048, SEED + 23,
            test_cfg_override=dict(num_timesteps=32))
        teacher = {'model.teacher_ckpt': os.path.join(
            wd_flow, 'checkpoints', flow_cfg.name)}
        # the MoE student through the CLI in a thread of its own, beside
        # the dense one (both launch-bound)
        wd_moe, moe_run = os.path.join(work, 'moe'), {}

        def moe_cli():
            try:
                moe_run['out'] = toy_cli(TOY_MOE[0], dict(TOY_MOE[1],
                                                          **teacher), wd_moe)
            except BaseException as e:       # re-raised below
                moe_run['error'] = e
        moe_thread = threading.Thread(target=moe_cli)
        moe_thread.start()
        path, opts = TOY_DISTILL
        distill_cfg, _, distill_wall, distill_s = toy_cli(
            path, dict(opts, **teacher), wd_distill)
        distill_step, distill_share = toy_support(distill_cfg, wd_distill,
                                                  1024, SEED + 24)
        moe_thread.join()
        if 'error' in moe_run:
            raise moe_run['error']
        moe_cfg, _, moe_wall, moe_s = moe_run['out']
        with own_rng():     # its model's init: the later phases' weights
            moe_step, moe_share = toy_support(moe_cfg, wd_moe, 1024,
                                              SEED + 24)
        router = load_raw_checkpoint(os.path.join(
            wd_moe, 'checkpoints', moe_cfg.name))['ema']['diffusion'][
                'moe.router'].norm(dim=0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if moe_step != moe_cfg.total_iters or not (
            moe_share > TOY_MOE_SUPPORT
            and abs(moe_share - distill_share) < TOY_MOE_MARGIN
            and bool((router > TOY_MOE_ROUTER_NORM).all())):
        raise AssertionError(f'MoE toy: last checkpoint at {moe_step}, '
                             f'in-support {moe_share:.4f} (want > '
                             f'{TOY_MOE_SUPPORT}, within {TOY_MOE_MARGIN} '
                             f'of the dense {distill_share:.4f}), router '
                             f'column norms {router.tolist()}')
    if flow_step != flow_cfg.total_iters or \
            distill_step != distill_cfg.total_iters:
        raise AssertionError(f'last checkpoints at {flow_step}, '
                             f'{distill_step}')
    if not (flow_share > TOY_FLOW_SUPPORT
            and distill_share > TOY_DISTILL_SUPPORT):
        raise AssertionError(f'in-support shares {flow_share:.4f} (want > '
                             f'{TOY_FLOW_SUPPORT}), {distill_share:.4f} '
                             f'(want > {TOY_DISTILL_SUPPORT})')
    log(f'phase 23 toy stack through python -m arcflow_tpu_torch.train on '
        f'the card (hidden 128 x 2, 2 x 2 board; alongside phase 37\'s '
        f'validate_toy_e2e in a process of its own): ok | {TOY_FLOW[0]}: '
        f'{flow_cfg.total_iters} iterations at batch 512, {flow_s:.5f} s per '
        f'iteration (last log interval), {flow_wall:.1f} s of command, '
        f'in-support share {flow_share:.4f} of 2048 samples (EMA, 32 Euler '
        f'steps; gate > {TOY_FLOW_SUPPORT}) | {TOY_DISTILL[0]} with that '
        f'teacher: {distill_cfg.total_iters} iterations at batch 256, '
        f'{distill_s:.5f} s per iteration, {distill_wall:.1f} s of command, '
        f'2-NFE in-support share {distill_share:.4f} of 1024 samples (gate > '
        f'{TOY_DISTILL_SUPPORT}) | {TOY_MOE[0]} from the same teacher, '
        f'beside it: {moe_cfg.total_iters} iterations, {moe_s:.5f} s per '
        f'iteration, {moe_wall:.1f} s of command, in-support share '
        f'{moe_share:.4f} (gate > {TOY_MOE_SUPPORT} and within '
        f'{TOY_MOE_MARGIN} of the dense student), router column norms '
        + ', '.join(f'{v:.4f}' for v in router.tolist())
        + f' (gate > {TOY_MOE_ROUTER_NORM})')
    return dict(flow_s_per_iter=flow_s, flow_support=flow_share,
                distill_s_per_iter=distill_s, distill_support=distill_share,
                moe_s_per_iter=moe_s, moe_support=moe_share)


KERNEL_COUNTERS = ((attn, 'LAUNCHES'), (attn, 'BWD_LAUNCHES'),
                   (qmm, 'LAUNCHES'), (i8, 'LAUNCHES'), (hop, 'LAUNCHES'),
                   (icdf, 'LAUNCHES'), (fi8, 'LAUNCHES'),
                   (fi8, 'QUANT_LAUNCHES'))


def kernel_counts():
    return [getattr(m, n) for m, n in KERNEL_COUNTERS]


def imagenet_config(path, **opts):
    cfg = Config.fromfile(os.path.join(REPO, path))
    cfg.merge_from_dict(opts)
    return cfg


def write_imagenet_latents(root, n, shape, labels, seed):
    """``n`` seeded records in the latent cacher's format: ``x`` (C, H, W)
    and ``y``, one ``.npz`` each; returns the latents (N, H, W, C)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    out = []
    for i in range(n):
        x, y = labels(rng, i)
        np.savez(os.path.join(root, f'{i:05d}.npz'),
                 x=x.transpose(2, 0, 1), y=y)
        out.append(x)
    return np.stack(out)


def imagenet_train(cfg, work_dir):
    """``train_model`` on ``cfg`` on the card with ``IterTimerHook(sync)``:
    the state and model, s per iteration, the model's build seconds (the
    teacher's checkpoint and the graft included), the graft's seconds and
    the peak memory."""
    timings, managers, builds, grafts = Timings(), [], [], []
    build_real = t_train.build_model_from_cfg
    graft_real = LatentDiffusionClassImage._graft_student_from_teacher

    def synced(fn, out, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(*args, **kwargs)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
        return res
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mesh_train_hooks([timings, IterTimerHook(interval=1, sync=True)],
                          managers), \
            mock.patch.object(t_train, 'build_model_from_cfg',
                              lambda *a, **k: synced(build_real, builds, *a,
                                                     **k)), \
            mock.patch.object(LatentDiffusionClassImage,
                              '_graft_student_from_teacher',
                              lambda self: synced(graft_real, grafts, self)):
        state, model = t_train.train_model(cfg, work_dir=work_dir,
                                           resume=False, device='cuda')
    torch.cuda.synchronize()
    return dict(state=state, model=model,
                s_per_iter=[r['time_iter'] for r in timings.rows],
                build_s=builds[0], graft_s=grafts[0] if grafts else None,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def timed_samples(model, labels, ema, seed, **kwargs):
    """(latents on the host, samples per second) of one synced
    ``val_step`` for ``labels``."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = model.val_step(dict(label=labels), g, ema=ema, **kwargs)
    torch.cuda.synchronize()
    lat = out['pred_latents'].float().cpu().numpy()
    if lat.shape != (len(labels), *model.latent_shape) or \
            not np.isfinite(lat).all():
        raise AssertionError(f'samples {lat.shape}, finite '
                             f'{np.isfinite(lat).all()}')
    return lat, len(labels) / (time.perf_counter() - t)


def imagenet_card_vs_cpu():
    """The small ArcFlow UNet (tests/test_e2e_imagenet.py's widths, K=4)
    and two UniPC steps on the card against the same on the CPU: (worst
    relative L2 of the UNet outputs, max abs of the steps)."""
    g = torch.Generator().manual_seed(SEED + 32)
    kw = dict(in_channels=4, num_gaussians=4, data_shape=E2E_LAT, **E2E_UNET)
    cpu = ArcDenoisingUnetMod(**kw, device='cpu')
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    card = ArcDenoisingUnetMod(**kw, device='cuda')
    card.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.randn(8, *E2E_LAT, generator=g)
    t = torch.rand(8, generator=g) * 1000
    y = torch.randint(0, E2E_CLASSES + 1, (8,), generator=g)
    with torch.no_grad():
        want = cpu(x, t, label=y)
        got = card(x.cuda(), t.cuda(), label=y.cuda())
    unet_err = max(rel_l2(got[k].cpu(), want[k]) for k in want)
    sched = FlowUniPCScheduler()
    sigmas = sched.set_timesteps(2)
    outs = [torch.randn(8, *E2E_LAT, generator=g) for _ in range(2)]
    res = []
    for dev in ('cpu', 'cuda'):
        xd = x.to(dev)
        state = sched.init_state(xd)
        for out, s0, s1 in zip(outs, sigmas[:-1], sigmas[1:]):
            xd, state = sched.step_with_state(out.to(dev), xd, s0, s1, state)
        res.append(xd.cpu())
    step_err = (res[1] - res[0]).abs().max().item()
    if not (unet_err < IMAGENET_CARD_REL_L2 and
            step_err < IMAGENET_STEP_ATOL):
        raise AssertionError(f'card against CPU: UNet rel L2 {unet_err:.3e} '
                             f'(limit {IMAGENET_CARD_REL_L2}), UniPC steps '
                             f'max abs {step_err:.3e} (limit '
                             f'{IMAGENET_STEP_ATOL})')
    return unet_err, step_err


def unet_forward_gflop(cfg):
    """GFLOP of one sample's forward of ``cfg``'s student denoiser
    (``FlopCounterMode`` on the meta device: convolutions, products and
    attention, 2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    den = MODULES.build(cfg.model.diffusion.denoising, default_args=dict(
        device='meta', data_shape=IMAGENET_LATENT))
    x = torch.zeros(1, *IMAGENET_LATENT, device='meta')
    with FlopCounterMode(display=False) as fc:
        den(x, torch.zeros(1, device='meta'),
            label=torch.zeros(1, dtype=torch.long, device='meta'))
    return fc.get_total_flops() / 1e9


def phase_imagenet_full():
    """Both configs/imagenet files as shipped on the card: the flow
    teacher, then the 2-NFE distillation reading the flow run's checkpoint
    where the config says (work_dirs/imagenet256_flow/checkpoints/...,
    relative to a scratch directory the phase works in), then sampling
    through ``init_model``, the latent FDs and the card against the CPU."""
    counts = kernel_counts()
    work = tempfile.mkdtemp(prefix='imagenet-', dir=_build.BUILD_DIR)
    cwd = os.getcwd()
    try:
        os.chdir(work)
        ref = write_imagenet_latents(
            'latents', IMAGENET_FILES, IMAGENET_LATENT,
            lambda rng, i: (rng.standard_normal(IMAGENET_LATENT).astype(
                np.float32), int(rng.integers(0, 1000))), SEED + 32)
        runs, models = {}, {}
        for key, path, iters in (('flow', IMAGENET_FLOW, IMAGENET_ITERS[0]),
                                 ('distill', IMAGENET_DISTILL,
                                  IMAGENET_ITERS[1])):
            cfg = imagenet_config(path, **{
                'data.train.latents_dir': os.path.join(work, 'latents'),
                'total_iters': iters, 'checkpoint_config.interval': iters,
                'log_config.interval': iters})
            run = imagenet_train(cfg, cfg.work_dir)
            n = count_params(run['model'].init_params()[0])
            run.update(cfg=cfg, params=n, gflop=unet_forward_gflop(cfg))
            runs[key] = run
            del run['model'], run['state']
            gc.collect()
            torch.cuda.empty_cache()
        if (runs['flow']['params'], runs['distill']['params']) != \
                IMAGENET_PARAMS:
            raise AssertionError(f'parameters {runs["flow"]["params"]:,}, '
                                 f'{runs["distill"]["params"]:,}; want '
                                 f'{IMAGENET_PARAMS}')
        labels = np.random.default_rng(SEED + 33).integers(
            0, 1000, IMAGENET_SAMPLES)
        for key, run in runs.items():
            cfg = run['cfg']
            ckpt = os.path.join(cfg.work_dir, 'checkpoints', cfg.name)
            models[key], state = init_model(cfg, ckpt, device='cuda')
            if state.ema is not None or state.step != cfg.total_iters:
                raise AssertionError(f'{key}: init_model kept the EMA slot '
                                     f'or restored step {state.step}')
        student, teacher = models['distill'], models['flow']
        try:
            student.val_step(dict(label=labels), None, guidance_scale=1.5)
            raise AssertionError('the ArcFlow student sampled with CFG')
        except ValueError:
            pass
        timed_samples(student, labels, None, SEED)          # warm-up
        timed_samples(teacher, labels[:8], None, SEED,
                      test_cfg_override=dict(num_timesteps=2))
        sets = {'student 2-NFE': timed_samples(student, labels, None, 1),
                'teacher FlowEulerODE 50': timed_samples(teacher, labels,
                                                         None, 2),
                'teacher FlowEulerODE 50 CFG 1.5': timed_samples(
                    teacher, labels, None, 3, guidance_scale=1.5)}
        for i, name in enumerate(IMAGENET_SOLVERS):
            sets[f'teacher {name} {IMAGENET_SOLVER_STEPS}'] = timed_samples(
                teacher, labels, None, 4 + i, test_cfg_override=dict(
                    sampler=name, num_timesteps=IMAGENET_SOLVER_STEPS))
        fds = {k: latent_frechet_distance(lat, ref)
               for k, (lat, _) in sets.items()}
        del student, teacher, models
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    unet_err, step_err = imagenet_card_vs_cpu()
    if kernel_counts() != counts:
        raise AssertionError('the ImageNet path launched a hand-written '
                             'kernel')
    flow, distill = runs['flow'], runs['distill']
    # fp32 rates: the flow iteration's forward and backward (3 forwards'
    # worth at batch 64), the teacher's 50 Euler steps (64 forwards each)
    flow_tflops = 3 * 64 * flow['gflop'] / statistics.median(
        flow['s_per_iter'][1:]) / 1e3
    euler_tflops = 50 * 64 * flow['gflop'] * sets[
        'teacher FlowEulerODE 50'][1] / IMAGENET_SAMPLES / 1e3

    def warm(run):
        w = run['s_per_iter'][1:]
        return f'{min(w):.4f}-{max(w):.4f}'
    log(f'phase 32 ImageNet class-conditional path at full width '
        f'({smi_line()}; fp32, TF32 off; no hand-written kernel, none '
        f'launched) | cuts: data {IMAGENET_FILES} synthetic '
        f'{"x".join(map(str, IMAGENET_LATENT))} .npz '
        f'latents (seed {SEED + 32}, labels over 1000 classes), '
        f'{IMAGENET_ITERS[0]} + {IMAGENET_ITERS[1]} iterations, a checkpoint '
        f'at the last | {IMAGENET_FLOW}: DenoisingUnetMod '
        f'{flow["params"]:,} parameters, {flow["gflop"]:.3f} GFLOP per '
        f'sample forward (FlopCounterMode), batch 64, built in '
        f'{flow["build_s"]:.3f} s, warm s per iteration {warm(flow)} '
        f'(first {flow["s_per_iter"][0]:.3f}; {flow_tflops:.1f} TFLOP/s of '
        f'the 67 fp32 peak), peak {flow["peak_gib"]:.2f} GiB | '
        f'{IMAGENET_DISTILL} (teacher from the flow checkpoint at the shipped teacher_ckpt, EMA; CFG 1.5, nfe 2, '
        f'4 states, 128 substeps): ArcDenoisingUnetMod {distill["params"]:,} '
        f'parameters, batch 32, built in {distill["build_s"]:.3f} s (graft '
        f'{distill["graft_s"]:.4f} s), warm s per iteration {warm(distill)} '
        f'(first {distill["s_per_iter"][0]:.3f}), peak '
        f'{distill["peak_gib"]:.2f} GiB | init_model (EMA) samples of '
        f'{IMAGENET_SAMPLES} labels, samples/s and latent FD against the '
        f'{IMAGENET_FILES} latents: '
        + '; '.join(f'{k} {v[1]:.1f}/s FD {fds[k]:.4f}'
                    for k, v in sets.items())
        + f' (the 50 Euler steps at {euler_tflops:.1f} TFLOP/s)'
        + f' | student with CFG refused by name | card vs CPU (small '
        f'UNet, K=4): UNet rel L2 {unet_err:.3e} (limit '
        f'{IMAGENET_CARD_REL_L2}), 2 UniPC steps max abs {step_err:.3e} '
        f'(limit {IMAGENET_STEP_ATOL})')
    return dict(flow=dict({k: flow[k] for k in
                           ('params', 'gflop', 'build_s', 's_per_iter',
                            'peak_gib')}, tflops=flow_tflops),
                euler_tflops=euler_tflops,
                distill=dict((k, distill[k]) for k in
                             ('params', 'build_s', 'graft_s', 's_per_iter',
                              'peak_gib')),
                samples_per_s={k: v[1] for k, v in sets.items()}, fd=fds,
                card_vs_cpu=dict(unet_rel_l2=unet_err, step_max_abs=step_err))


def e2e_class_recovery(model, state, mus, max_rel_err, **kwargs):
    """tests/test_e2e_imagenet.py's bar: per-class means of 128 EMA
    samples within ``max_rel_err`` of the true means, each nearest its
    own. Returns (relative errors, ok)."""
    labels = np.arange(E2E_CLASSES).repeat(128 // E2E_CLASSES)
    out = model.val_step(dict(label=labels),
                         torch.Generator(device='cuda').manual_seed(9),
                         ema=state.ema['diffusion'], **kwargs)
    lat = out['pred_latents'].float().cpu().numpy()
    means = np.stack([lat[labels == y].mean(0) for y in range(E2E_CLASSES)])
    flat = means.reshape(E2E_CLASSES, -1)
    rel = np.linalg.norm(flat - mus.reshape(E2E_CLASSES, -1), axis=1) / \
        np.linalg.norm(mus.reshape(E2E_CLASSES, -1), axis=1)
    d = np.linalg.norm(flat[:, None] - mus.reshape(1, E2E_CLASSES, -1),
                       axis=-1)
    nearest = bool((d.argmin(axis=1) == np.arange(E2E_CLASSES)).all())
    return rel, nearest and bool(rel.max() < max_rel_err)


def main_imagenet():
    """Phases 32-33 alone (``chip_smoke.py --imagenet``, the child process
    of ``phase_imagenet``)."""
    if not torch.cuda.is_available():
        raise SystemExit('FAIL imagenet: torch.cuda.is_available() is false')
    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_imagenet_full()
    gc.collect()
    torch.cuda.empty_cache()
    phase_imagenet_quality()
    return 0


def start_imagenet():
    """Phases 32-33 in a process of their own, started after every phase of
    this process that reads the profiler and run beside phases 28r, 29 and
    30 (their times are taken beside it): run before phase 15, in this
    process or in a child, they left
    phase 15's profiler windows with no kernel record of flash SDPA (0 of
    50 in each of six), as large traces thin them
    (``profiler_drop_probe.py``). ``finish_imagenet`` collects them."""
    return start_child('--imagenet', 'imagenet-')


def finish_imagenet(child):
    """Wait for phases 32-33 and print their lines; fails unless the child
    exits 0."""
    finish_child(child, 'phases 32-33', ('phase 3',), IMAGENET_TIMEOUT)


def rounded(values, digits=4):
    return [round(float(v), digits) for v in values]


def phase_imagenet_quality():
    """tests/test_e2e_imagenet.py's recipe on the card at its own size and
    iteration counts, with its bars."""
    counts = kernel_counts()
    mus = np.random.default_rng(1234).standard_normal(
        (E2E_CLASSES, *E2E_LAT)).astype(np.float32) * 1.5
    work = tempfile.mkdtemp(prefix='imagenet-e2e-', dir=_build.BUILD_DIR)
    try:
        def e2e_latent(rng, i):
            y = i % E2E_CLASSES
            return mus[y] + 0.25 * rng.standard_normal(E2E_LAT).astype(
                np.float32), y
        write_imagenet_latents(os.path.join(work, 'latents'),
                               E2E_CLASSES * 192, E2E_LAT, e2e_latent, 0)
        data = {'data.train.latents_dir': os.path.join(work, 'latents')}
        flow_cfg = imagenet_config(IMAGENET_FLOW, **E2E_TINY, **data, **{
            'total_iters': E2E_FLOW_ITERS,
            'checkpoint_config.interval': E2E_FLOW_ITERS})
        t = time.perf_counter()
        state, model = t_train.train_model(
            flow_cfg, work_dir=os.path.join(work, 'flow'), seed=0,
            device='cuda')
        flow_s = time.perf_counter() - t
        teacher_rel, teacher_ok = e2e_class_recovery(
            model, state, mus, E2E_TEACHER_REL,
            test_cfg_override=dict(num_timesteps=32))
        del state, model
        distill_cfg = imagenet_config(IMAGENET_DISTILL, **E2E_TINY,
                                      **E2E_DISTILL, **data, **{
            'model.teacher_ckpt': os.path.join(work, 'flow', 'checkpoints',
                                               'imagenet256_flow'),
            'total_iters': E2E_DISTILL_ITERS,
            'checkpoint_config.interval': E2E_DISTILL_ITERS})
        t = time.perf_counter()
        state, model = t_train.train_model(
            distill_cfg, work_dir=os.path.join(work, 'distill'), seed=0,
            device='cuda')
        distill_s = time.perf_counter() - t
        student_rel, student_ok = e2e_class_recovery(model, state, mus,
                                                     E2E_STUDENT_REL)
        steps = (int(state.step), )
        del state, model
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if kernel_counts() != counts:
        raise AssertionError('the ImageNet path launched a hand-written '
                             'kernel')
    line = (f'tests/test_e2e_imagenet.py on the card ({E2E_CLASSES} '
            f'classes, 8x8x4, its _tiny_overrides): flow '
            f'{E2E_FLOW_ITERS} iterations in {flow_s:.1f} s '
            f'({flow_s / E2E_FLOW_ITERS * 1e3:.2f} ms each), 32-step teacher '
            f'per-class relative errors {rounded(teacher_rel)} '
            f'(bar {E2E_TEACHER_REL}) | distillation (K=4, 2 states, '
            f'guidance 1.0) {E2E_DISTILL_ITERS} iterations in '
            f'{distill_s:.1f} s ({distill_s / E2E_DISTILL_ITERS * 1e3:.2f} ms '
            f'each), 2-NFE student {rounded(student_rel)} (bar '
            f'{E2E_STUDENT_REL})')
    if not (teacher_ok and student_ok and steps == (E2E_DISTILL_ITERS,)):
        raise AssertionError(f'phase 33 failed its bars: {line}')
    log(f'phase 33 ImageNet quality bar: ok | {line}')
    return dict(flow_s=flow_s, distill_s=distill_s,
                teacher_rel=teacher_rel.tolist(),
                student_rel=student_rel.tolist())


def hop_case(g, b, s, h, lengths=None):
    """A random bf16 K/V block (B, s, H, 128) and its key validity (None, or
    the first ``lengths[i]`` keys of row i valid)."""
    k, v = (torch.randn(b, s, h, 128, generator=g, device='cuda',
                        dtype=torch.bfloat16) for _ in range(2))
    valid = None
    if lengths is not None:
        valid = torch.arange(s, device='cuda')[None, :] < torch.tensor(
            lengths, device='cuda')[:, None]
    return k, v, valid


def hop_chain(fn, q, blocks):
    """The hops of ``blocks`` from the first to the last through ``fn``
    (``ring_hop`` or ``ring_hop_ref``): the final carry and O."""
    carry = None
    for i, (k, v, valid) in enumerate(blocks):
        carry, out = fn(q, k, v, valid, carry, last=i == len(blocks) - 1)
    return carry, out


def k4_readings(got, want):
    """max |d| of ``got`` against the fp32 plain version ``want``, how far
    the worst element lies past K4_ATOL + K4_RTOL |want| (> 0: refused), and
    the relative L2."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    over = (d - K4_ATOL - K4_RTOL * want.abs()).max().item()
    return d.max().item(), over, rel_l2(got, want)


def k4_close(name, got, want):
    """Raises unless ``got`` is within both K4 limits of ``want``; returns
    (max |d|, relative L2)."""
    err, over, rel = k4_readings(got, want)
    if over > 0 or not rel <= K4_REL_L2:
        raise AssertionError(f'{name}: max|d| {err:.3e} ({over:+.2e} past '
                             f'{K4_ATOL} + {K4_RTOL:.4g} |ref|), rel L2 '
                             f'{rel:.3e} (bound {K4_REL_L2})')
    return err, rel


def normalized(carry):
    """acc / l of a carry, 0 on the rows that have seen no valid key."""
    acc, _, l = carry
    l_t = l.transpose(1, 2)[..., None]
    return torch.where(l_t > 0, acc / l_t, 0.0)


def carry_errors(name, carry, ref):
    """Kernel carry vs plain carry: raises unless the rows that have seen
    no valid key agree exactly (l = 0, m = -inf), the log-sum-exp m + log l
    is within ``LSE_TOL`` and the normalized acc / l within the K4 limits;
    returns (max |d(acc / l)|, its relative L2, max |d(m + log l)|)."""
    (_, m, l), (_, m_r, l_r) = carry, ref
    seen = l_r > 0
    if not (torch.equal(seen, l > 0) and torch.isneginf(m[~seen]).all()):
        raise AssertionError(f'K4 {name}: rows without a valid key differ')
    lse_err = ((m + l.log()) - (m_r + l_r.log()))[seen].abs().max().item()
    if lse_err > LSE_TOL:
        raise AssertionError(f'K4 {name} carry: max|d(m + log l)| '
                             f'{lse_err:.3e} (bound {LSE_TOL})')
    return (*k4_close(f'K4 {name} acc / l', normalized(carry),
                      normalized(ref)), lse_err)


def fold_without_acc_rescale(q, k, v, kv_valid=None, carry=None, last=False):
    """Planted fault: the plain fold with the carried acc not rescaled by
    exp(m_old - m_new) on entry (l still is)."""
    new, _ = hop.ring_hop_ref(q, k, v, kv_valid, carry)
    acc, m, l = new
    if carry is not None:
        keep = torch.where(carry[2] > 0, torch.exp(carry[1] - m), 0.0)
        acc = acc + carry[0] * (1 - keep).transpose(1, 2)[..., None]
    out = normalized((acc, m, l)).to(q.dtype) if last else None
    return (acc, m, l), out


def planted_k4_faults(q, blocks, out_r):
    """Three faults a hop could make, on the chain of ``blocks``: each must
    break both K4 limits on O against the sound plain O ``out_r``. Returns
    their readings."""
    k, v, valid = blocks[0]
    swap = torch.cat([torch.arange(8, 16), torch.arange(8)]).to(v.device)
    v_bad = v.clone()
    v_bad[:, :16] = v[:, swap]
    faults = {
        'hop 2 of 4 dropped': (hop.ring_hop, blocks[:1] + blocks[2:]),
        'V key rows 0-7 and 8-15 swapped in the first tile':
            (hop.ring_hop, [(k, v_bad, valid)] + blocks[1:]),
        'carried acc not rescaled (plain fold)':
            (fold_without_acc_rescale, blocks)}
    parts = []
    for name, (fn, chain) in faults.items():
        err, over, rel = k4_readings(hop_chain(fn, q, chain)[1], out_r)
        if not (over > 0 and rel > K4_REL_L2):
            raise AssertionError(f'K4 planted fault "{name}" passes a K4 '
                                 f'limit: max|dO| {err:.3e} ({over:+.2e}), '
                                 f'rel L2 {rel:.3e}')
        parts.append(f'{name}: max|dO| {err:.3e}, rel L2 {rel:.3e}')
    return parts


def phase_k4_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 16)
    b, s, h, _ = FLUX_SHAPE
    sq = s // SP
    cases = [('unmasked', (1, sq, h), [None]),
             ('padded', (2, sq, h), [(1000, sq)]),
             ('padded_block', (2, sq, h), [(0, sq), (700, 0)]),
             ('ragged', (2, 193, h), [(150, 193)]),
             ('chain4', (1, sq, h), [None, (1000,), (0,), None])]
    worst, parts = 0.0, []
    for name, (bb, ss, hh), lengths in cases:
        q = torch.randn(bb, ss, hh, 128, generator=g, device='cuda',
                        dtype=torch.bfloat16)
        blocks = [hop_case(g, bb, ss, hh, ln) for ln in lengths]
        before = hop.LAUNCHES
        carry, out = hop_chain(hop.ring_hop, q, blocks)
        again = hop_chain(hop.ring_hop, q, blocks)
        torch.cuda.synchronize()
        if hop.LAUNCHES != before + 2 * len(blocks):
            raise AssertionError(f'K4 {name}: {hop.LAUNCHES - before} '
                                 f'launches, want {2 * len(blocks)}')
        if not (torch.equal(out, again[1])
                and all(map(torch.equal, carry, again[0]))):
            raise AssertionError(f'K4 {name}: two runs differ')
        ref, out_r = hop_chain(hop.ring_hop_ref, q, blocks)
        acc_err, acc_rel, lse_err = carry_errors(name, carry, ref)
        err, rel = k4_close(f'K4 {name} O', out, out_r)
        worst = max(worst, err)
        parts.append(f'{name} B{bb} S{ss} H{hh} x{len(blocks)} hops max|dO| '
                     f'{err:.3e} rel L2 {rel:.3e}, max|d(acc/l)| '
                     f'{acc_err:.3e} rel L2 {acc_rel:.3e}, max|d(m + log '
                     f'l)| {lse_err:.3e}')
    faults = planted_k4_faults(q, blocks, out_r)     # on the chain4 case
    # one middle hop of the FLUX ring: the carry read and written, no O
    q = torch.randn(1, sq, h, 128, generator=g, device='cuda',
                    dtype=torch.bfloat16)
    k, v, _ = hop_case(g, 1, sq, h)
    carry, _ = hop.ring_hop(q, k, v)
    carry_r, _ = hop.ring_hop_ref(q, k, v)
    # device time by the profiler: a hop is short enough for the host's
    # launch cost to show through CUDA events around it (call_ms)
    ms = kernel_ms(lambda: hop.ring_hop(q, k, v, None, carry), 'ring_hop',
                   50)
    call_ms = cuda_ms(lambda: hop.ring_hop(q, k, v, None, carry), 50)
    plain_ms = cuda_ms(lambda: hop.ring_hop_ref(q, k, v, None, carry_r), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    with torch.inference_mode():
        library_ms = kernel_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt), 'flash', 50)
    bound_ms, bound_by = k4_bound(1, sq, sq, h)
    log(f'phase 15 ring-hop kernel vs plain: ok | {" ; ".join(parts)} '
        f'(limits on O and acc / l: |d| <= {K4_ATOL} + {K4_RTOL:.4g} |ref|, '
        f'rel L2 {K4_REL_L2}; m + log l {LSE_TOL}), keyless rows exact, two '
        f'runs bitwise equal | planted faults refused by both limits: '
        f'{" ; ".join(faults)} | one middle hop at B1 Sq {sq} Skv {sq} H{h} '
        f'D128: kernel {ms:.4f} ms of device time (a call by CUDA events '
        f'{call_ms:.4f} ms), plain fp32 {plain_ms:.4f} ms, flash SDPA (O + '
        f'LSE) {library_ms:.4f} ms of device time, bound {bound_ms:.4f} ms '
        f'({bound_by}, {100 * bound_ms / ms:.1f}% of it) | ptxas: '
        f'{ptxas_usage("ring_hop_kernel")}')
    return worst, dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, shape=[1, sq, sq, h, 128])


@contextlib.contextmanager
def lost_rotation():
    """Planted fault: the first rotation of every ring call hands each
    shard its own block again, so it folds that block twice and never sees
    the one ``size - 1`` shards back."""
    real, calls = ring_mod._rotation, itertools.count()

    def stale(ring, blocks):
        if next(calls) % (ring.size - 1) == 0:
            return lambda: blocks
        return real(ring, blocks)
    with mock.patch.object(ring_mod, '_rotation', stale):
        yield


def max_diff(a, b):
    return (a.float() - b.float()).abs().max().item()


def phase_ring_vs_k1():
    g = torch.Generator(device='cuda').manual_seed(SEED + 17)
    q, k, v = (torch.randn(FLUX_SHAPE, generator=g, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    s = FLUX_SHAPE[1]
    masked = torch.arange(s, device='cuda')[None, :] < QWEN_VALID_KEYS
    ring = LocalRing(SP)
    parts = []
    for name, kv_valid in (('unmasked', None), ('masked', masked)):
        before = hop.LAUNCHES
        out, lse = ring_attention(q, k, v, kv_valid, ring, return_lse=True)
        torch.cuda.synchronize()
        if hop.LAUNCHES != before + SP * SP:
            raise AssertionError(f'{name}: {hop.LAUNCHES - before} hop '
                                 f'launches, want {SP * SP}')
        ref, ref_lse = attn.attention_ref(q, k, v, kv_valid, return_lse=True)
        err, rel = k4_close(f'ring {name} O', out, ref)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=LSE_TOL)
        k1 = attn.flash_attention_fwd(q, k, v, kv_valid)
        ring_ms = cuda_ms(lambda: ring_attention(q, k, v, kv_valid, ring), 10)
        k1_ms = cuda_ms(lambda: attn.flash_attention_fwd(q, k, v, kv_valid),
                        10)
        parts.append(
            f'{name}: max|dO| {err:.3e} rel L2 {rel:.3e} max|dLSE| '
            f'{max_diff(lse, ref_lse):.3e} against the plain version, '
            f'max|ring - K1| {max_diff(out, k1):.3e}; ring {ring_ms:.4f} ms '
            f'({SP * SP} hops), K1 {k1_ms:.4f} ms')
    with lost_rotation():
        lost = ring_attention(q, k, v, masked, ring)
    err, over, rel = k4_readings(lost, ref)
    if not (over > 0 and rel > K4_REL_L2):
        raise AssertionError(f'a ring with a lost rotation passes a K4 '
                             f'limit: max|dO| {err:.3e} ({over:+.2e}), rel '
                             f'L2 {rel:.3e}')
    log(f'phase 16 ring attention (LocalRing({SP})) vs the attention kernel '
        f'at B1 S{s} H24 D128: ok | {" ; ".join(parts)} | limits on O: |d| '
        f'<= {K4_ATOL} + {K4_RTOL:.4g} |ref|, rel L2 {K4_REL_L2}; LSE '
        f'{LSE_TOL} | planted lost rotation (masked) refused by both: '
        f'max|dO| {err:.3e}, rel L2 {rel:.3e}')


def counted_forward(model, x, kw):
    """``means`` of one forward and its (ring-hop, attention) launches."""
    before = (hop.LAUNCHES, attn.LAUNCHES)
    with torch.inference_mode():
        means = model(x, **kw)['means'].float()
    torch.cuda.synchronize()
    return means, (hop.LAUNCHES - before[0], attn.LAUNCHES - before[1])


def local_ring_slice(name, model, x, kw, n_blocks, bound, size=SP):
    """One forward on the attention kernel, one on ``LocalRing(size)``;
    raises past ``bound`` (relative L2 of ``means``) or on wrong counts."""
    k1, n_k1 = counted_forward(model, x, kw)
    set_sequence_parallel(model, LocalRing(size))
    try:
        ring, n_ring = counted_forward(model, x, kw)
    finally:
        set_sequence_parallel(model, None)
    if n_k1 != (0, n_blocks) or n_ring != (size * size * n_blocks, 0):
        raise AssertionError(f'{name}: launches (hop, attention) {n_k1} on '
                             f'the kernel and {n_ring} on the ring')
    if not torch.isfinite(ring).all():
        raise AssertionError(f'{name}: non-finite means')
    rel = rel_l2(ring, k1)
    if rel > bound:
        raise AssertionError(f'{name}: means rel L2 {rel:.3e} > {bound}')
    return f'{name}: rel L2 ring vs K1 {rel:.3e} (bound {bound}), ' \
        f'{n_ring[0]} hop launches'


def phase_local_ring_slices():
    g = torch.Generator(device='cuda').manual_seed(SEED + 18)
    cfg = dict(FLUX_12B, num_layers=1, num_single_layers=1)
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **cfg)
    randomize_(model, g)
    x = torch.randn(1, 128, 128, 16, generator=g, device='cuda')
    kw = dict(flux_inputs(g), t=torch.full((1,), 0.7, device='cuda'),
              guidance=torch.full((1,), 3.5, device='cuda'))
    flux = local_ring_slice('FLUX 1+1 blocks bf16', model, x, kw, 2,
                            SLICE_REL_L2)
    # sp = 3 divides neither the 512 text nor the 4096 image tokens: both
    # streams are padded and every hop is masked
    padded = local_ring_slice('FLUX 1+1 blocks bf16 on LocalRing(3), both '
                              'streams padded', model, x, kw, 2,
                              SLICE_REL_L2, size=3)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    pipe, _, _ = qwen_w4a8(g, num_layers=1)
    kw = dict(qwen_inputs(g), t=torch.full((1,), 0.7, device='cuda'))
    qwen = local_ring_slice('Qwen 1 block w4a8', pipe.transformer, x, kw, 1,
                            QWEN_SLICE_REL_L2)
    log(f'phase 17 reduced slices under LocalRing({SP}) (full width): ok | '
        f'{flux} ; {padded} ; {qwen}')


def hop_host_ms(fn):
    """One call of ``fn`` with the ring-hop wrapper and its C entry point
    (TMA maps encoded, kernel launched) timed on the host clock around each
    call: (hop calls, wrapper ms per hop, entry point ms per hop). The
    kernels run asynchronously, so this is what the host spends to issue a
    hop, not the hop's device time."""
    lib = _build.load_library()
    real_hop, real_entry = ring_mod.ring_hop, lib.arcflow_ring_hop
    spent = dict(wrapper=0.0, entry=0.0, calls=0)

    def timed_hop(*args, **kw):
        t = time.perf_counter()
        try:
            return real_hop(*args, **kw)
        finally:
            spent['wrapper'] += time.perf_counter() - t
            spent['calls'] += 1

    def timed_entry(*args):
        t = time.perf_counter()
        try:
            return real_entry(*args)
        finally:
            spent['entry'] += time.perf_counter() - t
    with mock.patch.object(ring_mod, 'ring_hop', timed_hop), \
            mock.patch.object(lib, 'arcflow_ring_hop', timed_entry):
        fn()
    n = spent['calls']
    return n, 1e3 * spent['wrapper'] / n, 1e3 * spent['entry'] / n


def phase_full_local_ring(pipe, embeds, latents, lat_single, t_single):
    set_sequence_parallel(pipe.transformer, LocalRing(SP))
    try:
        _, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
        torch.cuda.reset_peak_memory_stats()
        hop.LAUNCHES = attn.LAUNCHES = 0    # the main path's counted run
        out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
        launches = dict(ring_hop=hop.LAUNCHES, attention=attn.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        lat = timed_call(pipe, embeds, latents,
                         output_type='latent')[0]['latents']
        n_host, host_ms, entry_ms = hop_host_ms(
            lambda: timed_call(pipe, embeds, latents, output_type='pt'))
        wall, busy, by_name = profile_split(
            lambda: pipe(prompt_embeds=embeds, latents=latents,
                         output_type='pt'))
        with lost_rotation():
            lost = pipe(prompt_embeds=embeds, latents=latents,
                        output_type='latent')['latents']
    finally:
        set_sequence_parallel(pipe.transformer, None)
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    want = dict(ring_hop=2 * n_blocks * SP * SP, attention=0)
    if launches != want:
        raise AssertionError(f'launches {launches}, want {want}')
    check_image(out['images'])
    rel = rel_l2(lat, lat_single)
    if not rel <= SP_IMAGE_REL_L2:
        raise AssertionError(f'latents rel L2 {rel:.3e} against one device '
                             f'> {SP_IMAGE_REL_L2}')
    hop_dev, hop_calls = (sum(v[i] for name, v in by_name.items()
                              if 'ring_hop' in name) for i in (0, 1))
    rel_lost = rel_l2(lost, lat_single)
    if not rel_lost > SP_IMAGE_REL_L2:
        raise AssertionError(f'a lost rotation passes: latents rel L2 '
                             f'{rel_lost:.3e} <= {SP_IMAGE_REL_L2}')
    log(f'phase 18 FLUX full slice under LocalRing({SP}) (phase 6 model): ok '
        f'| image finite | launches {launches} | latents rel L2 against '
        f'phase 6 {rel:.3e} (bound {SP_IMAGE_REL_L2}; planted lost rotation '
        f'{rel_lost:.3e}, refused) | cold run {t_cold:.3f} s, warm per image '
        f'{t_e2e:.4f} s (phase 6: {t_single:.4f} s) | peak memory '
        f'{peak_gib:.2f} GiB | host per hop (one image, {n_host} hops, host '
        f'clock around each call): wrapper {host_ms:.4f} ms, of it the C '
        f'entry point (TMA maps, launch) {entry_ms:.4f} ms; {n_host} x '
        f'wrapper = {n_host * host_ms / 1e3:.4f} s | profile (one image): '
        f'wall {wall:.4f} s, device busy {busy:.4f} s, idle share '
        f'{1 - busy / wall:.4f}, ring_hop device {hop_dev:.2f} ms x'
        f'{hop_calls}')
    return launches['ring_hop'], dict(
        host_ms_per_hop=host_ms, entry_ms_per_hop=entry_ms,
        idle_share=1 - busy / wall, image_s=t_e2e)


def int8_case(g, m, k, n):
    """Random int8 activations (M, K) and an int8 kernel (K, N) stored as
    the layers store it: column-major, the bytes of (N, K)."""
    xq = torch.randint(-127, 128, (m, k), generator=g, device='cuda',
                       dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device='cuda',
                      dtype=torch.int8).t()
    return xq, w


def int_mm_takes(m):
    """Whether ``torch._int_mm`` itself takes an M-row product (the limit
    the wrapper's zero rows are for), or its error message."""
    xq, w = int8_case(torch.Generator(device='cuda'), m, 64, 64)
    try:
        torch._int_mm(xq, w)
        return 'takes it'
    except RuntimeError as e:
        return f'refuses it ({str(e).splitlines()[0][:80]})'


def phase_int8_vs_plain():
    g = torch.Generator(device='cuda').manual_seed(SEED + 20)
    for m, k, n in INT8_SHAPES:
        xq, w = int8_case(g, m, k, n)
        out = i8.int8_matmul(xq, w)
        torch.cuda.synchronize()
        if not torch.equal(out, i8.int8_matmul_ref(xq, w)):
            raise AssertionError(f'int8 product at ({m}, {k}, {n}) is not '
                                 f'exact')
    timed = []
    for m, k, n in INT8_TIMED:
        xq, w = int8_case(g, m, k, n)
        ms = cuda_ms(lambda: i8.int8_matmul(xq, w), 20)
        plain_ms = cuda_ms(lambda: i8.int8_matmul_ref(xq, w), 3)
        bound_ms, bound_by = roofline(2 * m * k * n, m * k + k * n + m * n * 4,
                                      H100_INT8)
        timed.append(dict(shape=[m, k, n], ms=ms, plain_ms=plain_ms,
                          tops=2 * m * k * n / (ms * 1e-3) / 1e12,
                          bound_ms=bound_ms, bound_by=bound_by))
    limits = {m: int_mm_takes(m) for m in (1, 16, 17)}
    log(f'phase 19 int8 product (torch._int_mm) vs plain: ok | '
        f'{len(INT8_SHAPES)} FLUX-12B layer shapes bitwise exact (M 4096, '
        f'512, 4608 and 1, the last zero-padded to {i8.MIN_ROWS} rows) | '
        f'torch._int_mm alone at M=1 {limits[1]}, M=16 {limits[16]}, M=17 '
        f'{limits[17]} | ' + ' ; '.join(
            f'M{t["shape"][0]} K{t["shape"][1]} N{t["shape"][2]}: '
            f'{t["ms"]:.4f} ms ({t["tops"]:.1f} TOP/s), plain fp64 '
            f'{t["plain_ms"]:.4f} ms, bound {t["bound_ms"]:.4f} ms '
            f'({t["bound_by"]}, {100 * t["bound_ms"] / t["ms"]:.1f}% of it)'
            for t in timed))
    return timed


def int8_layers(model, act_quant):
    """The int8 layers of ``model``, each set to ``act_quant``."""
    found = [m for m in model.modules()
             if isinstance(m, LoRADense) and m.is_int8]
    for m in found:
        m.act_quant = act_quant
    return len(found)


def phase_w8a8_reduced():
    g = torch.Generator(device='cuda').manual_seed(SEED + 21)
    cfg = dict(FLUX_12B, num_layers=1, num_single_layers=1)
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **cfg)
    randomize_(model, g)
    x = torch.randn(1, 128, 128, 16, generator=g, device='cuda')
    kw = dict(flux_inputs(g), t=torch.full((1,), 0.7, device='cuda'),
              guidance=torch.full((1,), 3.5, device='cuda'))
    want_layers = INT8_OUTSIDE_BLOCKS + INT8_PER_JOINT + INT8_PER_SINGLE
    with torch.inference_mode():
        bf16 = model(x, **kw)['means'].float()
        n_int8 = ArcFluxPipeline(model).quantize_int8(act_quant=True)
        before = (attn.LAUNCHES, i8.LAUNCHES)
        fast = model(x, **kw)['means'].float()
        torch.cuda.synchronize()
        launches = (attn.LAUNCHES - before[0], i8.LAUNCHES - before[1])

        def plain(q, k, v, kv_valid=None, return_lse=False):
            return attn.attention_ref(q, k, v, kv_valid, return_lse)

        with mock.patch.object(i8, 'int8_matmul', i8.int8_matmul_ref):
            plain_product = model(x, **kw)['means'].float()
            with mock.patch.object(attn, 'flash_attention_fwd', plain):
                slow = model(x, **kw)['means'].float()
        int8_layers(model, act_quant=False)
        weight_only = model(x, **kw)['means'].float()
        torch.cuda.synchronize()
    if n_int8 != want_layers or launches != (2, want_layers):
        raise AssertionError(f'{n_int8} int8 layers (want {want_layers}), '
                             f'launches (attention, int8) {launches}')
    if not all(torch.isfinite(t).all() for t in (fast, slow, weight_only)):
        raise AssertionError('non-finite means')
    if not torch.equal(fast, plain_product):
        raise AssertionError('the plain int8 product changes the means')
    rel = rel_l2(fast, slow)
    if rel > W8A8_SLICE_REL_L2:
        raise AssertionError(f'means rel L2 {rel:.3e} > {W8A8_SLICE_REL_L2}')
    quant_rel, wo_rel = rel_l2(fast, bf16), rel_l2(weight_only, bf16)
    log(f'phase 20 FLUX reduced slice (1+1 blocks, full width) w8a8: ok | '
        f'{n_int8} int8 layers | means with the plain int8 product bitwise '
        f'equal | means rel L2 card vs plain attention and plain int8 '
        f'product {rel:.3e} (bound {W8A8_SLICE_REL_L2}) | launches '
        f'(attention, int8) {launches} | quantization against bf16: w8a8 '
        f'{quant_rel:.3e}, weight-only int8 {wo_rel:.3e}')
    return quant_rel


def int8_image(pipe, embeds, latents, lat_bf16, want):
    """A cold then a counted warm image of the quantized ``pipe`` (counts
    set to 0 just before), checked against ``want`` launches; then the
    latents alone and a decode. Returns the numbers of one mode."""
    attn.LAUNCHES = i8.LAUNCHES = 0
    first, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = i8.LAUNCHES = 0        # the main path's counted run
    out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
    launches = dict(attention=attn.LAUNCHES, int8=i8.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != want:
        raise AssertionError(f'launches {launches}, want {want}')
    img = out['images']
    check_image(img)
    rerun = (first['images'] - img).abs().max().item()
    if rerun != 0.0:
        raise AssertionError(f'two runs differ by {rerun:.3e}')
    lat, t_dit = timed_call(pipe, embeds, latents, output_type='latent')
    lat = lat['latents']
    rel = rel_l2(lat, lat_bf16)
    if not rel <= INT8_IMAGE_REL_L2:
        raise AssertionError(f'latents rel L2 against bf16 {rel:.3e} > '
                             f'{INT8_IMAGE_REL_L2}')
    return dict(launches=launches, cold_s=t_cold, warm_s=t_e2e, dit_s=t_dit,
                decode_s=timed_decode(pipe.vae, lat), peak_gib=peak_gib,
                rel_l2=rel, range=(img.min().item(), img.max().item()))


def captured_attention(pipe, embeds, latents, calls):
    """q, k, v of the attention calls numbered ``calls`` (in order) of the
    first DiT call of one image, copied by a spy on ``layers.attention``."""
    seen, kept = itertools.count(), []

    def spy(q, k, v, mask=None, sp=None):
        if next(seen) in calls:
            kept.append(tuple(t.clone() for t in (q, k, v)))
        return attention(q, k, v, mask=mask, sp=sp)
    attention = layers.attention
    with mock.patch.object(layers, 'attention', spy):
        pipe(prompt_embeds=embeds, latents=latents, output_type='latent')
    return kept


def phase_w8a8_full(pipe, embeds, latents, lat_bf16, t_bf16):
    resident_bf16 = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    n_int8 = pipe.quantize_int8(act_quant=True)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    n_joint = FLUX_12B['num_layers']
    n_single = FLUX_12B['num_single_layers']
    want_layers = (INT8_OUTSIDE_BLOCKS + INT8_PER_JOINT * n_joint
                   + INT8_PER_SINGLE * n_single)
    if n_int8 != want_layers or int8_layers(pipe.transformer,
                                            True) != want_layers:
        raise AssertionError(f'{n_int8} int8 layers, want {want_layers}')
    n_attn = 2 * (n_joint + n_single)
    w8a8 = int8_image(pipe, embeds, latents, lat_bf16,
                      dict(attention=n_attn, int8=2 * n_int8))
    # the first joint and the first single block of the first DiT call
    captured = captured_attention(pipe, embeds, latents, (0, n_joint))
    wall, busy, by_name = profile_split(
        lambda: pipe(prompt_embeds=embeds, latents=latents, output_type='pt'))
    total = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    int8_layers(pipe.transformer, act_quant=False)
    weight_only = int8_image(pipe, embeds, latents, lat_bf16,
                             dict(attention=n_attn, int8=0))
    log(f'phase 21 FLUX-12B int8 (phase 6 model quantized in place with '
        f'quantize_int8(act_quant=True)): ok | {n_int8} int8 layers in '
        f'{t_quant:.1f} s, resident {resident_gib:.2f} GiB (bf16 '
        f'{resident_bf16:.2f} GiB) | ' + ' ; '.join(
            f'{name}: image finite, range [{r["range"][0]:.3f}, '
            f'{r["range"][1]:.3f}], two runs bitwise equal, launches '
            f'{r["launches"]}, cold run {r["cold_s"]:.3f} s, warm per image '
            f'{r["warm_s"]:.4f} s: transformer + integration '
            f'{r["dit_s"]:.4f} s, decode {r["decode_s"]:.4f} s (bf16 phase 6: '
            f'{t_bf16:.4f} s), peak memory {r["peak_gib"]:.2f} GiB, latents '
            f'rel L2 against bf16 {r["rel_l2"]:.3e} (bound '
            f'{INT8_IMAGE_REL_L2})'
            for name, r in (('w8a8', w8a8), ('weight-only int8',
                                               weight_only))))
    log(f'phase 21 profile (one warm w8a8 image): wall {wall:.4f} s, device '
        f'busy {busy:.4f} s, idle share {1 - busy / wall:.4f} | by family: '
        + ' ; '.join(f'{f} {ms:.2f} ms {100 * ms / total:.1f}% x{calls}'
                     for f, (ms, calls, _) in sorted(
                         split_families(by_name).items(),
                         key=lambda kv: -kv[1][0]))
        + ' | by name: ' + ' ; '.join(
            f'{ms:.2f} ms x{calls} {name[:70]}' for name, (ms, calls) in top))
    return captured


def k7_readings(got, want):
    """max |d| of ``got`` against the plain version ``want``, how far the
    worst element lies past K7_ATOL + K7_RTOL |want| (> 0: refused), and
    the relative L2."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    over = (d - K7_ATOL - K7_RTOL * want.abs()).max().item()
    return d.max().item(), over, rel_l2(got, want)


def k7_check(name, q, k, v, kv_valid=None):
    """K7 against its plain version on one case (and a bitwise repeat);
    raises past a limit; returns (max |d|, rel L2, O)."""
    out = fi8.flash_attention_int8(q, k, v, kv_valid)
    again = fi8.flash_attention_int8(q, k, v, kv_valid)
    torch.cuda.synchronize()
    if not (torch.isfinite(out).all() and torch.equal(out, again)):
        raise AssertionError(f'K7 {name}: non-finite or not repeatable')
    err, over, rel = k7_readings(
        out, fi8.flash_attention_int8_ref(q, k, v, kv_valid))
    if over > 0 or not rel <= K7_REL_L2:
        raise AssertionError(f'K7 {name}: max|d| {err:.3e} ({over:+.2e} past '
                             f'{K7_ATOL} + {K7_RTOL:.4g} |ref|), rel L2 '
                             f'{rel:.3e} (bound {K7_REL_L2})')
    return err, rel, out


def planted_k7_faults(q, k, v):
    """Two faults the kernel could make, on sound inputs: the k scales
    dropped, and int8 key rows 0-7 and 8-15 swapped in the first tile (what
    rescaling an accumulator by another column's scale does). Each must
    break both limits. Returns their readings."""
    qq, qs, kq, ks = fi8.quantize_qk(q, k)
    ref = fi8.flash_attention_int8_ref(q, k, v)
    swap = torch.cat([torch.arange(8, 16), torch.arange(8)]).to(q.device)
    kq_bad = kq.clone()
    kq_bad[:, :16] = kq[:, swap]
    parts = []
    for name, (k_i8, k_scale) in {
            'k scales dropped': (kq, torch.ones_like(ks)),
            'int8 key rows swapped in one tile': (kq_bad, ks)}.items():
        bad = fi8.launch(qq, qs, k_i8, k_scale, v, None, q.shape[-1] ** -0.5,
                         q.dtype)
        err, over, rel = k7_readings(bad, ref)
        if not (over > 0 and rel > K7_REL_L2):
            raise AssertionError(f'K7 planted fault "{name}" passes a limit: '
                                 f'max|d| {err:.3e} ({over:+.2e}), rel L2 '
                                 f'{rel:.3e}')
        parts.append(f'{name}: max|d| {err:.3e}, rel L2 {rel:.3e}')
    return parts


def quant_bound(b, s, h, elem=2):
    """Roofline of the row quantization of q and k at (B, S, H, 128):
    reading both in ``elem`` bytes a value, writing their int8 rows and fp32
    scales; against 6 fp32 operations a value (abs, max, divide, round,
    two clips) at the fp32 peak."""
    values = 2 * b * s * h * 128
    nbytes = values * elem + values + 2 * b * h * s * 4
    return roofline(6 * values, nbytes, H100_FP32)


def quant_check(name, q, k):
    """The quantization kernel against ``rowwise_int8`` (through
    ``quantize_qk_ref``) on the same card tensors, bitwise; raises on any
    difference, else returns the largest |difference| (0)."""
    got = fi8.quantize_qk(q, k)
    want = fi8.quantize_qk_ref(q, k)
    worst = 0.0
    for part, x, y in zip(('q rows', 'q scales', 'k rows', 'k scales'), got,
                          want):
        if not torch.equal(x, y):
            raise AssertionError(f'quantization {name}: {part} differ from '
                                 f'rowwise_int8 at {int((x != y).sum())} '
                                 f'places')
        worst = max(worst, (x.float() - y.float()).abs().max().item())
    return worst


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def phase_k7_vs_plain(captured):
    g = torch.Generator(device='cuda').manual_seed(SEED + 22)
    b, s, h, _ = FLUX_SHAPE

    def qkv(shape):
        return [torch.randn(shape, generator=g, device='cuda',
                            dtype=torch.bfloat16) for _ in range(3)]

    def valid(n, lengths):
        return torch.arange(n, device='cuda')[None, :] < torch.tensor(
            lengths, device='cuda')[:, None]
    flux = qkv(FLUX_SHAPE)
    jax_shape = qkv((2, 512, 3, 128))
    cases = [('flux', flux, None),
             ('masked', flux, valid(s, (QWEN_VALID_KEYS,))),
             ('keyless row', jax_shape, valid(512, (0, 512))),
             ('jax test shape', jax_shape, None),
             ('jax test shape masked', jax_shape, valid(512, (256, 448))),
             ('ragged', qkv((2, 1000, 4, 128)), valid(1000, (900, 1000)))]
    fp32 = [x.float() for x in qkv((2, 1000, 4, 128))]
    quant_err = max(quant_check(name, q, k) for name, (q, k, _), _ in
                    cases + [('ragged fp32', fp32, None)])
    q, k, _ = flux
    quant_err = max(quant_err, quant_check(
        'FLUX shape, head-major views',
        q.transpose(1, 2).contiguous().transpose(1, 2),
        k.transpose(1, 2).contiguous().transpose(1, 2)))
    worst, parts = 0.0, []
    for name, (q, k, v), kv_valid in cases:
        err, rel, out = k7_check(name, q, k, v, kv_valid)
        if name == 'keyless row':
            mean = v[0].float().mean(0).expand_as(v[0]).to(v.dtype)
            if (out[0].float() - mean.float()).abs().max() > K7_ATOL:
                raise AssertionError('K7: a keyless row is not the mean of v')
        worst = max(worst, err)
        parts.append(f'{name} max|d| {err:.3e} rel L2 {rel:.3e}')
    fi8.LAUNCHES = fi8.QUANT_LAUNCHES = 0   # the probe of the w8a8 image
    probe = []
    for name, (q, k, v) in zip(('joint block 0', 'single block 0'),
                               captured):
        err, rel, out = k7_check(name, q, k, v)
        cos = cosine(out, attn.flash_attention_fwd(q, k, v))
        if not cos > K7_COSINE:
            raise AssertionError(f'K7 {name}: cosine against K1 {cos:.6f}')
        worst = max(worst, err)
        probe.append(f'{name} max|d| {err:.3e} rel L2 {rel:.3e}, cosine '
                     f'against K1 {cos:.6f}')
    launches = fi8.LAUNCHES // 2            # each case runs twice
    quant_launches = fi8.QUANT_LAUNCHES // 2
    if launches != 2 or quant_launches != 2:
        raise AssertionError(f'the probe launched K7 {launches} and the '
                             f'quantization {quant_launches} times, want 2')
    faults = planted_k7_faults(*flux) + planted_k7_faults(*jax_shape)
    q, k, v = flux
    qq, qs, kq, ks = fi8.quantize_qk(q, k)
    sm = q.shape[-1] ** -0.5
    ms = cuda_ms(lambda: fi8.launch(qq, qs, kq, ks, v, None, sm, q.dtype), 20)
    wrapper_ms = cuda_ms(lambda: fi8.flash_attention_int8(q, k, v), 20)
    plain_ms = cuda_ms(lambda: fi8.flash_attention_int8_ref(q, k, v), 3)
    k1_ms = cuda_ms(lambda: attn.flash_attention_fwd(q, k, v), 20)
    with torch.inference_mode():
        sdpa_ms = cuda_ms(lambda: sdpa(q, k, v), 20)
    bound_ms, bound_by = k7_bound(b, s, h)
    quant = dict(ms=kernel_ms(lambda: fi8.quantize_qk(q, k),
                              'quantize_rows_int8', 50),
                 call_ms=cuda_ms(lambda: fi8.quantize_qk(q, k), 50),
                 plain_ms=cuda_ms(lambda: fi8.quantize_qk_ref(q, k), 20),
                 launches=quant_launches, max_abs_err=quant_err)
    quant['bound_ms'], quant['bound_by'] = quant_bound(b, s, h)
    ptxas = {name: ptxas_usage(name) for name in (
        'flash_int8_kernelI13__nv_bfloat16E', 'quantize_rows_int8_kernel')}
    log(f'phase 22 int8-QK^T attention kernel (K7) vs plain: ok | '
        f'{" ; ".join(parts)} | on the w8a8 image ({launches} probe '
        f'launches): {" ; ".join(probe)} | limits |d| <= {K7_ATOL} + '
        f'{K7_RTOL:.4g} |ref|, rel L2 {K7_REL_L2}, cosine {K7_COSINE}; two '
        f'runs bitwise equal, the keyless row the mean of v | planted faults '
        f'refused by both limits (FLUX shape, then B2 S512 H3): '
        f'{" ; ".join(faults)} | FLUX shape B{b} S{s} H{h} D128: kernel '
        f'{ms:.4f} ms (the call with the quantization {wrapper_ms:.4f} ms), '
        f'plain {plain_ms:.4f} ms, K1 {k1_ms:.4f} ms, SDPA bf16 '
        f'{sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, '
        f'{100 * bound_ms / ms:.1f}% of it) | quantization ({quant_launches} '
        f'probe launches) bitwise rowwise_int8 on bf16, fp32, ragged and '
        f'head-major rows: {quant["ms"]:.4f} ms device time (the call '
        f'{quant["call_ms"]:.4f} ms), plain {quant["plain_ms"]:.4f} ms, '
        f'bound {quant["bound_ms"]:.4f} ms ({quant["bound_by"]}, '
        f'{100 * quant["bound_ms"] / quant["ms"]:.1f}% of it) | ptxas: '
        + ' ; '.join(f'{name}: {use}' for name, use in ptxas.items()))
    return worst, launches, dict(ms=ms, wrapper_ms=wrapper_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, k1_ms=k1_ms,
                                 sdpa_ms=sdpa_ms, quant=quant,
                                 ptxas=ptxas)


def spied_call(pipe, embeds, latents, output_type):
    """One counted call of the sharded ``pipe`` (every count set to 0 just
    before it): (result, seconds, launches, the first ring attention's q,
    k, v, key mask and output, or None under Ulysses)."""
    calls = []

    def spy(*args, **kw):
        out = ring_attention(*args, **kw)
        if not calls:
            calls.append((*args[:4], out))
        return out
    hop.LAUNCHES = attn.LAUNCHES = qmm.LAUNCHES = 0
    with mock.patch.object(layers, 'ring_attention', spy):
        out, t = timed_call(pipe, embeds, latents, output_type=output_type)
    launches = dict(ring_hop=hop.LAUNCHES, attention=attn.LAUNCHES,
                    w4a8=qmm.LAUNCHES)
    return out, t, launches, calls[0] if calls else None


def equals_local_ring(sp, call):
    """Whether this rank's first ring attention is, bit for bit, its shard
    of ``LocalRing`` on every rank's q, k, v and key mask put together."""
    if call is None:
        return None
    q, k, v, valid, got = call
    full = [sp.gather(t) for t in (q, k, v)]
    mask = None if valid is None else sp.gather(valid)
    local = ring_attention(*full, mask, LocalRing(sp.size))
    return torch.equal(local.split(q.shape[1], dim=1)[sp.rank], got)


def broadcast_from_rank0(*tensors):
    for t in tensors:
        dist.broadcast(t, 0)


def rank_main(out_dir):
    """One rank of ``--ranks N``: FLUX-12B on one device, then sharded over
    the N ranks in ring and in Ulysses mode; then Qwen w4a8 at full width
    and RANKS_QWEN_LAYERS blocks, with its text mask, the same way; writes
    ``rank{r}.json``."""
    dev = setup_distributed(timeout=300.0)
    rank, n = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    with torch.device(dev):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, **FLUX_12B)
        vae = PretrainedVAE(dtype=torch.bfloat16)
    randomize_(model, g)
    pipe = ArcFluxPipeline(model, vae=vae)
    embeds = flux_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device=dev)
    broadcast_from_rank0(*model.state_dict().values(),
                         *vae.state_dict().values(), *embeds.values(),
                         latents)
    timed_call(pipe, embeds, latents, output_type='pt')     # cold
    single, t_single = timed_call(pipe, embeds, latents, output_type='pt')
    single_lat = pipe(prompt_embeds=embeds, latents=latents,
                      output_type='latent')['latents']
    res = dict(rank=rank, single_s=t_single)
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    for mode in ('ring', 'ulysses'):
        pipe.shard({'sp': n}, sp_mode=mode)
        sp = pipe.transformer.sequence_parallel
        _, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
        torch.cuda.reset_peak_memory_stats()
        out, t_e2e, launches, call = spied_call(pipe, embeds, latents, 'pt')
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        img = out['images']
        lat = pipe(prompt_embeds=embeds, latents=latents,
                   output_type='latent')['latents']
        wall, busy, _ = profile_split(lambda: pipe(
            prompt_embeds=embeds, latents=latents, output_type='pt'))
        rank0 = img.clone(memory_format=torch.contiguous_format)
        broadcast_from_rank0(rank0)
        want = dict(ring=dict(ring_hop=2 * n_blocks * n, attention=0, w4a8=0),
                    ulysses=dict(ring_hop=0, attention=2 * n_blocks,
                                 w4a8=0))[mode]
        res[mode] = dict(
            launches=launches, launches_ok=launches == want,
            image_finite=bool(torch.isfinite(img).all()),
            equal_to_rank0=torch.equal(img, rank0),
            local_ring_equal=equals_local_ring(sp, call),
            rel_l2_image=rel_l2(img, single['images']),
            rel_l2_latents=rel_l2(lat, single_lat), cold_s=t_cold,
            warm_s=t_e2e, peak_gib=peak_gib, profiled_wall_s=wall,
            device_busy_s=busy, idle_share=1 - busy / wall)
    del pipe, model, vae, single, img, out
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    pipe, _, n_int4 = qwen_w4a8(g, num_layers=RANKS_QWEN_LAYERS)
    embeds = qwen_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device=dev)
    broadcast_from_rank0(*pipe.transformer.state_dict().values(),
                         *embeds.values(), latents)
    timed_call(pipe, embeds, latents, output_type='latent')  # cold
    single_lat = pipe(prompt_embeds=embeds, latents=latents,
                      output_type='latent')['latents']
    for mode in ('ring', 'ulysses'):
        pipe.shard({'sp': n}, sp_mode=mode)
        sp = pipe.transformer.sequence_parallel
        timed_call(pipe, embeds, latents, output_type='latent')  # cold
        out, t_e2e, launches, call = spied_call(pipe, embeds, latents,
                                                'latent')
        lat = out['latents']
        rank0 = lat.clone(memory_format=torch.contiguous_format)
        broadcast_from_rank0(rank0)
        want = dict(ring=dict(ring_hop=2 * RANKS_QWEN_LAYERS * n,
                              attention=0, w4a8=2 * n_int4),
                    ulysses=dict(ring_hop=0, attention=2 * RANKS_QWEN_LAYERS,
                                 w4a8=2 * n_int4))[mode]
        res[f'qwen_{mode}'] = dict(
            launches=launches, launches_ok=launches == want,
            image_finite=bool(torch.isfinite(lat).all()),
            equal_to_rank0=torch.equal(lat, rank0),
            local_ring_equal=equals_local_ring(sp, call),
            masked_ring_call=call is not None and call[3] is not None,
            rel_l2_latents=rel_l2(lat, single_lat), warm_s=t_e2e)
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def serve_ranks(n, out_dir):
    """--ranks' serving: FLUX-12B and Qwen w4a8 over sp = n in ring and
    Ulysses mode, read across the ranks; returns each rank's results."""
    t = time.perf_counter()
    spawn(rank_main, n, (out_dir,), timeout=600.0)
    wall = time.perf_counter() - t
    ranks = [json.load(open(os.path.join(out_dir, f'rank{r}.json')))
             for r in range(n)]
    modes = ('ring', 'ulysses', 'qwen_ring', 'qwen_ulysses')
    bad = [(r['rank'], mode, key) for r in ranks for mode in modes
           for key in ('launches_ok', 'image_finite', 'equal_to_rank0')
           if not r[mode][key]]
    bad += [(r['rank'], mode, 'local_ring_equal') for r in ranks
            for mode in ('ring', 'qwen_ring')
            if r[mode]['local_ring_equal'] is not True]
    bad += [(r['rank'], 'qwen_ring', 'masked_ring_call') for r in ranks
            if not r['qwen_ring']['masked_ring_call']]
    bad += [(r['rank'], mode, 'rel_l2_latents') for r in ranks
            for mode in modes
            if not r[mode]['rel_l2_latents'] <= SP_IMAGE_REL_L2]
    if bad:
        raise AssertionError(f'--ranks {n} failed: {bad}; {ranks}')
    r0 = ranks[0]
    log(f'phase R FLUX-12B on {n} NCCL ranks (sp = {n}): ok in {wall:.1f} s '
        f'| single device {r0["single_s"]:.4f} s per warm image | '
        + ' ; '.join(
            f'{mode}: launches per rank {r0[mode]["launches"]}, warm per '
            f'image {r0[mode]["warm_s"]:.4f} s (cold {r0[mode]["cold_s"]:.3f}'
            f'), rank 0 profiled: wall {r0[mode]["profiled_wall_s"]:.4f} s, '
            f'device busy {r0[mode]["device_busy_s"]:.4f} s, idle share '
            f'{r0[mode]["idle_share"]:.4f}, peak {r0[mode]["peak_gib"]:.2f} '
            f'GiB, rank 0 against one '
            f'device: image rel L2 {r0[mode]["rel_l2_image"]:.3e}, latents '
            f'{r0[mode]["rel_l2_latents"]:.3e} (bound {SP_IMAGE_REL_L2}); '
            f'every rank bitwise equal to rank 0'
            for mode in modes[:2])
        + f' ; first ring attention bitwise equal to LocalRing({n}) on every '
        f'rank')
    log(f'phase RQ Qwen w4a8 ({RANKS_QWEN_LAYERS} blocks, full width, text '
        f'mask {QWEN_TXT_VALID} of {QWEN_TXT}) on {n} NCCL ranks: ok | '
        + ' ; '.join(
            f'{mode[5:]}: launches per rank {r0[mode]["launches"]}, latents '
            f'rel L2 against one device {r0[mode]["rel_l2_latents"]:.3e} '
            f'(bound {SP_IMAGE_REL_L2}), warm {r0[mode]["warm_s"]:.4f} s, '
            f'every rank bitwise equal to rank 0' for mode in modes[2:])
        + f' ; first masked ring attention bitwise equal to LocalRing({n}) '
        f'on every rank')
    return ranks


def main_ranks(n, serve=True, mesh_train=True, pipe_expert=False,
               tensor=False, placement=False, quantized_only=False):
    """``--ranks n``: serving over sp = n (unless ``serve`` is off:
    ``--train-only``), mesh training over data=2, fsdp=n/2 (unless
    ``mesh_train`` is off: ``--sp-train-only``, which serves nothing
    either), then FLUX-12B training under sp (``sp_rank_cases``);
    ``--pipe-expert-only`` trains on the pipe and expert axes alone
    (``pe_rank_cases``), ``--tensor-only`` serves and trains on the
    tensor axis alone (``TP_SERVING``, ``TP_TRAINING``; 4 ranks),
    ``--placement-only`` serves over fsdp, pipe and expert and trains the
    quantized trunk sharded (``PL_SERVING``, ``pl_train``; 4 ranks;
    ``--quantized-only`` serves ``PL_QUANTIZED`` alone)."""
    smi = phase_facts()
    if torch.cuda.device_count() < n:
        raise SystemExit(f'FAIL ranks: --ranks {n} needs {n} cards, '
                         f'{torch.cuda.device_count()} visible')
    phase_build()
    out_dir = tempfile.mkdtemp(prefix='ranks-', dir=_build.BUILD_DIR)
    if pipe_expert:
        return main_pipe_expert(n, smi, out_dir)
    if tensor:
        if n != 4:
            raise SystemExit(f'FAIL ranks: --tensor-only runs on 4 ranks '
                             f'(tensor=4 and sp=2 x tensor=2), got {n}')
        return main_tensor(n, smi, out_dir)
    if placement:
        if n != 4:
            raise SystemExit(f'FAIL ranks: --placement-only runs on 4 ranks '
                             f'(fsdp=4, fsdp=2 x tensor=2, pipe=2 x '
                             f'expert=2), got {n}')
        return main_placement_ranks(n, smi, out_dir, quantized_only)
    ranks = serve_ranks(n, out_dir) if serve else None
    train = None
    if mesh_train:
        t = time.perf_counter()
        spawn(mesh_rank_main, n, (out_dir,), timeout=1200.0)
        train_wall = time.perf_counter() - t
        train = [json.load(open(os.path.join(out_dir, f'train{r}.json')))
                 for r in range(n)]
        shutil.rmtree(os.path.join(out_dir, 'work'), ignore_errors=True)
        check_mesh_ranks(train, n)
        log(f'phase RT mesh training on {n} NCCL ranks: ok in '
            f'{train_wall:.1f} s (both configs, builds, checkpoints and '
            f'profiles included)')
    t = time.perf_counter()
    refs = sp_train_references(out_dir, n)
    spawn(sp_rank_main, n, (out_dir,), timeout=1500.0)
    sp_wall = time.perf_counter() - t
    sp_train = [json.load(open(os.path.join(out_dir, f'sp{r}.json')))
                for r in range(n)]
    shutil.rmtree(out_dir, ignore_errors=True)
    check_sp_ranks(sp_train, n, refs)
    log(f'phase RS training under sp on {n} NCCL ranks: ok in {sp_wall:.1f} '
        f's (the one-card references, builds and iterations included)')
    print(json.dumps({'ranks': ranks, 'train': train, 'sp_train': sp_train}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# prompt to image: the text towers, diffusers folders, from_pretrained, CLIs
# ---------------------------------------------------------------------------

PROMPT = 'a photo of an astronaut riding a horse on the moon'
# the published text-tower widths: CLIP ViT-L/14's text model and the
# T5 v1.1 XXL encoder (FLUX.1-dev's text_encoder/ and text_encoder_2/), the
# Qwen2.5-VL-7B decoder (Qwen-Image's text_encoder/)
CLIP_L = dict(vocab_size=49408, hidden_size=768, intermediate_size=3072,
              num_hidden_layers=12, num_attention_heads=12,
              max_position_embeddings=77, hidden_act='quick_gelu',
              projection_dim=768)
T5_XXL = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240,
              num_layers=24, num_heads=64, feed_forward_proj='gated-gelu')
QWEN25_7B = dict(vocab_size=152064, hidden_size=3584, num_layers=28,
                 num_heads=28, num_kv_heads=4, intermediate_size=18944,
                 rope_theta=1e6, rms_norm_eps=1e-6)
T5_SEQ = 512
# phase 26's folders: FLUX and Qwen widths, depth cut to these
PRETRAINED_FLUX = dict(FLUX_12B, num_layers=2, num_single_layers=2,
                       lora_rank=256)
PRETRAINED_QWEN = dict(QWEN_20B, num_layers=2)
PRETRAINED_T5_LAYERS, PRETRAINED_QWEN_TEXT_LAYERS = 2, 2
PRETRAINED_HW = 512
CLI_TIMEOUT = 300


def toy_tokenizer():
    """A byte-level BPE trained on a few sentences, as a transformers fast
    tokenizer with a pad token: the real tokenizers are not in the repo.
    Its ids stay below every tower's vocabulary."""
    import transformers
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            trainers)
    tok = Tokenizer(models.BPE(unk_token='<unk>'))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=600, special_tokens=['<pad>', '<unk>', '</s>',
                                        '<|im_start|>', '<|im_end|>'],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(
        [PROMPT, 'a serene mountain lake at sunrise',
         'Describe the image by detailing the color, shape, size, texture, '
         'quantity, text, spatial relationships of the objects and '
         'background', 'system user assistant'] * 8, trainer)
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token='<pad>', unk_token='<unk>',
        eos_token='</s>')


def bf16_tower(cls_name, **config):
    """A transformers text tower built on the card in bf16 (random
    weights: normal(0, 0.02) on every matrix from the seeded generator
    later; transformers' own init runs on the card, not the host)."""
    import transformers
    cfg_cls = {'CLIPTextModel': 'CLIPTextConfig',
               'T5EncoderModel': 'T5Config'}[cls_name]
    cfg = getattr(transformers, cfg_cls)(**config)
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.bfloat16)
    try:
        with torch.device('cuda'):
            model = getattr(transformers, cls_name)(cfg)
    finally:
        torch.set_default_dtype(default)
    return model.to(torch.bfloat16).eval()


def qwen_text_tower(generator, **overrides):
    from arcflow_tpu_torch.models import Qwen25TextModel
    with torch.device('cuda'):
        model = Qwen25TextModel(**dict(QWEN25_7B, **overrides),
                                dtype=torch.bfloat16)
    randomize_(model, generator)
    return model.eval()


def synced(fn):
    """(fn(), its host seconds), synchronised at both ends."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def prompt_run(pipe, latents, want, counts, label):
    """Drive ``pipe`` from PROMPT: a cold call, then the counted call
    (counts reset just before it and read just after), the embeds path with
    ``encode_prompt``'s output bitwise equal to it, and the split of a warm
    image into encode, transformer + integration and decode seconds."""
    pipe(prompt=PROMPT, latents=latents, output_type='pt')       # cold
    torch.cuda.reset_peak_memory_stats()
    for name in counts:
        setattr(counts[name][0], counts[name][1], 0)
    out, t_e2e = synced(lambda: pipe(prompt=PROMPT, latents=latents,
                                     output_type='pt'))
    launches = {name: getattr(*counts[name]) for name in counts}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != want:
        raise AssertionError(f'{label}: launches {launches}, want {want}')
    img = out['images']
    check_image(img)
    embeds, t_enc = synced(lambda: pipe.encode_prompt(PROMPT))
    for k, v in embeds.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f'{label}: non-finite {k}')
    same = pipe(prompt_embeds=embeds, latents=latents, output_type='pt')
    if not torch.equal(same['images'], img):
        raise AssertionError(f'{label}: the image from prompt_embeds='
                             f'encode_prompt(prompt) differs from the image '
                             f'from prompt= by '
                             f'{(same["images"] - img).abs().max().item()}')
    lat, t_dit = synced(lambda: pipe(prompt_embeds=embeds, latents=latents,
                                     output_type='latent')['latents'])
    t_dec = timed_decode(pipe.vae, lat)
    return dict(launches=launches, s_per_image=t_e2e, encode_s=t_enc,
                transformer_s=t_dit, decode_s=t_dec, peak_gib=peak_gib,
                embeds={k: (tuple(v.shape), str(v.dtype).split('.')[-1],
                            v.float().abs().max().item())
                        for k, v in embeds.items()}, image=img)


def phase_prompt_flux_full(flux_run):
    """Phase 24, on phase 6's FLUX-12B pipeline: CLIP-L and T5-XXL at their
    published widths, random bf16 weights, then images from a prompt."""
    from arcflow_tpu_torch.models import PretrainedFluxTextEncoder
    pipe, _, latents, _, _ = flux_run
    g = torch.Generator(device='cuda').manual_seed(SEED + 24)
    (clip, t5), t_build = synced(lambda: (bf16_tower('CLIPTextModel',
                                                     **CLIP_L),
                                          bf16_tower('T5EncoderModel',
                                                     **T5_XXL)))
    randomize_(clip, g)
    randomize_(t5, g)
    n_text = sum(p.numel() for m in (clip, t5) for p in m.parameters())
    tok = toy_tokenizer()
    pipe.text_encoder = PretrainedFluxTextEncoder.from_modules(
        clip, t5, tok, tok, max_sequence_length=T5_SEQ)
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    try:
        run = prompt_run(pipe, latents, {'attention': 2 * n_blocks},
                         {'attention': (attn, 'LAUNCHES')}, 'phase 24')
        run['clip_s'] = tower_s(lambda ids: clip(input_ids=ids), tok, 77)
        run['t5_s'] = tower_s(lambda ids: t5(input_ids=ids), tok, T5_SEQ)
        run['ui'] = ui_callback(pipe, n_blocks)
    finally:
        pipe.text_encoder = None
        del clip, t5
        gc.collect()
        torch.cuda.empty_cache()
    img = run['image']
    log(f'phase 24 FLUX from a prompt (FLUX-12B bf16 + CLIP-L and T5-XXL '
        f'at published widths, {n_text / 1e9:.3f}B text params bf16, random '
        f'from a seed; toy BPE tokenizer): ok | image {tuple(img.shape)} '
        f'finite, range [{img.min().item():.3f}, {img.max().item():.3f}], '
        f'bitwise equal from prompt= and from prompt_embeds=encode_prompt '
        f'| embeds (shape, dtype, max|x|) {run["embeds"]} | launches '
        f'{run["launches"]} | towers built in {t_build:.1f} s | warm per '
        f'image from a prompt {run["s_per_image"]:.4f} s: encode '
        f'{run["encode_s"]:.4f} s (CLIP-L alone {run["clip_s"]:.4f} s, '
        f'T5-XXL alone {run["t5_s"]:.4f} s, best of 3), transformer + '
        f'integration {run["transformer_s"]:.4f} s, decode '
        f'{run["decode_s"]:.4f} s | peak memory {run["peak_gib"]:.2f} GiB')
    log(f'phase 37 gradio callback (ui.gradio_app.generate, no gradio '
        f'needed) on this pipeline: ok | one 1024x1024 image from "{PROMPT}"'
        f', a torch.Generator on the card seeded {SEED + 37}: '
        f'{run["ui"]["s"]:.4f} s with the encode, K1 {run["ui"]["launches"]}'
        f', bitwise the pipeline\'s own image for that generator')
    run.pop('image')
    return run


def tower_s(fn, tok, length, reps=3):
    """Best of ``reps`` synchronised seconds of one tower's forward on
    PROMPT's ids at ``length`` tokens."""
    ids = tok([PROMPT], padding='max_length', max_length=length,
              truncation=True, return_tensors='pt')['input_ids'].to('cuda')
    with torch.inference_mode():
        return min(synced(lambda: fn(ids))[1] for _ in range(reps))


def phase_prompt_qwen_full(qwen_run):
    """Phase 25, on phase 8's Qwen-Image 20B w4a8 pipeline: the native
    Qwen2.5-VL-7B decoder at its published width, random bf16 weights,
    then images from a prompt. The toy tokenizer's template is not the real
    one's 34 tokens; 34 of its tokens are dropped all the same, as JAX
    does."""
    from arcflow_tpu_torch.models import PretrainedQwenImageTextEncoder
    pipe, latents, n_int4 = qwen_run
    g = torch.Generator(device='cuda').manual_seed(SEED + 25)
    model, t_build = synced(lambda: qwen_text_tower(g))
    n_text = sum(p.numel() for p in model.parameters())
    tok = toy_tokenizer()
    pipe.text_encoder = PretrainedQwenImageTextEncoder.from_modules(
        model, tok, pad_seq_len=QWEN_TXT)
    try:
        valid = int(pipe.encode_prompt(PROMPT)[
            'encoder_hidden_states_mask'].sum())
        run = prompt_run(
            pipe, latents,
            {'attention': 2 * QWEN_20B['num_layers'], 'w4a8': 2 * n_int4},
            {'attention': (attn, 'LAUNCHES'), 'w4a8': (qmm, 'LAUNCHES')},
            'phase 25')
    finally:
        pipe.text_encoder = None
        del model
        gc.collect()
        torch.cuda.empty_cache()
    img = run['image']
    log(f'phase 25 Qwen from a prompt (Qwen-Image 20B w4a8 + the native '
        f'Qwen2.5-VL-7B decoder at its published width, {n_text / 1e9:.3f}B '
        f'params bf16, random from a seed; toy BPE tokenizer, 34 template '
        f'tokens dropped as in JAX): ok | valid text tokens {valid} of '
        f'{QWEN_TXT} | image {tuple(img.shape)} finite, range '
        f'[{img.min().item():.3f}, {img.max().item():.3f}], bitwise equal '
        f'from prompt= and from prompt_embeds=encode_prompt | embeds '
        f'(shape, dtype, max|x|) {run["embeds"]} | launches '
        f'{run["launches"]} | tower built in {t_build:.1f} s | warm per '
        f'image from a prompt {run["s_per_image"]:.4f} s: encode '
        f'{run["encode_s"]:.4f} s, transformer + integration '
        f'{run["transformer_s"]:.4f} s, decode {run["decode_s"]:.4f} s | '
        f'peak memory {run["peak_gib"]:.2f} GiB')
    run.pop('image')
    run['valid_text_tokens'] = valid
    return run


# the port's VAE decoder names -> diffusers' (the inverse of
# pipelines/convert.py's rules, for the folders phase 26 writes)
VAE_TO_DIFFUSERS = [
    (r'^decoder\.up_(\d+)_res_(\d+)\.', r'decoder.up_blocks.\1.resnets.\2.'),
    (r'^decoder\.up_(\d+)_us\.', r'decoder.up_blocks.\1.upsamplers.0.'),
    (r'\.mid_res_1\.', '.mid_block.resnets.0.'),
    (r'\.mid_res_2\.', '.mid_block.resnets.1.'),
    (r'\.mid_attn\.', '.mid_block.attentions.0.'),
    (r'\.to_out\.', '.to_out.0.'),
]
QWEN_VAE_TO_DIFFUSERS = [
    (r'^decoder\.up_blocks_(\d+)\.resnets_(\d+)\.',
     r'decoder.up_blocks.\1.resnets.\2.'),
    (r'^decoder\.up_blocks_(\d+)\.upsampler\.',
     r'decoder.up_blocks.\1.upsamplers.0.'),
    (r'\.mid_block\.resnets_(\d+)\.', r'.mid_block.resnets.\1.'),
    (r'\.mid_block\.attentions_0\.', '.mid_block.attentions.0.'),
    (r'\.resample_conv\.', '.resample.1.'),
]


def vae_to_diffusers(state, family):
    """A port VAE state -> diffusers keys and layouts: the Wan VAE's convs
    outside attention and resampling as causal 3-D kernels of one temporal
    slice, its RMS gammas (c, 1, 1)."""
    rules = VAE_TO_DIFFUSERS if family == 'flux' else QWEN_VAE_TO_DIFFUSERS
    out = {}
    for key, v in state.items():
        name = key
        for pat, rep in rules:
            name = re.sub(pat, rep, name)
        v = v.detach().cpu().contiguous()
        if family == 'qwen' and name.endswith('.gamma'):
            v = v.reshape(-1, 1, 1)
        elif (family == 'qwen' and v.dim() == 4 and '.attentions.' not in
              name and '.resample.' not in name):
            v = v[:, :, None].contiguous()
        out[name] = v
    return out


def save_safetensors(state, path):
    from safetensors.torch import save_file
    save_file({k: v.detach().cpu().contiguous() for k, v in state.items()},
              path)
    return os.path.getsize(path)


def write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f)


def dir_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def adapter_of(model, generator):
    """The ArcFlow surface of ``model`` (heads, norm_out, LoRA) moved by
    random draws, as a trained adapter would be."""
    from arcflow_tpu_torch.models.flux import ARCFLUX_ADAPTER_KEYS
    from arcflow_tpu_torch.utils.pytree import name_matches
    out = {}
    for k, v in model.state_dict().items():
        if name_matches(k, ARCFLUX_ADAPTER_KEYS):
            out[k] = (v.float() + 0.02 * torch.randn(
                v.shape, generator=generator, device=v.device)).to(v.dtype)
    return out


def write_qwen_text_folder(root, generator, tok, layers):
    """The Qwen2.5-VL-7B decoder at its published width, cut to ``layers``
    layers, random bf16 weights, as a diffusers pipeline's
    ``text_encoder/`` (a Qwen2.5-VL config and safetensors) with ``tok`` in
    ``tokenizer/``. Returns the tower."""
    text = qwen_text_tower(generator, num_layers=layers)
    write_json(os.path.join(root, 'text_encoder', 'config.json'),
               dict(architectures=['Qwen2_5_VLForConditionalGeneration'],
                    text_config=dict(
                        vocab_size=QWEN25_7B['vocab_size'],
                        hidden_size=QWEN25_7B['hidden_size'],
                        num_hidden_layers=layers,
                        num_attention_heads=QWEN25_7B['num_heads'],
                        num_key_value_heads=QWEN25_7B['num_kv_heads'],
                        intermediate_size=QWEN25_7B['intermediate_size'],
                        rope_theta=QWEN25_7B['rope_theta'],
                        rms_norm_eps=QWEN25_7B['rms_norm_eps'])))
    save_safetensors({'model.language_model.' + k: v
                      for k, v in text.state_dict().items()},
                     os.path.join(root, 'text_encoder', 'model.safetensors'))
    tok.save_pretrained(os.path.join(root, 'tokenizer'))
    return text


def write_pipeline_folder(root, family, generator):
    """A diffusers pipeline folder at the family's widths, depth cut
    (PRETRAINED_*), random weights, and the modules it was written from
    (transformer with the adapter merged, VAE, text towers, tokenizer) for
    a pipeline built directly."""
    from arcflow_tpu_torch.pipelines import torch_to_diffusers
    tok = toy_tokenizer()
    index = {'_class_name': 'ArcFluxPipeline' if family == 'flux'
             else 'ArcQwenImagePipeline',
             'scheduler': ['diffusers', 'FlowMatchEulerDiscreteScheduler'],
             'transformer': ['diffusers', 'ArcFluxTransformer2DModel']}
    cfg = PRETRAINED_FLUX if family == 'flux' else PRETRAINED_QWEN
    cls = ArcFluxTransformer2DModel if family == 'flux' \
        else ArcQwenImageTransformer2DModel
    with torch.device('cuda'):
        model = cls(dtype=torch.bfloat16, **cfg)
        vae = PretrainedVAE(dtype=torch.bfloat16) if family == 'flux' \
            else PretrainedVAEQwenImage(dtype=torch.bfloat16)
    randomize_(model, generator)
    randomize_(vae, generator)
    write_json(os.path.join(root, 'transformer', 'config.json'),
               dict(cfg, _class_name=cls.__name__))
    save_safetensors(torch_to_diffusers(model.state_dict(), family=family),
                     os.path.join(root, 'transformer',
                                  'diffusion_pytorch_model.safetensors'))
    adapter = adapter_of(model, generator)
    model.load_state_dict(adapter, strict=False)
    if family == 'flux':
        vae_cfg = dict(_class_name='AutoencoderKL', latent_channels=16,
                       block_out_channels=[128, 256, 512, 512],
                       layers_per_block=2, scaling_factor=0.3611,
                       shift_factor=0.1159, use_quant_conv=False,
                       use_post_quant_conv=False)
    else:
        vae_cfg = dict(_class_name='AutoencoderKLQwenImage', base_dim=96,
                       z_dim=16, dim_mult=[1, 2, 4, 4], num_res_blocks=2)
    index['vae'] = ['diffusers', vae_cfg['_class_name']]
    write_json(os.path.join(root, 'vae', 'config.json'), vae_cfg)
    save_safetensors(vae_to_diffusers(vae.state_dict(), family),
                     os.path.join(root, 'vae',
                                  'diffusion_pytorch_model.safetensors'))
    towers = {}
    if family == 'flux':
        clip = bf16_tower('CLIPTextModel', **CLIP_L)
        t5 = bf16_tower('T5EncoderModel', **dict(
            T5_XXL, num_layers=PRETRAINED_T5_LAYERS))
        randomize_(clip, generator)
        randomize_(t5, generator)
        for sub, m in (('text_encoder', clip), ('text_encoder_2', t5)):
            m.save_pretrained(os.path.join(root, sub))
        for sub in ('tokenizer', 'tokenizer_2'):
            tok.save_pretrained(os.path.join(root, sub))
        index.update(text_encoder=['transformers', 'CLIPTextModel'],
                     text_encoder_2=['transformers', 'T5EncoderModel'],
                     tokenizer=['transformers', 'CLIPTokenizer'],
                     tokenizer_2=['transformers', 'T5TokenizerFast'])
        towers = dict(clip=clip, t5=t5)
        sched = dict(shift=3.0, use_dynamic_shifting=True)
    else:
        text = write_qwen_text_folder(root, generator, tok,
                                      PRETRAINED_QWEN_TEXT_LAYERS)
        index.update(text_encoder=['transformers',
                                   'Qwen2_5_VLForConditionalGeneration'],
                     tokenizer=['transformers', 'Qwen2Tokenizer'])
        towers = dict(text=text)
        sched = dict(shift=QWEN_SHIFT, use_dynamic_shifting=False)
    write_json(os.path.join(root, 'scheduler', 'scheduler_config.json'),
               dict(_class_name='FlowMatchEulerDiscreteScheduler', **sched,
                    base_shift=0.5, max_shift=1.15, base_image_seq_len=256,
                    max_image_seq_len=4096))
    write_json(os.path.join(root, 'model_index.json'), index)
    adapter_path = os.path.join(root, 'arcflow_adapter.safetensors')
    from arcflow_tpu_torch.pipelines import save_adapter_state
    save_adapter_state(adapter_path, adapter,
                       policy_config=dict(nfe=2, temperature=0.9),
                       family=family)
    return dict(model=model, vae=vae, tok=tok, sched=sched,
                adapter=adapter_path, **towers)


def direct_pipeline(family, built):
    """The pipeline of the same modules, built without a folder."""
    from arcflow_tpu_torch.models import (PretrainedFluxTextEncoder,
                                          PretrainedQwenImageTextEncoder)
    if family == 'flux':
        enc = PretrainedFluxTextEncoder.from_modules(
            built['clip'], built['t5'], built['tok'], built['tok'])
        return ArcFluxPipeline(built['model'], vae=built['vae'],
                               text_encoder=enc, temperature=0.9,
                               **built['sched'])
    enc = PretrainedQwenImageTextEncoder.from_modules(built['text'],
                                                      built['tok'])
    return ArcQwenImagePipeline(built['model'], vae=built['vae'],
                                text_encoder=enc, temperature=0.9,
                                **built['sched'])


def phase_from_pretrained():
    """Phase 26: diffusers pipeline folders written at FLUX's and
    Qwen-Image's widths (depth cut: 2 joint + 2 single FLUX blocks, a
    2-layer T5-XXL, 2 Qwen blocks, a 2-layer Qwen2.5 decoder; CLIP-L, the
    VAEs and every width full), loaded with ``from_pretrained`` +
    ``load_arcflow_adapter`` on the card; each image bitwise equal to that
    of a pipeline built directly from the same modules; then the FLUX CLI
    in a subprocess on the folder."""
    g = torch.Generator(device='cuda').manual_seed(SEED + 26)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix='pretrained-', dir=_build.BUILD_DIR)
    pipe_cls = dict(flux=ArcFluxPipeline, qwen=ArcQwenImagePipeline)
    readings = {}
    try:
        for family in ('flux', 'qwen'):
            root = os.path.join(work, family)
            built, t_write = synced(lambda: write_pipeline_folder(
                root, family, g))
            nbytes = dir_bytes(root)
            direct = direct_pipeline(family, built)
            (pipe, policy), t_load = synced(lambda: load_folder(
                pipe_cls[family], root, built['adapter']))
            if policy != dict(nfe=2, temperature=0.9) or \
                    pipe.diffusion.test_cfg['temperature'] != 0.9:
                raise AssertionError(f'{family}: policy {policy}, test_cfg '
                                     f'{pipe.diffusion.test_cfg}')
            hw = PRETRAINED_HW
            latents = direct.prepare_latents(1, hw, hw, generator=g,
                                             device='cuda')
            want = direct(prompt=PROMPT, latents=latents,
                          output_type='pt')['images']
            got, t_image = synced(lambda: pipe(
                prompt=PROMPT, latents=latents, output_type='pt')['images'])
            if tuple(got.shape) != (1, hw, hw, 3) or \
                    not torch.isfinite(got).all():
                raise AssertionError(f'{family}: image {tuple(got.shape)}')
            if not torch.equal(got, want):
                raise AssertionError(
                    f'{family}: from_pretrained image differs from the '
                    f'direct pipeline by {(got - want).abs().max().item()}')
            readings[family] = dict(bytes=nbytes, write_s=t_write,
                                    load_s=t_load, image_s=t_image)
            if family == 'flux':
                cli = run_cli(root, built['adapter'], work)
                readings['flux_cli'] = cli
            del built, direct, pipe, latents, want, got
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f'phase 26 from_pretrained (diffusers pipeline folders at FLUX and '
        f'Qwen-Image widths, cut to 2 + 2 FLUX blocks and a 2-layer T5-XXL, '
        f'2 Qwen blocks and a 2-layer Qwen2.5 decoder; full CLIP-L and '
        f'VAEs; bf16; {PRETRAINED_HW}x{PRETRAINED_HW}): ok | '
        + ' ; '.join(
            f'{f}: {r["bytes"] / 1e9:.3f} GB written in {r["write_s"]:.1f} s, '
            f'from_pretrained + load_arcflow_adapter {r["load_s"]:.2f} s, '
            f'image from a prompt {r["image_s"]:.4f} s, bitwise equal to the '
            f'directly built pipeline' for f, r in readings.items()
            if f != 'flux_cli')
        + f' | python -m arcflow_tpu_torch.inference_flux on the folder: '
        f'exit 0 in {readings["flux_cli"]["s"]:.1f} s, '
        f'{readings["flux_cli"]["png_bytes"]} B PNG')
    return readings


def load_folder(cls, root, adapter):
    """``from_pretrained`` + ``load_arcflow_adapter``, and a first encode,
    which loads the text towers (they load lazily)."""
    pipe = cls.from_pretrained(root)
    policy = pipe.load_arcflow_adapter(adapter)
    pipe.encode_prompt(PROMPT)
    return pipe, policy


def run_cli(model_dir, adapter, work):
    out = os.path.join(work, 'cli.png')
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-m', 'arcflow_tpu_torch.inference_flux',
         '--model-dir', model_dir, '--adapter', adapter, '--prompt', PROMPT,
         '--height', str(PRETRAINED_HW), '--width', str(PRETRAINED_HW),
         '--out', out], capture_output=True, text=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t
    text = res.stdout + res.stderr
    if res.returncode != 0:
        raise AssertionError(f'inference_flux exited {res.returncode}:\n'
                             f'{text[-3000:]}')
    if 'device: cuda' not in text or not os.path.exists(out):
        raise AssertionError(f'inference_flux did not serve on the card:\n'
                             f'{text[-3000:]}')
    with open(out, 'rb') as f:
        if f.read(8) != b'\x89PNG\r\n\x1a\n':
            raise AssertionError('inference_flux wrote no PNG')
    return dict(s=wall, png_bytes=os.path.getsize(out))


# ---- phases 27-30: Qwen-Image distillation training ------------------------

def qwen_train_config(**net):
    """The Qwen int8-trunk config through the port's ``Config``: every
    ``parallel.mesh`` axis set to 1 (one card) and ``total_iters``, ``net``
    cutting the depth of the student and of the teacher alike."""
    cfg = Config.fromfile(QWEN_TRAIN_CONFIG)
    opts = {'parallel.mesh': {k: 1 for k in cfg.parallel.mesh},
            'total_iters': RUNNER_ITERS}
    for k, v in net.items():
        opts[f'model.diffusion.denoising.{k}'] = v
        opts[f'model.teacher.denoising.{k}'] = v
    cfg.merge_from_dict(opts)
    return cfg


def qwen_train_model(generator, cfg):
    """The Qwen distillation composition of ``cfg`` built through
    ``MODELS`` on the card, with random weights: normal(0.02) on every
    weight matrix of the student (trunk and adapter), drawn before the
    composition quantizes its trunk, and of the teacher's head."""
    from arcflow_tpu_torch.models import LatentDiffusionTextImage
    quantize = LatentDiffusionTextImage._quantize

    def randomized(self, module):
        randomize_(module, generator)
        return quantize(self, module)
    with mock.patch.object(LatentDiffusionTextImage, '_quantize', randomized):
        model = MODELS.build(cfg.model, default_args=dict(
            train_cfg=cfg.train_cfg, test_cfg=cfg.test_cfg, device='cuda',
            dtype=torch.bfloat16))
    teacher = model.teacher.denoising
    randomize_(torch.nn.ModuleList([teacher.norm_out, teacher.proj_out]),
               generator)
    return model


def qwen_embeds(generator, valid):
    """Random Qwen2.5-VL prompt embeds (1, 512, 3584) and the int64 text
    mask the loader gives, its first ``valid`` tokens valid."""
    mask = torch.arange(QWEN_TXT, device='cuda')[None] < valid
    return dict(
        encoder_hidden_states=torch.randn(1, QWEN_TXT, 3584,
                                          generator=generator, device='cuda',
                                          dtype=torch.bfloat16),
        encoder_hidden_states_mask=mask.long())


def qwen_train_batch(generator, cfg):
    """One batch of 1: random latents (only their shape and device are
    used: the data-free loss starts from noise), the prompt's embeds (384
    of 512 tokens valid) and the negative prompt's (128 valid), which the
    teacher's CFG takes."""
    return dict(latents=torch.randn(1, *cfg.model.latent_shape,
                                    generator=generator, device='cuda'),
                prompt_embed_kwargs=qwen_embeds(generator, QWEN_TXT_VALID),
                negative_prompt_embed_kwargs=qwen_embeds(generator,
                                                         QWEN_NEG_VALID))


def tied_trunk_mismatches(model):
    """Names of the tied teacher's trunk tensors (its head aside) that do
    not lie in the student's storage."""
    student = model.diffusion.denoising.state_dict(keep_vars=True)
    teacher = model.teacher.denoising.state_dict(keep_vars=True)
    return [n for n, t in teacher.items()
            if not n.startswith(('proj_out.', 'norm_out.'))
            and (n not in student or t.data_ptr() != student[n].data_ptr())]


def masked_bwd_timing(g):
    """K3 on the Qwen path's key-padded attention at the FLUX shape, its
    key mask laid out as the joint blocks lay it out: 512 text keys of
    which the first 384 are valid, then 4096 image keys (4480 of 4608
    valid). Against its plain version, then the kernels, the plain version
    and SDPA's masked backward timed."""
    q, k, v, do = (torch.randn(FLUX_SHAPE, generator=g, device='cuda',
                               dtype=torch.bfloat16) for _ in range(4))
    keys = torch.arange(FLUX_SHAPE[1], device='cuda')
    kv_valid = ((keys < QWEN_TXT_VALID) | (keys >= QWEN_TXT))[None].expand(
        FLUX_SHAPE[0], -1).contiguous()
    if int(kv_valid[0].sum()) != QWEN_VALID_KEYS:
        raise AssertionError(f'{int(kv_valid[0].sum())} valid keys')
    o, lse = attn.flash_attention_fwd(q, k, v, kv_valid, return_lse=True)
    got = attn.flash_attention_bwd(q, k, v, o, do, lse, kv_valid)
    want = attn.attention_bwd_ref(q, k, v, o, do, lse, kv_valid)
    rels = [rel_l2(x, y) for x, y in zip(got, want)]
    if max(rels) > BWD_REL_L2 or got[1][:, ~kv_valid[0]].any():
        raise AssertionError(f'masked K3: rel L2 dq/dk/dv {rels} > '
                             f'{BWD_REL_L2}, or a masked key got a gradient')
    err = max((x.float() - y.float()).abs().max().item()
              for x, y in zip(got, want))
    del got, want
    ms = cuda_ms(lambda: attn.flash_attention_bwd(q, k, v, o, do, lse,
                                                  kv_valid), 10)
    plain_ms = cuda_ms(lambda: attn.attention_bwd_ref(q, k, v, o, do, lse,
                                                      kv_valid), 3)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, kv_valid)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 10)
    bound_ms, bound_by = attention_bound(FLUX_SHAPE, QWEN_VALID_KEYS,
                                         backward=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                rel_l2=rels, valid_keys=QWEN_VALID_KEYS,
                shape=list(FLUX_SHAPE))


def phase_qwen_train_reduced():
    g = torch.Generator(device='cuda').manual_seed(SEED + 27)
    masked = masked_bwd_timing(g)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = qwen_train_config(num_layers=1)
    model = qwen_train_model(g, cfg)
    batch = qwen_train_batch(g, cfg)
    readings = train_slice_vs_plain(
        model, batch, QWEN_UPSTREAM_OF_ATTENTION,
        (TRAIN_FORWARDS, TRAIN_BACKWARDS), SEED + 28, QWEN_SHARE_REL_L2)
    log(f'phase 27 Qwen training reduced slice (1 joint block, full width, '
        f'int8 trunk, LoRA 256, CFG teacher at batch 2, {QWEN_TXT_VALID} of '
        f'{QWEN_TXT} text tokens valid): ok | {readings} | K3 key-padded at '
        f'{tuple(FLUX_SHAPE)} with {QWEN_VALID_KEYS} keys valid (the text '
        f'keys {QWEN_TXT_VALID}-{QWEN_TXT - 1} masked): rel L2 dq/dk/dv '
        + '/'.join(f'{r:.2e}' for r in masked['rel_l2'])
        + f' vs plain, kernels {masked["ms"]:.4f} ms, '
        f'plain fp32 {masked["plain_ms"]:.4f} ms, SDPA masked backward '
        f'{masked["library_ms"]:.4f} ms, bound {masked["bound_ms"]:.4f} ms '
        f'({masked["bound_by"]}, {100 * masked["bound_ms"] / masked["ms"]:.1f}'
        f'% of it)')
    ring = phase_qwen_train_local_ring(model, batch, SEED + 28)
    del model, batch
    return masked, ring


def phase_qwen_train_full():
    g = torch.Generator(device='cuda').manual_seed(SEED + 29)
    t0 = time.perf_counter()
    cfg = qwen_train_config()
    model = qwen_train_model(g, cfg)
    trainable, frozen = model.init_params()
    n_params = (count_params(trainable), count_params(frozen))
    n_int8 = sum(isinstance(m, LoRADense) and m.is_int8 and not m.act_quant
                 for m in model.diffusion.denoising.modules())
    if n_params != QWEN_TRAIN_PARAMS or n_int8 != QWEN_INT8_LAYERS:
        raise AssertionError(f'{QWEN_TRAIN_CONFIG} built (trainable, frozen) '
                             f'{n_params} parameters and {n_int8} int8 '
                             f'layers, want {QWEN_TRAIN_PARAMS}, '
                             f'{QWEN_INT8_LAYERS}')
    if tied_trunk_mismatches(model):
        raise AssertionError(f'teacher tensors outside the student\'s '
                             f'storage: {tied_trunk_mismatches(model)[:5]}')
    optimizers = build_optimizers(dict(cfg.optimizer), trainable)
    state = TrainState.create(
        torch.Generator(device='cuda').manual_seed(SEED + 30), trainable,
        frozen, optimizers, ema_keys=model.ema_keys)
    step = build_train_step(model, optimizers, model.train_cfg,
                            ema_config_from_cfg(cfg))
    batch = qwen_train_batch(g, cfg)
    adapter = trainable['diffusion']
    start = {n: p.detach().clone() for n, p in adapter.items()}
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    resident_build = torch.cuda.memory_allocated() / 2 ** 30
    frozen_host = {n: t.detach().cpu() for n, t in flatten(frozen).items()}
    n_blocks = cfg.model.diffusion.denoising.num_layers
    want = (TRAIN_FORWARDS * n_blocks, TRAIN_BACKWARDS * n_blocks)

    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(TRAIN_STEPS):
        attn.LAUNCHES = attn.BWD_LAUNCHES = 0   # the main path's counted run
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, logs = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = (attn.LAUNCHES, attn.BWD_LAUNCHES)
        if launches != want:
            raise AssertionError(f'step {state.step}: launches (forward, '
                                 f'backward) {launches}, want {want}')
        loss, gnorm = float(logs['loss']), logs['diffusion_grad_norm']
        if not (torch.isfinite(torch.tensor([loss, gnorm])).all()
                and logs['diffusion_skipped'] == 0.0):
            raise AssertionError(f'step {state.step}: loss {loss}, grad '
                                 f'norm {gnorm}, skipped '
                                 f'{logs["diffusion_skipped"]}')
        if not all(torch.equal(state.ema['diffusion'][n], p)
                   for n, p in adapter.items()):
            raise AssertionError(f'step {state.step}: the EMA is not the '
                                 f'adapter before start_iter')
        steps.append(dict(s=dt, loss=loss, grad_norm=gnorm,
                          step0=float(logs['loss_diffusion_step0']),
                          step1=float(logs['loss_diffusion_step1'])))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(p, start[n]) for n, p in adapter.items())
    if moved == 0:
        raise AssertionError('the adapter did not move')
    changed = [n for n, t in flatten(frozen).items()
               if not torch.equal(t.cpu(), frozen_host[n])]
    if changed or tied_trunk_mismatches(model):
        raise AssertionError(f'frozen tensors changed: {changed[:5]}, or the '
                             f'teacher left the student\'s storage')
    del frozen_host, start
    wall, busy, by_name = profile_split(lambda: step(state, batch))
    families = split_families(by_name)
    total = sum(ms for ms, _, _ in families.values())
    warm = sum(st['s'] for st in steps[1:]) / len(steps[1:])
    int8_gb = sum(t.numel() for t in frozen['base'].values()
                  if t.dtype == torch.int8) / 1e9
    log(f'phase 28 Qwen training full slice (Qwen-Image 20B ArcFlow '
        f'distillation of {QWEN_TRAIN_CONFIG} through Config and MODELS, '
        f'{count_params(frozen) / 1e9:.2f}B frozen ({n_int8} int8 layers, '
        f'{int8_gb:.2f} GB of int8 kernels) + {count_params(trainable)} fp32 '
        f'adapter parameters, teacher tied to the student\'s int8 trunk, CFG '
        f'4.0 at batch 2, batch 1, 1024x1024, {QWEN_TXT_VALID} of '
        f'{QWEN_TXT} text tokens valid, nfe 2, 4 intermediate states, LoRA '
        f'dropout 0.05, checkpointing): ok | '
        + ' ; '.join(f'step {i + 1}: {st["s"]:.3f} s, loss {st["loss"]:.5e} '
                     f'(NFE steps {st["step0"]:.4e} + {st["step1"]:.4e}), '
                     f'grad norm {st["grad_norm"]:.4e}'
                     for i, st in enumerate(steps))
        + f' | warm {warm:.4f} s per step | launches per step forward '
        f'{launches[0]}, backward {launches[1]} | {moved} of '
        f'{len(adapter)} adapter tensors moved, frozen trunk bit-identical, '
        f'the teacher\'s trunk the student\'s storage, EMA = adapter | build '
        f'{t_build:.1f} s, resident after build {resident_build:.2f} GiB | '
        f'peak memory {peak_gib:.2f} GiB, resident {resident_gib:.2f} GiB')
    log(f'phase 28 profile (one warm step): wall {wall:.4f} s, device busy '
        f'{busy:.4f} s, idle share {1 - busy / wall:.4f}, {len(by_name)} '
        f'kernel names | by family: ' + ' ; '.join(
            f'{f} {ms:.2f} ms {100 * ms / total:.1f}% x{calls} (largest: '
            f'{top_name[:60]})'
            for f, (ms, calls, top_name) in sorted(families.items(),
                                                   key=lambda kv: -kv[1][0])))
    return dict(forward=launches[0], backward=launches[1], warm_s=warm,
                peak_gib=peak_gib), dict(
        cfg=cfg, model=model, state=state, step=step, batch=batch, warm=warm,
        n_blocks=n_blocks)


def phase_qwen_train_runner(run):
    """Phase 28's model and state for QWEN_RUNNER_ITERS iterations through
    ``IterBasedRunner`` with the config's log hooks (interval 1), the loss
    quartiles and ``IterTimerHook(sync=True)``; no checkpoint."""
    cfg, state = run['cfg'], run['state']
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix='qwen-runner-', dir=_build.BUILD_DIR)
    try:
        start = state.step
        counter, timings = LaunchesPerIter(), Timings()
        hooks = build_hooks(dict(cfg.log_config, interval=1), extra_hooks=[
            counter, timings, QuartileLossLoggerHook(
                total_timesteps=cfg.model.diffusion.num_timesteps),
            IterTimerHook(interval=1, sync=True)])
        runner = IterBasedRunner(
            run['model'], state, run['step'], itertools.repeat(run['batch']),
            start + QWEN_RUNNER_ITERS, work_dir=work, hooks=hooks,
            device='cuda')
        # the main path's counted run
        attn.LAUNCHES = attn.BWD_LAUNCHES = hop.LAUNCHES = 0
        runner.run()
        want = (TRAIN_FORWARDS * run['n_blocks'],
                TRAIN_BACKWARDS * run['n_blocks'], 0)
        if runner.iter - start != QWEN_RUNNER_ITERS or \
                counter.per_iter != [want] * QWEN_RUNNER_ITERS:
            raise AssertionError(f'{runner.iter - start} iterations, '
                                 f'launches (K1, K3, K4) per iteration '
                                 f'{counter.per_iter}, want {want}')
        with open(os.path.join(work, 'metrics.jsonl')) as f:
            rows = [json.loads(line) for line in f]
        if len(rows) != QWEN_RUNNER_ITERS or not all(
                math.isfinite(r['loss']) for r in rows):
            raise AssertionError(f'the runner logged {rows}')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    per_iter = [r['time_iter'] for r in timings.rows]
    host_ms = [1e3 * (r['time_iter'] - r['time_step']) for r in timings.rows]
    log(f'phase 28r Qwen-Image 20B through IterBasedRunner (phase 28 model '
        f'and state, {len(hooks)} hooks: '
        f'{", ".join(type(h).__name__ for h in hooks)}): ok | launches (K1, '
        f'K3, K4) per iteration {counter.per_iter} | s per iteration through '
        f'the runner '
        + ', '.join(f'{x:.4f}' for x in per_iter)
        + f' (phase 28 bare warm step {run["warm"]:.4f} s) | runner host '
        f'time per iteration (iteration minus synced step) '
        + ', '.join(f'{x:.3f}' for x in host_ms) + ' ms | losses '
        + ', '.join(f'{r["loss"]:.5e}' for r in rows))
    return dict(forward=counter.per_iter[-1][0],
                backward=counter.per_iter[-1][1])


def phase_vae_encoders():
    """Both encoders at their published widths, random bf16 weights (the
    flax-default init from a seeded generator), a 1024^2 image."""
    from arcflow_tpu_torch.models import PretrainedVAEEncoder
    g = torch.Generator(device='cuda').manual_seed(SEED + 31)
    img = torch.rand(1, 1024, 1024, 3, generator=g, device='cuda') * 2 - 1
    parts = []
    for name, build in (
            ('FLUX AutoencoderKL Encoder',
             lambda: PretrainedVAEEncoder(dtype=torch.bfloat16)),
            ('Wan QwenVAEEncoder', lambda: PretrainedVAEQwenImage(
                dtype=torch.bfloat16, with_encoder=True))):
        with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
            torch.manual_seed(SEED + 32)
            with torch.device('cuda'):
                vae = build()
        n = sum(p.numel() for n_, p in vae.named_parameters()
                if n_.startswith(('encoder.', 'quant_conv.')))
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            z, t_cold = synced(lambda: vae.encode(img))
            runs = [synced(lambda: vae.encode(img)) for _ in range(3)]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if tuple(z.shape) != (1, 128, 128, 16) or not torch.isfinite(z).all():
            raise AssertionError(f'{name}: latents {tuple(z.shape)}, finite '
                                 f'{torch.isfinite(z).all().item()}')
        if not all(torch.equal(z, r) for r, _ in runs):
            raise AssertionError(f'{name}: a repeat differs')
        warm = min(t for _, t in runs)
        parts.append(f'{name} ({n / 1e6:.1f}M params): latents '
                     f'{tuple(z.shape)} finite, std {z.float().std():.4f}, '
                     f'the same on 3 repeats | cold {t_cold:.4f} s, warm '
                     f'{warm:.4f} s per encode | peak memory {peak:.2f} GiB')
        del vae, z, runs
        gc.collect()
        torch.cuda.empty_cache()
    log(f'phase 29 VAE encoders (1024x1024 -> 128x128x16, bf16): ok | '
        + ' ; '.join(parts))


QWEN_CLI_CONFIG = """\
_base_ = [{base!r}]
name = 'qwen_train_cli'
parallel = dict(mesh=dict({mesh}))
model = dict(
    diffusion=dict(denoising=dict(num_layers={layers})),
    teacher=dict(denoising=dict(num_layers={layers})),
    text_encoder=dict(type='PretrainedQwenImageTextEncoder',
                      pretrained={text!r}, tokenizer_path={tok!r},
                      pad_seq_len={pad}, dtype='bfloat16'))
data = dict(train=dict(_delete_=True, type='ImagePrompt',
                       prompts_path={prompts!r}, latent_size=(128, 128, 16),
                       negative_prompt=''))
checkpoint_config = dict(out_dir={ckpt!r})
log_config = dict(interval=1)
total_iters = {iters}
"""


def phase_qwen_train_cli():
    """``python -m arcflow_tpu_torch.train`` on the card in a subprocess:
    the int8-trunk Qwen config at full width cut to QWEN_CLI_LAYERS joint
    blocks, its data an ImagePrompt in prompt mode over a jsonl of prompts
    in two size_idx buckets of QWEN_CLI_SIZES (so the bucketized loader is
    taken, and each iteration trains one resolution: the port's sampler for
    the CLI's seed 0 gives their order), and the native Qwen2.5-VL-7B
    decoder at its published width cut to 2 layers with phase 25's toy
    tokenizer, run inside the loss for the prompt and the (empty) negative
    prompt."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix='qwen-cli-', dir=_build.BUILD_DIR)
    try:
        g = torch.Generator(device='cuda').manual_seed(SEED + 33)
        text = write_qwen_text_folder(work, g, toy_tokenizer(),
                                      PRETRAINED_QWEN_TEXT_LAYERS)
        del text
        gc.collect()
        torch.cuda.empty_cache()
        base = Config.fromfile(QWEN_TRAIN_CONFIG)
        batch = base.data.train_dataloader.samples_per_gpu
        bucket_ids = [i % len(QWEN_CLI_SIZES)
                      for i in range(batch * len(QWEN_CLI_SIZES))]
        prompts = os.path.join(work, 'prompts.jsonl')
        with open(prompts, 'w') as f:
            for i, b in enumerate(bucket_ids):
                f.write(json.dumps({'prompt': f'{PROMPT}, take {i}',
                                    'size_idx': b,
                                    'height': QWEN_CLI_SIZES[b],
                                    'width': QWEN_CLI_SIZES[b]}) + '\n')
        order = [QWEN_CLI_SIZES[bucket_ids[int(g[0])]] for g in
                 BucketizedBatchSampler(bucket_ids, batch).epoch_batches(0)]
        if sorted(order) != sorted(QWEN_CLI_SIZES):
            raise AssertionError(f'the epoch draws sizes {order}')
        cfg_path = os.path.join(work, 'qwen_train_cli.py')
        with open(cfg_path, 'w') as f:
            f.write(QWEN_CLI_CONFIG.format(
                base=os.path.abspath(QWEN_TRAIN_CONFIG),
                mesh=', '.join(f'{k}=1' for k in base.parallel.mesh),
                layers=QWEN_CLI_LAYERS, text=os.path.join(work,
                                                          'text_encoder'),
                tok=os.path.join(work, 'tokenizer'), pad=QWEN_TXT,
                prompts=prompts, ckpt=os.path.join(work, 'checkpoints'),
                iters=QWEN_CLI_ITERS))
        t = time.perf_counter()
        res = subprocess.run(
            [sys.executable, '-m', 'arcflow_tpu_torch.train', cfg_path,
             '--work-dir', os.path.join(work, 'run'), '--no-resume'],
            capture_output=True, text=True, timeout=CLI_TIMEOUT)
        wall = time.perf_counter() - t
        out = res.stdout + res.stderr
        if res.returncode != 0:
            raise AssertionError(f'the Qwen CLI exited {res.returncode}:\n'
                                 f'{out[-3000:]}')
        if not re.search(r'INFO device: cuda', out):
            raise AssertionError(f'the Qwen CLI did not train on the card:\n'
                                 f'{out[-3000:]}')
        with open(os.path.join(work, 'run', 'metrics.jsonl')) as f:
            rows = [json.loads(line) for line in f]
        if [r['iter'] for r in rows] != list(range(1, QWEN_CLI_ITERS + 1)) \
                or not all(math.isfinite(r['loss'])
                           and math.isfinite(r['diffusion_grad_norm'])
                           for r in rows):
            raise AssertionError(f'the Qwen CLI logged {rows}')
        params = re.search(r'trainable params: ([0-9,]+); frozen params: '
                           r'([0-9,]+)', out)
        cfg = Config.fromfile(cfg_path)
        log(f'phase 30 Qwen training through python -m '
            f'arcflow_tpu_torch.train on the card ({QWEN_TRAIN_CONFIG} cut '
            f'to {QWEN_CLI_LAYERS} joint blocks, ImagePrompt in prompt mode, '
            f'2 size_idx buckets -> the bucketized loader, iterations at '
            f'{" then ".join(f"{hw}^2" for hw in order)}, samples_per_gpu '
            f'{cfg.data.train_dataloader.samples_per_gpu} in chunks of '
            f'{cfg.train_cfg.grad_accum_batch_size}, the native Qwen2.5-VL-7B '
            f'decoder cut to {PRETRAINED_QWEN_TEXT_LAYERS} layers inside the '
            f'loss): ok | params (trainable, frozen) '
            f'{params.groups() if params else "not logged"} | '
            + ' ; '.join(f'iter {r["iter"]}: loss {r["loss"]:.5e}, grad norm '
                         f'{r["diffusion_grad_norm"]:.4e}, skipped '
                         f'{r.get("diffusion_skipped")}' for r in rows)
            + f' | child {wall:.1f} s')
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# around a training run (phases 34-37): the evaluation hook's image and CLIP
# branch, the export served back, ControlNet and fill, the tools, the UI
# ---------------------------------------------------------------------------

# phase 34: two prompts, their seeded embeds standing for the cache
# records' (no T5-XXL is loaded); CLIP ViT-L/14's vision tower and
# projection at their published widths (the text tower is CLIP_L)
EVAL_PROMPTS = [PROMPT, 'a serene mountain lake at sunrise']
CLIP_L_VISION = dict(hidden_size=1024, intermediate_size=4096,
                     num_hidden_layers=24, num_attention_heads=16,
                     image_size=224, patch_size=14, hidden_act='quick_gelu')
CLIP_L_PROJECTION = 768
EVAL_LATENT = 128                 # the config's latent_shape: 1024^2 images
# phase 35: the image served from the exported adapter against the
# EvalHook's image from the EMA weights, max |d| over [0, 1] pixels. Both
# run the same modules, weights (the EMA, fp32, written and read as fp32),
# noise (the same generator seed and draw) and ops, so they are expected to
# be bitwise; the bound only admits a different reduction order in a
# cuBLAS call, which moves a bf16 trunk's pixels by a few 1e-3. An export
# that loses a tensor or a layout moves them by O(1e-1) at these weights.
EXPORT_IMAGE_ATOL = 2e-2
# phase 36: ControlNet residuals as a FLUX ControlNet gives them (5 joint,
# 10 single samples at the image tokens' width), scaled to a tenth of the
# residual stream's rms at random weights; the FLUX.1-Fill-dev input width
CN_JOINT, CN_SINGLE, CN_SCALE = 5, 10, 0.1
FILL_IN_CHANNELS = 384
# phase 37: the ImageNet cacher on a few seeded 256^2 images of 2 classes,
# and validate_toy_e2e's own flags: the run lengths of
# tests/test_e2e_checkerboard.py (3000 flow + 800 distillation
# iterations) and its 2-NFE bar, 0.5, at the configs' widths. Samples of
# noise read about 0.23 (the share of a standard normal inside the board's
# white squares); runs of 400 or fewer distillation iterations (the
# teacher ratio decays over 500) read 0.49-0.52 on a CPU, too near the bar
SDVAE_IMAGES, SDVAE_SIZE = (3, 2), 256
TOY_VALIDATE_FLAGS = ['--flow-iters', '3000', '--distill-iters', '800',
                      '--num-samples', '4096', '--bar', '0.5']


def write_clip_folder(root, generator, tok):
    """A CLIP-L folder at ``openai/clip-vit-large-patch14``'s widths (text
    768 x 12 layers, vision 1024 x 24 layers, patch 14 at 224, projection
    768), random fp32 weights from ``generator``, the toy BPE tokenizer's
    vocabulary with CLIP's two special tokens, and CLIP's image processor:
    what ``CLIPProcessor`` / ``CLIPModel.from_pretrained`` read. Loads it
    once, so a folder they refuse fails here with its error (``clip_score``
    turns any load error into None)."""
    import transformers
    cfg = transformers.CLIPConfig(
        text_config={k: v for k, v in CLIP_L.items()
                     if k != 'projection_dim'},
        vision_config=CLIP_L_VISION, projection_dim=CLIP_L_PROJECTION)
    with torch.device('cuda'):
        model = transformers.CLIPModel(cfg)
    randomize_(model, generator)
    model.save_pretrained(root)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    tok.backend_tokenizer.model.save(root)
    with open(os.path.join(root, 'vocab.json')) as f:
        vocab = json.load(f)
    for special in ('<|startoftext|>', '<|endoftext|>'):
        vocab.setdefault(special, len(vocab))
    write_json(os.path.join(root, 'vocab.json'), vocab)
    write_json(os.path.join(root, 'tokenizer_config.json'), dict(
        tokenizer_class='CLIPTokenizer', bos_token='<|startoftext|>',
        eos_token='<|endoftext|>', unk_token='<unk>',
        pad_token='<|endoftext|>', model_max_length=77))
    side = CLIP_L_VISION['image_size']
    transformers.CLIPImageProcessor(
        size={'shortest_edge': side},
        crop_size={'height': side, 'width': side}).save_pretrained(root)
    processor = transformers.CLIPProcessor.from_pretrained(
        root, local_files_only=True)
    ids = processor(text=EVAL_PROMPTS, return_tensors='pt',
                    padding=True)['input_ids']
    return n_params, tuple(ids.shape)


class EvalProbe(Hook):
    """Around ``EvalHook`` (priority 60) and the TensorBoard and wandb
    hooks (90) that log its score: at 59 the time and a zeroed attention
    count; at 91 the seconds of the evaluation and its logging, its K1
    launches (zeroed again, so the training iterations' counts stay
    theirs) and the logged CLIP score, and, before the run, the seconds of
    the hooks' ``before_run`` in between (``wandb.init``); with ``spy``,
    the images ``val_step`` returned."""

    def __init__(self, priority, before=None):
        self.priority = priority
        self.before = before
        self.rows = []
        self.images = None

    def before_run(self, runner):
        self.t = time.perf_counter()
        if self.before is not None:
            self.init_s = self.t - self.before.t

    def after_train_iter(self, runner):
        torch.cuda.synchronize()
        if self.before is None:
            attn.LAUNCHES = 0
            self.t = time.perf_counter()
            return
        self.rows.append(dict(iter=runner.iter,
                              s=time.perf_counter() - self.before.t,
                              launches=attn.LAUNCHES,
                              clip_score=runner.log_buffer.get(
                                  'eval_clip_score')))
        attn.LAUNCHES = 0

    def spy(self, val_step):
        def wrapped(*args, **kwargs):
            out = val_step(*args, **kwargs)
            self.images = out['pred_imgs']
            return out
        return wrapped


def check_eval_outputs(work, probe, n_blocks, jsonl_fallback):
    """Phase 34's checks of the run's artifacts; their summary."""
    from PIL import Image
    per_eval = 2 * n_blocks
    if [r['launches'] for r in probe.rows] != [per_eval] * len(probe.rows):
        raise AssertionError(f'evaluation K1 launches '
                             f'{[r["launches"] for r in probe.rows]}, want '
                             f'{per_eval} per evaluation')
    scores = [r['clip_score'] for r in probe.rows]
    if not all(isinstance(x, float) and math.isfinite(x) for x in scores):
        raise AssertionError(f'eval_clip_score {scores}: missing or not '
                             f'finite')
    grid = np.asarray(Image.open(os.path.join(
        work, 'eval', f'iter_{probe.rows[-1]["iter"]}.png')))
    n = len(EVAL_PROMPTS)
    h = 8 * EVAL_LATENT
    if tuple(probe.images.shape) != (n, h, h, 3) or grid.shape != (h, h * n,
                                                                   3):
        raise AssertionError(f'eval images {tuple(probe.images.shape)}, '
                             f'grid {grid.shape}: want {n} images of {h} x '
                             f'{h}')
    want = np.clip(probe.images.float().cpu().numpy() * 255 + 0.5, 0,
                   255).astype(np.uint8)
    for i in range(n):
        if not np.array_equal(grid[:, h * i:h * (i + 1)], want[i]):
            raise AssertionError(f'grid cell {i} is not the evaluation\'s '
                                 f'image {i}')
    jsonl = [json.loads(x) for x in open(os.path.join(work,
                                                      'metrics.jsonl'))]
    if jsonl_fallback and not any('eval_clip_score' in r for r in jsonl):
        raise AssertionError('the wandb fallback wrote no eval_clip_score '
                             'to metrics.jsonl')
    events = [f for f in os.listdir(os.path.join(work, 'tf_logs'))] \
        if os.path.isdir(os.path.join(work, 'tf_logs')) else []
    return dict(scores=scores, s=[r['s'] for r in probe.rows],
                launches=sum(r['launches'] for r in probe.rows),
                grid=grid.shape, jsonl_lines=len(jsonl),
                tf_events=len(events))


def phase_export(run, work, ckpt_dir, probe, eval_batch):
    """Phase 35: ``python -m arcflow_tpu_torch.export_arcflow_to_diffusers``
    on phase 11r's checkpoint; an ``ArcFluxPipeline`` on the student's own
    modules (shared, not copied) with the exported adapter loaded; its
    image from the last evaluation's generator seed against the
    EvalHook's; ``tools.save_inference_weights`` on the same checkpoint."""
    from safetensors import safe_open

    from arcflow_tpu_torch.tools.save_inference_weights import \
        save_inference_weights
    out = os.path.join(work, 'export')
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-m', 'arcflow_tpu_torch.export_arcflow_to_diffusers',
         FLUX_TRAIN_CONFIG, ckpt_dir, out], capture_output=True, text=True,
        timeout=600)
    export_s = time.perf_counter() - t
    if res.returncode != 0:
        raise AssertionError(f'the export exited {res.returncode}:\n'
                             f'{(res.stdout + res.stderr)[-3000:]}')
    adapter = os.path.join(out, 'diffusion_pytorch_model.safetensors')
    export_bytes = os.path.getsize(adapter)
    with safe_open(adapter, framework='pt') as f:
        policy = json.loads(f.metadata()['policy_config'])
        n_export = sum(math.prod(f.get_slice(k).get_shape())
                       for k in f.keys())
    if n_export != FLUX_TRAIN_PARAMS[0]:
        raise AssertionError(f'exported {n_export} parameters, want the '
                             f'adapter\'s {FLUX_TRAIN_PARAMS[0]}')
    config = json.load(open(os.path.join(out, 'config.json')))
    if config.get('_class_name') != 'ArcFluxTransformer2DModel' \
            or 'pretrained' in config:
        raise AssertionError(f'exported config.json {config}')
    model = run['model']
    pipe = ArcFluxPipeline(model.diffusion.denoising, vae=model.vae)
    pipe.load_arcflow_adapter(adapter)
    if pipe.diffusion.test_cfg['nfe'] != policy['nfe']:
        raise AssertionError(f'policy {policy} not applied')
    seed = probe.rows[-1]['iter']
    embeds = dict(eval_batch['prompt_embed_kwargs'])
    attn.LAUNCHES = 0                    # the served image's counted run
    served, serve_s = synced(lambda: pipe(
        prompt_embeds=embeds, height=8 * EVAL_LATENT, width=8 * EVAL_LATENT,
        generator=torch.Generator(device='cuda').manual_seed(seed),
        output_type='pt')['images'])
    launches = attn.LAUNCHES
    n_blocks = run['n_blocks']
    if launches != 2 * n_blocks:
        raise AssertionError(f'served image: {launches} K1 launches, want '
                             f'{2 * n_blocks}')
    diff = (served - probe.images).abs().max().item()
    if diff > EXPORT_IMAGE_ATOL or not torch.isfinite(served).all():
        raise AssertionError(f'the image served from the exported adapter '
                             f'differs from the EvalHook image by {diff} '
                             f'(bound {EXPORT_IMAGE_ATOL})')
    weights = os.path.join(work, 'inference.safetensors')
    n_inf, inf_s = synced(lambda: save_inference_weights(ckpt_dir, weights))
    return dict(export_s=export_s, export_bytes=export_bytes,
                policy=policy, max_abs=diff,
                bitwise=torch.equal(served, probe.images), serve_s=serve_s,
                launches=launches, inference_params=n_inf,
                inference_bytes=os.path.getsize(weights), inference_s=inf_s)


def controlnet_samples(generator, n, tokens, width, scale=CN_SCALE):
    """``n`` ControlNet residuals (1, tokens, width) in bf16."""
    return [scale * torch.randn(1, tokens, width, generator=generator,
                                device='cuda', dtype=torch.bfloat16)
            for _ in range(n)]


def fill_inputs(generator, h=128, w=128):
    """Flux-fill's inputs: masked-image latents (1, h, w, 16) and the pixel
    mask of each latent cell, 8 x 8 pixels -> 64 channels (1, h, w, 64), of
    one rectangle (a random 0/1 mask would not be an inpainting mask)."""
    masked = torch.randn(1, h, w, 16, generator=generator, device='cuda')
    pixels = torch.zeros(8 * h, 8 * w, device='cuda')
    pixels[8 * h // 4:8 * h // 2, 8 * w // 8:8 * w * 5 // 8] = 1.0
    mask = pixels.reshape(h, 8, w, 8).permute(0, 2, 1, 3).reshape(1, h, w,
                                                                  64)
    return masked, mask


def phase_controlnet_fill(flux_run):
    """Phase 36, on phase 6's FLUX-12B pipeline (before phase 21 quantizes
    it): a 2-NFE image with ControlNet residuals on the interval map, then
    on the repeat map, and one with the Flux-fill inputs through a
    temporary 384-wide ``x_embedder``; each finite, off the plain image,
    114 K1 launches; then 2 + 2-block reductions of each against the plain
    attention."""
    pipe, embeds, latents, lat_plain, _ = flux_run
    model = pipe.transformer
    g = torch.Generator(device='cuda').manual_seed(SEED + 36)
    _, lh, lw, _ = latents.shape
    tokens = (lh // 2) * (lw // 2)
    joint = controlnet_samples(g, CN_JOINT, tokens, model.inner_dim)
    single = controlnet_samples(g, CN_SINGLE, tokens, model.inner_dim)
    n_blocks = FLUX_12B['num_layers'] + FLUX_12B['num_single_layers']
    rows = {}
    _, plain_s = synced(lambda: pipe(prompt_embeds=embeds, latents=latents,
                                     output_type='latent'))

    def image(label, extra):
        attn.LAUNCHES = 0                   # this path's counted run
        lat, s = synced(lambda: pipe(prompt_embeds=dict(embeds, **extra),
                                     latents=latents,
                                     output_type='latent')['latents'])
        launches = attn.LAUNCHES
        with torch.inference_mode():
            img = (pipe.vae.decode(lat) / 2 + 0.5).clamp(0.0, 1.0)
        check_image(img)
        moved = rel_l2(lat, lat_plain)
        if launches != 2 * n_blocks or moved < 1e-2:
            raise AssertionError(f'{label}: {launches} K1 launches (want '
                                 f'{2 * n_blocks}), latents off the plain '
                                 f'image by {moved:.3e} rel L2')
        rows[label] = dict(s=s, launches=launches, moved=moved)

    for repeat in (False, True):
        image('controlnet_repeat' if repeat else 'controlnet_interval',
              dict(controlnet_block_samples=joint,
                   controlnet_single_block_samples=single,
                   controlnet_blocks_repeat=repeat))
    masked, mask = fill_inputs(g, lh, lw)
    served = model.x_embedder
    with torch.device('cuda'):
        wide = LoRADense(FILL_IN_CHANNELS, served.out_features,
                         dtype=torch.bfloat16)
    randomize_(wide, g)
    model.x_embedder = wide
    try:
        image('fill', dict(masked_image_latents=masked, mask=mask))
    finally:
        model.x_embedder = served
    del joint, single, wide
    # the 2 + 2-block reductions at full width against the plain attention
    with torch.device('cuda'):
        small = ArcFluxTransformer2DModel(
            dtype=torch.bfloat16, **dict(FLUX_12B, num_layers=2,
                                         num_single_layers=2))
    randomize_(small, g)
    x = torch.randn(latents.shape, generator=g, device='cuda')
    kw = dict(embeds, t=torch.full((1,), 0.7, device='cuda'),
              guidance=torch.full((1,), 3.5, device='cuda'))
    reduced = {}
    for repeat in (False, True):
        reduced['controlnet_repeat' if repeat else 'controlnet_interval'] = \
            reduced_vs_plain(
                'phase 36 ControlNet reduction', small, x, dict(
                    kw, controlnet_block_samples=controlnet_samples(
                        g, 3, tokens, small.inner_dim),
                    controlnet_single_block_samples=controlnet_samples(
                        g, 2, tokens, small.inner_dim),
                    controlnet_blocks_repeat=repeat))[0]
    with torch.device('cuda'):
        small.x_embedder = LoRADense(FILL_IN_CHANNELS, small.inner_dim,
                                     dtype=torch.bfloat16)
    randomize_(small.x_embedder, g)
    reduced['fill'] = reduced_vs_plain(
        'phase 36 fill reduction', small, x,
        dict(kw, masked_image_latents=masked, mask=mask))[0]
    del small
    log(f'phase 36 FLUX-12B ControlNet and fill (phase 6 pipeline, 2-NFE '
        f'1024x1024 + decode): ok | ControlNet {CN_JOINT} joint samples '
        f'(interval map: blocks 4 per sample; repeat map: i % {CN_JOINT}) + '
        f'{CN_SINGLE} single samples (1, {tokens}, {model.inner_dim}) bf16 '
        f'at {CN_SCALE} | '
        f'fill: masked-image latents + 8 x 8 pixel mask per cell through a '
        f'{FILL_IN_CHANNELS}-wide x_embedder | ' + ' ; '.join(
            f'{k}: {r["s"]:.4f} s per image without the decode (plain '
            f'{plain_s:.4f} s), K1 {r["launches"]}, latents off the plain '
            f'image by '
            f'{r["moved"]:.3e} rel L2' for k, r in rows.items())
        + ' | 2 + 2-block reductions, K1 vs plain means rel L2: '
        + ', '.join(f'{k} {v:.3e}' for k, v in reduced.items())
        + f' (bound {SLICE_REL_L2})')
    return {k: r['launches'] for k, r in rows.items()}


def ui_callback(pipe, n_blocks, size=1024):
    """Phase 37's UI part, on phase 24's pipeline with its text towers:
    ``ui.gradio_app.generate`` (gradio not needed) for one 1024^2 image,
    against the pipeline called directly with the generator it seeds."""
    from arcflow_tpu_torch.ui import gradio_app
    seed = SEED + 37
    attn.LAUNCHES = 0                       # the callback's counted run
    imgs, s = synced(lambda: gradio_app.generate(
        pipe, PROMPT, size, size, 2, 1.0, 3.5, seed, 1))
    launches = attn.LAUNCHES
    if launches != 2 * n_blocks or len(imgs) != 1 or \
            imgs[0].shape != (size, size, 3) or not np.isfinite(
                imgs[0]).all():
        raise AssertionError(f'UI callback: {len(imgs)} images '
                             f'{[i.shape for i in imgs]}, {launches} K1 '
                             f'launches')
    direct = pipe(prompt=[PROMPT], height=size, width=size,
                  generator=torch.Generator(device='cuda').manual_seed(seed),
                  output_type='np')['images']
    if not np.array_equal(direct[0], imgs[0]):
        raise AssertionError('the UI callback\'s image is not the '
                             'pipeline\'s for the same seed')
    return dict(s=s, launches=launches)


def start_toy_validation():
    """Phase 37's ``python -m arcflow_tpu_torch.tools.validate_toy_e2e``
    with TOY_VALIDATE_FLAGS on the card, in a process of its own, started
    with phases 32-33's child and run alongside phases 28r-30, 26 and 23:
    both toys are launch-bound and hold the card a small share of the
    time, and in turn they took about 150 s of the smoke's 1200.
    ``finish_toy_validation`` collects it."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix='toy-validate-', dir=_build.BUILD_DIR)
    out = open(os.path.join(work, 'out.log'), 'w')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'arcflow_tpu_torch.tools.validate_toy_e2e',
         '--work-dir', os.path.join(work, 'run'), '--device', 'cuda',
         *TOY_VALIDATE_FLAGS], stdout=out, stderr=subprocess.STDOUT)
    return dict(proc=proc, work=work, out=out, t=time.perf_counter())


def stop_toy_validation(toy):
    """End the validation's process if it still runs; remove its files."""
    if toy['proc'].poll() is None:
        toy['proc'].kill()
        toy['proc'].wait()
    toy['out'].close()
    shutil.rmtree(toy['work'], ignore_errors=True)


def finish_toy_validation(toy):
    """Wait for the validation: (its 2-NFE in-support share, the seconds
    from its start). Fails unless it exits 0 with VALIDATION OK."""
    try:
        rc = toy['proc'].wait(timeout=TOY_CLI_TIMEOUT)
        wall = time.perf_counter() - toy['t']
        toy['out'].close()
        with open(os.path.join(toy['work'], 'out.log')) as f:
            text = f.read()
    finally:
        stop_toy_validation(toy)
    m = re.search(r'2-NFE in-support: ([0-9.]+)%', text)
    if rc != 0 or m is None or 'VALIDATION OK' not in text:
        raise AssertionError(f'validate_toy_e2e exited {rc}:\n'
                             f'{text[-3000:]}')
    return float(m.group(1)) / 100, wall


def phase_tools(toy):
    """Phase 37's tools that compute on the card: validate_toy_e2e with
    its own flags (started by ``start_toy_validation``); the SD-VAE latent
    cacher on seeded images, read back by ``ImageNet``. The prompt cacher
    writes zstd, which this machine may lack: it is held on the CPU by the
    tests and not run here."""
    import importlib.util

    from PIL import Image

    from arcflow_tpu_torch.data import ImageNet, collate
    from arcflow_tpu_torch.tools import cache_imagenet_data_sdvae as sdvae
    share, toy_s = finish_toy_validation(toy)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix='tools-', dir=_build.BUILD_DIR)
    rng = np.random.default_rng(SEED + 37)
    try:
        images = os.path.join(work, 'images')
        for ci, n in enumerate(SDVAE_IMAGES):
            os.makedirs(os.path.join(images, f'n{ci:08d}'))
            for j in range(n):
                Image.fromarray(rng.integers(
                    0, 256, (SDVAE_SIZE + 40 * j, SDVAE_SIZE + 24, 3),
                    np.uint8)).save(os.path.join(images, f'n{ci:08d}',
                                                 f'{j}.png'))
        out = os.path.join(work, 'latents')
        _, cache_s = synced(lambda: sdvae.main(
            ['--image-dir', images, '--out', out, '--image-size',
             str(SDVAE_SIZE), '--batch', '4', '--device', 'cuda']))
        ds = ImageNet(image_dir=images, image_size=SDVAE_SIZE)
        vae = sdvae.build_encoder('cuda')
        with torch.inference_mode():
            want = vae.encode(torch.from_numpy(collate(
                [ds[i] for i in range(len(ds))])['images']).cuda() * 2 - 1
                              ).float().cpu().numpy()
        del vae
        got = ImageNet(latents_dir=out)
        c = sdvae.LATENT_CHANNELS
        err = 0.0
        for i in range(len(ds)):
            item = got[i]
            if item['latents'].shape != (SDVAE_SIZE // 8, SDVAE_SIZE // 8,
                                         c) or item['label'] != \
                    ds[i]['label']:
                raise AssertionError(f'record {i}: {item["latents"].shape}, '
                                     f'label {item["label"]}')
            err = max(err, float(np.abs(item['latents'] - want[i]).max()))
        if not err <= 1e-3 * max(1.0, float(np.abs(want).max())):
            raise AssertionError(f'cached latents off the encoder by {err}')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    zstd = importlib.util.find_spec('zstandard') is not None
    log(f'phase 37 tools on the card: ok | cache_imagenet_data_sdvae: '
        f'{len(ds)} seeded images of {len(SDVAE_IMAGES)} classes, ADM crop '
        f'to {SDVAE_SIZE}^2, SD-VAE encoder (4 channels, scale 0.18215, '
        f'random from seed 0) on the card in {cache_s:.3f} s, records read '
        f'back by ImageNet as ({SDVAE_SIZE // 8}, {SDVAE_SIZE // 8}, {c}) '
        f'channel-last with their labels, '
        f'max |d| against the encoder {err:.3e} | python -m '
        f'arcflow_tpu_torch.tools.validate_toy_e2e '
        f'{" ".join(TOY_VALIDATE_FLAGS)}: VALIDATION OK, 2-NFE in-support '
        f'{share:.4f}, {toy_s:.1f} s of command alongside phase 23 | '
        f'cache_image_prompt_data: not run on the card (it writes zstd '
        f'records; zstandard importable here: {zstd}); held against JAX\'s '
        f'ImagePrompt on the CPU by tests/test_torch_export_tools.py')
    return dict(cache_s=cache_s, toy_s=toy_s, toy_share=share)


# ---------------------------------------------------------------------------
# the frozen weights' placement and the native loader (phases 43-45 in a
# child process; --ranks 4 --placement-only)
# ---------------------------------------------------------------------------

FASTLOADER_RECORDS = 8
# what ``zstd.h`` defines for ZSTD_CCtx_setParameter
ZSTD_C_COMPRESSION_LEVEL, ZSTD_C_CONTENT_SIZE_FLAG = 100, 200
# phase 44: each shipped quantized-trunk config at reduced depth through
# train_model over data=1, fsdp=-1 (FSDP2 at world size 1) against the same
# config without a mesh: (name, config, depth of the student and teacher)
TRUNK_FSDP = (('flux_int8', 'configs/flux/arcflux_2nfe_k16_int8trunk.py',
               dict(num_layers=1, num_single_layers=2)),
              ('flux_int4', 'configs/flux/arcflux_2nfe_k16_int4trunk.py',
               dict(num_layers=1, num_single_layers=2)),
              ('qwen_int8', QWEN_TRAIN_CONFIG, dict(num_layers=2)))
# phase 44b: FLUX w8a8 at full width and this depth, its units and int8
# kernels sharded by shard_units at world size 1
W8A8_FSDP_DEPTH = dict(num_layers=1, num_single_layers=2)
# phase 45: FLUX at full width and this depth on LocalPipe(2); 2 divides
# both stacks, so both are pipelined
PIPE_SERVE_DEPTH = dict(num_layers=2, num_single_layers=4)
PLACEMENT_TIMEOUT = 600


def zstd_available():
    """(zstd.h found by g++, libzstd's path or None)."""
    import ctypes.util
    gxx = shutil.which('g++')
    header = gxx is not None and subprocess.run(
        [gxx, '-E', '-x', 'c++', '-'], input='#include <zstd.h>\n',
        capture_output=True, text=True).returncode == 0
    return header, ctypes.util.find_library('zstd')


def zstd_frame(lib, payload, content_size):
    """``payload`` in one zstd frame made by libzstd (``lib``, ctypes): with
    its content size in the header (the loader's bounded path) or without
    (as a streaming compressor writes it: the loader's streaming path)."""
    import ctypes
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_compressBound.restype = size_t
    lib.ZSTD_compressBound.argtypes = [size_t]
    lib.ZSTD_createCCtx.restype = vp
    lib.ZSTD_freeCCtx.argtypes = [vp]
    lib.ZSTD_CCtx_setParameter.restype = size_t
    lib.ZSTD_CCtx_setParameter.argtypes = [vp, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_compress2.restype = size_t
    lib.ZSTD_compress2.argtypes = [vp, vp, size_t, vp, size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [size_t]
    cap = lib.ZSTD_compressBound(len(payload))
    dst = ctypes.create_string_buffer(cap)
    cctx = lib.ZSTD_createCCtx()
    try:
        for param, value in ((ZSTD_C_COMPRESSION_LEVEL, 3),
                             (ZSTD_C_CONTENT_SIZE_FLAG, int(content_size))):
            if lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, param,
                                                           value)):
                raise AssertionError(f'ZSTD_CCtx_setParameter({param})')
        n = lib.ZSTD_compress2(cctx, dst, cap, payload, len(payload))
        if lib.ZSTD_isError(n):
            raise AssertionError('ZSTD_compress2 failed')
    finally:
        lib.ZSTD_freeCCtx(cctx)
    return dst.raw[:n]


def write_prompt_cache(root, n, lib, generator):
    """An ``ImagePrompt`` cache of ``n`` records as
    ``tools/cache_image_prompt_data.py`` writes them (a pickled dict of CPU
    tensors per prompt: T5 embeds (512, 4096) and pooled CLIP 768 in bf16,
    the VAE latents (16, 128, 128) fp32), compressed by libzstd, every
    other frame without its content size; returns the records."""
    import pickle
    os.makedirs(os.path.join(root, 'cache'), exist_ok=True)
    records = []
    with open(os.path.join(root, 'datalist.jsonl'), 'w') as f:
        for i in range(n):
            emb = flux_inputs(generator)
            rec = dict(prompt=f'{PROMPT} {i}', prompt_embed_kwargs={
                k: v[0].cpu() for k, v in emb.items()},
                latents=torch.randn(16, 128, 128, generator=generator,
                                    device='cuda').cpu())
            name = f'rec{i:04d}'
            with open(os.path.join(root, 'cache', f'{name}.zst'),
                      'wb') as z:
                z.write(zstd_frame(lib, pickle.dumps(rec), i % 2 == 0))
            f.write(json.dumps({'name': name}) + '\n')
            records.append(rec)
    return records


def phase_fastloader():
    """Phase 43: the native loader on the card's machine: where g++ finds
    zstd.h it must build (a failure fails the smoke) and
    ``ImagePrompt.getitems`` must decode a written cache through it, every
    array bitwise the record's; where zstd.h or libzstd is missing the
    phase says it did not run, and why."""
    import ctypes
    from arcflow_tpu_torch.data import ImagePrompt
    from arcflow_tpu_torch.data import _fastloader as fastloader
    header, libpath = zstd_available()
    zstandard = importlib.util.find_spec('zstandard') is not None
    if not header or libpath is None:
        fast = fastloader.get_fastloader()
        if fast is not None:
            raise AssertionError('the loader built without zstd.h')
        log(f'phase 43 the native loader: did not run | zstd.h found by '
            f'g++: {header}, libzstd: {libpath}, zstandard: {zstandard} | '
            f'get_fastloader() is None: {fastloader.unavailable_reason()}')
        return dict(ran=False, header=header, lib=libpath)
    t = time.perf_counter()
    fast = fastloader.get_fastloader()
    build_s = time.perf_counter() - t
    if fast is None:
        raise AssertionError(f'zstd.h and libzstd are here but the loader '
                             f'did not build: '
                             f'{fastloader.unavailable_reason()}')
    work = tempfile.mkdtemp(prefix='fastloader-', dir=_build.BUILD_DIR)
    try:
        g = torch.Generator(device='cuda').manual_seed(SEED + 43)
        records = write_prompt_cache(work, FASTLOADER_RECORDS,
                                     ctypes.CDLL(libpath), g)
        ds = ImagePrompt(cache_dir=os.path.join(work, 'cache'),
                         datalist_path=os.path.join(work, 'datalist.jsonl'),
                         latent_size=(128, 128, 16))
        batches = []
        real = fast.load_batch

        class Counted:
            def load_batch(self, paths, **kw):
                batches.append(len(paths))
                return real(paths, **kw)
        with mock.patch.object(fastloader, 'get_fastloader',
                               lambda: Counted()):
            items = ds.getitems(range(FASTLOADER_RECORDS))
        if batches != [FASTLOADER_RECORDS]:
            raise AssertionError(f'getitems read batches {batches}')
        for item, rec in zip(items, records):
            pek = item['prompt_embed_kwargs']
            want = {k: v.float().numpy()
                    for k, v in rec['prompt_embed_kwargs'].items()}
            if item['name'] != rec['prompt'] or any(
                    not np.array_equal(pek[k], w) for k, w in want.items()) \
                    or not np.array_equal(item['latents'], np.moveaxis(
                        rec['latents'].numpy(), 0, -1)):
                raise AssertionError(f'item {item["ids"]} differs from its '
                                     f'record')
        paths = [ds._record_path(i) for i in range(FASTLOADER_RECORDS)]
        raw_mb = sum(os.path.getsize(p) for p in paths) / 1e6
        out_mb = sum(len(b) for b in fast.load_batch(paths)) / 1e6
        times = []
        for _ in range(3):
            t = time.perf_counter()
            fast.load_batch(paths)
            times.append(time.perf_counter() - t)
        t = time.perf_counter()
        ds.getitems(range(FASTLOADER_RECORDS))
        items_s = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f'phase 43 the native loader: ok | zstd.h found by g++, libzstd '
        f'{libpath}, zstandard installed: {zstandard} | built in '
        f'{build_s:.2f} s into {fastloader.library_path().name} | '
        f'ImagePrompt.getitems decoded {FASTLOADER_RECORDS} records (FLUX '
        f'embeds 512 x 4096 + 768 bf16, latents 16 x 128 x 128 fp32; half '
        f'the frames without their content size) in one batch, every array '
        f'bitwise its record | load_batch of {raw_mb:.1f} MB of frames to '
        f'{out_mb:.1f} MB, warm file cache: '
        + ', '.join(f'{x * 1e3:.1f}' for x in times)
        + f' ms ({out_mb / min(times):.0f} MB/s); getitems with unpickling '
        f'{items_s * 1e3:.1f} ms')
    return dict(ran=True, build_s=build_s, load_ms=[x * 1e3 for x in times],
                mb=out_mb, getitems_ms=items_s * 1e3)


def cut_depth(cfg, depth):
    """``cfg``'s student and teacher at ``depth`` (block counts)."""
    cfg.merge_from_dict({f'model.{k}.denoising.{f}': v
                         for k in ('diffusion', 'teacher')
                         for f, v in depth.items()})
    return cfg


def quant_params(model):
    """{name: tensor} of the student trunk's frozen int8 / int4 kernels and
    scales (``utils/quantize.py:QUANT_NAMES``)."""
    from arcflow_tpu_torch.utils.quantize import QUANT_NAMES
    return {n: b for n, b in model.diffusion.denoising.named_buffers()
            if n.rsplit('.', 1)[-1] in QUANT_NAMES}


def local_bytes(tensors):
    """Bytes of the storage the local parts of ``tensors`` hold (unique
    storages, so a part that kept its whole tensor alive counts whole)."""
    return sum({local(t).untyped_storage().data_ptr():
                local(t).untyped_storage().nbytes()
                for t in tensors}.values())


def phase_trunk_fsdp():
    """Phase 44: each of ``TRUNK_FSDP`` at reduced depth and full width
    through ``train_model`` over data=1, fsdp=-1 (FSDP2 at world size 1,
    in a process group of one) against the same config without a mesh:
    the int8 / int4 kernels and their scales sharded beside FSDP2's units
    (``parallel/fsdp.py:_QuantShards``: DTensor buffers, each unit's
    gathered in one all-gather of bytes), sharded again after the step
    (its checkpointed blocks' recompute put them back), the launches per
    iteration, the loss and
    (FLUX: ``IterLogs`` reads ``TEMB_UPSTREAM``) the timestep embedder's
    gradients within TRAIN_SLICE_REL_L2 of the run without a mesh, the
    quantized trunk unchanged by the step."""
    work = tempfile.mkdtemp(prefix='trunk-fsdp-', dir=_build.BUILD_DIR)
    setup_distributed()
    res = {}
    try:
        for name, path, depth in TRUNK_FSDP:
            ref = mesh_train_run(cut_depth(mesh_train_config(
                path, 1, 0, unsharded=True), depth),
                os.path.join(work, f'{name}-ref'), SEED + 44,
                keep_first=True)
            ref_loss, ref_grads = ref['rows'][0]['loss'], ref['grads']
            ref_quant = {n: p.detach().clone()
                         for n, p in quant_params(ref['model']).items()}
            del ref
            gc.collect()
            torch.cuda.empty_cache()
            cfg = cut_depth(mesh_train_config(path, 1, 0,
                                              mesh=dict(data=1, fsdp=-1)),
                            depth)
            run = mesh_train_run(cfg, os.path.join(work, name), SEED + 44,
                                 keep_first=True)
            quant = quant_params(run['model'])
            n_blocks = sum(depth.values())
            want = (TRAIN_FORWARDS * n_blocks, TRAIN_BACKWARDS * n_blocks, 0)
            loss = run['rows'][0]['loss']
            grads = {n: rel_l2(g, ref_grads[n])
                     for n, g in run['grads'].items()}
            x = dict(
                launches=run['launches'][0], want=want, loss=loss,
                ref_loss=ref_loss, loss_rel=abs(loss - ref_loss)
                / abs(ref_loss), grad_rel=grads, n_quant=len(quant),
                dtypes=sorted({str(p.dtype) for p in quant.values()}),
                # read after the iteration: the checkpointed blocks'
                # recompute put their gathered kernels back
                sharded=all(is_sharded(p) for p in quant.values()),
                same_values=all(torch.equal(p.full_tensor(), ref_quant[n])
                                for n, p in quant.items()),
                quant_gib=local_bytes(quant.values()) / 2 ** 30,
                s_per_iter=run['s_per_iter'][0], peak_gib=run['peak_gib'])
            if x['launches'] != want or not x['n_quant'] \
                    or not x['sharded'] or not x['same_values'] \
                    or not math.isfinite(loss) \
                    or x['loss_rel'] > TRAIN_SLICE_REL_L2 or grads \
                    and max(grads.values()) > TRAIN_SLICE_REL_L2:
                raise AssertionError(f'phase 44 {name}: {x}')
            res[name] = x
            del run, quant, ref_quant
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
        dist.destroy_process_group()
    for name, path, depth in TRUNK_FSDP:
        x = res[name]
        log(f'phase 44 {name} trunk under FSDP2 ({path} through train_model, '
            f'parallel.mesh data=1, fsdp=-1 on one card; cuts: depth '
            f'{depth}, phase 31\'s others): ok | {x["n_quant"]} quantized '
            f'kernels and scales ({", ".join(x["dtypes"])}) sharded beside '
            f'FSDP2\'s units (DTensor buffers), {x["quant_gib"]:.3f} GiB, '
            f'unchanged by the step | launches per iteration (K1/K2, K3, K4) {x["launches"]} '
            f'| first loss {x["loss"]:.6e} against {x["ref_loss"]:.6e} '
            f'without a mesh (rel {x["loss_rel"]:.3e}), timestep embedder '
            f'gradients rel L2 ' + (', '.join(
                f'{v:.3e}' for v in x['grad_rel'].values()) or 'not read')
            + f' (bound {TRAIN_SLICE_REL_L2}) | s per iteration '
            f'{x["s_per_iter"]:.4f}, peak {x["peak_gib"]:.2f} GiB')
    return res


def phase_w8a8_fsdp():
    """Phase 44b: FLUX w8a8 (phase 21's mode) at full width and
    ``W8A8_FSDP_DEPTH`` (bf16, random weights) served 2-NFE at 1024^2
    with its units sharded by ``parallel/fsdp.py:shard_units`` over a
    (data 1, fsdp 1) mesh in a process group of one, against the same
    pipeline unsharded: each unit's int8 kernels come back from the
    gather column-major, as the int8 product reads them, so the latents
    are those of the live kernels. The K1 launches of the counted run,
    the kernels sharded before and after it. Both calls run under
    ``no_grad`` in place of the pipeline's ``inference_mode``: FSDP2 at
    world size 1 reads its gathered parameters' version counters, which
    inference tensors lack (torch 2.13 on the CPU); over more ranks
    ``shard`` serves under ``inference_mode``."""
    from torch.distributed.device_mesh import init_device_mesh
    from arcflow_tpu_torch.parallel.fsdp import shard_units
    g = torch.Generator(device='cuda').manual_seed(SEED + 46)
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(
            dtype=torch.bfloat16, **dict(FLUX_12B, **W8A8_FSDP_DEPTH))
    randomize_(model, g)
    pipe = ArcFluxPipeline(model)
    n_quant = pipe.quantize_int8(act_quant=True)
    embeds = flux_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device='cuda')

    def call():
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = ArcFluxPipeline.__call__.__wrapped__(
                pipe, prompt_embeds=embeds, latents=latents,
                output_type='latent')
            torch.cuda.synchronize()
        return out, time.perf_counter() - t
    call()
    plain, t_plain = call()

    def kernels():
        return [m._buffers['kernel'] for m in model.modules()
                if isinstance(m._buffers.get('kernel'), torch.Tensor)]
    setup_distributed()                 # a process group of one
    try:
        model.requires_grad_(False)
        shard_units(model, init_device_mesh('cuda', (1, 1),
                                            mesh_dim_names=('data', 'fsdp')))
        before = all(is_sharded(k) for k in kernels())
        call()
        attn.LAUNCHES = 0                   # the main path's counted run
        out, t_sharded = call()
        launches = attn.LAUNCHES
        after = all(is_sharded(k) for k in kernels())
    finally:
        dist.destroy_process_group()
    want = 2 * sum(W8A8_FSDP_DEPTH.values())
    got, ref = out['latents'], plain['latents']
    rel = rel_l2(got, ref)
    if launches != want or not (before and after) or not n_quant \
            or not torch.isfinite(got).all() or rel > SP_IMAGE_REL_L2:
        raise AssertionError(f'phase 44b: {launches} K1 (want {want}), '
                             f'sharded {before} / {after}, latents rel L2 '
                             f'{rel:.3e}')
    log(f'phase 44b FLUX w8a8 served with its units and int8 kernels '
        f'sharded by shard_units (full width, depth {W8A8_FSDP_DEPTH}, '
        f'2-NFE 1024^2 latents, data=1 x fsdp=1 in a process group of '
        f'one): ok | {n_quant} layers quantized | K1 launches {launches} | '
        f'latents rel L2 {rel:.3e} against the unsharded pipeline '
        f'(bitwise: {torch.equal(got, ref)}) | s per call {t_sharded:.4f} '
        f'against {t_plain:.4f} unsharded')
    del pipe, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, rel=rel, s=t_sharded, plain_s=t_plain)


def phase_local_pipe_serving():
    """Phase 45: FLUX at full width and ``PIPE_SERVE_DEPTH`` (bf16, random
    weights) served 2-NFE at 1024^2 with both block stacks on
    ``LocalPipe(2)`` (one microbatch at batch 1: the bubble, no overlap)
    against the same pipeline without a pipe: the K1 launches of the
    counted run, the latents against the plain ones."""
    g = torch.Generator(device='cuda').manual_seed(SEED + 45)
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(
            dtype=torch.bfloat16, **dict(FLUX_12B, **PIPE_SERVE_DEPTH))
    randomize_(model, g)
    pipe = ArcFluxPipeline(model)
    embeds = flux_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device='cuda')
    timed_call(pipe, embeds, latents, output_type='latent')
    plain, t_plain = timed_call(pipe, embeds, latents, output_type='latent')
    set_pipe(model, LocalPipe(2))
    timed_call(pipe, embeds, latents, output_type='latent')
    attn.LAUNCHES = 0                       # the main path's counted run
    out, t_pipe = timed_call(pipe, embeds, latents, output_type='latent')
    launches = attn.LAUNCHES
    want = 2 * sum(PIPE_SERVE_DEPTH.values())
    got, ref = out['latents'], plain['latents']
    rel = rel_l2(got, ref)
    if launches != want or not torch.isfinite(got).all() \
            or rel > SP_IMAGE_REL_L2:
        raise AssertionError(f'phase 45: {launches} K1 (want {want}), '
                             f'latents rel L2 {rel:.3e}')
    log(f'phase 45 FLUX serving on LocalPipe(2) (full width, depth '
        f'{PIPE_SERVE_DEPTH}, bf16, 2-NFE 1024^2 latents, both stacks '
        f'pipelined, 1 microbatch): ok | K1 launches {launches} | latents '
        f'rel L2 {rel:.3e} against the plain loop (bitwise: '
        f'{torch.equal(got, ref)}) | s per call {t_pipe:.4f} against '
        f'{t_plain:.4f} plain')
    del pipe, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, rel=rel, s=t_pipe, plain_s=t_plain)


def main_placement():
    """Phases 43-45 alone (``chip_smoke.py --placement``, the child process
    that ``start_placement`` starts beside phases 28r-30); writes what the
    parent reads to the file named after the flag."""
    if not torch.cuda.is_available():
        raise SystemExit('FAIL placement: torch.cuda.is_available() is false')
    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    res = dict(fastloader=phase_fastloader())
    res['trunk_fsdp'] = phase_trunk_fsdp()
    gc.collect()
    torch.cuda.empty_cache()
    res['w8a8_fsdp'] = phase_w8a8_fsdp()
    res['local_pipe'] = phase_local_pipe_serving()
    with open(sys.argv[2], 'w') as f:
        json.dump(res, f)
    return 0


def start_child(flag, prefix, *args):
    """``chip_smoke.py flag *args`` in a process of its own, its output to
    files (a pipe left unread would block it)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix=prefix, dir=_build.BUILD_DIR)
    out = open(os.path.join(work, 'out.log'), 'w')
    err = open(os.path.join(work, 'err.log'), 'w')
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag,
         *[a.format(work=work) for a in args]],
        stdout=out, stderr=err, text=True)
    return dict(proc=proc, work=work, files=(out, err))


def stop_child(child):
    """End the child if it still runs; remove its files."""
    if child['proc'].poll() is None:
        child['proc'].kill()
        child['proc'].wait()
    for f in child['files']:
        f.close()
    shutil.rmtree(child['work'], ignore_errors=True)


def finish_child(child, what, prefixes, timeout, result=None):
    """Wait for the child and print its lines that start with one of
    ``prefixes``; fails unless it exits 0. Returns the JSON it wrote to
    ``result`` in its directory, if any."""
    try:
        rc = child['proc'].wait(timeout=timeout)
        for f in child['files']:
            f.flush()
        with open(os.path.join(child['work'], 'out.log')) as f:
            stdout = f.read()
        with open(os.path.join(child['work'], 'err.log')) as f:
            stderr = f.read()
        out = None
        if rc == 0 and result is not None:
            with open(os.path.join(child['work'], result)) as f:
                out = json.load(f)
    finally:
        stop_child(child)
    for line in stdout.splitlines():
        if line.startswith(prefixes):
            print(line, flush=True)
    if rc != 0:
        raise AssertionError(f'{what} exited {rc}:\n'
                             f'{stdout[-3000:]}\n{stderr[-3000:]}')
    return out


def start_placement():
    """Phases 43-45 in a child started with phases 32-33's, beside phases
    28r-30, 26, 23 and 37 (no profiler there): the smoke's time limit
    leaves no room for them in this process."""
    return start_child('--placement', 'placement-',
                       '{work}/placement.json')


def finish_placement(child):
    return finish_child(child, 'phases 43-45', ('phase 4',),
                        PLACEMENT_TIMEOUT, 'placement.json')


# --ranks 4 --placement-only serving: (name, model, mesh); batch 1 on
# every rank (an indivisible batch runs whole on each)
PL_SERVING = (('flux_fsdp4', 'flux', {'fsdp': 4}),
              ('flux_fsdp2_tensor2', 'flux', {'fsdp': 2, 'tensor': 2}),
              ('qwen_w4a8_fsdp4', 'qwen', {'fsdp': 4}),
              ('flux_data2_pipe2', 'flux', {'data': 2, 'pipe': 2}),
              ('flux_moe_pipe2_expert2', 'flux_moe',
               {'pipe': 2, 'expert': 2}))
PL_TRAIN_ITERS = 2
# --placement-only --quantized-only: the layouts that shard a quantized
# trunk (the serving case here, then pl_train)
PL_QUANTIZED = ('qwen_w4a8_fsdp4',)
# at most this share of the one-card weights a rank may hold under fsdp
# (FSDP2 pads each tensor's dim 0 to a multiple of fsdp)
PL_FSDP_HELD = 1.02


def pl_serving_launches(family, axes):
    """K1 / K2 and K5 launches per rank and image: every rank runs the
    whole image (batch 1), a pipe stage its own blocks and those of the
    stacks the pipe degree does not divide."""
    if family == 'qwen':
        n = QWEN_20B['num_layers']
        return dict(attention=2 * n, ring_hop=0,
                    w4a8=2 * (INT4_OUTSIDE_BLOCKS + INT4_PER_BLOCK * n))
    s = axes.get('pipe', 1)
    n = sum(k if k % s else k // s for k in (FLUX_12B['num_layers'],
                                             FLUX_12B['num_single_layers']))
    return dict(attention=2 * n, ring_hop=0, w4a8=0)


def pl_serve(family, axes, pipe, embeds, latents, one):
    """One placement case on this rank: shard ``pipe`` over ``axes``, a
    cold then a counted image, the latents against one card's ``one``,
    the weights and memory a rank holds, one profiled image's NCCL
    share."""
    whole_gib = local_bytes(pipe.transformer.state_dict().values()) / 2 ** 30
    pipe.shard(dict(axes))
    gc.collect()
    torch.cuda.empty_cache()
    held_gib = local_bytes(pipe.transformer.state_dict().values()) / 2 ** 30
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    _, t_cold = timed_call(pipe, embeds, latents, output_type='pt')
    torch.cuda.reset_peak_memory_stats()
    attn.LAUNCHES = hop.LAUNCHES = qmm.LAUNCHES = 0  # the counted run
    out, t_e2e = timed_call(pipe, embeds, latents, output_type='pt')
    launches = dict(attention=attn.LAUNCHES, ring_hop=hop.LAUNCHES,
                    w4a8=qmm.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check_image(out['images'])
    lat = timed_call(pipe, embeds, latents, output_type='latent')[0][
        'latents']
    times = [timed_call(pipe, embeds, latents, output_type='pt')[1]
             for _ in range(2)]
    wall, busy, by_name = profile_split(
        lambda: pipe(prompt_embeds=embeds, latents=latents, output_type='pt'))
    return dict(
        mesh=axes, launches=launches,
        want_launches=pl_serving_launches(family, axes),
        rel_l2=rel_l2(lat, one), bitwise=torch.equal(lat, one),
        latents=lat.float().cpu(), s_per_image=[t_e2e] + times,
        cold_s=t_cold, whole_gib=whole_gib, held_gib=held_gib,
        resident_gib=resident_gib, peak_gib=peak_gib,
        profiled_wall_s=wall, device_busy_s=busy,
        nccl=nccl_split(by_name, wall, busy, ('AllGather', 'AllReduce',
                                              'SendRecv', 'Broadcast')))


def pl_build(family):
    """``tp_build``'s FLUX-12B or Qwen-Image 20B w4a8, or FLUX-12B with
    ``moe_experts=2`` at capacity 1 (phase 41's model) with phase 6's
    VAE and inputs."""
    if family != 'flux_moe':
        return tp_build(family)
    torch.manual_seed(SEED)
    g = torch.Generator(device='cuda').manual_seed(SEED + 2)
    with torch.device('cuda'):
        model = ArcFluxTransformer2DModel(dtype=torch.bfloat16, moe_experts=2,
                                          moe_capacity_factor=1.0,
                                          **FLUX_12B)
        vae = PretrainedVAE(dtype=torch.bfloat16)
    randomize_(model, g)
    pipe = ArcFluxPipeline(model, vae=vae)
    embeds = flux_inputs(g)
    latents = pipe.prepare_latents(1, 1024, 1024, generator=g, device='cuda')
    return pipe, embeds, latents


def pl_train(out_dir):
    """The Qwen-Image 20B int8-trunk config over its shipped mesh (data=2,
    fsdp=-1) at phase 31's cuts and 1 row a rank (as ``--ranks 4`` reads
    it with the trunk whole), its trunk sharded: s per iteration, peaks, the trunk's bytes on this rank,
    every rank's shards against the checkpoint gathered from data replica
    0 and its int8 shards against their parts of the trunk gathered
    whole. Every rank works in ``out_dir`` (one checkpoint directory for
    all, as rank 0 writes it and the others look for its steps)."""
    cfg = mesh_train_config(QWEN_TRAIN_CONFIG, PL_TRAIN_ITERS,
                            PL_TRAIN_ITERS, samples=1)
    run = mesh_train_run(cfg, os.path.join(out_dir, 'work', 'qwen'),
                         SEED + 32)
    state, model = run['state'], run['model']
    mesh = next(iter(state.trainable['diffusion'].values())).device_mesh
    raw = load_raw_checkpoint(run['manager'].directory)
    shards_bad = state_mismatches(state, raw)
    del raw
    quant = quant_params(model)
    quant_bad = [n for n, p in quant.items()
                 if not torch.equal(local(p), shard_of(p.full_tensor(),
                                                       p))]
    teacher = model.teacher.denoising.transformer_blocks
    x = dict(
        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
        iters=PL_TRAIN_ITERS, launches=run['launches'],
        rows=run['rows'], s_per_iter=run['s_per_iter'],
        s_per_step=run['s_per_step'], peak_gib=run['peak_gib'],
        build_peak_gib=run['build_peak_gib'],
        n_shards_bad=len(shards_bad), shards_bad=shards_bad[:5],
        quant_bad=quant_bad[:5], n_quant=len(quant),
        quant_sharded=all(is_sharded(p) for p in quant.values()),
        quant_gib=local_bytes(quant.values()) / 2 ** 30,
        quant_whole_gib=sum(p.numel() * p.element_size()
                            for p in quant.values()) / 2 ** 30,
        tied=teacher is model.diffusion.denoising.transformer_blocks,
        resident_gib=torch.cuda.memory_allocated() / 2 ** 30)
    step = build_train_step(model, state.optimizers, model.train_cfg,
                            ema_config_from_cfg(cfg), mesh=mesh)
    index, _ = batch_ranks(mesh)
    batch = to_device(t_train.build_dataset(cfg.data.train).batch(
        np.random.default_rng([SEED, index]), 1),
        torch.device('cuda', torch.cuda.current_device()))
    wall, busy, by_name = profile_split(lambda: step(state, batch))
    x.update(profiled_wall_s=wall, device_busy_s=busy,
             nccl=nccl_split(by_name, wall, busy),
             prefetch_ab=pl_prefetch_ab(step, state, batch))
    del run, state, model, step, batch, quant
    gc.collect()
    torch.cuda.empty_cache()
    return x


def pl_prefetch_ab(step, state, batch):
    """s per step of ``step`` with the quantized trunk's gathers started a
    unit ahead (``parallel/fsdp.py:_Prefetch``, 'ahead') and with each
    started where it is waited on ('waited', the gather before the
    prefetch), on one state, in the order ahead, waited, waited, ahead."""
    from arcflow_tpu_torch.parallel import fsdp as pfsdp
    ahead = pfsdp._Prefetch.gather

    def waited(self, unit):
        work, out = unit.start()
        work.wait()
        return out
    times = dict(ahead=[], waited=[])
    try:
        for mode in ('ahead', 'waited', 'waited', 'ahead'):
            pfsdp._Prefetch.gather = ahead if mode == 'ahead' else waited
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t)
    finally:
        pfsdp._Prefetch.gather = ahead
    return times


def pl_cases(names):
    """The entries of ``PL_SERVING`` named in ``names``."""
    return [c for c in PL_SERVING if c[0] in names]


def pl_rank_main(out_dir, names):
    """One rank of ``--ranks N --placement-only``: each of ``PL_SERVING``
    named in ``names`` against the one-card image this rank makes of the
    same weights first, then ``pl_train``. Writes ``pl{r}.json`` and ``pl{r}.pt`` (the
    latents)."""
    setup_distributed(timeout=600.0)
    rank = dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res, lats = dict(rank=rank, cases=list(names)), {}
    for name, family, axes in pl_cases(names):
        pipe, embeds, latents = pl_build(family)
        timed_call(pipe, embeds, latents, output_type='latent')
        out, t_one = timed_call(pipe, embeds, latents, output_type='latent')
        res[f'{name}_one_card'] = dict(s_latents=t_one)
        res[name] = pl_serve(family, axes, pipe, embeds, latents,
                             out['latents'])
        lats[name] = res[name].pop('latents')
        del pipe, embeds, latents, out
        gc.collect()
        torch.cuda.empty_cache()
    res['train'] = pl_train(out_dir)
    with open(os.path.join(out_dir, f'pl{rank}.json'), 'w') as f:
        json.dump(res, f)
    torch.save(lats, os.path.join(out_dir, f'pl{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def check_pl_ranks(ranks, lats, n):
    """--placement-only read across the ranks: the launches, every rank's
    latents bitwise rank 0's and within the one-card bound, the weights a
    rank holds; training's launches, shards and losses."""
    bad = []
    cases = pl_cases(ranks[0]['cases'])
    for name, family, axes in cases:
        bound = TP_QUANT_IMAGE_REL_L2 if family == 'qwen' else TP_IMAGE_REL_L2
        # under fsdp x tensor the tensors the split keeps whole (embedders,
        # heads, units under min_size) are cut by fsdp alone
        share = PL_FSDP_HELD / axes.get('fsdp', 1)
        for r, lat in zip(ranks, lats):
            got = r[name]
            if got['launches'] != got['want_launches']:
                bad.append((r['rank'], name, 'launches', got['launches']))
            if not got['rel_l2'] <= bound:
                bad.append((r['rank'], name, 'one card', got['rel_l2']))
            if not torch.equal(lat[name], lats[0][name]):
                bad.append((r['rank'], name, 'rank 0 latents'))
            if not got['held_gib'] < got['whole_gib'] or 'fsdp' in axes \
                    and got['held_gib'] > share * got['whole_gib']:
                bad.append((r['rank'], name, 'held', got['held_gib'],
                            got['whole_gib']))
    n_blocks = QWEN_20B['num_layers']
    want = [TRAIN_FORWARDS * n_blocks, TRAIN_BACKWARDS * n_blocks, 0]
    for r in ranks:   # read back from JSON: lists
        x = r['train']
        if x['launches'] != [want] * x['iters'] or x['n_shards_bad'] \
                or x['quant_bad'] or not x['quant_sharded'] \
                or not x['tied'] \
                or x['quant_gib'] > PL_FSDP_HELD / 2 * x['quant_whole_gib'] \
                or [row['loss'] for row in x['rows']] != [
                    row['loss'] for row in ranks[0]['train']['rows']] \
                or not all(math.isfinite(row['loss']) for row in x['rows']):
            bad.append((r['rank'], 'train', {k: x[k] for k in (
                'launches', 'shards_bad', 'quant_bad', 'quant_sharded',
                'tied', 'quant_gib', 'quant_whole_gib', 'rows')}))
    for name, family, axes in cases:
        x = ranks[0][name]
        log(f'phase RPL serving {name} on {n} NCCL ranks (mesh {axes}, batch '
            f'1 whole on every rank): {"FAIL" if bad else "ok"} | launches '
            f'per rank and image {x["launches"]} | latents rel L2 against '
            f'one card {x["rel_l2"]:.3e} (bitwise: {x["bitwise"]}) on rank '
            f'0, every rank bitwise rank 0 | s per image (counted, then 2 '
            f'warm) ' + ', '.join(f'{s:.4f}' for s in x['s_per_image'])
            + f' against one card '
            f'{ranks[0][f"{name}_one_card"]["s_latents"]:.4f} s (latents '
            f'only) | weights held ' + ', '.join(
                f'{r[name]["held_gib"]:.2f}' for r in ranks)
            + f' of {x["whole_gib"]:.2f} GiB (ranks 0-{n - 1}) | resident '
            f'{x["resident_gib"]:.2f} GiB, peak {x["peak_gib"]:.2f} GiB | '
            f'profiled image: wall {x["profiled_wall_s"]:.4f} s, device '
            f'busy {x["device_busy_s"]:.4f} s; NCCL ' + ', '.join(
                f'{k} {v["ms"]:.1f} ms ({100 * v["share_of_wall"]:.1f}% of '
                f'wall)' for k, v in x['nccl'].items()))
    x = ranks[0]['train']
    log(f'phase RPL Qwen-Image 20B int8-trunk training through train_model '
        f'on {n} NCCL ranks (mesh {x["mesh"]}, as shipped; phase 31\'s cuts, '
        f'1 row a rank, {x["iters"]} iterations): {"FAIL" if bad else "ok"} '
        f'| launches per iteration {x["launches"][0]} | losses '
        + ', '.join(f'{row["loss"]:.5e}' for row in x['rows'])
        + f' on every rank | {x["n_quant"]} int8 kernels and scales sharded '
        f'(the teacher on the student\'s trunk): {x["quant_gib"]:.2f} of '
        f'{x["quant_whole_gib"]:.2f} GiB on each rank, every rank\'s shards '
        f'equal to their parts of the trunk gathered whole and of the '
        f'checkpoint gathered from data replica 0 | rank 0 profiled step: '
        f'wall {x["profiled_wall_s"]:.4f} s, device busy '
        f'{x["device_busy_s"]:.4f} s; NCCL ' + ', '.join(
            f'{k} {v["ms"]:.1f} ms ({100 * v["share_of_wall"]:.1f}% of wall)'
            for k, v in x['nccl'].items()) + ' | s per step, the quantized '
        f'gathers started a unit ahead / each where it is waited on (order '
        f'ahead, waited, waited, ahead): ' + ' ; '.join(
            f'rank {r["rank"]}: ' + ', '.join(
                f'{v:.4f}' for v in r['train']['prefetch_ab']['ahead'])
            + ' / ' + ', '.join(
                f'{v:.4f}' for v in r['train']['prefetch_ab']['waited'])
            for r in ranks) + ' | ' + ' ; '.join(
            f'rank {r["rank"]}: s per iteration ' + ', '.join(
                f'{v:.4f}' for v in r['train']['s_per_iter'])
            + f', peak {r["train"]["peak_gib"]:.2f} GiB training '
            f'({r["train"]["build_peak_gib"]:.2f} building), resident '
            f'{r["train"]["resident_gib"]:.2f} GiB' for r in ranks))
    if bad:
        raise AssertionError(f'--ranks {n} --placement-only failed: {bad}')


def main_placement_ranks(n, smi, out_dir, quantized_only=False):
    """``--ranks n --placement-only`` (4 ranks): ``pl_rank_main`` on each,
    over every serving case or (``--quantized-only``) ``PL_QUANTIZED``."""
    names = PL_QUANTIZED if quantized_only else [c[0] for c in PL_SERVING]
    t = time.perf_counter()
    spawn(pl_rank_main, n, (out_dir, tuple(names)), timeout=1500.0)
    wall = time.perf_counter() - t
    ranks = [json.load(open(os.path.join(out_dir, f'pl{r}.json')))
             for r in range(n)]
    lats = [torch.load(os.path.join(out_dir, f'pl{r}.pt'))
            for r in range(n)]
    shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps({'placement': ranks}))
    check_pl_ranks(ranks, lats, n)
    log(f'phase RPL the weights\' placement on {n} NCCL ranks: ok in '
        f'{wall:.1f} s (builds, one-card images, images and iterations '
        f'included)')
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def main():
    if sys.argv[1:2] == ['--imagenet']:
        return main_imagenet()
    if sys.argv[1:2] == ['--placement']:
        return main_placement()
    if sys.argv[1:2] == ['--ranks']:
        sp_only = '--sp-train-only' in sys.argv[3:]
        return main_ranks(int(sys.argv[2]),
                          serve=not sp_only
                          and '--train-only' not in sys.argv[3:],
                          mesh_train=not sp_only,
                          pipe_expert='--pipe-expert-only' in sys.argv[3:],
                          tensor='--tensor-only' in sys.argv[3:],
                          placement='--placement-only' in sys.argv[3:],
                          quantized_only='--quantized-only' in sys.argv[3:])
    smi = phase_facts()
    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    attn_err, attn_timed = phase_kernel_vs_plain()
    w4a8_err, w4a8_timed, w4a8_classes = phase_w4a8_vs_plain()
    phase_int8_vs_plain()
    tp_kernels = phase_tensor_kernels()
    # the ring phases early: phase 15's flash-SDPA yardstick reads kernel
    # records, which torch.profiler drops in a process after large traces
    # (it kept 23 of 50 a window after the FLUX phases in PR 12, 7 of 50
    # after phases 34-37 joined them)
    k4_err, k4_timed = phase_k4_vs_plain()
    phase_ring_vs_k1()
    gc.collect()
    torch.cuda.empty_cache()
    phase_local_ring_slices()
    gc.collect()
    torch.cuda.empty_cache()
    phase_reduced_slice()
    phase_w8a8_reduced()
    gc.collect()
    torch.cuda.empty_cache()
    flux_launches, flux_run = phase_full_slice()
    flux_prompt = phase_prompt_flux_full(flux_run)
    ring_launches, ring_host = phase_full_local_ring(*flux_run)
    flux_tp = phase_flux_local_tensor(*flux_run)
    cn_fill = phase_controlnet_fill(flux_run)
    captured = phase_w8a8_full(*flux_run)
    flux_tp_w8a8 = phase_w8a8_local_tensor(*flux_run[:3])
    vae, embeds, latents = flux_run[0].vae, flux_run[1], flux_run[2]
    del flux_run
    gc.collect()                            # the FLUX model goes first
    torch.cuda.empty_cache()
    with own_rng():
        flux_moe = phase_flux_moe(vae, embeds, latents)
    del vae, embeds, latents
    gc.collect()
    torch.cuda.empty_cache()
    k7_err, k7_launches, k7_timed = phase_k7_vs_plain(captured)
    del captured
    phase_qwen_reduced()
    gc.collect()
    torch.cuda.empty_cache()
    qwen_launches, qwen_run = phase_qwen_full(w4a8_classes)
    qwen_prompt = phase_prompt_qwen_full(qwen_run)
    qwen_tp = phase_qwen_local_tensor(qwen_run)
    del qwen_run
    gc.collect()
    torch.cuda.empty_cache()
    bwd = phase_bwd_vs_plain()
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_reduced()
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_run = phase_train_full()
    runner_launches = phase_train_runner(train_run)
    flux_ring_train = phase_train_local_ring(train_run)
    with own_rng():
        flux_pipe_train = phase_train_local_pipe(train_run)
    bare_step_s = train_run['warm']
    del train_run
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches = phase_mesh_train(runner_launches['s_per_iter'],
                                     bare_step_s)
    gc.collect()
    torch.cuda.empty_cache()
    k6_err, k6_timed = phase_k6_vs_plain()
    kr = phase_kr()
    phase_gmflow()
    # the Qwen training phases last. Phase 28's profile of one 20B step
    # (about 168k kernel records) leaves every later torch.profiler window
    # of this process dropping kernel records (profiler_drop_probe.py: a
    # few of 50 after one trace of 170k-250k tiny kernels; phase 15 kept 8
    # of 50 in each of its windows when it ran after phase 28), so no phase
    # that reads profile_split (which sums every record of one call) may
    # come after it; kernel_ms pools the records kept over its windows
    gc.collect()
    torch.cuda.empty_cache()
    masked_bwd, qwen_ring = phase_qwen_train_reduced()
    gc.collect()
    torch.cuda.empty_cache()
    qwen_train, qwen_run = phase_qwen_train_full()
    # phases 32-33 in a child beside the last phases (28r, 29, 30, 26, 23,
    # 37): after them this process's profiler windows kept no kernel
    # records (phase 15, 0 of 50 in six windows), and phase 28 reads the
    # last of them. The child sets the end of the run (254-375 s against
    # 28r-30's 70-90 s on the H100 machine), so the phases that read no
    # profiler (26, and 23 and 37 with the toy validation's process) run
    # beside it, and it starts that much earlier
    imagenet = start_imagenet()
    toy = start_toy_validation()
    placement = start_placement()
    try:
        qwen_runner = phase_qwen_train_runner(qwen_run)
        del qwen_run
        gc.collect()
        torch.cuda.empty_cache()
        phase_vae_encoders()
        gc.collect()
        torch.cuda.empty_cache()
        phase_qwen_train_cli()
        gc.collect()
        torch.cuda.empty_cache()
        phase_from_pretrained()
        gc.collect()
        torch.cuda.empty_cache()
        phase_toy_cli()
        phase_tools(toy)
        placed = finish_placement(placement)
        finish_imagenet(imagenet)
    finally:
        stop_toy_validation(toy)
        stop_child(placement)
        stop_child(imagenet)
    fwd = attn_timed['unmasked']
    ff_in = w4a8_timed[0]
    fwd_by_path = {'flux': flux_launches, 'qwen': qwen_launches['attention'],
                   'flux_prompt': flux_prompt['launches']['attention'],
                   'qwen_prompt': qwen_prompt['launches']['attention'],
                   'flux_train': train_launches['forward'],
                   'flux_train_runner': runner_launches['forward'],
                   'flux_mesh_train': mesh_launches['forward'],
                   'qwen_train': qwen_train['forward'],
                   'qwen_train_runner': qwen_runner['forward'],
                   'flux_eval_hook': runner_launches['eval'],
                   'flux_export_served': runner_launches['export_served'],
                   'flux_controlnet': cn_fill['controlnet_interval']
                   + cn_fill['controlnet_repeat'],
                   'flux_fill': cn_fill['fill'],
                   'flux_ui_callback': flux_prompt['ui']['launches'],
                   'flux_train_local_pipe': flux_pipe_train['k1'],
                   'flux_moe': flux_moe['launches'],
                   'flux_local_tensor': flux_tp['launches'],
                   'flux_w8a8_local_tensor':
                   flux_tp_w8a8['launches']['attention'],
                   'qwen_local_tensor': qwen_tp['launches']['attention'],
                   'flux_local_pipe_serving':
                   placed['local_pipe']['launches'],
                   **{f'{name}_trunk_fsdp': x['launches'][0]
                      for name, x in placed['trunk_fsdp'].items()}}
    bwd_by_path = {'flux_train': train_launches['backward'],
                   'flux_train_runner': runner_launches['backward'],
                   'flux_mesh_train': mesh_launches['backward'],
                   'qwen_train': qwen_train['backward'],
                   'qwen_train_runner': qwen_runner['backward'],
                   'flux_train_local_ring': flux_ring_train['k3'],
                   'qwen_train_local_ring': qwen_ring['k3'],
                   'flux_train_local_pipe': flux_pipe_train['k3'],
                   **{f'{name}_trunk_fsdp': x['launches'][1]
                      for name, x in placed['trunk_fsdp'].items()}}
    hop_by_path = {'flux_local_ring': ring_launches,
                   'flux_train_local_ring': flux_ring_train['k4'],
                   'qwen_train_local_ring': qwen_ring['k4']}
    print(json.dumps({'kernels': [
        {'name': 'attention_fwd', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/attention_fwd.cu',
         'replaces': 'arcflow_tpu/models/layers.py:525',
         'launches': sum(fwd_by_path.values()),
         'launches_by_path': fwd_by_path,
         'max_abs_err': attn_err, 'ms': fwd['ms'],
         'plain_ms': fwd['plain_ms'], 'bound_ms': fwd['bound_ms'],
         'bound_by': fwd['bound_by'], 'library_ms': fwd['library_ms'],
         'shape': list(FLUX_SHAPE),
         'masked': dict(attn_timed['masked'], valid_keys=QWEN_VALID_KEYS),
         'tensor_shards': tp_kernels['attention_fwd'],
         'tensor_shards_masked': tp_kernels['attention_masked']},
        {'name': 'w4a8_matmul', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/w4a8_matmul.cu',
         'replaces': 'arcflow_tpu/ops/quant_matmul.py:88',
         'launches': qwen_launches['w4a8'] + qwen_prompt['launches']['w4a8']
         + qwen_tp['launches']['w4a8'],
         'launches_by_path': {'qwen': qwen_launches['w4a8'],
                              'qwen_prompt': qwen_prompt['launches']['w4a8'],
                              'qwen_local_tensor':
                              qwen_tp['launches']['w4a8']},
         'max_abs_err': w4a8_err, 'ms': ff_in['ms'],
         'plain_ms': ff_in['plain_ms'], 'bound_ms': ff_in['bound_ms'],
         'bound_by': ff_in['bound_by'], 'library_ms': None,
         'reference_ms': ff_in['reference_ms'],
         'shape': ff_in['shape'], 'timed': w4a8_timed,
         'by_class': w4a8_classes,
         'tensor_shards': tp_kernels['w4a8_matmul']},
        {'name': 'attention_bwd', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/attention_bwd.cu',
         'replaces': 'arcflow_tpu/models/layers.py:542',
         'launches': sum(bwd_by_path.values()),
         'launches_by_path': bwd_by_path,
         'max_abs_err': bwd['max_abs_err'], 'max_rel_l2': bwd['max_rel_l2'],
         'ms': bwd['ms'], 'plain_ms': bwd['plain_ms'],
         'bound_ms': bwd['bound_ms'], 'bound_by': bwd['bound_by'],
         'library_ms': bwd['library_ms'], 'shape': list(FLUX_SHAPE),
         'masked': masked_bwd,
         'tensor_shards': tp_kernels['attention_bwd']},
        {'name': 'gm_inverse_cdf', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/gm_inverse_cdf.cu',
         'replaces': 'arcflow_tpu/ops/gm/inverse_cdf.py:70',
         'launches': kr['launches'],
         'launches_by_path': {'kr_transport': kr['launches']},
         'max_abs_err': k6_err, 'ms': k6_timed['kr_axis']['ms'],
         'plain_ms': k6_timed['kr_axis']['plain_ms'],
         'bound_ms': k6_timed['kr_axis']['bound_ms'],
         'bound_by': k6_timed['kr_axis']['bound_by'], 'library_ms': None,
         'shape': k6_timed['kr_axis']['shape'],
         'wrapper_ms': k6_timed['kr_axis']['wrapper_ms'],
         'lanes': k6_timed['kr_axis']['lanes'],
         'ms_by_lanes': k6_timed['kr_axis']['ms_by_lanes'],
         'large': k6_timed['large']},
        {'name': 'ring_hop', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/ring_hop.cu',
         'replaces': 'arcflow_tpu/parallel/ring_attention.py:116',
         'launches': sum(hop_by_path.values()),
         'launches_by_path': hop_by_path,
         'max_abs_err': k4_err, 'ms': k4_timed['ms'],
         'plain_ms': k4_timed['plain_ms'], 'bound_ms': k4_timed['bound_ms'],
         'bound_by': k4_timed['bound_by'],
         'library_ms': k4_timed['library_ms'],
         'call_ms': k4_timed['call_ms'], 'shape': k4_timed['shape'],
         'flux_local_ring': ring_host},
        {'name': 'flash_int8', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/flash_int8.cu',
         'replaces': 'arcflow_tpu/ops/flash_int8.py:93',
         'launches': k7_launches,
         'launches_by_path': {'w8a8_flux_probe': k7_launches},
         'max_abs_err': k7_err, 'ms': k7_timed['ms'],
         'plain_ms': k7_timed['plain_ms'], 'bound_ms': k7_timed['bound_ms'],
         'bound_by': k7_timed['bound_by'], 'library_ms': None,
         'wrapper_ms': k7_timed['wrapper_ms'],
         'reference_ms': {'attention_fwd': k7_timed['k1_ms'],
                          'sdpa_bf16': k7_timed['sdpa_ms']},
         'shape': list(FLUX_SHAPE)},
        {'name': 'quantize_rows_int8', 'route': 'cuda',
         'source': 'arcflow_tpu_torch/csrc/flash_int8.cu',
         'replaces': 'arcflow_tpu/ops/flash_int8.py:118',
         'launches': k7_timed['quant']['launches'],
         'launches_by_path': {
             'w8a8_flux_probe': k7_timed['quant']['launches']},
         'max_abs_err': k7_timed['quant']['max_abs_err'],
         'ms': k7_timed['quant']['ms'],
         'plain_ms': k7_timed['quant']['plain_ms'],
         'bound_ms': k7_timed['quant']['bound_ms'],
         'bound_by': k7_timed['quant']['bound_by'], 'library_ms': None,
         'call_ms': k7_timed['quant']['call_ms'],
         'shape': list(FLUX_SHAPE)}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
