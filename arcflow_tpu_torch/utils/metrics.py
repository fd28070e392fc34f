"""Sample-quality metrics for the evaluation hook.

The port's own copy of ``arcflow_tpu/utils/metrics.py`` (that module
imports no JAX, but the port imports nothing of the JAX package): a
latent-space Fréchet distance between generated and reference latents
(numpy, fp64; no external model), and a CLIP score that runs when CLIP
weights are on disk (transformers' torch ``CLIPModel``, local files only).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    """FD^2 = |mu_a - mu_b|^2 + tr(Ca + Cb - 2 sqrtm(Ca Cb)) of two
    (N, D) feature matrices, in fp64."""
    a = np.asarray(feats_a, np.float64).reshape(len(feats_a), -1)
    b = np.asarray(feats_b, np.float64).reshape(len(feats_b), -1)
    mu_a, mu_b = a.mean(0), b.mean(0)
    ca = np.cov(a, rowvar=False) + eps * np.eye(a.shape[1])
    cb = np.cov(b, rowvar=False) + eps * np.eye(b.shape[1])
    diff = mu_a - mu_b
    # tr(sqrtm(Ca Cb)) = sum sqrt(eigvals(Ca Cb)): the product of two PSD
    # matrices has a real non-negative spectrum up to rounding
    eigvals = np.linalg.eigvals(ca @ cb)
    tr_sqrt = np.sqrt(np.clip(eigvals.real, 0.0, None)).sum()
    fd2 = diff @ diff + np.trace(ca) + np.trace(cb) - 2.0 * tr_sqrt
    return float(max(fd2, 0.0))


def latent_stats_features(latents: np.ndarray) -> np.ndarray:
    """(N, H, W, C) latents -> (N, 2C) per-sample channel means and stds
    (a covariance that small N can estimate)."""
    x = np.asarray(latents, np.float64)
    return np.concatenate([x.mean(axis=(1, 2)), x.std(axis=(1, 2))], axis=-1)


def latent_frechet_distance(pred_latents: np.ndarray,
                            ref_latents: np.ndarray) -> float:
    return frechet_distance(latent_stats_features(pred_latents),
                            latent_stats_features(ref_latents))


def clip_score(images, prompts: Sequence[str],
               clip_path: str = 'openai/clip-vit-large-patch14'
               ) -> Optional[float]:
    """Mean CLIP image-text cosine similarity of (N, H, W, 3) images in
    [0, 1] (numpy, or a tensor) and their prompts, or None when the CLIP
    weights at ``clip_path`` (a folder, or the transformers cache) are
    absent. Nothing is downloaded: JAX's ``clip_score`` calls
    ``from_pretrained`` without ``local_files_only``
    (``arcflow_tpu/utils/metrics.py:60-61``) and may reach for the hub. The
    CLIP runs in fp32 on the device a tensor of images lies on (the CPU
    for numpy)."""
    try:
        import torch
        import transformers
        processor = transformers.CLIPProcessor.from_pretrained(
            clip_path, local_files_only=True)
        model = transformers.CLIPModel.from_pretrained(
            clip_path, local_files_only=True, dtype=torch.float32)
    except Exception:
        return None
    device = getattr(images, 'device', 'cpu')
    if hasattr(images, 'detach'):
        images = images.detach().float().cpu().numpy()
    imgs = np.clip(np.asarray(images) * 255, 0, 255).astype(np.uint8)
    inputs = processor(text=list(prompts), images=list(imgs),
                       return_tensors='pt', padding=True)
    model = model.to(device).eval()
    with torch.no_grad():
        out = model(**{k: v.to(device) for k, v in inputs.items()})
    img = torch.nn.functional.normalize(out.image_embeds.float(), dim=-1)
    txt = torch.nn.functional.normalize(out.text_embeds.float(), dim=-1)
    return float((img * txt).sum(-1).mean())
