"""ImageNet dataset: cached SD-VAE latents, or images with ADM
center-crop preprocessing, or deterministic test fixtures.

The port's own copy of ``arcflow_tpu/data/imagenet.py`` (it imports no
JAX): (a) latents mode reads one ``.npz`` / ``.npy`` / ``.pth`` record per
image, ``{x: (C, H, W), y: label}`` as the latent cacher writes them, and
returns the latents channel-last; (b) image mode walks one folder per
class under ``image_dir`` (classes in sorted order) and center-crops
ADM-style to ``image_size``; (c) ``test_mode`` gives per-index labels and
noise from ``np.random.default_rng(idx)``. Items are numpy, as in JAX; the runner
moves them to the device.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..registry import DATASETS
from .image_prompts import _chw_to_hwc, _to_numpy


def adm_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """ADM preprocessing of an (H, W, 3) image: repeated 2x box
    downsampling while the short side is at least 2 ``size``, a bicubic
    resize of the short side to ``size`` (index sampling without PIL),
    then the center ``size`` x ``size`` crop, as float32."""
    h, w = img.shape[:2]
    while min(h, w) >= 2 * size:
        img = img[:(h // 2) * 2:2].astype(np.float32) / 2 \
            + img[1:(h // 2) * 2:2].astype(np.float32) / 2
        img = img[:, :(w // 2) * 2:2] / 2 + img[:, 1:(w // 2) * 2:2] / 2
        h, w = img.shape[:2]
    scale = size / min(h, w)
    if scale != 1.0:
        try:
            from PIL import Image
            pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
            pil = pil.resize((round(w * scale), round(h * scale)),
                             Image.BICUBIC)
            img = np.asarray(pil, np.float32)
        except ImportError:   # coarse fallback
            idx_h = np.linspace(0, h - 1, round(h * scale)).astype(int)
            idx_w = np.linspace(0, w - 1, round(w * scale)).astype(int)
            img = img[idx_h][:, idx_w]
        h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return np.asarray(img[top:top + size, left:left + size], np.float32)


@DATASETS.register_module()
class ImageNet:
    def __init__(self, latents_dir: Optional[str] = None,
                 image_dir: Optional[str] = None, image_size: int = 256,
                 num_classes: int = 1000, test_mode: bool = False,
                 latent_size=(32, 32, 4), n_test_samples: int = 50000):
        self.latents_dir = latents_dir
        self.image_dir = image_dir
        self.image_size = image_size
        self.num_classes = num_classes
        self.test_mode = test_mode
        self.latent_size = tuple(latent_size)
        self.n_test_samples = n_test_samples

        self.files: Sequence[str] = []
        self.labels: Sequence[int] = []
        if latents_dir is not None:
            self.files = sorted(
                f for f in os.listdir(latents_dir)
                if f.endswith(('.pth', '.npz', '.npy')))
        elif image_dir is not None:
            classes = sorted(os.listdir(image_dir))
            for ci, cls in enumerate(classes):
                cdir = os.path.join(image_dir, cls)
                if not os.path.isdir(cdir):
                    continue
                for f in sorted(os.listdir(cdir)):
                    self.files.append(os.path.join(cls, f))
                    self.labels.append(ci)
        elif not test_mode:
            raise ValueError('need latents_dir or image_dir (or test_mode)')

    def __len__(self):
        if self.test_mode and not self.files:
            return self.n_test_samples
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        if self.test_mode:
            rng = np.random.default_rng(idx)
            return dict(
                ids=idx,
                label=int(rng.integers(0, self.num_classes)),
                noise=rng.standard_normal(self.latent_size).astype(np.float32))
        if self.latents_dir is not None:
            path = os.path.join(self.latents_dir, self.files[idx])
            if path.endswith('.pth'):
                import torch
                rec = torch.load(path, map_location='cpu', weights_only=False)
                latents = _chw_to_hwc(_to_numpy(rec['x']))
                label = int(_to_numpy(rec['y']))
            else:
                rec = np.load(path)
                latents = _chw_to_hwc(np.asarray(rec['x'], np.float32))
                label = int(rec['y'])
            return dict(ids=idx, latents=latents, label=label)
        from PIL import Image
        img = np.asarray(Image.open(
            os.path.join(self.image_dir, self.files[idx])).convert('RGB'))
        img = adm_center_crop(img, self.image_size) / 255.0
        return dict(ids=idx, images=img.astype(np.float32),
                    label=self.labels[idx])
