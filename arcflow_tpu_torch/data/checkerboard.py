"""Analytic 2-D checkerboard distribution: the toy path's data.

Counterpart of ``arcflow_tpu/data/checkerboard.py`` (a copy, since the port
imports nothing of the JAX package): n_rc x n_rc alternating white squares
in [-1, 1]^2, optional thin-frame thickness warp, rotation, scale, shift;
``test_mode`` gives per-index deterministic draws. A numpy sampler: the
host makes the data, the device never sees the generation code.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..registry import DATASETS


@DATASETS.register_module()
class CheckerboardData:
    def __init__(self, n_rc: int = 4, n_samples: float = 1e8,
                 thickness: float = 1.0, scale: float = 1.0,
                 shift: Sequence[float] = (0.0, 0.0), rotation: float = 0.0,
                 test_mode: bool = False, seed: int = 0):
        self.n_rc = n_rc
        self.n_samples = int(n_samples)
        self.thickness = thickness
        self.scale = scale
        self.shift = np.asarray(shift, np.float32)
        self.rotation = rotation
        self.test_mode = test_mode
        self.seed = seed
        self.white_squares = np.asarray(
            [(i, j) for i in range(n_rc) for j in range(n_rc)
             if (i + j) % 2 == 0], np.float32)

    def __len__(self):
        return self.n_samples

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        idx = rng.integers(0, len(self.white_squares), size=n)
        squares = self.white_squares[idx]
        uv = rng.random((n, 2), dtype=np.float32)
        if self.thickness < 1.0:
            # push interior mass toward the square's frame
            uv = uv - 0.5
            r2 = (uv ** 2).sum(-1, keepdims=True)
            ang = np.arctan2(uv[:, 1], uv[:, 0])[:, None]
            max_r = np.minimum(
                0.5 / np.maximum(np.abs(np.cos(ang)), 1e-6),
                0.5 / np.maximum(np.abs(np.sin(ang)), 1e-6)) ** 2
            r2_scaled = max_r - (max_r - r2) * self.thickness ** 0.5
            uv = uv * np.sqrt(r2_scaled / np.maximum(r2, 1e-12)) + 0.5
        pts = (squares + uv) * (2.0 / self.n_rc) - 1.0
        if self.rotation != 0.0:
            a = np.deg2rad(self.rotation).astype(np.float32)
            rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                           np.float32)
            pts = pts @ rot
        return pts.astype(np.float32) * self.scale + self.shift

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed + idx if self.test_mode
                                    else None)
        return dict(x=self.draw(rng, 1)[0])

    def batch(self, rng: np.random.Generator, batch_size: int) -> dict:
        return dict(x=self.draw(rng, batch_size))

    def log_prob_support(self, pts: np.ndarray) -> np.ndarray:
        """Whether each point lies in the (un-warped) support."""
        p = (pts - self.shift) / self.scale
        if self.rotation != 0.0:
            a = np.deg2rad(self.rotation).astype(np.float32)
            rot = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]],
                           np.float32)
            p = p @ rot
        cell = np.floor((p + 1.0) * (self.n_rc / 2.0)).astype(int)
        inside = np.all((cell >= 0) & (cell < self.n_rc), axis=-1)
        white = (cell.sum(-1) % 2) == 0
        return inside & white
