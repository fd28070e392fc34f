"""Port parity: the ImageNet dataset (``data/imagenet.py``) against the
JAX package, item by item, bitwise: latents mode over ``.npz``, ``.npy``
(a structured record) and ``.pth`` files (CHW on disk, HWC out), image
mode with the ADM center crop, and the test-mode fixtures."""

import os

import numpy as np
import pytest
import torch

from arcflow_tpu.data.imagenet import ImageNet as JImageNet
from arcflow_tpu.data.imagenet import adm_center_crop as j_crop
from arcflow_tpu_torch import DATASETS
from arcflow_tpu_torch.data import ImageNet, adm_center_crop, collate

C, H, W = 4, 8, 8


def assert_items_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert type(g) is type(w), k
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w, k


def write_latents(root):
    rng = np.random.default_rng(0)
    os.makedirs(root)
    for i in range(6):
        x = rng.standard_normal((C, H, W)).astype(np.float32)
        y = int(rng.integers(0, 1000))
        kind = ('npz', 'npy', 'pth')[i % 3]
        path = os.path.join(root, f'{i:03d}.{kind}')
        if kind == 'npz':
            np.savez(path, x=x, y=y)
        elif kind == 'npy':
            rec = np.zeros((), [('x', np.float32, (C, H, W)), ('y', np.int64)])
            rec['x'], rec['y'] = x, y
            np.save(path, rec)
        else:
            torch.save(dict(x=torch.from_numpy(x).to(torch.bfloat16)
                            if i == 2 else torch.from_numpy(x),
                            y=torch.tensor(y)), path)
    with open(os.path.join(root, 'notes.txt'), 'w') as f:
        f.write('not a record')


def test_latents_mode_is_bitwise_jax(tmp_path):
    root = str(tmp_path / 'latents')
    write_latents(root)
    ds = DATASETS.build(dict(type='ImageNet', latents_dir=root))
    ref = JImageNet(latents_dir=root)
    assert isinstance(ds, ImageNet) and len(ds) == len(ref) == 6
    for i in range(len(ds)):
        item = ds[i]
        assert item['latents'].shape == (H, W, C)
        assert_items_equal(item, ref[i])
    batch = collate([ds[i] for i in range(3)])
    assert batch['latents'].shape == (3, H, W, C)
    assert batch['label'].dtype == np.int64


def test_image_mode_is_bitwise_jax(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(1)
    for cls, sizes in (('n01', [(40, 52), (33, 33)]), ('n00', [(64, 96)])):
        os.makedirs(tmp_path / 'img' / cls)
        for j, (h, w) in enumerate(sizes):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                tmp_path / 'img' / cls / f'{j}.png')
    ds = ImageNet(image_dir=str(tmp_path / 'img'), image_size=16)
    ref = JImageNet(image_dir=str(tmp_path / 'img'), image_size=16)
    assert ds.files == ref.files and ds.labels == ref.labels == [0, 1, 1]
    for i in range(len(ds)):
        assert ds[i]['images'].shape == (16, 16, 3)
        assert_items_equal(ds[i], ref[i])


@pytest.mark.parametrize('shape,size', [((70, 45, 3), 16), ((31, 64, 3), 32),
                                        ((32, 32, 3), 32), ((9, 200, 3), 4)])
def test_adm_center_crop_is_bitwise_jax(shape, size):
    img = np.random.default_rng(2).integers(0, 256, shape).astype(np.uint8)
    got = adm_center_crop(img, size)
    np.testing.assert_array_equal(got, j_crop(img, size))
    assert got.shape == (size, size, 3) and got.dtype == np.float32


def test_test_mode_fixtures_are_bitwise_jax():
    ds = ImageNet(test_mode=True, latent_size=(H, W, C), n_test_samples=5)
    ref = JImageNet(test_mode=True, latent_size=(H, W, C), n_test_samples=5)
    assert len(ds) == len(ref) == 5
    for i in (0, 3, 4):
        assert_items_equal(ds[i], ref[i])
    with pytest.raises(ValueError, match='latents_dir or image_dir'):
        ImageNet()
