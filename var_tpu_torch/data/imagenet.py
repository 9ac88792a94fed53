"""ImageNet folder dataset and transforms, eval side (counterpart of
``var_tpu/data/imagenet.py``; reference ``utils/data.py:14-132``).

* ``FolderDataset``: class-sorted subdirectories, torchvision
  ``DatasetFolder`` semantics;
* ``build_imagenet_a_class_map``: ImageNet-A folders mapped to the original
  1000-class indices through an ``imagenet_class_index.json`` file, like the
  fork's loader (``data.py:48-116``);
* ``make_transform``: LANCZOS resize of the shorter side to
  round(1.125 * reso), then a center crop (``train=False``) or a random crop
  with an optional flip from a numpy generator; pixels [0, 1] -> [-1, 1].

Images come out as float32 numpy (H, W, 3), as the JAX package's do. PIL is
imported inside the functions that read images, so importing the port needs
no imaging library. The training sampler and the prefetching loader are not
ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".JPEG", ".JPG", ".PNG")


class FolderDataset:
    """Class-per-subdir image dataset: ``samples`` lists (path, label)."""

    def __init__(self, root: str, class_to_idx: Optional[dict] = None):
        self.root = root
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if class_to_idx is None:
            class_to_idx = {c: i for i, c in enumerate(classes)}
        self.class_to_idx = class_to_idx
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            if c not in class_to_idx:
                continue
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fn), class_to_idx[c]))

    def __len__(self):
        return len(self.samples)


def build_imagenet_a_class_map(class_index_json: str, root: str) -> dict:
    """wnid directory -> original ImageNet-1k index; ``class_index_json``
    maps "idx" -> [wnid, name]."""
    with open(class_index_json) as f:
        idx_map = json.load(f)
    wnid_to_idx = {v[0]: int(k) for k, v in idx_map.items()}
    present = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    return {w: wnid_to_idx[w] for w in present if w in wnid_to_idx}


def _resize_shorter(img, target: int):
    from PIL import Image

    w, h = img.size
    if w <= h:
        nw, nh = target, max(1, round(h * target / w))
    else:
        nw, nh = max(1, round(w * target / h)), target
    return img.resize((nw, nh), Image.LANCZOS)


def _to_pm1(img) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[..., :3] * 2.0 - 1.0  # normalize_01_into_pm1 (data.py:10)


def make_transform(final_reso: int, mid_reso: float = 1.125, train: bool = True,
                   hflip: bool = False) -> Callable:
    """``tf(path, rng) -> (final_reso, final_reso, 3)`` float32 in [-1, 1]."""
    mid = round(mid_reso * final_reso)

    def tf(path: str, rng: np.random.Generator) -> np.ndarray:
        from PIL import Image

        img = _resize_shorter(Image.open(path).convert("RGB"), mid)
        w, h = img.size
        if train:
            x0 = int(rng.integers(0, w - final_reso + 1))
            y0 = int(rng.integers(0, h - final_reso + 1))
        else:
            x0, y0 = (w - final_reso) // 2, (h - final_reso) // 2
        img = img.crop((x0, y0, x0 + final_reso, y0 + final_reso))
        if train and hflip and rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return _to_pm1(img)

    return tf
