"""ImageNet folder pipeline on the host (counterpart of
``var_tpu/data/imagenet.py``; reference ``utils/data.py:14-132``,
``utils/data_sampler.py:6-103``).

* ``FolderDataset``: class-sorted subdirectories, torchvision
  ``DatasetFolder`` semantics;
* ``build_imagenet_a_class_map``: ImageNet-A folders mapped to the original
  1000-class indices through an ``imagenet_class_index.json`` file, like the
  fork's loader (``data.py:48-116``), and ``build_imagenet_a_dataset``;
* ``make_transform``: LANCZOS resize of the shorter side to
  round(1.125 * reso), then a center crop (``train=False``) or a random crop
  with an optional flip from a numpy generator; pixels [0, 1] -> [-1, 1];
* ``eval_split_indices``: the contiguous no-pad eval split;
* ``DistInfiniteBatchSampler``: infinite, epoch-seeded, resumable at
  (start_ep, start_it), per-rank slices with fill-last padding;
* ``sample_rng``: the augmentation stream of one (seed, epoch, index);
* ``DataLoader``: a thread-pooled prefetcher of numpy batches.

Every stream is numpy, as in the JAX package, so the same dataset gives the
same batches bit for bit. Batches come out as float32 numpy (B, H, W, 3)
and int32 labels; moving them to the GPU is the caller's. PIL is imported
inside the functions that read images, so importing the port needs no
imaging library.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Tuple

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


def build_imagenet_a_dataset(root: str, class_index_json: str) -> FolderDataset:
    """ImageNet-A folder with labels remapped to the original 1k-class
    indices (the fork's ``build_imagenet_a_dataset``, data.py:105-116)."""
    return FolderDataset(root, class_to_idx=build_imagenet_a_class_map(class_index_json, root))


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


# ---------------------------------------------------------------------------
# samplers (reference utils/data_sampler.py semantics)


def eval_split_indices(n: int, world_size: int, rank: int) -> range:
    """Contiguous no-pad split (EvalDistributedSampler, data_sampler.py:6-17)."""
    seps = np.linspace(0, n, world_size + 1, dtype=int)
    return range(seps[rank], seps[rank + 1])


class DistInfiniteBatchSampler:
    """Infinite epoch-seeded shuffled batches, contiguous per-rank slice,
    fill-last padding, resumable at (start_ep, start_it)
    (``data_sampler.py:67-103``)."""

    def __init__(self, world_size: int, rank: int, dataset_len: int, glb_batch_size: int,
                 same_seed_for_all_ranks: int = 0, fill_last: bool = True,
                 shuffle: bool = True, start_ep: int = 0, start_it: int = 0):
        if glb_batch_size % world_size:
            raise ValueError(f"global batch {glb_batch_size} is not a multiple of the "
                             f"world size {world_size}")
        self.world_size, self.rank = world_size, rank
        self.dataset_len = dataset_len
        self.glb_batch_size = glb_batch_size
        self.batch_size = glb_batch_size // world_size
        self.iters_per_ep = (dataset_len + glb_batch_size - 1) // glb_batch_size
        self.fill_last, self.shuffle = fill_last, shuffle
        self.same_seed_for_all_ranks = same_seed_for_all_ranks
        self.start_ep, self.start_it = start_ep, start_it
        self.epoch = start_ep
        self.indices = self._gen()

    def _gen(self) -> List[int]:
        gmax = self.iters_per_ep * self.glb_batch_size
        rng = np.random.default_rng(self.epoch + self.same_seed_for_all_ranks)
        g = rng.permutation(self.dataset_len) if self.shuffle else np.arange(self.dataset_len)
        filling = gmax - g.shape[0]
        if filling > 0 and self.fill_last:
            g = np.concatenate([g, g[:filling]])
        seps = np.linspace(0, g.shape[0], self.world_size + 1, dtype=int)
        local = g[seps[self.rank]: seps[self.rank + 1]].tolist()
        self.max_p = len(local)
        return local

    def __iter__(self) -> Iterator[List[int]]:
        # The reference's start_it skip inside the sampler can never trigger
        # (data_sampler.py:52-55 compares the epoch after incrementing it);
        # here the first iterated epoch resumes at start_it. ``epoch`` is
        # incremented before the first yield: the loader's producer reads it
        # right after taking each batch, as the JAX package's does.
        self.epoch = self.start_ep
        first = True
        while True:
            self.epoch += 1
            p = self.start_it * self.batch_size if first else 0
            first = False
            while p < self.max_p:
                yield self.indices[p: p + self.batch_size]
                p += self.batch_size
            if self.shuffle:
                self.indices = self._gen()

    def __len__(self):
        return self.iters_per_ep


# ---------------------------------------------------------------------------
# prefetching loader


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """Augmentation stream for one (seed, epoch, dataset index): thread-safe
    (each load owns its generator), restart-invariant (a resumed run redraws
    the crop and flip the uninterrupted run drew) and world-size-invariant,
    which supersedes the reference's per-worker streams with rank-offset
    seeds (``arg_util.py:113-127``)."""
    return np.random.default_rng([int(seed), int(epoch), int(index)])


class DataLoader:
    """Thread-pooled prefetching loader -> (imgs (B, H, W, 3) float32, labels
    (B,) int32), numpy.

    ``batch_iter`` may be the sampler object itself: when it has an
    ``epoch`` attribute (``DistInfiniteBatchSampler`` does), the per-sample
    streams are ``sample_rng(seed, epoch, index)``, else epoch 0.
    ``dataset.samples[i]`` is (item, label), and ``transform(item, rng)``
    returns one image; ``batch_transform(items, rngs)``, when given, returns
    the whole batch in one call (the native pipeline).
    """

    def __init__(self, dataset, batch_iter, transform: Callable, num_threads: int = 8,
                 prefetch: int = 4, seed: int = 0, batch_transform: Optional[Callable] = None):
        self.ds = dataset
        self.batch_iter = batch_iter
        self.tf = transform
        self.batch_tf = batch_transform
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.seed = seed

    def __iter__(self):
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        epoch_src = self.batch_iter if hasattr(self.batch_iter, "epoch") else None
        it = iter(self.batch_iter)

        def put(item) -> None:
            # never blocks for good: once the consumer has gone, the producer ends
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue_mod.Full:
                    pass

        def produce():
            if self.batch_tf is not None:  # native pipeline: one call per batch
                for idxs in it:
                    if stop.is_set():
                        return
                    ep = epoch_src.epoch if epoch_src is not None else 0
                    items = [self.ds.samples[i][0] for i in idxs]
                    labels = np.asarray([self.ds.samples[i][1] for i in idxs], np.int32)
                    rngs = [sample_rng(self.seed, ep, i) for i in idxs]
                    put((self.batch_tf(items, rngs), labels))
                return
            with ThreadPoolExecutor(self.num_threads) as pool:
                for idxs in it:
                    if stop.is_set():
                        return
                    ep = epoch_src.epoch if epoch_src is not None else 0

                    def load(i, ep=ep):
                        item, label = self.ds.samples[i]
                        return self.tf(item, sample_rng(self.seed, ep, i)), label
                    out = list(pool.map(load, idxs))
                    imgs = np.stack([o[0] for o in out]).astype(np.float32, copy=False)
                    labels = np.asarray([o[1] for o in out], np.int32)
                    put((imgs, labels))

        def producer():
            # a failed load reaches the consumer as the exception, not as a hang
            try:
                produce()
            except Exception as e:  # noqa: BLE001  (re-raised in the consumer)
                put(e)
            else:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
