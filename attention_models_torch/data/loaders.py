"""Batching loader with a seeded per-epoch order.

The port's copy of ``attention_models_tpu/data/loaders.py``: the same
permutation per epoch (``default_rng(seed + epoch)``), fixed-size batches
(``drop_last``), ``set_epoch`` to pin the next iteration's epoch so a
resumed run replays the uninterrupted run's order. Items are fetched in the
calling thread; the JAX loader's prefetch thread and worker pool are not
ported (the step is device-bound at the shipped batch sizes).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def _collate(items):
    """(images (b, 3, H, W), captions as a list or labels as int32 (b,))."""
    imgs = np.stack([it[0] for it in items])
    seconds = [it[1] for it in items]
    if isinstance(seconds[0], (int, np.integer)):
        return imgs, np.asarray(seconds, np.int32)
    return imgs, seconds


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return max(n, 1 if len(self.dataset) else 0)

    def set_epoch(self, epoch: int) -> None:
        """Pin the order of the next iteration to ``epoch``."""
        self._epoch = int(epoch)

    def _batch_indices(self, epoch: int):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        end = (len(idx) - len(idx) % self.batch_size
               if self.drop_last and len(idx) >= self.batch_size
               else len(idx))
        for s in range(0, end, self.batch_size):
            yield idx[s: s + self.batch_size]

    def __iter__(self) -> Iterator:
        for batch_idx in self.iter_indices():
            yield _collate([self.dataset[int(i)] for i in batch_idx])

    def iter_indices(self) -> Iterator[np.ndarray]:
        """The sample indices of each batch, with the epoch and order that
        ``__iter__`` would use (it consumes the epoch alike): token-cached
        training reads its grids from the cache without the images."""
        epoch = self._epoch
        self._epoch += 1
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        yield from self._batch_indices(epoch)


def build_loader(cfg):
    """(train_dl, val_dl) for the ``synthetic``, ``coco`` and ``imagenet``
    (an ImageFolder, split by ``train_test_split``) datasets; synthetic items
    carry captions unless ``dataset.params.with_captions`` is false, then
    labels of 10 classes, as in JAX."""
    from attention_models_torch.data.datasets import (
        CocoCaptions,
        ImageFolder,
        SyntheticImages,
        random_split,
    )
    from attention_models_torch.data.transforms import Transform

    params = cfg.dataset.params
    name = cfg.dataset.name
    if params.get("native_pipeline", False) and name != "synthetic":
        raise NotImplementedError("dataset.params.native_pipeline is not "
                                  "ported yet")
    if name == "coco":
        train_ds = CocoCaptions(cfg, "train2017", is_train=True)
        if params.get("train_test_split"):
            train_ds, val_ds = random_split(
                train_ds, float(params.train_test_split),
                seed=int(cfg.training.get("seed", 0) or 0))
        else:
            val_ds = CocoCaptions(cfg, "val2017", is_train=False)
    elif name == "imagenet":
        seed = int(cfg.training.get("seed", 0) or 0)
        ds = ImageFolder(params.train_path, Transform(cfg, True), seed=seed)
        if not params.get("train_test_split"):
            raise ValueError("train_test_split required for imagenet")
        train_ds, val_ds = random_split(ds, float(params.train_test_split),
                                        seed=seed)
    elif name == "synthetic":
        res = int(cfg.dataset.preprocessing.resolution)
        n = min(int(cfg.experiment.max_train_examples), 64)
        captions = bool(params.get("with_captions", True))
        train_ds = SyntheticImages(n, res, captions)
        val_ds = SyntheticImages(max(n // 4, 2), res, captions, seed=10_000)
    else:
        raise ValueError(f"unknown dataset {name!r}")
    bs = int(params.batch_size)
    train_dl = DataLoader(train_ds, bs, shuffle=bool(params.get("shuffle", True)))
    val_dl = DataLoader(val_ds, bs, shuffle=False, drop_last=False)
    return train_dl, val_dl
