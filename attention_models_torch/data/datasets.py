"""Datasets: COCO captions (plain JSON reader), ImageFolder and seeded
synthetic images.

The port's copies of ``attention_models_tpu/data/datasets.py``'s
``CocoCaptions``, ``ImageFolder`` and ``SyntheticImages``: each item is
(image CHW float32, caption str) or, for the classifier, (image, class
index). Per-item randomness (caption choice, crops, flips) is keyed on
(seed, epoch, idx), so a resumed run replays the same draws. Pillow is
imported only when an image is read.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from attention_models_torch.data.transforms import Transform


class CocoCaptions:
    """{root}/{data_type}/ images + {root}/annotations/captions_*.json,
    truncated to ``experiment.max_train_examples``."""

    def __init__(self, cfg, data_type="train2017", is_train=True, seed=0):
        params = cfg.dataset.params
        root = params.train_path if is_train else params.val_path
        self.img_dir = os.path.join(root, data_type)
        ann_file = os.path.join(root, "annotations",
                                f"captions_{data_type}.json")
        with open(ann_file) as f:
            ann = json.load(f)
        self.file_by_imgid = {im["id"]: im["file_name"] for im in ann["images"]}
        self.captions: dict[int, list[str]] = {}
        for a in ann["annotations"]:
            self.captions.setdefault(a["image_id"], []).append(a["caption"])
        self.imgids = [i for i in self.file_by_imgid if i in self.captions]
        max_n = int(cfg.experiment.max_train_examples)
        if max_n < len(self.imgids):
            self.imgids = self.imgids[:max_n]
        self.transform = Transform(cfg, is_train, seed)
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _item_rng(self, idx) -> np.random.Generator:
        return np.random.default_rng((self.seed, self._epoch, int(idx)))

    def __len__(self):
        return len(self.imgids)

    def __getitem__(self, idx):
        from PIL import Image

        rng = self._item_rng(idx)
        imgid = self.imgids[idx]
        path = os.path.join(self.img_dir, self.file_by_imgid[imgid])
        caption = str(rng.choice(self.captions[imgid]))
        return self.transform(Image.open(path), rng), caption


class ImageFolder:
    """torchvision ``ImageFolder``: ``root/<class>/<image>``, classes in
    sorted order, items (image, class index)."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root: str, transform: Transform, seed: int = 0):
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[str, int]] = [
            (os.path.join(root, c, fn), self.class_to_idx[c])
            for c in classes for fn in sorted(os.listdir(os.path.join(root, c)))
            if fn.lower().endswith(self.EXTS)]
        self.transform = transform
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        from PIL import Image

        path, label = self.samples[idx]
        rng = np.random.default_rng((self.seed, self._epoch, int(idx)))
        return self.transform(Image.open(path), rng), label


class SyntheticImages:
    """Deterministic random images with captions or, without
    ``with_captions``, class labels ``idx % num_classes``, for tests and the
    card."""

    _CAPTIONS = ["a photo of a cat", "a red stop sign", "two dogs playing",
                 "a mountain at sunset"]

    def __init__(self, n: int, resolution: int, with_captions: bool = True,
                 num_classes: int = 10, seed: int = 0):
        self.n, self.resolution, self.seed = n, resolution, seed
        self.with_captions, self.num_classes = with_captions, num_classes

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rs = np.random.RandomState(self.seed + idx)
        img = rs.rand(3, self.resolution, self.resolution).astype(np.float32)
        if self.with_captions:
            return img, self._CAPTIONS[idx % len(self._CAPTIONS)]
        return img, idx % self.num_classes


class Subset:
    def __init__(self, ds, indices: Sequence[int]):
        self.ds, self.indices = ds, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.ds[self.indices[idx]]

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(epoch)


def random_split(ds, train_frac: float, seed: int = 0):
    """A seeded random permutation split into (train, val) subsets."""
    n = len(ds)
    n_train = int(train_frac * n)
    perm = np.random.default_rng(seed).permutation(n)
    return Subset(ds, perm[:n_train]), Subset(ds, perm[n_train:])
