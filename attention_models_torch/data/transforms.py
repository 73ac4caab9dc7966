"""Host-side image preprocessing with the reference's semantics.

The port's copy of ``attention_models_tpu/data/transforms.py::Transform``:
resize to the exact (n, n) square with n = int(resolution / scale)
(bilinear; eval forces scale 1.0), then train: [random crop] [random
horizontal flip] [center crop] per config flags, eval: center crop; float32
CHW in [0, 1]; optional mean/std normalisation. Pillow is imported only when
an image is transformed. The native C++ batch pipeline is not ported.
"""

from __future__ import annotations

import numpy as np


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return arr[top: top + size, left: left + size]


def _random_crop(arr: np.ndarray, size: int, rng: np.random.Generator):
    h, w = arr.shape[:2]
    top = int(rng.integers(0, max(h - size, 0) + 1))
    left = int(rng.integers(0, max(w - size, 0) + 1))
    return arr[top: top + size, left: left + size]


class Transform:
    def __init__(self, cfg, is_train: bool = True, seed: int = 0):
        pp = cfg.dataset.preprocessing
        self.size = int(pp.resolution)
        scale = float(pp.scale) if is_train else 1.0
        self.resize_to = int(self.size / scale)
        self.is_train = is_train
        self.random_crop = bool(pp.get("random_crop")) and is_train
        self.random_flip = bool(pp.get("random_flip")) and is_train
        self.center_crop_train = bool(pp.get("center_crop")) and is_train
        self.mean = pp.get("mean")
        self.std = pp.get("std")
        self.rng = np.random.default_rng(seed)

    def __call__(self, img, rng: np.random.Generator | None = None
                 ) -> np.ndarray:
        """PIL image -> float32 (3, size, size); ``rng`` is the dataset's
        per-item Generator (the shared stream when omitted)."""
        from PIL import Image

        rng = self.rng if rng is None else rng
        img = img.convert("RGB").resize((self.resize_to, self.resize_to),
                                        Image.BILINEAR)
        arr = np.asarray(img, np.uint8)
        if self.is_train:
            if self.random_crop:
                arr = _random_crop(arr, self.size, rng)
            if self.random_flip and rng.random() < 0.5:
                arr = arr[:, ::-1]
            if self.center_crop_train:
                arr = _center_crop(arr, self.size)
        else:
            arr = _center_crop(arr, self.size)
        out = np.transpose(arr.astype(np.float32) / 255.0, (2, 0, 1))
        if self.mean:
            mean = np.asarray(self.mean, np.float32).reshape(-1, 1, 1)
            std = np.asarray(self.std, np.float32).reshape(-1, 1, 1)
            out = (out - mean) / std
        return np.ascontiguousarray(out)
