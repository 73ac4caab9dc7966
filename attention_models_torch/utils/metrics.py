"""Training metrics as JSON lines, and image grids.

The port's copy of ``attention_models_tpu/utils/metrics.py`` without the
TensorBoard and wandb sinks: every ``log`` call appends one line
``{"step", "ts", **metrics}`` to ``<out_dir>/metrics.jsonl``. Pillow is
imported only to write a grid.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np


class MetricsWriter:
    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._jsonl = open(self.path, "a")

    def log(self, metrics: Mapping, step: int) -> None:
        clean = {k: (float(v) if np.ndim(v) == 0 else np.asarray(v).tolist())
                 for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": step, "ts": time.time(),
                                      **clean}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


def make_grid(images: np.ndarray, nrow: int = 6, pad: int = 2) -> np.ndarray:
    """torchvision ``make_grid``: (n, c, h, w) -> (c, H, W)."""
    n, c, h, w = images.shape
    nr = -(-n // nrow)
    grid = np.zeros((c, nr * (h + pad) + pad, nrow * (w + pad) + pad),
                    images.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        top, left = r * (h + pad) + pad, col * (w + pad) + pad
        grid[:, top: top + h, left: left + w] = images[i]
    return grid


def save_image_grid(images: np.ndarray, path: str, nrow: int = 6) -> None:
    from PIL import Image

    grid = make_grid(np.asarray(images, np.float32), nrow)
    arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    Image.fromarray(arr).save(path)
