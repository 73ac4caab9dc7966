"""Entry point of the main path: ViTVQGAN 256 px reconstruction.

Counterpart of ``__graft_entry__.entry()``: ``vitvqgan_base`` in bf16 with
seeded random weights, a batch of 8 images of 3 x 256 x 256.
"""

from __future__ import annotations

import torch

from attention_models_torch.models.vitvqgan import vitvqgan_base
from attention_models_torch.ops.dispatch import resolve_device


def entry(device: str | torch.device | None = None):
    """Returns ``(fn, (model, imgs))`` with ``fn(model, imgs) -> (rec, loss)``.
    ``device=None`` means the card and raises without CUDA."""
    dev = resolve_device(device)
    model = vitvqgan_base(img_size=256, dtype=torch.bfloat16, device=dev)
    imgs = torch.zeros(8, 3, 256, 256, dtype=torch.bfloat16, device=dev)

    def fn(model, imgs):
        with torch.inference_mode():
            return model(imgs)

    return fn, (model, imgs)
