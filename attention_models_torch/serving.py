"""Batch programs for the tokenizer services.

Counterparts of ``attention_models_tpu/serving.py``'s ``vq_encode_service``
and ``vq_recon_service``: each returns ``run_batch(imgs, seeds)``, taking a
batch of images (b, 3, H, W) as float32 and ignoring the seeds (both
services are deterministic). Results are tensors on the model's device.
The dynamic-batching engine is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def _images(model: torch.nn.Module, imgs) -> torch.Tensor:
    device = next(model.parameters()).device
    return torch.as_tensor(np.asarray(imgs, np.float32), device=device)


def vq_encode_service(model):
    """Tokenize: images -> codebook indices (b, num_patches), int32."""

    def run_batch(imgs, seeds):  # noqa: ARG001 — deterministic service
        with torch.inference_mode():
            return model.encode_imgs(_images(model, imgs))

    return run_batch


def vq_recon_service(model):
    """Reconstruct: images -> reconstructed images (b, 3, H, W)."""

    def run_batch(imgs, seeds):  # noqa: ARG001 — deterministic service
        with torch.inference_mode():
            rec, _ = model(_images(model, imgs))
        return rec

    return run_batch
