"""Batch programs for the tokenizer, MaskGIT, Muse and Parti services.

Counterparts of ``attention_models_tpu/serving.py``'s ``vq_encode_service``,
``vq_recon_service``, ``maskgit_service``, ``muse_service`` and
``parti_service``: each returns
``run_batch(inputs, seeds)``. The tokenizer services (over the ViTVQGAN or
the CNN VQGAN) take a batch of images (b, 3, H, W) as float32 and ignore
the seeds (both are deterministic).
Results are tensors on the model's device. The dynamic-batching engine is
not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from attention_models_torch.models.parti import parti_generate


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


def maskgit_service(model, *, timesteps: int = 18, num_masked: int = 200,
                    filter_p: float = 0.9, approx_topk: bool = False,
                    inpaint: bool = False):
    """MaskGIT's iterative decode: unconditional (inputs ignored, one image
    per seed) or inpainting (inputs: images (b, 3, H, W)). The batch runs
    as one forward; row i's noise depends on ``seeds[i]`` only, so its image
    does not depend on the rest of the batch."""

    def run_batch(inputs, seeds):
        seeds = np.asarray(seeds, np.int64).reshape(-1)
        kw = dict(num_masked=num_masked, timesteps=timesteps,
                  filter_p=filter_p, approx_topk=approx_topk, seeds=seeds)
        with torch.inference_mode():
            if inpaint:
                return model.generate(_images(model, inputs), **kw)
            return model.generate(batch=len(seeds), **kw)

    return run_batch


def muse_service(model, *, timesteps: int = 18, filter_p: float = 0.9,
                 guidance_scale: float | None = None,
                 approx_topk: bool = False):
    """Muse's text-to-image decode. Inputs: text ids, one (max_length,)
    int row per request (``models/text_encoder.py::tokenize``); one image
    (3, H, W) per request. The batch runs as one CFG forward per step; row
    i's noise depends on ``seeds[i]`` only, so its image does not depend on
    the rest of the batch."""

    def run_batch(text_ids, seeds):
        seeds = np.asarray(seeds, np.int64).reshape(-1)
        device = next(model.parameters()).device
        ids = torch.as_tensor(np.asarray(text_ids, np.int64), device=device)
        with torch.inference_mode():
            return model.generate(ids, timesteps=timesteps, filter_p=filter_p,
                                  guidance_scale=guidance_scale,
                                  approx_topk=approx_topk, seeds=seeds)

    return run_batch


def parti_service(model, *, filter_p: float = 0.9, approx_topk: bool = False,
                  guidance_scale: float = 0.0):
    """Parti's KV-cached autoregressive decode. Inputs: text ids, one
    (max_length,) int row per request; one image (3, H, W) per request. The
    batch runs as one decode; row i's noise depends on ``seeds[i]`` only,
    so its image does not depend on the rest of the batch."""

    def run_batch(text_ids, seeds):
        seeds = np.asarray(seeds, np.int64).reshape(-1)
        device = next(model.parameters()).device
        ids = torch.as_tensor(np.asarray(text_ids, np.int64), device=device)
        with torch.inference_mode():
            return parti_generate(model, ids, filter_p=filter_p,
                                  approx_topk=approx_topk,
                                  guidance_scale=guidance_scale, seeds=seeds)

    return run_batch
