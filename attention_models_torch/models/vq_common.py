"""The frozen VQ tokenizer under the token-space generators.

Counterpart of ``attention_models_tpu/models/vq_common.py``. ``vq_config``:
{"kind": "vitvqgan" (default) | "vqgan", ...constructor kwargs}. The CNN
VQGAN tokenizer is not ported yet (slice 7) and raises.
"""

from __future__ import annotations

import torch

from attention_models_torch.models.vitvqgan import ViTVQGAN


def build_vq(vq_config: dict, dtype: torch.dtype | None = None) -> ViTVQGAN:
    """The tokenizer, computing in ``dtype`` over fp32 parameters."""
    cfg = dict(vq_config)
    kind = cfg.pop("kind", "vitvqgan")
    if kind == "vqgan":
        raise NotImplementedError(
            "the CNN VQGAN tokenizer is not ported yet (port slice 7)")
    if kind != "vitvqgan":
        raise ValueError(f"unknown vq kind {kind!r}")
    return ViTVQGAN(**cfg, dtype=dtype)


def vq_codebook_size(vq_config: dict) -> int:
    return int(vq_config["codebook_params"]["codebook_size"])


def vq_num_patches(vq_config: dict) -> int:
    vp = vq_config["vit_params"]
    return (vp["img_size"] // vp["patch_size"]) ** 2
