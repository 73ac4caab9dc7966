"""The frozen VQ tokenizer under the token-space generators.

Counterpart of ``attention_models_tpu/models/vq_common.py``. ``vq_config``:
{"kind": "vitvqgan" (default) | "vqgan", ...constructor kwargs}: the
ViTVQGAN, or the CNN VQGAN, whose encoder is fixed at 256 px and a 16 x 16
token grid.
"""

from __future__ import annotations

import torch

from attention_models_torch.models.vitvqgan import ViTVQGAN
from attention_models_torch.models.vqgan import VQGAN


def build_vq(vq_config: dict,
             dtype: torch.dtype | None = None) -> ViTVQGAN | VQGAN:
    """The tokenizer, computing in ``dtype`` over fp32 parameters."""
    cfg = dict(vq_config)
    kind = cfg.pop("kind", "vitvqgan")
    if kind == "vqgan":
        return VQGAN(**cfg, dtype=dtype)
    if kind != "vitvqgan":
        raise ValueError(f"unknown vq kind {kind!r}")
    return ViTVQGAN(**cfg, dtype=dtype)


def vq_codebook_size(vq_config: dict) -> int:
    if vq_config.get("kind", "vitvqgan") == "vqgan":
        return int(vq_config["codebook_size"])
    return int(vq_config["codebook_params"]["codebook_size"])


def vq_num_patches(vq_config: dict) -> int:
    if vq_config.get("kind", "vitvqgan") == "vqgan":
        return 16 * 16
    vp = vq_config["vit_params"]
    return (vp["img_size"] // vp["patch_size"]) ** 2
