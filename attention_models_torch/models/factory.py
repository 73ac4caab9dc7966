"""build_model(cfg): the config's model, unplaced and not yet initialised
(the trainer seeds and places it).

Counterpart of ``attention_models_tpu/models/factory.py``'s ``vitvqgan``
branch: ``model.transformer`` gives the ViT widths,
``dataset.preprocessing.resolution`` the image size, ``codebook`` the
quantiser, and ``training.mixed_precision: bf16`` the bf16 compute dtype
over fp32 parameters. Other models raise until their slice is ported.
"""

from __future__ import annotations

import torch

from attention_models_torch.models.vitvqgan import ViTVQGAN


def build_model(cfg) -> ViTVQGAN:
    name = cfg.model.name
    if name != "vitvqgan":
        raise NotImplementedError(f"model {name!r} is not ported yet")
    t = cfg.model.transformer
    mp = str(cfg.training.get("mixed_precision", "no") or "no")
    return ViTVQGAN(
        vit_params=dict(
            dim=t.dim, img_size=cfg.dataset.preprocessing.resolution,
            patch_size=t.patch_size, n_heads=t.n_heads, d_head=t.d_head,
            depth=t.depth, mlp_dim=t.mlp_dim, dropout=t.dropout),
        codebook_params=dict(codebook_dim=cfg.codebook.codebook_dim,
                             codebook_size=cfg.codebook.codebook_size),
        dtype=torch.bfloat16 if mp == "bf16" else torch.float32,
    )
