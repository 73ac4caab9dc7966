"""Patch embedding of the ViT towers (exact path).

Counterpart of ``attention_models_tpu/models/vit.py::PatchEmbedding``'s
exact formulation: rearrange ``b c (h p1) (w p2) -> b (h w) (p1 p2 c)``,
LayerNorm, Linear, LayerNorm. The JAX package's conv-form refold is a TPU
layout workaround that loses accuracy on flat patches; it is not ported.
Parameter names follow the reference ``to_patch_embedding`` Sequential:
``1`` = LayerNorm, ``2`` = Linear, ``3`` = LayerNorm.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_models_torch.models.layers import LayerNorm, Linear


class Patchify(nn.Module):
    """b c (h p1) (w p2) -> b (h w) (p1 p2 c)."""

    def __init__(self, patch_size: int):
        super().__init__()
        self.patch_size = patch_size

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = imgs.shape
        p = self.patch_size
        x = imgs.reshape(b, c, hh // p, p, ww // p, p)
        return x.permute(0, 2, 4, 3, 5, 1).reshape(
            b, (hh // p) * (ww // p), p * p * c)


def unpatchify(x: torch.Tensor, patch_size: int, h: int) -> torch.Tensor:
    """b (h w) (p1 p2 c) -> b c (h p1) (w p2)."""
    b, n, f = x.shape
    p = patch_size
    w = n // h
    c = f // (p * p)
    x = x.reshape(b, h, w, p, p, c).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, c, h * p, w * p)


class PatchEmbedding(nn.Sequential):
    def __init__(self, dim: int, patch_size: int):
        feat = patch_size * patch_size * 3  # RGB
        super().__init__(Patchify(patch_size), LayerNorm(feat),
                         Linear(feat, dim), LayerNorm(dim))

    def forward(self, imgs: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """``dtype`` is the compute dtype (default: the weights' dtype)."""
        patchify, norm1, proj, norm2 = self
        # the first LayerNorm runs in the images' dtype, as in the JAX path,
        # and its output is cast to the compute dtype for the projection
        x = norm1(patchify(imgs)).to(dtype or proj.weight.dtype)
        return norm2(proj(x))
