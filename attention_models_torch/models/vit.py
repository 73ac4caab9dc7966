"""The ViT classifier and the patch embedding of the ViT towers.

Counterpart of ``attention_models_tpu/models/vit.py``:
- ``PatchEmbedding``: the exact formulation, rearrange ``b c (h p1) (w p2)
  -> b (h w) (p1 p2 c)``, LayerNorm, Linear, LayerNorm. The JAX package's
  conv-form refold is a TPU layout workaround that loses accuracy on flat
  patches; it is not ported. Parameter names follow the reference
  ``to_patch_embedding`` Sequential: ``1`` = LayerNorm, ``2`` = Linear,
  ``3`` = LayerNorm.
- ``ViTBlock``: x + attn(norm1(x)), then x + mlp(norm2(x)), gamma-only
  LayerNorms, the attention's and the MLP's dropout (the JAX package's
  documented API, not the reference's dead ``feed_forward``, SURVEY §2.9#3).
  Under the JAX gate (bf16, d % 128, rows % 8, dropout inactive) the MLP is
  kernel 7 (and 8 backward); at 65 tokens the attention fails
  ``flash_supported`` and takes the plain attention, as in JAX.
- ``ViT``: the patch embedding, a class token (dim,) in front, ``pos_enc``
  (1, n + 1, dim) added, the blocks, then ``final_fc`` on the class token.

``ViT(..., dtype=torch.bfloat16)`` keeps fp32 parameters and computes in
bf16, as the other models; ``dtype=None`` follows the parameters. Keys:
``to_patch_embedding.{1,2,3}``, ``class_token``, ``pos_enc``,
``layers.{i}.{norm1.gamma, self_attn.{q.0,kv.0,W_o}, norm2.gamma,
mlp.{0,2}}``, ``final_fc`` (``utils/convert.py::vit_from_jax``).
"""

from __future__ import annotations

import torch
from torch import nn

from attention_models_torch.models.attention import SoftmaxAttention
from attention_models_torch.models.layers import (
    GammaLayerNorm,
    LayerNorm,
    Linear,
    Mlp,
    lecun_normal_,
)


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


class ViTBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int, mlp_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.norm1 = GammaLayerNorm(dim)
        self.self_attn = SoftmaxAttention(dim, n_heads, d_head, dropout)
        self.norm2 = GammaLayerNorm(dim)
        self.mlp = Mlp(dim, mlp_dim, dropout)
        self.kernels = True  # the MLP's

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), deterministic, generator)
        return x + self.mlp(self.norm2(x), deterministic, generator,
                            kernels=self.kernels)


class ViT(nn.Module):
    def __init__(self, dim: int, image_size: int = 256, patch_size: int = 16,
                 n_heads: int = 12, d_head: int = 64, depth: int = 12,
                 mlp_dim: int = 3072, dropout: float = 0.0,
                 num_classes: int = 1000, dtype: torch.dtype | None = None):
        super().__init__()
        num_patches = (image_size // patch_size) ** 2
        self.compute_dtype = dtype
        self.to_patch_embedding = PatchEmbedding(dim, patch_size)
        self.class_token = nn.Parameter(torch.zeros(dim))
        self.pos_enc = nn.Parameter(torch.zeros(1, num_patches + 1, dim))
        self.layers = nn.ModuleList(
            ViTBlock(dim, n_heads, d_head, mlp_dim, dropout)
            for _ in range(depth))
        self.final_fc = Linear(dim, num_classes)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.compute_dtype or self.final_fc.weight.dtype

    def forward(self, imgs: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits (b, num_classes) in the compute dtype for images
        (b, 3, H, W); dropout draws from ``generator`` when the forward is
        not ``deterministic``."""
        x = self.to_patch_embedding(imgs, self.dtype)
        cls = self.class_token.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self.pos_enc.to(x.dtype)
        for layer in self.layers:
            x = layer(x, deterministic, generator)
        return self.final_fc(x[:, 0])

    def use_kernels(self, flag: bool = True) -> "ViT":
        """Route every op through its kernel wrapper (True, the default) or
        through its plain version (False) on whatever device."""
        for m in self.modules():
            if hasattr(m, "kernels"):
                m.kernels = flag
        return self

    def reset_parameters(self, generator: torch.Generator) -> "ViT":
        """The JAX package's inits: lecun-normal Linear weights, zero biases,
        LayerNorm ones/zeros, normal(1.0) class token and position table."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, GammaLayerNorm):
                    m.gamma.fill_(1.0)
            for p in (self.class_token, self.pos_enc):
                p.normal_(0.0, 1.0, generator=generator)
        return self
