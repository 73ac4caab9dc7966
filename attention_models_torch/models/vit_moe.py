"""The ViT-MoE classifier.

Counterpart of ``attention_models_tpu/models/vit_moe.py``:
- ``ViTMoEBlock``: x + SwitchHeadAttention(norm1(x)), then
  x + MoELayer(norm2(x)), with standard LayerNorms (weight and bias, the
  reference's ``nn.LayerNorm``, not ViT's gamma-only ones), so every
  LayerNorm of the model is kernel 3 with beta on the card. Dropout drops
  the attention's q and k only, as in JAX.
- ``ViTMoE``: ViT's patch embedding (the exact formulation,
  ``models/vit.py::PatchEmbedding``), a class token (1, 1, dim) in front,
  ``pos_enc`` (1, n + 1, dim) added, the blocks, the final ``norm``, then
  ``class_embed`` on the class token.

At 65 tokens (256 px, patch 32) the attention fails ``flash_supported`` and
takes the plain attention, as in JAX; at flash-sized lengths it runs
kernels 9 and 10. The MoE dispatch is PyTorch, as JAX leaves it to XLA.

``ViTMoE(..., dtype=torch.bfloat16)`` keeps fp32 parameters and computes in
bf16; ``dtype=None`` follows the parameters. Keys, after the reference's
``convert_vit_moe``: ``to_patch_embedding.{1,2,3}``, ``class_token``,
``pos_enc``, ``encoder.layers.{i}.{norm1, self_attn.{q.0, k.0, W_s.0,
W_d.0, experts_v, experts_out}, norm2, moe.{gate, experts_kernel,
experts_bias}}``, ``norm``, ``class_embed``. The three expert banks are
stacked tensors where the reference holds one ``Linear`` an expert (see
``models/attention.py`` and ``models/moe.py``);
``utils/convert.py::vit_moe_from_jax`` maps the flax tree onto them.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_models_torch.models.attention import SwitchHeadAttention
from attention_models_torch.models.layers import (
    LayerNorm,
    Linear,
    lecun_normal_,
)
from attention_models_torch.models.moe import MoELayer
from attention_models_torch.models.vit import PatchEmbedding


class ViTMoEBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int, n_experts: int,
                 sel_experts: int, dropout: float = 0.0,
                 moe_impl: str = "auto",
                 capacity_factor: float | None = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.self_attn = SwitchHeadAttention(
            dim, n_heads, d_head, n_experts, sel_experts, dropout, moe_impl,
            capacity_factor)
        self.norm2 = LayerNorm(dim)
        self.moe = MoELayer(dim, dim, n_experts, sel_experts, moe_impl,
                            capacity_factor)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), deterministic, generator)
        return x + self.moe(self.norm2(x))


class ViTMoEEncoder(nn.Module):
    """The blocks, under the reference's ``encoder.layers.{i}`` keys."""

    def __init__(self, depth: int, **block):
        super().__init__()
        self.layers = nn.ModuleList(ViTMoEBlock(**block)
                                    for _ in range(depth))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, deterministic, generator)
        return x


class ViTMoE(nn.Module):
    def __init__(self, dim: int = 1024, image_size: int = 256,
                 patch_size: int = 32, n_heads: int = 16, d_head: int = 64,
                 depth: int = 6, n_experts: int = 32, sel_experts: int = 2,
                 dropout: float = 0.0, num_classes: int = 1000,
                 moe_impl: str = "auto",
                 capacity_factor: float | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        num_patches = (image_size // patch_size) ** 2
        self.compute_dtype = dtype
        self.to_patch_embedding = PatchEmbedding(dim, patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_enc = nn.Parameter(torch.zeros(1, num_patches + 1, dim))
        self.encoder = ViTMoEEncoder(
            depth, dim=dim, n_heads=n_heads, d_head=d_head,
            n_experts=n_experts, sel_experts=sel_experts, dropout=dropout,
            moe_impl=moe_impl, capacity_factor=capacity_factor)
        self.norm = LayerNorm(dim)
        self.class_embed = Linear(dim, num_classes)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.compute_dtype or self.class_embed.weight.dtype

    def forward(self, imgs: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits (b, num_classes) in the compute dtype for images
        (b, 3, H, W); dropout draws from ``generator`` when the forward is
        not ``deterministic``."""
        x = self.to_patch_embedding(imgs, self.dtype)
        cls = self.class_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], 1) + self.pos_enc.to(x.dtype)
        x = self.encoder(x, deterministic, generator)
        return self.class_embed(self.norm(x)[:, 0])

    def use_kernels(self, flag: bool = True) -> "ViTMoE":
        """Route every op through its kernel wrapper (True, the default) or
        through its plain version (False) on whatever device."""
        for m in self.modules():
            if hasattr(m, "kernels"):
                m.kernels = flag
        return self

    def reset_parameters(self, generator: torch.Generator) -> "ViTMoE":
        """The JAX package's inits: lecun-normal Linear weights and expert
        banks, zero biases, LayerNorm ones/zeros, normal(1.0) class token
        and position table."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, (SwitchHeadAttention, MoELayer)):
                    m.reset_experts(generator)
            for p in (self.class_token, self.pos_enc):
                p.normal_(0.0, 1.0, generator=generator)
        return self
