"""ViTVQGAN image tokenizer: the port's main-path model.

Counterpart of ``attention_models_tpu/models/vitvqgan.py``. Pipeline:
patchify -> ViT encoder -> pre_quant -> L2-normalised codebook (nearest-code
kernel) -> post_quant -> ViT decoder -> un-patchify. Parameter names are the
reference PyTorch ``state_dict`` keys, so a released checkpoint loads with
``load_state_dict`` and no conversion.

The compute dtype is separate from the parameters' dtype, as flax's
``dtype=`` is: ``ViTVQGAN(..., dtype=torch.bfloat16)`` keeps fp32 parameters
(the trainer's master weights) and runs the towers in bf16, every Linear
weight, bias and ``pos_enc`` cast at use by an autograd-tracked ``.to()``.
``dtype=None`` computes in the parameters' own dtype (the bf16 serving
model). The codebook table stays fp32 and is L2-normalised in fp32.
``quant="int8"`` is the JAX package's W8A8 inference mode: the attention
projections through ``quant_dot`` and each block's LN + MLP through the int8
block (kernel 21); the patch embedding, pre/post_quant, ``fc`` and the
codebook stay as they are ("int8_wide" quantizes nothing here, as in JAX).

Semantics kept from the JAX package:
  - the encoder adds ``pos_enc`` cast to the activations' dtype;
  - the codebook L2-normalises z, the table and the lookup in fp32; the
    nearest-code dots take bf16 operands only when z is bf16;
  - loss = beta * mean((sg[z_q] - z)^2) + mean((z_q - sg[z])^2) (beta on the
    first term), straight-through estimator.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_models_torch.models.attention import SoftmaxAttention
from attention_models_torch.models.layers import (
    LayerNorm,
    Linear,
    Mlp,
    lecun_normal_,
    ln_mlp_block,
    xformers_hidden,
)
from attention_models_torch.models.vit import PatchEmbedding, unpatchify
from attention_models_torch.ops.codebook import (
    _nearest_codes_reference,
    l2_normalize,
    nearest_codes,
)
from attention_models_torch.ops.dispatch import resolve_device
from attention_models_torch.ops.quant import QuantCache, check_mode


class ViTVQGANBlock(nn.Module):
    """Pre-LN block: x + attn(norm1(x)), then x + mlp(norm2(x))."""

    def __init__(self, dim: int, n_heads: int, d_head: int, mlp_dim: int,
                 quant: str | None = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.self_attn = SoftmaxAttention(dim, n_heads, d_head, quant=quant)
        self.norm2 = LayerNorm(dim)
        self.feed_forward = Mlp(dim, xformers_hidden(mlp_dim))
        self.quant = quant
        self.q8 = QuantCache()
        self.kernels = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x))
        return ln_mlp_block(x, self.norm2, self.feed_forward,
                            kernels=self.kernels, quant=self.quant,
                            q8=self.q8)


class _Blocks(nn.Module):
    """Holds ``layers``, so block keys read ``<tower>.<name>.layers.{i}``."""

    def __init__(self, blocks):
        super().__init__()
        self.layers = nn.ModuleList(blocks)


def _check_dropout(dropout: float) -> None:
    if dropout != 0.0:
        raise ValueError("dropout is not ported yet: the port's ViTVQGAN "
                         f"needs dropout 0.0, got {dropout}")


class ViTEncoder(nn.Module):
    def __init__(self, dim: int, img_size: int, patch_size: int, n_heads: int,
                 d_head: int, depth: int, mlp_dim: int, dropout: float = 0.0,
                 quant: str | None = None):
        super().__init__()
        _check_dropout(dropout)
        num_patches = (img_size // patch_size) ** 2
        self.to_patch_embedding = PatchEmbedding(dim, patch_size)
        self.pos_enc = nn.Parameter(torch.zeros(1, num_patches, dim))
        self.pre_norm = LayerNorm(dim)
        self.encoder = _Blocks(
            ViTVQGANBlock(dim, n_heads, d_head, mlp_dim, quant)
            for _ in range(depth))

    def forward(self, imgs: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        x = self.to_patch_embedding(imgs, dtype)
        x = self.pre_norm(self.pos_enc.to(x.dtype) + x)
        for block in self.encoder.layers:
            x = block(x)
        return x


class ViTDecoder(nn.Module):
    def __init__(self, dim: int, img_size: int, patch_size: int, n_heads: int,
                 d_head: int, depth: int, mlp_dim: int, dropout: float = 0.0,
                 quant: str | None = None):
        super().__init__()
        _check_dropout(dropout)
        self.patch_size = patch_size
        self.grid = img_size // patch_size
        self.pos_enc = nn.Parameter(torch.zeros(1, self.grid ** 2, dim))
        self.pre_norm = LayerNorm(dim)
        self.decoder = _Blocks(
            ViTVQGANBlock(dim, n_heads, d_head, mlp_dim, quant)
            for _ in range(depth))
        self.fc = Linear(dim, patch_size ** 2 * 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_norm(x + self.pos_enc.to(x.dtype))
        for block in self.decoder.layers:
            x = block(x)
        return unpatchify(self.fc(x), self.patch_size, self.grid)


class Codebook(nn.Module):
    """L2-normalised VQ codebook (ViT variant)."""

    def __init__(self, codebook_size: int = 8192, codebook_dim: int = 32,
                 beta: float = 0.25):
        super().__init__()
        self.embedding = nn.Embedding(codebook_size, codebook_dim)
        self.beta = beta
        self.kernels = True

    def nearest(self, z: torch.Tensor) -> torch.Tensor:
        """int32 indices of z (..., d): fp32 L2-normalised z and table,
        bf16 dot operands when z is bf16, first-lowest argmin."""
        flat = l2_normalize(z.float()).reshape(-1, z.shape[-1])
        table = l2_normalize(self.embedding.weight.float())
        if z.dtype == torch.bfloat16:
            flat, table = flat.to(torch.bfloat16), table.to(torch.bfloat16)
        fn = nearest_codes if self.kernels else _nearest_codes_reference
        return fn(flat, table).reshape(z.shape[:-1])

    def indices_to_embeddings(self, indices: torch.Tensor) -> torch.Tensor:
        """Indices past the table read its last row, as JAX's gather clamps
        them (MaskGIT's never-unmasked positions hold the mask token id)."""
        idx = indices.long().clamp(max=self.embedding.num_embeddings - 1)
        return l2_normalize(self.embedding(idx).float())

    def forward(self, z: torch.Tensor):
        zn = l2_normalize(z.float())
        indices = self.nearest(z)
        z_q = self.indices_to_embeddings(indices)
        loss = (self.beta * torch.mean((z_q.detach() - zn) ** 2)
                + torch.mean((z_q - zn.detach()) ** 2))
        z_q = zn + (z_q - zn).detach()  # straight-through
        return z_q.to(z.dtype), indices, loss


class ViTVQGAN(nn.Module):
    """``vit_params`` / ``codebook_params`` as the reference constructor;
    ``dtype`` the compute dtype (None: the parameters' dtype); ``quant`` the
    inference mode (None, "int8", "int8_wide")."""

    def __init__(self, vit_params: dict, codebook_params: dict,
                 dtype: torch.dtype | None = None, quant: str | None = None):
        super().__init__()
        self.vit_params = dict(vit_params)
        self.compute_dtype = dtype
        self.quant = check_mode(quant)
        dim = vit_params["dim"]
        cb_dim = codebook_params["codebook_dim"]
        self.encoder = ViTEncoder(**vit_params, quant=quant)
        self.pre_quant = Linear(dim, cb_dim)
        self.codebook = Codebook(**codebook_params)
        self.post_quant = Linear(cb_dim, dim)
        self.decoder = ViTDecoder(**vit_params, quant=quant)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.compute_dtype or self.pre_quant.weight.dtype

    @property
    def num_patches(self) -> int:
        return (self.vit_params["img_size"] // self.vit_params["patch_size"]) ** 2

    def forward(self, imgs: torch.Tensor):
        z = self.pre_quant(self.encoder(imgs, self.dtype))
        embeds, _, loss = self.codebook(z)
        rec = self.decoder(self.post_quant(embeds.to(self.dtype)))
        return rec, loss

    def encode_imgs(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.codebook.nearest(
            self.pre_quant(self.encoder(imgs, self.dtype)))

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        embeds = self.codebook.indices_to_embeddings(indices)
        return self.decoder(self.post_quant(embeds.to(self.dtype)))

    def use_kernels(self, flag: bool = True) -> "ViTVQGAN":
        """Route every op through its kernel wrapper (True, the default) or
        through its plain version (False) on whatever device."""
        for m in self.modules():
            if hasattr(m, "kernels"):
                m.kernels = flag
        return self

    def reset_parameters(self, generator: torch.Generator) -> "ViTVQGAN":
        """The JAX package's inits: lecun-normal Linear weights, zero biases,
        LayerNorm ones/zeros, normal(1.0) position tables and codebook."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            for p in (self.encoder.pos_enc, self.decoder.pos_enc,
                      self.codebook.embedding.weight):
                p.normal_(0.0, 1.0, generator=generator)
        return self


def vitvqgan_base(img_size: int = 256, dtype: torch.dtype = torch.float32,
                  device: str | torch.device | None = None,
                  seed: int = 0, quant: str | None = None) -> ViTVQGAN:
    """The released-checkpoint configuration: dim 512, patch 8, depth 6,
    8 heads x 64, mlp 2048 (hidden 1368), codebook 8192 x 32. Weights are
    seeded random (initialised on the CPU from ``seed``, then moved);
    ``device=None`` means the card."""
    dev = resolve_device(device)
    model = ViTVQGAN(
        vit_params=dict(dim=512, img_size=img_size, patch_size=8, n_heads=8,
                        d_head=64, depth=6, mlp_dim=2048, dropout=0.0),
        codebook_params=dict(codebook_size=8192, codebook_dim=32, beta=0.25),
        quant=quant,
    )
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dtype).eval()
