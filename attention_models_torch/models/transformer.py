"""Pre-LN transformer stacks, loop form.

Counterpart of ``attention_models_tpu/models/transformer.py``'s
``EncoderLayer`` / ``Encoder`` and ``DecoderLayer`` / ``Decoder``. Keys are
the reference's (``attention_models_tpu/utils/torch_convert.py::
convert_encoder_layer`` / ``convert_decoder_layer``):
``layers.{i}.norm1.gamma``, ``layers.{i}.self_attn.{q.0,kv.0,W_o}``,
``layers.{i}.norm2.gamma``, ``layers.{i}.feed_forward.ff.{0,2.gamma,3}``;
a decoder layer adds ``cross_attn.*`` after ``norm2`` and ``norm3`` before
the FFN. Self-attention is unmasked and bidirectional (the paths MaskGIT and
Muse run); cross-attention takes the ``context`` and its ``context_mask``.
``dropout`` is the attention's (on q, kv and its output) when the forward is
not ``deterministic``; the FFN has none, as in JAX. ``quant`` is the W8A8
inference mode of every layer (``models/layers.py``). ``scan_layers``,
``remat``, pipeline parallelism and the decoder's causal and KV-cache modes
are not ported yet: ``models/factory.py::build_model`` refuses the first
three.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_models_torch.models.attention import SoftmaxAttention
from attention_models_torch.models.layers import FeedForward, GammaLayerNorm


class EncoderLayer(nn.Module):
    """x + attn(norm1(x)), then x + feed_forward(norm2(x))."""

    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 mult: float = 4, dropout: float = 0.0,
                 quant: str | None = None):
        super().__init__()
        self.norm1 = GammaLayerNorm(dim)
        self.self_attn = SoftmaxAttention(dim, n_heads, d_head, dropout, quant)
        self.norm2 = GammaLayerNorm(dim)
        self.feed_forward = FeedForward(dim, mult, quant)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), deterministic, generator)
        return x + self.feed_forward(self.norm2(x))


class Encoder(nn.Module):
    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 depth: int = 6, mult: float = 4, dropout: float = 0.0,
                 quant: str | None = None):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(dim, n_heads, d_head, mult, dropout, quant)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, deterministic, generator)
        return x


class DecoderLayer(nn.Module):
    """x + self_attn(norm1(x)), x + cross_attn(norm2(x), context), then
    x + feed_forward(norm3(x))."""

    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 mult: float = 4, dropout: float = 0.0,
                 quant: str | None = None):
        super().__init__()
        self.norm1 = GammaLayerNorm(dim)
        self.self_attn = SoftmaxAttention(dim, n_heads, d_head, dropout, quant)
        self.norm2 = GammaLayerNorm(dim)
        self.cross_attn = SoftmaxAttention(dim, n_heads, d_head, dropout,
                                           quant)
        self.norm3 = GammaLayerNorm(dim)
        self.feed_forward = FeedForward(dim, mult, quant)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_mask: torch.Tensor | None = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), deterministic, generator)
        x = x + self.cross_attn(self.norm2(x), deterministic, generator,
                                context=context, context_mask=context_mask)
        return x + self.feed_forward(self.norm3(x))


class Decoder(nn.Module):
    """Bidirectional self-attention -> cross-attention -> FFN stack (Muse's
    decoder)."""

    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 depth: int = 6, mult: float = 4, dropout: float = 0.0,
                 quant: str | None = None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(dim, n_heads, d_head, mult, dropout, quant)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_mask: torch.Tensor | None = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, context, context_mask, deterministic, generator)
        return x
