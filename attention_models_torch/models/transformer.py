"""Pre-LN transformer encoder stack, loop form.

Counterpart of ``attention_models_tpu/models/transformer.py``'s
``EncoderLayer`` and ``Encoder``. Keys are the reference's
(``attention_models_tpu/utils/torch_convert.py::convert_encoder_layer``):
``layers.{i}.norm1.gamma``, ``layers.{i}.self_attn.{q.0,kv.0,W_o}``,
``layers.{i}.norm2.gamma``, ``layers.{i}.feed_forward.ff.{0,2.gamma,3}``.
Self-attention is unmasked (the path MaskGIT runs). ``dropout`` is the
attention's (on q, kv and its output) when the forward is not
``deterministic``; the FFN has none, as in JAX. ``scan_layers``, ``remat``
and pipeline parallelism are not ported yet:
``models/factory.py::build_model`` refuses them.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_models_torch.models.attention import SoftmaxAttention
from attention_models_torch.models.layers import FeedForward, GammaLayerNorm


class EncoderLayer(nn.Module):
    """x + attn(norm1(x)), then x + feed_forward(norm2(x))."""

    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 mult: float = 4, dropout: float = 0.0):
        super().__init__()
        self.norm1 = GammaLayerNorm(dim)
        self.self_attn = SoftmaxAttention(dim, n_heads, d_head, dropout)
        self.norm2 = GammaLayerNorm(dim)
        self.feed_forward = FeedForward(dim, mult)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), deterministic, generator)
        return x + self.feed_forward(self.norm2(x))


class Encoder(nn.Module):
    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 depth: int = 6, mult: float = 4, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(dim, n_heads, d_head, mult, dropout)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, deterministic, generator)
        return x
