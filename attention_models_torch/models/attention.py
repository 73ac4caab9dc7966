"""SoftmaxAttention (no decode mode).

Counterpart of ``attention_models_tpu/models/attention.py::SoftmaxAttention``
with the reference's parameter names: no-bias ``q.0``, fused no-bias
``kv.0`` whose output is viewed as (b, t, 2, h, d), biased ``W_o``, scale
``d ** -0.5``. Self-attention, unmasked: the path ViTVQGAN and MaskGIT run.
The packed kv goes to the flash op unsplit; on the card its backward
returns the packed (dk, dv) cotangent, so the split never happens in either
direction.
``dropout`` drops q, the packed kv and the output, as the JAX module does,
when the forward is not ``deterministic``.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_models_torch.models.layers import Dropout, Linear
from attention_models_torch.ops.flash_attention import (
    _flash_reference,
    flash_attention_bthd_kv,
)


class SoftmaxAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.dim_head = num_heads, dim_head
        self.q = nn.Sequential(Linear(dim, num_heads * dim_head, bias=False))
        self.kv = nn.Sequential(
            Linear(dim, 2 * num_heads * dim_head, bias=False))
        self.W_o = Linear(num_heads * dim_head, dim)
        self.drop = Dropout(dropout)
        self.kernels = True

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h, d = self.num_heads, self.dim_head
        b, t = x.shape[:2]
        q = self.drop(self.q(x), deterministic, generator).view(b, t, h, d)
        kv = self.drop(self.kv(x), deterministic, generator).view(
            b, t, 2, h, d)
        if self.kernels:
            out, _ = flash_attention_bthd_kv(q, kv, scale=d ** -0.5)
        else:
            out, _ = _flash_reference(q, kv, d ** -0.5, False)
        return self.drop(self.W_o(out.reshape(b, t, h * d)), deterministic,
                         generator)
