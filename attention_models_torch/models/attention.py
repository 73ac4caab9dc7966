"""SoftmaxAttention (no decode mode).

Counterpart of ``attention_models_tpu/models/attention.py::SoftmaxAttention``
with the reference's parameter names: no-bias ``q.0``, fused no-bias
``kv.0`` whose output is viewed as (b, t, 2, h, d), biased ``W_o``, scale
``d ** -0.5``. Self-attention, or cross-attention to a ``context`` whose kv
keeps its own batch, with an optional ``context_mask`` (b, tk) keep mask.

Dispatch is the JAX package's ``_dispatch_attention`` on one device: without
a mask and where ``flash_supported`` holds, the flash op on the packed kv
(which goes to it unsplit; on the card its backward returns the packed
(dk, dv) cotangent, so the split never happens in either direction);
otherwise the plain ``multihead_attention`` with the masks, as JAX runs XLA
there (Muse's cross-attention over 77 text tokens, the shapes below 128
tokens). A flash-sized kv batch unlike q's raises a ValueError: the JAX
package's separate-k/v kernel, the only one there that takes separate k and
v, reads k and v at q's batch index, so it defines no result for that shape.
``dropout`` drops q, the packed kv and the output, as the JAX module does,
when the forward is not ``deterministic``. ``quant="int8"`` runs the three
projections through ``quant_dot`` (JAX's ``_proj``); "int8_wide" leaves
them in the model dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_models_torch.models.layers import Dropout, Linear
from attention_models_torch.ops.attention import multihead_attention
from attention_models_torch.ops.flash_attention import (
    _flash_reference,
    flash_attention_bthd_kv,
    flash_supported,
)


class SoftmaxAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, quant: str | None = None):
        super().__init__()
        self.num_heads, self.dim_head = num_heads, dim_head
        proj_quant = "int8" if quant == "int8" else None
        inner = num_heads * dim_head
        self.q = nn.Sequential(Linear(dim, inner, bias=False, quant=proj_quant))
        self.kv = nn.Sequential(
            Linear(dim, 2 * inner, bias=False, quant=proj_quant))
        self.W_o = Linear(inner, dim, quant=proj_quant)
        self.drop = Dropout(dropout)
        self.kernels = True

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None, *,
                context: torch.Tensor | None = None,
                context_mask: torch.Tensor | None = None) -> torch.Tensor:
        h, d = self.num_heads, self.dim_head
        b, t = x.shape[:2]
        src = x if context is None else context
        q = self.drop(self.q(x), deterministic, generator).view(b, t, h, d)
        kv = self.drop(self.kv(src), deterministic, generator).view(
            src.shape[0], src.shape[1], 2, h, d)
        scale = d ** -0.5
        if context_mask is None and flash_supported(
                (b, h, t, d), (kv.shape[0], h, kv.shape[1], d),
                q.element_size()):
            if kv.shape[0] != b:
                raise ValueError(
                    f"flash attention over a kv batch ({kv.shape[0]}) unlike "
                    f"q's ({b}) has no defined result: the JAX package's "
                    f"separate-k/v kernel (_flash_kernel_mh, grid over q's "
                    f"batch) reads k and v at q's batch index")
            if self.kernels:
                out, _ = flash_attention_bthd_kv(q, kv, scale=scale)
            else:
                out, _ = _flash_reference(q, kv, scale, False)
        else:
            heads = lambda a: a.transpose(1, 2)  # noqa: E731
            out = heads(multihead_attention(
                heads(q), heads(kv[:, :, 0]), heads(kv[:, :, 1]), scale=scale,
                context_mask=context_mask))
        out = out.reshape(out.shape[0], out.shape[1], h * d)
        return self.drop(self.W_o(out), deterministic, generator)
