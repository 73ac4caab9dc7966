"""Multi-head attention with the reference's mask semantics (plain path).

Counterpart of ``attention_models_tpu/ops/attention.py``:
  - scores = (q * scale) @ k^T, softmax in fp32, probabilities cast back to
    the input dtype before the value product;
  - ``context_mask`` is a keep mask (b, tk): False positions get -1e9;
  - ``causal_mask`` is an exclude mask (tq, tk): True positions get -1e9.

The causal mask is bottom-right aligned (``make_causal_mask``); torch's
``scaled_dot_product_attention(is_causal=True)`` aligns top-left and is not
this function when tq != tk.
"""

from __future__ import annotations

import torch

MASK_FILL = -1e9


def multihead_attention(
    q: torch.Tensor,  # (b, h, tq, d)
    k: torch.Tensor,  # (b, h, tk, d)
    v: torch.Tensor,  # (b, h, tk, d)
    *,
    scale: float,
    causal_mask: torch.Tensor | None = None,  # (tq, tk) bool, True = exclude
    context_mask: torch.Tensor | None = None,  # (b, tk) bool, True = keep
) -> torch.Tensor:
    orig_dtype = q.dtype
    scores = torch.einsum("bhid,bhjd->bhij", (q * scale).float(), k.float())
    if context_mask is not None:
        keep = context_mask[:, None, None, :]
        scores = torch.where(keep, scores, torch.full_like(scores, MASK_FILL))
    if causal_mask is not None:
        scores = scores.masked_fill(causal_mask[None, None], MASK_FILL)
    probs = torch.softmax(scores, dim=-1).to(orig_dtype)
    return torch.einsum("bhij,bhjd->bhid", probs, v)


def make_causal_mask(tq: int, tk: int | None = None,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """Strict upper-triangular exclude mask, bottom-right aligned:
    True where key j > query i + (tk - tq)."""
    tk = tq if tk is None else tk
    i = torch.arange(tq, device=device)[:, None]
    j = torch.arange(tk, device=device)[None, :]
    return j > i + (tk - tq)
