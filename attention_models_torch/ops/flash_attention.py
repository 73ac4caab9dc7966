"""Flash attention forward on packed kv: kernel (csrc/flash_attention.cu) and
plain version.

Counterpart of ``attention_models_tpu/ops/flash_attention.py``'s
``flash_attention_bthd_kv`` forward: q is (b, tq, h, d) and kv is
(b, tk, 2, h, d), the fused kv projection's output viewed in place, so k and
v are never split into copies. Returns ``(out, lse)``: out in q's dtype and
the natural-log logsumexp (b, tq, h) in fp32. The causal mask is
bottom-right aligned; tq > tk with ``causal=True`` raises. The kernel takes
bf16 (tensor-core products, exp2 softmax) and fp32 (exact FMA products and
``expf``), head dim 64 only.
"""

from __future__ import annotations

import math

import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops.attention import make_causal_mask
from attention_models_torch.ops.dispatch import check_tensor, is_kernel_path

HEAD_DIM = 64  # the head width csrc/flash_attention.cu is written for


def _check_causal_lengths(tq: int, tk: int) -> None:
    """With the bottom-right-aligned mask, tq > tk leaves the first tq - tk
    query rows with no visible key (0/0 in the softmax): refuse the shape."""
    if tq > tk:
        raise ValueError(
            f"causal flash attention requires tq <= tk (got tq={tq}, "
            f"tk={tk}): rows before tq-tk have no visible keys under the "
            f"bottom-right-aligned mask"
        )


def _flash_reference(q: torch.Tensor, kv: torch.Tensor, scale: float,
                     causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the full fp32 score matrix, its logsumexp and the
    normalised product with v."""
    tq, tk = q.shape[1], kv.shape[1]
    qh = q.float().permute(0, 2, 1, 3)              # (b, h, tq, d)
    kh = kv[:, :, 0].float().permute(0, 2, 1, 3)    # (b, h, tk, d)
    vh = kv[:, :, 1].float().permute(0, 2, 1, 3)
    s = (qh @ kh.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(make_causal_mask(tq, tk, s.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                # (b, h, tq)
    out = torch.exp(s - lse[..., None]) @ vh
    return (out.permute(0, 2, 1, 3).to(q.dtype),
            lse.permute(0, 2, 1).contiguous())


def flash_attention_bthd_kv(
    q: torch.Tensor, kv: torch.Tensor, *, scale: float | None = None,
    causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention of q (b, tq, h, d) over packed kv (b, tk, 2, h, d); returns
    (out (b, tq, h, d), lse (b, tq, h) fp32). The kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.dim() != 4 or kv.dim() != 5 or kv.shape[2] != 2:
        raise ValueError(f"expected q (b,t,h,d) and kv (b,t,2,h,d), got "
                         f"{tuple(q.shape)} and {tuple(kv.shape)}")
    b, tq, h, d = q.shape
    tk = kv.shape[1]
    if (kv.shape[0], kv.shape[3], kv.shape[4]) != (b, h, d):
        raise ValueError(f"kv {tuple(kv.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if causal:
        _check_causal_lengths(tq, tk)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not is_kernel_path(q):
        return _flash_reference(q, kv, scale, causal)
    check_tensor(q, "q", (torch.float32, torch.bfloat16), 4)
    check_tensor(kv, "kv", (q.dtype,), 5, q.device)
    if d != HEAD_DIM:
        raise ValueError(f"flash kernel: head dim {d}, needs {HEAD_DIM}")
    if q.data_ptr() % 16 or kv.data_ptr() % 16:
        raise ValueError("flash kernel: q and kv must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty(b, tq, h, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch(
            "amt_flash_fwd_kv", q.data_ptr(), kv.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, tq, tk, h, d, scale, int(causal),
            _build.DTYPE_CODES[q.dtype], _build.stream_of(q),
        )
    flash_attention_bthd_kv.launches += 1
    return out, lse


flash_attention_bthd_kv.launches = 0
