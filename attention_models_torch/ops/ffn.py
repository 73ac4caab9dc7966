"""Fused pre-LN MLP block, x + Mlp(LayerNorm(x)): kernel (csrc/ln_mlp.cu)
and plain version.

Counterpart of ``attention_models_tpu/ops/ffn.py``'s ``fused_ln_mlp``
forward (bf16 only, as there). Weights are in the torch Linear layout:
w1 (hid, d), w2 (d, hid). The kernel's gelu uses the true erf; the TPU
kernel's A&S polynomial differs from it by at most 1.5e-7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from attention_models_torch.ops import _build
from attention_models_torch.ops.dispatch import check_tensor, is_kernel_path
from attention_models_torch.ops.layernorm import _ln_reference

KERNEL_DIMS = (512,)  # model widths csrc/ln_mlp.cu instantiates


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """gelu(approximate=False): x * Phi(x) with the true erf."""
    return F.gelu(x, approximate="none")


def _mlp_reference(x, w1, b1, w2, b2):
    """Linear -> exact gelu -> Linear in x's dtype (models/layers.py Mlp)."""
    dt = x.dtype
    h = gelu_exact(F.linear(x, w1.to(dt), b1.to(dt)))
    return F.linear(h, w2.to(dt), b2.to(dt))


def _ln_mlp_reference(x, lng, lnb, w1, b1, w2, b2, eps):
    """Plain version: x + Mlp(LayerNorm(x)), LayerNorm with fp32 stats."""
    return x + _mlp_reference(_ln_reference(x, lng, lnb, eps), w1, b1, w2, b2)


def fused_ln_mlp(
    x: torch.Tensor,      # (..., d) bf16
    ln_gamma: torch.Tensor,  # (d,)
    ln_beta: torch.Tensor,   # (d,)
    w1: torch.Tensor,     # (hid, d)
    b1: torch.Tensor,     # (hid,)
    w2: torch.Tensor,     # (d, hid)
    b2: torch.Tensor,     # (d,)
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x + gelu(LN(x) @ w1^T + b1) @ w2^T + b2: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if not is_kernel_path(x):
        return _ln_mlp_reference(x, ln_gamma, ln_beta, w1, b1, w2, b2, eps)
    check_tensor(x, "x", (torch.bfloat16,))
    d = x.shape[-1]
    hid = w1.shape[0]
    check_tensor(w1, "w1", (torch.bfloat16,), 2, x.device)
    check_tensor(w2, "w2", (torch.bfloat16,), 2, x.device)
    if d not in KERNEL_DIMS or w1.shape != (hid, d) or w2.shape != (d, hid):
        raise ValueError(f"ln_mlp kernel: d={d} (needs one of {KERNEL_DIMS}),"
                         f" w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if hid % 8:
        raise ValueError(f"ln_mlp kernel: hidden width {hid} not a multiple "
                         f"of 8")
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("ln_mlp kernel: x, w1, w2 must be 16-byte aligned")
    vecs = []
    for name, p, size in (("ln_gamma", ln_gamma, d), ("ln_beta", ln_beta, d),
                          ("b1", b1, hid), ("b2", b2, d)):
        check_tensor(p, name, (torch.float32, torch.bfloat16), 1, x.device)
        if p.shape != (size,):
            raise ValueError(f"ln_mlp kernel: {name} must be ({size},)")
        vecs.append(p.float().contiguous())
    lng, lnb, b1f, b2f = vecs
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.launch(
            "amt_ln_mlp", x.data_ptr(), lng.data_ptr(), lnb.data_ptr(),
            w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(),
            out.data_ptr(), x.numel() // d, d, hid, eps, _build.stream_of(x),
        )
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0
