"""Row LayerNorm: kernel (csrc/layernorm.cu) and plain version.

Counterpart of ``attention_models_tpu/ops/layernorm.py``: fp32 statistics,
biased variance (torch ``F.layer_norm`` semantics), optional beta, output in
the input's dtype. The kernel takes any last dim up to 4096 (1024 when it is
not a multiple of the 16-byte vector width), so the patch-embed LayerNorm at
d = 192 runs on it too.
"""

from __future__ import annotations

import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops.dispatch import check_tensor, is_kernel_path


def _ln_reference(x: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor | None, eps: float) -> torch.Tensor:
    """Plain version: fp32 mean and biased variance, cast back at the end."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) / torch.sqrt(var + eps)
    y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor | None = None,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (..., d): the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if not is_kernel_path(x):
        return _ln_reference(x, gamma, beta, eps)
    check_tensor(x, "x", (torch.float32, torch.bfloat16))
    d = x.shape[-1]
    vec = 16 // x.element_size()
    if d > (4096 if d % vec == 0 else 1024):
        raise ValueError(f"layernorm kernel: d={d} too wide")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p is not None:
            check_tensor(p, name, (torch.float32, torch.bfloat16), 1, x.device)
            if p.shape != (d,):
                raise ValueError(f"layernorm kernel: {name} must be ({d},)")
    g = gamma.float().contiguous()
    b = beta.float().contiguous() if beta is not None else None
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.launch(
            "amt_layernorm", x.data_ptr(), g.data_ptr(),
            b.data_ptr() if b is not None else None, y.data_ptr(),
            x.numel() // d, d, eps, _build.DTYPE_CODES[x.dtype],
            _build.stream_of(x),
        )
    layernorm.launches += 1
    return y


layernorm.launches = 0
