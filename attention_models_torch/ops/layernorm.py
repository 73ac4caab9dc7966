"""Row LayerNorm: kernel (csrc/layernorm.cu) and plain version.

Counterpart of ``attention_models_tpu/ops/layernorm.py``: fp32 statistics,
biased variance (torch ``F.layer_norm`` semantics), optional beta, output in
the input's dtype. The kernel takes every last dim: a warp a row in
registers up to 4096 (1024 when it is not a multiple of the 16-byte vector
width), so the patch-embed LayerNorm at d = 192 runs on it too, and a block
a row looping over wider rows. The JAX package's gate (d % 128 and rows % 8)
sends a subset of these to its kernel and the rest to XLA; here none raises
and none runs the plain version on the card.

On the card the kernel is the forward of ``_LayerNormFn``; its backward is
the plain vjp of ``_ln_reference``, as the JAX package's ``_ln_b_bwd`` /
``_ln_nb_bwd`` take it. Without a gradient to record (serving, ``no_grad``)
the wrapper launches the kernel directly (``needs_grad``).
"""

from __future__ import annotations

import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops.dispatch import (
    check_tensor,
    is_kernel_path,
    needs_grad,
)


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


def _layernorm_kernel(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor | None, eps: float) -> torch.Tensor:
    """Checks, then one launch of the kernel; counts the launch."""
    check_tensor(x, "x", (torch.float32, torch.bfloat16))
    d = x.shape[-1]
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


class _LayerNormFn(torch.autograd.Function):
    """Forward: the kernel. Backward: the plain vjp of ``_ln_reference``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, gamma, beta)
        return _layernorm_kernel(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True)
                  for t in (x, gamma, beta) if t is not None]
        with torch.enable_grad():
            y = _ln_reference(inputs[0], inputs[1],
                              inputs[2] if beta is not None else None, ctx.eps)
            grads = torch.autograd.grad(y, inputs, g)
        dbeta = grads[2] if beta is not None else None
        return grads[0], grads[1], dbeta, None


def layernorm(x: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor | None = None,
              eps: float = 1e-5) -> torch.Tensor:
    """Differentiable LayerNorm over the last axis of ``x`` (..., d): the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not is_kernel_path(x):
        return _ln_reference(x, gamma, beta, eps)
    if needs_grad(x, gamma, beta):
        return _LayerNormFn.apply(x, gamma, beta, eps)
    return _layernorm_kernel(x, gamma, beta, eps)


layernorm.launches = 0
