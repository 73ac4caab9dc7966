"""Nearest codebook entry: kernel (csrc/codebook.cu) and plain version.

Counterpart of ``attention_models_tpu/ops/codebook.py``. Distances
``|e|^2 - 2 z.e`` (the per-token ``|z|^2`` is dropped, argmin-invariant) are
accumulated in fp32 and ties go to the first (lowest) index, as
``torch.argmin`` does. Indices come back as int32 ``(n,)``; callers widen to
int64 only for the embedding gather. The kernel takes every code width, as
the JAX package computes every width: 8, 16, 32 and 64 with each token in
registers, any other in 32-wide steps through shared memory.
"""

from __future__ import annotations

import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops.dispatch import check_tensor, is_kernel_path

CODES_PER_BLOCK = 512  # codebook slice of one block (a multiple of 128)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize`` semantics: x / max(|x|, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def _nearest_codes_reference(z: torch.Tensor,
                             codes: torch.Tensor) -> torch.Tensor:
    """Plain version: the (n, k) fp32 distance matrix and its argmin."""
    zf, cf = z.float(), codes.float()
    d = torch.sum(cf * cf, dim=-1)[None, :] - 2.0 * (zf @ cf.T)
    return torch.argmin(d, dim=-1).to(torch.int32)


def nearest_codes(z: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """argmin_j |z_i - e_j|^2 for z (n, d) against codes (k, d), both bf16
    (bf16 operands, exact fp32 products and sums) or both fp32 (the exact
    path the golden index check runs)."""
    z, codes = z.detach(), codes.detach()
    if not is_kernel_path(z):
        return _nearest_codes_reference(z, codes)
    check_tensor(z, "z", (torch.float32, torch.bfloat16), 2)
    check_tensor(codes, "codes", (z.dtype,), 2, z.device)
    n, d = z.shape
    if codes.shape[1] != d or d == 0:
        raise ValueError(f"nearest_codes kernel: code width {d} with codes "
                         f"{tuple(codes.shape)}")
    k = codes.shape[0]
    slices = -(-k // CODES_PER_BLOCK)
    # per-slice (min, argmin) scratch, combined by the kernel's second pass
    part_d = torch.empty(n * slices, dtype=torch.float32, device=z.device)
    part_i = torch.empty(n * slices, dtype=torch.int32, device=z.device)
    out = torch.empty(n, dtype=torch.int32, device=z.device)
    with torch.cuda.device(z.device):
        _build.launch(
            "amt_nearest_codes", z.data_ptr(), codes.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), out.data_ptr(), n, k, d,
            CODES_PER_BLOCK, _build.DTYPE_CODES[z.dtype], _build.stream_of(z),
        )
    nearest_codes.launches += 1
    return out


nearest_codes.launches = 0
