"""Nearest codebook entry: kernel (csrc/codebook.cu) and plain version.

Counterpart of ``attention_models_tpu/ops/codebook.py``. Distances
``|e|^2 - 2 z.e`` (the per-token ``|z|^2`` is dropped, argmin-invariant) are
accumulated in fp32 and ties go to the first (lowest) index, as
``torch.argmin`` does. Indices come back as int32 ``(n,)``; callers widen to
int64 only for the embedding gather. The kernel takes every code width, as
the JAX package computes every width. ``codes_plan`` routes widths 8, 16, 32
and 64 to the Hopper designs (bf16: the dots on wgmma; fp32: exact FMA dots
on register tiles, the parent kernel's bits) and any other width to the
first design, in 32-wide steps through shared memory.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops.dispatch import check_tensor, is_kernel_path
from attention_models_torch.ops.gemm_sm90 import SM_COUNT

# csrc/codebook.cu: 128 tokens a block; the new designs walk their codebook
# slice in chunks of 128 codes
BLOCK_TOKENS, CHUNK = 128, 128
NEW_WIDTHS = (8, 16, 32, 64)  # code widths the new designs take
ANY, WGMMA, TILES = 0, 1, 2   # the designs (the C entry's design_of)
BLOCKS_PER_SM = 2             # of either new design (kWgBlocks, kTileBlocks)
CODES_PER_BLOCK = 512  # the any-width kernel's codebook slice (a multiple of 128)


@dataclass(frozen=True)
class CodesPlan:
    """One call's launch: the design (the C entry derives it from the
    dtype and the width; here it sizes the work scratch), the codes of a
    slice (``split``, a multiple of CHUNK), the slices (grid.y), the
    entries of each (min, argmin) scratch (n x slices, or 0 where one slice
    of a new design writes the indices itself) and the 4-byte entries of
    the new designs' work scratch (|e|^2 in k rounded up to 4, a ticket a
    128-token tile rounded up to 4, then for fp32 the transposed codebook,
    d rows of the first length)."""
    design: int
    split: int
    slices: int
    parts: int
    work: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slice_cost(n: int, k: int, slots: int, s: int) -> int:
    """Waves of blocks x (chunks a slice + one for a block's own start and
    finish) when the codebook is cut into ``s`` slices."""
    return (_cdiv(_cdiv(n, BLOCK_TOKENS) * s, slots)
            * (_cdiv(_cdiv(k, CHUNK), s) + 1))


@functools.lru_cache(maxsize=64)
def codes_plan(n: int, k: int, d: int, dtype: torch.dtype) -> CodesPlan:
    """The launch of ``nearest_codes`` for z (n, d) against codes (k, d):
    the cheapest slice count (ties to fewer), since 64 token tiles of 8192
    tokens fill one wave only with the codebook split. Cached on the shape:
    the search is host time on every call of a host-bound path."""
    if d not in NEW_WIDTHS:
        slices = _cdiv(k, CODES_PER_BLOCK)
        return CodesPlan(ANY, CODES_PER_BLOCK, slices, n * slices, 0)
    design = WGMMA if dtype == torch.bfloat16 else TILES
    slots = SM_COUNT * BLOCKS_PER_SM
    s = min(range(1, _cdiv(k, CHUNK) + 1),
            key=lambda s: (slice_cost(n, k, slots, s), s))
    split = _cdiv(_cdiv(k, s), CHUNK) * CHUNK
    slices = _cdiv(k, split)
    ldt, tickets = _cdiv(k, 4) * 4, _cdiv(_cdiv(n, BLOCK_TOKENS), 4) * 4
    return CodesPlan(design, split, slices, n * slices if slices > 1 else 0,
                     ldt * (1 + (d if design == TILES else 0)) + tickets)


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """TMA reads 16-byte aligned rows: a view off that alignment is copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    plan = codes_plan(n, k, d, z.dtype)
    z, codes = _aligned(z), _aligned(codes)
    # the slices' (min, argmin) pairs, combined in slice order by the last
    # block of each token tile (the first design: by a second launch);
    # |e|^2, the tiles' tickets (and the fp32 codebook transposed)
    part_d = torch.empty(plan.parts, dtype=torch.float32, device=z.device)
    part_i = torch.empty(plan.parts, dtype=torch.int32, device=z.device)
    work = torch.empty(plan.work, dtype=torch.float32, device=z.device)
    out = torch.empty(n, dtype=torch.int32, device=z.device)
    with torch.cuda.device(z.device):
        _build.launch(
            "amt_nearest_codes", z.data_ptr(), codes.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), out.data_ptr(), n, k, d,
            plan.split, _build.DTYPE_CODES[z.dtype], work.data_ptr(),
            _build.stream_of(z),
        )
    nearest_codes.launches += 1
    return out


nearest_codes.launches = 0
