"""Fused classifier head + softmax cross-entropy: kernels (csrc/xent.cu)
and plain versions.

Counterpart of ``attention_models_tpu/ops/xent.py``. ``fused_head_xent``
is the mean cross-entropy over the non-ignored positions of ``h W^T (+
bias)`` against ``targets``, without the (n, V) logits in device memory:
the forward kernel writes each row's (max, sum of exp, target logit) over
every 128-column tile of the logits and merges them in column order, the
backward kernel writes dl = (softmax - onehot) * coef once and forms dh
and dW from it. Numerics as the TPU kernels: the product accumulates in
fp32 and is rounded to h's dtype (plus the bias in that dtype) before the
fp32 softmax; dl is rounded to h's dtype before both products; dW and db
are fp32. In bf16 the products are csrc/gemm_sm90.cuh's TMA/wgmma tile
product, planned on the host by ``xent_fwd_plan`` (the logits h W^T with
the statistics formed in its epilogue) and ``xent_bwd_plan``
(``ops/gemm_sm90.py``: the logits with dl formed in its epilogue, dh = dl
W with W read MN-major, dW = dl^T h with both operands MN-major); in fp32
the logits run on csrc/gemm.cuh's register-tiled FMA product, with no
plan.

``w`` is the head weight in the torch Linear layout (V, d) (the TPU kernel
takes its transpose (d, V)). On the card ``_HeadNll`` wires the two kernels
into autograd, as ``_head_nll.defvjp`` does: it returns each row's nll,
and the mean over valid rows (plain tensor code, as in JAX) hands its
backward the per-row cotangent ``coef`` (1 / valid count on valid rows, 0
on ignored ones). Without a gradient to record the forward kernel runs
directly (``needs_grad``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops.dispatch import (
    check_tensor,
    is_kernel_path,
    needs_grad,
    rows_lane_tileable,
)
from attention_models_torch.ops.gemm_sm90 import (
    GEMM_ROWS,
    K_MAJOR,
    MN_MAJOR,
    GemmPlan,
    PlanArray,
    gemm_plan,
    meta,
    scratch_meta,
)

TILE = 128  # rows and vocab columns of csrc/xent.cu's logits tiles (fp32)


def _logits(h, w, bias):
    """h w^T accumulated in fp32 from h's dtype's operands, rounded to h's
    dtype, plus the bias in that dtype; returned in fp32."""
    dt = h.dtype
    lg = (h.float() @ w.to(dt).float().T).to(dt)
    if bias is not None:
        lg = lg + bias.to(dt)
    return lg.float()


def _target_logit(lg, targets):
    """l[target] per row, 0 where the target lies outside [0, V)."""
    inside = (targets >= 0) & (targets < lg.shape[-1])
    picked = lg.gather(-1, torch.where(inside, targets, 0).long()[:, None])[:, 0]
    return torch.where(inside, picked, torch.zeros_like(picked))


def _head_xent_reference(h, w, targets, ignore_index=-1, bias=None):
    """Plain version of the forward kernel: h (n, d), w (V, d), targets
    (n,). Returns (nll, lse), fp32 (n,); a row whose target lies outside
    [0, V) (``ignore_index`` included) gets nll = lse, for the caller to
    mask."""
    lg = _logits(h, w, bias)
    lse = torch.logsumexp(lg, dim=-1)
    return lse - _target_logit(lg, targets), lse


def _head_xent_backward_reference(h, w, targets, lse, coef, bias=None):
    """Plain version of the backward kernel for the per-row cotangent
    ``coef`` of the nll: (dh in h's dtype, dW (V, d) fp32, db (V,) fp32 or
    None)."""
    dt = h.dtype
    lg = _logits(h, w, bias)
    p = torch.exp(lg - lse[:, None])
    onehot = torch.zeros_like(p)
    inside = (targets >= 0) & (targets < lg.shape[-1])
    onehot[inside, targets[inside].long()] = 1.0
    dl32 = (p - onehot) * coef.float()[:, None]
    db = dl32.sum(0) if bias is not None else None
    dl = dl32.to(dt).float()
    dh = (dl @ w.to(dt).float()).to(dt)
    dw = dl.T @ h.float()
    return dh, dw, db


def _flat(h, targets):
    """h as (n, d) rows and the targets broadcast to its leading shape, as
    the unfused formulation's numpy broadcasting does, as (n,)."""
    return (h.reshape(-1, h.shape[-1]),
            torch.broadcast_to(targets, h.shape[:-1]).reshape(-1))


def _masked_mean(nll, targets, ignore_index):
    """The mean of the rows' nll over the non-ignored ones (0 / 1 when every
    row is ignored)."""
    valid = targets != ignore_index
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def _head_xent_loss_reference(h, w, targets, ignore_index=-1, bias=None):
    """Plain version of ``fused_head_xent`` on any device."""
    hf, tf = _flat(h, targets)
    nll, _ = _head_xent_reference(hf, w, tf, ignore_index, bias)
    return _masked_mean(nll, tf, ignore_index)


def head_xent_supported(shape: tuple, d: int, vocab: int) -> bool:
    """The JAX package's fused-head gate without its backend test: vocab
    and d lane-aligned (128), the rows a nonzero multiple of 8."""
    return vocab % 128 == 0 and rows_lane_tileable(shape, d)


def _check_operands(h, w, bias, targets):
    """The kernels' rules; returns (w, bias) in h's dtype and the targets
    as contiguous int32."""
    check_tensor(h, "h", (torch.float32, torch.bfloat16), 2)
    n, d = h.shape
    wc = w.to(h.dtype).contiguous()
    check_tensor(wc, "w", (h.dtype,), 2, h.device)
    v = wc.shape[0]
    if wc.shape[1] != d or v % 128 or d % 8 or n % 8:
        raise ValueError(f"head xent kernel: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)} (V and the rows need multiples "
                         f"of 128 and 8)")
    bc = None
    if bias is not None:
        bc = bias.to(h.dtype).contiguous()
        check_tensor(bc, "bias", (h.dtype,), 1, h.device)
        if bc.shape != (v,):
            raise ValueError(f"head xent kernel: bias must be ({v},)")
    tg = targets.to(torch.int32).contiguous()
    if tg.shape != (n,) or tg.device != h.device:
        raise ValueError(f"head xent kernel: targets {tuple(tg.shape)} on "
                         f"{tg.device}, expected ({n},) on {h.device}")
    if any(t.data_ptr() % 16 for t in (h, wc) + ((bc,) if bc is not None
                                                 else ())):
        raise ValueError("head xent kernel: h, w, bias must be 16-byte "
                         "aligned")
    return wc, bc, tg


@functools.lru_cache(maxsize=64)
def _xent_fwd_plan(h: tuple, w: tuple) -> PlanArray:
    return PlanArray((gemm_plan(h, K_MAJOR, w, K_MAJOR, TILE, w[1][0],
                                what="head xent forward"),))


def xent_fwd_plan(h: torch.Tensor, w: torch.Tensor) -> PlanArray:
    """Kernel 13's plan for bf16 h (n, d) and w (V, d): its one tile
    product, the logits h W^T with both operands K-major at tile width 128
    (the epilogue writes each row's max, sum of exp and target logit over
    every 128-column tile, never a logit), cached by their shapes, strides
    and 16-byte alignment; a view TMA cannot take raises a ValueError
    naming it."""
    return _xent_fwd_plan(meta("h", h), meta("w", w))


def _head_xent_fwd_kernel(h, w, bias, targets):
    """One launch of the forward kernel: (nll, lse), fp32 (n,). Its fp32
    scratch holds each row's partial statistics over every vocab tile:
    (3, V / 128, n), the tiles the plan's grid covers in bf16."""
    wc, bc, tg = _check_operands(h, w, bias, targets)
    n, d = h.shape
    v = wc.shape[0]
    f32 = dict(dtype=torch.float32, device=h.device)
    plan = xent_fwd_plan(h, wc) if h.dtype == torch.bfloat16 else None
    tiles = plan.plans[0].grid[0] if plan is not None else -(-v // TILE)
    part = torch.empty(3, tiles, n, **f32)
    nll, lse = torch.empty(n, **f32), torch.empty(n, **f32)
    with torch.cuda.device(h.device):
        _build.launch(
            "amt_head_xent_fwd", h.data_ptr(), wc.data_ptr(),
            bc.data_ptr() if bc is not None else None, tg.data_ptr(),
            part.data_ptr(), nll.data_ptr(), lse.data_ptr(),
            None if plan is None else plan.c_array(), n, d, v,
            _build.DTYPE_CODES[h.dtype], _build.stream_of(h),
        )
    fused_head_xent.launches += 1
    return nll, lse


@dataclass(frozen=True)
class XentBwdPlan:
    """Kernel 14's three bf16 tile products (csrc/xent.cu): ``logits``
    h W^T (both K-major; dl formed in the epilogue into the (n, V)
    scratch), ``dh`` dl W (W read MN-major), ``dw`` dl^T h (both operands
    MN-major, K = n split into ordered partials where the tiles do not fill
    the card)."""
    logits: GemmPlan
    dh: GemmPlan
    dw: GemmPlan
    _arr: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_arr",
                           PlanArray((self.logits, self.dh, self.dw)))

    def c_array(self):
        """The 63 int64 values ``amt_head_xent_bwd`` reads (built once)."""
        return self._arr.c_array()


@functools.lru_cache(maxsize=64)
def _xent_bwd_plan(h: tuple, w: tuple) -> XentBwdPlan:
    (n, d), v = h[1], w[1][0]
    dl = scratch_meta("dl", n, v, v)
    what = "head xent backward"
    return XentBwdPlan(
        gemm_plan(h, K_MAJOR, w, K_MAJOR, 128, v, what=what),
        gemm_plan(dl, K_MAJOR, w, MN_MAJOR, 128, d, what=what),
        gemm_plan(dl, MN_MAJOR, h, MN_MAJOR, 128, d, split=True, what=what))


def xent_bwd_plan(h: torch.Tensor, w: torch.Tensor) -> XentBwdPlan:
    """Kernel 14's plan for bf16 h (n, d) and w (V, d), cached by their
    shapes, strides and 16-byte alignment; a view TMA cannot take raises a
    ValueError naming it."""
    return _xent_bwd_plan(meta("h", h), meta("w", w))


def head_xent_backward(h, w, targets, lse, coef, *, bias=None):
    """Gradients of the per-row nll for the cotangent ``coef`` (n,): (dh in
    h's dtype, dW (V, d) fp32, db (V,) fp32 or None). The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if not is_kernel_path(h):
        return _head_xent_backward_reference(h, w, targets, lse, coef, bias)
    wc, bc, tg = _check_operands(h, w, bias, targets)
    n, d = h.shape
    v = wc.shape[0]
    lse = lse.float().contiguous()
    coef = coef.float().contiguous()
    for name, t in (("lse", lse), ("coef", coef)):
        if t.shape != (n,) or t.device != h.device:
            raise ValueError(f"head xent backward: {name} must be ({n},)")
    f32 = dict(dtype=torch.float32, device=h.device)
    plan = xent_bwd_plan(h, wc) if h.dtype == torch.bfloat16 else None
    # db partials: bf16 one row per warpgroup (64 rows) of each 128-row
    # tile, fp32 one per 128-row tile
    db_rows = (2 * -(-n // GEMM_ROWS) if plan is not None
               else -(-n // TILE))
    dl = torch.empty(n, v, dtype=h.dtype, device=h.device)
    dbpart = torch.empty(db_rows, v, **f32) if bc is not None else None
    wpart = (torch.empty(plan.dw.splits, v, d, **f32)
             if plan is not None and plan.dw.splits > 1 else None)
    dh = torch.empty_like(h)
    dw = torch.empty(v, d, **f32)
    db = torch.empty(v, **f32) if bc is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(h.device):
        _build.launch(
            "amt_head_xent_bwd", h.data_ptr(), wc.data_ptr(), ptr(bc),
            tg.data_ptr(), lse.data_ptr(), coef.data_ptr(), dl.data_ptr(),
            ptr(dbpart), dh.data_ptr(), dw.data_ptr(), ptr(db), ptr(wpart),
            None if plan is None else plan.c_array(), n, d, v,
            _build.DTYPE_CODES[h.dtype], _build.stream_of(h),
        )
    head_xent_backward.launches += 1
    return dh, dw, db


head_xent_backward.launches = 0


class _HeadNll(torch.autograd.Function):
    """Per-row nll through the forward kernel; the backward kernel for the
    rows' cotangent. Returns the weight and bias gradients in their
    parameters' dtypes."""

    @staticmethod
    def forward(ctx, h, w, bias, targets):
        nll, lse = _head_xent_fwd_kernel(h, w, bias, targets)
        ctx.dtypes = (w.dtype, None if bias is None else bias.dtype)
        ctx.save_for_backward(h, w, bias, targets, lse)
        return nll

    @staticmethod
    def backward(ctx, coef):
        h, w, bias, targets, lse = ctx.saved_tensors
        dh, dw, db = head_xent_backward(h, w, targets, lse, coef, bias=bias)
        return (dh, dw.to(ctx.dtypes[0]),
                None if db is None else db.to(ctx.dtypes[1]), None)


def fused_head_xent(
    h: torch.Tensor,        # (..., d) final hidden states
    w: torch.Tensor,        # (V, d) head weight
    targets: torch.Tensor,  # broadcastable to h.shape[:-1]
    ignore_index: int = -1,
    *,
    bias: torch.Tensor | None = None,  # (V,): Parti's biased head
) -> torch.Tensor:
    """Mean cross-entropy over the non-ignored positions of ``h w^T (+
    bias)``: the kernels for a CUDA tensor, the plain version for a CPU
    tensor. ``targets`` broadcast to h's leading shape, as the unfused
    formulation's do."""
    if not is_kernel_path(h):
        return _head_xent_loss_reference(h, w, targets, ignore_index, bias)
    hf, tf = _flat(h, targets)
    hf = hf.contiguous()
    if needs_grad(hf, w, bias):
        nll = _HeadNll.apply(hf, w, bias, tf)
    else:
        nll, _ = _head_xent_fwd_kernel(hf, w, bias, tf)
    return _masked_mean(nll, tf, ignore_index)


fused_head_xent.launches = 0
