"""Flash attention on packed kv, forward and backward: kernels
(csrc/flash_attention.cu, csrc/flash_attention_bwd.cu) and plain versions.

Counterpart of ``attention_models_tpu/ops/flash_attention.py``'s
``flash_attention_bthd_kv``: q is (b, tq, h, d) and kv is (b, tk, 2, h, d),
the fused kv projection's output viewed in place, so k and v are never split
into copies. The forward returns ``(out, lse)``: out in q's dtype and the
natural-log logsumexp (b, tq, h) in fp32. The causal mask is bottom-right
aligned; tq > tk with ``causal=True`` raises. The kernels take bf16
(tensor-core products, exp2 softmax) and fp32 (exact FMA products and
``expf``), head dim 64 only.

On the card ``_FlashKV`` wires the two kernels into autograd: its forward
saves ``(q, kv, out, lse)`` as ``_flash_bthd_kv_fwd`` does, and its backward
takes ``delta = rowsum(o * do)`` (``flash_delta``, plain) and launches the
backward kernel for ``(dq, dkv)``. Without a gradient to record (serving,
``no_grad``) the wrapper launches the forward kernel directly
(``needs_grad``).
"""

from __future__ import annotations

import math

import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops.attention import make_causal_mask
from attention_models_torch.ops.dispatch import (
    check_tensor,
    is_kernel_path,
    needs_grad,
)

HEAD_DIM = 64  # the head width the flash kernels are written for
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _check_causal_lengths(tq: int, tk: int) -> None:
    """With the bottom-right-aligned mask, tq > tk leaves the first tq - tk
    query rows with no visible key (0/0 in the softmax): refuse the shape."""
    if tq > tk:
        raise ValueError(
            f"causal flash attention requires tq <= tk (got tq={tq}, "
            f"tk={tk}): rows before tq-tk have no visible keys under the "
            f"bottom-right-aligned mask"
        )


def _pick_block(t: int, pref: int) -> int:
    """Largest block <= pref of (pref, 512, ..., 8) that divides t (the JAX
    package's ``_pick_block``)."""
    for cand in (pref, 512, 256, 128, 64, 32, 16, 8):
        if cand <= pref and t % cand == 0:
            return cand
    raise ValueError(f"sequence length {t} has no supported block tiling")


def _mh_pick_blocks(tq: int, tk: int, h: int, d: int, pref_bq: int,
                    pref_bk: int, itemsize: int) -> tuple[int, int]:
    """The JAX package's ``_mh_pick_blocks``: the TPU kernel's VMEM budget
    (14 MiB of blocks), which decides there which shapes reach it."""
    hd = h * d
    for bkp in (pref_bk, 512, 256, 128):
        if bkp > pref_bk:
            continue
        bk = _pick_block(tk, bkp)
        for bqp in (pref_bq, 512, 256, 128, 64, 32, 16, 8):
            if bqp > pref_bq:
                continue
            bq = _pick_block(tq, bqp)
            used = (2 * bq * hd * itemsize + 2 * 2 * tk * hd * itemsize
                    + 2 * (bq * hd * itemsize + bq * h * 4)
                    + 2 * bq * bk * 4 + bq * bk * itemsize + bq * d * 4)
            if used <= 14 * 1024 * 1024:
                return bq, bk
    raise ValueError(f"no VMEM-fitting blocks for mh flash at tq={tq} tk={tk} "
                     f"h={h} d={d}")


def flash_supported(q_shape: tuple, k_shape: tuple, itemsize: int = 2) -> bool:
    """The JAX package's flash dispatch predicate (``flash_supported``)
    without its backend test: q (b, h, tq, d) and k (b, h, tk, d) with tq,
    tk >= 128 and multiples of 8, within the TPU kernels' block budget in
    the forward's and the backward's roles. The port sends exactly these
    shapes to the flash op, so its kernel runs where the TPU kernel runs
    (fp32 at h 16, t 1024 does not fit that budget and takes the plain
    attention, as it takes XLA's there)."""
    _, h, tq, d = q_shape
    tk = k_shape[2]
    if tq < 128 or tk < 128 or tq % 8 or tk % 8:
        return False
    try:
        _mh_pick_blocks(tq, tk, h, d, 512, 1024, itemsize)
        _mh_pick_blocks(tk, tq, h, d, 1024, 512, itemsize)
        return True
    except ValueError:
        return False


def _heads(q: torch.Tensor, kv: torch.Tensor):
    """fp32 (b, h, t, d) views of q, k and v."""
    return (q.float().permute(0, 2, 1, 3), kv[:, :, 0].float().permute(0, 2, 1, 3),
            kv[:, :, 1].float().permute(0, 2, 1, 3))


def _scores(qh, kh, scale: float, causal: bool) -> torch.Tensor:
    s = (qh @ kh.transpose(-1, -2)) * scale
    if causal:
        tq, tk = s.shape[-2:]
        s = s.masked_fill(make_causal_mask(tq, tk, s.device), float("-inf"))
    return s


def _flash_reference(q: torch.Tensor, kv: torch.Tensor, scale: float,
                     causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the full fp32 score matrix, its logsumexp and the
    normalised product with v. In bf16 with the kernels' rounding points
    (the TPU kernel's and csrc/flash_attention.cu's): q scaled by
    scale * log2(e) and rounded to bf16, the softmax in exp2, P rounded to
    bf16 for the PV product while its row sum stays fp32."""
    qh, kh, vh = _heads(q, kv)
    if q.dtype == torch.bfloat16:
        q2 = (qh * (scale * LOG2E)).to(q.dtype).float()
        s2 = _scores(q2, kh, 1.0, causal)            # log2 domain
        m = s2.amax(dim=-1, keepdim=True)
        p = torch.exp2(s2 - m)
        lsum = p.sum(dim=-1, keepdim=True)
        out = (p.to(q.dtype).float() @ vh) / lsum
        lse = ((m + torch.log2(lsum)) * LN2)[..., 0]
    else:
        s = _scores(qh, kh, scale, causal)
        lse = torch.logsumexp(s, dim=-1)            # (b, h, tq)
        out = torch.exp(s - lse[..., None]) @ vh
    return (out.permute(0, 2, 1, 3).to(q.dtype),
            lse.permute(0, 2, 1).contiguous())


def flash_delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) over the head dim, fp32 (b, tq, h)."""
    return torch.sum(g.float() * o.float(), dim=-1)


def _flash_backward_reference(q, kv, o, lse, g, scale: float, causal: bool):
    """Plain version of the backward, all in fp32: P = exp(S - lse),
    dV = P^T dO, dS = P * (dO V^T - delta), dQ = dS K * scale,
    dK = dS^T Q * scale. Returns (dq like q, dkv like kv)."""
    qh, kh, vh = _heads(q, kv)
    gh = g.float().permute(0, 2, 1, 3)
    delta = flash_delta(o, g).permute(0, 2, 1)[..., None]   # (b, h, tq, 1)
    p = torch.exp(_scores(qh, kh, scale, causal) - lse.permute(0, 2, 1)[..., None])
    dv = p.transpose(-1, -2) @ gh
    ds = p * (gh @ vh.transpose(-1, -2) - delta)
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    dkv = torch.stack([dk, dv], dim=1).permute(0, 3, 1, 2, 4)  # (b, tk, 2, h, d)
    return (dq.permute(0, 2, 1, 3).to(q.dtype),
            dkv.to(kv.dtype).contiguous())


def _check_shapes(q: torch.Tensor, kv: torch.Tensor, causal: bool) -> None:
    if q.dim() != 4 or kv.dim() != 5 or kv.shape[2] != 2:
        raise ValueError(f"expected q (b,t,h,d) and kv (b,t,2,h,d), got "
                         f"{tuple(q.shape)} and {tuple(kv.shape)}")
    b, tq, h, d = q.shape
    if (kv.shape[0], kv.shape[3], kv.shape[4]) != (b, h, d):
        raise ValueError(f"kv {tuple(kv.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if causal:
        _check_causal_lengths(tq, kv.shape[1])


def _check_kernel_operands(q: torch.Tensor, kv: torch.Tensor,
                           *more: tuple[str, torch.Tensor]) -> None:
    check_tensor(q, "q", (torch.float32, torch.bfloat16), 4)
    check_tensor(kv, "kv", (q.dtype,), 5, q.device)
    for name, t in more:
        check_tensor(t, name, (t.dtype,), None, q.device)
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash kernel: head dim {q.shape[-1]}, needs "
                         f"{HEAD_DIM}")
    if any(t.data_ptr() % 16 for t in (q, kv, *(t for _, t in more))):
        raise ValueError("flash kernel: operands must be 16-byte aligned")


def _flash_fwd_kernel(q, kv, scale: float, causal: bool):
    _check_kernel_operands(q, kv)
    b, tq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, tq, h, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch(
            "amt_flash_fwd_kv", q.data_ptr(), kv.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, tq, kv.shape[1], h, d, scale, int(causal),
            _build.DTYPE_CODES[q.dtype], _build.stream_of(q),
        )
    flash_attention_bthd_kv.launches += 1
    return out, lse


def flash_attention_bwd_kv(q, kv, o, lse, g, *, scale: float,
                           causal: bool = False):
    """(dq, dkv) of ``flash_attention_bthd_kv`` for the cotangent ``g`` of
    ``o``: the kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_shapes(q, kv, causal)
    if not is_kernel_path(q):
        return _flash_backward_reference(q, kv, o, lse, g, scale, causal)
    g = g.contiguous()
    delta = flash_delta(o, g)
    _check_kernel_operands(q, kv, ("o", o), ("lse", lse), ("g", g))
    if o.dtype != q.dtype or g.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash backward: o and g in q's dtype, lse fp32")
    b, tq, h, d = q.shape
    dq = torch.empty_like(q)
    dkv = torch.empty_like(kv)
    with torch.cuda.device(q.device):
        _build.launch(
            "amt_flash_bwd_kv", q.data_ptr(), kv.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dkv.data_ptr(),
            b, tq, kv.shape[1], h, d, scale, int(causal),
            _build.DTYPE_CODES[q.dtype], _build.stream_of(q),
        )
    flash_attention_bwd_kv.launches += 1
    return dq, dkv


flash_attention_bwd_kv.launches = 0


class _FlashKV(torch.autograd.Function):
    """Forward and backward kernels; lse is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, kv, scale, causal):
        out, lse = _flash_fwd_kernel(q, kv, scale, causal)
        ctx.scale, ctx.causal = scale, causal
        ctx.save_for_backward(q, kv, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, kv, out, lse = ctx.saved_tensors
        dq, dkv = flash_attention_bwd_kv(q, kv, out, lse, g, scale=ctx.scale,
                                         causal=ctx.causal)
        return dq, dkv, None, None


def flash_attention_bthd_kv(
    q: torch.Tensor, kv: torch.Tensor, *, scale: float | None = None,
    causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable attention of q (b, tq, h, d) over packed kv
    (b, tk, 2, h, d); returns (out (b, tq, h, d), lse (b, tq, h) fp32). The
    kernels for CUDA tensors, the plain version for CPU tensors."""
    _check_shapes(q, kv, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not is_kernel_path(q):
        return _flash_reference(q, kv, scale, causal)
    if needs_grad(q, kv):
        return _FlashKV.apply(q, kv, scale, causal)
    return _flash_fwd_kernel(q, kv, scale, causal)


flash_attention_bthd_kv.launches = 0
