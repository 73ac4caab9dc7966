"""W8A8 int8 inference ops: the quantizers, ``quant_dot``, and the three
fused int8 blocks (csrc/quant.cu) with their plain versions.

Counterpart of ``attention_models_tpu/ops/quant.py``, same scheme:
  - weights: per-output-channel symmetric int8, scale = max(amax, 1e-8) / 127,
    q = clip(round_half_even(w / scale), -127, 127), from the fp32 weights;
  - activations: the same per row (token), computed on the fly;
  - products: exact int32 sums, dequantised as (float(acc) * s_row) * s_col
    (+ bias), the int32 -> fp32 conversion rounding once.

A quantized weight is a ``QuantWeight``: the int8 matrix in the torch Linear
layout (d_out, d_in) -- per output channel a row, the rows K-contiguous, the
B operand of an int8 mma as it stands -- and its fp32 scales (d_out,).
Callers quantize once and reuse it (``QuantCache``): a decode loop
quantizes at its first step, as JAX hoists the quantization out of its scan.

- ``quant_dot``: XLA-level in JAX (the projections and heads), plain here:
  the integer product is ``torch._int_mm`` on the card, an exact float64
  product on the CPU (|sum| <= K * 127^2 < 2^53).
- ``fused_ffn_q8`` (kernel 19): the GEGLU FFN with both products in int8.
  On the card: the row codes of x, the up-projection on csrc/gemm_sm90.cuh's
  paired-column tile product in its int8 form (a and gate dequantised, then
  g = gate * gelu(a)), the LayerNorm and row codes of g, then the tile
  product's int8 form; its host plan is ``q8_plan``.
- ``fused_ffn_q8wide`` (kernel 20): the up-projection in x's dtype, the
  down-projection in int8. On the card: the up-projection g = gate *
  gelu(a) on the paired-column tile product (bf16, kernel 11's GEGLU
  product and epilogue) or on the fp64 tensor cores (fp32), then kernel
  19's tail; its host plan is ``q8wide_plan``.
- ``fused_ln_mlp_q8`` (kernel 21): x + W8A8 Mlp(LayerNorm(x)), biased.
  On the card: x's LayerNorm and codes, y_q W1q^T on the tile product's
  int8 form with g = gelu(dequant + b1) in its epilogue, g's codes at a
  64-byte pitch, then g_q W2q^T on the int8 form with the bias and the
  residual x in its epilogue; its host plan is ``ln_mlp_q8_plan``.

The row statistics of the LayerNorms (the GEGLU's gamma-LN over the inner
width, kernel 21's LN over d) are summed in float64 and rounded once to
fp32, in the kernels and in the plain versions alike; the fp32 up-projection
of kernel 20 likewise. The int8 codes are a step function of those values:
with every other operation taken in the same order, the kernels and the
plain versions give the same codes on the card (the TPU kernels sum in fp32,
within an ulp of these). Inference only: no backward, as in JAX.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from attention_models_torch.ops import _build
from attention_models_torch.ops.dispatch import (
    check_tensor,
    is_kernel_path,
    needs_grad,
    rows_lane_tileable,
)
from attention_models_torch.ops.gemm_sm90 import (
    K_MAJOR,
    ROW_ALIGN,
    GemmPlan,
    PlanArray,
    gemm_plan,
    row_pitch,
    scratch_meta,
)

Q8_GEGLU_BN = 256  # the paired GEGLU products' tile width (kernel 11's)
# kernel 21's products: two blocks an SM, so one block's epilogue runs
# under the other's products (at 256 its down-projection's 128 tiles would
# leave SMs idle at the tokenizer's 8192 rows)
LN_MLP_Q8_BN = 128
INT8_ROW_ALIGN = 2 * ROW_ALIGN  # bytes: int8 rows start 64-byte aligned
QUANT_MODES = (None, "int8", "int8_wide")


class QuantWeight(NamedTuple):
    q: torch.Tensor      # (d_out, d_in) int8
    scale: torch.Tensor  # (d_out,) fp32


def check_mode(quant: str | None) -> str | None:
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
    return quant


def quantize_rows(x32: torch.Tensor):
    """Per-row symmetric int8 of fp32 rows: (q int8, scale (..., 1) fp32),
    JAX's ``_quantize_rows_f32`` (``torch.round`` rounds half to even, as
    ``jnp.round`` does)."""
    amax = x32.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8)
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which is not IEEE division
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor) -> QuantWeight:
    """A torch Linear weight (d_out, d_in) per output channel: JAX's
    ``quantize_weight`` of its (d_in, d_out) transpose, from the weight's
    fp32 values."""
    q, scale = quantize_rows(w.float())
    return QuantWeight(q.contiguous(), scale[:, 0].contiguous())


def int_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 of the exact int32 products a (m, k) @ w (n, k)^T of int8
    operands (the conversion rounds once, as JAX's ``astype(float32)``)."""
    if a.is_cuda:
        m, k = a.shape
        n = w.shape[0]
        # torch._int_mm: rows > 16, k and n multiples of 8 (zero padding
        # adds nothing to the sums)
        pm, pk, pn = max(24, -(-m // 8) * 8) - m, -k % 8, -n % 8
        if pm or pk:
            a = F.pad(a, (0, pk, 0, pm))
        if pk or pn:
            w = F.pad(w, (0, pk, 0, pn))
        return torch._int_mm(a, w.t())[:m, :n].float()
    return (a.double() @ w.double().T).float()


def quant_dot(x: torch.Tensor, w: QuantWeight,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """W8A8 ``x @ W^T``: dynamic per-row scales of x, per-channel scales of
    the weight; x (..., d_in) -> (..., d_out) in ``out_dtype`` (x's)."""
    shape = x.shape
    xq, sx = quantize_rows(x.reshape(-1, shape[-1]).float())
    y = int_dot(xq, w.q) * sx * w.scale
    return y.reshape(*shape[:-1], w.q.shape[0]).to(out_dtype or x.dtype)


class QuantCache:
    """A module's quantized weights. While ``store`` is a dict (inside
    ``weights_quantized_once``) a weight is quantized at its first use and
    reused after; otherwise each use quantizes afresh, as an unhoisted JAX
    call does."""

    def __init__(self):
        self.store: dict | None = None

    def get(self, key: str, w: torch.Tensor) -> QuantWeight:
        if self.store is None:
            return quantize_weight(w)
        if key not in self.store:
            self.store[key] = quantize_weight(w)
        return self.store[key]


@contextlib.contextmanager
def weights_quantized_once(model: torch.nn.Module):
    """Hold every ``QuantCache`` of ``model`` (a module's ``q8``) for the
    block: a decode quantizes each weight at its first step only."""
    caches = [m.q8 for m in model.modules()
              if isinstance(getattr(m, "q8", None), QuantCache)]
    for c in caches:
        c.store = {}
    try:
        yield
    finally:
        for c in caches:
            c.store = None


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def ln_rows(v32: torch.Tensor, gamma: torch.Tensor,
            beta: torch.Tensor | None, eps: float) -> torch.Tensor:
    """LayerNorm of fp32 rows with float64 statistics rounded once to fp32:
    mean, c = v - mean, var = mean(c^2), rstd = 1 / sqrt(var + eps) (eps
    as fp32), then (c * rstd) * gamma (+ beta) in fp32 -- csrc/quant.cu's
    row pass operation for operation."""
    mean = v32.double().mean(dim=-1, keepdim=True).float()
    c = v32 - mean
    var = c.double().square().mean(dim=-1, keepdim=True)
    rstd = torch.reciprocal(torch.sqrt(var + float(np.float32(eps)))).float()
    y = c * rstd * gamma.float()
    return y + beta.float() if beta is not None else y


def _keep(codes: dict | None, **named) -> None:
    if codes is not None:
        codes.update(named)


def _ffn_q8_reference(x, q1: QuantWeight, gamma, q2: QuantWeight,
                      eps: float = 1e-5, codes: dict | None = None):
    """Plain version of kernel 19: rows of x quantized, int8 x W1^T,
    dequantised, [a | gate] -> gate * gelu(a), gamma-LN, rows quantized,
    int8 y W2^T, dequantised, in x's dtype. ``codes`` (a dict) receives the
    int8 activations (xq, yq)."""
    d, inner = x.shape[-1], q2.q.shape[1]
    xq, sx = quantize_rows(x.reshape(-1, d).float())
    h = int_dot(xq, q1.q) * sx * q1.scale
    g = h[:, inner:] * gelu_exact(h[:, :inner])
    yq, sy = quantize_rows(ln_rows(g, gamma, None, eps))
    _keep(codes, xq=xq, yq=yq)
    o = int_dot(yq, q2.q) * sy * q2.scale
    return o.reshape(*x.shape[:-1], q2.q.shape[0]).to(x.dtype)


def _ffn_q8wide_reference(x, w1, gamma, q2: QuantWeight, eps: float = 1e-5,
                          codes: dict | None = None):
    """Plain version of kernel 20: H = x W1^T with W1 in x's dtype (bf16:
    fp32 sums; fp32: one rounding of the float64 product), then as
    ``_ffn_q8_reference`` from g on. ``codes`` receives yq."""
    dt, d, inner = x.dtype, x.shape[-1], q2.q.shape[1]
    xf, w1c = x.reshape(-1, d), w1.to(dt)
    if dt == torch.float32:
        h = (xf.double() @ w1c.double().T).float()
    else:
        h = F.linear(xf.float(), w1c.float())
    g = h[:, inner:] * gelu_exact(h[:, :inner])
    yq, sy = quantize_rows(ln_rows(g, gamma, None, eps))
    _keep(codes, yq=yq)
    o = int_dot(yq, q2.q) * sy * q2.scale
    return o.reshape(*x.shape[:-1], q2.q.shape[0]).to(dt)


def _ln_mlp_q8_reference(x, lng, lnb, q1: QuantWeight, b1, q2: QuantWeight,
                         b2, eps: float = 1e-5, codes: dict | None = None):
    """Plain version of kernel 21: x + W8A8 Mlp(LayerNorm(x)), the biases
    added after dequantising, exact gelu, in x's dtype. ``codes``
    receives (yq, gq)."""
    d = x.shape[-1]
    x32 = x.reshape(-1, d).float()
    yq, sy = quantize_rows(ln_rows(x32, lng, lnb, eps))
    h = int_dot(yq, q1.q) * sy * q1.scale + b1.float()
    gq, sg = quantize_rows(gelu_exact(h))
    _keep(codes, yq=yq, gq=gq)
    o = int_dot(gq, q2.q) * sg * q2.scale + b2.float()
    return (x32 + o).reshape(x.shape).to(x.dtype)


def ffn_q8_tileable(shape: tuple, dim: int, inner: int) -> bool:
    """JAX's ``FeedForward`` gate of the fused quantized kernels without its
    backend test (``models/layers.py:142-146``)."""
    return (inner % 128 == 0 and rows_lane_tileable(shape, shape[-1])
            and (2 * inner) % 128 == 0 and dim % 128 == 0)


def ln_mlp_q8_tileable(shape: tuple, dim: int) -> bool:
    """JAX's ``ln_mlp_block`` int8 gate without its backend test
    (``models/layers.py:332-335``)."""
    return (rows_lane_tileable(shape, shape[-1]) and dim % 128 == 0
            and shape[-1] == dim)


def _refuse_grad(x, name):
    if needs_grad(x):
        raise ValueError(f"{name} is inference-only (no backward, as in JAX)")


def _check_q8(x, name, qw: QuantWeight, shape: tuple):
    check_tensor(qw.q, f"{name} int8", (torch.int8,), 2, x.device)
    check_tensor(qw.scale, f"{name} scale", (torch.float32,), 1, x.device)
    if tuple(qw.q.shape) != shape or qw.scale.shape != (shape[0],):
        raise ValueError(f"{name}: {tuple(qw.q.shape)} / "
                         f"{tuple(qw.scale.shape)}, expected {shape}")


def _vec(p, name, size, dev) -> torch.Tensor:
    check_tensor(p, name, (torch.float32, torch.bfloat16), 1, dev)
    if p.shape != (size,):
        raise ValueError(f"{name} must be ({size},)")
    return p.float().contiguous()


def _check_widths(what, d, inner):
    if d % 128 or inner % 128:
        raise ValueError(f"{what}: d={d} and inner={inner} must be multiples "
                         f"of 128")


def _check_aligned(what, **named):
    for name, t in named.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} starts at an address that is "
                             f"not 16-byte aligned")


def _ffn_q8_kernel(x, q1, gamma, q2, eps, codes=None):
    what = "ffn_q8 kernel"
    check_tensor(x, "x", (torch.float32, torch.bfloat16))
    d, inner = x.shape[-1], q2.q.shape[1]
    _check_q8(x, "w1", q1, (2 * inner, d))
    _check_q8(x, "w2", q2, (d, inner))
    _check_widths(what, d, inner)
    _check_aligned(what, **{"w1 int8": q1.q, "w2 int8": q2.q})
    gam = _vec(gamma, "gamma", inner, x.device)
    n, dev = x.numel() // d, x.device
    out = torch.empty_like(x)
    if n == 0:
        return out
    plan = q8_plan(n, d, inner)
    xq = torch.empty(n, plan.x_pitch, dtype=torch.int8, device=dev)
    sx = torch.empty(n, dtype=torch.float32, device=dev)
    g = torch.empty(n * plan.g_pitch, dtype=torch.float32, device=dev)
    yq = torch.empty(n, plan.q_pitch, dtype=torch.int8, device=dev)
    sy = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "amt_ffn_q8", plan.c_array(), x.data_ptr(), q1.q.data_ptr(),
            q1.scale.data_ptr(), gam.data_ptr(), q2.q.data_ptr(),
            q2.scale.data_ptr(), xq.data_ptr(), sx.data_ptr(), g.data_ptr(),
            yq.data_ptr(), sy.data_ptr(), out.data_ptr(), n, d, inner, eps,
            _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
    fused_ffn_q8.launches += 1
    _keep(codes, xq=xq[:, :d], yq=yq[:, :inner])
    return out


def fused_ffn_q8(x: torch.Tensor, q1: QuantWeight, gamma: torch.Tensor,
                 q2: QuantWeight, *, eps: float = 1e-5,
                 codes: dict | None = None) -> torch.Tensor:
    """The W8A8 GEGLU FFN (kernel 19) of x (..., d) with quantized W1
    (2i, d) and W2 (d, i), gamma (i,): the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if not is_kernel_path(x):
        return _ffn_q8_reference(x, q1, gamma, q2, eps, codes)
    _refuse_grad(x, "fused_ffn_q8")
    return _ffn_q8_kernel(x.contiguous(), q1, gamma, q2, eps, codes)


fused_ffn_q8.launches = 0


@dataclass(frozen=True)
class Q8Plan:
    """The two tile products of kernels 19 and 20 (csrc/quant.cu):
    ``geglu``, the paired-column product of x (n, d) and W1 (2 inner, d),
    both K-major, W1 read as boxes of ``bn / 2`` rows, writing g = gate *
    gelu(a) into the fp32 scratch g (n, inner) at ``g_pitch`` elements a
    row -- kernel 19: x_q at ``x_pitch`` bytes a row and W1q in int8, K
    boxes of 128; kernel 20: x and W1 bf16, K boxes of 64 (fp32 x: only the
    pitch is read; the fp64 tensor-core product writes g); ``out`` = y_q
    W2q^T in the int8 form, y_q (n, inner) at ``q_pitch`` bytes a row and
    W2q (d, inner), both K-major, K boxes of 128 int8."""
    geglu: GemmPlan
    out: GemmPlan
    _arr: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_arr", PlanArray((self.geglu, self.out)))

    def c_array(self):
        """The 42 int64 values ``amt_ffn_q8`` / ``amt_ffn_q8wide`` read
        (built once)."""
        return self._arr.c_array()

    @property
    def x_pitch(self) -> int:
        return self.geglu.a.stride

    @property
    def g_pitch(self) -> int:
        return self.geglu.ldc

    @property
    def q_pitch(self) -> int:
        return self.out.a.stride


def _out_plan(n: int, d: int, inner: int, what: str) -> GemmPlan:
    """y_q W2q^T's plan; its tile width is kernel 11's y W2^T rule: 256
    above d 128."""
    yq = scratch_meta("yq", n, inner, inner, item=1)
    w2q = scratch_meta("w2 int8", d, inner, inner, item=1)
    return gemm_plan(yq, K_MAJOR, w2q, K_MAJOR, 256 if d > 128 else 128, d,
                     what=what)


@functools.lru_cache(maxsize=64)
def q8_plan(n: int, d: int, inner: int) -> Q8Plan:
    """Kernel 19's plan for n rows of x (n, d), W1q (2 inner, d) and W2q
    (d, inner), the same for bf16 and fp32 x, cached on the sizes alone
    (the wrapper checks the weights 16-byte aligned first)."""
    what = "ffn_q8 kernel"
    xq = scratch_meta("xq", n, d, d, item=1)
    w1q = scratch_meta("w1 int8", 2 * inner, d, d, item=1)
    return Q8Plan(
        gemm_plan(xq, K_MAJOR, w1q, K_MAJOR, Q8_GEGLU_BN, row_pitch(inner),
                  paired=True, what=what),
        _out_plan(n, d, inner, what))


@functools.lru_cache(maxsize=64)
def q8wide_plan(n: int, d: int, inner: int) -> Q8Plan:
    """Kernel 20's plan for n rows of x (n, d), W1 (2 inner, d) and W2q
    (d, inner), cached on the sizes alone (the wrapper checks the operands
    contiguous and 16-byte aligned first)."""
    what = "ffn_q8wide kernel"
    x = scratch_meta("x", n, d, d)
    w1 = scratch_meta("w1", 2 * inner, d, d)
    return Q8Plan(
        gemm_plan(x, K_MAJOR, w1, K_MAJOR, Q8_GEGLU_BN, row_pitch(inner),
                  paired=True, what=what),
        _out_plan(n, d, inner, what))


def _ffn_q8wide_kernel(x, w1, gamma, q2, eps, codes=None):
    check_tensor(x, "x", (torch.float32, torch.bfloat16))
    d, inner = x.shape[-1], q2.q.shape[1]
    w1c = w1.to(x.dtype).contiguous()
    check_tensor(w1c, "w1", (x.dtype,), 2, x.device)
    if w1c.shape != (2 * inner, d):
        raise ValueError(f"ffn_q8wide kernel: w1 {tuple(w1c.shape)}")
    _check_q8(x, "w2", q2, (d, inner))
    _check_widths("ffn_q8wide kernel", d, inner)
    _check_aligned("ffn_q8wide kernel", x=x, w1=w1c, **{"w2 int8": q2.q})
    gam = _vec(gamma, "gamma", inner, x.device)
    n, dev = x.numel() // d, x.device
    out = torch.empty_like(x)
    if n == 0:
        return out
    plan = q8wide_plan(n, d, inner)
    g = torch.empty(n * plan.g_pitch, dtype=torch.float32, device=dev)
    yq = torch.empty(n, plan.q_pitch, dtype=torch.int8, device=dev)
    sy = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "amt_ffn_q8wide", plan.c_array(), x.data_ptr(), w1c.data_ptr(),
            gam.data_ptr(), q2.q.data_ptr(), q2.scale.data_ptr(),
            g.data_ptr(), yq.data_ptr(), sy.data_ptr(), out.data_ptr(), n, d,
            inner, eps, _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
    fused_ffn_q8wide.launches += 1
    _keep(codes, yq=yq[:, :inner])
    return out


def fused_ffn_q8wide(x: torch.Tensor, w1: torch.Tensor, gamma: torch.Tensor,
                     q2: QuantWeight, *, eps: float = 1e-5,
                     codes: dict | None = None) -> torch.Tensor:
    """The wide-only FFN (kernel 20): W1 (2i, d) cast to x's dtype for the
    up-projection, quantized W2 (d, i) for the down-projection. The kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if not is_kernel_path(x):
        return _ffn_q8wide_reference(x, w1, gamma, q2, eps, codes)
    _refuse_grad(x, "fused_ffn_q8wide")
    return _ffn_q8wide_kernel(x.contiguous(), w1, gamma, q2, eps, codes)


fused_ffn_q8wide.launches = 0


def int8_pitch(k: int) -> int:
    """Bytes a row of k int8 takes when rows start 64-byte aligned."""
    return -(-k // INT8_ROW_ALIGN) * INT8_ROW_ALIGN


@dataclass(frozen=True)
class LnMlpQ8Plan:
    """Kernel 21's two int8 tile products (csrc/quant.cu): ``up`` h = y_q
    W1q^T, y_q (n, d) at ``y_pitch`` bytes a row and W1q (hid, d), both
    K-major, K boxes of 128 int8, writing g = gelu(dequant + b1) into the
    fp32 scratch g (n, hid) at ``g_pitch`` elements a row; ``down`` g_q
    W2q^T + b2 + x, g_q (n, hid) at ``q_pitch`` bytes a row (64-byte
    aligned) and W2q (d, hid) read at the same pitch, staged by the C side
    at every call where hid is not a multiple of 64; its maps have K = hid,
    so TMA zero-fills past it and the padding is never read."""
    up: GemmPlan
    down: GemmPlan
    _arr: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_arr", PlanArray((self.up, self.down)))

    def c_array(self):
        """The 42 int64 values ``amt_ln_mlp_q8`` reads (built once)."""
        return self._arr.c_array()

    @property
    def y_pitch(self) -> int:
        return self.up.a.stride

    @property
    def g_pitch(self) -> int:
        return self.up.ldc

    @property
    def q_pitch(self) -> int:
        return self.down.a.stride

    @property
    def w2_stage_bytes(self) -> int:
        """Bytes of the W2q stage the C side fills (0: W2q read as it
        is)."""
        pitch, (hid, d) = self.down.b.stride, self.down.b.dims
        return 0 if pitch == hid else d * pitch


@functools.lru_cache(maxsize=64)
def ln_mlp_q8_plan(n: int, d: int, hid: int) -> LnMlpQ8Plan:
    """Kernel 21's plan for n rows of x (n, d), W1q (hid, d) and W2q (d,
    hid), hid a multiple of 8, the same for bf16 and fp32 x, cached on the
    sizes alone (the wrapper checks the weights contiguous and 16-byte
    aligned first)."""
    what = "ln_mlp_q8 kernel"
    pitch = int8_pitch(hid)
    yq = scratch_meta("yq", n, d, d, item=1)
    w1q = scratch_meta("w1 int8", hid, d, d, item=1)
    gq = scratch_meta("gq", n, hid, pitch, item=1)
    w2q = scratch_meta("w2 int8", d, hid, pitch, item=1)
    return LnMlpQ8Plan(
        gemm_plan(yq, K_MAJOR, w1q, K_MAJOR, LN_MLP_Q8_BN, row_pitch(hid),
                  what=what),
        gemm_plan(gq, K_MAJOR, w2q, K_MAJOR, LN_MLP_Q8_BN, d, what=what))


def _pad_hid(q1: QuantWeight, b1, q2: QuantWeight):
    """The kernel takes a hidden width that is a multiple of 8; zero rows of
    W1q with a zero bias give gelu(0) = 0, whose codes are 0 and leave the
    row's amax as it is, and W2q's zero columns add nothing: the same bits
    on the first hid columns."""
    pad = -q1.q.shape[0] % 8
    if not pad:
        return q1, b1, q2
    return (QuantWeight(F.pad(q1.q, (0, 0, 0, pad)),
                        F.pad(q1.scale, (0, pad), value=1.0)),
            F.pad(b1, (0, pad)),
            QuantWeight(F.pad(q2.q, (0, pad)).contiguous(), q2.scale))


def _ln_mlp_q8_kernel(x, lng, lnb, q1, b1, q2, b2, eps, codes=None):
    what = "ln_mlp_q8 kernel"
    check_tensor(x, "x", (torch.float32, torch.bfloat16))
    d, hid0 = x.shape[-1], q1.q.shape[0]
    _check_q8(x, "w1", q1, (hid0, d))
    _check_q8(x, "w2", q2, (d, hid0))
    if d % 128:
        raise ValueError(f"{what}: d={d} must be a multiple of 128")
    _check_aligned(what, x=x, **{"w1 int8": q1.q, "w2 int8": q2.q})
    dev = x.device
    lng, lnb = _vec(lng, "ln_gamma", d, dev), _vec(lnb, "ln_beta", d, dev)
    b1, b2 = _vec(b1, "b1", hid0, dev), _vec(b2, "b2", d, dev)
    q1, b1, q2 = _pad_hid(q1, b1, q2)
    hid, n = q1.q.shape[0], x.numel() // d
    out = torch.empty_like(x)
    if n == 0:
        return out
    plan = ln_mlp_q8_plan(n, d, hid)
    f32, i8 = (dict(dtype=dt, device=dev) for dt in (torch.float32,
                                                     torch.int8))
    yq = torch.empty(n, plan.y_pitch, **i8)
    g = torch.empty(n * plan.g_pitch, **f32)
    gq = torch.empty(n, plan.q_pitch, **i8)
    sy, sg = torch.empty(n, **f32), torch.empty(n, **f32)
    w2s = (torch.empty(plan.w2_stage_bytes, **i8) if plan.w2_stage_bytes
           else None)
    with torch.cuda.device(dev):
        _build.launch(
            "amt_ln_mlp_q8", plan.c_array(), x.data_ptr(), lng.data_ptr(),
            lnb.data_ptr(), q1.q.data_ptr(), q1.scale.data_ptr(),
            b1.data_ptr(), q2.q.data_ptr(), q2.scale.data_ptr(),
            b2.data_ptr(), None if w2s is None else w2s.data_ptr(),
            yq.data_ptr(), sy.data_ptr(), g.data_ptr(),
            gq.data_ptr(), sg.data_ptr(), out.data_ptr(), n, d, hid, eps,
            _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
    fused_ln_mlp_q8.launches += 1
    _keep(codes, yq=yq[:, :d], gq=gq[:, :hid0])
    return out


def fused_ln_mlp_q8(x: torch.Tensor, ln_gamma: torch.Tensor,
                    ln_beta: torch.Tensor, q1: QuantWeight, b1: torch.Tensor,
                    q2: QuantWeight, b2: torch.Tensor, *, eps: float = 1e-5,
                    codes: dict | None = None) -> torch.Tensor:
    """x + W8A8 Mlp(LayerNorm(x)) (kernel 21), W1 (hid, d) and W2 (d, hid)
    quantized: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if not is_kernel_path(x):
        return _ln_mlp_q8_reference(x, ln_gamma, ln_beta, q1, b1, q2, b2,
                                    eps, codes)
    _refuse_grad(x, "fused_ln_mlp_q8")
    return _ln_mlp_q8_kernel(x.contiguous(), ln_gamma, ln_beta, q1, b1, q2,
                             b2, eps, codes)


fused_ln_mlp_q8.launches = 0
