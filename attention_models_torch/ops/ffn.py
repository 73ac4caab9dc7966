"""Fused feed-forward blocks: kernels and plain versions.

- ``fused_mlp``: the biased GELU MLP gelu(x W1^T + b1) W2^T + b2, forward
  and backward (kernels 7 and 8: csrc/mlp.cu, csrc/mlp_bwd.cu). The
  forward is two products (g = gelu(x W1^T + b1), then g W2^T + b2); the
  backward is kernel 6's passes on x in place of LN(x): the dual product
  (H = x W1^T and dG = dy W2 over one tile, G and dH in its epilogue), dx =
  dH W1 in bf16, the weight gradients dH^T x and dy^T G with K split into
  ordered partials, and the bias gradients' ordered column sums.
- ``fused_ln_mlp``: the pre-LN MLP block x + Mlp(LayerNorm(x)), forward and
  backward (csrc/ln_mlp.cu, csrc/ln_mlp_bwd.cu). At every d % 128 == 0 the
  forward is the LayerNorm kernel writing Y and kernel 7's two products on
  it, the second adding x; the backward is the LayerNorm kernel writing yc,
  a dual product (H = yc W1^T and dG = dy W2 over one tile, G and dH in
  its epilogue), dy_ln = dH W1, the weight gradients dH^T yc and dy^T G
  with K split into ordered partials, and the LN backward's row pass.
- ``fused_ffn``: the GEGLU FFN LN_gamma(gate * gelu(a)) W2 with
  [a | gate] = x W1, no biases, forward and backward (kernels 11 and 12:
  csrc/ffn.cu, csrc/ffn_bwd.cu). In bf16 the forward is the paired-column
  GEGLU product (W1's "a" and "gate" rows as two half boxes of one B tile,
  g = gate * gelu(a) in fp32 in its epilogue), the LayerNorm row pass and
  y W2^T; the backward is H = x W1^T and dy_ln = dy W2 in fp32, the row
  pass, and dW2, dx and dW1 (the weight gradients with K split into
  ordered partials where the plan says so). In fp32 the same passes run
  on csrc/gemm.cuh's register-tiled FMA product.

The forwards of kernels 7 and 2 run csrc/gemm_sm90.cuh's TMA/wgmma tile
product twice, kernels 6 and 8 five times, kernel 11 twice and kernel 12
five times. ``mlp_plan``, ``ln_mlp_bwd_plan``, ``mlp_bwd_plan``,
``ffn_plan`` and ``ffn_bwd_plan`` compute on the host what those launches need (``ops/gemm_sm90.py``: each
operand's rank-2 tensor map, K-major or MN-major, the tile width of each
product, the grids, the splits of K and the shared memory, and the
scratches' pitches), cached by the operands' shapes, strides and alignment
(kernels 11 and 12: by their sizes alone, their operands checked contiguous
and 16-byte aligned first), and refuse by name a view TMA cannot take; the
C side encodes the maps and launches. Where the hidden width is not a
multiple of 32, W2's rows would start only 16-byte aligned, which TMA
reads slowly: the C entries copy W2 into a scratch at a 64-byte pitch at
every call (one cudaMemcpy2DAsync), so the kernels read the weight they
are given, never a copy held from an earlier call.

Counterparts of ``attention_models_tpu/ops/ffn.py``'s ``fused_mlp`` and
``fused_ln_mlp`` (bf16 only on the kernel path, as there) and ``fused_ffn``
(bf16 and fp32).
Weights are in the torch Linear layout: w1 (hid, d), w2 (d, hid). The
kernels' gelu uses the true erf; the TPU kernels' A&S polynomial differs
from it by at most 1.5e-7.

On the card ``_LnMlp`` wires the two kernels into autograd, as
``_ln_mlp.defvjp`` does: the forward takes the (fp32 master) weights and
casts them to the activations' dtype inside the op; the backward recomputes
LN -> W1 -> gelu from x and returns the weight gradients in the parameters'
dtype. ``_MlpFn`` and ``_Ffn`` do the same for the GELU MLP and the GEGLU
FFN, saving x and the cast weights as ``_mlp_fwd`` / ``_ffn_fwd`` save
them. Without a gradient to
record (serving, ``no_grad``) the wrappers launch the forward kernel
directly (``needs_grad``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

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
    GEMM_ROWS,
    K_MAJOR,
    MN_MAJOR,
    ROW_ALIGN,
    GemmPlan,
    PlanArray,
    gemm_plan,
    meta,
    row_pitch,
    scratch_meta,
)
from attention_models_torch.ops.layernorm import _ln_reference

BWD_ROWS = 32         # rows per block of csrc/ln_mlp_bwd.cu's LN backward
FFN_BWD_ROWS = 16     # rows per block of csrc/ffn_bwd.cu's row pass
FFN_GEGLU_BN = 256    # kernel 11's GEGLU product: 128 inner columns a block
FFN_OUT_BN = 256      # kernel 11's y W2^T: 256 columns a block
COL_ROWS = 32         # rows per partial of kernel 8's db2 column sums


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


def _ln_mlp_backward_reference(x, lng, lnb, w1, b1, w2, dy, eps):
    """Plain version of the backward, the TPU kernel's formulas in fp32 with
    its roundings to x's dtype (yc, g, dh): returns (dx in x's dtype,
    dlng, dlnb, dw1, db1, dw2, db2 in fp32)."""
    dt = x.dtype
    d = x.shape[-1]
    x32 = x.reshape(-1, d).float()
    do = dy.reshape(-1, d)
    do32 = do.float()
    mean = x32.mean(-1, keepdim=True)
    c = x32 - mean
    rstd = torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    xhat = c * rstd
    yc = (xhat * lng.float() + lnb.float()).to(dt)
    w1c, w2c = w1.to(dt), w2.to(dt)
    h = (yc @ w1c.T).float() + b1.float()
    phi = 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
    g = (h * phi).to(dt)
    db2 = do32.sum(0)
    dw2 = (do.T @ g).float()                          # (d, hid)
    dg = (do @ w2c).float()                           # (n, hid)
    dh = dg * (phi + h * torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi))
    db1 = dh.sum(0)
    dhc = dh.to(dt)
    dw1 = (dhc.T @ yc).float()                        # (hid, d)
    dy_ln = (dhc @ w1c).float()                       # (n, d)
    dlng = (dy_ln * xhat).sum(0)
    dlnb = dy_ln.sum(0)
    dxhat = dy_ln * lng.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = do32 + rstd * (dxhat - m1 - xhat * m2)
    return dx.to(dt).reshape(x.shape), dlng, dlnb, dw1, db1, dw2, db2


def mlp_supported(shape: tuple, d: int) -> bool:
    """The JAX package's fused-MLP gate without its backend test: d
    lane-aligned (128), the rows a nonzero multiple of 8; any hidden width."""
    return rows_lane_tileable(shape, d)


def _pad_hidden(w1, b1, w2):
    """The kernels take a hidden width that is a multiple of 8 (16-byte rows
    of W2 and of the scratches); a wider zero-padded W1, b1 and W2 add
    gelu(0) * 0 = 0 forward and zero gradients backward."""
    pad = -w1.shape[0] % 8
    if not pad:
        return w1, b1, w2
    return F.pad(w1, (0, 0, 0, pad)), F.pad(b1, (0, pad)), F.pad(w2, (0, pad))


# -- the tile products' host plans -------------------------------------------

def pick_bn(n: int, gelu: bool) -> int:
    """The tile width of a forward product with N columns: 128 for the GELU
    product (two blocks an SM, so one block's erff epilogue runs under the
    other's products), 256 for the residual product (one block an SM, a
    quarter fewer operand bytes from L2 a flop) unless N fits one 128-wide
    tile (chosen in turns on the H100, PERF.md section 6)."""
    return 128 if gelu or n <= 128 else 256


@dataclass(frozen=True)
class MlpPlan:
    """The two products of kernels 7 and 2: ``up`` g = gelu(x W1^T + b1)
    (M n, N hid, K d; kernel 2's x is its LayerNorm's output) into the bf16
    scratch g, whose rows are ``up.ldc`` elements apart, and ``down``
    g W2^T (M n, N d, K hid), whose B map reads W2 staged at ``up.ldc``
    elements a row where hid is not a multiple of ROW_ALIGN."""
    up: GemmPlan
    down: GemmPlan
    _arr: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_arr", PlanArray((self.up, self.down)))

    def c_array(self):
        """The 42 int64 values ``amt_mlp`` and ``amt_ln_mlp`` read (built
        once)."""
        return self._arr.c_array()

    def w2_stage_elems(self, hid: int) -> int:
        """Elements of the W2 stage the C side fills (0: W2 read as it
        is)."""
        pitch = self.down.b.stride // 2
        return 0 if pitch == hid else self.down.b.dims[1] * pitch


def _g_meta(n: int, hid: int) -> tuple:
    """The wrapper's g scratch: (n, hid) at a pitch of whole ROW_ALIGNs."""
    return scratch_meta("g", n, hid, row_pitch(hid))


def _w2_meta(w2: tuple) -> tuple:
    """W2 (rows, hid) as the kernels read it: as it is where hid is a
    multiple of ROW_ALIGN, else its stage at a 64-byte pitch."""
    rows, hid = w2[1]
    return w2 if hid % ROW_ALIGN == 0 else scratch_meta(
        "w2", rows, hid, row_pitch(hid))


@functools.lru_cache(maxsize=256)
def _mlp_plan(x: tuple, w1: tuple, w2: tuple) -> MlpPlan:
    (n, d), hid = x[1], w1[1][0]
    g = _g_meta(n, hid)
    return MlpPlan(
        gemm_plan(x, K_MAJOR, w1, K_MAJOR, pick_bn(hid, gelu=True), g[2][0]),
        gemm_plan(g, K_MAJOR, _w2_meta(w2), K_MAJOR, pick_bn(d, gelu=False),
                  d))


def mlp_plan(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> MlpPlan:
    """The plan of kernel 7's (or kernel 2's) two products for x (n, d),
    w1 (hid, d) and w2 (d, hid) in bf16, cached by their shapes, strides and
    16-byte alignment, so a serving loop pays for it once; a view TMA cannot
    take raises a ValueError naming it. The g scratch is allocated with
    ``up.ldc`` elements a row."""
    return _mlp_plan(meta("x", x), meta("w1", w1), meta("w2", w2))


def _launch_mlp(entry: str, x, w1, b1f, w2, b2f, *pre) -> torch.Tensor:
    """Kernel 7's products on bf16 x (..., d) and padded weights in the
    kernels' layout (or kernel 2's, with ``pre`` = (ln_gamma, ln_beta, eps):
    its LayerNorm writes a Y scratch the products read, and x is the
    residual): the plan, the scratches, one call of ``entry``."""
    d, hid = x.shape[-1], w1.shape[0]
    n = x.numel() // d
    plan = mlp_plan(x.view(n, d), w1, w2)  # kernel 2's Y is laid out as x
    # one scratch: kernel 2's Y (n, d), g (n, plan.up.ldc), W2's stage
    ny, ng = (n * d if pre else 0), n * plan.up.ldc
    nw = plan.w2_stage_elems(hid)
    scratch = torch.empty(ny + ng + nw, dtype=x.dtype, device=x.device)
    def at(off):
        return scratch.data_ptr() + off * scratch.element_size()

    w2_stage = at(ny + ng) if nw else None
    out = torch.empty_like(x)
    bias = _build.DTYPE_CODES[b1f.dtype]
    stream = _build.stream_of(x)
    with torch.cuda.device(x.device):
        if pre:
            lng, lnb, eps = pre
            _build.launch(
                entry, x.data_ptr(), lng.data_ptr(), lnb.data_ptr(),
                w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(),
                out.data_ptr(), at(0), at(ny), w2_stage, plan.c_array(), n, d,
                hid, eps, bias, stream)
        else:
            _build.launch(
                entry, x.data_ptr(), w1.data_ptr(), b1f.data_ptr(),
                w2.data_ptr(), b2f.data_ptr(), None, at(0), w2_stage,
                out.data_ptr(), plan.c_array(), n, d, hid, bias, stream)
    return out


def _layout(parts: list[tuple[str, int]], align: int = 128) -> tuple:
    """(name, offset, size) of each scratch part in one buffer, each offset
    a multiple of ``align`` elements; the total last."""
    out, off = [], 0
    for name, size in parts:
        out.append((name, off, size))
        off += -(-size // align) * align
    return tuple(out), off


@dataclass(frozen=True)
class GeluBwdPlan:
    """The five tile products of the GELU-MLP backwards and their
    scratches: kernel 6 (csrc/ln_mlp_bwd.cu) on yc = LayerNorm(x), kernel 8
    (csrc/mlp_bwd.cu) on x. The dual product ``h`` (H = yc W1^T, or x
    W1^T) and ``dg`` (dG = dy W2, W2 read MN-major, staged where hid is not
    a multiple of ROW_ALIGN) over the same (128 rows x 128 hidden) tiles;
    ``back`` dH W1 (W1 MN-major: kernel 6's fp32 dy_ln, kernel 8's bf16
    dx); ``dw1`` (dH^T yc, or dH^T x) and ``dw2`` (dy^T G), both operands
    MN-major with K split into ordered partials where the tiles leave SMs
    idle. G and dH are (n, hid) at ``h.ldc`` elements a row. ``bf16`` and
    ``f32`` lay out the scratches of one bf16 and one fp32 buffer: (name,
    offset, size) each, and the total."""
    h: GemmPlan
    dg: GemmPlan
    back: GemmPlan
    dw1: GemmPlan
    dw2: GemmPlan
    bf16: tuple
    f32: tuple
    _arr: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_arr", PlanArray(
            (self.h, self.dg, self.back, self.dw1, self.dw2)))

    def c_array(self):
        """The 105 int64 values ``amt_ln_mlp_bwd`` / ``amt_mlp_bwd`` read
        (built once)."""
        return self._arr.c_array()


@functools.lru_cache(maxsize=256)
def _ln_mlp_bwd_plan(dy: tuple, w1: tuple, w2: tuple) -> GeluBwdPlan:
    (n, d), hid = dy[1], w1[1][0]
    what = "ln_mlp backward"
    pitch = row_pitch(hid)
    yc = scratch_meta("yc", n, d, d)
    g, dh = scratch_meta("g", n, hid, pitch), scratch_meta("dh", n, hid, pitch)
    w2s = _w2_meta(w2)
    plans = dict(
        h=gemm_plan(yc, K_MAJOR, w1, K_MAJOR, 128, pitch, dual=True,
                    what=what),
        dg=gemm_plan(dy, K_MAJOR, w2s, MN_MAJOR, 128, pitch, dual=True,
                     what=what),
        back=gemm_plan(dh, K_MAJOR, w1, MN_MAJOR, 128, d, what=what),
        dw1=gemm_plan(dh, MN_MAJOR, yc, MN_MAJOR, 128, d, split=True,
                      what=what),
        dw2=gemm_plan(dy, MN_MAJOR, g, MN_MAJOR, 128, hid, split=True,
                      what=what))
    splits = max(plans["dw1"].splits, plans["dw2"].splits)
    tiles = -(-n // GEMM_ROWS)
    bf16 = _layout([("yc", n * d), ("g", n * pitch), ("dh", n * pitch),
                    ("w2s", d * pitch if w2s is not w2 else 0)])
    f32 = _layout([("dyln", n * d), ("dhpart", 2 * tiles * hid),
                   ("part", 3 * -(-n // BWD_ROWS) * d),
                   ("wpart", splits * hid * d if splits > 1 else 0)])
    return GeluBwdPlan(**plans, bf16=bf16, f32=f32)


def ln_mlp_bwd_plan(dy: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor) -> GeluBwdPlan:
    """Kernel 6's plan for the cotangent dy (n, d) (x, yc and dx are laid
    out as it), w1 (hid, d) and w2 (d, hid) in bf16, cached by their
    shapes, strides and 16-byte alignment; a view TMA cannot take raises a
    ValueError naming it."""
    return _ln_mlp_bwd_plan(meta("dy", dy), meta("w1", w1), meta("w2", w2))


@functools.lru_cache(maxsize=256)
def _mlp_bwd_plan(x: tuple, dy: tuple, w1: tuple, w2: tuple) -> GeluBwdPlan:
    (n, d), hid = x[1], w1[1][0]
    what = "mlp backward"
    pitch = row_pitch(hid)
    g, dh = scratch_meta("g", n, hid, pitch), scratch_meta("dh", n, hid, pitch)
    w2s = _w2_meta(w2)
    plans = dict(
        h=gemm_plan(x, K_MAJOR, w1, K_MAJOR, 128, pitch, dual=True,
                    what=what),
        dg=gemm_plan(dy, K_MAJOR, w2s, MN_MAJOR, 128, pitch, dual=True,
                     what=what),
        back=gemm_plan(dh, K_MAJOR, w1, MN_MAJOR, 128, d, what=what),
        dw1=gemm_plan(dh, MN_MAJOR, x, MN_MAJOR, 128, d, split=True,
                      what=what),
        dw2=gemm_plan(dy, MN_MAJOR, g, MN_MAJOR, 128, hid, split=True,
                      what=what))
    splits = max(plans["dw1"].splits, plans["dw2"].splits)
    bf16 = _layout([("g", n * pitch), ("dh", n * pitch),
                    ("w2s", d * pitch if w2s is not w2 else 0)])
    f32 = _layout([("dhpart", 2 * -(-n // GEMM_ROWS) * hid),
                   ("dypart", -(-n // COL_ROWS) * d),
                   ("wpart", splits * hid * d if splits > 1 else 0)])
    return GeluBwdPlan(**plans, bf16=bf16, f32=f32)


def mlp_bwd_plan(x: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor,
                 w2: torch.Tensor) -> GeluBwdPlan:
    """Kernel 8's plan for x and the cotangent dy (n, d) (dx is laid out
    contiguous), w1 (hid, d) and w2 (d, hid) in bf16, cached by their
    shapes, strides and 16-byte alignment; a view TMA cannot take raises a
    ValueError naming it."""
    return _mlp_bwd_plan(meta("x", x), meta("dy", dy), meta("w1", w1),
                         meta("w2", w2))


def _scratch(plan, dev, dtype) -> tuple:
    """One bf16 (``dtype``) and one fp32 buffer laid out as the plan's
    ``bf16`` and ``f32`` layouts say, and each part's address (None where
    it is empty); the caller holds the buffers until its launch."""
    bufs = (torch.empty(plan.bf16[1], dtype=dtype, device=dev),
            torch.empty(plan.f32[1], dtype=torch.float32, device=dev))
    return bufs, [buf.data_ptr() + off * buf.element_size() if size else None
                  for buf, (layout, _) in zip(bufs, (plan.bf16, plan.f32))
                  for _, off, size in layout]


def _check_kernel_operands(x, w1, w2, vecs,
                           biases_as_is: bool = False) -> list[torch.Tensor]:
    """Shape/dtype/alignment checks shared by the MLP and ln_mlp kernels;
    returns the 1-D parameters contiguous and 16-byte aligned, as fp32 or,
    with ``biases_as_is`` and both biases bf16, the biases as bf16 (the
    forwards' epilogues read either)."""
    check_tensor(x, "x", (torch.bfloat16,))
    d = x.shape[-1]
    hid = w1.shape[0]
    check_tensor(w1, "w1", (torch.bfloat16,), 2, x.device)
    check_tensor(w2, "w2", (torch.bfloat16,), 2, x.device)
    if d % 128 or w1.shape != (hid, d) or w2.shape != (d, hid):
        raise ValueError(f"mlp kernel: d={d} (needs a multiple of 128), w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if hid % 8:
        raise ValueError(f"mlp kernel: hidden width {hid} not a multiple "
                         f"of 8")
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"mlp kernel: {name} starts at an address that "
                             f"is not 16-byte aligned")
    out = []
    sizes = {"ln_gamma": d, "ln_beta": d, "b1": hid, "b2": d}
    keep = biases_as_is and all(p.dtype == torch.bfloat16 for name, p in vecs
                                if name in ("b1", "b2"))
    for name, p in vecs:
        check_tensor(p, name, (torch.float32, torch.bfloat16), 1, x.device)
        if p.shape != (sizes[name],):
            raise ValueError(f"mlp kernel: {name} must be ({sizes[name]},)")
        p = (p if keep and name in ("b1", "b2") else p.float()).contiguous()
        # the kernels read them by 8- and 16-byte loads
        out.append(p.clone() if p.data_ptr() % 16 else p)
    return out


def _ln_mlp_fwd_kernel(x, lng, lnb, w1, b1, w2, b2, eps):
    w1, b1, w2 = _pad_hidden(w1, b1, w2)
    lng, lnb, b1f, b2f = _check_kernel_operands(
        x, w1, w2, (("ln_gamma", lng), ("ln_beta", lnb), ("b1", b1),
                    ("b2", b2)), biases_as_is=True)
    out = _launch_mlp("amt_ln_mlp", x, w1, b1f, w2, b2f, lng, lnb, eps)
    fused_ln_mlp.launches += 1
    return out


def fused_ln_mlp_backward(x, lng, lnb, w1, b1, w2, dy, *, eps: float = 1e-5):
    """Gradients of ``fused_ln_mlp`` for the cotangent ``dy``: (dx in x's
    dtype, dlng, dlnb, dw1, db1, dw2, db2 in fp32). ``w1``/``w2`` in x's
    dtype. The kernel for CUDA tensors, the plain version for CPU tensors."""
    if not is_kernel_path(x):
        return _ln_mlp_backward_reference(x, lng, lnb, w1, b1, w2, dy, eps)
    dy = dy.contiguous()
    check_tensor(dy, "dy", (x.dtype,), x.dim(), x.device)
    if dy.shape != x.shape or dy.data_ptr() % 16:
        raise ValueError("ln_mlp backward: dy must match x, 16-byte aligned")
    hid0 = w1.shape[0]
    w1, b1, w2 = _pad_hidden(w1, b1, w2)
    lng, lnb, b1f = _check_kernel_operands(
        x, w1, w2, (("ln_gamma", lng), ("ln_beta", lnb), ("b1", b1)))
    d, hid = x.shape[-1], w1.shape[0]
    n = x.numel() // d
    plan = ln_mlp_bwd_plan(dy.view(n, d), w1, w2)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    bufs, scratch = _scratch(plan, dev, x.dtype)
    dx = torch.empty_like(x)
    dw1, db1 = torch.empty(hid, d, **f32), torch.empty(hid, **f32)
    dw2 = torch.empty(d, hid, **f32)
    lnbias = torch.empty(3, d, **f32)  # dlng, dlnb, db2
    with torch.cuda.device(dev):
        _build.launch(
            "amt_ln_mlp_bwd", plan.c_array(), x.data_ptr(), lng.data_ptr(),
            lnb.data_ptr(), w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), lnbias.data_ptr(), *scratch, n, d, hid, eps,
            _build.stream_of(x),
        )
    fused_ln_mlp_backward.launches += 1
    dlng, dlnb, db2 = lnbias
    return (dx, dlng, dlnb, dw1[:hid0], db1[:hid0], dw2[:, :hid0], db2)


fused_ln_mlp_backward.launches = 0


class _LnMlp(torch.autograd.Function):
    """Forward and backward kernels; weights cast to x's dtype inside."""

    @staticmethod
    def forward(ctx, x, lng, lnb, w1, b1, w2, b2, eps):
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        ctx.eps = eps
        ctx.dtypes = tuple(p.dtype for p in (lng, lnb, w1, b1, w2, b2))
        ctx.save_for_backward(x, lng, lnb, w1c, b1, w2c)
        return _ln_mlp_fwd_kernel(x, lng, lnb, w1c, b1, w2c, b2, eps)

    @staticmethod
    def backward(ctx, dy):
        x, lng, lnb, w1c, b1, w2c = ctx.saved_tensors
        grads = fused_ln_mlp_backward(x, lng, lnb, w1c, b1, w2c, dy,
                                      eps=ctx.eps)
        dx, rest = grads[0], grads[1:]
        return (dx, *(g.to(dt) for g, dt in zip(rest, ctx.dtypes)), None)


def fused_ln_mlp(
    x: torch.Tensor,         # (..., d) bf16
    ln_gamma: torch.Tensor,  # (d,)
    ln_beta: torch.Tensor,   # (d,)
    w1: torch.Tensor,        # (hid, d)
    b1: torch.Tensor,        # (hid,)
    w2: torch.Tensor,        # (d, hid)
    b2: torch.Tensor,        # (d,)
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Differentiable x + gelu(LN(x) @ w1^T + b1) @ w2^T + b2: the kernels
    for a CUDA tensor, the plain version for a CPU tensor."""
    if not is_kernel_path(x):
        return _ln_mlp_reference(x, ln_gamma, ln_beta, w1, b1, w2, b2, eps)
    args = (x, ln_gamma, ln_beta, w1, b1, w2, b2)
    if needs_grad(*args):
        return _LnMlp.apply(*args, eps)
    return _ln_mlp_fwd_kernel(x, ln_gamma, ln_beta, w1.to(x.dtype), b1,
                              w2.to(x.dtype), b2, eps)


fused_ln_mlp.launches = 0


def _fused_mlp_reference(x, w1, b1, w2, b2):
    """Plain version of kernel 7 with the TPU kernel's rounding points:
    h = x w1^T + b1 and its gelu in fp32 from x's dtype's operands, g
    rounded to x's dtype before the W2 product, b2 added in fp32, one
    rounding at the end. In fp32 it is the JAX package's ``_mlp_reference``.
    w1 (hid, d), w2 (d, hid)."""
    dt = x.dtype
    h = F.linear(x.float(), w1.to(dt).float(), b1.float())
    g = gelu_exact(h).to(dt)
    return F.linear(g.float(), w2.to(dt).float(), b2.float()).to(dt)


def _fused_mlp_backward_reference(x, w1, b1, w2, dy):
    """Plain version of kernel 8, the TPU kernel's formulas and rounding
    points (``_mlp_bwd_kernel``): h recomputed in fp32, g and dh rounded to
    x's dtype before the products that take them. Returns (dx in x's dtype,
    dW1 (hid, d), db1, dW2 (d, hid), db2 in fp32)."""
    dt = x.dtype
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    do = dy.reshape(-1, d).to(dt).float()
    w1c, w2c = w1.to(dt).float(), w2.to(dt).float()
    h = xf @ w1c.T + b1.float()
    phi = 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
    g = (h * phi).to(dt).float()
    db2 = do.sum(0)
    dw2 = do.T @ g                                    # (d, hid)
    dh = (do @ w2c) * (phi + h * torch.exp(-0.5 * h * h)
                       / math.sqrt(2.0 * math.pi))
    db1 = dh.sum(0)
    dhc = dh.to(dt).float()
    dx = (dhc @ w1c).to(dt)
    dw1 = dhc.T @ xf                                  # (hid, d)
    return dx.reshape(x.shape), dw1, db1, dw2, db2


def _mlp_fwd_kernel(x, w1c, b1, w2c, b2):
    """One launch of kernel 7 on weights in x's dtype."""
    w1c, b1, w2c = _pad_hidden(w1c, b1, w2c)
    b1f, b2f = _check_kernel_operands(x, w1c, w2c, (("b1", b1), ("b2", b2)),
                                      biases_as_is=True)
    out = _launch_mlp("amt_mlp", x, w1c, b1f, w2c, b2f)
    fused_mlp.launches += 1
    return out


def fused_mlp_backward(x, w1, b1, w2, dy):
    """Gradients of ``fused_mlp`` for the cotangent ``dy``: (dx in x's
    dtype, dW1 (hid, d), db1, dW2 (d, hid), db2 in fp32), with ``w1``/``w2``
    in x's dtype. Kernel 8 for CUDA tensors, the plain version for CPU
    tensors."""
    if not is_kernel_path(x):
        return _fused_mlp_backward_reference(x, w1, b1, w2, dy)
    dy = dy.contiguous()
    check_tensor(dy, "dy", (x.dtype,), x.dim(), x.device)
    if dy.shape != x.shape or dy.data_ptr() % 16:
        raise ValueError("mlp backward: dy must match x, 16-byte aligned")
    hid0 = w1.shape[0]
    w1, b1, w2 = _pad_hidden(w1, b1, w2)
    (b1f,) = _check_kernel_operands(x, w1, w2, (("b1", b1),))
    d, hid = x.shape[-1], w1.shape[0]
    n = x.numel() // d
    xv, dyv = x.reshape(n, d), dy.view(n, d)
    plan = mlp_bwd_plan(xv, dyv, w1, w2)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    bufs, scratch = _scratch(plan, dev, x.dtype)
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    dw1, db1 = torch.empty(hid, d, **f32), torch.empty(hid, **f32)
    dw2, db2 = torch.empty(d, hid, **f32), torch.empty(d, **f32)
    with torch.cuda.device(dev):
        _build.launch(
            "amt_mlp_bwd", plan.c_array(), xv.data_ptr(), w1.data_ptr(),
            b1f.data_ptr(), w2.data_ptr(), dyv.data_ptr(), dx.data_ptr(),
            dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            *scratch, n, d, hid, _build.stream_of(x),
        )
    fused_mlp_backward.launches += 1
    return dx, dw1[:hid0], db1[:hid0], dw2[:, :hid0], db2


fused_mlp_backward.launches = 0


class _MlpFn(torch.autograd.Function):
    """Kernels 7 and 8; weights cast to x's dtype inside."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        w1c = w1.to(x.dtype).contiguous()
        w2c = w2.to(x.dtype).contiguous()
        ctx.dtypes = (w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        ctx.save_for_backward(x, w1c, b1, w2c)
        return _mlp_fwd_kernel(x, w1c, b1, w2c, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1c, b1, w2c = ctx.saved_tensors
        dx, *rest = fused_mlp_backward(x, w1c, b1, w2c, dy)
        return (dx, *(g.to(dt) for g, dt in zip(rest, ctx.dtypes)))


def fused_mlp(
    x: torch.Tensor,   # (..., d) bf16
    w1: torch.Tensor,  # (hid, d)
    b1: torch.Tensor,  # (hid,)
    w2: torch.Tensor,  # (d, hid)
    b2: torch.Tensor,  # (d,)
) -> torch.Tensor:
    """Differentiable gelu(x @ w1^T + b1) @ w2^T + b2 in x's dtype (the
    weights are cast to it): kernels 7 and 8 for a CUDA tensor, the plain
    version for a CPU tensor."""
    if not is_kernel_path(x):
        return _fused_mlp_reference(x, w1, b1, w2, b2)
    if needs_grad(x, w1, b1, w2, b2):
        return _MlpFn.apply(x, w1, b1, w2, b2)
    return _mlp_fwd_kernel(x, w1.to(x.dtype).contiguous(), b1,
                           w2.to(x.dtype).contiguous(), b2)


fused_mlp.launches = 0


def _ffn_reference(x, w1, gamma, w2, eps):
    """Plain version of the GEGLU FFN with the TPU kernel's rounding points:
    H = x w1^T from x's dtype's operands into fp32, g = gate * gelu(a) and
    its two-pass LN statistics in fp32, y = ghat * gamma rounded to x's
    dtype before the W2 product. In fp32 it is the JAX package's
    ``_ffn_reference``; in bf16 that one also rounds H and g to bf16, which
    the kernel does not. w1 (2i, d), w2 (d, i)."""
    dt = x.dtype
    h = F.linear(x.float(), w1.to(dt).float())
    i = w2.shape[1]
    g = h[..., i:] * gelu_exact(h[..., :i])
    mean = g.mean(-1, keepdim=True)
    var = g.var(-1, keepdim=True, unbiased=False)
    y = (g - mean) / torch.sqrt(var + eps) * gamma.float()
    return F.linear(y.to(dt), w2.to(dt))


def ffn_supported(shape: tuple, d: int, inner: int) -> bool:
    """The JAX package's fused-FFN gate without its backend test: inner and
    d lane-aligned (128), the rows a nonzero multiple of 8."""
    return inner % 128 == 0 and rows_lane_tileable(shape, d)


def _ffn_backward_reference(x, w1, gamma, w2, dy, eps):
    """Plain version of the GEGLU FFN's backward, the TPU kernel's formulas
    and rounding points (``_ffn_bwd_kernel``): a, gate, g and the LN
    statistics in fp32 from x's dtype's operands, y rounded to x's dtype
    before dW2, dy_ln in fp32, da and dgate rounded before dx and dW1.
    w1 (2i, d), w2 (d, i). Returns (dx in x's dtype, dW1 (2i, d), dgamma,
    dW2 (d, i) in fp32)."""
    dt = x.dtype
    d, i = x.shape[-1], w2.shape[1]
    xf = x.reshape(-1, d)
    do = dy.reshape(-1, d).to(dt)
    w1c, w2c = w1.to(dt).float(), w2.to(dt).float()
    h = xf.float() @ w1c.T
    a, gate = h[:, :i], h[:, i:]
    phi = 0.5 * (1.0 + torch.erf(a * (1.0 / math.sqrt(2.0))))
    ga = a * phi
    g = gate * ga
    c = g - g.mean(-1, keepdim=True)
    rstd = torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    ghat = c * rstd
    gamma32 = gamma.float()
    y = (ghat * gamma32).to(dt)
    dw2 = do.float().T @ y.float()                    # (d, i)
    dy_ln = do.float() @ w2c                          # (n, i)
    dgamma = (dy_ln * ghat).sum(0)
    dghat = dy_ln * gamma32
    m1 = dghat.mean(-1, keepdim=True)
    m2 = (dghat * ghat).mean(-1, keepdim=True)
    dg = rstd * (dghat - m1 - ghat * m2)
    pdf = torch.exp(-0.5 * a * a) / math.sqrt(2.0 * math.pi)
    dh = torch.cat([(dg * gate * (phi + a * pdf)).to(dt), (dg * ga).to(dt)], -1)
    dx = (dh.float() @ w1c).to(dt)
    dw1 = dh.float().T @ xf.float()                   # (2i, d)
    return dx.reshape(x.shape), dw1, dgamma, dw2


@dataclass(frozen=True)
class FfnPlan:
    """Kernel 11's two bf16 tile products (csrc/ffn.cu): ``geglu``, the
    paired-column product of x (n, d) and W1 (2 inner, d), both K-major, W1
    read as boxes of ``bn / 2`` rows (a block's "a" rows, then its "gate"
    rows), writing g = gate * gelu(a) into the fp32 scratch g (n, inner) at
    ``geglu.ldc`` elements a row; ``out`` = y W2^T, y (n, inner) in bf16 at
    ``y_pitch`` elements a row and W2 (d, inner) both K-major."""
    geglu: GemmPlan
    out: GemmPlan
    _arr: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_arr", PlanArray((self.geglu, self.out)))

    def c_array(self):
        """The 42 int64 values ``amt_ffn`` reads (built once)."""
        return self._arr.c_array()

    @property
    def g_pitch(self) -> int:
        return self.geglu.ldc

    @property
    def y_pitch(self) -> int:
        return self.out.a.stride // 2


@functools.lru_cache(maxsize=64)
def ffn_plan(n: int, d: int, inner: int) -> FfnPlan:
    """Kernel 11's plan for n rows of contiguous bf16 x (n, d), W1
    (2 inner, d) and W2 (d, inner), cached on the sizes alone (the
    wrapper checks the operands contiguous and 16-byte aligned first). The
    tile widths were chosen in turns on the H100 (``bench_ffn.py``)."""
    what = "ffn kernel"
    x = scratch_meta("x", n, d, d)
    w1 = scratch_meta("w1", 2 * inner, d, d)
    w2 = scratch_meta("w2", d, inner, inner)
    y = scratch_meta("y", n, inner, row_pitch(inner))
    return FfnPlan(
        gemm_plan(x, K_MAJOR, w1, K_MAJOR, FFN_GEGLU_BN, row_pitch(inner),
                  paired=True, what=what),
        gemm_plan(y, K_MAJOR, w2, K_MAJOR, FFN_OUT_BN if d > 128 else 128, d,
                  what=what))


@dataclass(frozen=True)
class FfnBwdPlan:
    """Kernel 12's five bf16 tile products (csrc/ffn_bwd.cu) and its
    scratches: ``h`` (H = x W1^T, both K-major, fp32 (n, 2 inner)),
    ``dyln`` (dy W2, W2 (d, inner) read MN-major, fp32 (n, inner)),
    ``dw2`` (dy^T y) and ``dw1`` ([da | dgate]^T x), both operands
    MN-major with K = n split into ordered partials, and ``dx``
    ([da | dgate] W1, W1 read MN-major, bf16 out). ``f32`` and ``low``
    lay out the fp32 and the bf16 scratch buffers: (name, offset, size)
    each, and the total."""
    h: GemmPlan
    dyln: GemmPlan
    dw2: GemmPlan
    dx: GemmPlan
    dw1: GemmPlan
    f32: tuple
    low: tuple
    _arr: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_arr", PlanArray(
            (self.h, self.dyln, self.dw2, self.dx, self.dw1)))

    def c_array(self):
        """The 105 int64 values ``amt_ffn_bwd`` reads (built once)."""
        return self._arr.c_array()


def _ffn_bwd_layout(n: int, d: int, inner: int, pitch: dict,
                    wpart: int) -> tuple:
    """The fp32 buffer (H, dy_ln, dgamma's block partials, ``wpart``
    elements of split planes) and the dtype's (y, [da | dgate]) of kernel
    12, at the row pitches ``pitch`` (elements)."""
    f32 = _layout([("h", n * pitch["h"]), ("dyln", n * pitch["dyln"]),
                   ("gpart", -(-n // FFN_BWD_ROWS) * inner),
                   ("wpart", wpart)])
    low = _layout([("y", n * pitch["y"]), ("dh", n * pitch["dh"])])
    return f32, low


@functools.lru_cache(maxsize=64)
def ffn_bwd_plan(n: int, d: int, inner: int) -> FfnBwdPlan:
    """Kernel 12's plan for n rows of contiguous bf16 x and dy (n, d), W1
    (2 inner, d) and W2 (d, inner), cached on the sizes alone (the
    wrapper checks the operands first)."""
    what = "ffn backward"
    i2 = 2 * inner
    pitch = dict(h=row_pitch(i2), dyln=row_pitch(inner), y=row_pitch(inner),
                 dh=row_pitch(i2))
    x, dy = scratch_meta("x", n, d, d), scratch_meta("dy", n, d, d)
    w1 = scratch_meta("w1", i2, d, d)
    w2 = scratch_meta("w2", d, inner, inner)
    y = scratch_meta("y", n, inner, pitch["y"])
    dh = scratch_meta("dh", n, i2, pitch["dh"])
    plans = dict(
        h=gemm_plan(x, K_MAJOR, w1, K_MAJOR, 128, pitch["h"], what=what),
        dyln=gemm_plan(dy, K_MAJOR, w2, MN_MAJOR, 128, pitch["dyln"],
                       what=what),
        dw2=gemm_plan(dy, MN_MAJOR, y, MN_MAJOR, 128, inner, split=True,
                      what=what),
        dx=gemm_plan(dh, K_MAJOR, w1, MN_MAJOR, 128, d, what=what),
        dw1=gemm_plan(dh, MN_MAJOR, x, MN_MAJOR, 128, d, split=True,
                      what=what))
    splits = max(plans["dw2"].splits, plans["dw1"].splits)
    f32, low = _ffn_bwd_layout(n, d, inner, pitch,
                               splits * i2 * d if splits > 1 else 0)
    return FfnBwdPlan(**plans, f32=f32, low=low)


def _check_ffn_operands(x, w1c, gamma, w2c, dy=None):
    """The kernels' shape, dtype and alignment rules, each operand named
    where it breaks one; gamma as contiguous 16-byte aligned fp32."""
    check_tensor(x, "x", (torch.float32, torch.bfloat16))
    d, inner = x.shape[-1], w2c.shape[1]
    if w1c.shape != (2 * inner, d) or w2c.shape != (d, inner):
        raise ValueError(f"ffn kernel: w1 {tuple(w1c.shape)} and w2 "
                         f"{tuple(w2c.shape)} do not fit d={d}")
    if d % 128 or inner % 128:
        raise ValueError(f"ffn kernel: d={d} and inner={inner} must be "
                         f"multiples of 128")
    check_tensor(w1c, "w1", (x.dtype,), 2, x.device)
    check_tensor(w2c, "w2", (x.dtype,), 2, x.device)
    check_tensor(gamma, "gamma", (torch.float32, torch.bfloat16), 1, x.device)
    if gamma.shape != (inner,):
        raise ValueError(f"ffn kernel: gamma must be ({inner},)")
    named = [("x", x), ("w1", w1c), ("w2", w2c)]
    if dy is not None:
        check_tensor(dy, "dy", (x.dtype,), x.dim(), x.device)
        if dy.shape != x.shape:
            raise ValueError("ffn backward: dy must match x")
        named.append(("dy", dy))
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"ffn kernel: {name} starts at an address that "
                             f"is not 16-byte aligned")
    gam = gamma.float().contiguous()
    return gam.clone() if gam.data_ptr() % 16 else gam


def _ffn_fwd_kernel(x, w1c, gamma, w2c, eps):
    """One launch of the forward kernel on weights in x's dtype (bf16 with
    ``ffn_plan``'s plan, fp32 without one)."""
    gam = _check_ffn_operands(x, w1c, gamma, w2c)
    d, inner = x.shape[-1], w2c.shape[1]
    n = x.numel() // d
    out = torch.empty_like(x)
    if n == 0:
        return out
    plan = ffn_plan(n, d, inner) if x.dtype == torch.bfloat16 else None
    pg, py = (plan.g_pitch, plan.y_pitch) if plan else (inner, inner)
    # fp32: g, then the W2 product's split partials (2 n d)
    g = torch.empty(n * pg + (0 if plan else 2 * n * d), dtype=torch.float32,
                    device=x.device)
    part = None if plan else g.data_ptr() + 4 * n * pg
    y = torch.empty(n * py, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "amt_ffn", plan.c_array() if plan else None, x.data_ptr(),
            w1c.data_ptr(), gam.data_ptr(), w2c.data_ptr(), g.data_ptr(),
            y.data_ptr(), part, out.data_ptr(), n, d, inner, eps,
            _build.DTYPE_CODES[x.dtype], _build.stream_of(x),
        )
    fused_ffn.launches += 1
    return out


def fused_ffn_backward(x, w1, gamma, w2, dy, *, eps: float = 1e-5):
    """Gradients of ``fused_ffn`` for the cotangent ``dy``: (dx in x's
    dtype, dW1 (2i, d), dgamma, dW2 (d, i) in fp32), with ``w1``/``w2`` in
    x's dtype. The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if not is_kernel_path(x):
        return _ffn_backward_reference(x, w1, gamma, w2, dy, eps)
    dy = dy.contiguous()
    gam = _check_ffn_operands(x, w1, gamma, w2, dy)
    d, inner = x.shape[-1], w2.shape[1]
    n = x.numel() // d
    if n % 8:
        raise ValueError(f"ffn backward: {n} rows, not a multiple of 8")
    dev, dt = x.device, x.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    # scratch: H = [a | gate] and dy_ln in fp32, y and [da | dgate] in the
    # dtype, per-block partial sums of dgamma, the weight gradients' split
    # planes (bf16: the plan's; fp32: 2 max(n, 2 inner) d elements for the
    # FMA products' split partials, rows 2 inner and inner elements apart)
    if dt == torch.bfloat16:
        plan = ffn_bwd_plan(n, d, inner)
        f32_layout, low_layout = plan.f32, plan.low
    else:
        plan = None
        f32_layout, low_layout = _ffn_bwd_layout(
            n, d, inner, dict(h=2 * inner, dyln=inner, y=inner, dh=2 * inner),
            2 * max(n, 2 * inner) * d)
    bufs = (torch.empty(f32_layout[1], **f32),
            torch.empty(low_layout[1], dtype=dt, device=dev))
    ptr = {name: buf.data_ptr() + off * buf.element_size() if size else None
           for buf, (layout, _) in zip(bufs, (f32_layout, low_layout))
           for name, off, size in layout}
    dx = torch.empty_like(x)
    dw1, dgamma = torch.empty(2 * inner, d, **f32), torch.empty(inner, **f32)
    dw2 = torch.empty(d, inner, **f32)
    with torch.cuda.device(dev):
        _build.launch(
            "amt_ffn_bwd", plan.c_array() if plan else None, x.data_ptr(),
            w1.data_ptr(), gam.data_ptr(), w2.data_ptr(), dy.data_ptr(),
            ptr["h"], ptr["dyln"], ptr["y"], ptr["dh"], ptr["gpart"],
            ptr["wpart"], dx.data_ptr(), dw1.data_ptr(), dgamma.data_ptr(),
            dw2.data_ptr(), n, d, inner, eps, _build.DTYPE_CODES[dt],
            _build.stream_of(x),
        )
    fused_ffn_backward.launches += 1
    return dx, dw1, dgamma, dw2


fused_ffn_backward.launches = 0


class _Ffn(torch.autograd.Function):
    """Forward and backward kernels; weights cast to x's dtype inside."""

    @staticmethod
    def forward(ctx, x, w1, gamma, w2, eps):
        w1c = w1.to(x.dtype).contiguous()
        w2c = w2.to(x.dtype).contiguous()
        ctx.eps = eps
        ctx.dtypes = (w1.dtype, gamma.dtype, w2.dtype)
        ctx.save_for_backward(x, w1c, gamma, w2c)
        return _ffn_fwd_kernel(x, w1c, gamma, w2c, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w1c, gamma, w2c = ctx.saved_tensors
        dx, *rest = fused_ffn_backward(x, w1c, gamma, w2c, dy, eps=ctx.eps)
        return (dx, *(g.to(dt) for g, dt in zip(rest, ctx.dtypes)), None)


def fused_ffn(
    x: torch.Tensor,      # (..., d) bf16 or fp32
    w1: torch.Tensor,     # (2i, d)
    gamma: torch.Tensor,  # (i,)
    w2: torch.Tensor,     # (d, i)
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Differentiable LN_gamma(gate * gelu(a)) @ w2^T with [a | gate] =
    x @ w1^T, in x's dtype (the weights are cast to it): the kernels for a
    CUDA tensor, the plain version for a CPU tensor."""
    if not is_kernel_path(x):
        return _ffn_reference(x, w1, gamma, w2, eps)
    if needs_grad(x, w1, gamma, w2):
        return _Ffn.apply(x, w1, gamma, w2, eps)
    return _ffn_fwd_kernel(x, w1.to(x.dtype).contiguous(), gamma,
                           w2.to(x.dtype).contiguous(), eps)


fused_ffn.launches = 0
