"""Flash attention, forward and backward, on three layouts: kernels
(csrc/flash_attention.cu, csrc/flash_attention_bwd.cu) and plain versions.

Counterparts of ``attention_models_tpu/ops/flash_attention.py``:

- packed kv (kernels 1 and 5): ``flash_attention_bthd_kv`` takes q
  (b, tq, h, d) and kv (b, tk, 2, h, d), the fused kv projection's output
  viewed in place, so k and v are never split into copies;
  ``flash_attention_bwd_kv`` is its backward;
- separate k and v (kernels 9 and 10): ``flash_attention_bthd`` takes q, k, v
  (b, t, h, d); ``flash_attention_bwd_bthd`` returns separate dk and dv;
- per head (kernels 16, 17 and 18), the long-context and ring-attention
  building blocks: ``flash_attention`` on (b, h, t, d), differentiable;
  ``flash_forward`` (out and lse (b, h, tq)); ``flash_bwd_dkv`` and
  ``flash_bwd_dq``, each from a given (global) lse and
  ``delta = flash_delta(o, g)``, so the ring reuses them chunk by chunk;
  ``_flash_backward`` runs dkv, then dq.

The three layouts are three sets of strides into one forward kernel and one
dkv/dq pair of kernels; a kernel takes any view whose last dimension is
contiguous and whose rows are 16-byte aligned (k and v may be views of one
packed kv). The bf16 kernels read q, k, v (and the backward's dout) by TMA:
``fwd_plan`` and ``bwd_plan`` compute on the host everything a launch needs
(each operand's tensor map, the grids, the shared memory, the tile order)
and refuse a view TMA cannot take; the C side encodes the maps and
launches. The forwards return out in q's dtype and the
natural-log logsumexp in fp32. The causal mask is bottom-right aligned;
tq > tk with ``causal=True`` raises. The kernels take bf16 (tensor-core
products, exp2 softmax) and fp32 (exact FMA products and ``expf``), head
width 32 or 64.

On the card each differentiable entry goes through its autograd Function
(kernel forward, kernel backward) when a gradient is recorded and launches
the forward kernel directly otherwise (``needs_grad``). A CPU tensor takes
the plain version; a CUDA tensor a kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field

import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops.dispatch import (
    check_tensor,
    is_kernel_path,
    needs_grad,
)

HEAD_DIMS = (32, 64)  # the head widths the flash kernels are built for
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
MAX_BH = 65535  # b * h: the fp32 forward's grid y (the kernels refuse more)

# the bf16 forward's shape (csrc/flash_attention.cu: kFwdRows, kFwdKeys,
# kFwdStages, kFwdThreads)
FWD_ROWS, FWD_KEYS, FWD_STAGES, FWD_THREADS = 128, 128, 2, 384
# the bf16 backward's (csrc/flash_attention_bwd.cu: kBwdRows, kDkvStages,
# kDqStages, kBwdThreads): a block of one warpgroup owns 64 keys (dkv) or 64
# query rows (dq); tiles of 64 rows stream through a 3-stage (dkv) or
# 2-stage (dq) ring
BWD_ROWS, BWD_DKV_STAGES, BWD_DQ_STAGES, BWD_THREADS = 64, 3, 2, 128


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


# -- plain versions ----------------------------------------------------------

def _row_chunks(tq: int, chunk: int | None) -> list[tuple[int, int]]:
    step = tq if chunk is None else chunk
    return [(r, min(step, tq - r)) for r in range(0, tq, step)]


def _scores(qh, kh, scale: float, causal: bool, row0: int = 0,
            tq: int | None = None) -> torch.Tensor:
    """(q rows row0.. of a tq-row q) K^T * scale, the causal mask's hidden
    entries at -inf."""
    s = (qh @ kh.transpose(-1, -2)) * scale
    if causal:
        rows, tk = s.shape[-2:]
        tq = rows if tq is None else tq
        i = torch.arange(row0, row0 + rows, device=s.device)[:, None]
        j = torch.arange(tk, device=s.device)[None, :]
        s = s.masked_fill(j > i + (tk - tq), float("-inf"))
    return s


def _attend(qh, kh, vh, scale: float, causal: bool, bf16: bool, row0: int,
            tq: int):
    """fp32 (b, h, rows, d) query rows row0.. against all of k and v:
    (out fp32, lse (b, h, rows)). In bf16 with the kernels' rounding points
    (the TPU kernel's and csrc/flash_attention.cu's): q scaled by
    scale * log2(e) and rounded to bf16, the softmax in exp2, P rounded to
    bf16 for the PV product while its row sum stays fp32."""
    if bf16:
        q2 = (qh * (scale * LOG2E)).to(torch.bfloat16).float()
        s2 = _scores(q2, kh, 1.0, causal, row0, tq)            # log2 domain
        m = s2.amax(dim=-1, keepdim=True)
        p = torch.exp2(s2 - m)
        lsum = p.sum(dim=-1, keepdim=True)
        out = (p.to(torch.bfloat16).float() @ vh) / lsum
        lse = ((m + torch.log2(lsum)) * LN2)[..., 0]
    else:
        s = _scores(qh, kh, scale, causal, row0, tq)
        lse = torch.logsumexp(s, dim=-1)
        out = torch.exp(s - lse[..., None]) @ vh
    return out, lse


def _flash_forward_reference(q, k, v, scale: float, causal: bool,
                             chunk: int | None = None):
    """Plain version of kernel 16: q, k, v (b, h, t, d) -> (out like q, lse
    (b, h, tq) fp32), ``chunk`` query rows at a time (the arithmetic of a row
    is unchanged), so a long sequence never holds the whole (t, t) score
    matrix."""
    bf16 = q.dtype == torch.bfloat16
    tq = q.shape[2]
    kh, vh = k.float(), v.float()
    outs, lses = [], []
    for r0, n in _row_chunks(tq, chunk):
        out, lse = _attend(q[:, :, r0:r0 + n].float(), kh, vh, scale, causal,
                           bf16, r0, tq)
        outs.append(out.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _flash_bthd_reference(q, k, v, scale: float, causal: bool):
    """Plain version of kernel 9: q, k, v (b, t, h, d) -> (out like q, lse
    (b, tq, h) fp32)."""
    out, lse = _flash_forward_reference(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), scale, causal)
    return (out.transpose(1, 2).contiguous(),
            lse.transpose(1, 2).contiguous())


def _flash_reference(q: torch.Tensor, kv: torch.Tensor, scale: float,
                     causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 1: q (b, tq, h, d) over packed kv
    (b, tk, 2, h, d) -> (out like q, lse (b, tq, h) fp32)."""
    return _flash_bthd_reference(q, kv[:, :, 0], kv[:, :, 1], scale, causal)


def flash_delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) over the head dim, fp32: (b, tq, h) for the
    (b, t, h, d) layouts, (b, h, tq) for the per-head one."""
    return torch.sum(g.float() * o.float(), dim=-1)


def _backward_heads(q, k, v, g, lse, delta, scale: float, causal: bool,
                    chunk: int | None = None, dq: bool = True,
                    dkv: bool = True):
    """The backward's arithmetic on (b, h, t, d) operands with lse and delta
    (b, h, tq), ``chunk`` query rows at a time (dk and dv summed over the
    chunks): P = exp(S - lse), dV = P^T dO, dS = P * (dO V^T - delta),
    dQ = dS K * scale, dK = dS^T Q * scale. fp32 results (dq None unless
    asked; dk, dv None unless asked). In bf16 with the kernels' rounding
    points: S from q scaled by scale * log2(e) and rounded to bf16, P in
    exp2, P and dS rounded to bf16 before the products that take them."""
    bf16 = q.dtype == torch.bfloat16
    tq = q.shape[2]
    kh, vh = k.float(), v.float()
    dqs, dk, dv = [], None, None
    for r0, n in _row_chunks(tq, chunk):
        rows = slice(r0, r0 + n)
        qh, gh = q[:, :, rows].float(), g[:, :, rows].float()
        lse_r, delta_r = lse[:, :, rows, None], delta[:, :, rows, None]
        if bf16:
            q2 = (qh * (scale * LOG2E)).to(torch.bfloat16).float()
            p = torch.exp2(_scores(q2, kh, 1.0, causal, r0, tq)
                           - lse_r * LOG2E)
        else:
            p = torch.exp(_scores(qh, kh, scale, causal, r0, tq) - lse_r)
        ds = p * (gh @ vh.transpose(-1, -2) - delta_r)
        if bf16:
            p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
        if dkv:
            dv_r = p.transpose(-1, -2) @ gh
            dk_r = (ds.transpose(-1, -2) @ qh) * scale
            dv = dv_r if dv is None else dv + dv_r
            dk = dk_r if dk is None else dk + dk_r
        if dq:
            dqs.append((ds @ kh) * scale)
    return (torch.cat(dqs, dim=2) if dq else None), dk, dv


def _flash_bwd_dkv_reference(q, g, lse, delta, k, v, scale: float,
                             causal: bool, chunk: int | None = None):
    """Plain version of kernel 17: (dk, dv) of one k/v chunk in k's and v's
    dtypes, from the given lse and delta."""
    _, dk, dv = _backward_heads(q, k, v, g, lse, delta, scale, causal, chunk,
                                dq=False)
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_dq_reference(k, v, q, g, lse, delta, scale: float,
                            causal: bool, chunk: int | None = None):
    """Plain version of kernel 18: dq against one k/v chunk in q's dtype,
    from the given lse and delta."""
    dq, _, _ = _backward_heads(q, k, v, g, lse, delta, scale, causal, chunk,
                               dkv=False)
    return dq.to(q.dtype)


def _flash_backward_heads_reference(q, k, v, o, lse, g, scale: float,
                                    causal: bool, chunk: int | None = None):
    """Plain version of ``_flash_backward`` (kernels 17 and 18) on
    (b, h, t, d): (dq, dk, dv) in q's, k's and v's dtypes."""
    dq, dk, dv = _backward_heads(q, k, v, g, lse, flash_delta(o, g), scale,
                                 causal, chunk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_backward_bthd_reference(q, k, v, o, lse, g, scale: float,
                                   causal: bool):
    """Plain version of kernel 10: q, k, v, o, g (b, t, h, d), lse
    (b, tq, h) -> (dq, dk, dv) (b, t, h, d)."""
    heads = [t.transpose(1, 2) for t in (q, k, v, o, lse, g)]
    return tuple(t.transpose(1, 2).contiguous() for t in
                 _flash_backward_heads_reference(*heads, scale, causal))


def _flash_backward_reference(q, kv, o, lse, g, scale: float, causal: bool):
    """Plain version of kernel 5: (dq like q, dkv like kv)."""
    dq, dk, dv = _flash_backward_bthd_reference(q, kv[:, :, 0], kv[:, :, 1],
                                                o, lse, g, scale, causal)
    return dq, torch.stack([dk, dv], dim=2).contiguous()


# -- the bf16 forward's host plan --------------------------------------------

@dataclass(frozen=True)
class TileMap:
    """A rank-4 TMA tensor map over one operand viewed as (b, h, t, d):
    ``dims`` (d, t, h, b) in elements, innermost first; ``strides`` the byte
    steps of t, h and b; ``box`` (d, rows), the tile one load brings."""
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    box: tuple[int, int]


@dataclass(frozen=True)
class FwdPlan:
    """Every host decision of a bf16 forward launch: the maps of q, k and v,
    the swizzle (bytes: one tile row, 128 at d 64, 64 at d 32), the grid
    (b*h, q tiles of FWD_ROWS), the threads, the dynamic shared memory
    (q tile, FWD_STAGES k and v tiles, mbarriers, 1024 bytes to align) and
    the q tiles' order: causal tiles run heaviest (most keys) first."""
    q: TileMap
    k: TileMap
    v: TileMap
    swizzle: int
    grid: tuple[int, int]
    threads: int
    smem: int
    heaviest_first: bool
    _c: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        vals = []
        for m in (self.q, self.k, self.v):
            vals += [*m.dims, *m.strides, *m.box]
        vals += [self.swizzle, *self.grid, self.threads, self.smem,
                 int(self.heaviest_first)]
        object.__setattr__(self, "_c", (ctypes.c_int64 * len(vals))(*vals))

    def c_array(self):
        """The 33 int64 values ``amt_flash_fwd`` reads (built once)."""
        return self._c


def fwd_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the bf16 forward at head width d (the
    struct FwdTiles<d> plus 1024 bytes of alignment slack)."""
    tile = FWD_ROWS * d * 2
    return (1 + 2 * FWD_STAGES) * tile + 8 * (1 + 3 * FWD_STAGES) + 1024


def _tile_map(name: str, shape: tuple, stride: tuple, item: int,
              ptr: int, rows: int = FWD_KEYS) -> TileMap:
    """The map of a (b, h, t, d) view given its shape, element strides,
    item size and address, in tiles of ``rows`` rows; a view TMA cannot
    take raises, naming why."""
    b, h, t, d = shape
    if ptr % 16:
        raise ValueError(f"flash kernel: {name} starts at an address that is "
                         f"not 16-byte aligned, which TMA cannot load")
    if stride[3] != 1:
        raise ValueError(f"flash kernel: {name} needs a contiguous last "
                         f"dimension for TMA (strides {stride})")
    steps = []
    for axis, n, s in (("t", t, stride[2]), ("h", h, stride[1]),
                       ("b", b, stride[0])):
        nbytes = s * item
        if n == 1:  # never stepped: any value TMA accepts
            nbytes = 16
        elif nbytes <= 0 or nbytes % 16:
            raise ValueError(f"flash kernel: {name}'s {axis} stride of "
                             f"{nbytes} bytes is not a positive multiple of "
                             f"16, which TMA cannot take")
        steps.append(nbytes)
    return TileMap((d, t, h, b), tuple(steps), (d, rows))


@functools.lru_cache(maxsize=256)
def _fwd_plan(metas: tuple, causal: bool) -> FwdPlan:
    (q, k, v) = (_tile_map(*m) for m in metas)
    d, tq, h, b = q.dims
    return FwdPlan(q, k, v, swizzle=2 * d, grid=(b * h, -(-tq // FWD_ROWS)),
                   threads=FWD_THREADS, smem=fwd_smem_bytes(d),
                   heaviest_first=causal)


def _meta(name: str, t: torch.Tensor) -> tuple:
    return (name, tuple(t.shape), tuple(t.stride()), t.element_size(),
            t.data_ptr() % 16)


def fwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> FwdPlan:
    """The bf16 forward's plan for (b, h, t, d) views q, k and v, cached by
    the views' shapes, strides and 16-byte alignment, so a serving loop
    pays for it once; the C side encodes the maps at every call."""
    return _fwd_plan((_meta("q", q), _meta("k", k), _meta("v", v)), causal)


# -- the bf16 backward's host plan -------------------------------------------

@dataclass(frozen=True)
class BwdPlan:
    """Every host decision of a bf16 backward launch (the dkv kernel, the dq
    kernel or both): the maps of q, k, v and dout in tiles of BWD_ROWS rows,
    the swizzle (one tile row), the dkv grid (b*h, k tiles), the dq grid
    (b*h, q tiles), the threads, each kernel's dynamic shared memory and the
    dq tiles' order: causal tiles run heaviest (most keys, the last) first.
    The dkv grid's natural order already is heaviest first."""
    q: TileMap
    k: TileMap
    v: TileMap
    dout: TileMap
    swizzle: int
    dkv_grid: tuple[int, int]
    dq_grid: tuple[int, int]
    threads: int
    dkv_smem: int
    dq_smem: int
    dq_heaviest_first: bool
    _c: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        vals = []
        for m in (self.q, self.k, self.v, self.dout):
            vals += [*m.dims, *m.strides, *m.box]
        vals += [self.swizzle, *self.dkv_grid, *self.dq_grid, self.threads,
                 self.dkv_smem, self.dq_smem, int(self.dq_heaviest_first)]
        object.__setattr__(self, "_c", (ctypes.c_int64 * len(vals))(*vals))

    def c_array(self):
        """The 45 int64 values ``amt_flash_bwd_*`` read (built once)."""
        return self._c


def bwd_smem_bytes(d: int) -> tuple[int, int]:
    """Dynamic shared memory of the bf16 dkv and dq kernels at head width d:
    dkv the struct DkvTiles<d> (k and v tiles, BWD_DKV_STAGES stages of q,
    its scaled copy and dout, two buffers of lse and delta rows, mbarriers),
    dq DqTiles<d> (q and dout tiles, BWD_DQ_STAGES stages of k and v,
    mbarriers), each plus 1024 bytes of alignment slack."""
    tile = BWD_ROWS * d * 2
    dkv = (2 + 3 * BWD_DKV_STAGES) * tile + 2 * 2 * BWD_ROWS * 4
    dq = (2 + 2 * BWD_DQ_STAGES) * tile
    return (dkv + 8 * (1 + BWD_DKV_STAGES) + 1024,
            dq + 8 * (1 + 2 * BWD_DQ_STAGES) + 1024)


@functools.lru_cache(maxsize=256)
def _bwd_plan(metas: tuple, causal: bool) -> BwdPlan:
    (q, k, v, dout) = (_tile_map(*m, rows=BWD_ROWS) for m in metas)
    d, tq, h, b = q.dims
    tk = k.dims[1]
    dkv_smem, dq_smem = bwd_smem_bytes(d)
    return BwdPlan(q, k, v, dout, swizzle=2 * d,
                   dkv_grid=(b * h, -(-tk // BWD_ROWS)),
                   dq_grid=(b * h, -(-tq // BWD_ROWS)), threads=BWD_THREADS,
                   dkv_smem=dkv_smem, dq_smem=dq_smem,
                   dq_heaviest_first=causal)


def bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             dout: torch.Tensor, causal: bool) -> BwdPlan:
    """The bf16 backward's plan for (b, h, t, d) views q, k, v and dout,
    cached by the views' shapes, strides and 16-byte alignment; a view TMA
    cannot take (a stride-0 broadcast, an unaligned base or row) raises a
    ValueError naming it."""
    return _bwd_plan((_meta("q", q), _meta("k", k), _meta("v", v),
                      _meta("dout", dout)), causal)


# -- kernel launches -----------------------------------------------------------

def _check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {d}; the kernels take "
                         f"{HEAD_DIMS}")


def _check_views(q: torch.Tensor, *named: tuple[str, torch.Tensor]) -> None:
    """Kernel operands as (b, h, t, d) views of q's dtype (lse and delta:
    fp32 (b, h, t)) on q's device: the last dimension contiguous, rows
    16-byte aligned; b * h within the grid."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel: dtype {q.dtype} not in (float32, "
                        f"bfloat16)")
    _check_head_dim(q.shape[-1])
    if q.shape[0] * q.shape[1] > MAX_BH:
        raise ValueError(f"flash kernel: b*h {q.shape[0] * q.shape[1]} > "
                         f"{MAX_BH}")
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
        if t.dim() == 3:
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: dtype {t.dtype}, needs float32")
            continue
        if t.dtype != q.dtype or t.shape[-1] != q.shape[-1]:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} does not "
                             f"match q's {q.dtype} head dim {q.shape[-1]}")
        item = t.element_size()
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s * item % 16 for s, n in zip(t.stride()[:3], t.shape)
                       if n > 1)):
            raise ValueError(f"flash kernel: {name} needs a contiguous last "
                             f"dimension and 16-byte aligned rows (strides "
                             f"{t.stride()})")


def _strides(*views: torch.Tensor | None):
    """The (batch, head, row) element strides of each view, as the C int64
    array the kernels take (zeros for an absent operand)."""
    vals = []
    for t in views:
        vals += [0, 0, 0] if t is None else list(t.stride()[:3])
    return (ctypes.c_int64 * len(vals))(*vals)


def _plan_array(q, k, v, causal: bool):
    """The bf16 forward's plan as the C array, None in fp32."""
    if q.dtype != torch.bfloat16:
        return None
    return fwd_plan(q, k, v, causal).c_array()


def _launch_fwd(q, k, v, out, lse, scale: float, causal: bool) -> None:
    """The forward kernel on (b, h, t, d) views of q, k, v and out and a
    (b, h, tq) view of lse."""
    _check_views(q, ("q", q), ("k", k), ("v", v), ("out", out), ("lse", lse))
    b, h, tq, d = q.shape
    with torch.cuda.device(q.device):
        _build.launch(
            "amt_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out, lse),
            _plan_array(q, k, v, causal), b, h, tq, k.shape[2], d, scale,
            int(causal), _build.DTYPE_CODES[q.dtype], _build.stream_of(q),
        )


def _bwd_plan_array(q, k, v, g, causal: bool):
    """The bf16 backward's plan as the C array, None in fp32."""
    if q.dtype != torch.bfloat16:
        return None
    return bwd_plan(q, k, v, g, causal).c_array()


def _launch_bwd(q, k, v, g, lse, delta, scale: float, causal: bool, *,
                dq=None, dk=None, dv=None) -> None:
    """The dkv kernel (when dk and dv are given), then the dq kernel (when dq
    is given), on (b, h, t, d) views; lse and delta (b, h, tq) views."""
    outs = [(n, t) for n, t in (("dq", dq), ("dk", dk), ("dv", dv))
            if t is not None]
    _check_views(q, ("q", q), ("k", k), ("v", v), ("g", g), ("lse", lse),
                 ("delta", delta), *outs)
    b, h, tq, d = q.shape
    strides = _strides(q, k, v, g, lse, delta, dq, dk, dv)
    plan = _bwd_plan_array(q, k, v, g, causal)
    tail = (b, h, tq, k.shape[2], d, scale, int(causal),
            _build.DTYPE_CODES[q.dtype], _build.stream_of(q))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        if dk is not None:
            _build.launch("amt_flash_bwd_dkv", *ins, dk.data_ptr(),
                          dv.data_ptr(), strides, plan, *tail)
        if dq is not None:
            _build.launch("amt_flash_bwd_dq", *ins, dq.data_ptr(), strides,
                          plan, *tail)


def _empty(t: torch.Tensor) -> torch.Tensor:
    """A new contiguous tensor of t's shape, dtype and device."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _heads(t: torch.Tensor) -> torch.Tensor:
    """(b, t, h, ...) -> the (b, h, t, ...) view."""
    return t.transpose(1, 2)


# -- packed kv: kernels 1 and 5 --------------------------------------------------

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
    _check_head_dim(q.shape[-1])
    if q.shape[0] * q.shape[2] > MAX_BH:
        raise ValueError(f"flash kernel: b*h {q.shape[0] * q.shape[2]} > "
                         f"{MAX_BH}")
    if any(t.data_ptr() % 16 for t in (q, kv, *(t for _, t in more))):
        raise ValueError("flash kernel: operands must be 16-byte aligned")


def _flash_fwd_kernel(q, kv, scale: float, causal: bool):
    _check_kernel_operands(q, kv)
    b, tq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, tq, h, dtype=torch.float32, device=q.device)
    plan = _plan_array(*map(_heads, (q, kv[:, :, 0], kv[:, :, 1])), causal)
    with torch.cuda.device(q.device):
        _build.launch(
            "amt_flash_fwd_kv", q.data_ptr(), kv.data_ptr(), out.data_ptr(),
            lse.data_ptr(), plan, b, tq, kv.shape[1], h, d, scale,
            int(causal), _build.DTYPE_CODES[q.dtype], _build.stream_of(q),
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
    plan = _bwd_plan_array(*map(_heads, (q, kv[:, :, 0], kv[:, :, 1], g)),
                           causal)
    with torch.cuda.device(q.device):
        _build.launch(
            "amt_flash_bwd_kv", q.data_ptr(), kv.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dkv.data_ptr(),
            plan, b, tq, kv.shape[1], h, d, scale, int(causal),
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


# -- separate k and v on (b, t, h, d): kernels 9 and 10 --------------------------

def _check_bthd(q, k, v, causal: bool) -> None:
    """q (b, tq, h, d), k and v (b, tk, h, d). k and v are read at q's
    batch index, as the JAX package's kernel reads them."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q, k, v (b,t,h,d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if causal:
        _check_causal_lengths(tq, k.shape[1])


def _flash_bthd_kernel(q, k, v, scale: float, causal: bool):
    b, tq, h, _ = q.shape
    out = _empty(q)
    lse = torch.empty(b, tq, h, dtype=torch.float32, device=q.device)
    _launch_fwd(*map(_heads, (q, k, v, out, lse)), scale, causal)
    flash_attention_bthd.launches += 1
    return out, lse


def flash_attention_bwd_bthd(q, k, v, o, lse, g, *, scale: float,
                             causal: bool = False):
    """(dq, dk, dv) of ``flash_attention_bthd`` for the cotangent ``g`` of
    ``o`` (kernel 10: the dkv kernel, then the dq kernel); the plain version
    for CPU tensors. g is made contiguous first: a broadcast cotangent has
    stride 0, which TMA cannot take."""
    _check_bthd(q, k, v, causal)
    if not is_kernel_path(q):
        return _flash_backward_bthd_reference(q, k, v, o, lse, g, scale,
                                              causal)
    g = g.contiguous()
    delta = flash_delta(o, g)
    dq, dk, dv = _empty(q), _empty(k), _empty(v)
    _launch_bwd(*map(_heads, (q, k, v, g, lse, delta)), scale, causal,
                dq=_heads(dq), dk=_heads(dk), dv=_heads(dv))
    flash_attention_bwd_bthd.launches += 1
    return dq, dk, dv


flash_attention_bwd_bthd.launches = 0


class _FlashBthd(torch.autograd.Function):
    """Kernel 9 forward, kernel 10 backward; lse has no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = _flash_bthd_kernel(q, k, v, scale, causal)
        ctx.scale, ctx.causal = scale, causal
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_bthd(
            q, k, v, out, lse, g.contiguous(), scale=ctx.scale,
            causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_bthd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: float | None = None, causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable attention over q (b, tq, h, d) and separate k, v
    (b, tk, h, d), the JAX package's ``flash_attention_bthd``; returns
    (out (b, tq, h, d), lse (b, tq, h) fp32). k and v may be strided views
    (``kv[:, :, 0]``), read in place."""
    _check_bthd(q, k, v, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not is_kernel_path(q):
        return _flash_bthd_reference(q, k, v, scale, causal)
    if needs_grad(q, k, v):
        return _FlashBthd.apply(q, k, v, scale, causal)
    return _flash_bthd_kernel(q, k, v, scale, causal)


flash_attention_bthd.launches = 0


# -- per head (b, h, t, d): kernels 16, 17 and 18 --------------------------------

def _check_heads_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q, k, v (b,h,t,d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (k.shape[0], k.shape[1], k.shape[3]) != (q.shape[0], q.shape[1],
                                                q.shape[3]):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if causal:
        _check_causal_lengths(q.shape[2], k.shape[2])


def flash_forward(q, k, v, *, scale: float, causal: bool = False):
    """Kernel 16 (the JAX package's ``_flash_forward``): q, k, v
    (b, h, t, d) -> (out like q, natural-log lse (b, h, tq) fp32); the plain
    version for CPU tensors."""
    _check_heads_shapes(q, k, v, causal)
    if not is_kernel_path(q):
        return _flash_forward_reference(q, k, v, scale, causal)
    b, h, tq, _ = q.shape
    out = _empty(q)
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=q.device)
    _launch_fwd(q, k, v, out, lse, scale, causal)
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def flash_bwd_dkv(q, g, lse, delta, k, v, *, scale: float,
                  causal: bool = False):
    """Kernel 17 (the JAX package's ``flash_bwd_dkv``): the partial dk, dv
    of the k/v chunk from the GLOBAL lse and delta (b, h, tq), in k's and
    v's dtypes."""
    _check_heads_shapes(q, k, v, causal)
    if not is_kernel_path(q):
        return _flash_bwd_dkv_reference(q, g, lse, delta, k, v, scale, causal)
    dk, dv = _empty(k), _empty(v)
    _launch_bwd(q, k, v, g, lse, delta, scale, causal, dk=dk, dv=dv)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(k, v, q, g, lse, delta, *, scale: float,
                 causal: bool = False):
    """Kernel 18 (the JAX package's ``flash_bwd_dq``): the partial dq
    against the k/v chunk from the GLOBAL lse and delta, in q's dtype."""
    _check_heads_shapes(q, k, v, causal)
    if not is_kernel_path(q):
        return _flash_bwd_dq_reference(k, v, q, g, lse, delta, scale, causal)
    dq = _empty(q)
    _launch_bwd(q, k, v, g, lse, delta, scale, causal, dq=dq)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def _flash_backward(q, k, v, o, lse, g, *, scale: float,
                    causal: bool = False):
    """(dq, dk, dv) of ``flash_attention``: delta, then kernel 17, then
    kernel 18, as the JAX package's ``_flash_backward``."""
    delta = flash_delta(o, g)
    dk, dv = flash_bwd_dkv(q, g, lse, delta, k, v, scale=scale, causal=causal)
    dq = flash_bwd_dq(k, v, q, g, lse, delta, scale=scale, causal=causal)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Kernel 16 forward; kernels 17 and 18 backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_forward(q, k, v, scale=scale, causal=causal)
        ctx.scale, ctx.causal = scale, causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, g.contiguous(),
                                     scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: float | None = None, causal: bool = False,
) -> torch.Tensor:
    """Differentiable flash attention over (b, h, t, d) tensors, the JAX
    package's ``flash_attention``: out in q's dtype. Its memory is O(t) at
    any length (no (t, t) score matrix on the card)."""
    _check_heads_shapes(q, k, v, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not is_kernel_path(q):
        return _flash_forward_reference(q, k, v, scale, causal)[0]
    if needs_grad(q, k, v):
        return _Flash.apply(q, k, v, scale, causal)
    return flash_forward(q, k, v, scale=scale, causal=causal)[0]
