"""The host plans of the W8A8 GEGLU FFN (kernel 19), wide FFN (kernel 20)
and pre-LN MLP (kernel 21, csrc/quant.cu) and the widths the three W8A8
blocks take, checked through faked launches on the CPU: everything the C
side is handed is decided in ops/quant.py (on ops/gemm_sm90.py).

- Kernel 21 at the int8 tokenizer's (8192, 512), hid 1368, and at (520,
  768), hid 8704: both int8 products' maps (K-major, boxes of 128 int8 of
  K; the down-projection's K = hid, so TMA zero-fills past it), grids, tile
  widths, g's pitch, g_q's and W2q's 64-byte pitch (W2q staged at every
  call where hid is not a multiple of 64), fp32 launching with the same
  plan, a hidden width not a multiple of 8 padded with the same bits,
  misaligned operands refused by name unlaunched, the cache, and a CPU
  emulation of both int8 products in 128-int8 K slices through the
  dequantising epilogues, bit-equal to ``_ln_mlp_q8_reference``.

- Kernel 19 at the same three shapes: the paired int8 product's maps (x_q
  K-major, W1q read as boxes of half a tile of rows by 128 int8 of K), grid
  and g's pitch; the int8 down-projection's plan; the scratches' pitches;
  fp32 launching with the same plan; misaligned weights refused by name
  before any launch; the plan cache; and a CPU emulation of the paired
  int8 blocks in 128-int8 K slices, dequantised, through the tail, bit-equal
  to ``_ffn_q8_reference``.

- Kernel 20 at Muse's (16384, 1024), inner 4096, at ragged rows (520,
  1024, 4096) and at inner 8704 (520, 768): the paired-column GEGLU
  product's maps (W1 read as boxes of half a tile: a block's "a" rows, then
  its "gate" rows), grid, tile width and g's 64-byte pitch; the int8
  product's maps (K boxes of 128 int8, both operands K-major), K slices,
  grid and shared memory.
- fp32 launching with the same plan, misaligned operands refused by name
  before any launch, the plan cache, and inner, d and hid above 4096
  reaching kernels 19, 20 and 21.
- CPU emulations of what the card computes: the paired blocks, the row
  pass and the int8 product in 128-byte K slices against
  ``_ffn_q8wide_reference`` (fp32, equal codes and bits), and the fp32
  up-projection's DMMA order (k in steps of 16, float64, rounded once)
  against the plain float64 product, bit for bit.
The expected values are written out from the layouts, not from the plan
code.
"""

import contextlib

import numpy as np
import pytest
import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops import gemm_sm90 as t_gemm
from attention_models_torch.ops import quant as t_q

SMEM_LIMIT = 232448
SMEM_128 = 3 * (128 + 128) * 128 + 3 * 16 + 1024    # 99376
SMEM_256 = 4 * (128 + 256) * 128 + 4 * 16 + 1024    # 197696
# where amt_ffn_q8wide takes each pointer after the plan (ops/_build.py)
ARGS = ("x", "w1", "gamma", "w2q", "s2", "g", "yq", "sy", "out")
# ... and amt_ffn_q8
ARGS_19 = ("x", "w1q", "s1", "gamma", "w2q", "s2", "xq", "sx", "g", "yq",
           "sy", "out")


def _fake_launches(monkeypatch):
    """The kernel path without a card: each launch records its name and
    arguments."""
    launched = []
    for mod in (t_q, t_gemm):
        monkeypatch.setattr(mod, "is_kernel_path", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append((name, a)))
    return launched


def _decode(arr, count):
    """``count`` plans of 21 values each, by name."""
    v = list(arr)
    assert len(v) == 21 * count
    out = []
    for i in range(count):
        p = v[21 * i:21 * (i + 1)]
        out.append(dict(
            a=dict(dims=tuple(p[0:2]), stride=p[2], box=tuple(p[3:5]),
                   major=p[5]),
            b=dict(dims=tuple(p[6:8]), stride=p[8], box=tuple(p[9:11]),
                   major=p[11]),
            swizzle=p[12], grid=tuple(p[13:16]), threads=p[16], smem=p[17],
            bn=p[18], ldc=p[19], kslices=p[20]))
    return out


def _qw(rows, cols):
    return t_q.QuantWeight(torch.zeros(rows, cols, dtype=torch.int8),
                           torch.ones(rows))


def _q8wide(monkeypatch, n, d, inner, dtype=torch.bfloat16):
    launched = _fake_launches(monkeypatch)
    t_q.fused_ffn_q8wide(torch.zeros(n, d, dtype=dtype),
                         torch.zeros(2 * inner, d), torch.ones(inner),
                         _qw(d, inner))
    ((name, args),) = launched
    assert name == "amt_ffn_q8wide"
    assert args[10:15] == (n, d, inner, 1e-5, _build.DTYPE_CODES[dtype])
    return args[0], dict(zip(ARGS, args[1:10]))


# (n, d, inner): Muse, ragged rows, a row wider than 4096
KERNEL_20 = [(16384, 1024, 4096), (520, 1024, 4096), (520, 768, 8704)]


@pytest.mark.parametrize("n,d,inner", KERNEL_20)
def test_kernel_20_paired_plan(monkeypatch, n, d, inner):
    arr, _ = _q8wide(monkeypatch, n, d, inner)
    geglu, _ = _decode(arr, 2)
    # x (n, d) and W1 (2 inner, d) bf16, K-major, K boxes of 64; W1's boxes
    # 128 rows (half of BN 256): block x loads W1 rows 128 x .. ("a") and
    # inner + 128 x .. ("gate"), and writes g's columns 128 x .. + 127
    assert geglu["a"] == dict(dims=(d, n), stride=2 * d, box=(64, 128),
                              major=0)
    assert geglu["b"] == dict(dims=(d, 2 * inner), stride=2 * d,
                              box=(64, 128), major=0)
    assert geglu["bn"] == 256
    assert geglu["grid"] == (2 * inner // 256, -(-n // 128), 1)
    assert geglu["grid"][0] * geglu["b"]["box"][1] == inner
    assert geglu["kslices"] == d // 64
    # g fp32 (n, inner) at a 64-byte pitch
    assert geglu["ldc"] >= inner and (4 * geglu["ldc"]) % 64 == 0
    assert (geglu["swizzle"], geglu["threads"], geglu["smem"]) == (
        128, 288, SMEM_256)


@pytest.mark.parametrize("n,d,inner", KERNEL_20)
def test_kernel_20_int8_plan(monkeypatch, n, d, inner):
    arr, _ = _q8wide(monkeypatch, n, d, inner)
    _, out = _decode(arr, 2)
    # y_q (n, inner) and W2q (d, inner) int8, both K-major: K boxes of 128
    # int8 (one 128-byte swizzle row, as 64 bf16), rows inner bytes apart
    assert out["a"] == dict(dims=(inner, n), stride=inner, box=(128, 128),
                            major=0)
    assert out["b"] == dict(dims=(inner, d), stride=inner, box=(128, 256),
                            major=0)
    assert out["kslices"] == inner // 128
    assert (out["bn"], out["grid"], out["ldc"]) == (
        256, (-(-d // 256), -(-n // 128), 1), d)
    # the ring's bytes are the bf16 form's
    assert (out["swizzle"], out["threads"], out["smem"]) == (
        128, 288, SMEM_256)
    assert out["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("n,d,inner", KERNEL_20)
def test_kernel_20_scratches(monkeypatch, n, d, inner):
    _, ptrs = _q8wide(monkeypatch, n, d, inner)
    plan = t_q.q8wide_plan(n, d, inner)
    assert plan.g_pitch == inner and plan.q_pitch == inner
    for name in ("g", "yq", "sy", "out"):
        assert ptrs[name] % 16 == 0


def test_small_d_takes_the_narrow_tile():
    p = t_q.q8wide_plan(64, 128, 256)
    assert (p.out.bn, p.out.grid, p.out.smem) == (128, (1, 1, 1), SMEM_128)
    assert p.geglu.grid == (2, 1, 1)


def test_fp32_launches_with_the_same_plan(monkeypatch):
    n, d, inner = 520, 768, 8704
    arr, ptrs = _q8wide(monkeypatch, n, d, inner, dtype=torch.float32)
    plan = t_q.q8wide_plan(n, d, inner)
    assert list(arr) == list(plan.c_array())
    # the fp64 tensor-core product writes g at the GEGLU plan's pitch
    assert plan.g_pitch * 4 % 64 == 0
    assert ptrs["yq"] % 16 == 0


def _misaligned(t):
    """``t``'s values in a tensor whose storage starts one element past a
    16-byte boundary."""
    n = t.numel()
    buf = torch.zeros(n + 16, dtype=t.dtype)
    return buf[1:n + 1].view(t.shape)


@pytest.mark.parametrize("which", ["x", "w1", "w2 int8"])
def test_misaligned_operands_refused_unlaunched(monkeypatch, which):
    launched = _fake_launches(monkeypatch)
    x = torch.zeros(16, 128, dtype=torch.bfloat16)
    w1 = torch.zeros(256, 128, dtype=torch.bfloat16)
    q2 = _qw(128, 128)
    if which == "x":
        x = _misaligned(x)
    elif which == "w1":
        w1 = _misaligned(w1)
    else:
        q2 = t_q.QuantWeight(_misaligned(q2.q), q2.scale)
    with pytest.raises(ValueError, match=f"ffn_q8wide kernel: {which} starts"):
        t_q.fused_ffn_q8wide(x, w1, torch.ones(128), q2)
    assert launched == []


def test_int8_operands_are_read_k_major_only():
    m = t_gemm.scratch_meta("yq", 64, 256, 256, item=1)
    with pytest.raises(ValueError, match="K-major only"):
        t_gemm.gemm_plan(m, t_gemm.MN_MAJOR, m, t_gemm.K_MAJOR, 128, 64)


def test_plans_are_cached():
    p = t_q.q8wide_plan(64, 128, 256)
    assert p is t_q.q8wide_plan(64, 128, 256)
    assert p.c_array() is p.c_array()


@pytest.mark.parametrize("kernel,d,wide", [(19, 4224, 4352), (20, 768, 8704),
                                           (21, 4224, 4352)])
def test_rows_wider_than_4096_reach_the_kernels(monkeypatch, kernel, d, wide):
    """d, inner and hid above the 4096 values a row pass holds in registers
    (it walks such a row in chunks) launch, as JAX's gates take them."""
    launched = _fake_launches(monkeypatch)
    x = torch.zeros(520, d, dtype=torch.bfloat16)
    if kernel == 19:
        t_q.fused_ffn_q8(x, _qw(2 * wide, d), torch.ones(wide), _qw(d, wide))
    elif kernel == 20:
        t_q.fused_ffn_q8wide(x, torch.zeros(2 * wide, d), torch.ones(wide),
                             _qw(d, wide))
    else:
        t_q.fused_ln_mlp_q8(x, torch.ones(d), torch.zeros(d), _qw(wide, d),
                            torch.zeros(wide), _qw(d, wide), torch.zeros(d))
    ((name, args),) = launched
    assert name == {19: "amt_ffn_q8", 20: "amt_ffn_q8wide",
                    21: "amt_ln_mlp_q8"}[kernel]


def _operands(n, d, inner, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    w1 = torch.tensor(rng.standard_normal((2 * inner, d)) / d ** 0.5,
                      dtype=torch.float32)
    gamma = torch.tensor(1 + 0.1 * rng.standard_normal(inner),
                         dtype=torch.float32)
    w2 = torch.tensor(rng.standard_normal((d, inner)) / inner ** 0.5,
                      dtype=torch.float32)
    return x, w1, gamma, t_q.quantize_weight(w2)


def _tail(h, inner, gamma, q2, slice_k):
    """g from H, then the row pass and the int8 product over K slices of
    ``slice_k`` int8 (int64 sums: exact), dequantised."""
    g = h[:, inner:] * t_q.gelu_exact(h[:, :inner])
    yq, sy = t_q.quantize_rows(t_q.ln_rows(g, gamma, None, 1e-5))
    acc = torch.zeros(yq.shape[0], q2.q.shape[0], dtype=torch.int64)
    for k0 in range(0, inner, slice_k):
        acc += yq[:, k0:k0 + slice_k].long() @ q2.q[:, k0:k0 + slice_k].long().T
    return (acc.float() * sy) * q2.scale, yq


@pytest.mark.parametrize("inner", [512, 1152])
def test_paired_blocks_and_int8_slices_match_the_plain_version(inner):
    """H built block by block from the plan's (a row, gate row) pairs, as the
    paired product's producer loads them, g = gate * gelu(a), the row pass,
    and y_q W2q^T summed slice by slice over the int8 plan's 128-byte K
    boxes: equal to ``_ffn_q8wide_reference`` in fp32, codes and bits."""
    n, d = 48, 128
    x, w1, gamma, q2 = _operands(n, d, inner, 5)
    plan = t_q.q8wide_plan(n, d, inner)
    half, blocks = plan.geglu.b.box[1], plan.geglu.grid[0]
    h = torch.empty(n, 2 * inner)
    for bx in range(blocks):
        rows = list(range(bx * half, (bx + 1) * half))
        gate_rows = [blocks * half + r for r in rows]
        tile = (x.double() @ torch.cat([w1[rows], w1[gate_rows]]).double().T
                ).float()
        h[:, rows] = tile[:, :half]
        h[:, [inner + r for r in rows]] = tile[:, half:]
    got, yq = _tail(h, inner, gamma, q2, plan.out.a.box[0])
    codes = {}
    want = t_q._ffn_q8wide_reference(x, w1, gamma, q2, 1e-5, codes)
    assert plan.out.a.box[0] == 128
    assert torch.equal(yq, codes["yq"])
    assert torch.equal(got, want)


def test_dmma_order_matches_the_float64_product():
    """The fp32 up-projection's order: k in 32-deep slices of two steps of
    16 (one m16n8k16 DMMA each), exact products of the fp32 operands summed
    in float64, rounded once to fp32: bit-equal to the plain version's
    float64 product rounded, with equal codes downstream."""
    n, d, inner = 40, 256, 256
    x, w1, gamma, q2 = _operands(n, d, inner, 11)
    x64, w64 = x.double(), w1.double()
    acc = torch.zeros(n, 2 * inner, dtype=torch.float64)
    for k0 in range(0, d, 16):
        acc += x64[:, k0:k0 + 16] @ w64[:, k0:k0 + 16].T
    h = acc.float()
    assert torch.equal(h, (x64 @ w64.T).float())
    got, yq = _tail(h, inner, gamma, q2, 128)
    codes = {}
    want = t_q._ffn_q8wide_reference(x, w1, gamma, q2, 1e-5, codes)
    assert torch.equal(yq, codes["yq"])
    assert torch.equal(got, want)


def test_int8_tile_product_plan_and_plain_version(monkeypatch):
    """The int8 form alone (chip_smoke.py's check against torch._int_mm):
    one plan at tile width 128 with 128-int8 K boxes, K past the last box
    included; on the CPU the exact float64 product, scaled as the
    DequantStore epilogue scales."""
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.integers(-127, 128, (40, 1040)), dtype=torch.int8)
    b = torch.tensor(rng.integers(-127, 128, (24, 1040)), dtype=torch.int8)
    sr, sc = torch.rand(40), torch.rand(24)
    got = t_gemm.tile_product_s8(a, b, sr, sc)
    want = (t_q.int_dot(a, b) * sr[:, None]) * sc
    assert torch.equal(got, want)
    launched = _fake_launches(monkeypatch)
    t_gemm.tile_product_s8(a, b)
    ((name, args),) = launched
    assert name == "amt_tile_product_s8"
    (plan,) = _decode(args[0], 1)
    assert plan["a"] == dict(dims=(1040, 40), stride=1040, box=(128, 128),
                             major=0)
    assert plan["b"] == dict(dims=(1040, 24), stride=1040, box=(128, 128),
                             major=0)
    assert (plan["kslices"], plan["grid"], plan["bn"]) == (9, (1, 1, 1), 128)
    assert args[6:10] == (40, 24, 1040, 24)


# -- kernel 19 -------------------------------------------------------------------

def _q8(monkeypatch, n, d, inner, dtype=torch.bfloat16):
    launched = _fake_launches(monkeypatch)
    t_q.fused_ffn_q8(torch.zeros(n, d, dtype=dtype), _qw(2 * inner, d),
                     torch.ones(inner), _qw(d, inner))
    ((name, args),) = launched
    assert name == "amt_ffn_q8"
    assert args[13:18] == (n, d, inner, 1e-5, _build.DTYPE_CODES[dtype])
    return args[0], dict(zip(ARGS_19, args[1:13]))


@pytest.mark.parametrize("n,d,inner", KERNEL_20)
def test_kernel_19_paired_int8_plan(monkeypatch, n, d, inner):
    arr, _ = _q8(monkeypatch, n, d, inner)
    geglu, _ = _decode(arr, 2)
    # x_q (n, d) and W1q (2 inner, d) int8, K-major, K boxes of 128 int8
    # (one 128-byte swizzle row); W1q's boxes 128 rows (half of BN 256):
    # block x loads W1q rows 128 x .. ("a") and inner + 128 x .. ("gate")
    # and writes g's columns 128 x .. + 127
    assert geglu["a"] == dict(dims=(d, n), stride=d, box=(128, 128), major=0)
    assert geglu["b"] == dict(dims=(d, 2 * inner), stride=d, box=(128, 128),
                              major=0)
    assert geglu["bn"] == 256
    assert geglu["grid"] == (2 * inner // 256, -(-n // 128), 1)
    assert geglu["grid"][0] * geglu["b"]["box"][1] == inner
    assert geglu["kslices"] == d // 128
    assert geglu["ldc"] >= inner and (4 * geglu["ldc"]) % 64 == 0
    assert (geglu["swizzle"], geglu["threads"], geglu["smem"]) == (
        128, 288, SMEM_256)


@pytest.mark.parametrize("n,d,inner", KERNEL_20)
def test_kernel_19_int8_out_plan(monkeypatch, n, d, inner):
    """Kernel 19's down-projection is kernel 20's, plan for plan."""
    arr, _ = _q8(monkeypatch, n, d, inner)
    _, out = _decode(arr, 2)
    assert out["a"] == dict(dims=(inner, n), stride=inner, box=(128, 128),
                            major=0)
    assert out["b"] == dict(dims=(inner, d), stride=inner, box=(128, 256),
                            major=0)
    assert (out["bn"], out["grid"], out["ldc"], out["kslices"]) == (
        256, (-(-d // 256), -(-n // 128), 1), d, inner // 128)
    assert out["smem"] == SMEM_256 <= SMEM_LIMIT
    assert t_q.q8_plan(n, d, inner).out == t_q.q8wide_plan(n, d, inner).out


@pytest.mark.parametrize("n,d,inner", KERNEL_20)
def test_kernel_19_scratches(monkeypatch, n, d, inner):
    _, ptrs = _q8(monkeypatch, n, d, inner)
    plan = t_q.q8_plan(n, d, inner)
    assert (plan.x_pitch, plan.g_pitch, plan.q_pitch) == (d, inner, inner)
    for name in ("xq", "sx", "g", "yq", "sy", "out"):
        assert ptrs[name] % 16 == 0


def test_kernel_19_fp32_launches_with_the_same_plan(monkeypatch):
    n, d, inner = 520, 768, 8704
    arr, ptrs = _q8(monkeypatch, n, d, inner, dtype=torch.float32)
    assert list(arr) == list(t_q.q8_plan(n, d, inner).c_array())
    assert ptrs["g"] % 16 == 0


@pytest.mark.parametrize("which", ["w1 int8", "w2 int8"])
def test_kernel_19_misaligned_weights_refused_unlaunched(monkeypatch, which):
    launched = _fake_launches(monkeypatch)
    q1, q2 = _qw(256, 128), _qw(128, 128)
    if which == "w1 int8":
        q1 = t_q.QuantWeight(_misaligned(q1.q), q1.scale)
    else:
        q2 = t_q.QuantWeight(_misaligned(q2.q), q2.scale)
    with pytest.raises(ValueError, match=f"ffn_q8 kernel: {which} starts"):
        t_q.fused_ffn_q8(torch.zeros(16, 128, dtype=torch.bfloat16), q1,
                         torch.ones(128), q2)
    assert launched == []


def test_kernel_19_plans_are_cached():
    p = t_q.q8_plan(64, 128, 256)
    assert p is t_q.q8_plan(64, 128, 256)
    assert p.c_array() is p.c_array()
    assert p is not t_q.q8wide_plan(64, 128, 256)


@pytest.mark.parametrize("inner", [512, 1152])
def test_paired_int8_blocks_match_the_plain_version(inner):
    """x's codes, then H block by block from the plan's (a row, gate row)
    pairs of W1q, as the paired int8 product's producer loads them, summed
    over its 128-int8 K slices (int64: exact) and dequantised as the
    GegluDequant epilogue does, g = gate * gelu(a), the row pass and the
    int8 down-projection: equal to ``_ffn_q8_reference`` in fp32, codes and
    bits."""
    n, d = 48, 256
    x, w1, gamma, q2 = _operands(n, d, inner, 7)
    q1 = t_q.quantize_weight(w1)
    plan = t_q.q8_plan(n, d, inner)
    half, blocks = plan.geglu.b.box[1], plan.geglu.grid[0]
    ks = plan.geglu.a.box[0]
    xq, sx = t_q.quantize_rows(x)
    acc = torch.zeros(n, 2 * inner, dtype=torch.int64)
    for bx in range(blocks):
        rows = list(range(bx * half, (bx + 1) * half))
        pair = torch.cat([q1.q[rows], q1.q[[blocks * half + r for r in rows]]])
        tile = torch.zeros(n, 2 * half, dtype=torch.int64)
        for k0 in range(0, d, ks):
            tile += xq[:, k0:k0 + ks].long() @ pair[:, k0:k0 + ks].long().T
        acc[:, rows] = tile[:, :half]
        acc[:, [inner + r for r in rows]] = tile[:, half:]
    h = (acc.float() * sx) * q1.scale
    got, yq = _tail(h, inner, gamma, q2, plan.out.a.box[0])
    codes = {}
    want = t_q._ffn_q8_reference(x, q1, gamma, q2, 1e-5, codes)
    assert (ks, plan.geglu.kslices) == (128, d // 128)
    assert torch.equal(yq, codes["yq"])
    assert torch.equal(got, want)


# -- kernel 21 -------------------------------------------------------------------

# where amt_ln_mlp_q8 takes each pointer after the plan (ops/_build.py)
ARGS_21 = ("x", "lng", "lnb", "w1q", "s1", "b1", "w2q", "s2", "b2", "w2s",
           "yq", "sy", "g", "gq", "sg", "out")


def _ln_q8(monkeypatch, n, d, hid, dtype=torch.bfloat16, q2=None):
    launched = _fake_launches(monkeypatch)
    q2 = _qw(d, hid) if q2 is None else q2
    t_q.fused_ln_mlp_q8(torch.zeros(n, d, dtype=dtype), torch.ones(d),
                        torch.zeros(d), _qw(hid, d), torch.zeros(hid), q2,
                        torch.zeros(d))
    ((name, args),) = launched
    assert name == "amt_ln_mlp_q8"
    hid8 = -(-hid // 8) * 8
    assert args[17:22] == (n, d, hid8, 1e-5, _build.DTYPE_CODES[dtype])
    return args[0], dict(zip(ARGS_21, args[1:17])), hid8


# (n, d, hid, g's pitch in fp32 elements, g_q's and W2q's pitch in bytes)
KERNEL_21 = [(8192, 512, 1368, 1376, 1408), (520, 768, 8704, 8704, 8704)]


@pytest.mark.parametrize("n,d,hid,g_pitch,q_pitch", KERNEL_21)
def test_kernel_21_int8_plans(monkeypatch, n, d, hid, g_pitch, q_pitch):
    arr, _, _ = _ln_q8(monkeypatch, n, d, hid)
    up, down = _decode(arr, 2)
    # h = y_q W1q^T: y_q (n, d) and W1q (hid, d) int8, K-major, K boxes of
    # 128 int8; tile width 128 (two blocks an SM), g fp32 at a 64-byte pitch
    assert up["a"] == dict(dims=(d, n), stride=d, box=(128, 128), major=0)
    assert up["b"] == dict(dims=(d, hid), stride=d, box=(128, 128), major=0)
    assert (up["bn"], up["grid"], up["ldc"], up["kslices"]) == (
        128, (-(-hid // 128), -(-n // 128), 1), g_pitch, d // 128)
    assert (4 * up["ldc"]) % 64 == 0
    # out = g_q W2q^T + b2 + x: g_q (n, hid) and W2q (d, hid) at a 64-byte
    # pitch, K = hid (not the pitch): the last box reaches past hid and TMA
    # zero-fills it, so the padding columns are never read
    assert down["a"] == dict(dims=(hid, n), stride=q_pitch, box=(128, 128),
                             major=0)
    assert down["b"] == dict(dims=(hid, d), stride=q_pitch, box=(128, 128),
                             major=0)
    assert q_pitch % 64 == 0
    assert (down["bn"], down["grid"], down["ldc"], down["kslices"]) == (
        128, (d // 128, -(-n // 128), 1), d, -(-hid // 128))
    for p in (up, down):
        assert (p["swizzle"], p["threads"], p["smem"]) == (128, 288,
                                                            SMEM_128)


@pytest.mark.parametrize("n,d,hid,g_pitch,q_pitch", KERNEL_21)
def test_kernel_21_scratches(monkeypatch, n, d, hid, g_pitch, q_pitch):
    _, ptrs, _ = _ln_q8(monkeypatch, n, d, hid)
    plan = t_q.ln_mlp_q8_plan(n, d, hid)
    assert (plan.y_pitch, plan.g_pitch, plan.q_pitch) == (d, g_pitch, q_pitch)
    staged = hid % 64 != 0
    assert plan.w2_stage_bytes == (d * q_pitch if staged else 0)
    assert (ptrs["w2s"] is None) == (not staged)
    for name, p in ptrs.items():
        assert p is None or p % 16 == 0, name


def test_kernel_21_stages_w2q_at_every_call(monkeypatch):
    """W2q (512, 1368) reaches the C side as the weight itself, with a
    stage of 512 rows of 1408 bytes for the C side to fill at every call;
    a write through ``.data`` reaches the next call."""
    q2 = t_q.QuantWeight(torch.ones(512, 1368, dtype=torch.int8),
                         torch.ones(512))
    for step in range(2):
        _, ptrs, _ = _ln_q8(monkeypatch, 64, 512, 1368, q2=q2)
        assert ptrs["w2q"] == q2.q.data_ptr() and ptrs["w2s"] is not None
        assert int(q2.q[0, 0]) == 1 + step
        q2.q.data.add_(1)
        monkeypatch.undo()


def test_kernel_21_fp32_launches_with_the_same_plan(monkeypatch):
    n, d, hid = 8192, 512, 1368
    arr, _, _ = _ln_q8(monkeypatch, n, d, hid, dtype=torch.float32)
    assert list(arr) == list(t_q.ln_mlp_q8_plan(n, d, hid).c_array())


def test_kernel_21_plan_is_cached():
    p = t_q.ln_mlp_q8_plan(64, 128, 96)
    assert p is t_q.ln_mlp_q8_plan(64, 128, 96)
    assert p.c_array() is p.c_array()


@pytest.mark.parametrize("which", ["x", "w1 int8", "w2 int8"])
def test_kernel_21_misaligned_operands_refused_unlaunched(monkeypatch, which):
    launched = _fake_launches(monkeypatch)
    x = torch.zeros(16, 128, dtype=torch.bfloat16)
    q1, q2 = _qw(96, 128), _qw(128, 96)
    if which == "x":
        x = _misaligned(x)
    elif which == "w1 int8":
        q1 = t_q.QuantWeight(_misaligned(q1.q), q1.scale)
    else:
        q2 = t_q.QuantWeight(_misaligned(q2.q), q2.scale)
    with pytest.raises(ValueError, match=f"ln_mlp_q8 kernel: {which} starts"):
        t_q.fused_ln_mlp_q8(x, torch.ones(128), torch.zeros(128), q1,
                            torch.zeros(96), q2, torch.zeros(128))
    assert launched == []


def _ln_q8_operands(n, d, hid, seed):
    rng = np.random.default_rng(seed)
    def f32(*shape, scale=1.0, shift=0.0):
        return torch.tensor(rng.standard_normal(shape) * scale + shift,
                            dtype=torch.float32)
    return (f32(n, d), f32(d, scale=0.1, shift=1.0), f32(d, scale=0.1),
            t_q.quantize_weight(f32(hid, d, scale=d ** -0.5)),
            f32(hid, scale=0.1),
            t_q.quantize_weight(f32(d, hid, scale=hid ** -0.5)),
            f32(d, scale=0.1))


def test_kernel_21_pads_a_hidden_width_with_the_same_bits(monkeypatch):
    """hid 100 reaches the kernel as 104: W1q's zero rows with a zero bias
    give gelu(0) = 0, code 0, the row's amax unchanged, and W2q's zero
    columns add nothing -- the plain version on the padded weights gives
    the same codes and output."""
    x, lng, lnb, q1, b1, q2, b2 = _ln_q8_operands(24, 128, 100, 3)
    q1p, b1p, q2p = t_q._pad_hid(q1, b1, q2)
    assert q1p.q.shape == (104, 128) and q2p.q.shape == (128, 104)
    want, got = {}, {}
    out = t_q._ln_mlp_q8_reference(x, lng, lnb, q1, b1, q2, b2, 1e-5, want)
    outp = t_q._ln_mlp_q8_reference(x, lng, lnb, q1p, b1p, q2p, b2, 1e-5, got)
    assert torch.equal(out, outp) and torch.equal(want["yq"], got["yq"])
    assert torch.equal(got["gq"][:, :100], want["gq"])
    assert not got["gq"][:, 100:].any()
    _ln_q8(monkeypatch, 24, 128, 100)


@pytest.mark.parametrize("hid", [136, 1368])
def test_kernel_21_int8_slices_match_the_plain_version(hid):
    """x's LayerNorm and codes, then y_q W1q^T summed over the up plan's
    128-int8 K slices (int64: exact), dequantised, + b1 and gelu as the
    DequantBiasGelu epilogue takes them, g's codes, then g_q W2q^T summed
    over the down plan's slices up to K = hid (the last one cut short, as
    TMA's zero fill does), dequantised, + b2, then x + that, as
    DequantStore's bias and residual: equal to ``_ln_mlp_q8_reference`` in
    fp32, codes and bits."""
    n, d = 48, 256
    x, lng, lnb, q1, b1, q2, b2 = _ln_q8_operands(n, d, hid, 9)
    plan = t_q.ln_mlp_q8_plan(n, d, hid)
    ks_up, ks_down = plan.up.a.box[0], plan.down.a.box[0]
    yq, sy = t_q.quantize_rows(t_q.ln_rows(x, lng, lnb, 1e-5))
    acc = torch.zeros(n, hid, dtype=torch.int64)
    for k0 in range(0, d, ks_up):
        acc += yq[:, k0:k0 + ks_up].long() @ q1.q[:, k0:k0 + ks_up].long().T
    g = t_q.gelu_exact((acc.float() * sy) * q1.scale + b1)
    gq, sg = t_q.quantize_rows(g)
    acc = torch.zeros(n, d, dtype=torch.int64)
    for k0 in range(0, plan.down.a.dims[0], ks_down):
        acc += gq[:, k0:k0 + ks_down].long() @ q2.q[:, k0:k0 + ks_down].long().T
    got = x + ((acc.float() * sg) * q2.scale + b2)
    codes = {}
    want = t_q._ln_mlp_q8_reference(x, lng, lnb, q1, b1, q2, b2, 1e-5, codes)
    assert (ks_up, ks_down, plan.down.a.dims[0]) == (128, 128, hid)
    assert torch.equal(yq, codes["yq"]) and torch.equal(gq, codes["gq"])
    assert torch.equal(got, want)
