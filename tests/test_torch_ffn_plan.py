"""The host plans of the GEGLU FFN forward and backward (kernels 11 and 12,
csrc/ffn.cu and csrc/ffn_bwd.cu), checked through faked launches on the
CPU: everything the C side is handed is decided in ops/ffn.py (on
ops/gemm_sm90.py).

- Kernel 11 at MaskGIT's (8192, 768) and Muse's (16384, 1024), inner 4096,
  and at ragged rows (n 520): the paired-column GEGLU product's maps (W1
  read as boxes of half a tile: a block's "a" rows, then its "gate" rows),
  the two boxes' row offsets, the grids, tile widths, shared memory, and
  the scratches' sizes and 64-byte pitches.
- Kernel 12's five products (maps with their K-major or MN-major flags,
  grids, the weight gradients' split of K into ordered ranges) and its
  scratches.
- fp32 launching without a plan, inner 8704 (rows wider than a row pass
  holds in registers) reaching both kernels, misaligned operands refused
  by name before any launch, the plan cache, a write through ``.data`` reaching
  the kernel, and a CPU emulation of the paired-column order against the
  plain version.
The expected values are written out from the layouts, not from the plan
code.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops import ffn as t_ffn
from attention_models_torch.ops import gemm_sm90 as t_gemm

SMEM_LIMIT = 232448
SMEM_128 = 3 * (128 + 128) * 64 * 2 + 3 * 16 + 1024    # 99376
SMEM_256 = 4 * (128 + 256) * 64 * 2 + 4 * 16 + 1024    # 197696


def _fake_launches(monkeypatch):
    """The kernel path without a card: each launch records its name and
    arguments."""
    launched = []
    for mod in (t_ffn, t_gemm):
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


def _t(*shape, dtype=torch.bfloat16):
    return torch.zeros(*shape, dtype=dtype)


def kmap(k, rows, pitch, box_rows=128, item=2):
    """A K-major map: (K, rows) dims, (64 K, box_rows) boxes."""
    return dict(dims=(k, rows), stride=item * pitch, box=(64, box_rows),
                major=0)


def mnmap(mn, k, pitch):
    """An MN-major map: (MN, K) dims, (64 MN, 64 K) boxes."""
    return dict(dims=(mn, k), stride=2 * pitch, box=(64, 64), major=1)


# where amt_ffn / amt_ffn_bwd take each pointer after the plan (ops/_build.py)
FWD_ARGS = ("x", "w1", "gamma", "w2", "g", "y", "part", "out")
BWD_ARGS = ("x", "w1", "gamma", "w2", "dy", "h", "dyln", "y", "dh", "gpart",
            "wpart", "dx", "dw1", "dgamma", "dw2")


def _ffn(monkeypatch, n, d, inner, dtype=torch.bfloat16, w1=None, w2=None):
    launched = _fake_launches(monkeypatch)
    w1 = _t(2 * inner, d, dtype=dtype) if w1 is None else w1
    w2 = _t(d, inner, dtype=dtype) if w2 is None else w2
    t_ffn.fused_ffn(_t(n, d, dtype=dtype), w1, torch.ones(inner), w2)
    ((name, args),) = launched
    assert name == "amt_ffn"
    assert args[9:14] == (n, d, inner, 1e-5, _build.DTYPE_CODES[dtype])
    return args[0], dict(zip(FWD_ARGS, args[1:9]))


def _ffn_bwd(monkeypatch, n, d, inner, dtype=torch.bfloat16):
    launched = _fake_launches(monkeypatch)
    x = _t(n, d, dtype=dtype)
    t_ffn.fused_ffn_backward(x, _t(2 * inner, d, dtype=dtype),
                             torch.ones(inner), _t(d, inner, dtype=dtype), x)
    ((name, args),) = launched
    assert name == "amt_ffn_bwd"
    assert args[16:21] == (n, d, inner, 1e-5, _build.DTYPE_CODES[dtype])
    return args[0], dict(zip(BWD_ARGS, args[1:16]))


# -- kernel 11 --------------------------------------------------------------

# (n, d, inner): MaskGIT, Muse, ragged rows
KERNEL_11 = [(8192, 768, 4096), (16384, 1024, 4096), (520, 768, 4096)]


@pytest.mark.parametrize("n,d,inner", KERNEL_11)
def test_kernel_11_products(monkeypatch, n, d, inner):
    arr, _ = _ffn(monkeypatch, n, d, inner)
    geglu, out = _decode(arr, 2)
    rt = -(-n // 128)
    # the GEGLU product: x (n, d) and W1 (2 inner, d) K-major, W1's boxes
    # 128 rows (half of BN 256): block x loads W1 rows 128 x .. ("a") and
    # inner + 128 x .. ("gate"), and writes g's columns 128 x .. + 127
    assert geglu["a"] == kmap(d, n, d)
    assert geglu["b"] == kmap(d, 2 * inner, d, box_rows=128)
    assert (geglu["bn"], geglu["grid"]) == (256, (2 * inner // 256, rt, 1))
    half = geglu["bn"] // 2
    a_rows = [x * half for x in range(geglu["grid"][0])]
    gate_rows = [geglu["grid"][0] * half + r for r in a_rows]
    assert a_rows[-1] + half == inner and gate_rows[0] == inner
    assert gate_rows[-1] + half == 2 * inner
    # g is fp32 (n, inner) at a 64-byte pitch
    assert geglu["ldc"] == inner and (4 * geglu["ldc"]) % 64 == 0
    assert geglu["kslices"] == d // 64
    # y W2^T: y (n, inner) bf16 at its pitch, W2 (d, inner) as it lies
    assert out["a"] == kmap(inner, n, inner)
    assert out["b"] == kmap(inner, d, inner, box_rows=256)
    assert (out["bn"], out["grid"], out["ldc"]) == (256, (-(-d // 256), rt,
                                                          1), d)
    assert out["kslices"] == inner // 64
    for p in (geglu, out):
        assert (p["swizzle"], p["threads"], p["smem"]) == (128, 288, SMEM_256)
        assert p["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("n,d,inner", KERNEL_11)
def test_kernel_11_scratches(monkeypatch, n, d, inner):
    _, ptrs = _ffn(monkeypatch, n, d, inner)
    plan = t_ffn.ffn_plan(n, d, inner)
    # g fp32 (n, inner) and y bf16 (n, inner), rows 64-byte aligned; bf16
    # takes no split partials
    assert plan.g_pitch == inner and plan.y_pitch == inner
    assert ptrs["part"] is None
    assert ptrs["g"] % 16 == 0 and ptrs["y"] % 16 == 0


def test_kernel_11_tile_widths_and_small_d(monkeypatch):
    # d 128: the W2 product fits one 128-wide tile
    arr, _ = _ffn(monkeypatch, 64, 128, 256)
    geglu, out = _decode(arr, 2)
    assert (geglu["bn"], geglu["grid"]) == (256, (2, 1, 1))
    assert (out["bn"], out["grid"], out["smem"]) == (128, (1, 1, 1), SMEM_128)
    # above d 128 both products are 256 wide, whatever the shape
    p = t_ffn.ffn_plan(520, 256, 8704)
    assert (p.geglu.bn, p.out.bn) == (256, 256)
    assert p.geglu.b.box == (64, 128) and p.geglu.grid == (68, 5, 1)
    assert p.out.grid == (1, 5, 1)


# -- kernel 12 --------------------------------------------------------------

# (n, d, inner, splits of dW2, splits of dW1)
KERNEL_12 = [(8192, 768, 4096, 1, 1), (520, 768, 4096, 1, 1),
             (8192, 1024, 4096, 1, 1), (1024, 128, 128, 8, 8)]


@pytest.mark.parametrize("n,d,inner,s2,s1", KERNEL_12)
def test_kernel_12_products(monkeypatch, n, d, inner, s2, s1):
    arr, _ = _ffn_bwd(monkeypatch, n, d, inner)
    h, dyln, dw2, dx, dw1 = _decode(arr, 5)
    rt, i2 = -(-n // 128), 2 * inner
    # H = x W1^T: both K-major, fp32 (n, 2 inner)
    assert h["a"] == kmap(d, n, d) and h["b"] == kmap(d, i2, d)
    assert (h["grid"], h["ldc"]) == ((i2 // 128, rt, 1), i2)
    # dy_ln = dy W2: W2 (d, inner) read MN-major, fp32 (n, inner)
    assert dyln["a"] == kmap(d, n, d) and dyln["b"] == mnmap(inner, d, inner)
    assert (dyln["grid"], dyln["ldc"]) == ((inner // 128, rt, 1), inner)
    # dW2 (d, inner) = dy^T y and dW1 (2 inner, d) = [da | dgate]^T x:
    # every operand MN-major, K = n in ordered ranges
    assert dw2["a"] == mnmap(d, n, d) and dw2["b"] == mnmap(inner, n, inner)
    assert dw1["a"] == mnmap(i2, n, i2) and dw1["b"] == mnmap(d, n, d)
    assert dw2["grid"] == (inner // 128, d // 128, s2)
    assert dw1["grid"] == (d // 128, i2 // 128, s1)
    assert dw2["ldc"] == inner and dw1["ldc"] == d
    ktiles = -(-n // 64)
    for p, s in ((dw2, s2), (dw1, s1)):
        assert (s - 1) * p["kslices"] < ktiles <= s * p["kslices"]
    # dx = [da | dgate] W1: dh K-major, W1 (2 inner, d) MN-major, bf16 out
    assert dx["a"] == kmap(i2, n, i2) and dx["b"] == mnmap(d, i2, d)
    assert (dx["grid"], dx["ldc"], dx["kslices"]) == ((d // 128, rt, 1), d,
                                                      i2 // 64)
    for p in (h, dyln, dw2, dx, dw1):
        assert (p["swizzle"], p["threads"], p["bn"]) == (128, 288, 128)
        assert p["smem"] == SMEM_128 <= SMEM_LIMIT


@pytest.mark.parametrize("n,d,inner,s2,s1", KERNEL_12)
def test_kernel_12_scratches(monkeypatch, n, d, inner, s2, s1):
    _, ptrs = _ffn_bwd(monkeypatch, n, d, inner)
    # fp32: H (n, 2 inner), dy_ln (n, inner), dgamma's partials (a 16-row
    # block each), the split planes of the larger weight gradient; bf16:
    # y (n, inner), [da | dgate] (n, 2 inner)
    splits = max(s1, s2)
    f32 = [("h", n * 2 * inner), ("dyln", n * inner),
           ("gpart", -(-n // 16) * inner),
           ("wpart", splits * 2 * inner * d if splits > 1 else 0)]
    bf16 = [("y", n * inner), ("dh", n * 2 * inner)]
    for parts, item in ((f32, 4), (bf16, 2)):
        for (name, size), (nxt, _) in zip(parts, parts[1:] + [(None, 0)]):
            if not size:
                assert ptrs[name] is None
                continue
            assert ptrs[name] % 64 == 0
            if nxt is not None and ptrs[nxt] is not None:
                assert ptrs[nxt] - ptrs[name] >= size * item


# -- fp32, refusals, the cache ---------------------------------------------

def test_fp32_launches_without_a_plan(monkeypatch):
    n, d, inner = 520, 256, 512
    arr, ptrs = _ffn(monkeypatch, n, d, inner, dtype=torch.float32)
    assert arr is None
    # g (n, inner) then the W2 product's split partials (2 n d) in one
    # fp32 buffer
    assert ptrs["part"] - ptrs["g"] == 4 * n * inner
    monkeypatch.undo()
    arr, ptrs = _ffn_bwd(monkeypatch, n, d, inner, dtype=torch.float32)
    assert arr is None and ptrs["wpart"] is not None
    # H, dy_ln, y and [da | dgate] at 2 inner / inner elements a row
    assert ptrs["dyln"] - ptrs["h"] >= 4 * n * 2 * inner
    assert ptrs["dh"] - ptrs["y"] >= 4 * n * inner


def test_fp32_tile_product_launch(monkeypatch):
    launched = _fake_launches(monkeypatch)
    a, b = _t(520, 1000, dtype=torch.float32), _t(1000, 384,
                                                  dtype=torch.float32)
    t_gemm.tile_product(a, 0, b, 1, tile_width=64)
    ((name, args),) = launched
    assert name == "amt_tile_product_f32"
    # A (520, K) kK at 1000 a row, B stored (K, 384): kR, form 1, width 64
    assert args[1] == 1000 and args[3] == 384
    assert args[5:10] == (520, 384, 1000, 1, 64)


def _misaligned(*shape):
    """A bf16 tensor of ``shape`` whose storage starts 2 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return _t(n + 8)[1:n + 1].view(*shape)


@pytest.mark.parametrize("which", ["x", "w1", "w2", "dy"])
def test_misaligned_operands_refused_unlaunched(monkeypatch, which):
    launched = _fake_launches(monkeypatch)
    ops = dict(x=_t(16, 128), w1=_t(256, 128), w2=_t(128, 128),
               dy=_t(16, 128))
    ops[which] = _misaligned(*ops[which].shape)
    with pytest.raises(ValueError, match=f"ffn kernel: {which} starts at"):
        if which == "dy":
            t_ffn.fused_ffn_backward(ops["x"], ops["w1"], torch.ones(128),
                                     ops["w2"], ops["dy"])
        else:
            t_ffn.fused_ffn(ops["x"], ops["w1"], torch.ones(128), ops["w2"])
    assert launched == []


@pytest.mark.parametrize("d,inner", [(128, 192), (192, 256)])
def test_widths_refused_by_name(monkeypatch, d, inner):
    launched = _fake_launches(monkeypatch)
    with pytest.raises(ValueError, match="multiples of 128"):
        t_ffn.fused_ffn(_t(16, d), _t(2 * inner, d), torch.ones(inner),
                        _t(d, inner))
    assert launched == []


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_wider_than_the_registers_reach_the_kernels(monkeypatch, dtype):
    """inner 8704 is wider than the 8192 columns a row pass holds in
    registers (it walks such a row in chunks): both kernels launch, with
    scratches sized for the whole row."""
    n, d, inner = 520, 768, 8704
    _, ptrs = _ffn(monkeypatch, n, d, inner, dtype)
    assert ptrs["g"] % 16 == 0 and ptrs["y"] % 16 == 0
    monkeypatch.undo()
    _, ptrs = _ffn_bwd(monkeypatch, n, d, inner, dtype)
    if dtype == torch.bfloat16:
        f32 = dict((k, v) for k, _, v in t_ffn.ffn_bwd_plan(n, d, inner).f32[0])
        assert f32["h"] == n * 2 * inner and f32["gpart"] == 33 * inner
    assert all(ptrs[k] % 16 == 0 for k in ("h", "dyln", "y", "dh", "gpart"))


def test_plans_are_cached():
    assert t_ffn.ffn_plan(64, 128, 256) is t_ffn.ffn_plan(64, 128, 256)
    p = t_ffn.ffn_bwd_plan(64, 128, 256)
    assert p is t_ffn.ffn_bwd_plan(64, 128, 256)
    assert p.c_array() is p.c_array()
    assert t_ffn.ffn_plan(64, 128, 256).c_array() is t_ffn.ffn_plan(
        64, 128, 256).c_array()


def test_a_write_through_data_reaches_the_kernel(monkeypatch):
    """No copy of a weight is held between calls: W1 and W2 reach the C
    side as the weights themselves, and a write through ``.data`` shows in
    the next call's bytes."""
    g = torch.Generator().manual_seed(2)
    w1 = torch.randn(256, 128, generator=g).bfloat16()
    w2 = torch.randn(128, 128, generator=g).bfloat16()
    for _ in range(2):
        _, ptrs = _ffn(monkeypatch, 16, 128, 128, w1=w1, w2=w2)
        for name, w in (("w1", w1), ("w2", w2)):
            assert ptrs[name] == w.data_ptr()
            buf = (ctypes.c_int16 * w.numel()).from_address(ptrs[name])
            assert torch.equal(torch.frombuffer(buf, dtype=torch.int16),
                               w.view(torch.int16).reshape(-1))
        w1.data.mul_(2)
        w2.data.mul_(-1)
        monkeypatch.undo()


@pytest.mark.parametrize("inner", [512, 1152])
def test_paired_column_order_matches_the_plain_version(inner):
    """g built block by block from the plan's (a row, gate row) pairs, as
    the GEGLU product's producer loads them and its epilogue pairs
    accumulator column j with j + bn / 2, then the LayerNorm and W2: equal
    to ``_ffn_reference`` in fp32."""
    n, d, bn = 48, 128, 256
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    w1 = torch.tensor(rng.standard_normal((2 * inner, d)) / d ** 0.5,
                      dtype=torch.float32)
    gamma = torch.tensor(1 + 0.1 * rng.standard_normal(inner),
                         dtype=torch.float32)
    w2 = torch.tensor(rng.standard_normal((d, inner)) / inner ** 0.5,
                      dtype=torch.float32)
    geglu = t_ffn.ffn_plan(n, d, inner).geglu
    half = geglu.b.box[1]
    assert half == bn // 2
    blocks = geglu.grid[0]
    pair_off = blocks * half           # the kernel's gate offset
    g = torch.empty(n, inner)
    for bx in range(blocks):
        rows = [bx * half + j for j in range(half)]
        tile = x @ torch.cat([w1[rows], w1[[pair_off + r for r in rows]]]).T
        a, gate = tile[:, :half], tile[:, half:]
        g[:, bx * half:(bx + 1) * half] = gate * t_ffn.gelu_exact(a)
    mean = g.mean(-1, keepdim=True)
    var = ((g - mean) ** 2).mean(-1, keepdim=True)
    y = (g - mean) * torch.rsqrt(var + 1e-5) * gamma
    got = y @ w2.T
    want = t_ffn._ffn_reference(x, w1, gamma, w2, 1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
