"""The host plans of the LN-MLP backward (kernel 6, csrc/ln_mlp_bwd.cu), the
GELU-MLP backward (kernel 8, csrc/mlp_bwd.cu) and the head cross-entropy
backward (kernel 14, csrc/xent.cu), all on csrc/gemm_sm90.cuh's TMA/wgmma
tile product, checked through faked launches on the CPU: everything the C
side is handed is decided in ops/ffn.py and ops/xent.py (on
ops/gemm_sm90.py).

- Kernel 6 at ViTVQGAN's main path (8192, 512), hidden 1368, at the wide
  widths (d 768, hidden 2048; d 1024, hidden 2728) and at ragged rows
  (n 520): the five products' maps (dims, row pitch, box, K-major or
  MN-major), grids, tile widths, shared memory, the split of the weight
  gradients' K = n into ordered ranges, the scratches' sizes and 64-byte
  row pitches, W2 staged where hidden is not a multiple of 32, and the
  launch's name, sizes and pointers.
- Kernel 8 at ViT's (4160, 1024), hidden 2048, at ragged rows (n 520),
  at hidden 100 (padded to 104) and 1368: the same five products on x in
  place of LayerNorm(x), dx's bf16 product (dH K-major, W1 MN-major), the
  split, W2 staged at every call, the scratches, the cache, and
  misaligned or strided operands refused by name before any launch.
- Kernel 14 at MaskGIT's training shape (8192, 768), vocab 8192, bf16
  with and without Parti's bias (and fp32, which takes no plan).
- The tile product's forms one by one, the cache, and views TMA cannot
  take refused by name before any launch.
The expected values are written out from the layouts, not from the plan
code.
"""

import contextlib
import ctypes

import pytest
import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops import ffn as t_ffn
from attention_models_torch.ops import gemm_sm90 as t_gemm
from attention_models_torch.ops import xent as t_xent

SMEM_LIMIT = 232448
SINGLE_SMEM = 3 * (128 + 128) * 64 * 2 + 3 * 16 + 1024      # 99376
DUAL_SMEM = 3 * 2 * (128 + 128) * 64 * 2 + 3 * 16 + 1024    # 197680


def _fake_launches(monkeypatch):
    """The kernel path without a card: each launch records its name and
    arguments."""
    launched = []
    for mod in (t_ffn, t_xent, t_gemm):
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


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def kmap(k, rows, pitch, box_rows=128):
    """A K-major map: (K, rows) dims, (64 K, box_rows) boxes."""
    return dict(dims=(k, rows), stride=2 * pitch, box=(64, box_rows), major=0)


def mnmap(mn, k, pitch):
    """An MN-major map: (MN, K) dims, (64 MN, 64 K) boxes."""
    return dict(dims=(mn, k), stride=2 * pitch, box=(64, 64), major=1)


# -- kernel 6 ---------------------------------------------------------------

# where amt_ln_mlp_bwd takes each pointer after the plan (ops/_build.py)
BWD_ARGS = ("x", "lng", "lnb", "w1", "b1", "w2", "dy", "dx", "dw1", "db1",
            "dw2", "lnbias", "yc", "g", "dh", "w2s", "dyln", "dhpart",
            "part", "wpart")


def _ln_mlp_bwd(monkeypatch, n, d, hid, w2=None):
    launched = _fake_launches(monkeypatch)
    x = _bf16(n, d)
    w2 = _bf16(d, hid) if w2 is None else w2
    t_ffn.fused_ln_mlp_backward(x, torch.ones(d), torch.zeros(d),
                                _bf16(hid, d), torch.zeros(hid), w2, x)
    ((name, args),) = launched
    assert name == "amt_ln_mlp_bwd"
    ptrs = dict(zip(BWD_ARGS, args[1:21]))
    assert args[21:24] == (n, d, hid) and args[24] == 1e-5
    return _decode(args[0], 5), ptrs


# (n, d, hid, G/dH/W2 pitch, splits of dW1 and dW2, K slices a split)
KERNEL_6 = [(8192, 512, 1368, 1376, 6, 22), (8192, 768, 2048, 2048, 2, 64),
            (8192, 1024, 2728, 2752, 1, 128), (520, 512, 1368, 1376, 5, 2)]


@pytest.mark.parametrize("n,d,hid,pitch,splits,kslices", KERNEL_6)
def test_kernel_6_products(monkeypatch, n, d, hid, pitch, splits, kslices):
    (h, dg, dyln, dw1, dw2), _ = _ln_mlp_bwd(monkeypatch, n, d, hid)
    rt, ht, dt = -(-n // 128), -(-hid // 128), d // 128
    # the dual product: H = yc W1^T (both K-major) and dG = dy W2 (W2
    # (d, hid) read MN-major at its staged pitch) over (128 x 128) tiles,
    # one K range of d; G and dH written at the 64-byte pitch
    assert h["a"] == kmap(d, n, d) and h["b"] == kmap(d, hid, d)
    assert dg["a"] == kmap(d, n, d) and dg["b"] == mnmap(hid, d, pitch)
    for p in (h, dg):
        assert (p["grid"], p["bn"], p["ldc"]) == ((ht, rt, 1), 128, pitch)
        assert (p["smem"], p["kslices"]) == (DUAL_SMEM, d // 64)
    # dy_ln = dH W1: dH K-major at its pitch, W1 (hid, d) MN-major
    assert dyln["a"] == kmap(hid, n, pitch) and dyln["b"] == mnmap(d, hid, d)
    assert (dyln["grid"], dyln["ldc"]) == ((dt, rt, 1), d)
    assert dyln["kslices"] == -(-hid // 64)
    # dW1 (hid, d) = dH^T yc and dW2 (d, hid) = dy^T G: every operand
    # MN-major, K = n in `splits` ranges of `kslices` slices
    assert dw1["a"] == mnmap(hid, n, pitch) and dw1["b"] == mnmap(d, n, d)
    assert dw2["a"] == mnmap(d, n, d) and dw2["b"] == mnmap(hid, n, pitch)
    assert (dw1["grid"], dw1["ldc"]) == ((dt, ht, splits), d)
    assert (dw2["grid"], dw2["ldc"]) == ((ht, dt, splits), hid)
    ktiles = -(-n // 64)
    for p in (dw1, dw2):
        assert p["kslices"] == kslices
        assert (splits - 1) * kslices < ktiles <= splits * kslices
    for p in (dyln, dw1, dw2):
        assert p["smem"] == SINGLE_SMEM and p["bn"] == 128
        assert 2 * (p["smem"] + 1024) <= 233472  # two blocks an SM
    for p in (h, dg, dyln, dw1, dw2):
        assert (p["swizzle"], p["threads"]) == (128, 288)
        assert p["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("n,d,hid,pitch,splits,kslices", KERNEL_6)
def test_kernel_6_scratches(monkeypatch, n, d, hid, pitch, splits, kslices):
    _, ptrs = _ln_mlp_bwd(monkeypatch, n, d, hid)
    # bf16: yc (n, d), G and dH (n, pitch), W2's stage (d, pitch) where
    # hidden is not a multiple of 32; fp32: dy_ln (n, d), db1's partials (2
    # a 128-row tile), the LN backward's partials of dlng, dlnb and db2 (3
    # a 32-row block), the split's planes of dW1 / dW2
    staged = hid % 32 != 0
    bf16 = [("yc", n * d), ("g", n * pitch), ("dh", n * pitch),
            ("w2s", d * pitch if staged else 0)]
    f32 = [("dyln", n * d), ("dhpart", 2 * -(-n // 128) * hid),
           ("part", 3 * -(-n // 32) * d),
           ("wpart", splits * hid * d if splits > 1 else 0)]
    for parts, item in ((bf16, 2), (f32, 4)):
        base = ptrs[parts[0][0]]
        for (name, size), (nxt, _) in zip(parts, parts[1:] + [(None, 0)]):
            if not size:
                assert ptrs[name] is None
                continue
            assert (ptrs[name] - base) % 256 == 0 and ptrs[name] % 64 == 0
            if nxt is not None and ptrs[nxt] is not None:
                assert ptrs[nxt] - ptrs[name] >= size * item
    assert (ptrs["w2s"] is None) == (not staged)


def test_kernel_6_reads_w2_as_given_at_every_call(monkeypatch):
    """Repair C.1 on the backward: W2 (512, 1368) reaches the C side as the
    weight itself, staged there at every call; a write through ``.data``
    reaches the next call."""
    w2 = torch.randn(512, 1368, generator=torch.Generator().manual_seed(1))
    w2 = w2.bfloat16()
    for _ in range(2):
        (_, dg, *_), ptrs = _ln_mlp_bwd(monkeypatch, 64, 512, 1368, w2=w2)
        assert ptrs["w2"] == w2.data_ptr() and ptrs["w2s"] is not None
        assert dg["b"]["stride"] == 2 * 1376
        buf = (ctypes.c_int16 * w2.numel()).from_address(ptrs["w2"])
        assert torch.equal(torch.frombuffer(buf, dtype=torch.int16),
                           w2.view(torch.int16).reshape(-1))
        w2.data.mul_(2)
        monkeypatch.undo()


def test_kernel_6_plan_is_cached():
    x, w1, w2 = _bf16(64, 256), _bf16(96, 256), _bf16(256, 96)
    assert t_ffn.ln_mlp_bwd_plan(x, w1, w2) is t_ffn.ln_mlp_bwd_plan(x, w1,
                                                                      w2)
    p = t_ffn.ln_mlp_bwd_plan(x, w1, w2)
    assert p.c_array() is p.c_array()


def _misaligned(*shape):
    """A bf16 tensor of ``shape`` whose storage starts 2 bytes past a
    16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    return _bf16(n + 8)[1:n + 1].view(*shape)


@pytest.mark.parametrize("which", ["x", "w1", "w2", "dy"])
def test_kernel_6_refuses_a_misaligned_operand_unlaunched(monkeypatch, which):
    launched = _fake_launches(monkeypatch)
    ops = dict(x=_bf16(16, 128), w1=_bf16(96, 128), w2=_bf16(128, 96),
               dy=_bf16(16, 128))
    ops[which] = _misaligned(*ops[which].shape)
    with pytest.raises(ValueError, match=f"{which}"):
        t_ffn.fused_ln_mlp_backward(ops["x"], torch.ones(128),
                                    torch.zeros(128), ops["w1"],
                                    torch.zeros(96), ops["w2"], ops["dy"])
    assert launched == []


def test_kernel_6_plan_refuses_views_tma_cannot_take():
    x, w1 = _bf16(16, 128), _bf16(96, 128)
    with pytest.raises(ValueError, match="w2's row stride of 200 bytes"):
        t_ffn.ln_mlp_bwd_plan(x, w1, _bf16(128, 100)[:, :96])
    with pytest.raises(ValueError, match="w1 needs a contiguous last"):
        t_ffn.ln_mlp_bwd_plan(x, _bf16(128, 96).t(), _bf16(128, 96))
    with pytest.raises(ValueError, match="dy starts at an address"):
        t_ffn.ln_mlp_bwd_plan(_misaligned(16, 128), w1, _bf16(128, 96))


# -- kernel 8 ---------------------------------------------------------------

# where amt_mlp_bwd takes each pointer after the plan (ops/_build.py)
MLP_BWD_ARGS = ("x", "w1", "b1", "w2", "dy", "dx", "dw1", "db1", "dw2",
                "db2", "g", "dh", "w2s", "dhpart", "dypart", "wpart")


def _mlp_bwd(monkeypatch, n, d, hid, w2=None):
    launched = _fake_launches(monkeypatch)
    x = _bf16(n, d)
    w2 = _bf16(d, hid) if w2 is None else w2
    out = t_ffn.fused_mlp_backward(x, _bf16(hid, d), torch.zeros(hid), w2,
                                   _bf16(n, d))
    ((name, args),) = launched
    assert name == "amt_mlp_bwd"
    hid8 = -(-hid // 8) * 8  # _pad_hidden's width
    assert args[17:20] == (n, d, hid8)
    # the gradients come back at the caller's hidden width
    assert [tuple(t.shape) for t in out] == [(n, d), (hid, d), (hid,),
                                             (d, hid), (d,)]
    return _decode(args[0], 5), dict(zip(MLP_BWD_ARGS, args[1:17])), hid8


# (n, d, hid, G/dH/W2 pitch, splits of dW1 and dW2, K slices a split)
KERNEL_8 = [(4160, 1024, 2048, 2048, 1, 65), (520, 1024, 2048, 2048, 1, 9),
            (520, 128, 100, 128, 5, 2), (8192, 512, 1368, 1376, 6, 22)]


@pytest.mark.parametrize("n,d,hid,pitch,splits,kslices", KERNEL_8)
def test_kernel_8_products(monkeypatch, n, d, hid, pitch, splits, kslices):
    (h, dg, dx, dw1, dw2), _, hk = _mlp_bwd(monkeypatch, n, d, hid)
    rt, ht, dt = -(-n // 128), -(-hk // 128), d // 128
    # kernel 6's dual product on x: H = x W1^T (both K-major) and dG = dy
    # W2 (W2 (d, hid) MN-major at its staged pitch), (128 x 128) tiles
    # over K = d; G and dH written at the 64-byte pitch
    assert h["a"] == kmap(d, n, d) and h["b"] == kmap(d, hk, d)
    assert dg["a"] == kmap(d, n, d) and dg["b"] == mnmap(hk, d, pitch)
    for p in (h, dg):
        assert (p["grid"], p["bn"], p["ldc"]) == ((ht, rt, 1), 128, pitch)
        assert (p["smem"], p["kslices"]) == (DUAL_SMEM, d // 64)
    # dx = bf16(dH W1): dH K-major at its pitch, W1 (hid, d) MN-major
    assert dx["a"] == kmap(hk, n, pitch) and dx["b"] == mnmap(d, hk, d)
    assert (dx["grid"], dx["ldc"], dx["kslices"]) == (
        (dt, rt, 1), d, -(-hk // 64))
    # dW1 (hid, d) = dH^T x and dW2 (d, hid) = dy^T G: every operand
    # MN-major, K = n in `splits` ranges of `kslices` slices
    assert dw1["a"] == mnmap(hk, n, pitch) and dw1["b"] == mnmap(d, n, d)
    assert dw2["a"] == mnmap(d, n, d) and dw2["b"] == mnmap(hk, n, pitch)
    assert (dw1["grid"], dw1["ldc"]) == ((dt, ht, splits), d)
    assert (dw2["grid"], dw2["ldc"]) == ((ht, dt, splits), hk)
    ktiles = -(-n // 64)
    for p in (dw1, dw2):
        assert p["kslices"] == kslices
        assert (splits - 1) * kslices < ktiles <= splits * kslices
    for p in (dx, dw1, dw2):
        assert (p["smem"], p["bn"]) == (SINGLE_SMEM, 128)
    for p in (h, dg, dx, dw1, dw2):
        assert (p["swizzle"], p["threads"]) == (128, 288)


@pytest.mark.parametrize("n,d,hid,pitch,splits,kslices", KERNEL_8)
def test_kernel_8_scratches(monkeypatch, n, d, hid, pitch, splits, kslices):
    _, ptrs, hk = _mlp_bwd(monkeypatch, n, d, hid)
    # bf16: G and dH (n, pitch), W2's stage (d, pitch) where the padded
    # hidden width is not a multiple of 32; fp32: db1's partials (2 a
    # 128-row tile), db2's (1 a 32-row block), the split's planes
    staged = hk % 32 != 0
    bf16 = [("g", n * pitch), ("dh", n * pitch),
            ("w2s", d * pitch if staged else 0)]
    f32 = [("dhpart", 2 * -(-n // 128) * hk), ("dypart", -(-n // 32) * d),
           ("wpart", splits * hk * d if splits > 1 else 0)]
    for parts, item in ((bf16, 2), (f32, 4)):
        base = ptrs[parts[0][0]]
        for (name, size), (nxt, _) in zip(parts, parts[1:] + [(None, 0)]):
            if not size:
                assert ptrs[name] is None
                continue
            assert (ptrs[name] - base) % 256 == 0 and ptrs[name] % 64 == 0
            if nxt is not None and ptrs[nxt] is not None:
                assert ptrs[nxt] - ptrs[name] >= size * item
    assert (ptrs["w2s"] is None) == (not staged)
    for name in ("x", "dy", "dx", "dw1", "db1", "dw2", "db2"):
        assert ptrs[name] % 16 == 0


def test_kernel_8_reads_w2_as_given_at_every_call(monkeypatch):
    """W2 (512, 1368) reaches the C side as the weight itself, staged there
    at every call (no copy keyed on its version); a write through ``.data``
    reaches the next call."""
    w2 = torch.randn(512, 1368, generator=torch.Generator().manual_seed(2))
    w2 = w2.bfloat16()
    for _ in range(2):
        (_, dg, *_), ptrs, _ = _mlp_bwd(monkeypatch, 64, 512, 1368, w2=w2)
        assert ptrs["w2"] == w2.data_ptr() and ptrs["w2s"] is not None
        assert dg["b"]["stride"] == 2 * 1376
        buf = (ctypes.c_int16 * w2.numel()).from_address(ptrs["w2"])
        assert torch.equal(torch.frombuffer(buf, dtype=torch.int16),
                           w2.view(torch.int16).reshape(-1))
        w2.data.mul_(2)
        monkeypatch.undo()


def test_kernel_8_plan_is_cached():
    x, w1, w2 = _bf16(64, 256), _bf16(96, 256), _bf16(256, 96)
    p = t_ffn.mlp_bwd_plan(x, x, w1, w2)
    assert p is t_ffn.mlp_bwd_plan(x, x, w1, w2)
    assert p.c_array() is p.c_array()
    assert len(list(p.c_array())) == 105


@pytest.mark.parametrize("which", ["x", "w1", "w2", "dy"])
def test_kernel_8_refuses_a_misaligned_operand_unlaunched(monkeypatch, which):
    launched = _fake_launches(monkeypatch)
    ops = dict(x=_bf16(16, 128), w1=_bf16(96, 128), w2=_bf16(128, 96),
               dy=_bf16(16, 128))
    ops[which] = _misaligned(*ops[which].shape)
    with pytest.raises(ValueError, match=f"{which}"):
        t_ffn.fused_mlp_backward(ops["x"], ops["w1"], torch.zeros(96),
                                 ops["w2"], ops["dy"])
    assert launched == []


def test_kernel_8_refuses_a_strided_x_unlaunched(monkeypatch):
    launched = _fake_launches(monkeypatch)
    x = _bf16(16, 136)[:, :128]
    with pytest.raises(ValueError, match="x: must be contiguous"):
        t_ffn.fused_mlp_backward(x, _bf16(96, 128), torch.zeros(96),
                                 _bf16(128, 96), _bf16(16, 128))
    assert launched == []


def test_kernel_8_plan_refuses_views_tma_cannot_take():
    x, w1, w2 = _bf16(16, 128), _bf16(96, 128), _bf16(128, 96)
    with pytest.raises(ValueError, match="mlp backward: x's row stride of "
                                         "264 bytes"):
        t_ffn.mlp_bwd_plan(_bf16(16, 132)[:, :128], x, w1, w2)
    with pytest.raises(ValueError, match="dy starts at an address"):
        t_ffn.mlp_bwd_plan(x, _misaligned(16, 128), w1, w2)
    with pytest.raises(ValueError, match="w2's row stride of 200 bytes"):
        t_ffn.mlp_bwd_plan(x, x, w1, _bf16(128, 100)[:, :96])


# -- kernel 14 --------------------------------------------------------------

def _xent_bwd(monkeypatch, n, d, v, bias, dtype=torch.bfloat16):
    launched = _fake_launches(monkeypatch)
    h = torch.zeros(n, d, dtype=dtype)
    w = torch.zeros(v, d, dtype=dtype)
    tgt = torch.arange(n) % v
    t_xent.head_xent_backward(h, w, tgt, torch.zeros(n), torch.ones(n),
                              bias=torch.zeros(v) if bias else None)
    ((name, args),) = launched
    assert name == "amt_head_xent_bwd"
    assert args[13:17] == (n, d, v, _build.DTYPE_CODES[dtype])
    return args


@pytest.mark.parametrize("bias", [False, True])
def test_kernel_14_products(monkeypatch, bias):
    n, d, v = 8192, 768, 8192
    args = _xent_bwd(monkeypatch, n, d, v, bias)
    logits, dh, dw = _decode(args[12], 3)
    # logits = h W^T, both K-major; dl formed in the epilogue, (n, V)
    assert logits["a"] == kmap(d, n, d) and logits["b"] == kmap(d, v, d)
    assert (logits["grid"], logits["ldc"], logits["kslices"]) == (
        (v // 128, n // 128, 1), v, d // 64)
    # dh = dl W: dl K-major, W (V, d) MN-major, K = V
    assert dh["a"] == kmap(v, n, v) and dh["b"] == mnmap(d, v, d)
    assert (dh["grid"], dh["ldc"], dh["kslices"]) == (
        (d // 128, n // 128, 1), d, v // 64)
    # dW = dl^T h: both MN-major, K = n; 6 x 64 tiles fill the card, so K
    # is not split
    assert dw["a"] == mnmap(v, n, v) and dw["b"] == mnmap(d, n, d)
    assert (dw["grid"], dw["ldc"], dw["kslices"]) == (
        (d // 128, v // 128, 1), d, n // 64)
    for p in (logits, dh, dw):
        assert (p["swizzle"], p["threads"], p["bn"]) == (128, 288, 128)
        assert p["smem"] == SINGLE_SMEM
    # scratch: dl (n, V) bf16; the db partials (one per 64 rows) only with a
    # bias; no split partials of dW
    assert args[6] is not None and args[11] is None
    assert (args[2] is None, args[7] is None, args[10] is None) == (
        (not bias,) * 3)


def test_kernel_14_fp32_takes_no_plan(monkeypatch):
    args = _xent_bwd(monkeypatch, 64, 128, 256, True, dtype=torch.float32)
    assert args[12] is None and args[11] is None and args[7] is not None


def test_kernel_14_plan_is_cached_and_refuses_views():
    h, w = _bf16(64, 128), _bf16(256, 128)
    assert t_xent.xent_bwd_plan(h, w) is t_xent.xent_bwd_plan(h, w)
    with pytest.raises(ValueError, match="w needs a contiguous last"):
        t_xent.xent_bwd_plan(h, _bf16(128, 256).t())
    with pytest.raises(ValueError, match="h starts at an address"):
        t_xent.xent_bwd_plan(_misaligned(64, 128), w)


def test_kernel_14_refuses_a_misaligned_operand_unlaunched(monkeypatch):
    launched = _fake_launches(monkeypatch)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t_xent.head_xent_backward(_misaligned(64, 128), _bf16(256, 128),
                                  torch.zeros(64, dtype=torch.long),
                                  torch.zeros(64), torch.ones(64))
    assert launched == []


# -- the tile product's forms -----------------------------------------------

@pytest.mark.parametrize("a_major", [0, 1])
@pytest.mark.parametrize("b_major", [0, 1])
def test_each_form_plans_and_launches(monkeypatch, a_major, b_major):
    """C (M 520, N 384) = A B^T over K 1000: each operand stored (rows, K)
    K-major or (K, rows) MN-major; the CPU answer is the plain product."""
    m, n, k = 520, 384, 1000
    g = torch.Generator().manual_seed(a_major * 2 + b_major)
    a = torch.randn(m, k, generator=g).bfloat16()
    b = torch.randn(n, k, generator=g).bfloat16()
    sa = a if a_major == 0 else a.T.contiguous()
    sb = b if b_major == 0 else b.T.contiguous()
    want = a.float() @ b.float().T
    torch.testing.assert_close(t_gemm.tile_product(sa, a_major, sb, b_major),
                               want)
    launched = _fake_launches(monkeypatch)
    t_gemm.tile_product(sa, a_major, sb, b_major, split=True)
    ((name, args),) = launched
    assert name == "amt_tile_product"
    assert args[5:10] == (m, n, k, n, 2 * a_major + b_major)
    (p,) = _decode(args[0], 1)
    assert p["a"] == (kmap(k, m, k) if a_major == 0 else mnmap(m, k, m))
    assert p["b"] == (kmap(k, n, k) if b_major == 0 else mnmap(n, k, n))
    # 3 x 5 tiles: K's 16 slices in 8 ranges of 2 (at most 8)
    assert (p["grid"], p["kslices"], p["ldc"]) == ((3, 5, 8), 2, n)
    assert args[4] is not None  # the partial planes


def test_the_split_rule():
    # as many K ranges as one wave of two blocks on each of 132 SMs holds,
    # whole 64-row slices
    assert t_gemm.split_k(44, 8192) == (6, 22)    # 264 blocks
    assert t_gemm.split_k(96, 8192) == (2, 64)    # 192, not 288
    # all but a 32nd of the SMs hold a block of their own: K whole
    assert t_gemm.split_k(128, 4160) == (1, 65)
    assert t_gemm.split_k(123, 4160) == (2, 33)
    assert t_gemm.split_k(176, 8192) == (1, 128)
    assert t_gemm.split_k(384, 8192) == (1, 128)
    assert t_gemm.split_k(44, 520) == (5, 2)
    assert t_gemm.split_k(264, 64) == (1, 1)
    assert t_gemm.gemm_smem_bytes(128, dual=True) == DUAL_SMEM <= SMEM_LIMIT
